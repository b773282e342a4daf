"""Entry `vo`: the port's frame-to-frame VO step,
`pipeline/vo.py::vo_step`, called through its module so that wrappers of
the module's functions see every call."""
from front_end_tpu_torch.pipeline import vo
from vobench.entries._config import make_rig, vo_config

EXTRA = ()


def setup(config: dict):
    return make_rig(config["rig"]), vo_config(config["vo"])


def init_state(rig, cfg, seed: int, device):
    return vo.init_state(rig, cfg, seed=seed, device=device)


def step(state, left, right, rig, cfg):
    return vo.vo_step(state, left, right, rig, cfg)


def frame(out):
    return out


def extras(out) -> list:
    return []

"""Entry `vo` in plain PyTorch: `vobench/reference/vo.py::vo_step`."""
from vobench.reference import vo
from vobench.reference.from_config import make_rig, vo_config

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

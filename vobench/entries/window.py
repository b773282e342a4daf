"""Entry `window`: the port's windowed VO step,
`pipeline/window_vo.py::window_vo_step` (the frame-to-frame step, the
landmark tracker and the windowed BA), called through its module."""
from front_end_tpu_torch.pipeline import window_vo
from vobench.entries._config import make_rig, vo_config

EXTRA = ("n_tracked",)


def setup(config: dict):
    w = dict(config["window"])
    cfg = window_vo.WindowVOConfig.create(
        vo_config(config["vo"]), window=w.pop("window"),
        capacity=w.pop("capacity"), **w)
    return make_rig(config["rig"]), cfg


def init_state(rig, cfg, seed: int, device):
    return window_vo.init_state(rig, cfg, seed=seed, device=device)


def step(state, left, right, rig, cfg):
    return window_vo.window_vo_step(state, left, right, rig, cfg)


def frame(out):
    return out.frame


def extras(out) -> list:
    return [out.n_tracked]

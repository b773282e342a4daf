"""The system under test: the port's entry points, built from a
configuration file.  The only module of the harness that imports the
port (`front_end_tpu_torch`); the per-layer readers name the port's
functions they wrap by module path."""
from __future__ import annotations

import time

import torch

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.io.feed import DeviceFeed
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.ops.kernels import _build
from front_end_tpu_torch.pipeline import vo, window_vo

# per-frame device scalars the check reads once the window has closed
VO_FIELDS = ("motion_ok", "n_detect_l", "n_detect_r", "n_stereo",
             "n_tracks", "n_inliers")
WINDOW_FIELDS = ("n_tracked", "ba_ran")


def make_rig(rig: dict) -> StereoRig:
    return StereoRig.create(fx=rig["fx"], fy=rig["fy"], cx=rig["cx"],
                            cy=rig["cy"], baseline=rig["baseline"],
                            width=rig["width"], height=rig["height"])


def vo_config(spec: dict) -> vo.VOConfig:
    kw = dict(spec)
    return vo.VOConfig(grid=grid.GridConfig(**kw.pop("grid")), **kw)


class Program:
    """One deployment's step: `vo_step` (entry `vo`) or `window_vo_step`
    (entry `window`), called through its module so that wrappers of the
    module's functions see every call."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.rig = make_rig(config["rig"])
        self.entry = config["entry"]
        cfg = vo_config(config["vo"])
        if self.entry == "window":
            w = dict(config["window"])
            self.cfg = window_vo.WindowVOConfig.create(
                cfg, window=w.pop("window"), capacity=w.pop("capacity"), **w)
            self.fields = VO_FIELDS + WINDOW_FIELDS
        elif self.entry == "vo":
            self.cfg = cfg
            self.fields = VO_FIELDS
        else:
            raise ValueError(f"unknown entry {self.entry!r}")

    def init_state(self, seed: int):
        mod = window_vo if self.entry == "window" else vo
        return mod.init_state(self.rig, self.cfg, seed=seed,
                              device=self.device)

    def step(self, state, left, right):
        if self.entry == "window":
            return window_vo.window_vo_step(state, left, right, self.rig,
                                            self.cfg)
        return vo.vo_step(state, left, right, self.rig, self.cfg)

    def frame(self, out):
        """The frame-to-frame outputs (the refined pose on `window`)."""
        return out.frame if self.entry == "window" else out

    def record(self, out) -> list:
        """This frame's scalars, as device tensors (no copy)."""
        f = self.frame(out)
        vals = [getattr(f, k) for k in VO_FIELDS]
        if self.entry == "window":
            vals += [getattr(out, k) for k in WINDOW_FIELDS]
        return vals

    def feed(self, source):
        """The port's feed at its default depth, as `cli vo` builds it."""
        return DeviceFeed(source, device=self.device)


class BuildClock:
    """While open, the seconds spent in the port's kernel builds that
    compiled something (`ops/kernels/_build.build`: nvcc at first use,
    once a checkout), and the number of libraries built."""

    def __init__(self):
        self.seconds = 0.0
        self.built = 0

    def __enter__(self):
        self._orig = orig = _build.build

        def timed(*names):
            todo = sum(not _build.library_path(n).exists() for n in names)
            t0 = time.perf_counter()
            try:
                return orig(*names)
            finally:
                if todo:
                    self.seconds += time.perf_counter() - t0
                    self.built += todo
        _build.build = timed
        return self

    def __exit__(self, *exc):
        _build.build = self._orig

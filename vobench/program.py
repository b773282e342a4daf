"""The system under test: the port's step that a configuration's `entry`
names (`vobench/entries/<entry>.py`, found by name), built from the
configuration file.  With the entry files, the only modules of the
harness that import the port (`front_end_tpu_torch`); the per-layer
readers name the port's functions they wrap by module path."""
from __future__ import annotations

import time
from pathlib import Path

import torch

from front_end_tpu_torch.io.feed import DeviceFeed
from front_end_tpu_torch.ops.kernels import _build
from vobench import check, spec
from vobench.entries._config import make_rig, vo_config  # noqa: F401


class Program:
    """One deployment's step, from the entry its configuration names."""

    def __init__(self, config: dict, device, root: Path = spec.ROOT):
        self.device = torch.device(device)
        self.entry = config["entry"]
        self._mod = spec.load_entry(self.entry, root)
        self.rig, self.cfg = self._mod.setup(config)
        self.fields = check.fields(self._mod)

    def init_state(self, seed: int):
        return self._mod.init_state(self.rig, self.cfg, seed, self.device)

    def step(self, state, left, right):
        return self._mod.step(state, left, right, self.rig, self.cfg)

    def frame(self, out):
        """The frame-to-frame outputs (`pose`, `motion_ok`)."""
        return self._mod.frame(out)

    def record(self, out) -> list:
        """This frame's compared scalars, as device tensors (no copy)."""
        return check.scalars(self._mod, out)

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

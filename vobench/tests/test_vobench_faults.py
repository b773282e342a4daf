"""A run with the timed path broken underneath comes out not correct:
the harness without its look for a card, on the CPU at a cut size."""
from __future__ import annotations

import pytest
import torch

from vobench import run
from vobench.program import Program

CELLS = ["kitti00-vo-brief.replay-mem", "euroc-mh01-window-surfext.replay-mem",
         "kitti00-vo-brief.replay-png", "euroc-mh01-window-surfext.camera-rate"]


class StateUnchanged(Program):
    """A step that returns the state it was given."""

    def step(self, state, left, right):
        _, out = super().step(state, left, right)
        return state, out


class PoseAltered(Program):
    """The pose of the fourth frame off by 1 cm where it is produced."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.n = 0

    def step(self, state, left, right):
        state, out = super().step(state, left, right)
        self.n += 1
        if self.n == 4:
            f = self.frame(out)
            pose = f.pose.clone()
            pose[0, 3] += 0.01
            f = f._replace(pose=pose)
            out = out._replace(frame=f) if self.entry == "window" else f
        return state, out


class CountAltered(Program):
    """The left detection count of every frame off by one."""

    def step(self, state, left, right):
        state, out = super().step(state, left, right)
        f = self.frame(out)
        f = f._replace(n_detect_l=f.n_detect_l + 1)
        out = out._replace(frame=f) if self.entry == "window" else f
        return state, out


class PixelsAltered(Program):
    """One pixel of the fourth pair off by one where the feed hands the
    pair to the step (after the decode, in the png cell)."""

    def feed(self, source):
        def altered(feed):
            for k, (left, right) in enumerate(feed):
                if k == 3:
                    left = left.clone()
                    left[0, 0] ^= 1
                yield left, right
        return altered(super().feed(source))


def _run(cell, cls, clock):
    return run.run_cell(cell, 1234567890123, 1.5, False, "cpu", clock,
                        program_cls=cls)


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name, tiny, clock):
    assert _run(tiny(name), Program, clock).correct


@pytest.mark.parametrize("fault", [StateUnchanged, PoseAltered,
                                   CountAltered, PixelsAltered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, tiny, clock):
    torch.manual_seed(0)
    res = _run(tiny(name), fault, clock)
    assert not res.correct, (fault.__name__, res.checks)
    if fault is PixelsAltered:
        assert res.checks["pixels_mismatch"]["value"] >= 1, res.checks

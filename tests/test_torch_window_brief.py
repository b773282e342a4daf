"""The windowed KITTI deployment at its production point
(`vobench/configs/kitti00-window-brief.json`: BRIEF-256, the Hamming
landmark tracker, W = 3, the BA every other frame at 2 iterations, as
`cli vo --kitti --window --ba-every 2 --ba-iters 2` runs it) steps through
the port's `window_vo_step`, built by the benchmark's `Program` from the
configuration file, as the plain reference (`vobench/reference/`) steps,
frame for frame, on the CPU.

The cut is `vobench/tests/conftest.py::shrink`'s: a quarter of the
resolution, 48 keypoints a grid cell, a 576-slot store, K = 128; 8 pairs,
so that the BA runs on frames 3, 5 and 7 and is skipped on the rest.
"""
import numpy as np
import pytest
import torch

from vobench import check, frames, spec
from vobench.program import Program
from vobench.reference import window_vo as ref_window
from vobench.tests.conftest import shrink

CELL = "kitti00-window-brief.replay-mem"
PAIRS = 8


def _scalars(out) -> dict:
    f = out.frame
    vals = {k: getattr(f, k) for k in check.COUNTS + ("n_inliers",)}
    vals.update(n_tracked=out.n_tracked, n_new=out.n_new,
                ba_ran=out.ba_ran)
    return {k: int(v) for k, v in vals.items()}


@pytest.mark.parametrize("seed", [2_147_483_659, 7])
def test_port_steps_as_the_reference(seed):
    cell = shrink(spec.load_cell(CELL), pairs=PAIRS)
    assert cell.config["window"] == {"window": 3, "ba_every": 2,
                                     "ba_iters": 2, "ba_max_landmarks": 128,
                                     "capacity": 576}
    assert cell.config["vo"]["descriptor"] == "brief"
    fr = frames.prepare(cell.config, cell.traffic, seed, "cpu")
    prog = Program(cell.config, "cpu")
    ref = check.Reference(cell.config, "cpu")
    assert prog.cfg.tracker.norm == ref.cfg.tracker.norm == "hamming"
    state = prog.init_state(frames.seed_of(seed))
    ref_state = ref_window.init_state(ref.rig, ref.cfg,
                                      seed=frames.seed_of(seed),
                                      device="cpu")
    got, want = [], []
    for i in range(PAIRS):
        left = torch.from_numpy(fr.lefts[i])
        right = torch.from_numpy(fr.rights[i])
        state, out = prog.step(state, left, right)
        ref_state, ref_out = ref_window.window_vo_step(
            ref_state, left, right, ref.rig, ref.cfg)
        got.append((_scalars(out), out.frame.pose, out.ba_cost))
        want.append((_scalars(ref_out), ref_out.frame.pose,
                     ref_out.ba_cost))
    # integer stages (detection, stereo, tracks, RANSAC consensus, the
    # tracker's associations and allocations, the host's BA schedule):
    # equal, frame by frame
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[0]["ba_ran"] for g in got] == [0, 0, 0, 1, 0, 1, 0, 1]
    assert all(g[0]["n_tracked"] > 0 for g in got[1:])
    # poses: the reference is the port's plain code frozen, so on one CPU
    # the same float32 operations run in the same order and the poses
    # agree bit for bit today; 1e-6 m is a few float32 ulps of the 5.6 m
    # the car covers in 8 frames, room for a sum one side reorders
    for (_, p, c), (_, q, d) in zip(got, want):
        assert torch.isfinite(p).all() and torch.isfinite(c)
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=0, atol=1e-6)
        # the BA's robust cost: relative, a float32 sum over up to K = 128
        # landmarks' residuals in the window
        np.testing.assert_allclose(float(c), float(d), rtol=1e-5, atol=0)

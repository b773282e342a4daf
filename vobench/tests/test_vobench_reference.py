"""The plain reference agrees with the port at a cut size on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vobench import check, frames, run
from vobench.program import Program


@pytest.mark.parametrize("name", ["kitti00-vo-brief.replay-mem",
                                  "euroc-mh01-window-surfext.replay-mem"])
def test_reference_equals_port(name, tiny):
    cell = tiny(name, pairs=6)
    fr = frames.prepare(cell.config, cell.traffic, 77, "cpu")
    prog = Program(cell.config, "cpu")
    w = run.run_window(prog, fr, cell.traffic, 77, 1e9, max_frames=6)
    fields = {k: w.scalars[:, j] for j, k in enumerate(prog.fields)}
    poses, vals = run.reference_run(fr, cell.traffic, 77, cell.config,
                                    "cpu", 6)
    for k in check.COUNTS + ("n_inliers",):
        assert np.array_equal(fields[k], vals[k]), k
    if "n_tracked" in vals:
        assert np.array_equal(fields["n_tracked"], vals["n_tracked"])
    np.testing.assert_allclose(w.poses, poses, atol=1e-6)
    gaps = check.gaps(w.poses, fields, poses, vals)
    assert check.judge(gaps, cell.config["check"])[0]


def test_gaps_read_relative_motion():
    eye = np.tile(np.eye(4), (3, 1, 1))
    moved = eye.copy()
    moved[1:, 2, 3] = 1.0               # a 1 m step at frame 1, then none
    vals = {k: np.zeros(3) for k in check.COUNTS + ("n_inliers",)}
    g = check.gaps(eye, vals, moved, vals)
    assert g["motion_gap_m"] == pytest.approx(1.0)
    assert g["motion_gap_deg"] == pytest.approx(0.0, abs=1e-12)
    rot = eye.copy()
    c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
    rot[2, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    assert check.gaps(eye, vals, rot, vals)["motion_gap_deg"] == \
        pytest.approx(2.0)
    bad = dict(vals, n_stereo=np.array([0.0, 1.0, 0.0]))
    assert check.gaps(eye, bad, eye, vals)["counts_mismatch"] == 1.0


def test_judge_fails_a_number_over_its_limit_or_not_finite():
    lim = {"counts_mismatch": 0, "motion_gap_m": 1e-3}
    assert check.judge({"counts_mismatch": 0.0, "motion_gap_m": 1e-4},
                       lim)[0]
    assert not check.judge({"counts_mismatch": 1.0, "motion_gap_m": 0.0},
                           lim)[0]
    assert not check.judge({"counts_mismatch": 0.0,
                            "motion_gap_m": float("nan")}, lim)[0]


def test_control_switches_tf32_inside_the_reference_only():
    from vobench.reference import precision
    seen = []

    @precision.f32_precision
    def probe():
        seen.append(torch.backends.cuda.matmul.allow_tf32)
    probe()
    check.control(probe)
    probe()
    assert seen == [False, True, False]

"""The metric arithmetic on hand-made inputs."""
from __future__ import annotations


import numpy as np
import pytest

from vobench import roofline, spec, stats, trace


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 200, 1001):
        v = rng.exponential(size=n).tolist()
        for q in (0, 25, 50, 95, 100):
            assert stats.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)), rel=1e-12)


def test_p95_of_a_known_ramp():
    # 1..200 ms: rank 0.95 * 199 = 189.05 -> 190.05
    assert stats.percentile(list(range(1, 201)), 95) == pytest.approx(190.05)


def test_traced_tail_reads_the_frames_after_the_profiled_ones():
    reader = spec.load_layer("frame_ms_p95.traced")
    tr = trace.Trace(spans={"frame_s": [k / 1e3 for k in range(1, 201)]},
                     frames=200, profile=None, profiled_frames=20, config={})
    assert reader.read(tr) == pytest.approx(190.05)
    assert reader.read(trace.Trace({}, 0, None, 20, {})) is None


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.union_length(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_share_of_a_profile():
    p = trace.Profile(device=[("k", "kernel", 0.0, 0.25),
                              ("Memcpy HtoD", "memcpy", 0.2, 0.3),
                              ("k", "kernel", 0.5, 0.6)],
                      window=(0.0, 1.0), host=[(0.3, 0.45, "aten::mul")])
    assert p.busy_s() == pytest.approx(0.4)
    b = trace.breakdown(p)
    assert b["idle_gaps"][0] == ["(python between operations)",
                                 pytest.approx(0.4)]
    assert ["aten::mul", pytest.approx(0.2)] in b["idle_gaps"]
    assert b["device_ops"][0] == ["k", pytest.approx(0.35)]


def test_open_loop_idle_is_read_inside_the_frames():
    """With frames marked (an open loop), idle time counts only while a
    frame is in the loop's hands: the wait for the next due frame is
    none of the card's idle time, in the breakdown and per frame."""
    p = trace.Profile(device=[("k", "kernel", 0.1, 0.2),
                              ("k", "kernel", 0.6, 0.65)],
                      window=(0.0, 1.0), host=[(0.22, 0.28, "aten::mul")],
                      active=[(0.05, 0.3), (0.55, 0.7)])
    assert p.idle() == [pytest.approx(g) for g in
                        [(0.05, 0.1), (0.2, 0.3), (0.55, 0.6), (0.65, 0.7)]]
    b = trace.breakdown(p)
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(0.25)
    assert ["aten::mul", pytest.approx(0.1)] in b["idle_gaps"]
    tr = trace.Trace(spans={}, frames=0, profile=p, profiled_frames=2,
                     config={})
    assert spec.load_layer("frame_idle_ms").read(tr) == pytest.approx(125.0)
    assert spec.load_layer("device_idle_pct").read(tr) == pytest.approx(85.0)
    p.active = []               # a closed loop: the whole window
    assert p.idle() == [pytest.approx(g) for g in
                        [(0.0, 0.1), (0.2, 0.6), (0.65, 1.0)]]
    assert spec.load_layer("frame_idle_ms").read(tr) is None


def test_fast_grid_bytes():
    # two 376 x 1241 float32 images and (2, 2, 3) thresholds read; per cell
    # of 188 x 413 a 94 x 207 pooled map (float32 + uint8) and a count
    by = 2 * 376 * 1241 * 4 + 12 * 4 + 12 * 94 * 207 * 5 + 12 * 4
    assert roofline.fast_grid_seconds(2, 376, 1241, 2, 3) == pytest.approx(
        by / 3.35e12)


def test_match_bound_is_the_tensor_or_core_pipe():
    nq = nt = 2304
    pairs = nq * nt
    ops_core = pairs * 12 / 33.5e12
    ops_tensor = pairs * 2 * 32 * 8 / 1979e12
    by = 2 * 2304 * (32 + 8 + 1) + 2304 * 12 + 2304 * 8
    assert roofline.match_seconds(nq, nt, 8) == pytest.approx(
        max(by / 3.35e12, ops_core, ops_tensor))
    assert ops_core > ops_tensor > by / 3.35e12   # the CUDA cores bound it

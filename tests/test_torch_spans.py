"""Spans and counters inside the port (`pipeline/telemetry.py`): off by
default, with nothing recorded and no profiler range opened; inside
`recording()` the span tree and frame ids of `vo_step`, `window_vo_step`
and `DeviceFeed` over a KITTI layout, outputs equal to the run with the
recording off bit for bit, the LM's range around its solve in a CPU
profile, the counters' reduction, and the arithmetic of the card-side
probe of them (`vobench/spans.py`) on hand-built events.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.io.feed import DeviceFeed
from front_end_tpu_torch.io.kitti import KittiSequence
from front_end_tpu_torch.motion import lm
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import cuda_graphs, telemetry, vo, window_vo
from front_end_tpu_torch.sim.sequence import make_sequence
from torch_parity import pan_poses, write_kitti

N_FRAMES = 4
VO_TREE = {("vo.step", None), ("vo.extract", "vo.step"),
           ("vo.motion", "vo.step"), ("vo.ransac", "vo.motion"),
           ("vo.lm", "vo.motion")}
WINDOW_TREE = (VO_TREE - {("vo.step", None)}) | {
    ("window.step", None), ("vo.step", "window.step"),
    ("window.tracker", "window.step"), ("tracker.match", "window.tracker"),
    ("window.ba", "window.step")}


def _rig():
    return StereoRig.create(fx=120.0, cx=79.5, cy=59.5, baseline=0.4,
                            width=160, height=120)


def _cfg():
    return vo.VOConfig(
        grid=grid.GridConfig(cell_capacity=64, set_point=120,
                             init_threshold=10.0),
        ransac_hyps=64, ransac_threshold=0.3, max_disparity=48.0,
        desc_bytes=16)


def _frames(k, seed=0):
    """A blocky texture panned 2 px a frame at a 6 px disparity."""
    r = np.random.RandomState(seed)
    base = np.kron(r.uniform(30, 220, (15, 20)),
                   np.ones((8, 8))).astype(np.float32)
    L, R = [], []
    for i in range(k):
        left = np.roll(base, 2 * i, axis=1)
        L.append(left + r.uniform(0, 2, left.shape).astype(np.float32))
        R.append(np.roll(left, -6, axis=1)
                 + r.uniform(0, 2, left.shape).astype(np.float32))
    return np.stack(L), np.stack(R)


def _path(windowed, **window_kw):
    """(step, initial state, config) of one of the two paths."""
    rig, cfg = _rig(), _cfg()
    if windowed:
        wcfg = window_vo.WindowVOConfig.create(cfg, window=3,
                                               ba_max_landmarks=64,
                                               **window_kw)
        return (lambda s, a, b: window_vo.window_vo_step(s, a, b, rig, wcfg),
                window_vo.init_state(rig, wcfg, seed=3, device="cpu"), wcfg)
    return (lambda s, a, b: vo.vo_step(s, a, b, rig, cfg),
            vo.init_state(rig, cfg, seed=3, device="cpu"), cfg)


def _run(windowed, k=N_FRAMES, **window_kw):
    step, state, _ = _path(windowed, **window_kw)
    L, R = _frames(k)
    outs = []
    for i in range(k):
        state, out = step(state, L[i], R[i])
        outs.append(out)
    return outs


def _tensors(outs):
    for out in outs:
        for leaf in (out if not hasattr(out, "frame") else
                     (*out.frame, *out[1:])):
            yield leaf


@pytest.fixture
def no_recording():
    assert telemetry._active is None
    yield
    assert telemetry._active is None, "a test left a recording open"


@pytest.mark.parametrize("windowed", [False, True], ids=["vo", "window"])
def test_off_records_nothing_and_opens_no_profiler_range(windowed,
                                                         no_recording):
    assert telemetry.span("vo.step", 0) is telemetry.span("vo.lm")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(windowed)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.split(".")[0] in
                ("vo", "window", "feed", "io")}
    assert "aten::linalg_solve_ex" in names


@pytest.mark.parametrize("windowed", [False, True], ids=["vo", "window"])
def test_span_tree_frames_and_outputs_bit_for_bit(windowed, no_recording):
    off = _run(windowed)
    with telemetry.recording() as rec:
        on = _run(windowed)
    for a, b in zip(_tensors(off), _tensors(on)):
        assert torch.equal(a, b)
    assert {(s.name, s.parent) for s in rec.spans} == (
        WINDOW_TREE if windowed else VO_TREE)
    root = "window.step" if windowed else "vo.step"
    assert [s.frame for s in rec.spans if s.name == root] == \
        list(range(N_FRAMES))
    by_frame = {}
    for s in rec.spans:
        by_frame.setdefault(s.frame, set()).add(s.name)
        assert s.t1_ns >= s.t0_ns and s.thread == threading.get_ident()
    for f in range(N_FRAMES):
        ba = not windowed or f >= 2          # W = 3: the BA from frame 2
        assert by_frame[f] == {n for n, _ in (
            WINDOW_TREE if windowed else VO_TREE)} - (
                set() if ba else {"window.ba"}), f
    # every child lies inside its parent's interval
    spans = {(s.name, s.frame): s for s in rec.spans}
    for s in rec.spans:
        if s.parent is not None:
            p = spans[(s.parent, s.frame)]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    secs = rec.seconds()
    assert set(secs[root]) == set(range(N_FRAMES))
    assert all(secs["vo.lm"][f] < secs[root][f] for f in secs["vo.lm"])


def test_feed_over_a_kitti_sequence_spans_each_item(tmp_path, no_recording):
    L, R = make_sequence(3, 48, 64)
    write_kitti(str(tmp_path), L, R, fx=60.0, baseline=0.3,
                poses=pan_poses(3, 0.3))
    seq = KittiSequence(str(tmp_path), "00")
    with telemetry.recording() as rec:
        got = list(DeviceFeed(seq.frames(), device="cpu", first_frame=5))
    assert len(got) == 3
    main = threading.get_ident()
    decode = [s for s in rec.spans if s.name == "io.decode"]
    assert sorted(s.frame for s in decode) == [5, 5, 6, 6, 7, 7]
    assert {s.parent for s in decode} == {"feed.source"}
    put = [s for s in rec.spans if s.name == "feed.put"]
    wait = [s for s in rec.spans if s.name == "feed.wait"]
    source = [s for s in rec.spans if s.name == "feed.source"]
    assert [s.frame for s in put] == [5, 6, 7]
    # the last pull finds the source exhausted; the consumer waits for its
    # end-of-feed mark too
    assert [s.frame for s in source] == [5, 6, 7, 8]
    assert [s.frame for s in wait] == [5, 6, 7, 8]
    assert {s.thread for s in wait} == {main}
    assert main not in {s.thread for s in decode + put + source}
    assert {s.parent for s in put + source + wait} == {None}


def test_inline_feed_spans_on_the_consumer(no_recording):
    L, R = _frames(2)
    with telemetry.recording() as rec:
        got = list(DeviceFeed(zip(L, R), device="cpu", threaded=False))
    assert len(got) == 2
    assert [(s.name, s.frame) for s in rec.spans] == [
        ("feed.source", 0), ("feed.put", 0), ("feed.source", 1),
        ("feed.put", 1), ("feed.source", 2)]


def test_lm_range_holds_its_solve_in_a_cpu_profile(no_recording):
    with telemetry.recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(False)
    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.name() == "vo.lm"]
    solves = [e.start_ns() for e in events
              if e.name() == "aten::linalg_solve_ex"]
    assert len(ranges) == N_FRAMES
    assert len(solves) == N_FRAMES * vo.VOConfig().lm_iters
    assert all(any(a <= t <= b for a, b in ranges) for t in solves)
    # the spans, moved by the recording's clock offset, fall on the
    # profiler's ranges (the offset is read once; allow 1 ms of drift)
    lm_spans = [s for s in rec.spans if s.name == "vo.lm"]
    for s, (a, b) in zip(lm_spans, ranges):
        assert abs(s.t0_ns + rec.clock_offset_ns - a) < 1e6
        assert abs(s.t1_ns + rec.clock_offset_ns - b) < 1e6


def test_counters_reduce_to_at_most_iters_accepted(no_recording):
    _, _, wcfg = _path(True)
    with telemetry.recording() as rec:
        _run(True)
    c = rec.counters()
    lm_iters, ba_iters = wcfg.vo.lm_iters, wcfg.ba_iters
    for name, iters, calls in (("lm.accepted", lm_iters, N_FRAMES),
                               ("ba.accepted", ba_iters, N_FRAMES - 2)):
        vals = c[name]
        assert len(vals) == iters * calls
        assert {v for _, v in vals} <= {0.0, 1.0}
        per_frame = {}
        for f, v in vals:
            per_frame[f] = per_frame.get(f, 0) + v
        assert all(0 <= v <= iters for v in per_frame.values())
    assert c["ba.accepted"] and any(v for _, v in c["ba.accepted"])
    lands = c["ba.landmarks"]
    assert [f for f, _ in lands] == [2, 3]
    assert all(0 < v <= wcfg.ba_max_landmarks for _, v in lands)
    # one count each: the log's per-frame totals
    log = telemetry.TelemetryLog()
    for _ in range(N_FRAMES):
        log.add_frame([telemetry.ProcTime("frame", 0.1)])
    telemetry.add_recording(log, rec, range(N_FRAMES))
    assert log.counters["ba.landmarks"][:2] == [0.0, 0.0]
    assert [r.label for r in log.frames[0]] == [
        "frame", "tracker.match", "vo.extract", "vo.lm", "vo.motion",
        "vo.ransac", "vo.step", "window.step", "window.tracker"]


def _every_other(k):
    """k windowed frames at the production schedule (W = 3, the BA every
    other frame, 2 iterations) -> outputs."""
    return _run(True, k, ba_every=2, ba_iters=2)


def test_tracker_match_and_window_counters_at_ba_every_2(no_recording):
    """`tracker.match` nests in `window.tracker` each frame; `window.ba_ran`
    follows the schedule (frames ingested >= W and even: frames 3 and 5
    of 6); `tracker.tracked` and `tracker.new` are the step's `n_tracked`
    and `n_new`."""
    k = 6
    with telemetry.recording() as rec:
        outs = _every_other(k)
    match = [s for s in rec.spans if s.name == "tracker.match"]
    assert [s.frame for s in match] == list(range(k))
    assert {s.parent for s in match} == {"window.tracker"}
    parents = {s.frame: s for s in rec.spans if s.name == "window.tracker"}
    for s in match:
        p = parents[s.frame]
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    c = rec.counters()
    assert c["window.ba_ran"] == [(f, float(f in (3, 5))) for f in range(k)]
    assert [bool(o.ba_ran) for o in outs] == [f in (3, 5) for f in range(k)]
    assert [f for f, _ in c["ba.landmarks"]] == [3, 5]
    for name, field in (("tracker.tracked", "n_tracked"),
                        ("tracker.new", "n_new")):
        assert c[name] == [(f, float(getattr(o, field)))
                           for f, o in enumerate(outs)], name
    assert sum(v for _, v in c["tracker.tracked"][1:]) > 0
    assert all(v > 0 for _, v in c["tracker.new"])


def test_window_spans_and_counters_off_store_nothing(monkeypatch,
                                                     no_recording):
    """With no recording open the new span and counters store nothing:
    no open span is made and no recording's stack is read."""
    def stored(*a, **k):
        raise AssertionError("recorded with the recording off")
    monkeypatch.setattr(telemetry._Open, "__init__", stored)
    monkeypatch.setattr(telemetry.Recording, "_stack", stored)
    assert telemetry.span("tracker.match") is telemetry._OFF
    outs = _every_other(4)
    assert [bool(o.ba_ran) for o in outs] == [False, False, False, True]


def test_refine_motion_counts_each_iteration(no_recording):
    rig = _rig()
    g = torch.Generator().manual_seed(0)
    X = torch.rand(50, 3, generator=g) * torch.tensor([4.0, 3.0, 5.0]) \
        + torch.tensor([-2.0, -1.5, 4.0])
    uv = rig.project4(X)
    with telemetry.recording() as rec:
        res = lm.refine_motion(torch.eye(4), X, uv + 0.5,
                               torch.ones(50, dtype=torch.bool), rig,
                               iters=3)
    vals = rec.counters()["lm.accepted"]
    assert len(vals) == 3 and [f for f, _ in vals] == [None] * 3
    assert float(res.cost) <= float(res.cost0)


def _lm_problem(n=50, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 3.0, 5.0]) \
        + torch.tensor([-2.0, -1.5, 4.0])
    uv = _rig().project4(X) + torch.rand(n, 4, generator=g)
    return X, uv, torch.rand(n, generator=g) < 0.8


@pytest.mark.parametrize("case", ["cpu", "vmap", "grad", "capture"])
def test_refine_motion_runs_eagerly_where_no_graph_serves(case, monkeypatch,
                                                          no_recording):
    """CPU tensors, a `torch.func.vmap` (the study's), inputs that require
    grad and a call inside a capture run `_refine` eagerly and capture
    nothing; `lm.graph` is not counted on the CPU, and a capture keeps no
    count at all."""
    rig, eye = _rig(), torch.eye(4)
    X, uv, valid = _lm_problem()
    calls = []
    graphs = lm._refine_graphs
    eager = graphs.body

    def spy(*a):
        calls.append(a[1].shape)
        return eager(*a)

    def no_graph(*a):
        raise AssertionError("no graph can serve these inputs")

    monkeypatch.setattr(graphs, "body", spy)
    monkeypatch.setattr(graphs, "_replay", no_graph)
    if case == "capture":
        monkeypatch.setattr(cuda_graphs, "_capturing", lambda: True)
    if case == "grad":
        X.requires_grad_(True)
    with telemetry.recording() as rec:
        if case == "vmap":
            H = torch.func.vmap(
                lambda Xb, uvb: lm.refine_motion(eye, Xb, uvb, valid, rig,
                                                 iters=3).H)(
                torch.stack([X, X + 0.1]), torch.stack([uv, uv]))
            assert H.shape == (2, 4, 4)
        else:
            res = lm.refine_motion(eye, X, uv, valid, rig, iters=3)
    assert calls == [X.shape]
    assert not graphs.graphs
    c = rec.counters()
    assert "lm.graph" not in c
    kept = {"cpu": 3, "grad": 3, "vmap": 0, "capture": 0}[case]
    assert len(c.get("lm.accepted", [])) == kept
    if case == "grad":
        res.cost.backward()
        assert X.grad is not None and bool(torch.isfinite(X.grad).all())
    elif case != "vmap":
        with telemetry.diverted() as counts:
            ref = eager(eye, X, uv, valid, rig, 3, 3.0, 1e-3)
        accepts = [v for _, v in counts]
        assert all(torch.equal(a, b) for a, b in zip(res, ref))
        assert [v for _, v in c.get("lm.accepted", [])] == (
            [float(a) for a in accepts] if kept else [])


def test_counts_inside_vmap_are_not_kept(no_recording):
    def f(x):
        telemetry.count("t", x > 0)
        telemetry.count("n", 2)
        return x * 2
    with telemetry.recording() as rec:
        torch.func.vmap(f)(torch.tensor([1.0, -1.0]))
    assert rec.counters() == {"n": [(None, 2.0)]}


def test_one_recording_at_a_time(no_recording):
    with telemetry.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with telemetry.recording():
                pass
        assert telemetry._active is not None
    assert telemetry._active is None


def test_threads_keep_their_own_parents(no_recording):
    """More threads than cores, switching often: every span is kept, each
    child names its own thread's parent and frame."""
    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.recording() as rec:
            def work(k):
                for i in range(n_spans):
                    with telemetry.span("outer", 1000 * k + i):
                        with telemetry.span("inner"):
                            telemetry.count("c", k)
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 2 * n_threads * n_spans
    outer = {s.frame: s.thread for s in rec.spans if s.name == "outer"}
    for s in rec.spans:
        if s.name == "inner":
            assert s.parent == "outer" and outer[s.frame] == s.thread
    counts = rec.counters()["c"]
    assert len(counts) == n_threads * n_spans
    assert all(v == f // 1000 for f, v in counts)


def _events():
    """A profiled window of two frames on thread 1 (spans `vo.step` ⊃
    `vo.lm`), in seconds, with the launch calls' correlation ids."""
    host = [(0.0, 1.0, "vo.step", 0, 1), (0.1, 0.5, "vo.lm", 0, 1),
            (0.2, 0.21, "cudaLaunchKernel", 11, 1),
            (0.25, 0.26, "cudaMemcpyAsync", 12, 1),
            (0.3, 0.31, "cuLaunchKernel", 13, 1),
            (0.6, 0.61, "cudaLaunchKernel", 14, 1),
            (1.05, 1.06, "cudaLaunchKernel", 15, 1),      # between steps
            (1.1, 2.0, "vo.step", 0, 1), (1.3, 1.6, "vo.lm", 0, 1),
            (1.4, 1.41, "cudaLaunchKernelExC", 16, 1),
            (1.5, 1.51, "cudaLaunchKernel", 17, 2),       # another thread
            (1.2, 1.8, "feed.put", 0, 2)]
    device = [(0.22, 0.3, "k_a", 11), (0.27, 0.28, "Memcpy HtoD", 12),
              (0.32, 0.4, "k_b", 13), (0.62, 0.7, "k_c", 14),
              (1.07, 1.08, "k_d", 15), (1.42, 1.5, "k_e", 16),
              (1.52, 1.6, "k_f", 17)]
    return (0.0, 2.0), 1, host, device


def test_probe_gives_each_kernel_and_idle_gap_its_span():
    from vobench import spans
    window, tid, host, device = _events()
    names = {"vo.step", "vo.lm", "feed.put"}
    got = spans.attribute(window, tid, host, device, names, frames=2)
    assert got["kernels"] == 6 / 2
    # vo.lm holds k_a, k_b (frame 0) and k_e (frame 1); vo.step also k_c;
    # k_d between the steps, k_f launched by the feed's thread
    assert got["launches_inside"] == {"vo.lm": 3 / 2, "vo.step": 4 / 2}
    assert got["launches_elsewhere"] == {spans.OUTSIDE: 1 / 2,
                                         spans.OTHER_THREAD: 1 / 2}
    idle = got["idle_ms"]
    # gaps (mid): 0-0.22 (0.11) lm, 0.3-0.32 lm, 0.4-0.62 (0.51) step,
    # 0.7-1.07 step, 1.08-1.42 (1.25) step, 1.5-1.52 lm, 1.6-2.0 step
    assert idle == pytest.approx(
        {"vo.step": 1e3 * (0.22 + 0.37 + 0.34 + 0.4) / 2,
         "vo.lm": 1e3 * (0.22 + 0.02 + 0.02) / 2})
    assert list(idle) == ["vo.step", "vo.lm"]
    assert got["window_ms"] == 1e3
    # the feed's spans are on another thread: no gap or launch is theirs
    assert "feed.put" not in got["launches_inside"]


def test_probe_innermost_span_of_nested_ranges():
    from vobench import spans
    ranges = [(0.0, 10.0, "a"), (1.0, 5.0, "b"), (2.0, 3.0, "c"),
              (6.0, 7.0, "d")]
    starts = [r[0] for r in ranges]
    assert [spans.innermost(ranges, starts, t) for t in
            (0.5, 1.5, 2.5, 4.0, 5.5, 6.5, 11.0, -1.0)] == \
        ["a", "b", "c", "b", "a", "d", spans.OUTSIDE, spans.OUTSIDE]


def test_probe_phase_figures_leave_out_frame_0_and_later_items(
        no_recording):
    """Host ms a frame over the phase's frames (the feed's prefetched
    items past them dropped), counter rates from frame 1 on."""
    from vobench import spans
    with telemetry.recording() as rec:
        for f in range(3):
            with telemetry.span("vo.step", f):
                with telemetry.span("vo.lm"):
                    for ok in (True, False):
                        telemetry.count("lm.accepted", torch.tensor(ok))
                telemetry.count("ba.landmarks",
                                torch.ones(10 * (f + 1), dtype=torch.bool))
        with telemetry.span("feed.source", 3):
            pass
    rec.spans[:] = [s._replace(t1_ns=s.t0_ns + 1_000_000)
                    for s in rec.spans]         # 1 ms each
    fig = spans.phase_figures(rec, frames=3)
    assert fig["host_ms"] == {"feed.source": 0.0, "vo.lm": 1.0,
                              "vo.step": 1.0}
    assert fig["counters"] == {"ba.landmarks_mean": 25.0,
                               "ba.landmarks_n": 2,
                               "lm.accepted_pct": 50.0,
                               "lm.accepted_n": 4}


def test_probe_times_a_call_off_and_on(no_recording):
    from vobench import spans
    us = spans.per_call_us(telemetry, calls=50)
    assert set(us) == {"empty_call", "span_off", "count_off", "span_on",
                       "count_on"}
    assert all(v > 0 for v in us.values())
    assert telemetry._active is None

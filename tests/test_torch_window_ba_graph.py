"""The windowed BA's dispatch (`window/tracker.py::run_window_ba`) on the
CPU: CPU tensors, a process group, inputs that require grad and calls
inside a capture run the eager body `_window_ba` and capture nothing;
`ba.graph` is counted for CUDA calls only; the eager body equals the
frozen plain reference bit for bit and counts what the solve counted
before it was split out; `window_vo_step` reaches the BA through the
module attribute the benchmark's `ba_ms` wraps; `telemetry.diverted`.
The replay itself runs on the card (`tests/test_torch_cuda.py -k ba_`).
"""
import threading

import pytest
import torch

from _window_ba_problem import eager, window_state
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.pipeline import telemetry
from front_end_tpu_torch.window import tracker


def _rig():
    """EuRoC MH_01's cam0 rig (`vobench/configs/`)."""
    return StereoRig.create(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                            baseline=0.11, width=752, height=480)


@pytest.fixture
def no_recording():
    assert telemetry._active is None
    yield
    assert telemetry._active is None, "a test left a recording open"


@pytest.fixture
def no_graph(monkeypatch):
    """The eager body's calls, with the replay refused."""
    calls = []
    body = tracker._window_ba

    def spy(*a):
        calls.append(a[-1])             # the group
        return body(*a)

    def refuse(*a):
        raise AssertionError("no graph can serve these inputs")

    monkeypatch.setattr(tracker, "_window_ba", spy)
    monkeypatch.setattr(tracker, "_replay", refuse)
    return calls


def _same(got, ref):
    (state, res), (Xw, ref_res) = got, ref
    assert torch.equal(state.store.Xw, Xw)
    assert torch.equal(state.poses, ref_res.poses)
    assert all(torch.equal(a, b) for a, b in zip(res, ref_res))


@pytest.mark.parametrize("case", ["cpu", "grad", "capture", "group"])
def test_window_ba_runs_eagerly_where_no_graph_serves(case, monkeypatch,
                                                      tmp_path, no_graph,
                                                      no_recording):
    """No graph is captured or replayed; `ba.graph` is not counted on the
    CPU, and a capture keeps no count at all.  The group's solve (one
    rank) is the sharded one, with its collectives."""
    import torch.distributed as dist
    rig = _rig()
    st = window_state(rig, 192, seed=1)
    ref = eager(st, rig, iters=4, max_landmarks=64)
    no_graph.clear()
    if case == "capture":
        monkeypatch.setattr(tracker, "_capturing", lambda: True)
    if case == "grad":
        st = st._replace(store=st.store._replace(
            Xw=st.store.Xw.clone().requires_grad_(True)))
    group = None
    if case == "group":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
        group = dist.group.WORLD
    try:
        with telemetry.recording() as rec:
            got = tracker.run_window_ba(st, rig, iters=4, max_landmarks=64,
                                        group=group)
    finally:
        if group is not None:
            dist.destroy_process_group()
    assert no_graph == [group]
    assert not tracker._graphs
    c = rec.counters()
    assert "ba.graph" not in c
    if case == "capture":
        assert c == {}
    else:
        assert len(c["ba.accepted"]) == 4 and len(c["ba.landmarks"]) == 1
    if case == "grad":
        got[1].cost.backward()
        assert bool(torch.isfinite(st.store.Xw.grad).all())
    if case == "group":
        torch.testing.assert_close(got[0].store.Xw, ref[0], rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(got[1].poses, ref[1].poses, rtol=0,
                                   atol=1e-5)
    else:
        _same(got, ref)


# ba.accepted (one 0/1 an iteration) and ba.landmarks of the solve before
# its body was split out, on `window_state(_rig(), 192, seed=5)`
PARENT_COUNTS = {
    (64, 6): ([1.0, 1.0, 1.0, 1.0, 0.0, 1.0], [64.0]),
    (None, 6): ([1.0, 1.0, 1.0, 1.0, 0.0, 0.0], [127.0]),
    (64, 2): ([1.0, 1.0], [64.0]),
    (None, 2): ([1.0, 1.0], [127.0]),
}


@pytest.mark.parametrize("K,iters", list(PARENT_COUNTS),
                         ids=["compacted-6", "full-6", "compacted-2",
                              "full-2"])
def test_window_ba_counts_as_before(K, iters, no_recording):
    rig = _rig()
    with telemetry.recording() as rec:
        tracker.run_window_ba(window_state(rig, 192, seed=5), rig,
                              iters=iters, max_landmarks=K)
    c = rec.counters()
    accepted, landmarks = PARENT_COUNTS[K, iters]
    assert [v for _, v in c["ba.accepted"]] == accepted
    assert [v for _, v in c["ba.landmarks"]] == landmarks
    assert set(c) == {"ba.accepted", "ba.landmarks"}


@pytest.mark.parametrize("K", [64, None], ids=["compacted", "full"])
def test_window_ba_body_equals_the_frozen_reference(K):
    """The eager body is the solve as it stood: the plain reference
    (`vobench/reference/tracker.py`) gives the same bits on the CPU."""
    from vobench.reference import tracker as ref_tracker
    from vobench.reference.camera import StereoRig as RefRig
    rig = _rig()
    st = window_state(rig, 192, seed=2)
    ref_rig = RefRig(**{f: getattr(rig, f) for f in
                        ("fx", "fy", "cx", "cy", "baseline", "width",
                         "height")})
    ref_state, ref_res = ref_tracker.run_window_ba(st, ref_rig, iters=6,
                                                   max_landmarks=K)
    _same(tracker.run_window_ba(st, rig, iters=6, max_landmarks=K),
          (ref_state.store.Xw, ref_res))


@pytest.mark.parametrize("ba_every", [1, 2])
def test_window_vo_step_calls_the_ba_by_module_attribute(ba_every,
                                                         monkeypatch,
                                                         no_recording):
    """A wrapper put in place of `tracker.run_window_ba` (as the
    benchmark's `ba_ms` reader puts its own) sees every BA call."""
    from test_torch_spans import _run
    seen = []
    solve = tracker.run_window_ba

    def wrapper(state, *a, **k):
        seen.append(state.frame_idx)
        return solve(state, *a, **k)

    monkeypatch.setattr(tracker, "run_window_ba", wrapper)
    outs = _run(True, 6, ba_every=ba_every, ba_iters=2)
    ran = [i + 1 for i, o in enumerate(outs) if bool(o.ba_ran)]
    assert seen == ran == [f for f in range(3, 7) if f % ba_every == 0]


def test_diverted_takes_this_threads_counts(no_recording):
    """Counts inside `diverted()` go to its list, recording or not, and
    nest; another thread's counts and those after the block go to the
    recording."""
    with telemetry.diverted() as off:
        telemetry.count("a", 1)
    assert off == [("a", 1)]
    with telemetry.recording() as rec:
        with telemetry.diverted() as outer:
            telemetry.count("b", 2)
            with telemetry.diverted() as inner:
                telemetry.count("c", torch.tensor(True))
            t = threading.Thread(target=telemetry.count, args=("d", 4))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            telemetry.count("e", 5)
        telemetry.count("f", 6)
    assert [n for n, _ in outer] == ["b", "e"]
    assert [n for n, _ in inner] == ["c"]
    assert rec.counters() == {"d": [(None, 4.0)], "f": [(None, 6.0)]}
    assert not telemetry._sinks

"""The open loop on a fake clock, the open cells at a cut size on the CPU,
and a step found by the entry its configuration names."""
from __future__ import annotations

import json
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from front_end_tpu_torch.io.feed import DeviceFeed
from vobench import frames as frames_mod, run, spec, trace
from vobench.program import Program

OPEN_CELL = "euroc-mh01-window-surfext.camera-rate"


def open_cell(config: str) -> spec.Cell:
    """A configuration's cell under the camera-rate mix, cut by `shrink`:
    the benchmark's, or one built as the benchmark would list it."""
    from conftest import shrink
    b = spec.load_json(spec.ROOT / "BENCHMARK.json")
    name = f"{config}.camera-rate"
    if name not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append({"name": name, "config": config,
                               "traffic": "camera-rate", "chips": 1,
                               "why": "x"})
        for m in b["end_to_end"] + b["per_layer"]:
            if OPEN_CELL in m.get("workloads", ()):
                m["workloads"].append(name)
    return shrink(spec.load_cell(name, b))


class FakeClock:
    """Time moves only when a test or a sleeper moves it."""

    def __init__(self):
        self.t = 100.0

    def now(self) -> float:
        return self.t

    def sleep_until(self, t: float, stop: threading.Event):
        if not stop.is_set():
            self.t = max(self.t, t)


def toy_frames(n: int = 6, hz: float = 8.0) -> frames_mod.Frames:
    imgs = np.arange(n * 4 * 5, dtype=np.uint8).reshape(n, 4, 5)
    return frames_mod.Frames(imgs, imgs[::-1].copy(),
                             np.tile(np.eye(4), (n, 1, 1)), None, hz)


OPEN = {"source": "mem", "loop": "open", "rate": "camera_hz",
        "replay": "pingpong"}


def test_open_source_hands_frames_over_at_their_due_time():
    clock = FakeClock()
    src = frames_mod.Source(toy_frames(hz=8.0), OPEN, clock)
    assert src.rate == 8.0
    src.start(clock.now())
    it = iter(src)
    handed = []
    for k in range(7):
        next(it)
        handed.append(clock.now())
        if k == 2:
            clock.t += 0.5          # the loop stalls 0.5 s on frame 2
    due = [src.due(k) for k in range(7)]
    assert all(h >= d for h, d in zip(handed, due))
    assert src.lags[:3] == [0.0, 0.0, 0.0]
    # frames 3-5 fell due during the stall: handed over at once, late
    assert handed[3] == handed[4] == handed[5] == due[2] + 0.5
    assert src.lags[3:6] == pytest.approx([0.375, 0.25, 0.125])
    assert src.lags[6] == 0.0       # caught up: frame 6 waits for its time


def test_open_source_waits_for_start_and_stops():
    src = frames_mod.Source(toy_frames(), OPEN, FakeClock())
    got = []
    t = threading.Thread(target=lambda: got.extend(iter(src)))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not got     # nothing before start()
    src.stop()
    t.join(10)
    assert not t.is_alive() and not got


def test_rate_is_the_camera_rate_or_a_number():
    fr = toy_frames(hz=20.0)
    assert frames_mod.rate_of(fr, OPEN) == 20.0
    assert frames_mod.rate_of(fr, dict(OPEN, rate=37.5)) == 37.5
    with pytest.raises(ValueError):
        frames_mod.rate_of(fr, dict(OPEN, rate=0))
    with pytest.raises(ValueError):
        frames_mod.Source(fr, dict(OPEN, loop="bursty"))


class Stepped:
    """A step that takes `cost` seconds of the fake clock, and `stall`
    more on frame `stall_at`, fed inline (no feed thread)."""
    device = torch.device("cpu")
    fields = ("motion_ok",)

    def __init__(self, clock, cost, stall_at=None, stall=0.0):
        self.clock, self.cost = clock, cost
        self.stall_at, self.stall = stall_at, stall

    def feed(self, source):
        return DeviceFeed(source, device="cpu", threaded=False)

    def init_state(self, seed):
        return 0

    def step(self, k, left, right):
        self.clock.t += self.cost + (self.stall if k == self.stall_at
                                     else 0.0)
        return k + 1, SimpleNamespace(pose=torch.eye(4),
                                      motion_ok=torch.tensor(True))

    def frame(self, out):
        return out

    def record(self, out):
        return [out.motion_ok]


def test_open_window_times_frames_from_their_due_time():
    clock = FakeClock()
    prog = Stepped(clock, cost=1 / 64, stall_at=2, stall=0.375)
    fr = toy_frames(hz=8.0)
    w = run.run_window(prog, fr, OPEN, 5, 1.0, clock=clock)
    assert w.attempted == 8 and w.failed == 0     # 8 frames due in 1 s
    assert w.rate == 8.0
    lat = w.latencies
    assert lat[:2] == pytest.approx([1 / 64] * 2)
    # frame 2 ends 0.375 s late; frames 3-5 queue behind it, each
    # timed from its own due time, and frame 6 is on time again
    stall_end = 2 / 8 + 1 / 64 + 0.375
    assert lat[2] == pytest.approx(stall_end - 2 / 8)
    for k in (3, 4, 5):
        assert lat[k] == pytest.approx(stall_end + (k - 2) / 64 - k / 8)
    assert lat[6] == lat[7] == pytest.approx(1 / 64)
    assert w.backlogs[2] == 3 and w.backlogs[0] == w.backlogs[-1] == 0
    assert max(w.backlogs) == 3
    assert w.lags[3] == pytest.approx(stall_end - 3 / 8)
    assert w.lags[6] == 0.0
    notes = run.notes(w, fr, OPEN)
    assert any(n.startswith("open loop at 8 frames/s") and "at most "
               f"{1e3 * max(w.lags):.3f} ms" in n for n in notes), notes
    assert any(n.startswith("backlog") and "at most 3, 0 at the last" in n
               for n in notes), notes


def test_open_window_resumes_after_the_profiled_frames(monkeypatch):
    """Stopping the profiler and putting the wrappers on (2 s here) is
    no frame's wait: the schedule resumes at the next frame."""
    clock = FakeClock()
    monkeypatch.setattr(run, "PROFILE_FRAMES", 3)
    monkeypatch.setattr(trace.Spans, "wrap",
                        lambda self, *a: setattr(clock, "t", clock.t + 2.0))
    reader = SimpleNamespace(WRAP=("m", "f", False))
    prog = Stepped(clock, cost=1 / 64)
    w = run.run_window(prog, toy_frames(hz=8.0), OPEN, 5, 1.0,
                       readers={"r": reader}, clock=clock)
    assert w.attempted == 8 and w.failed == 0
    assert w.latencies == pytest.approx([1 / 64] * 8)
    assert w.lags == [0.0] * 8 and max(w.backlogs) == 0
    assert w.spans["handoff_ms"] == [0.0] * 5


def test_open_window_steps_late_frames_after_its_close():
    clock = FakeClock()
    prog = Stepped(clock, cost=0.25)     # twice the frame interval
    w = run.run_window(prog, toy_frames(hz=8.0), OPEN, 5, 1.0, clock=clock)
    assert w.attempted == len(w.latencies) == 8
    assert w.latencies == pytest.approx([0.25 + k * (0.25 - 1 / 8)
                                         for k in range(8)])
    assert w.backlogs[-1] == 9 and w.failed == 0   # 16 due at 2 s


def test_closed_window_is_timed_from_the_request():
    clock = FakeClock()
    prog = Stepped(clock, cost=0.3)
    w = run.run_window(prog, toy_frames(), dict(OPEN, loop="closed"), 5,
                       1.0, clock=clock)
    assert w.latencies == pytest.approx([0.3] * 3)     # the 4th ends late
    assert w.rate is None and not w.lags and not w.backlogs


@pytest.mark.parametrize("config", ["kitti00-vo-brief",
                                    "euroc-mh01-window-surfext"])
def test_open_cell_reports_no_rate(config, tiny, clock):
    cell = open_cell(config)
    assert cell.traffic["loop"] == "open"
    res = run.run_cell(cell, 4242424242424, 1.0, False, "cpu", clock)
    assert res.correct, res.checks
    assert set(res.metrics) == {"frame_ms_p95", "setup_s"}
    assert any(n.startswith("open loop at") for n in res.notes), res.notes


def test_open_cell_traced_reads_handoff(tiny, clock, monkeypatch):
    monkeypatch.setattr(run, "PROFILE_FRAMES", 1)
    cell = open_cell("kitti00-vo-brief")
    res = run.run_cell(cell, 77, 1.0, True, "cpu", clock)
    assert res.correct, res.checks
    assert set(res.metrics) == {"handoff_ms"}    # no card: no device trace
    assert res.metrics["handoff_ms"]["value"] >= 0.0


def test_handoff_leaves_out_the_source_lag_and_a_busy_loop(monkeypatch):
    """A frame handed over late (a stall) is timed from its hand-off or
    from the loop's request, whichever came later: 0 here, where the
    feed is inline and the fake clock stands still inside it."""
    monkeypatch.setattr(run, "PROFILE_FRAMES", 1)
    clock = FakeClock()
    prog = Stepped(clock, cost=1 / 64, stall_at=2, stall=0.375)
    w = run.run_window(prog, toy_frames(hz=8.0), OPEN, 5, 1.0,
                       readers={}, clock=clock)
    assert w.failed == 0 and max(w.lags) > 0.1
    assert w.spans["handoff_ms"] == [0.0] * 7


def _toy_checkout(tmp_path):
    """A checkout with the benchmark and one more deployment whose entry
    `vo-copy` exists only as two new files."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "vobench", root / "vobench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (root / "vobench/entries/vo-copy.py").write_text(
        (spec.ROOT / "vobench/entries/vo.py").read_text())
    (root / "vobench/reference/entries/vo-copy.py").write_text(
        (spec.ROOT / "vobench/reference/entries/vo.py").read_text())
    b = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cfg = spec.load_json(spec.ROOT / "vobench/configs/kitti00-vo-brief.json")
    cfg.update(name="kitti00-vo-copy", entry="vo-copy")
    (root / "vobench/configs/kitti00-vo-copy.json").write_text(
        json.dumps(cfg))
    b["configs"].append({"name": cfg["name"], "source": "x",
                         "file": "vobench/configs/kitti00-vo-copy.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "kitti00-vo-copy.replay-mem",
                           "config": cfg["name"], "traffic": "replay-mem",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("kitti00-vo-copy.replay-mem")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_a_new_entry_is_two_new_files(tmp_path, clock):
    from conftest import shrink
    root = _toy_checkout(tmp_path)
    cell = shrink(spec.load_cell("kitti00-vo-copy.replay-mem", root=root),
                  pairs=6)
    prog = Program(cell.config, "cpu", root)
    assert prog._mod.__file__ == str(root / "vobench/entries/vo-copy.py")
    res = run.run_cell(cell, 5, 1.0, False, "cpu", clock)
    assert res.correct, res.checks
    assert res.attempted >= 2


def test_a_missing_entry_names_its_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="entries/nope.py"):
        spec.load_entry("nope")
    with pytest.raises(FileNotFoundError,
                       match="reference/entries/nope.py"):
        spec.load_reference_entry("nope")
    (tmp_path / "vobench/entries").mkdir(parents=True)
    (tmp_path / "vobench/entries/half.py").write_text("EXTRA = ()\n")
    with pytest.raises(ValueError, match="an entry needs setup"):
        spec.load_entry("half", tmp_path)

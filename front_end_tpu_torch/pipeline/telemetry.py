"""Per-stage timing telemetry (counterpart of
`front_end_tpu/pipeline/telemetry.py`), the `ProcTime` primitive.

- `FrameClock` times a whole frame step;
- `staged_timings` runs a VO frame's stages one at a time, each waited
  for, to recover the reference's per-stage breakdown (for diagnosis; the
  waits make it slower than the plain step).

On the card a call returns before the device finishes, so both wait for
the device (`torch.cuda.synchronize`) before they read the clock.
Records aggregate into `TelemetryLog` and persist with `save_log` in the
JAX package's `.npz` layout (`stage_*`, `counter_*`, `_meta`), so either
package's `load_log` reads the other's recordings.

Spans and counters inside the program, which never wait for the device:

- `span(name, frame=None)` marks a stage at the place it is called
  (`vo.step`, `vo.extract`, `vo.motion`, `vo.ransac`, `vo.lm`,
  `window.step`, `window.tracker`, `tracker.match`, `window.ba`,
  `feed.wait`, `feed.source`, `feed.put`, `io.decode`); `count(name,
  value)` keeps a value the step already computed (`lm.accepted`,
  `lm.graph`, `ba.accepted`, `ba.landmarks`, `ba.graph`,
  `tracker.tracked`, `tracker.new`, `window.ba_ran`).
- Both are off unless a `recording()` is open: `span` then hands back
  one shared no-op context after one test of a module flag, and `count`
  returns.  Inside `recording()` a span stores its name, frame, parent,
  thread and host times (`time.perf_counter_ns`, not synchronized: the
  host's dispatch) in the `Recording`, and while a `torch.profiler` runs
  it also opens a profiler range of that name, so the stage sits in the
  profiler's trace beside the launches it made.  The range is a host
  operation (`_RecordFunctionFast`), not `record_function`'s user
  annotation, which the profiler mirrors on the device's timeline as an
  event covering the range's kernels.  A count stores a
  reference to the tensor: no kernel, no copy, no wait; the recording
  reduces the values on the host when they are read.
- A span without a frame takes its parent's: the steps pass
  `state.frame_idx`, `DeviceFeed` numbers its items in order.
- `diverted()` hands the counts a thread makes inside it to a list in
  place of any recording: a CUDA graph's capture keeps the tensors it
  counted, whose values exist only at each replay.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


class ProcTime(NamedTuple):
    label: str
    seconds: float


@dataclass
class TelemetryLog:
    frames: list = field(default_factory=list)   # list[list[ProcTime]]
    counters: dict = field(default_factory=dict)  # label -> list[float]

    def add_frame(self, records):
        self.frames.append(list(records))

    def count(self, label, value):
        self.counters.setdefault(label, []).append(float(value))

    def stage_means(self):
        agg = {}
        for fr in self.frames:
            for r in fr:
                agg.setdefault(r.label, []).append(r.seconds)
        return {k: sum(v) / len(v) for k, v in agg.items()}

    def to_dict(self):
        return {"stage_means_s": self.stage_means(),
                "counters": {k: list(v) for k, v in self.counters.items()}}


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_log(path: str, log: TelemetryLog, meta: dict | None = None) -> str:
    """Persist a run's telemetry (.npz): per-frame stage times (NaN where a
    frame lacks a stage) and counter series.  Returns the path written."""
    labels = sorted({r.label for fr in log.frames for r in fr})
    arrs = {}
    for lb in labels:
        series = []
        for fr in log.frames:
            vals = [r.seconds for r in fr if r.label == lb]
            series.append(vals[0] if vals else np.nan)
        arrs[f"stage_{lb}"] = np.asarray(series, np.float64)
    for k, v in log.counters.items():
        arrs[f"counter_{k}"] = np.asarray(v, np.float64)
    arrs["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    path = _npz(path)
    np.savez(path, **arrs)
    return path


def load_log(path: str):
    """-> (stages: {label: (T,) seconds}, counters: {label: (T,)},
    meta: dict)."""
    stages, counters, meta = {}, {}, {}
    with np.load(_npz(path)) as z:
        for k in z.files:
            if k.startswith("stage_"):
                stages[k[len("stage_"):]] = z[k]
            elif k.startswith("counter_"):
                counters[k[len("counter_"):]] = z[k]
            elif k == "_meta":
                meta = json.loads(z[k].tobytes().decode() or "{}")
    return stages, counters, meta


class Span(NamedTuple):
    """One closed span: host times in ns on `time.perf_counter_ns`."""
    name: str
    frame: int | None
    parent: str | None          # the enclosing span on the same thread
    thread: int                 # `threading.get_ident()`
    t0_ns: int
    t1_ns: int


class Recording:
    """Spans and counts of a `recording()`, held in memory and read once
    it has closed.

    `clock_offset_ns` (CLOCK_REALTIME - CLOCK_MONOTONIC when the recording
    opened) moves a span onto `torch.profiler`'s timeline: its events
    carry `start_ns()` on the realtime clock, spans on `perf_counter_ns`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: list = []      # (name, frame, value as given)
        self.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def seconds(self) -> dict:
        """{span name: {frame: host seconds}}, a frame's calls summed."""
        out: dict = {}
        for s in self.spans:
            by = out.setdefault(s.name, {})
            by[s.frame] = by.get(s.frame, 0.0) + (s.t1_ns - s.t0_ns) * 1e-9
        return out

    def counters(self) -> dict:
        """{counter name: [(frame, value)]} in the order counted, each
        value reduced on the host (a mask: its true elements; a scalar:
        itself).  One copy off the device per device and dtype."""
        counts = list(self.counts)
        host = _to_host([torch.as_tensor(v).detach().reshape(-1)
                         for _, _, v in counts])
        out: dict = {}
        for (name, frame, _), h in zip(counts, host):
            out.setdefault(name, []).append((frame, float(h.sum())))
        return out


def _to_host(flat: list) -> list:
    """The tensors on the host, one copy per device and dtype."""
    out = [None] * len(flat)
    groups: dict = {}
    for i, t in enumerate(flat):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        cat = torch.cat([flat[i] for i in idx]).cpu().double().numpy()
        at = 0
        for i in idx:
            n = flat[i].numel()
            out[i] = cat[at:at + n]
            at += n
    return out


class _Open:
    """A span while it is open (recording on)."""
    __slots__ = ("rec", "name", "frame", "parent", "rf", "t0")

    def __init__(self, rec: Recording, name: str, frame):
        self.rec, self.name, self.frame = rec, name, frame

    def __enter__(self):
        st = self.rec._stack()
        up = st[-1] if st else None
        self.parent = up.name if up is not None else None
        if self.frame is None and up is not None:
            self.frame = up.frame
        st.append(self)
        self.rf = None
        if _RANGE is not None and torch.autograd._profiler_enabled():
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.name, self.frame, self.parent,
                                   threading.get_ident(), self.t0, t1))
        return False


# a named host range in the profiler's trace with no device-side twin
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()
_active: Recording | None = None        # the open recording, if any
_sinks: dict = {}       # thread id -> the list its counts go to (diverted)


def span(name: str, frame: int | None = None):
    """A context marking one stage; a no-op unless a recording is open."""
    if _active is None:
        return _OFF
    return _Open(_active, name, frame)


def count(name: str, value) -> None:
    """Keep `value` (a device scalar or mask the caller computed, or a
    number) under `name` for the innermost open span's frame; a no-op
    unless a recording is open, or inside a `torch.func` transform (a
    study's vmapped solve), whose tensors do not outlive it.  Inside
    `diverted()` it goes to that list, recording or not."""
    rec = _active
    if _sinks:
        sink = _sinks.get(threading.get_ident())
        if sink is not None:
            sink.append((name, value))
            return
    if rec is None or (isinstance(value, torch.Tensor) and
                       torch._C._functorch.is_functorch_wrapped_tensor(
                           value)):
        return
    st = rec._stack()
    rec.counts.append((name, st[-1].frame if st else None, value))


def is_recording() -> bool:
    """Whether a `recording()` is open."""
    return _active is not None


@contextlib.contextmanager
def diverted():
    """The counts this thread makes inside the block, as a list of (name,
    value) in the order counted, kept out of any recording."""
    tid = threading.get_ident()
    outer = _sinks.get(tid)
    sink = _sinks[tid] = []
    try:
        yield sink
    finally:
        if outer is None:
            del _sinks[tid]
        else:
            _sinks[tid] = outer


@contextlib.contextmanager
def recording():
    """Spans and counters on inside the block; yields the `Recording`.
    One recording at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a telemetry recording is already open")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None


def add_recording(log: TelemetryLog, rec: Recording, frames) -> None:
    """Append to `log` what `rec` holds of `frames` (the frame ids of
    `log.frames`, in order): each span's host seconds as a stage named
    after it, each counter's per-frame total (0 where a frame has none)."""
    frames = list(frames)
    for name, by in sorted(rec.seconds().items()):
        for records, f in zip(log.frames, frames):
            if f in by:
                records.append(ProcTime(name, by[f]))
    for name, vals in sorted(rec.counters().items()):
        tot: dict = {}
        for f, v in vals:
            tot[f] = tot.get(f, 0.0) + v
        for f in frames:
            log.count(name, tot.get(f, 0.0))


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class FrameClock:
    """Times a frame step into `log`; on a CUDA `device` the clock stops
    only once the device has finished the step's work."""

    def __init__(self, log: TelemetryLog, label: str = "frame",
                 device=None):
        self.log = log
        self.label = label
        self.device = device

    def __enter__(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.log.add_frame([ProcTime(self.label,
                                     time.perf_counter() - self.t0)])
        return False


def timed(label: str, fn, *args, device=None):
    """Run `fn(*args)`, wait for the device, return (result, ProcTime)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, ProcTime(label, time.perf_counter() - t0)


def staged_timings(state, left, right, rig, cfg):
    """Reference-style per-stage breakdown of one VO frame on the state's
    device.  Returns (records, outputs dict); the labels are the JAX
    package's: Detection, Description+Stereo, KNN_Match, MotionExtraction.
    """
    from front_end_tpu_torch.motion.ransac import InverseCdfSampler
    from front_end_tpu_torch.ops import grid as grid_mod
    from front_end_tpu_torch.ops import match as match_mod
    from front_end_tpu_torch.pipeline import vo as vo_mod
    from front_end_tpu_torch.types import Descriptors
    from front_end_tpu_torch.utils.precision import pinned_f32

    dev = state.pose.device
    left = torch.as_tensor(left).to(device=dev, dtype=torch.float32)
    right = torch.as_tensor(right).to(device=dev, dtype=torch.float32)
    tl, tr, prev = state.thresholds_l, state.thresholds_r, state.prev
    norm = cfg.desc_norm
    with pinned_f32():
        _, r0 = timed("Detection", grid_mod.detect_pair, left, right, tl,
                      tr, cfg.grid, device=dev)
        feats, r1 = timed(
            "Description+Stereo",
            lambda: vo_mod._extract_frame(left, right, tl, tr, rig, cfg)[0],
            device=dev)
        tm, r2 = timed(
            "KNN_Match",
            lambda: match_mod.interframe_match(
                feats.kps, Descriptors(feats.bits, feats.packed, norm),
                prev.kps, Descriptors(prev.bits, prev.packed, norm),
                box=cfg.track_box, ratio=cfg.lowe_ratio, norm=norm),
            device=dev)
        sampler = InverseCdfSampler(torch.Generator().manual_seed(0))
        (H, stats), r3 = timed(
            "MotionExtraction",
            lambda: vo_mod._estimate_motion(sampler, feats, prev, rig, cfg),
            device=dev)
    return [r0, r1, r2, r3], {"features": feats, "tracks": tm, "motion": H,
                              "stats": stats}

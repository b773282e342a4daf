"""The benchmark's own instrumentation of a `--trace 1` run: spans from
wrappers around the port's module functions, and one `torch.profiler`
window read into device intervals and host operations.

A wrapper with `sync` synchronizes the card before and after each call,
as `profile_torch_vo.py` does, so each span is the serialized time of
its call and the spans of a frame add up to a frame slower than the
untraced one.  Readers (`vobench/layers/<metric>.py`) turn a `Trace`
into one number each.
"""
from __future__ import annotations

import bisect
import functools
import importlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from vobench import stats

WINDOW_TAG = "vobench.profiled_window"
FRAME_TAG = "vobench.frame"     # an open loop's step, pair in hand -> pose
# profiler bookkeeping that the trace lists among the host's operations
NOT_HOST_WORK = {WINDOW_TAG, FRAME_TAG, "Activity Buffer Request"}
HOST_LOOKBACK = 64      # host operations searched back for a gap's label


class Spans:
    """Durations (s) by span name, and the wrappers that record them."""

    def __init__(self):
        self.times = defaultdict(list)
        self._saved = []

    def add(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def wrap(self, name: str, module: str, fn: str, sync: bool):
        mod = importlib.import_module(module)
        orig = getattr(mod, fn)
        add = self.add

        @functools.wraps(orig)
        def timed(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                add(name, time.perf_counter() - t0)
        setattr(mod, fn, timed)
        self._saved.append((mod, fn, orig))

    def restore(self):
        for mod, fn, orig in reversed(self._saved):
            setattr(mod, fn, orig)
        self._saved.clear()


@dataclass
class Profile:
    """One profiler window: device intervals (name, kind, start, end) in
    seconds, the window itself, the main thread's host operations and,
    in an open loop, the frames' active intervals (`FRAME_TAG`: from the
    pair in the loop's hand to the pose on the host)."""
    device: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    host: list = field(default_factory=list)   # (start, end, name)
    active: list = field(default_factory=list)  # (start, end)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.union_length(((s, e) for _, _, s, e in self.device),
                                  *self.window)

    def idle(self) -> list:
        """The card's idle stretches (start, end): inside the frames'
        active intervals where the profile has them (an open loop, whose
        window is mostly the wait for the next due frame), else over the
        whole window."""
        dev = [(s, e) for _, _, s, e in self.device]
        spans = sorted(self.active) or [self.window]
        return [g for lo, hi in spans for g in stats.gaps(dev, lo, hi)]

    def kernels(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [(s, e) for name, kind, s, e in self.device
                if kind == "kernel" and rx.search(name)]


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _span(e) -> tuple[float, float]:
    s = e.start_ns()
    return s * 1e-9, (s + e.duration_ns()) * 1e-9


def read_profile(prof) -> Profile:
    """The device intervals inside the `WINDOW_TAG` annotation and the
    host operations of the thread that opened it."""
    events = prof.profiler.kineto_results.events()
    out = Profile()
    tag = next(e for e in events if e.name() == WINDOW_TAG)
    lo, hi = _span(tag)
    out.window = (lo, hi)
    tid = tag.start_thread_id()
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        s, en = _span(e)
        if en <= lo or s >= hi:
            continue
        if e.name() == FRAME_TAG:
            if e.device_type() != cuda and e.start_thread_id() == tid:
                out.active.append((s, en))
            continue
        if e.name() in NOT_HOST_WORK:   # on the device too: the annotation
            continue
        if e.device_type() == cuda:
            out.device.append((e.name(), _kind(e.name()), s, en))
        elif e.start_thread_id() == tid:
            out.host.append((s, en, e.name()))
    out.host.sort()
    return out


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time (`Profile.idle`) summed by what the host was doing
    meanwhile: the innermost host operation running at the middle of each
    gap."""
    dev = defaultdict(float)
    for name, _, s, e in p.device:
        dev[_short(name)] += min(e, p.window[1]) - max(s, p.window[0])
    starts = [h[0] for h in p.host]
    idle = defaultdict(float)
    for s, e in p.idle():
        mid = 0.5 * (s + e)
        label = "(python between operations)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - HOST_LOOKBACK), -1):
            if p.host[j][1] >= mid:
                label = _short(p.host[j][2])
                break
        idle[label] += e - s

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(dev), "idle_gaps": ranked(idle)}


@dataclass
class Trace:
    """What the readers read: spans over `frames` frames, timed with the
    wrappers on, and the profiler window over `profiled_frames` frames."""
    spans: dict
    frames: int
    profile: Profile | None
    profiled_frames: int
    config: dict

    def per_frame_ms(self, name: str):
        if name not in self.spans or not self.frames:
            return None
        return 1e3 * sum(self.spans[name]) / self.frames

    def per_call_ms(self, name: str):
        v = self.spans.get(name)
        return 1e3 * sum(v) / len(v) if v else None

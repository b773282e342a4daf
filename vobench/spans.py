"""The port's own spans and counters (`front_end_tpu_torch/pipeline/
telemetry.py`) in one cell, on the card: a probe beside the benchmark,
whose figures are not yet metrics of it.

    python -m vobench.spans --workload <name> --seed <n>

After the cell's set-up and warm-up, as `vobench.run` makes them, it
steps three parts, each a fresh closed loop from frame 0 through the
cell's feed (`run.run_window`):

1. `run.PROFILE_FRAMES` frames under `torch.profiler`, the recording on.
   Each span is then a named host range on the loop's thread.  A kernel
   counts inside every span around its launch call (the call found by
   the kernel's correlation id); each idle stretch of the card goes to
   the innermost span around its middle.
2. `PHASES` of `SPAN_FRAMES` frames, recording off and on in turn, with
   neither profiler nor wrapper: each span's host ms a frame (on), the
   counters (on, frame 0 left out: it has no previous frame), and the
   loop's median frame either way, for the recording's cost.
3. The per-call cost of `span()` and `count()`, off and on.

Prints one JSON line; a table of it goes to standard error.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time

import torch

from vobench import frames as frames_mod, program as program_mod, run, \
    spec, stats, trace

SPAN_FRAMES = 60                        # frames of one phase
PHASES = ("off", "on", "on", "off")     # the recording in each phase
MICRO_CALLS = 100_000                   # calls timed per figure
OUTSIDE = "(outside any span)"
OTHER_THREAD = "(launched on another thread)"


def read_events(prof):
    """The profiled window of a stopped profiler as plain tuples: the
    window (s), the loop's thread, host events (start, end, name,
    correlation id, thread) and device events (start, end, name,
    correlation id), in seconds on the profiler's clock."""
    events = prof.profiler.kineto_results.events()
    tag = next(e for e in events if e.name() == trace.WINDOW_TAG)
    lo, hi = trace._span(tag)
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in events:
        s, en = trace._span(e)
        if en <= lo or s >= hi or e.name() in trace.NOT_HOST_WORK:
            continue
        if e.device_type() == cuda:
            device.append((s, en, e.name(), e.correlation_id()))
        else:
            host.append((s, en, e.name(), e.correlation_id(),
                         e.start_thread_id()))
    return (lo, hi), tag.start_thread_id(), host, device


def attribute(window, tid, host, device, names, frames: int) -> dict:
    """Per frame: the kernels launched inside each span (a kernel counts
    in its span and in every span around it), and the card's idle ms by
    the innermost span around each idle stretch's middle.  Spans are the
    host ranges named in `names` on thread `tid`; a kernel whose launch
    call (the host event of the same correlation id) ran on another
    thread, or is not in the window, counts apart."""
    ranges = sorted((s, e, n) for s, e, n, _, t in host
                    if t == tid and n in names)
    starts = [r[0] for r in ranges]
    launch = {c: (s, t) for s, _, n, c, t in host
              if n.startswith("cu") and c}
    kernels = [d for d in device if trace._kind(d[2]) == "kernel"]
    found = [launch.get(c, (None, None)) for _, _, _, c in kernels]
    at = sorted(s for s, t in found if t == tid)
    other = len(kernels) - len(at)
    inside: dict = {}
    for s, e, n in ranges:
        inside[n] = inside.get(n, 0) + (bisect.bisect_right(at, e)
                                        - bisect.bisect_left(at, s))
    outside = sum(innermost(ranges, starts, t) == OUTSIDE for t in at)
    idle: dict = {}
    for s, e in stats.gaps([(a, b) for a, b, _, _ in device], *window):
        label = innermost(ranges, starts, 0.5 * (s + e))
        idle[label] = idle.get(label, 0.0) + (e - s)
    return {
        "kernels": len(kernels) / frames,
        "launches_inside": {n: v / frames for n, v in sorted(inside.items())},
        "launches_elsewhere": {OUTSIDE: outside / frames,
                               OTHER_THREAD: other / frames},
        "idle_ms": {n: 1e3 * v / frames for n, v in
                    sorted(idle.items(), key=lambda kv: -kv[1])},
        "window_ms": 1e3 * (window[1] - window[0]) / frames,
    }


def innermost(ranges, starts, t) -> str:
    """The name of the innermost of the nested `ranges` (sorted by start,
    `starts` their starts) that holds time t."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    return OUTSIDE


def phase_figures(rec, frames: int) -> dict:
    """What an `on` phase's recording holds of its first `frames` frames:
    each span's host ms a frame (the feed's too: its items are numbered
    as the frames), each 0/1 counter's share of ones, and the mean of the
    other counters a call.  Counters leave frame 0 out."""
    secs = rec.seconds()
    host_ms = {n: 1e3 * sum(v for f, v in by.items()
                            if f is not None and 0 <= f < frames) / frames
               for n, by in sorted(secs.items())}
    counters = {}
    for n, vals in sorted(rec.counters().items()):
        v = [x for f, x in vals if f is not None and 1 <= f < frames]
        if not v:
            continue
        if set(v) <= {0.0, 1.0}:
            counters[n + "_pct"] = 100.0 * sum(v) / len(v)
        else:
            counters[n + "_mean"] = sum(v) / len(v)
        counters[n + "_n"] = len(v)
    return {"host_ms": host_ms, "counters": counters}


def per_call_us(telemetry, calls: int = MICRO_CALLS) -> dict:
    """µs a call of `span()` (entered and left) and `count()`, off and
    on, and of an empty function for the loop's own cost."""
    flag = torch.tensor(True)

    def nothing():
        pass

    def one_span():
        with telemetry.span("probe", 0):
            pass

    def one_count():
        telemetry.count("probe", flag)

    def timed(fn):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        return (time.perf_counter_ns() - t0) / calls / 1e3
    out = {"empty_call": timed(nothing), "span_off": timed(one_span),
           "count_off": timed(one_count)}
    with telemetry.recording():
        out["span_on"] = timed(one_span)
        out["count_on"] = timed(one_count)
    return out


def probe(cell: spec.Cell, seed: int, device) -> dict:
    from front_end_tpu_torch.pipeline import telemetry
    frames = frames_mod.render(cell.config, cell.traffic["unique_pairs"],
                               seed, device)
    frames_mod.attach_source(frames, cell.config, cell.traffic, seed)
    prog = program_mod.Program(cell.config, device)
    run.warm_up(prog, frames, cell.traffic, seed)
    out = {"cell": cell.name, "seed": seed}
    failed = 0

    with telemetry.recording() as rec:
        w = run.run_window(prog, frames, cell.traffic, seed, 1e9,
                           readers={}, max_frames=run.PROFILE_FRAMES)
    failed += w.failed
    prof, n = w.profiler
    if prog.device.type == "cuda" and n:
        out["profiled"] = attribute(*read_events(prof),
                                    {s.name for s in rec.spans}, n)
        out["profiled"]["frames"] = n

    phases = []
    for mode in PHASES:
        if mode == "on":
            with telemetry.recording() as rec:
                w = run.run_window(prog, frames, cell.traffic, seed, 1e9,
                                   max_frames=SPAN_FRAMES)
            fig = phase_figures(rec, w.attempted)
        else:
            w = run.run_window(prog, frames, cell.traffic, seed, 1e9,
                               max_frames=SPAN_FRAMES)
            fig = {}
        failed += w.failed
        phases.append({"recording": mode, "frames": w.attempted,
                       "failed": w.failed,
                       "frame_ms_median": 1e3 * statistics.median(
                           w.latencies) if w.latencies else None, **fig})
    out["phases"] = phases
    for mode in ("off", "on"):
        vals = [p["frame_ms_median"] for p in phases
                if p["recording"] == mode and p["frame_ms_median"]]
        out[f"frame_ms_{mode}"] = statistics.median(vals) if vals else None
    out["per_call_us"] = per_call_us(telemetry)
    out["failed"] = failed
    return out


def table(res: dict) -> str:
    """The JSON line's figures as lines of text."""
    lines = [f"{res['cell']} seed {res['seed']}: median frame ms, "
             f"recording off {res['frame_ms_off']}, on {res['frame_ms_on']}"
             f"; failed {res['failed']}"]
    for p in res["phases"]:
        if p["recording"] == "on":
            lines.append("  host ms a frame: " + ", ".join(
                f"{n} {v:.3f}" for n, v in p["host_ms"].items()))
            lines.append("  counters: " + ", ".join(
                f"{n} {v:.3f}" for n, v in p["counters"].items()))
    pr = res.get("profiled")
    if pr:
        lines.append(f"  profiled: {pr['kernels']:.1f} kernels a frame; "
                     "inside: " + ", ".join(
                         f"{n} {v:.1f}"
                         for n, v in pr["launches_inside"].items()))
        lines.append("  idle ms a frame by span: " + ", ".join(
            f"{n} {v:.3f}" for n, v in pr["idle_ms"].items()))
    lines.append("  µs a call: " + ", ".join(
        f"{n} {v:.3f}" for n, v in res["per_call_us"].items()))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vobench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    res = probe(spec.load_cell(args.workload), args.seed, "cuda:0")
    print(table(res), file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())

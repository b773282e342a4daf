"""The harness: one cell, one run, one JSON line.

    python -m vobench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's frames on the card from the seed, writes the
png cell's files once, builds the port's step and warms up the shapes
the cell uses (unpaced, in either loop).  In a closed loop the next
frame is requested from the source (through the port's `DeviceFeed`)
once the previous frame's pose has reached the host, and a frame's time
runs from that request.  In an open loop the source hands frame k to the
feed at its due time, `rate` frames a second from the window's start;
every frame due inside the window is stepped, late ones too, and a
frame's time runs from its due time, so a stall delays the frames behind
it.  A frame fails if its step raises,
its pose is not finite, or (after the first frame) `motion_ok` is
false.  Once the window has closed the peak memory is read, the
program's state is freed and the plain reference steps over the window's
first frames; `correct` holds if every number compared is within its
limit.  With `--trace 1` the first `PROFILE_FRAMES` frames of the window
run under `torch.profiler` (in an open loop each step marked, so that
the card's idle time is read inside the frames and not in the wait for
the next due one) and the rest with the per-layer readers' wrappers; the
line then carries the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from vobench import check, frames as frames_mod, spec, stats, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "front_end_tpu")
DRAIN_LIMIT = 64        # frames read off the feed after the window closes
WARMUP_FRAMES = 8       # frames stepped at set-up, through the cell's feed
PROFILE_FRAMES = 20     # frames of a traced window under torch.profiler
GRACE_S = 60.0          # an open window's wait for its late frames
CHECK_FRAMES = 160      # frames of the window compared with the reference;
                        # the configurations' limits were read at this count


@dataclass
class Window:
    """What the timed loop recorded."""
    seconds: float
    setup_s: float = 0.0
    latencies: list = field(default_factory=list)   # s, request (open
                                                    # loop: due) -> pose
    poses: list = field(default_factory=list)       # host (4, 4) float32
    pixels: list = field(default_factory=list)      # fed pairs' checksums
    scalars: list = field(default_factory=list)     # per checked frame
    oks: list = field(default_factory=list)         # motion_ok, device
    attempted: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)       # traced: s per call
    span_frames: int = 0        # frames timed with the wrappers on
    profiler: tuple | None = None   # traced: (stopped profiler, frames)
    rate: float | None = None   # an open loop's frames a second
    lags: list = field(default_factory=list)        # s, hand-off - due
    backlogs: list = field(default_factory=list)    # frames due, not done

    @property
    def completed(self) -> int:
        return len(self.latencies)


@dataclass
class Result:
    """One run: what the result line says, and the notes beside it."""
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    checks: dict
    notes: list
    memory_peak_bytes: int = 0
    build_s: float = 0.0            # nvcc at first use, inside setup_s
    breakdown: dict | None = None
    busy: tuple | None = None       # (busy_s, window_s) of the profile


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _drain(feed, source):
    source.stop()
    for _ in range(DRAIN_LIMIT):
        try:
            next(feed)
        except StopIteration:
            return


def warm_up(prog, frames, traffic, seed):
    """The cell's own shapes, through the cell's own source and feed,
    unpaced: an open loop's warm-up takes its frames as a closed one."""
    source = frames_mod.Source(frames, dict(traffic, loop="closed"))
    feed = prog.feed(source)
    state = prog.init_state(frames_mod.seed_of(seed))
    for _ in range(WARMUP_FRAMES):
        left, right = next(feed)
        state, out = prog.step(state, left, right)
        prog.frame(out).pose.cpu()
    _drain(feed, source)
    if prog.device.type == "cuda":
        torch.cuda.synchronize(prog.device)


def run_window(prog, frames, traffic, seed, seconds, readers=None,
               max_frames=None, check_frames=None, clock=None) -> Window:
    """The timed loop, closed or open as the traffic says.  `readers`:
    the per-layer readers of a traced run, whose wrappers go on after the
    profiled frames (the stopped profiler is read once the window has
    closed).  `max_frames` ends the loop after that many frames (the
    calibration's untimed runs).  The first `check_frames` frames
    (default `CHECK_FRAMES`) keep their pose, their scalars and a
    checksum of the pair fed to the step, for the comparison after the
    window.  `clock`: the host's clock (`frames.Clock`), or a test's."""
    w = Window(seconds=seconds)
    clock = clock or frames_mod.Clock()
    check_frames = CHECK_FRAMES if check_frames is None else check_frames
    weights = check.pixel_weights(frames.lefts.shape[1:], seed, prog.device)
    source = frames_mod.Source(frames, traffic, clock)
    w.rate = source.rate
    feed = prog.feed(source)
    state = prog.init_state(frames_mod.seed_of(seed))
    traced = readers is not None
    spans = trace.Spans()
    prof = tag = None
    n_prof = PROFILE_FRAMES if traced else 0
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if prog.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tag = torch.autograd.profiler.record_function(trace.WINDOW_TAG)
        tag.__enter__()
    t0 = clock.now()
    t_end = t0 + seconds
    source.start(t0)
    # an open window steps every frame due inside it, however late
    n_due = math.ceil(seconds * w.rate) if w.rate else None
    k = 0
    while True:
        t_req = clock.now()
        if k == max_frames or (t_req >= t_end if n_due is None
                               else k == n_due):
            break
        if n_due is not None and t_req > t_end + GRACE_S:
            w.attempted += n_due - k        # due, and never stepped
            w.failed += n_due - k
            w.errors.append(f"frames {k}-{n_due - 1} not stepped "
                            f"{GRACE_S:.0f} s past the window's close")
            break
        if traced and k == n_prof:
            tag.__exit__(None, None, None)
            prof.stop()
            w.profiler, prof = (prof, k), None
            for name, mod in readers.items():
                if mod.WRAP is not None:
                    module, fn, sync = mod.WRAP
                    spans.wrap(name, module, fn,
                               sync and prog.device.type == "cuda")
            if n_due is not None:   # stopping the profiler delays no frame:
                due = source.due(k)     # the schedule resumes at frame k
                _drain(feed, source)
                w.lags = source.lags[:k]
                source = frames_mod.Source(frames, traffic, clock, first=k)
                feed = prog.feed(source)
                source.start(max(clock.now(), due))
                t_end += source.due(k) - due
            t_req = clock.now()
        left, right = next(feed)
        t_got = clock.now()
        if len(w.pixels) < check_frames:
            w.pixels.append(check.pixel_sums(weights, left, right))
        # an open loop's profiled frames mark their steps, the stretches in
        # which the card's idle time is a frame's (`trace.Profile.idle`)
        active = (torch.autograd.profiler.record_function(trace.FRAME_TAG)
                  if prof is not None and n_due is not None
                  else contextlib.nullcontext())
        try:
            with active:
                new_state, out = prog.step(state, left, right)
                pose = prog.frame(out).pose.cpu()
        except Exception:       # a frame that raises fails; the loop goes on
            t_done = clock.now()
            if t_done > t_end and n_due is None:
                break
            w.attempted += 1
            w.failed += 1
            w.errors.append(traceback.format_exc(limit=3))
            if len(w.poses) < check_frames:     # compared as not finite
                nan = torch.tensor(math.nan)
                w.poses.append(torch.full((4, 4), math.nan))
                w.scalars.append([nan] * len(prog.fields))
            k += 1
            continue
        t_done = clock.now()
        if t_done > t_end and n_due is None:
            break
        state = new_state
        w.attempted += 1
        if n_due is None:
            w.latencies.append(t_done - t_req)
        else:
            w.latencies.append(t_done - source.due(k))
            w.backlogs.append(max(0, source.due_by(t_done) - (k + 1)))
        w.oks.append(prog.frame(out).motion_ok)
        if not bool(torch.isfinite(pose).all()):
            w.failed += 1
            w.errors.append(f"frame {k}: pose not finite")
        if len(w.poses) < check_frames:
            w.poses.append(pose)
            w.scalars.append(prog.record(out))
        if traced and k >= n_prof:
            spans.add("feed_wait_ms", t_got - t_req)
            spans.add("frame_s", w.latencies[-1])
            if n_due is not None:   # from the hand-off, or a later request
                handed = source.due(k) + source.lags[k - source.first]
                spans.add("handoff_ms", t_got - max(handed, t_req))
        k += 1
    if prof is not None:        # the window closed inside the profiled part
        tag.__exit__(None, None, None)
        prof.stop()
        w.profiler = (prof, k)
    spans.restore()
    _drain(feed, source)
    w.lags += source.lags[:w.attempted - len(w.lags)]
    w.spans = dict(spans.times)
    w.span_frames = max(0, k - n_prof)
    # motion_ok false after the first frame fails the frame
    oks = (torch.stack(w.oks).cpu().numpy() if w.oks
           else np.zeros(0, bool))
    bad = [j for j in range(1, len(oks)) if not oks[j]]
    w.failed += len(bad)
    if bad:
        w.errors.append(f"motion_ok false at frames {bad[:20]}")
    w.oks = oks
    w.scalars = (torch.stack([torch.stack([v.to(torch.float64) for v in r])
                              for r in w.scalars]).cpu().numpy()
                 if w.scalars else np.zeros((0, len(prog.fields))))
    w.poses = (torch.stack(w.poses).numpy().astype(np.float64) if w.poses
               else np.zeros((0, 4, 4)))
    w.pixels = (torch.stack(w.pixels[:len(w.poses)]).cpu().numpy()
                if w.poses.shape[0] else np.zeros((0, 2), np.int64))
    return w


def reference_run(frames, traffic, seed, config, device, m: int,
                  root=spec.ROOT):
    """The plain reference over the first m frames of the replay."""
    order = frames_mod.order(len(frames.lefts), traffic["replay"], m)
    return check.Reference(config, device, root).run(
        frames.lefts, frames.rights, order, frames_mod.seed_of(seed))


def compare(prog, window: Window, frames, traffic, seed, config,
            device, root=spec.ROOT) -> dict:
    """The numbers compared: the window's first frames against the
    reference over the same frames."""
    m = len(window.poses)
    if m == 0:
        return {k: math.inf for k in config["check"]}
    fields = {k: window.scalars[:, j] for j, k in enumerate(prog.fields)}
    ref_poses, ref_vals = reference_run(frames, traffic, seed, config,
                                        device, m, root)
    numbers = check.gaps(window.poses, fields, ref_poses, ref_vals)
    numbers["pixels_mismatch"] = check.pixels_mismatch(
        window.pixels, frames.lefts, frames.rights,
        frames_mod.order(len(frames.lefts), traffic["replay"], m),
        check.pixel_weights(frames.lefts.shape[1:], seed, device))
    return numbers


def notes(window: Window, frames, traffic) -> list[str]:
    """Lines for standard error: tracking, drift against the rendered
    ground truth, and the png cell's decoder."""
    out = []
    if window.latencies:
        q1, med, q3 = stats.percentile(window.latencies, 25), \
            stats.percentile(window.latencies, 50), \
            stats.percentile(window.latencies, 75)
        out.append(f"frame ms: quartiles {1e3 * q1:.3f} / {1e3 * med:.3f} "
                   f"/ {1e3 * q3:.3f}, max "
                   f"{1e3 * max(window.latencies):.3f}, "
                   f"{window.completed} frames")
    if window.rate and window.lags:
        out.append(f"open loop at {window.rate:g} frames/s: the source "
                   f"handed {len(window.lags)} frames to the feed a median "
                   f"{1e3 * stats.percentile(window.lags, 50):.3f} ms and at "
                   f"most {1e3 * max(window.lags):.3f} ms after their due "
                   f"time")
    if window.backlogs:
        out.append(f"backlog (frames due and not yet done as a pose "
                   f"landed): at most {max(window.backlogs)}, "
                   f"{window.backlogs[-1]} at the last frame")
    if len(window.oks):
        out.append(f"tracking held (motion_ok) on {window.oks.mean():.2%} "
                   f"of {len(window.oks)} frames")
    m = len(window.poses)
    if m > 1:
        gt = frames.gt[frames_mod.order(len(frames.gt), traffic["replay"],
                                        m)]
        rel_gt = np.linalg.inv(gt[0]) @ gt
        rel = np.linalg.inv(window.poses[0]) @ window.poses
        err = np.linalg.norm(rel[-1, :3, 3] - rel_gt[-1, :3, 3])
        path = np.linalg.norm(np.diff(rel_gt[:, :3, 3], axis=0),
                              axis=1).sum()
        out.append(f"drift over the {m} checked frames: {err:.4f} m on a "
                   f"{path:.3f} m path ({100 * err / max(path, 1e-9):.3f} %)")
    if frames.png_root is not None:
        try:
            import PIL  # noqa: F401
            reader = "PIL"
        except ImportError:
            reader = "the port's utils/png.py"
        out.append(f"io/kitti.py::_read_image decodes with {reader}")
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, program_cls=None,
             marks=()) -> Result:
    """One run of a cell on `device`.  `marks`: (what, when) of the
    set-up before the call, for the note that splits `setup_s`."""
    from vobench import program as program_mod
    program_cls = program_cls or program_mod.Program
    cuda = torch.device(device).type == "cuda"
    marks = [*marks, ("port import", time.perf_counter())]
    frames = frames_mod.render(cell.config, cell.traffic["unique_pairs"],
                               seed, device)
    marks.append(("render (CUDA context included)", time.perf_counter()))
    frames_mod.attach_source(frames, cell.config, cell.traffic, seed)
    marks.append(("png files", time.perf_counter()))
    readers = ({m["name"]: spec.load_layer(m["name"], cell.root)
                for m in cell.per_layer} if traced else None)
    with program_mod.BuildClock() as builds:
        prog = program_cls(cell.config, device, root=cell.root)
        warm_up(prog, frames, cell.traffic, seed)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("build and warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    t, parts = t_start, []
    for what, at in marks:
        parts.append(f"{what} {at - t:.2f}")
        t = at
    setup_note = (f"set-up s: {', '.join(parts)}; of it nvcc "
                  f"{builds.seconds:.2f} s for {builds.built} kernel "
                  f"libraries (0 once this checkout has them)")

    window = run_window(prog, frames, cell.traffic, seed, seconds, readers)
    window.setup_s = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare(prog, window, frames, cell.traffic, seed, cell.config,
                      device, cell.root)
    correct, table = check.judge(numbers, cell.config["check"])
    lines = [setup_note] + notes(window, frames, cell.traffic)
    lines.append(f"reference over {len(window.poses)} frames: "
                 f"{time.perf_counter() - t_ref:.1f} s")
    res = Result(correct=correct, attempted=window.attempted,
                 failed=window.failed, metrics={}, checks=table,
                 notes=lines + window.errors[:5], memory_peak_bytes=peak,
                 build_s=builds.seconds)
    if traced:
        prof, n_prof = window.profiler or (None, 0)
        profile = (trace.read_profile(prof) if prof is not None and cuda
                   else None)
        tr = trace.Trace(spans=window.spans, frames=window.span_frames,
                         profile=profile, profiled_frames=n_prof,
                         config=cell.config)
        for name, mod in readers.items():
            v = mod.read(tr)
            if v is not None and math.isfinite(v):
                res.metrics[name] = {"value": v, "unit": mod.UNIT}
        if profile is not None and profile.device:
            res.breakdown = trace.breakdown(profile)
            res.busy = (profile.busy_s(), profile.window_s)
    else:
        for m in cell.end_to_end:
            value = spec.load_end_to_end(m["name"], cell.root).read(window)
            res.metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    return res


def main(t_start: float, argv=None) -> int:
    marks = [("interpreter, harness and torch imports", time.perf_counter())]
    ap = argparse.ArgumentParser(prog="python -m vobench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"vobench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"vobench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", t_start, marks=marks)
    except ImportError as e:
        print(f"vobench: the port cannot be imported here: {e}",
              file=sys.stderr)
        return 4
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"vobench: the run loaded {loaded}", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(res.memory_peak_bytes),
              "power_limit": power_limit()}
    if args.trace:
        device["busy_s"], device["window_s"] = res.busy or (0.0, 0.0)
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": res.metrics, "device": device}
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["build_s"] = res.build_s       # the first run in a checkout's nvcc
    line["checks"] = res.checks
    for note in res.notes:
        print(f"vobench: {note}", file=sys.stderr)
    for k, v in res.checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

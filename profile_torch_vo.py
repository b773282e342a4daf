#!/usr/bin/env python3
"""Where the time of the PyTorch port's `vo_step`, or of its
`window_vo_step`, goes, on one CUDA card.

    python3 profile_torch_vo.py [--frames 20] [--path vo|window|sweep]

`--path window` drives `window_vo.run_sequence` with
`WindowVOConfig.create` defaults and adds `tracker.update` and
`tracker.run_window_ba` to the stages (a stage called inside another
stage, as the tracker's association is, counts once, with the outer one).
On the benchmark configuration at KITTI 376×1241 (the one `chip_smoke.py`
drives) it prints:
  1. the card's name and power limit;
  2. ms/frame of `run_sequence`, host clock, after warm-up;
  3. a per-stage breakdown: each stage function of `pipeline/vo.py` is
     wrapped to synchronize before and after it, so the stages' times add
     up to a (slower) serialized frame;
  4. a `torch.profiler` window over 5 frames: kernel launches per frame,
     summed device kernel time per frame, the device's busy share of the
     wall time, and the top operators by host and by device time.
`--path sweep` prints only the seconds of the 712-ID FAST/ORB/BRISK
`services.single_image_detection` sweep on frame 0's pair, three runs
after a warm-up on every 40th ID.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from front_end_tpu_torch import features, services  # noqa: E402
from front_end_tpu_torch.geometry.camera import kitti_rig  # noqa: E402
from front_end_tpu_torch.motion import lm, ransac  # noqa: E402
from front_end_tpu_torch.ops import brief, grid, match  # noqa: E402
from front_end_tpu_torch.pipeline import vo, window_vo  # noqa: E402
from front_end_tpu_torch.sim.sequence import make_sequence  # noqa: E402
from front_end_tpu_torch.window import tracker  # noqa: E402

STAGES = [(grid, "detect_pair"), (brief, "smooth"), (brief, "describe_pair"),
          (match, "stereo_match_live"), (match, "interframe_match"),
          (ransac, "rigid_ransac"), (lm, "refine_motion")]
WINDOW_STAGES = [(tracker, "update"), (tracker, "run_window_ba")]


def bench_cfg():
    return vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=384,
                             set_point=2000, init_threshold=15.0),
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0, min_track_inliers=12)


def path_module(cfg):
    return window_vo if isinstance(cfg, window_vo.WindowVOConfig) else vo


def run(L, R, rig, cfg):
    mod = path_module(cfg)
    s = mod.init_state(rig, cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.run_sequence(s, L, R, rig, cfg)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(L)


def sweep(rig) -> None:
    lefts, rights = make_sequence(1, rig.height, rig.width)
    table = features.detector_table()
    ids = sum((features.ids_for(f, table) for f in ("FAST", "ORB", "BRISK")),
              [])
    services.single_image_detection(ids[::40], lefts[0], rights[0],
                                    device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        services.single_image_detection(ids, lefts[0], rights[0],
                                        device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"sweep: {len(ids)} IDs, {min(times):.3f} s (runs "
          f"{[round(t, 3) for t in times]})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--path", choices=("vo", "window", "sweep"),
                    default="vo")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_vo: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    rig, cfg = kitti_rig(), bench_cfg()
    if args.path == "sweep":
        sweep(rig)
        return 0
    stages = list(STAGES)
    if args.path == "window":
        cfg = window_vo.WindowVOConfig.create(cfg)
        stages += WINDOW_STAGES
    mod = path_module(cfg)
    print(f"path: {args.path} ({mod.__name__}.run_sequence)")
    lefts, rights = make_sequence(args.frames, rig.height, rig.width)
    L = torch.as_tensor(lefts).cuda()
    R = torch.as_tensor(rights).cuda()

    run(L[:3], R[:3], rig, cfg)                       # build + warm-up
    times = [run(L, R, rig, cfg) for _ in range(3)]
    print(f"run_sequence: {min(times):.3f} ms/frame (runs "
          f"{[round(t, 3) for t in times]})")

    # ---- serialized per-stage breakdown ------------------------------
    spent = defaultdict(float)
    saved = []
    depth = [0]
    for smod, name in stages:
        fn = getattr(smod, name)
        saved.append((smod, name, fn))

        def timed(*a, _fn=fn, _name=name, **k):
            if depth[0]:                 # inside another stage: its time
                return _fn(*a, **k)
            depth[0] += 1
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                spent[_name] += time.perf_counter() - t0
            finally:
                depth[0] -= 1
            return out
        setattr(smod, name, functools.wraps(fn)(timed))
    try:
        run(L[:2], R[:2], rig, cfg)
        spent.clear()
        total = run(L, R, rig, cfg)
    finally:
        for smod, name, fn in saved:
            setattr(smod, name, fn)
    n = len(L)
    staged = 0.0
    print(f"serialized frame: {total:.3f} ms/frame")
    for _, name in stages:
        ms = spent[name] * 1e3 / n
        staged += ms
        print(f"  {name:<20s} {ms:8.3f} ms/frame")
    print(f"  {'(rest)':<20s} {total - staged:8.3f} ms/frame")

    # ---- profiler window ----------------------------------------------
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    k = 5
    s = mod.init_state(rig, cfg, seed=0, device="cuda")
    s, _ = mod.run_sequence(s, L[:3], R[:3], rig, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        mod.run_sequence(s, L[3:3 + k], R[3:3 + k], rig, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events if "Synchronize" in e.key
                or e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize"))
    print(f"profiler window: {k} frames, wall {wall / k:.3f} ms/frame "
          f"(profiled), device kernel time {dev_us / 1e3 / k:.3f} ms/frame, "
          f"device busy {dev_us / 1e3 / wall:.1%}, kernel launches "
          f"{launches / k:.0f}/frame, memcpy+sync calls {syncs / k:.0f}/frame")
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=48))
    print(events.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=48))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the PyTorch port's `vo_step`, or of its
`window_vo_step`, goes, on one CUDA card.

    python3 profile_torch_vo.py [--frames 20] [--path vo|window|sweep]
                                [--descriptor NAME] [--subpix]
                                [--motion rigid|essential]

`--descriptor` picks the VO descriptor (brief, orb, brisk, freak, surf,
surf_ext; default brief) and `--subpix` turns on the sub-pixel refinement;
the stages follow: `subpix.corner_subpix`, each descriptor's orientation
and description functions, and the two matches, which run on the L2
distance matrix for SURF (marked [l2]) and on the match kernel otherwise.
`--motion essential` drives the essential-matrix egomotion: its stages
are the 8-point RANSAC (`ransac.ransac`), the cheirality vote with its
SVDs (`essential.select_cheirality`) and the stereo scale
(`essential.estimate_scale`) beside the LM polish.
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
`--path sweep` prints only the seconds of the 1208-ID FAST/ORB/BRISK/
SURF/AKAZE `services.single_image_detection` sweep on frame 0's pair,
three runs after a warm-up on every 40th ID, and ms per swept ID per
family.
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
from front_end_tpu_torch.motion import essential, lm, ransac  # noqa: E402
from front_end_tpu_torch.ops import (brief, brisk, freak, grid,  # noqa
                                     match, orb, subpix, surf)
from front_end_tpu_torch.pipeline import vo, window_vo  # noqa: E402
from front_end_tpu_torch.sim.sequence import make_sequence  # noqa: E402
from front_end_tpu_torch.window import tracker  # noqa: E402

DESCRIBE_STAGES = {
    "brief": [(brief, "smooth"), (brief, "describe_pair")],
    "orb": [(brief, "smooth"), (orb, "intensity_centroid_angle"),
            (orb, "describe")],
    "brisk": [(brisk, "orientations"), (brisk, "describe")],
    "freak": [(freak, "orientations"), (freak, "describe")],
    "surf": [(surf, "describe")],
    "surf_ext": [(surf, "describe")],
}
MATCH_STAGES = [(match, "stereo_match_live"), (match, "interframe_match")]
MOTION_STAGES = {
    "rigid": [(ransac, "rigid_ransac"), (lm, "refine_motion")],
    "essential": [(ransac, "ransac"), (essential, "select_cheirality"),
                  (essential, "estimate_scale"), (lm, "refine_motion")],
}
WINDOW_STAGES = [(tracker, "update"), (tracker, "run_window_ba")]


def bench_cfg(descriptor: str = "brief", use_subpix: bool = False,
              motion: str = "rigid"):
    return vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=384,
                             set_point=2000, init_threshold=15.0),
        descriptor=descriptor, desc_bytes=32, subpix=use_subpix,
        ransac_hyps=256, ransac_threshold=0.5, max_disparity=192.0,
        min_track_inliers=12, motion=motion)


def stage_list(cfg):
    """(module, function) pairs of the frame step with this descriptor."""
    out = [(grid, "detect_pair")]
    if cfg.subpix:
        out.append((subpix, "corner_subpix"))
    return (out + DESCRIBE_STAGES[cfg.descriptor] + MATCH_STAGES
            + MOTION_STAGES[cfg.motion])


def stage_label(smod, name, cfg):
    label = f"{smod.__name__.rsplit('.', 1)[-1]}.{name}"
    if (smod, name) in MATCH_STAGES and cfg.desc_norm == "l2":
        label += " [l2]"
    return label


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
    fams = ("FAST", "ORB", "BRISK", "SURF", "AKAZE")
    ids = sum((features.ids_for(f, table) for f in fams), [])
    services.single_image_detection(ids[::40], lefts[0], rights[0],
                                    device="cuda")
    torch.cuda.synchronize()
    times, recs = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        recs = services.single_image_detection(ids, lefts[0], rights[0],
                                               device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"sweep: {len(ids)} IDs, {min(times):.3f} s (runs "
          f"{[round(t, 3) for t in times]})")
    per = defaultdict(list)
    for r in recs:
        per[table[r["detID"]]["Name"]].append(
            r["processingTime"][0]["seconds"])
    print("sweep, last run: ms per swept ID "
          + ", ".join(f"{f} {1e3 * sum(per[f]) / len(per[f]):.3f}"
                      for f in fams))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--path", choices=("vo", "window", "sweep"),
                    default="vo")
    ap.add_argument("--descriptor", choices=tuple(DESCRIBE_STAGES),
                    default="brief")
    ap.add_argument("--subpix", action="store_true")
    ap.add_argument("--motion", choices=tuple(MOTION_STAGES),
                    default="rigid")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_vo: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    rig, cfg = kitti_rig(), bench_cfg(args.descriptor, args.subpix,
                                      args.motion)
    if args.path == "sweep":
        sweep(rig)
        return 0
    stages = stage_list(cfg)
    labels = [stage_label(m, f, cfg) for m, f in stages]
    vo_cfg = cfg
    if args.path == "window":
        cfg = window_vo.WindowVOConfig.create(cfg)
        stages += WINDOW_STAGES
        labels += [stage_label(m, f, vo_cfg) for m, f in WINDOW_STAGES]
    mod = path_module(cfg)
    print(f"path: {args.path} ({mod.__name__}.run_sequence), descriptor "
          f"{vo_cfg.descriptor}, subpix {vo_cfg.subpix}, motion "
          f"{vo_cfg.motion}")
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
    for (smod, name), label in zip(stages, labels):
        fn = getattr(smod, name)
        saved.append((smod, name, fn))

        def timed(*a, _fn=fn, _name=label, **k):
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
    for label in dict.fromkeys(labels):
        ms = spent[label] * 1e3 / n
        staged += ms
        print(f"  {label:<34s} {ms:8.3f} ms/frame")
    print(f"  {'(rest)':<34s} {total - staged:8.3f} ms/frame")

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

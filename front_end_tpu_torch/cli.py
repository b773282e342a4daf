"""Command line of the port (counterpart of `front_end_tpu/cli.py`).

`python -m front_end_tpu_torch.cli <command>`:

  gen-table        export the detector / descriptor sweep tables
  detect-sweep     the single-image detection service over a family's IDs
  extract-motion   the Monte-Carlo estimator study (operating curves)
  ba-scaling       the landmark-sharded BA at 1, 2, 4 ... N ranks
  ransac-smoke     rigid RANSAC on a synthetic world of known motion
  vo               the VO pipeline (frame-to-frame, or `--window`: tracker
                   + windowed BA, `--shard-ba N`: over N ranks) on a KITTI
                   or EuRoC sequence read from disk, or on synthetic frames
  report           study, detection, descriptor and recorded-run figures
                   (SVG) and REPORT.md
  explore          a detector family's whole parameter grid over frames
  bench            the benchmark: VO frames/s at KITTI size, its variants,
                   the feed, stage times and the rendered-world ATE, as one
                   JSON line (`front_end_tpu_torch/bench.py`)

Every command that computes runs on the card unless `--device cpu` asks
for the CPU.  Every command of the JAX package has its counterpart here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


def cmd_gen_table(args):
    from front_end_tpu_torch import features
    n = features.export_table_yaml(args.out)
    print(f"wrote {n} entries to {args.out} "
          f"(detectors={len(features.detector_table())}, "
          f"descriptors={len(features.descriptor_table())})")


def cmd_detect_sweep(args):
    from front_end_tpu_torch import features, services

    if args.image:
        from front_end_tpu_torch.io.kitti import _read_image
        left = right = _read_image(args.image)
    else:
        from front_end_tpu_torch.sim.sequence import make_sequence
        L, R = make_sequence(1)
        left, right = L[0], R[0]
    table = features.detector_table()
    ids = [k for k, v in table.items() if v["Name"] == args.family][: args.n]
    res = services.single_image_detection(ids, left, right,
                                          device=args.device)
    for r in res:
        if not r["supported"]:
            continue
        print(f"{r['detID']}: L={r['leftFeatures']['nPoints']} "
              f"R={r['rightFeatures']['nPoints']} "
              f"t={r['processingTime'][0]['seconds'] * 1000:.2f}ms")


def cmd_extract_motion(args):
    from front_end_tpu_torch.analysis import sweeps
    print(json.dumps(sweeps.run_study(
        args.out, methods=tuple(args.methods.split(",")),
        speeds=tuple(args.speeds.split(",")),
        curves=tuple(int(c) for c in args.curves.split(",")),
        batch=args.batch, ideal_only=args.ideal, devices=args.devices,
        device=args.device)))


def _scaling_sizes(n_ranks: int) -> list[int]:
    """The group sizes `ba-scaling` measures: 1, 2, 4 ... and `n_ranks`."""
    return [s for s in (1, 2, 4, 8, 16, 32) if s < n_ranks] + [n_ranks]


def _ba_scaling_problem(args, n_ranks: int):
    """The JAX command's synthetic window: W poses of medium motion, L
    landmarks seen from each, noisy measurements, perturbed poses; padded
    to a multiple of every group size up to `n_ranks`, so each size splits
    the same problem.  Built on the host from the seed, the same on every
    rank."""
    import math

    import torch

    from front_end_tpu_torch.ba import distributed
    from front_end_tpu_torch.geometry import se3
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.sim import synthetic as sim

    gen = torch.Generator().manual_seed(args.seed)
    W, L = args.window, args.landmarks
    rig = StereoRig.create(fx=300.0, cx=160.0, cy=120.0, baseline=0.3,
                           width=320, height=240)
    cat = sim.motion_category("medium")
    Ts = [torch.eye(4)]
    for _ in range(W - 1):
        Ts.append(sim.sample_motion(gen, cat)[1] @ Ts[-1])
    T = torch.stack(Ts)
    world = sim.sample_world(gen, rig, cat, L)
    Xc = se3.transform_points(T, world.Xa)                    # (W, L, 3)
    meas = rig.project4(Xc).transpose(0, 1)
    vis = rig.in_view(Xc).transpose(0, 1) & world.valid[:, None]
    meas = meas + args.noise_px * torch.randn(meas.shape, generator=gen)
    dxi = 0.01 * torch.randn((W, 6), generator=gen)
    dxi[0] = 0.0
    T0 = se3.se3_exp(dxi) @ T
    return (rig, T0, *distributed.pad_landmarks(
        world.Xa, meas, vis, math.lcm(*_scaling_sizes(n_ranks))))


def _ba_scaling_rank(rank, group, dev, args, virtual: bool, n_hosts: int):
    """One rank of `ba-scaling`: for every size s, the first s ranks solve
    the whole problem in s blocks over a group of their own; sizes
    interleave across the repeats.  Rank 0 prints.  Returns ({size: this
    rank's BAResult}, {size: wall s}, {size: CPU s summed over ranks})."""
    import torch
    import torch.distributed as dist

    from front_end_tpu_torch.ba import distributed
    from front_end_tpu_torch.eval import metrics

    N = group.size()
    rig, T0, Xp, measp, visp = (a.to(dev) if isinstance(a, torch.Tensor)
                                else a
                                for a in _ba_scaling_problem(args, N))
    sizes = _scaling_sizes(N)
    groups = {s: dist.new_group(list(range(s))) for s in sizes}

    def solve(s):
        blocks = (distributed.local_block(a, rank, s)
                  for a in (Xp, measp, visp))
        return distributed.ba_solve_sharded(groups[s], T0, *blocks, rig,
                                            iters=args.iters)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {s: solve(s) for s in sizes if rank < s}     # warm-up
    sync()
    wall = {s: float("inf") for s in sizes}
    cpu = dict(wall)
    for _rep in range(args.repeats):
        for s in sizes:
            dist.barrier(group)
            dt = torch.zeros(2, dtype=torch.float64, device=dev)
            if rank < s:
                t0, c0 = time.perf_counter(), time.process_time()
                solve(s)
                sync()
                dt[0] = time.perf_counter() - t0
                dt[1] = time.process_time() - c0
            w = dt[:1].clone()
            dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(dt, group=group)        # CPU seconds summed
            wall[s] = min(wall[s], float(w[0]))
            cpu[s] = min(cpu[s], float(dt[1]))
    if rank:
        return results, wall, cpu
    L = int(Xp.shape[0])
    for s in sizes:
        r = results[s]
        print(f"n={s}: wall {wall[s]*1e3:.3f} ms  cpu {cpu[s]*1e3:.3f} ms  "
              f"cost {float(r.cost):.1f} (from {float(r.cost0):.1f}) "
              f"rms {float(r.rms_px):.2f}px")
    # ranks sharing a device time-slice it: process CPU seconds measure the
    # distribution's overhead there (per-rank time cpu(n) / n); separate
    # cards solve the whole problem in their wall time
    eff = metrics.scaling_efficiency(
        {n: n * L / cpu[n] for n in sizes} if virtual
        else {n: L / wall[n] for n in sizes})
    print(json.dumps({
        "n_hosts": n_hosts, "n_devices": N, "virtual_mesh": virtual,
        "landmarks": L, "window": args.window,
        "wall_ms": {str(n): t * 1e3 for n, t in wall.items()},
        "cpu_ms": {str(n): t * 1e3 for n, t in cpu.items()},
        "efficiency": {str(n): e for n, e in eff.items()}}), flush=True)
    return results, wall, cpu


def cmd_ba_scaling(args):
    """The landmark-sharded Schur LM at 1, 2, 4 ... N ranks on one
    synthetic window: wall and CPU ms per size and the scaling efficiency.
    `--ranks N` ranks are spawned here, placed as `ba.distributed.placement`
    says; with `--multihost` this process is one rank of a `torchrun`
    launch."""
    import torch

    from front_end_tpu_torch.ba import distributed

    if args.multihost:
        import torch.distributed as dist

        group = distributed.initialize()
        try:
            local = int(os.environ.get("LOCAL_RANK", 0))
            dev = (torch.device("cuda", local) if args.device != "cpu"
                   else torch.device("cpu"))
            n_local = int(os.environ.get("LOCAL_WORLD_SIZE", group.size()))
            virtual = (dev.type == "cpu"
                       or torch.cuda.device_count() < n_local)
            _ba_scaling_rank(group.rank(), group, dev, args, virtual,
                             group.size() // n_local)
        finally:
            dist.destroy_process_group()
        return
    n = args.ranks or (torch.cuda.device_count() if args.device != "cpu"
                       else 1)
    p = distributed.placement(n, args.device)
    print(f"ba-scaling over {n} rank(s): {distributed.describe(p)}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.launch(_ba_scaling_rank, n, (args, p.virtual, 1),
                           init_method=f"file://{tmp}/store",
                           device=args.device)


def cmd_ransac_smoke(args):
    """200 landmarks under known slow motion; print the recovered and the
    ideal rotation (roll, pitch, yaw) and translation."""
    import torch

    from front_end_tpu_torch.geometry import se3
    from front_end_tpu_torch.geometry.camera import bumblebee_rig
    from front_end_tpu_torch.motion import ransac
    from front_end_tpu_torch.sim import synthetic as sim
    from front_end_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(args.device)
    w = sim.sample_world(torch.Generator().manual_seed(args.seed),
                         bumblebee_rig(), sim.motion_category("slow"), 200)
    sampler = ransac.InverseCdfSampler(
        torch.Generator().manual_seed(args.seed + 1))
    res = ransac.rigid_ransac(sampler, w.Xa.to(dev), w.Xb.to(dev),
                              w.valid.to(dev))
    ang_i, t_i = se3.get_motion(w.Ht)
    ang_e, t_e = se3.get_motion(res.H.cpu())
    print("ideal     rpy=", ang_i.numpy(), " t=", t_i.numpy())
    print("recovered rpy=", ang_e.numpy(), " t=", t_e.numpy())
    print("inliers:", int(res.n_inliers))


def _open_sequence(args, dev):
    """-> (rig, frame iterator, ground-truth (T, 4, 4) poses or None)."""
    if args.kitti:
        from front_end_tpu_torch.io.kitti import KittiSequence
        seq = KittiSequence(args.kitti, args.seq, max_frames=args.frames)
        return seq.rig, seq.frames(), seq.poses
    if args.euroc:
        from front_end_tpu_torch.io.euroc import EurocSequence
        seq = EurocSequence(args.euroc, args.seq, max_frames=args.frames,
                            rectify=True, device=dev)
        return seq.rig, seq.frames(), None
    from front_end_tpu_torch.geometry.camera import kitti_rig
    from front_end_tpu_torch.sim.sequence import make_sequence
    rig = kitti_rig()
    L, R = make_sequence(args.frames or 40, h=rig.height, w=rig.width)
    return rig, zip(L, R), None


def cmd_vo(args):
    """`--window --shard-ba N` starts N ranks, each running the whole step
    on the same frames with the same RANSAC seed, the windowed BA sharded
    over them; rank 0 alone prints and writes."""
    if not (args.window and args.shard_ba):
        return _run_vo(args)
    from front_end_tpu_torch.ba import distributed
    n = args.shard_ba
    print(f"windowed BA sharded over {n} rank(s) (landmark axis): "
          f"{distributed.describe(distributed.placement(n, args.device))}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.launch(_vo_rank, n, (args,),
                           init_method=f"file://{tmp}/store",
                           device=args.device)


def _vo_rank(rank, group, dev, args):
    _run_vo(args, group=group, dev=dev)


def _run_vo(args, group=None, dev=None):
    import torch

    from front_end_tpu_torch.eval import metrics
    from front_end_tpu_torch.io.feed import DeviceFeed
    from front_end_tpu_torch.ops import grid
    from front_end_tpu_torch.pipeline import telemetry, vo, window_vo
    from front_end_tpu_torch.utils import checkpoint
    from front_end_tpu_torch.utils.precision import resolve_device

    lead = group is None or group.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    dev = dev or resolve_device(args.device)
    rig, frame_iter, gt = _open_sequence(args, dev)
    # the JAX package's benchmark configuration
    cfg = vo.VOConfig(
        grid=grid.GridConfig(cell_capacity=384, set_point=args.set_point,
                             init_threshold=15.0),
        descriptor=args.descriptor,
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0)
    if args.window:
        # the compacted BA problem divides among the ranks
        n = 1 if group is None else group.size()
        wcfg = window_vo.WindowVOConfig.create(
            cfg, window=args.window_size, ba_every=args.ba_every,
            ba_iters=args.ba_iters, ba_max_landmarks=-(-1024 // n) * n,
            ba_group=group)
        if args.max_age is not None:
            wcfg = wcfg.replace(tracker=dataclasses.replace(
                wcfg.tracker, max_age=args.max_age))
        state = window_vo.init_state(rig, wcfg, device=dev)

        def step(s, l, r):
            s, o = window_vo.window_vo_step(s, l, r, rig, wcfg)
            return s, o, o.frame, s.vo.prev
    else:
        state = vo.init_state(rig, cfg, device=dev)

        def step(s, l, r):
            s, o = vo.vo_step(s, l, r, rig, cfg)
            return s, o, o, s.prev

    # --resume: the carried state (thresholds, features, pose, frame
    # indices, the RANSAC generator) and the trajectory so far; the frames
    # already processed are skipped
    n_done, prior = 0, np.zeros((0, 4, 4))
    if args.resume:
        with open(args.resume + ".meta.json") as f:
            meta = json.load(f)
        if (meta["window"] != bool(args.window)
                or meta["descriptor"] != args.descriptor):
            raise SystemExit(f"resume config mismatch: checkpoint was "
                             f"{meta}, flags differ")
        n_done = int(meta["n_processed"])
        prior = np.load(args.resume + ".traj.npy")
        state = checkpoint.load_state(args.resume, state)
        say(f"resuming after {n_done} frames from {args.resume}")

    def skip_done(it):
        for i, pair in enumerate(it):
            if i >= n_done:
                yield pair

    tlog = telemetry.TelemetryLog() if args.record and lead else None
    poses = []
    # --record keeps the program's spans and counters too, per frame
    with (telemetry.recording() if tlog is not None
          else contextlib.nullcontext()) as rec:
        for i, (l, r) in enumerate(DeviceFeed(skip_done(frame_iter),
                                              device=dev,
                                              first_frame=n_done)):
            if tlog is None:
                state, out, frame, feats = step(state, l, r)
            else:
                with telemetry.FrameClock(tlog, device=dev):
                    state, out, frame, feats = step(state, l, r)
                tlog.count("n_detect_l", frame.n_detect_l)
                tlog.count("n_stereo", frame.n_stereo)
                if args.window:
                    tlog.count("n_inliers", frame.n_inliers)
                    tlog.count("n_tracked", out.n_tracked)
                    tlog.count("ba_rms_px", out.ba_rms_px)
                else:
                    tlog.count("n_tracks", frame.n_tracks)
                    tlog.count("n_inliers", frame.n_inliers)
            poses.append(frame.pose)
            if args.debug_images and lead and i % args.debug_every == 0:
                _dump_debug(args.debug_images, i, l, r, feats, frame)
            if args.verbose and i % 25 == 0:
                extra = (f" tracked={int(out.n_tracked)} "
                         f"ba_rms={float(out.ba_rms_px):.2f}px"
                         if args.window else "")
                say(f"frame {i}: stereo={int(frame.n_stereo)} "
                    f"inliers={int(frame.n_inliers)}{extra}")
    if rec is not None:
        telemetry.add_recording(tlog, rec,
                                range(n_done, n_done + len(poses)))
    new = (torch.stack(poses).cpu().numpy().astype(np.float64) if poses
           else np.zeros((0, 4, 4)))
    poses = np.concatenate([prior, new])
    if not lead:
        return
    print(f"processed {len(poses)} frames"
          + (" (windowed BA mode)" if args.window else ""))
    if tlog is not None:
        platform = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
        path = telemetry.save_log(args.record, tlog, meta={
            "descriptor": args.descriptor, "window": bool(args.window),
            "platform": platform,
            "resolution": f"{rig.height}x{rig.width}"})
        print(f"telemetry recording -> {path}")
    if args.save_state:
        checkpoint.save_state(args.save_state, state)
        np.save(args.save_state + ".traj.npy", poses)
        with open(args.save_state + ".meta.json", "w") as f:
            json.dump({"n_processed": int(len(poses)),
                       "window": bool(args.window),
                       "descriptor": args.descriptor}, f)
        print(f"state -> {args.save_state} (+ .traj.npy, .meta.json)")
    if gt is not None and len(poses):
        n = min(len(poses), len(gt))
        ate = metrics.ate_rmse(poses[:n, :3, 3], gt[:n, :3, 3])
        print(f"ATE RMSE: {ate:.3f} m")
    if args.out:
        np.savetxt(args.out, poses[:, :3, :].reshape(len(poses), 12))
        print(f"trajectory -> {args.out}")


def _dump_debug(out_dir, i, l, r, feats, frame):
    """The stereo matches (side by side) and the tracks over the anaglyph
    of frame i, drawn from the step's own state, as PNG files."""
    from front_end_tpu_torch.utils import png
    from front_end_tpu_torch.viz import draw

    os.makedirs(out_dir, exist_ok=True)
    png.write(os.path.join(out_dir, f"match_{i:05d}.png"),
              draw.draw_stereo_uv4(l, r, feats.uv4, feats.stereo_valid))
    png.write(os.path.join(out_dir, f"tracks_{i:05d}.png"),
              draw.draw_tracks(draw.anaglyph(l, r), frame.track_xy_prev,
                               feats.kps.xy, frame.track_inliers,
                               frame.track_valid))


def cmd_report(args):
    """Study, detection, descriptor and recorded-run figures and
    REPORT.md."""
    from front_end_tpu_torch.analysis import report

    frames = None
    if args.kitti:
        from front_end_tpu_torch.io.kitti import KittiSequence
        seq = KittiSequence(args.kitti, args.seq, max_frames=args.frames)
        pairs = list(seq.frames())
        frames = (np.stack([p[0] for p in pairs]),
                  np.stack([p[1] for p in pairs]))
    path = report.generate_report(
        args.study, args.out, frames=frames,
        with_timings=not args.no_timings, bench_json=args.bench_json,
        records=args.record, device=args.device)
    print(f"report -> {path}")


def cmd_explore(args):
    from front_end_tpu_torch.analysis import explore
    explore.explore_features(family=args.family, out=args.out,
                             image=args.image, n_frames=args.frames,
                             top=args.top, device=args.device)


def main(argv=None):
    from front_end_tpu_torch import bench

    p = argparse.ArgumentParser(prog="front_end_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card; "
                             "`cpu` runs on the CPU)")

    g = sub.add_parser("gen-table")
    g.add_argument("--out", default="detectorLookupTable.yaml")
    g.set_defaults(fn=cmd_gen_table)

    d = sub.add_parser("detect-sweep")
    d.add_argument("--family", default="FAST")
    d.add_argument("--n", type=int, default=10)
    d.add_argument("--image", default=None)
    device_flag(d)
    d.set_defaults(fn=cmd_detect_sweep)

    e = sub.add_parser("extract-motion")
    e.add_argument("--out", default="fe_torch_study")
    e.add_argument("--methods", default="PCL,Nister,BA")
    e.add_argument("--speeds", default="slow,medium,fast")
    e.add_argument("--curves", default="100,250,500")
    e.add_argument("--batch", type=int, default=64)
    e.add_argument("--ideal", action="store_true")
    e.add_argument("--devices", type=int, default=None,
                   help="split each condition's world batch over N cards")
    device_flag(e)
    e.set_defaults(fn=cmd_extract_motion)

    bs = sub.add_parser("ba-scaling")
    bs.add_argument("--landmarks", type=int, default=32768)
    bs.add_argument("--window", type=int, default=3)
    bs.add_argument("--iters", type=int, default=8)
    bs.add_argument("--repeats", type=int, default=3)
    bs.add_argument("--noise-px", type=float, default=0.5)
    bs.add_argument("--seed", type=int, default=0)
    bs.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: one per card; on the "
                         "CPU, 1); ranks beyond the cards share them")
    bs.add_argument("--multihost", action="store_true",
                    help="this process is one rank of a torchrun launch")
    device_flag(bs)
    bs.set_defaults(fn=cmd_ba_scaling)

    r = sub.add_parser("ransac-smoke")
    r.add_argument("--seed", type=int, default=0)
    device_flag(r)
    r.set_defaults(fn=cmd_ransac_smoke)

    v = sub.add_parser("vo")
    v.add_argument("--kitti", default=None, help="KITTI odometry root")
    v.add_argument("--euroc", default=None,
                   help="EuRoC root (rectified on the fly)")
    v.add_argument("--seq", default="00")
    v.add_argument("--frames", type=int, default=None)
    v.add_argument("--set-point", type=int, default=2000)
    v.add_argument("--descriptor", default="brief",
                   choices=["brief", "brief_pallas", "orb", "surf",
                            "surf_ext", "freak", "brisk"],
                   help="live descriptor (the reference's swap set); "
                        "surf/surf_ext match with L2, the rest with Hamming")
    v.add_argument("--out", default=None,
                   help="write the trajectory as KITTI 12-column rows")
    v.add_argument("--verbose", action="store_true")
    v.add_argument("--window", action="store_true",
                   help="live window mode: tracker + windowed BA")
    v.add_argument("--window-size", type=int, default=3)
    v.add_argument("--ba-every", type=int, default=1)
    v.add_argument("--ba-iters", type=int, default=6,
                   help="LM iterations of each windowed BA solve")
    v.add_argument("--max-age", type=int, default=None,
                   help="landmark track-retention horizon in frames "
                        "(default 3)")
    v.add_argument("--shard-ba", type=int, default=0, metavar="N",
                   help="with --window: shard the windowed BA's landmark "
                        "blocks over N ranks (0 = one process)")
    v.add_argument("--debug-images", default=None, metavar="DIR",
                   help="write stereo-match and anaglyph track overlays "
                        "(PNG) every --debug-every frames to DIR")
    v.add_argument("--debug-every", type=int, default=10)
    v.add_argument("--record", default=None, metavar="PATH",
                   help="record per-frame telemetry (frame time, "
                        "counters, the program's spans as stage_<span> "
                        "host seconds and its counters) to PATH (.npz)")
    v.add_argument("--save-state", default=None, metavar="PATH",
                   help="checkpoint the carried pipeline state and the "
                        "trajectory after the run")
    v.add_argument("--resume", default=None, metavar="PATH",
                   help="restore a --save-state checkpoint and continue "
                        "from the next unprocessed frame")
    device_flag(v)
    v.set_defaults(fn=cmd_vo)

    rp = sub.add_parser("report")
    rp.add_argument("--study", default=None,
                    help="extract-motion output directory")
    rp.add_argument("--out", default="fe_torch_report")
    rp.add_argument("--kitti", default=None)
    rp.add_argument("--seq", default="00")
    rp.add_argument("--frames", type=int, default=12)
    rp.add_argument("--no-timings", action="store_true")
    rp.add_argument("--bench-json", default=None)
    rp.add_argument("--record", action="append", default=[], metavar="PATH",
                    help="a `vo --record` recording to render (repeatable)")
    device_flag(rp)
    rp.set_defaults(fn=cmd_report)

    x = sub.add_parser("explore")
    x.add_argument("--family", default="FAST")
    x.add_argument("--out", default="fe_torch_explore")
    x.add_argument("--image", default=None)
    x.add_argument("--frames", type=int, default=4)
    x.add_argument("--top", type=int, default=12)
    device_flag(x)
    x.set_defaults(fn=cmd_explore)

    b = sub.add_parser("bench")
    bench.add_arguments(b)
    b.set_defaults(fn=bench.run)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port (counterpart of `front_end_tpu/cli.py`).

`python -m front_end_tpu_torch.cli <command>`:

  gen-table        export the detector / descriptor sweep tables
  detect-sweep     the single-image detection service over a family's IDs
  ransac-smoke     rigid RANSAC on a synthetic world of known motion
  vo               the VO pipeline (frame-to-frame, or `--window`: tracker
                   + windowed BA) on a KITTI or EuRoC sequence read from
                   disk, or on synthetic frames

Every command that computes runs on the card unless `--device cpu` asks
for the CPU.  The JAX package's `extract-motion`, `ba-scaling`, `report`,
`explore` and `bench` commands and `vo --shard-ba` are not here yet:
they need the studies and the landmark-sharded BA (`ROADMAP.md` Queue 1
item 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

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
    import torch

    from front_end_tpu_torch.eval import metrics
    from front_end_tpu_torch.io.feed import DeviceFeed
    from front_end_tpu_torch.ops import grid
    from front_end_tpu_torch.pipeline import telemetry, vo, window_vo
    from front_end_tpu_torch.utils import checkpoint
    from front_end_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(args.device)
    rig, frame_iter, gt = _open_sequence(args, dev)
    # the JAX package's benchmark configuration
    cfg = vo.VOConfig(
        grid=grid.GridConfig(cell_capacity=384, set_point=args.set_point,
                             init_threshold=15.0),
        descriptor=args.descriptor,
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0)
    if args.window:
        wcfg = window_vo.WindowVOConfig.create(
            cfg, window=args.window_size, ba_every=args.ba_every,
            ba_max_landmarks=1024)
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
        print(f"resuming after {n_done} frames from {args.resume}")

    def skip_done(it):
        for i, pair in enumerate(it):
            if i >= n_done:
                yield pair

    tlog = telemetry.TelemetryLog() if args.record else None
    poses = []
    for i, (l, r) in enumerate(DeviceFeed(skip_done(frame_iter),
                                          device=dev)):
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
        if args.debug_images and i % args.debug_every == 0:
            _dump_debug(args.debug_images, i, l, r, feats, frame)
        if args.verbose and i % 25 == 0:
            extra = (f" tracked={int(out.n_tracked)} "
                     f"ba_rms={float(out.ba_rms_px):.2f}px"
                     if args.window else "")
            print(f"frame {i}: stereo={int(frame.n_stereo)} "
                  f"inliers={int(frame.n_inliers)}{extra}")
    new = (torch.stack(poses).cpu().numpy().astype(np.float64) if poses
           else np.zeros((0, 4, 4)))
    poses = np.concatenate([prior, new])
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


def main(argv=None):
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
    v.add_argument("--max-age", type=int, default=None,
                   help="landmark track-retention horizon in frames "
                        "(default 3)")
    v.add_argument("--debug-images", default=None, metavar="DIR",
                   help="write stereo-match and anaglyph track overlays "
                        "(PNG) every --debug-every frames to DIR")
    v.add_argument("--debug-every", type=int, default=10)
    v.add_argument("--record", default=None, metavar="PATH",
                   help="record per-frame telemetry (frame time + "
                        "counters) to PATH (.npz)")
    v.add_argument("--save-state", default=None, metavar="PATH",
                   help="checkpoint the carried pipeline state and the "
                        "trajectory after the run")
    v.add_argument("--resume", default=None, metavar="PATH",
                   help="restore a --save-state checkpoint and continue "
                        "from the next unprocessed frame")
    device_flag(v)
    v.set_defaults(fn=cmd_vo)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

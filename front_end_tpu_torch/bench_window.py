"""Windowed-mode operating-point sweep: (fps, ATE) per (ba_every, iters),
then per window length (counterpart of the root `bench_window.py`).

    python -m front_end_tpu_torch.bench_window [--device cuda]

The windowed pipeline's BA share of the frame is tuned by running it
every k-th frame and by its LM iteration count.  This sweep measures both
sides of the trade on the same inputs:

- fps at KITTI resolution on the device: 20 synthetic frames
  (`sim/sequence.py`) staged beforehand, 3 warm-up frames, then 4 passes
  carrying one state, a host clock ending in a device synchronize;
- ATE on 40 frames of the rendered 6-DoF corridor (`sim/render.py`),
  against the plain frame-to-frame pipeline's.

The grid is `ba_every` in {1, 2, 4} x `iters` in {2, 4}, then the window
lengths {3, 4, 6, 8} at the benchmark's operating point (`ba_every=2`,
`iters=2`) with the sharded solver's bytes per LM iteration
(`ba/distributed.comm_audit`).  Prints the JAX script's markdown tables.
`--frames`, `--passes`, `--rendered-frames` and `--size` cut the depth.
"""
from __future__ import annotations

import argparse

import torch

from front_end_tpu_torch import bench
from front_end_tpu_torch.ba import distributed
from front_end_tpu_torch.eval import metrics
from front_end_tpu_torch.pipeline import vo, window_vo
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.utils.precision import resolve_device

GRID = ((1, 2), (1, 4), (2, 2), (2, 4), (4, 2), (4, 4))
WINDOWS = (3, 4, 6, 8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="front_end_tpu_torch.bench_window")
    bench.add_depth_arguments(p, frames=20, passes=4)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    bench.build_kernels(dev)
    h, w = bench.parse_size(args.size)
    rig, cfg = bench.bench_rig(h, w), bench.vo_config()
    lefts, rights = make_sequence(args.frames, h=h, w=w, seed=args.seed)
    L = [torch.as_tensor(x).to(dev) for x in lefts]
    R = [torch.as_tensor(x).to(dev) for x in rights]
    rrig, gt, rl, rr = bench.rendered_world(args.rendered_frames)
    rcfg = bench.rendered_config()

    def ate(traj):
        return metrics.ate_rmse(traj[:, :3, 3], gt[:, :3, 3])

    def windowed_ate(ba_every, iters, window=3):
        wc = bench.operating_point(rcfg, window, ba_every, iters)
        return ate(bench.trajectory(
            lambda s, left, right: window_vo.window_vo_step(
                s, left, right, rrig, wc),
            window_vo.init_state(rrig, wc, device=dev), rl, rr,
            lambda o: o.frame.pose))

    def fps(ba_every, iters, window=3):
        wc = bench.operating_point(cfg, window, ba_every, iters)
        return bench.timed_loop(
            lambda s, left, right: window_vo.window_vo_step(
                s, left, right, rig, wc),
            window_vo.init_state(rig, wc, device=dev), L, R, args.passes,
            3, dev)[0]

    ate_plain = ate(bench.trajectory(
        lambda s, left, right: vo.vo_step(s, left, right, rrig, rcfg),
        vo.init_state(rrig, rcfg, device=dev), rl, rr, lambda o: o.pose))

    rows = ["| mode | ba_every | iters | fps/chip | ATE (m) |",
            "|---|---|---|---|---|",
            f"| frame-to-frame | — | — | (see bench headline) | "
            f"{ate_plain:.4f} |"]
    for ba_every, iters in GRID:
        rows.append(f"| windowed | {ba_every} | {iters} | "
                    f"{fps(ba_every, iters):.1f} | "
                    f"{windowed_ate(ba_every, iters):.4f} |")
        print(f"  measured: {rows[-1]}", flush=True)
    print("\n".join(rows))

    rows = ["", "| window W | fps/chip | ATE (m) | comm/iter (B) |",
            "|---|---|---|---|"]
    for n in WINDOWS:
        cb = distributed.comm_audit(n, 1)["bytes_per_iter"]
        rows.append(f"| {n} | {fps(2, 2, window=n):.1f} | "
                    f"{windowed_ate(2, 2, window=n):.4f} | {cb} |")
        print(f"  measured: {rows[-1]}", flush=True)
    print("\n".join(rows))
    print(f"bench_window: {len(L)} frames x {args.passes} passes at "
          f"{h}x{w}, {len(rl)} rendered frames on "
          f"{bench.device_name(dev)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Benchmark of the port: stereo VO frames/s on one card at KITTI
resolution (counterpart of the root `bench.py`).

    python -m front_end_tpu_torch.bench [--device cuda] [--seed 5]
    python -m front_end_tpu_torch.cli bench     (the same, as a command)

Prints ONE JSON line last, with the keys and meanings of the JAX
package's benchmark line:

  {"metric": "kitti_stereo_vo_frames_per_s_per_chip", "value": fps,
   "unit": "frames/s", "vs_baseline": value / 200, "detail": {...}}

200 frames/s is the north star of `BASELINE.json`.  The headline is
`vo_step` over 40 synthetic KITTI-size pairs (`sim/sequence.py`) staged on
the device beforehand, 5 passes carrying one state, after a 2-frame
warm-up; every timing is a host clock ending in a device synchronize.
`detail` adds the same loop with 128-bit BRIEF and with sub-pixel
refinement; `run_sequence` over the stacked frames (`fps_device_scan`:
the port dispatches it frame by frame, there is no scan); the windowed
pipeline at its operating point (`ba_every=2`, `ba_iters=2`); the loop fed
from PGM files through `io/feed.py::DeviceFeed` (`fps_feed_inclusive`;
`feed_source` says whether the native decode ring or the port's own PGM
reader decoded them); the pageable host-to-device rate; eager per-call
stage times; and the ATE of the plain and windowed pipelines on 40
frames of the rendered corridor (`sim/render.py`).

`--frames`, `--passes`, `--stage-calls`, `--rendered-frames` and `--size`
cut the depth (each defaults to the JAX benchmark's value); the line
records the frames as `n_frames` (passes x frames) and `resolution`, the
stage calls in `stage_ms.note`.  Without a card, `--device cuda` (the
default) raises and nothing is printed.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import tempfile
import time

import numpy as np
import torch

from front_end_tpu_torch.eval import metrics
from front_end_tpu_torch.geometry.camera import StereoRig, kitti_rig
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import vo, window_vo
from front_end_tpu_torch.sim import render
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.utils.precision import pinned_f32, resolve_device

BASELINE_FPS = 200.0
KITTI_SIZE = "376x1241"
WARM_FRAMES = 2         # before each timed loop, as the JAX benchmark
# the kernels of the VO and windowed paths, built before any warm-up
PATH_KERNELS = ("fast_grid", "brief_keypoints", "match_reduce")


def vo_config() -> vo.VOConfig:
    """The headline configuration (`bench.py:128-132`)."""
    return vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=384,
                             set_point=2000, init_threshold=15.0),
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0, min_track_inliers=12)


def rendered_config() -> vo.VOConfig:
    """The rendered corridor's configuration (`bench.py:308-312`)."""
    return vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=128,
                             set_point=700, init_threshold=12.0),
        desc_bytes=32, ransac_hyps=192, ransac_threshold=0.12,
        max_disparity=60.0, min_track_inliers=10)


def operating_point(cfg: vo.VOConfig) -> window_vo.WindowVOConfig:
    """The windowed pipeline at the JAX benchmark's operating point, not
    `WindowVOConfig.create`'s defaults (`ba_every=1`, `ba_iters=6`)."""
    return window_vo.WindowVOConfig.create(cfg, window=3, ba_every=2,
                                           ba_iters=2)


def configs() -> dict:
    """Every configuration the benchmark runs, by the name of its figure."""
    cfg, rcfg = vo_config(), rendered_config()
    return {"vo": cfg, "brief16": cfg.replace(desc_bytes=16),
            "subpix": cfg.replace(subpix=True),
            "windowed": operating_point(cfg), "rendered": rcfg,
            "rendered_windowed": operating_point(rcfg)}


def parse_size(text: str) -> tuple[int, int]:
    h, w = (int(v) for v in text.lower().split("x"))
    return h, w


def bench_rig(h: int, w: int) -> StereoRig:
    """`kitti_rig()` at its own size; a cut size keeps its focal length and
    baseline with the principal point at the centre."""
    k = kitti_rig()
    if (h, w) == (k.height, k.width):
        return k
    return StereoRig.create(fx=k.fx, fy=k.fy, cx=(w - 1) / 2,
                            cy=(h - 1) / 2, baseline=k.baseline, width=w,
                            height=h)


def rendered_world(n_frames: int):
    """The rendered 6-DoF corridor of `bench.py:302-307` ->
    (rig, (T, 4, 4) ground truth, lefts, rights)."""
    rig = StereoRig.create(fx=200.0, cx=127.5, cy=95.5, baseline=0.3,
                           width=256, height=192)
    scene = render.corridor_scene(np.random.RandomState(11), tex_size=384)
    gt = render.corridor_trajectory(n_frames)
    lefts, rights = render.render_stereo_sequence(scene, rig, gt)
    return rig, gt, lefts, rights


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's description."""
    if dev.type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[dev.index or 0]
    return (f"cpu ({platform.machine()}, {torch.get_num_threads()} "
            f"threads)")


def build_kernels(dev: torch.device) -> None:
    """Compile the path's kernels before any warm-up (no-op on the CPU)."""
    if dev.type == "cuda":
        from front_end_tpu_torch.ops.kernels import _build
        _build.build(*PATH_KERNELS)


def timed_loop(step, state, L, R, passes: int, dev):
    """`WARM_FRAMES` frames (the first ones, cycled), then `passes` passes
    over the frames carrying the state -> (fps, seconds, state, last
    output)."""
    for t in range(WARM_FRAMES):
        state, out = step(state, L[t % len(L)], R[t % len(R)])
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(passes):
        for left, right in zip(L, R):
            state, out = step(state, left, right)
    sync(dev)
    dt = time.perf_counter() - t0
    return passes * len(L) / dt, dt, state, out


def trajectory(step, state, lefts, rights, pose_of) -> np.ndarray:
    """Step over the frames -> (T, 4, 4) float64 poses."""
    poses = []
    for left, right in zip(lefts, rights):
        state, out = step(state, left, right)
        poses.append(pose_of(out))
    return torch.stack(poses).cpu().double().numpy()


def _write_pgm(path, img) -> None:
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.asarray(img, np.uint8).tobytes())


def feed_inclusive(step, state0, lefts, rights, rig, dev,
                   runs: int = 3) -> tuple[float, str]:
    """PGM on disk -> decode -> `DeviceFeed` (uint8, pinned ring on the
    card) -> step: one warm run, then the best of `runs` ->
    (fps, "native" or "python").  The native decode ring where it builds
    (g++ and libpng), else the PGM reader of `cli vo --kitti`."""
    from front_end_tpu_torch.io import kitti, native_feed
    from front_end_tpu_torch.io.feed import DeviceFeed

    source = "native" if native_feed.available() else "python"
    n = len(lefts)
    with tempfile.TemporaryDirectory(prefix="fe_torch_bench_") as d:
        lp = [os.path.join(d, f"l{i:03d}.pgm") for i in range(n)]
        rp = [os.path.join(d, f"r{i:03d}.pgm") for i in range(n)]
        for paths, imgs in ((lp, lefts), (rp, rights)):
            for p, img in zip(paths, imgs):
                _write_pgm(p, img)

        def run_once():
            if source == "native":
                src = native_feed.NativeStereoFeed(
                    lp, rp, rig.height, rig.width, ring=8, threads=4)
                frames = iter(src)
            else:
                src = None
                frames = ((kitti._read_image(a), kitti._read_image(b))
                          for a, b in zip(lp, rp))
            try:
                state = state0
                t0 = time.perf_counter()
                for left, right in DeviceFeed(frames, depth=4, device=dev):
                    state, _ = step(state, left, right)
                sync(dev)
                return n / (time.perf_counter() - t0)
            finally:
                if src is not None:
                    src.close()

        run_once()                   # warm: file cache, feed, allocator
        return max(run_once() for _ in range(runs)), source


def h2d_rates(lefts, dev) -> tuple[float | None, float | None]:
    """Pageable host-to-device MB/s (medians of 3): one put of 8 uint8
    frames, and 8 frame-sized puts then one synchronize; each repetition
    XORs the bytes so no put repeats.  None on the CPU (no link)."""
    if dev.type != "cuda":
        return None, None
    blob = np.ascontiguousarray(np.stack(lefts[:8]).astype(np.uint8))
    one, pipe = [], []
    for rep in range(3):
        b = blob ^ rep
        t0 = time.perf_counter()
        torch.from_numpy(b).to(dev)
        sync(dev)
        one.append(b.nbytes / 1e6 / (time.perf_counter() - t0))
    for rep in range(3):
        frames = [np.ascontiguousarray(f ^ (rep + 1)) for f in blob]
        t0 = time.perf_counter()
        for f in frames:
            torch.from_numpy(f).to(dev)
        sync(dev)
        pipe.append(sum(f.nbytes for f in frames) / 1e6
                    / (time.perf_counter() - t0))
    return float(np.median(one)), float(np.median(pipe))


def stage_ms(fn, n: int, dev) -> float:
    """ms per eager call of `fn`: one warm call, then `n` calls on a host
    clock ending in a synchronize."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The benchmark's arguments; the depth ones default to the JAX
    script's values."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; `cpu` "
                        "runs on the CPU)")
    p.add_argument("--seed", type=int, default=5,
                   help="seed of the synthetic frames")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--passes", type=int, default=5)
    p.add_argument("--rendered-frames", type=int, default=40)
    p.add_argument("--size", default=KITTI_SIZE, metavar="HxW",
                   help="frame size of the synthetic sequence")
    p.add_argument("--stage-calls", type=int, default=50)


def run(args) -> dict:
    """Every measurement of the benchmark; prints and returns its line."""
    from front_end_tpu_torch.motion import ransac

    dev = resolve_device(args.device)
    build_kernels(dev)
    h, w = parse_size(args.size)
    rig = bench_rig(h, w)
    cf = configs()
    cfg = cf["vo"]
    passes, calls = args.passes, args.stage_calls
    lefts, rights = make_sequence(args.frames, h=h, w=w, seed=args.seed)
    n_frames = len(lefts)

    def stepper(c):
        return lambda s, left, right: vo.vo_step(s, left, right, rig, c)

    def wstepper(c, r=rig):
        return lambda s, left, right: window_vo.window_vo_step(
            s, left, right, r, c)

    # ---- headline: frames staged on the device beforehand ---------------
    L = [torch.as_tensor(x).to(dev) for x in lefts]
    R = [torch.as_tensor(x).to(dev) for x in rights]
    sync(dev)
    fps, dt, state, out = timed_loop(stepper(cfg), vo.init_state(
        rig, cfg, device=dev), L, R, passes, dev)

    # ---- run_sequence over the stacked frames ---------------------------
    Ls, Rs = torch.stack(L), torch.stack(R)
    st, outs = vo.run_sequence(vo.init_state(rig, cfg, device=dev), Ls, Rs,
                               rig, cfg)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(passes):
        st, outs = vo.run_sequence(st, Ls, Rs, rig, cfg)
    sync(dev)
    fps_scan = passes * n_frames / (time.perf_counter() - t0)

    # ---- 128-bit BRIEF; sub-pixel refinement -----------------------------
    fps_b16 = timed_loop(stepper(cf["brief16"]), vo.init_state(
        rig, cf["brief16"], device=dev), L, R, passes, dev)[0]
    fps_subpix = timed_loop(stepper(cf["subpix"]), vo.init_state(
        rig, cf["subpix"], device=dev), L, R, passes, dev)[0]

    # ---- host -> device -------------------------------------------------
    h2d, h2d_pipe = h2d_rates(lefts, dev)

    # ---- per-stage eager timings on frame 0 ------------------------------
    with pinned_f32():
        floor_x = torch.zeros(8, dtype=torch.float32, device=dev)
        st_floor = stage_ms(lambda: floor_x + 1.0, calls, dev)
        tl, tr = state.thresholds_l, state.thresholds_r
        st_detect = stage_ms(
            lambda: grid.detect_pair(L[0], R[0], tl, tr, cfg.grid), calls,
            dev)
        st_extract = stage_ms(
            lambda: vo._extract_frame(L[0], R[0], tl, tr, rig, cfg), calls,
            dev)
        feats0 = vo._extract_frame(L[0], R[0], tl, tr, rig, cfg)[0]
        sampler = ransac.InverseCdfSampler(torch.Generator().manual_seed(0))
        st_motion = stage_ms(
            lambda: vo._estimate_motion(sampler, feats0, feats0, rig, cfg),
            calls, dev)

    # ---- end to end: PGM files -> decode -> DeviceFeed -> step -----------
    fps_feed, feed_source = feed_inclusive(
        stepper(cfg), vo.init_state(rig, cfg, device=dev), lefts, rights,
        rig, dev)

    # ---- accuracy: rendered-world ATE, plain and windowed ----------------
    rrig, gt, rl, rr = rendered_world(args.rendered_frames)
    rcfg, rwcfg = cf["rendered"], cf["rendered_windowed"]
    traj = trajectory(lambda s, left, right: vo.vo_step(s, left, right,
                                                        rrig, rcfg),
                      vo.init_state(rrig, rcfg, device=dev), rl, rr,
                      lambda o: o.pose)
    ate_plain = metrics.ate_rmse(traj[:, :3, 3], gt[:, :3, 3])
    traj = trajectory(wstepper(rwcfg, rrig),
                      window_vo.init_state(rrig, rwcfg, device=dev), rl, rr,
                      lambda o: o.frame.pose)
    ate_win = metrics.ate_rmse(traj[:, :3, 3], gt[:, :3, 3])

    # ---- the windowed pipeline at its operating point --------------------
    wcfg = cf["windowed"]
    fps_win, _, _, wout = timed_loop(wstepper(wcfg), window_vo.init_state(
        rig, wcfg, device=dev), L, R, passes, dev)

    device = device_name(dev)
    value = round(fps, 2)       # vs_baseline is value / 200, as in `bench.py`
    mb_frame = 2 * h * w / 1e6                  # a uint8 stereo pair
    link = ("no host-to-device link on the CPU" if h2d is None else
            f"{h2d:.1f} MB/s one pageable put of 8 frames / "
            f"{h2d_pipe:.1f} MB/s 8 frame-sized pageable puts")
    result = {
        "metric": "kitti_stereo_vo_frames_per_s_per_chip",
        "value": value,
        "unit": "frames/s",
        "vs_baseline": round(value / BASELINE_FPS, 3),
        "detail": {
            "resolution": f"{h}x{w}",
            "keypoint_capacity": cfg.grid.capacity,
            "n_frames": passes * n_frames,
            "ms_per_frame": round(1000.0 * dt / (passes * n_frames), 3),
            "device": device,
            "n_inliers_last": int(out.n_inliers),
            "motion_ok_last": bool(out.motion_ok),
            "fps_feed_inclusive": round(fps_feed, 2),
            "feed_source": feed_source,
            "h2d_link_mb_per_s": None if h2d is None else round(h2d, 1),
            "h2d_pipelined_mb_per_s": (None if h2d_pipe is None
                                       else round(h2d_pipe, 1)),
            "stage_ms": {
                "harness_floor": round(st_floor, 3),
                "detect_pair": round(st_detect, 3),
                "describe_match_triangulate": round(
                    max(st_extract - st_detect, 0.0), 3),
                "extract_total": round(st_extract, 3),
                "motion_ransac_lm": round(st_motion, 3),
                "tracker_ba_overhead": round(
                    1000.0 / max(fps_win, 1e-9)
                    - 1000.0 / max(fps, 1e-9), 3),
                "note": f"eager per-call timings on frame 0, {calls} calls "
                        f"each after a warm call, host clock ending in a "
                        f"device synchronize (not one scan); "
                        f"harness_floor is the same harness around an (8,) "
                        f"add: read each stage net of it; "
                        f"tracker_ba_overhead is fps_windowed's ms/frame "
                        f"less the headline's",
            },
            "roofline": (
                f"feed {fps_feed:.1f} fps x {mb_frame:.3f} MB/frame (uint8 "
                f"pair) = {fps_feed * mb_frame:.1f} MB/s through DeviceFeed "
                f"({feed_source} decode) against {link}; {device}"),
            "fps_subpix_on": round(fps_subpix, 2),
            "fps_brief16": round(fps_b16, 2),
            "fps_device_scan": round(fps_scan, 2),
            "fps_windowed": round(fps_win, 2),
            "windowed_ba_ran_last": bool(wout.ba_ran),
            "windowed_n_tracked_last": int(wout.n_tracked),
            "ate_rendered_world_m": round(float(ate_plain), 4),
            "ate_rendered_world_windowed_m": round(float(ate_win), 4),
        },
    }
    print(f"bench: {n_frames} frames x {passes} passes at {h}x{w}, "
          f"{calls} stage calls, {len(rl)} rendered frames on {device}",
          flush=True)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="front_end_tpu_torch.bench")
    add_arguments(p)
    run(p.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

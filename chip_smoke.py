#!/usr/bin/env python3
"""Drive the PyTorch port (`front_end_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the six CUDA kernels from `front_end_tpu_torch/csrc/` (one
     nvcc per source, all at once) and hold each against its plain PyTorch
     twin — exact equality — at the shapes its path gives it, timing
     kernel and twin with CUDA events: the grid, BRIEF and match kernels
     at the VO path's shapes (KITTI 376×1241 stereo pair, 2304 keypoints,
     256 bits; the grid kernel at thresholds from -inf, where every pixel
     is a candidate of its early rejection, to 60, with a per-cell table,
     and on a crop small enough for the lower of its two score windows; the
     keypoint BRIEF kernel also
     at 128 and 512 bits and against the gathered dense planes; the dense
     plane kernel, which no path launches any more, against its twin all
     the same); the dense detect and margin kernels at the service path's
     (the KITTI pair for all three circle types, NMS on and off, scalar
     thresholds from -inf to 60 and a per-pixel one; the margin kernel
     also on the one image the sweep launches it at; the detect kernel
     also on every level shape of ORB's three scale factors and on BRISK's
     octaves).  The grid and detect kernels skip work where a cheap bound
     proves a pixel's score 0, so their time depends on the image and the
     threshold: each is timed at its path's threshold, with the share of
     pixels the bound lets through, with every pixel a candidate and with
     none.  Each kernel's wrapper is timed by CUDA events (back-to-back
     calls) and its kernel alone by torch.profiler (`device_ms`): the
     margin kernel per circle type, the dense plane kernel at 128, 256 and
     512 bits beside its shared-load floor;
     The match kernel is also held against its twin, and timed, at 16
     words (FREAK's 512 bits) at the swap-set paths' shapes: the stereo
     and inter-frame launches (2304 × 2304) and the tracker's association
     (2304 × 4608, from a short windowed FREAK run);
  3. the VO path: `vo.run_sequence` over 20 synthetic KITTI frames at full
     width with the benchmark configuration (20, not the 40 of the first
     version of this script, so that the whole script keeps its run time
     now that it drives three paths), launch counters reset just before
     and read just after (1 grid, 1 keypoint BRIEF, 2 match launches per
     frame, no dense plane launch),
     trajectory checked against the sequence's known motion, ms/frame;
  4. the first 3 frames again on the CPU (plain twins, same RANSAC seed):
     identical detections, keypoints, stereo and track counts, poses
     within 1e-4;
  4b. the VO descriptor swap set: `vo.run_sequence` at full width over
     `SWAP_FRAMES` frames for each of orb, brisk, freak, surf, surf_ext and
     brief with sub-pixel refinement, launch counters reset before and
     read after each (1 grid launch a frame; 2 match launches a frame for
     the binary descriptors, none for SURF, whose matches run on the L2
     distance matrix; BRIEF's kernel only for brief), the trajectory
     checked as in phase 3, ms/frame (best of 3); then `CPU_FRAMES`
     frames of each on the CPU: detections equal, keypoints equal (within
     `SUBPIX_TOL` px with sub-pixel refinement), binary descriptors with
     at most `BIT_SHARE` of their bits differing, SURF's within
     `SURF_TOL`, counts and poses as stated beside each;
  4c. the essential-matrix egomotion (`motion="essential"`): (a) the
     synthetic pan over `SWAP_FRAMES` frames, launch counters as in phase
     3 (1 grid, 1 keypoint BRIEF, 2 match launches a frame), trajectory
     checked as there, ms/frame (best of 3); (b) the rendered corridor
     (`render.corridor_scene` + `corridor_trajectory_reversal`, rendered
     with the KITTI rig) through the start of its 180° turn, ATE against
     the rendered truth beside the rigid path's on the same frames; (c)
     `CPU_FRAMES` frames of the pan on the CPU with the same draws:
     detections, keypoints, stereo, track and inlier counts equal, poses
     within `ESS_POSE_TOL`; (d) the
     5-point solver (`essential_scaled_motion(solver="five_point")`) on
     2304 correspondences with 30 % outliers and 64 minimal sets, card
     then CPU with the same draws: R within `FIVE_POINT_ANGLE`, inlier
     sets within `FIVE_POINT_SHARE`, ms per call;
  5. the service path: `services.single_image_detection` over all 1208
     IDs of the detector table (FAST 354, ORB 270, BRISK 88, SURF 432,
     AKAZE 64) on frame 0's
     pair, then `get_stereo_features` + `stereo_matching` for a (FAST,
     BRIEF-32) and a (FAST, ORB) ID pair; counters reset before and read
     after (6 margin launches, one detect launch per pyramid level, octave
     and image; SURF and AKAZE none); every record supported, counts
     monotone in the threshold where that is a theorem, everything held
     against the same calls on the CPU (AKAZE exact); ms per swept ID per
     family;
  5b. AKAZE (MLDB and M-SURF) and SIFT `detect_and_describe` on frame 0's
     left image: the card twice identical; card against CPU keypoints
     equal, orientations equal on all but `ANGLE_SHARE`, MLDB bits within
     `BIT_SHARE`, M-SURF and SIFT values within `SURF_TOL` where the
     orientations agree; ms per image;
  6. the windowed path: `window_vo.run_sequence` over 40 frames with
     `WindowVOConfig.create` defaults (1 grid, 1 keypoint BRIEF, 3 match
     launches per frame), BA on every frame once the window is full,
     trajectory
     within 5 % of the true motion, ms/frame; the match kernel held
     against its twin at the tracker's 2304 × 4608 association; first 3
     frames against the CPU; then `WINDOW_SURF_FRAMES` frames with SURF (a
     float landmark store, no match launch), checked the same way;
  7. the command line on disk (`front_end_tpu_torch.cli`, in process),
     on layouts written to a temporary directory: (a) `CLI_FRAMES` frames
     of the VO path's sequence as 8-bit PNG in a KITTI layout (calib.txt
     from the rig, poses/00.txt the pan's known motion), read back equal
     through `KittiSequence` and, where libpng lets it build, the native
     feed (alone and through a `DeviceFeed`), decode ms/image; (b) `vo
     --kitti --record --out`, 1 / 1 / 2 launches a frame, the trajectory
     equal to `vo.run_sequence`'s in memory within the card's run-to-run
     spread (measured here: two in-memory runs), within 5 % of the known
     motion, ATE / RPE, the recording read back, ms/frame; the step's
     ms/frame over frames in memory, behind the feed (threaded, inline) and
     behind the feed over decoded files, and the decode alone,
     interleaved; (c) `--save-state` after half the frames, `--resume` for the
     rest, equal to (b) within that spread, and a windowed checkpoint's
     save and load ms; (d) `vo --window` over `CLI_WINDOW_FRAMES`, 1 / 1 / 3
     a frame; (e) a depth-`FEED_DEPTH` `DeviceFeed` over the frames,
     byte-equal, and the H2D copy of a pinned pair, uint8 against float32;
     (f) a EuRoC layout of `EUROC_FRAMES` rendered frames at 752 × 480,
     cam1 pitched 2°: the rectifier's remap card vs CPU within
     `REMAP_CARD_TOL`, `vo --euroc` with stereo matches beside the raw
     pair's; (g) `detect-sweep` for FAST and ORB, records equal to the
     service's called directly;
  8. the studies and the distributed BA: (a) the estimator study
     (`analysis.sweeps`) on 16 conditions, the 4 methods x `medium` x 250
     landmarks x noise {0, 1} px x outliers {0, 10 %}, a batch of 64
     worlds each, drawn on the host and estimated on the card by one
     vmapped call per method, ms per condition split into drawing and
     estimating, the noise-free medians near 0, `run_study` then skipping
     every file, and PCL and Nister at (1 px, 10 %) again on the CPU with
     the same draws: per-world motions within `STUDY_H_TOL` but for up to
     `NISTER_FORKS` forked Nister worlds; (b)
     `ba-scaling`'s measurement at the JAX command's defaults (32768
     landmarks, W = 3, 8 iterations) at 1 and 2 ranks on the one card
     (gloo, tensors on the card), the 2-rank cost and poses within
     `SHARD_COST_RTOL` / `SHARD_POSE_TOL` of one rank's, the counted
     all-reduces equal to the audit, wall and CPU ms; (c) `vo --window
     --shard-ba 2` over phase 7's KITTI layout: BA from frame 2, positions
     and BA rms within `SHARD_POS_TOL` / `SHARD_RMS_TOL` of phase 7's
     unsharded `--window` run, ms/frame of both; (d) `report` on (a)'s
     study and phase 7's recording (every referenced SVG present and
     parsed, the timing table's configurations, desc+match ms) and
     `explore --family FAST --frames 2`, launch counters reset before and
     read after each (`report`: grid, keypoint BRIEF and match kernels;
     `explore`: the margin kernel), and the match kernel at the report's
     4 words against its twin;
  9. the benchmark: `python -m front_end_tpu_torch.cli bench` at its
     defaults (in process, `cli.main(["bench"])`, launch counters reset
     before and read after): its last line has the JAX benchmark's keys
     and `feed_source`, `vs_baseline` = round(value / 200, 3), the card
     line as its device, both rendered-world ATEs under `ATE_SHARE` of
     the corridor's path, `motion_ok_last` true, the grid, keypoint BRIEF
     and match kernels launched exactly as often as its frames and stage
     calls give (`bench_launches`); then `window_vo_step` at every
     (window length, `ba_every`, BA iterations) of `WINDOW_POINTS`, on
     `WINDOW_KITTI_FRAMES` synthetic KITTI-size frames and the 40-frame
     rendered corridor, inside a telemetry recording: every BA served by
     its CUDA graph (`ba.graph` 1 on each frame `window.ba_ran` counts),
     `ba.accepted` counted once an iteration, the rendered-world ATE under
     `ATE_SHARE` of the path, launches as `window_launches` gives;
  10. a JSON line describing every kernel (`launches_by_path` with `cli`,
     `report`, `explore`, `bench` and `window` entries), the card
     line, and as the last line {"ok": true, "device": {...}}.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 20            # VO path
WINDOW_FRAMES = 40     # windowed path
SWAP_FRAMES = 10       # each descriptor of the swap set
WINDOW_SURF_FRAMES = 10
CPU_FRAMES = 3
POSE_TOL = 1e-4      # card vs CPU: float32 geometry summed in another order
# card vs CPU on the swap set: CUDA's sin/cos/atan2 and reductions round
# otherwise than the CPU's, so a rotated sample can land a hair away and a
# bit near a tie flip (ORB, BRISK, FREAK), and SURF's subregion sums and
# norm differ in the last places
BIT_SHARE = 1e-3
SURF_TOL = 1e-5
SUBPIX_TOL = 1e-3    # px
COUNT_SHARE = 0.01   # stereo / track counts where descriptors differ
SWAP_POSE_TOL = 1e-3  # poses where the match sets differ
SWAP = (("orb", False), ("brisk", False), ("freak", False), ("surf", False),
        ("surf_ext", False), ("brief", True))
# the essential path card vs CPU: on the pan's single plane the 8-point E
# is not determined, so the card's SVDs, which round otherwise than
# LAPACK's, give another E of the same consensus; the LM polish brings the
# poses together
ESS_POSE_TOL = 2e-2
# frames of the rendered corridor's out-and-back walk (120 frames, a
# 48-frame turn from frame 36): the last of the forward leg and the turn
CORRIDOR_FRAMES = slice(30, 50)
# the 5-point solver card vs CPU: each finds its own null-space basis
FIVE_POINT_ANGLE = 2e-3     # rad
FIVE_POINT_SHARE = 0.02
# orientations card vs CPU (AKAZE's window sums, SIFT's atan2 at a bin
# edge): the share of keypoints whose angle may differ
ANGLE_SHARE = 0.005

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor
# float32 ops/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# an addition, subtraction or logic operation is one result per lane and
# clock, half the float32 figure, which counts a fused multiply-add as two
CORE_OPS_S = F32_OPS_S / 2
# a float min, max or compare runs on a pipe half as wide: 64 results per
# clock and SM in NVIDIA's published throughput table, 63.5
# measured on the H100 with a register-only loop of independent fminf
# (`PERF.md` section 6)
MINMAX_OPS_S = CORE_OPS_S / 2
# no 1-bit tensor-core rate is published for the H100; the int8 rate is the
# nearest published one and stands in for it (an assumption)
TENSOR_INT_OPS_S = 1979e12
# gate, key and min operations per pair that the match kernel leaves on the
# CUDA cores, its popcounts being on the tensor cores (an estimate, counted
# from the source)
MATCH_CORE_OPS = 12
OFF_PATH = {"brief_planes"}   # kept, checked and timed; launched by no path
# phase 7, the command line on disk
CLI_FRAMES = 20
CLI_WINDOW_FRAMES = 8
EUROC_FRAMES = 5
EUROC_SIZE = (752, 480)        # EuRoC's cameras, (W, H)
FEED_DEPTH = 2
# the rectifier's remap card vs CPU, grey levels in [0, 255]: CUDA may
# contract the bilinear weights into fused multiply-adds (a few ulp)
REMAP_CARD_TOL = 1e-3
SLEEP_CYCLES_S = 1.98e9   # `torch.cuda._sleep` spins this many clocks a second
# phase 8, the studies and the distributed BA
STUDY_BATCH = 64               # the study's batch of worlds per condition
STUDY_POINTS = 250             # the `medium` curve's landmark count
STUDY_LEVELS = ((0.0, 0.0), (0.0, 0.1), (1.0, 0.0), (1.0, 0.1))
# a study condition (1 px, 10 % outliers) card vs CPU on the same draws,
# the estimated motion of each world: every rotation entry and the
# translation (m) within STUDY_H_TOL (measured on the H100: PCL 1.9e-6,
# Nister 1.5e-5), the consensus counts equal.  Nister's RANSAC may fork
# in up to NISTER_FORKS of the 64 worlds, one in 8 as
# `tests/test_torch_sweeps.py` allows against the JAX package (a score a
# row apart elects another hypothesis; measured: 2 worlds, 7.1e-3 m),
# each within NISTER_ROWS rows of consensus
STUDY_H_TOL = 1e-4
NISTER_FORKS, NISTER_ROWS = 8, 3
# the sharded BA against one rank (`tests/test_ba.py`'s bounds)
SHARD_COST_RTOL, SHARD_POSE_TOL = 1e-3, 1e-4
# the sharded windowed run against the unsharded one
# (`tests/test_sharded_window.py`'s bounds)
SHARD_POS_TOL, SHARD_RMS_TOL = 2e-3, 5e-2
SHARD_RANKS = 2
# phase 9, the benchmark: the keys of the JAX benchmark's line (`bench.py`)
# and the port's `feed_source`
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "detail",
    *(f"detail.{k}" for k in (
        "resolution", "keypoint_capacity", "n_frames", "ms_per_frame",
        "device", "n_inliers_last", "motion_ok_last", "fps_feed_inclusive",
        "feed_source", "h2d_link_mb_per_s", "h2d_pipelined_mb_per_s",
        "stage_ms", "roofline", "fps_subpix_on", "fps_brief16",
        "fps_device_scan", "fps_windowed", "windowed_ba_ran_last",
        "windowed_n_tracked_last", "ate_rendered_world_m",
        "ate_rendered_world_windowed_m")),
    *(f"detail.stage_ms.{k}" for k in (
        "harness_floor", "detect_pair", "describe_match_triangulate",
        "extract_total", "motion_ransac_lm", "tracker_ba_overhead",
        "note"))}
ATE_SHARE = 0.03          # of the rendered corridor's path, both packages'
# (window length, ba_every, BA iterations) of phase 9's window sweep: the
# (ba_every, iters) grid at W = 3, then W = 4, 6, 8 at the benchmark's
# operating point; each point captures its own BA graphs
WINDOW_POINTS = ((3, 1, 2), (3, 1, 4), (3, 2, 2), (3, 2, 4), (3, 4, 2),
                 (3, 4, 4), (4, 2, 2), (6, 2, 2), (8, 2, 2))
WINDOW_KITTI_FRAMES = 12  # synthetic KITTI-size frames a point


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Device milliseconds per call of `fn`.  A wrapper's host work (Python,
    ctypes, allocation) can take longer than its kernel, and then events
    around a loop time the host.  So a sleep kernel holds the stream while
    the host enqueues all the calls, for longer than the warm-up says the
    enqueue takes, and the calls then run back to back on the card."""
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t0) / warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SLEEP_CYCLES_S))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(torch, fn, kernel: str, reps: int = 50):
    """Device milliseconds per call of `fn` spent in the kernels whose name
    holds `kernel`, by torch.profiler: the kernel alone, without the
    wrapper's host work, launch gaps or other kernels.  None where the
    profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += (getattr(ev, "self_device_time_total", 0)
                   or getattr(ev, "self_cuda_time_total", 0))
    return us / reps / 1e3 if us > 0 else None


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


def ints(torch, x):
    """uint32 tensors compared through an int32 view (PyTorch has few
    uint32 kernels on CUDA)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def same(torch, a, b) -> bool:
    return torch.equal(ints(torch, a), ints(torch, b))


def max_abs_err(torch, got, ref) -> float:
    err = 0.0
    for g, r in zip(got, ref):
        g, r = ints(torch, g), ints(torch, r)
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(r.shape)} {r.dtype}")
        diff = (g.to(torch.float64) - r.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def arc_ops(n: int, K: int) -> int:
    """min/max operations of `fast_segment.cuh::arc_extreme` for one
    brightness class, counted along its recursion: the n / 2 pair extremes;
    per group of M starts its core (a span of K - M + 1 ring values, one
    operation per pair after the first), its combine, and the halving
    network below it; the max over the groups."""
    m = 1
    while 2 * m <= K and n % (2 * m) == 0:
        m *= 2

    def span(length):
        return length // 2 - 1

    def group(M):
        if M == 2:
            return 1
        return 2 * span(M // 2) + 3 + 2 * group(M // 2)

    return n // 2 + n // m * (span(K - m + 1) + 1 + group(m)) + n // m - 1


def segment_ops_per_pixel(n: int, K: int) -> tuple[int, int]:
    """(min/max/compare, add/subtract) operations of the full FAST segment
    test per pixel, on the ring's pixel values: per brightness class the
    arc network (`arc_ops`) and one subtraction; the score max; for 12/8-
    point circles the quick gates (8 + 7 per class, a subtraction each) and
    3 combines."""
    minmax = 2 * arc_ops(n, K) + 1
    return (minmax, 2) if n == 16 else (minmax + 2 * 15 + 3, 4)


def detect_ops_per_pixel(n: int, K: int, nms: bool) -> tuple[int, int]:
    """The segment test, the threshold compare and select, and with NMS
    the 8-neighbour max, compare and select."""
    minmax, adds = segment_ops_per_pixel(n, K)
    return minmax + 2 + (10 if nms else 0), adds


def fast_ops_per_pixel(n: int, K: int) -> tuple[int, int]:
    """The grid kernel: detect with NMS, then pool and count (~4)."""
    minmax, adds = detect_ops_per_pixel(n, K, True)
    return minmax + 4, adds


def fast_ops_seconds(per_pixel: tuple[int, int], pixels: int) -> float:
    """The least time for that many segment tests: the min/max pipe, or
    the dispatch of all the operations, whichever takes longer."""
    minmax, adds = per_pixel
    return pixels * max(minmax / MINMAX_OPS_S, (minmax + adds) / CORE_OPS_S)


def match_work(nq: int, nt: int, nw: int):
    """(bytes, operations, (bytes s, operations s)) of one match launch of
    nq queries against nt trains, nw words each: every input read once,
    every output written once.  The popcounts run on the tensor cores (an
    AND and a count per bit) and the CUDA cores keep the gate, key and min
    operations; the two pipes issue side by side, so the operations take
    the longer of the two."""
    pairs = nq * nt
    by = (nq + nt) * (nw * 4 + 8 + 1) + nq * 12 + nt * 8
    ops = pairs * (2 * 32 * nw + MATCH_CORE_OPS)
    return by, ops, (by / HBM_BYTES_S, max(
        pairs * 2 * 32 * nw / TENSOR_INT_OPS_S,
        pairs * MATCH_CORE_OPS / CORE_OPS_S))


def ate_rmse(poses, gt) -> float:
    """Absolute trajectory error (m) of (T, 4, 4) world_T_camera poses
    that start at the identity against the truth `gt`, taken relative to
    its first pose, after the rigid alignment that minimises it."""
    g = (np.linalg.inv(gt[0]) @ gt)[:, :3, 3]
    e = np.asarray(poses, np.float64)[:, :3, 3]
    me, mg = e.mean(0), g.mean(0)
    U, _, Vt = np.linalg.svd((g - mg).T @ (e - me))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    aligned = (e - me) @ (U @ D @ Vt).T + mg
    return float(np.sqrt((np.linalg.norm(aligned - g, axis=1) ** 2).mean()))


def features_close(a, b, tol):
    return (abs(a["X"][0] - b["X"][0]) <= tol
            and abs(a["X"][1] - b["X"][1]) <= tol
            and abs(a["Y"][0] - b["Y"][0]) <= tol
            and abs(a["Y"][1] - b["Y"][1]) <= tol)


def write_kitti(root: Path, lefts, rights, rig, poses) -> None:
    """A KITTI odometry layout: sequences/00/image_{0,1} as 8-bit PNG
    (the port's encoder), calib.txt from `rig`, poses/00.txt."""
    from front_end_tpu_torch.utils import png
    sd = root / "sequences" / "00"
    for cam, imgs in (("image_0", lefts), ("image_1", rights)):
        (sd / cam).mkdir(parents=True)
        for i, im in enumerate(imgs):
            png.write(sd / cam / f"{i:06d}.png", im)
    fx, cx, cy, b = rig.fx, rig.cx, rig.cy, rig.baseline
    (sd / "calib.txt").write_text(
        f"P0: {fx!r} 0 {cx!r} 0 0 {fx!r} {cy!r} 0 0 0 1 0\n"
        f"P1: {fx!r} 0 {cx!r} {-fx * b!r} 0 {fx!r} {cy!r} 0 0 0 1 0\n")
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt",
               poses[:, :3, :].reshape(len(poses), 12))


def write_euroc(root: Path, n: int):
    """An ASL layout at EuRoC's size whose cam1 is pitched 2° in its
    sensor.yaml T_BS (and rendered so), so the pair is usable only once
    rectified (`tests/test_euroc_format.py`'s fixture at full size).
    Returns the rig the frames were rendered with."""
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.sim import render
    from front_end_tpu_torch.utils import png
    W, H = EUROC_SIZE
    rig = StereoRig.create(fx=458.654, cx=(W - 1) / 2, cy=(H - 1) / 2,
                           baseline=0.11, width=W, height=H)
    scene = render.corridor_scene(np.random.RandomState(13), tex_size=256)
    gt = render.corridor_trajectory(n)
    a = np.deg2rad(2.0)
    T1 = np.eye(4)
    T1[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]]
    T1[0, 3] = rig.baseline
    mav = root / "S" / "mav0"
    for cam, T in (("cam0", np.eye(4)), ("cam1", T1)):
        (mav / cam / "data").mkdir(parents=True)
        rows = ", ".join(repr(float(x)) for x in T.ravel())
        (mav / cam / "sensor.yaml").write_text(
            f"sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n"
            f"  data: [{rows}]\nresolution: [{W}, {H}]\n"
            f"intrinsics: [{rig.fx!r}, {rig.fy!r}, {rig.cx!r}, {rig.cy!r}]\n"
            "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")
        for i in range(n):
            img = render.render_view(scene, rig, gt[i] @ T)
            png.write(mav / cam / "data" / f"{1403636579763555584 + i:d}.png",
                      img.astype(np.uint8))
    return rig


def run_cli(torch, argv, reset_counts, read_counts):
    """`cli.main(argv)` on the card, launch counters reset just before and
    read just after; -> (stdout, counts)."""
    import contextlib
    import io

    from front_end_tpu_torch import cli
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return out.getvalue(), read_counts()


def cli_phase(torch, dev, card, lefts, rights, rig, cfg, poses_mem,
              ms_frame, reset_counts, read_counts, tmp: Path):
    """Phase 7: the command line on a KITTI and a EuRoC layout written
    under `tmp`.  Returns the launches of all its CLI runs, and what phase
    8 reads: the KITTI root, the `--window` run's trajectory, recording and
    ms/frame, and the recording of the `vo` run."""
    from front_end_tpu_torch import native, services
    from front_end_tpu_torch.eval import metrics
    from front_end_tpu_torch.io import euroc, kitti, native_feed
    from front_end_tpu_torch.io.feed import DeviceFeed
    from front_end_tpu_torch.pipeline import telemetry, vo, window_vo
    from front_end_tpu_torch.sim.sequence import make_sequence
    from front_end_tpu_torch.utils import checkpoint, png

    n = CLI_FRAMES
    L8 = np.asarray(lefts[:n], np.uint8)
    R8 = np.asarray(rights[:n], np.uint8)
    check(np.array_equal(L8, lefts[:n]) and np.array_equal(R8, rights[:n]),
          "the synthetic frames are not 8-bit integers")
    step_m = 3 * rig.baseline / 12
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = step_m * np.arange(n)
    total = {}

    def run_counted(argv, expect=None):
        text, counts = run_cli(torch, argv, reset_counts, read_counts)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if expect is not None:
            check(counts == expect, f"cli {' '.join(argv[:2])}: launches "
                  f"{counts}, want {expect}")
        return text, counts

    def launches(grid_, brief, match):
        return {"fast_grid": grid_, "brief_planes": 0,
                "brief_keypoints": brief, "match_reduce": match,
                "fast_detect": 0, "fast_margins": 0}

    # (a) the KITTI layout, read back
    root = tmp / "kitti"
    write_kitti(root, L8, R8, rig, gt)
    seq = kitti.KittiSequence(str(root), "00")
    check(seq.rig == rig, f"calib.txt read back as {seq.rig}")
    for i in range(n):
        a, b = seq[i]
        check(np.array_equal(a, L8[i]) and np.array_equal(b, R8[i]),
              f"KITTI frame {i} read back differs")
    lp, rp = seq.paths()
    t0 = time.perf_counter()
    for p in lp + rp:
        kitti._read_image(p)
    read_ms = (time.perf_counter() - t0) / (2 * n) * 1e3
    t0 = time.perf_counter()
    for p in lp + rp:
        png.read(p)
    zlib_ms = (time.perf_counter() - t0) / (2 * n) * 1e3
    import importlib.util
    reader = ("PIL" if importlib.util.find_spec("PIL") else
              "the port's zlib decoder")
    print(f"CLI phase: KITTI layout of {n} frames read back equal; "
          f"decode {read_ms:.3f} ms/image ({reader}), {zlib_ms:.3f} "
          f"ms/image (the port's zlib decoder) [{card}]", flush=True)
    try:        # builds and loads csrc/feed.cc, which needs libpng
        native_feed.NativeStereoFeed(lp[:1], rp[:1], rig.height,
                                     rig.width).close()
        have_native = True
    except (native.NativeBuildError, OSError) as e:
        check("png" in str(e), f"native feed build or load failed: {e}")
        have_native = False
        first = next((ln for ln in str(e).splitlines() if "png" in ln),
                     "")
        print(f"native feed: left out, libpng is not on this machine "
              f"({first.strip()})", flush=True)
    if have_native:
        t0 = time.perf_counter()
        with native_feed.NativeStereoFeed(lp, rp, rig.height, rig.width,
                                          ring=4, threads=4) as feed:
            got = list(feed)
        native_ms = (time.perf_counter() - t0) / n * 1e3
        check(len(got) == n and all(
            np.array_equal(a, L8[i]) and np.array_equal(b, R8[i])
            for i, (a, b) in enumerate(got)),
            "NativeStereoFeed frames differ from the source")
        with native_feed.NativeStereoFeed(lp, rp, rig.height, rig.width,
                                          ring=2, threads=4) as feed:
            got = list(DeviceFeed(feed.frames_zero_copy(),
                                  depth=FEED_DEPTH, device=dev))
        torch.cuda.synchronize()
        check(all(torch.equal(a.cpu(), torch.from_numpy(L8[i]))
                  and torch.equal(b.cpu(), torch.from_numpy(R8[i]))
                  for i, (a, b) in enumerate(got)),
              "NativeStereoFeed -> DeviceFeed frames differ")
        print(f"native feed: {n} pairs equal, {native_ms:.3f} ms/pair "
              f"(4 decoder threads), and through a depth-"
              f"{FEED_DEPTH} DeviceFeed onto the card equal [{card}]",
              flush=True)

    # the card's run-to-run spread on the in-memory path
    s = vo.init_state(rig, cfg, seed=0, device=dev)
    _, o = vo.run_sequence(s, torch.as_tensor(L8).to(dev),
                           torch.as_tensor(R8).to(dev), rig, cfg)
    mem = poses_mem.double().numpy()
    spread = float(np.abs(o.pose.cpu().double().numpy() - mem).max())
    print(f"card run to run: in-memory trajectories differ by at most "
          f"{spread:.3e}", flush=True)

    # (b) `cli vo --kitti` with a recording
    rec, traj = str(tmp / "rec"), str(tmp / "traj.txt")
    text, _ = run_counted(["vo", "--kitti", str(root), "--frames", str(n),
                           "--record", rec, "--out", traj],
                          launches(n, n, 2 * n))
    est = np.loadtxt(traj)
    check(est.shape == (n, 12), f"--out holds {est.shape}")
    diff = float(np.abs(est - mem[:, :3, :].reshape(n, 12)).max())
    check(diff <= spread, f"cli trajectory differs from run_sequence's "
          f"by {diff} (run-to-run spread {spread})")
    drift = float(np.linalg.norm(est[-1, [3, 7, 11]] - gt[-1, :3, 3]))
    check(drift < 0.05 * gt[-1, 0, 3], f"cli final position "
          f"{est[-1, [3, 7, 11]]} vs {gt[-1, :3, 3]}")
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :] = est.reshape(n, 3, 4)
    ate = metrics.ate_rmse(P[:, :3, 3], gt[:, :3, 3])
    rpe = metrics.rpe(P, gt)
    check("ATE RMSE" in text, "cli vo printed no ATE")
    stages, counters, meta = telemetry.load_log(rec)
    check(stages["frame"].shape == (n,) and set(counters) == {
        "n_detect_l", "n_stereo", "n_tracks", "n_inliers", "lm.accepted",
        "lm.graph"}, f"recording {list(stages)} {list(counters)}")
    check(meta["platform"] == torch.cuda.get_device_name(dev),
          f"recorded platform {meta['platform']}")
    rec_ms = float(np.median(stages["frame"])) * 1e3
    t0 = time.perf_counter()
    run_counted(["vo", "--kitti", str(root), "--frames", str(n)],
                launches(n, n, 2 * n))
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    # where the command line's time goes: the step over frames in
    # memory (float32, as phase 3), behind the feed (its thread, or
    # inline), over frames decoded from the files behind the feed, and
    # the decode alone; interleaved, median of 3 runs each
    Lf = torch.as_tensor(lefts[:n]).to(dev)
    Rf = torch.as_tensor(rights[:n]).to(dev)
    sources = {
        "in memory": lambda: zip(Lf, Rf),
        "feed": lambda: DeviceFeed(zip(L8, R8), device=dev),
        "feed inline": lambda: DeviceFeed(zip(L8, R8), device=dev,
                                          threaded=False),
        "decode + feed": lambda: DeviceFeed(seq.frames(), device=dev),
        "decode + feed inline": lambda: DeviceFeed(
            seq.frames(), device=dev, threaded=False),
        "decode alone": None}
    runs = {k: [] for k in sources}
    for _ in range(3):
        for k, frames in sources.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if frames is None:
                for _ in seq.frames():
                    pass
            else:
                s = vo.init_state(rig, cfg, seed=0, device=dev)
                for a, b in frames():
                    s, _ = vo.vo_step(s, a, b, rig, cfg)
            torch.cuda.synchronize()
            runs[k].append((time.perf_counter() - t0) / n * 1e3)
    print("ms/frame, interleaved, median of 3: " + ", ".join(
        f"{k} {np.median(v):.3f} {[round(x, 3) for x in v]}"
        for k, v in runs.items()) + f" [{card}]", flush=True)
    print(f"cli vo --kitti: {n} frames, launches 1 / 1 / 2 a frame, "
          f"trajectory equal to run_sequence's (max diff {diff:.3e}), "
          f"drift {drift:.4f} m, ATE {ate:.6f} m, RPE "
          f"{rpe['trans_rmse_m']:.6f} m / {rpe['rot_rmse_deg']:.6f} deg;"
          f" recorded frame median {rec_ms:.3f} ms, cli wall "
          f"{wall_ms:.3f} ms/frame (decode, feed and step), in-memory "
          f"vo_step {ms_frame:.3f} (phase 3) [{card}]", flush=True)

    # (c) --save-state after half, --resume for the rest
    ck, traj_c = str(tmp / "ck"), str(tmp / "traj_c.txt")
    half = n // 2
    run_counted(["vo", "--kitti", str(root), "--frames", str(half),
                 "--save-state", ck], launches(half, half, 2 * half))
    run_counted(["vo", "--kitti", str(root), "--frames", str(n),
                 "--resume", ck, "--out", traj_c],
                launches(n - half, n - half, 2 * (n - half)))
    rdiff = float(np.abs(np.loadtxt(traj_c) - est).max())
    check(rdiff <= spread, f"resumed trajectory differs by {rdiff} "
          f"(run-to-run spread {spread})")
    wcfg = window_vo.WindowVOConfig.create(cfg)
    ws, _ = window_vo.run_sequence(
        window_vo.init_state(rig, wcfg, seed=0, device=dev),
        torch.as_tensor(L8[:3]).to(dev), torch.as_tensor(R8[:3]).to(dev),
        rig, wcfg)
    wpath = str(tmp / "win.npz")
    save_ms, load_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_state(wpath, ws)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        tmpl = window_vo.init_state(rig, wcfg, seed=9, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = checkpoint.load_state(wpath, tmpl)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    check(same(torch, back.win.store.packed, ws.win.store.packed)
          and torch.equal(back.win.store.bits, ws.win.store.bits)
          and torch.equal(back.vo.generator.get_state(),
                          ws.vo.generator.get_state()),
          "windowed checkpoint round trip on the card")
    mb = Path(wpath).stat().st_size / 1e6
    print(f"cli resume: {half} + {n - half} frames, trajectory equal to "
          f"the uninterrupted run's (max diff {rdiff:.3e}); windowed "
          f"checkpoint ({mb:.1f} MB) save {min(save_ms):.3f} ms, load "
          f"{min(load_ms):.3f} ms (best of 3) [{card}]", flush=True)

    # (d) --window
    nw = CLI_WINDOW_FRAMES
    traj_w, rec_w = str(tmp / "traj_w.txt"), str(tmp / "rec_w")
    run_counted(["vo", "--kitti", str(root), "--frames", str(nw),
                 "--window", "--out", traj_w, "--record", rec_w],
                launches(nw, nw, 3 * nw))
    ew = np.loadtxt(traj_w)
    wdrift = float(np.linalg.norm(ew[-1, [3, 7, 11]] - gt[nw - 1, :3, 3]))
    check(np.isfinite(ew).all() and wdrift < 0.05 * gt[nw - 1, 0, 3],
          f"cli --window final position {ew[-1, [3, 7, 11]]}")
    print(f"cli vo --window: {nw} frames, launches 1 / 1 / 3 a frame, "
          f"drift {wdrift:.4f} m", flush=True)

    # (e) the pinned ring, smaller than the sequence
    got = list(DeviceFeed(zip(L8, R8), depth=FEED_DEPTH, device=dev))
    torch.cuda.synchronize()
    check(len(got) == n and all(
        l.dtype == torch.uint8 and torch.equal(l.cpu(),
                                               torch.from_numpy(L8[i]))
        and torch.equal(r.cpu(), torch.from_numpy(R8[i]))
        for i, (l, r) in enumerate(got)),
        f"DeviceFeed (depth {FEED_DEPTH}) frames differ from the source")
    h2d = {}
    for dt in (np.uint8, np.float32):
        pairs = [tuple(torch.from_numpy(a.astype(dt)).pin_memory()
                       for a in (L8[i], R8[i])) for i in range(n)]
        it = iter(range(10 ** 9))
        h2d[dt.__name__] = cuda_ms(torch, lambda: [
            t.to(dev, non_blocking=True)
            for t in pairs[next(it) % n]], 40) * 1e3
    mb8 = 2 * L8[0].nbytes / 1e6
    print(f"DeviceFeed: {n} pairs through a depth-{FEED_DEPTH} pinned "
          f"ring, byte-equal; H2D per pair {h2d['uint8']:.3f} us uint8 "
          f"({mb8:.2f} MB, {mb8 / h2d['uint8'] * 1e3:.1f} GB/s), "
          f"{h2d['float32']:.3f} us float32 ({4 * mb8:.2f} MB, "
          f"{4 * mb8 / h2d['float32'] * 1e3:.1f} GB/s) [{card}]",
          flush=True)

    # (f) EuRoC: rectified on the card
    t0 = time.perf_counter()
    erig = write_euroc(tmp / "euroc", EUROC_FRAMES)
    render_s = time.perf_counter() - t0
    seq_dir = str(tmp / "euroc" / "S")
    rc_card = euroc.build_rectifier(seq_dir, device=dev)
    rc_cpu = euroc.build_rectifier(seq_dir, device="cpu")
    check(rc_card.rig() == erig, f"rectified rig {rc_card.rig()}")
    raw = euroc.EurocSequence(str(tmp / "euroc"), "S", rectify=False)
    rerr = 0.0
    for i in range(EUROC_FRAMES):
        l, r = raw[i]
        for g, c in zip(rc_card(l, r), rc_cpu(l, r)):
            rerr = max(rerr, float((g.cpu() - c).abs().max()))
    check(rerr <= REMAP_CARD_TOL, f"remap card vs CPU differs by {rerr}")
    l, r = (torch.as_tensor(a).to(dev) for a in raw[0])
    remap_ms = cuda_ms(torch, lambda: rc_card(l, r), 20)
    erec = str(tmp / "erec")
    run_counted(["vo", "--euroc", str(tmp / "euroc"), "--seq", "S",
                 "--record", erec],
                launches(EUROC_FRAMES, EUROC_FRAMES, 2 * EUROC_FRAMES))
    ecount = telemetry.load_log(erec)[1]["n_stereo"]
    rrig = euroc.load_rig(seq_dir)
    st = vo.init_state(rrig, cfg, device=dev)
    raw_count = []
    for i in range(EUROC_FRAMES):
        st, o = vo.vo_step(st, *raw[i], rrig, cfg)
        raw_count.append(int(o.n_stereo))
    check(ecount.min() > 50 and ecount.min() > 1.5 * max(raw_count),
          f"EuRoC stereo matches rectified {ecount.tolist()}, raw "
          f"{raw_count}")
    print(f"cli vo --euroc: {EUROC_FRAMES} frames at {EUROC_SIZE[1]}x"
          f"{EUROC_SIZE[0]} (rendered in {render_s:.1f} s), remap card "
          f"vs CPU max diff {rerr:.3e} (tolerance {REMAP_CARD_TOL}), "
          f"{remap_ms * 1e3:.3f} us a pair on the card (both maps, "
          f"uint8 frames already there); stereo "
          f"matches rectified {ecount.astype(int).tolist()} against "
          f"{raw_count} on the raw pair [{card}]", flush=True)

    # (g) detect-sweep against the service called directly
    L1, R1 = make_sequence(1)
    for family, k, kernel in (("FAST", 10, "fast_margins"),
                              ("ORB", 4, "fast_detect")):
        text, counts = run_counted(["detect-sweep", "--family", family,
                                    "--n", str(k)])
        check(counts[kernel] > 0, f"detect-sweep {family}: {counts}")
        from front_end_tpu_torch import features
        ids = [i for i, v in features.detector_table().items()
               if v["Name"] == family][:k]
        want = [f"{r['detID']}: L={r['leftFeatures']['nPoints']} "
                f"R={r['rightFeatures']['nPoints']}" for r in
                services.single_image_detection(ids, L1[0], R1[0])]
        got = [ln.rsplit(" t=", 1)[0] for ln in text.splitlines()]
        check(got == want, f"detect-sweep {family}: {got} vs {want}")
        print(f"cli detect-sweep --family {family} --n {k}: records "
              f"equal to the service's, launches {counts}", flush=True)
    return total, {"root": str(root), "traj_w": traj_w, "rec_w": rec_w,
                   "rec": rec}


def scaling_rank(rank, group, dev, args, out):
    """A rank of phase 8(b): `ba-scaling`'s measurement at 1 and 2 ranks,
    then one counted solve over both; rank 0 saves what the parent
    checks."""
    import torch
    import torch.distributed as dist

    from front_end_tpu_torch import cli
    from front_end_tpu_torch.ba import distributed

    results, wall, cpu = cli._ba_scaling_rank(rank, group, dev, args, True,
                                              1)
    rig, T0, *blocks = (a.to(dev) if isinstance(a, torch.Tensor) else a
                        for a in cli._ba_scaling_problem(args, group.size()))
    distributed.reset_counts()
    res = distributed.ba_solve_sharded(
        group, T0, *(distributed.local_block(a, rank, group.size())
                     for a in blocks), rig, iters=args.iters)
    torch.cuda.synchronize()
    counts = (distributed.all_reduces, distributed.all_gathers)
    on_card = all(t.is_cuda for t in (res.poses, res.landmarks, T0,
                                      *blocks))
    if rank == 0:
        np.savez(out, poses1=results[1].poses.cpu().numpy(),
                 cost1=results[1].cost.cpu().numpy(),
                 poses2=results[2].poses.cpu().numpy(),
                 cost2=results[2].cost.cpu().numpy(),
                 poses=res.poses.cpu().numpy(), cost=res.cost.cpu().numpy(),
                 rms=res.rms_px.cpu().numpy(), counts=np.array(counts),
                 wall=np.array([wall[1], wall[2]]),
                 cpu=np.array([cpu[1], cpu[2]]), on_card=on_card,
                 device=str(dev), backend=dist.get_backend(group))


def studies_phase(torch, dev, card, tmp: Path, ctx: dict, reset_counts,
                  read_counts) -> tuple[dict, dict]:
    """Phase 8: (a) the estimator study, (b) `ba-scaling` at 1 and 2 ranks,
    (c) `vo --window --shard-ba 2`, (d) `report` and `explore`.  Returns
    the launches of `report` and of `explore`, and the match kernel at 4
    words (the report's BRIEF_16) against its twin."""
    import argparse
    import xml.etree.ElementTree as ET

    from front_end_tpu_torch.analysis import report, sweeps
    from front_end_tpu_torch.ba import distributed
    from front_end_tpu_torch.geometry.camera import bumblebee_rig
    from front_end_tpu_torch.ops import grid
    from front_end_tpu_torch.ops.kernels import match_reduce
    from front_end_tpu_torch.pipeline import telemetry
    from front_end_tpu_torch.sim import synthetic as sim
    from front_end_tpu_torch.sim.sequence import make_sequence

    # (a) the study: 4 methods x medium x 250 landmarks x 2 noise x 2
    # outlier levels, a batch of 64 worlds a condition, drawn on the host,
    # estimated on the card by one vmapped call per method
    srig, cat = bumblebee_rig(), sim.motion_category("medium")
    study = tmp / "study"
    study.mkdir()
    cpu_draws, card_res = {}, {}
    for method in sweeps.EXTRACTORS:
        draw_ms, est_ms = [], []
        for noise, frac in STUDY_LEVELS:
            name = sweeps.condition_name(method, "medium", STUDY_POINTS,
                                         noise, frac)
            gen = torch.Generator().manual_seed(sweeps.condition_seed(0,
                                                                      name))
            t0 = time.perf_counter()
            if method == "WindowBA":
                draws = (sweeps.draw_window_condition(
                    gen, srig, cat, STUDY_POINTS, noise, frac, STUDY_BATCH),)

                def est(ww):
                    return sweeps.estimate_window_condition(ww, srig)
            else:
                draws = sweeps.draw_condition(gen, method, srig, cat,
                                              STUDY_POINTS, noise, frac,
                                              STUDY_BATCH)

                def est(w, s, method=method):
                    return sweeps.estimate_condition(method, w, s, srig)
            t1 = time.perf_counter()
            on = [None if d is None else type(d)(*(f.to(dev) for f in d))
                  if isinstance(d, tuple) else d.to(dev) for d in draws]
            reps = 2 if not est_ms else 1        # the first call warms up
            for _ in range(reps):
                t2 = time.perf_counter()
                res = est(*on)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
            res = {k: v.cpu().numpy() for k, v in res.items()}
            check(all(v.shape == (STUDY_BATCH,) and np.isfinite(v).all()
                      for v in res.values()), f"study {name}: {res}")
            if noise == 0 and frac == 0:
                check(np.median(res["rot_err_deg"]) < 0.1
                      and np.median(res["trans_err_m"]) < 1e-3,
                      f"study {name}: median errors "
                      f"{np.median(res['rot_err_deg'])} deg, "
                      f"{np.median(res['trans_err_m'])} m without noise")
            np.savez(study / name, **res)
            draw_ms.append((t1 - t0) * 1e3)
            est_ms.append((t3 - t2) * 1e3)
            cpu_draws[(method, noise, frac)] = draws
            card_res[(method, noise, frac)] = res
        meds = [f"{np.median(card_res[(method, n_, f_)]['rot_err_deg']):.4f}"
                for n_, f_ in STUDY_LEVELS]
        print(f"study {method}: {STUDY_BATCH} worlds x {STUDY_POINTS} "
              f"landmarks a condition; draw (host) "
              f"{', '.join(f'{v:.1f}' for v in draw_ms)} ms, estimate "
              f"(card, one vmapped call) "
              f"{', '.join(f'{v:.1f}' for v in est_ms)} ms per condition "
              f"(levels {STUDY_LEVELS}); median rotation errors {meds} deg "
              f"[{card}]", flush=True)
    stats = sweeps.run_study(str(study), methods=sweeps.EXTRACTORS,
                             speeds=("medium",), curves=(STUDY_POINTS,),
                             noises=(0.0, 1.0), outliers=(0.0, 0.1),
                             batch=STUDY_BATCH, verbose=False, device=dev)
    check(stats == {"ran": 0, "skipped": 16}, f"study resume: {stats}")
    for method in ("PCL", "Nister"):
        worlds, sets = cpu_draws[(method, 1.0, 0.1)]
        H_cpu, n_cpu = (v.numpy() for v in sweeps.estimate_motion(
            method, worlds, sets, srig))
        H, n_card = (v.cpu().numpy() for v in sweeps.estimate_motion(
            method, type(worlds)(*(f.to(dev) for f in worlds)), sets.to(dev),
            srig))
        d_rot = np.abs(H[:, :3, :3] - H_cpu[:, :3, :3]).max((1, 2))
        d_tr = np.linalg.norm(H[:, :3, 3] - H_cpu[:, :3, 3], axis=1)
        d_inl = np.abs(n_card - n_cpu)
        forked = (d_rot > STUDY_H_TOL) | (d_tr > STUDY_H_TOL)
        held = ~forked
        check(forked.sum() <= (NISTER_FORKS if method == "Nister" else 0)
              and d_inl[held].max(initial=0) == 0
              and d_inl.max() <= NISTER_ROWS,
              f"study {method} (1 px, 10 %) card vs CPU: {forked.sum()} "
              f"worlds past {STUDY_H_TOL}, the rest within rotation "
              f"{d_rot[held].max(initial=0)}, translation "
              f"{d_tr[held].max(initial=0)} m; consensus {d_inl.max()} "
              f"rows apart")
        print(f"study {method} (1 px, 10 % outliers) card vs CPU on the "
              f"same draws, the estimated motion of each of the "
              f"{STUDY_BATCH} worlds: {held.sum()} within rotation entries "
              f"{d_rot[held].max(initial=0):.3e} and translation "
              f"{d_tr[held].max(initial=0):.3e} m, {forked.sum()} forked "
              f"(translation up to {d_tr.max():.3e} m); consensus counts "
              f"{d_inl.max()} rows apart", flush=True)

    # (b) ba-scaling at the JAX command's defaults, 1 and 2 ranks, one card
    args = argparse.Namespace(landmarks=32768, window=3, iters=8, repeats=3,
                              noise_px=0.5, seed=0)
    out = str(tmp / "scaling.npz")
    place = distributed.placement(SHARD_RANKS, dev)
    t0 = time.perf_counter()
    distributed.launch(scaling_rank, SHARD_RANKS, (args, out),
                       init_method=f"file://{tmp}/store_scaling",
                       device=dev, timeout=300)
    spawn_s = time.perf_counter() - t0
    z = np.load(out)
    check(bool(z["on_card"]) and str(z["device"]).startswith("cuda")
          and str(z["backend"]) == place.backend,
          f"ba-scaling ranks on {z['device']} with {z['backend']}")
    want = distributed.comm_audit(args.window, args.iters)[
        "psums_per_solve"] + 2
    check(tuple(z["counts"]) == (want, 0),
          f"ba-scaling collectives {tuple(z['counts'])}, audit {want}")
    dc = abs(float(z["cost2"]) / float(z["cost1"]) - 1.0)
    dp = float(np.abs(z["poses2"] - z["poses1"]).max())
    check(dc <= SHARD_COST_RTOL and dp <= SHARD_POSE_TOL
          and np.allclose(z["poses"], z["poses2"], atol=SHARD_POSE_TOL),
          f"sharded BA vs one rank: cost {dc} relative, poses {dp}")
    print(f"ba-scaling (32768 landmarks, W = 3, 8 iterations, best of 3; "
          f"{SHARD_RANKS} ranks: {distributed.describe(place)}): wall "
          f"{z['wall'][0] * 1e3:.3f} ms at 1 rank, {z['wall'][1] * 1e3:.3f} "
          f"at 2; CPU {z['cpu'][0] * 1e3:.3f} / {z['cpu'][1] * 1e3:.3f} ms; "
          f"2 ranks vs 1: cost {dc:.2e} relative, poses {dp:.2e}; "
          f"{want} all-reduces a solve = the audit; rms "
          f"{float(z['rms']):.3f} px; spawn to exit {spawn_s:.1f} s "
          f"[{card}]", flush=True)

    # (c) vo --window --shard-ba 2 over phase 7's KITTI layout
    nw = CLI_WINDOW_FRAMES
    traj_s, rec_s = str(tmp / "traj_s.txt"), str(tmp / "rec_s")
    text, _ = run_cli(torch, ["vo", "--kitti", ctx["root"], "--frames",
                              str(nw), "--window", "--shard-ba",
                              str(SHARD_RANKS), "--out", traj_s,
                              "--record", rec_s], reset_counts, read_counts)
    check(f"sharded over {SHARD_RANKS} rank(s)" in text
          and place.backend in text, f"vo --shard-ba said {text!r}")
    a, b = np.loadtxt(ctx["traj_w"]), np.loadtxt(traj_s)
    check(b.shape == (nw, 12), f"vo --shard-ba wrote {b.shape}")
    dpos = float(np.abs(a[:, 3::4] - b[:, 3::4]).max())
    st_w, c_w, _ = telemetry.load_log(ctx["rec_w"])
    st_s, c_s, _ = telemetry.load_log(rec_s)
    ran = c_s["ba_rms_px"] > 0
    check(ran[2:].all() and not ran[:2].any(), f"BA ran {ran}")
    drms = float(np.abs(c_s["ba_rms_px"] - c_w["ba_rms_px"]).max())
    check(dpos <= SHARD_POS_TOL and drms <= SHARD_RMS_TOL,
          f"vo --shard-ba vs unsharded: positions {dpos} m, rms {drms} px")
    ms_w = float(np.median(st_w["frame"])) * 1e3
    ms_s = float(np.median(st_s["frame"])) * 1e3
    print(f"cli vo --window --shard-ba {SHARD_RANKS}: {nw} frames, BA on "
          f"frames 2-{nw - 1}, positions within {dpos:.3e} m and BA rms "
          f"within {drms:.3e} px of the unsharded run; median {ms_s:.3f} "
          f"ms/frame sharded against {ms_w:.3f} unsharded (rank 0's "
          f"recording) [{card}]", flush=True)

    # (d) report on (a)'s study and phase 7's recording, then explore
    rep = tmp / "report"
    text, rcounts = run_cli(torch, ["report", "--study", str(study),
                                    "--record", ctx["rec"], "--out",
                                    str(rep)], reset_counts, read_counts)
    md = (rep / "REPORT.md").read_text()
    figs = [ln[ln.index("(") + 1:ln.index(")")] for ln in md.splitlines()
            if ln.startswith("![")]
    check(len(figs) >= 16, f"report references {len(figs)} figures")
    for f in figs:
        check((rep / f).exists(), f"report figure {f} missing")
        ET.parse(rep / f)
    rows = [ln.split("|")[1:5] for ln in md.splitlines()
            if ln.startswith("| ") and ln.split("|")[1].strip() in
            {c for c, _ in report.DESC_CONFIGS}]
    check([r[0].strip() for r in rows] == [c for c, _ in
                                           report.DESC_CONFIGS],
          f"timing table rows {rows}")
    check(all(rcounts[k] > 0 for k in ("fast_grid", "brief_keypoints",
                                       "match_reduce")),
          f"report launches {rcounts}")
    print(f"cli report: {len(figs)} figures (SVG, parsed), the study "
          f"table and the timing table of {len(rows)} configurations; "
          f"desc+match ms on the card: "
          + ", ".join(f"{r[0].strip()} {r[2].strip()}" for r in rows)
          + f"; launches {rcounts} [{card}]", flush=True)
    ex = tmp / "explore"
    text, xcounts = run_cli(torch, ["explore", "--family", "FAST",
                                    "--frames", "2", "--out", str(ex)],
                            reset_counts, read_counts)
    index = (ex / "INDEX.md").read_text()
    n_rows = sum(1 for ln in index.splitlines() if ln.startswith("| ")
                 and ln.split("|")[1].strip().isdigit())
    for ln in index.splitlines():
        if ln.startswith("!["):
            f = ln[ln.index("(") + 1:ln.index(")")]
            check((ex / f).exists(), f"explore file {f} missing")
    check(n_rows == 354 and xcounts["fast_margins"] > 0,
          f"explore: {n_rows} rows, launches {xcounts}")
    print(f"cli explore --family FAST --frames 2: {n_rows} combinations "
          f"ranked, overlays and summary written; launches {xcounts}",
          flush=True)

    # the report's BRIEF_16 stereo match: the match kernel at 4 words
    L1, R1 = make_sequence(1)
    from front_end_tpu_torch import features
    gcfg = grid.GridConfig()
    left, right = (torch.as_tensor(a[0]).to(dev) for a in (L1, R1))
    kl, kr = (grid.detect(img, gcfg.init_thresholds(dev), gcfg).keypoints
              for img in (left, right))
    fn = features.make_descriptor(report.DESC_CONFIGS[0][1])[0]
    dl, dr = fn(left, kl.xy), fn(right, kr.xy)
    margs = (dl.packed, dr.packed, kl.xy, kr.xy, kl.valid, kr.valid)
    check(margs[0].shape[1] == 4, f"BRIEF_16 words {tuple(margs[0].shape)}")
    kw = dict(mode="epi", p1=2.0)
    got = match_reduce.match_reduce(*margs, **kw)
    ref = match_reduce.plain(*margs, **kw)
    torch.cuda.synchronize()
    check(all(same(torch, g, r) for g, r in zip(got, ref)),
          "match_reduce at 4 words != plain")
    m4 = {"err": max_abs_err(torch, got, ref),
          "ms": cuda_ms(torch, lambda: match_reduce.match_reduce(*margs,
                                                                 **kw), 100),
          "plain": cuda_ms(torch, lambda: match_reduce.plain(*margs, **kw),
                           10)}
    print(f"kernel match_reduce (report BRIEF_16 stereo, "
          f"{margs[0].shape[0]} x {margs[1].shape[0]}, 4 words): exact; "
          f"{m4['ms'] * 1e3:.1f} us vs plain {m4['plain'] * 1e3:.1f} us "
          f"[{card}]", flush=True)
    return {"report": rcounts, "explore": xcounts}, m4


def key_paths(d: dict, prefix: str = "") -> set:
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= key_paths(v, prefix + k + ".")
    return keys


def bench_launches(F: int, P: int, C: int, R: int) -> dict:
    """Kernel launches of `cli bench` at F frames, P passes, C stage calls
    and R rendered frames: 1 grid and 1 keypoint BRIEF launch and 2 match
    launches per VO frame, one more match per windowed frame; the stage
    timings add one call each for warming and `feats0`."""
    vo_frames = ((2 + F * P) + (F + F * P) + 2 * (2 + F * P)  # headline,
                 + 4 * F + R)           # run_sequence, brief16, subpix; feed
    win_frames = R + (2 + F * P)
    frames = vo_frames + win_frames
    detect, extract, motion = C + 1, C + 2, C + 1
    return {"fast_grid": frames + detect + extract,
            "brief_keypoints": frames + extract,
            "match_reduce": 2 * frames + win_frames + extract + motion}


def bench_phase(torch, card, reset_counts, read_counts) -> dict:
    """Phase 9: `cli bench` at its defaults, launch counters reset just
    before and read just after.  Returns its launches."""
    from front_end_tpu_torch.sim import render

    gt = render.corridor_trajectory(40)
    path = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    t0 = time.perf_counter()
    text, counts = run_cli(torch, ["bench"], reset_counts, read_counts)
    bench_s = time.perf_counter() - t0
    res = json.loads(text.strip().splitlines()[-1])
    d = res["detail"]
    check(key_paths(res) == BENCH_KEYS, "bench line keys differ: "
          f"{sorted(key_paths(res) ^ BENCH_KEYS)}")
    check(res["value"] > 0
          and res["vs_baseline"] == round(res["value"] / 200, 3),
          f"bench value {res['value']}, vs_baseline {res['vs_baseline']}")
    check(d["device"] == card, f"bench device {d['device']!r}, card {card!r}")
    check(d["resolution"] == "376x1241" and d["n_frames"] == 200,
          f"bench depth {d['resolution']}, {d['n_frames']} frames")
    check(d["motion_ok_last"] is True, "bench: motion_ok_last is not true")
    for k in ("ate_rendered_world_m", "ate_rendered_world_windowed_m"):
        check(np.isfinite(d[k]) and d[k] < ATE_SHARE * path,
              f"bench {k} {d[k]} not under {ATE_SHARE:.0%} of the "
              f"{path:.3f} m path")
    for k in ("fps_feed_inclusive", "fps_subpix_on", "fps_brief16",
              "fps_device_scan", "fps_windowed", "h2d_link_mb_per_s",
              "h2d_pipelined_mb_per_s"):
        check(d[k] > 0, f"bench {k} {d[k]}")
    want = dict(bench_launches(40, 5, 50, 40), brief_planes=0,
                fast_detect=0, fast_margins=0)
    check(counts == want, f"bench launches {counts}, want {want}")
    st = d["stage_ms"]
    print(f"bench: {res['value']} fps (vs_baseline {res['vs_baseline']}, "
          f"{d['ms_per_frame']} ms/frame), run_sequence "
          f"{d['fps_device_scan']}, brief16 {d['fps_brief16']}, subpix "
          f"{d['fps_subpix_on']}, windowed (ba_every=2, ba_iters=2) "
          f"{d['fps_windowed']}, feed {d['fps_feed_inclusive']} "
          f"({d['feed_source']}); H2D {d['h2d_link_mb_per_s']} / "
          f"{d['h2d_pipelined_mb_per_s']} MB/s; stage ms floor "
          f"{st['harness_floor']} detect {st['detect_pair']} extract "
          f"{st['extract_total']} motion {st['motion_ransac_lm']}; ATE "
          f"{d['ate_rendered_world_m']} / "
          f"{d['ate_rendered_world_windowed_m']} m of a {path:.3f} m path; "
          f"launches {counts}; {bench_s:.1f} s [{card}]", flush=True)
    return {"bench": counts}


def window_launches(points: int, frames: int) -> dict:
    """Kernel launches of the window sweep: per point `frames` windowed
    frames, each 1 grid, 1 keypoint BRIEF and 3 match launches."""
    n = points * frames
    return {"fast_grid": n, "brief_keypoints": n, "match_reduce": 3 * n}


def window_phase(torch, card, reset_counts, read_counts) -> dict:
    """Phase 9, second half: `window_vo_step` at every point of
    `WINDOW_POINTS` on synthetic KITTI-size frames and on the rendered
    corridor, launch counters reset just before and read just after.
    Returns its launches."""
    from front_end_tpu_torch import bench
    from front_end_tpu_torch.eval import metrics
    from front_end_tpu_torch.pipeline import telemetry, window_vo
    from front_end_tpu_torch.sim.sequence import make_sequence

    dev = torch.device("cuda")
    h, w = bench.parse_size(bench.KITTI_SIZE)
    rig, cfg = bench.bench_rig(h, w), bench.vo_config()
    lefts, rights = make_sequence(WINDOW_KITTI_FRAMES, h=h, w=w, seed=5)
    L = [torch.as_tensor(x).to(dev) for x in lefts]
    R = [torch.as_tensor(x).to(dev) for x in rights]
    rrig, gt, rl, rr = bench.rendered_world(40)
    rcfg = bench.rendered_config()
    path = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = []
    for W, every, iters in WINDOW_POINTS:
        with telemetry.recording() as rec:
            for c, rg, ls, rs in ((cfg, rig, L, R), (rcfg, rrig, rl, rr)):
                wc = window_vo.WindowVOConfig.create(
                    c, window=W, ba_every=every, ba_iters=iters)
                traj = bench.trajectory(
                    lambda s, left, right, rg=rg, wc=wc:
                        window_vo.window_vo_step(s, left, right, rg, wc),
                    window_vo.init_state(rg, wc, device=dev), ls, rs,
                    lambda o: o.frame.pose)
        counters = rec.counters()
        ran = int(sum(v for _, v in counters["window.ba_ran"]))
        served = [v for _, v in counters.get("ba.graph", [])]
        steps = len(counters.get("ba.accepted", []))
        check(ran > 0 and served == [1.0] * ran and steps == iters * ran,
              f"window (W {W}, ba_every {every}, iters {iters}): {ran} BA "
              f"frames, ba.graph {served}, {steps} BA iterations")
        ate = metrics.ate_rmse(traj[:, :3, 3], gt[:, :3, 3])
        check(np.isfinite(ate) and ate < ATE_SHARE * path,
              f"window (W {W}, ba_every {every}, iters {iters}): ATE "
              f"{ate} not under {ATE_SHARE:.0%} of the {path:.3f} m path")
        rows.append(f"({W}, {every}, {iters}) {ran} BA {ate:.4f} m")
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict(window_launches(len(WINDOW_POINTS),
                                WINDOW_KITTI_FRAMES + len(rl)),
                brief_planes=0, fast_detect=0, fast_margins=0)
    check(counts == want, f"window launches {counts}, want {want}")
    print("window (W, ba_every, iters) BA frames, rendered ATE: "
          + "; ".join(rows) + f"; every BA a graph replay; launches "
          f"{counts}; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return {"window": counts}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "front_end_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(front_end_tpu_torch/ not found beside it)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))

    from front_end_tpu_torch import features, services
    from front_end_tpu_torch.geometry import se3
    from front_end_tpu_torch.geometry.camera import kitti_rig
    from front_end_tpu_torch.ops import (akaze, brief, brisk, grid, image,
                                         match, orb, sift)
    from front_end_tpu_torch.ops import fast as fast_ops
    from front_end_tpu_torch.ops.kernels import (_build, brief_keypoints,
                                                 brief_planes, fast_detect,
                                                 fast_grid, fast_margins,
                                                 match_reduce)
    from front_end_tpu_torch.motion import essential, ransac
    from front_end_tpu_torch.pipeline import vo, window_vo
    from front_end_tpu_torch.sim import render
    from front_end_tpu_torch.sim.sequence import make_sequence
    from front_end_tpu_torch.utils.precision import pinned_f32

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- build, in parallel ---------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build("fast_grid", "brief_planes", "brief_keypoints",
                        "match_reduce", "fast_detect", "fast_margins")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill", text)]
        if regs:
            print(f"  ptxas {name}: {len(regs)} kernels, at most "
                  f"{max(regs)} registers, {max(spills, default=0)} bytes "
                  f"spilled")

    rig = kitti_rig()
    cfg = vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=384,
                             set_point=2000, init_threshold=15.0),
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0, min_track_inliers=12)
    lefts, rights = make_sequence(WINDOW_FRAMES, rig.height, rig.width)
    H, W = rig.height, rig.width
    kernels = []
    modules = {"fast_grid": fast_grid, "brief_planes": brief_planes,
               "brief_keypoints": brief_keypoints,
               "match_reduce": match_reduce, "fast_detect": fast_detect,
               "fast_margins": fast_margins}
    by_path = {}

    def reset_counts():
        for m in modules.values():
            m.launches = 0

    def read_counts():
        return {k: m.launches for k, m in modules.items()}

    def match_case(args, kw, what):
        """The match kernel against the twin, exactly; device ms of both."""
        ref = match_reduce.plain(*args, **kw)
        got = match_reduce.match_reduce(*args, **kw)
        torch.cuda.synchronize()
        check(all(same(torch, g, r) for g, r in zip(got, ref)),
              f"match_reduce ({what}) != plain")
        out = {"err": max_abs_err(torch, got, ref),
               "ms": cuda_ms(torch, lambda: match_reduce.match_reduce(
                   *args, **kw), 100),
               "plain": cuda_ms(torch,
                                lambda: match_reduce.plain(*args, **kw), 10)}
        print(f"kernel match_reduce ({what}): exact; {out['ms'] * 1e3:.1f} "
              f"us vs plain {out['plain'] * 1e3:.1f} us", flush=True)
        return out

    with pinned_f32():
        # ---- phase 2: each kernel against its plain twin ------------------
        imgs = torch.as_tensor(np.stack([lefts[0], rights[0]])).to(dev)
        thr = cfg.grid.init_thresholds(dev).expand(2, -1, -1).contiguous()
        cell = (2, 3) + grid._cell_dims(H, W, cfg.grid)
        got = fast_grid.fast_grid(imgs, thr, cell)
        ref = fast_grid.plain(imgs, thr, cell)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, ref)
        check(err == 0.0 and all(same(torch, g, r) for g, r in
                                 zip(got, ref)), "fast_grid != plain")
        corners = int(got[2].sum())
        check(corners > 1000, "fast_grid found too few corners")
        # the controller keeps thresholds in [4, 80]; the kernel holds for
        # any: -inf makes every pixel a candidate of its early rejection
        rs = np.random.RandomState(4)
        table = torch.as_tensor(rs.randint(-2, 40, (2, 2, 3)).astype(
            np.float32)).to(dev)
        every = torch.full_like(thr, -torch.inf)
        none = torch.full_like(thr, torch.inf)
        for what, th in (("-inf", every), ("-1", torch.full_like(thr, -1.0)),
                         ("1", torch.full_like(thr, 1.0)),
                         ("60", torch.full_like(thr, 60.0)),
                         ("per-cell table", table)):
            # the pair's score windows are 32 rows high, the crop's 16
            for where, im in (("pair", imgs), ("crop", imgs[:, :120, :400])):
                c = (2, 3) + grid._cell_dims(*im.shape[-2:], cfg.grid)
                got = fast_grid.fast_grid(im, th, c)
                ref = fast_grid.plain(im, th, c)
                torch.cuda.synchronize()
                check(all(same(torch, g, r) for g, r in zip(got, ref)),
                      f"fast_grid (thresholds {what}, {where}) != plain")
                err = max(err, max_abs_err(torch, got, ref))
        for ft in ("7_12", "5_8"):
            got = fast_grid.fast_grid(imgs, table, cell, ft)
            ref = fast_grid.plain(imgs, table, cell, ft)
            torch.cuda.synchronize()
            check(all(same(torch, g, r) for g, r in zip(got, ref)),
                  f"fast_grid ({ft}) != plain")
            err = max(err, max_abs_err(torch, got, ref))
        ms = cuda_ms(torch, lambda: fast_grid.fast_grid(imgs, thr, cell), 100)
        dev_ms = device_ms(torch, lambda: fast_grid.fast_grid(imgs, thr, cell),
                           "fast_grid_kernel")
        ms_all = cuda_ms(torch, lambda: fast_grid.fast_grid(imgs, every,
                                                            cell), 100)
        ms_none = cuda_ms(torch, lambda: fast_grid.fast_grid(imgs, none,
                                                             cell), 100)
        plain_ms = cuda_ms(torch, lambda: fast_grid.plain(imgs, thr, cell),
                           10)
        fd, fb = fast_ops.candidate_masks(
            imgs, fast_grid.threshold_map(thr, H, W, cell[2], cell[3]))
        share = float((fd | fb).float().mean())
        ph, pw = fast_grid.pooled_dims(cell[2], cell[3])
        n_out = 2 * 6 * ph * pw
        by = imgs.numel() * 4 + thr.numel() * 4 + n_out * 5 + 2 * 6 * 4
        per_px = fast_ops_per_pixel(16, 9)
        # the kernel skips the segment test where a bound proves the score
        # 0, so the operations of the full test are no floor: the bound is
        # the bytes, and the full test's count stands beside it as `ops`
        kernels.append(dict(
            name="fast_grid", route="cuda",
            source="front_end_tpu_torch/csrc/fast_grid.cu",
            replaces="front_end_tpu/ops/pallas/fast_kernel.py:351",
            max_abs_err=err, ms=ms, device_ms=dev_ms,
            ms_all_candidates=ms_all, ms_no_candidates=ms_none,
            candidate_share=share,
            plain_ms=plain_ms, bytes=by, ops=sum(per_px) * imgs.numel(),
            bound_s=(by / HBM_BYTES_S, 0.0), library_ms=None))
        print(f"kernel fast_grid: exact (thresholds -inf to 60 and per "
              f"cell, 3 circle types); {ms * 1e3:.1f} us at the path's "
              f"thresholds (kernel alone {fmt_us(dev_ms)}; {share:.1%} of "
              f"pixels candidates), "
              f"{ms_all * 1e3:.1f} us with every pixel a candidate, "
              f"{ms_none * 1e3:.1f} us with none, vs plain "
              f"{plain_ms * 1e3:.1f} us; {corners} corners", flush=True)

        sm = brief.smooth(imgs)
        bp = {}
        for n_bits in (8 * cfg.desc_bytes, 128, 512):
            pat = brief.brief_pattern(n_bits)
            got = brief_planes.brief_planes(sm, pat)
            ref = brief_planes.plain(sm, pat)
            torch.cuda.synchronize()
            check(same(torch, got, ref), f"brief_planes ({n_bits} bits) != "
                  "plain")
            bp[n_bits] = (
                max_abs_err(torch, [got], [ref]),
                cuda_ms(torch, lambda: brief_planes.brief_planes(sm, pat),
                        100),
                device_ms(torch, lambda: brief_planes.brief_planes(sm, pat),
                          "brief_planes_kernel"))
            del got, ref
        n_bits = 8 * cfg.desc_bytes
        pat = brief.brief_pattern(n_bits)
        plain_ms = cuda_ms(torch, lambda: brief_planes.plain(sm, pat), 5)
        by = sm.numel() * 4 + sm.numel() * n_bits // 8
        ops = sm.numel() * n_bits       # one float compare a bit
        kernels.append(dict(
            name="brief_planes", route="cuda",
            source="front_end_tpu_torch/csrc/brief_planes.cu",
            replaces="front_end_tpu/ops/pallas/brief_kernel.py:76",
            max_abs_err=max(v[0] for v in bp.values()), ms=bp[n_bits][1],
            device_ms=bp[n_bits][2], ms_128=bp[128][1],
            device_ms_128=bp[128][2], ms_512=bp[512][1],
            device_ms_512=bp[512][2], plain_ms=plain_ms, bytes=by, ops=ops,
            bound_s=(by / HBM_BYTES_S, ops / MINMAX_OPS_S), library_ms=None))
        print(f"kernel brief_planes: exact (128, 256, 512 bits); "
              f"{bp[n_bits][1] * 1e3:.3f} us (kernel alone "
              f"{fmt_us(bp[n_bits][2])}) vs plain {plain_ms * 1e3:.1f} us at "
              f"{n_bits} bits; {bp[128][1] * 1e3:.3f} us at 128 (alone "
              f"{fmt_us(bp[128][2])}), {bp[512][1] * 1e3:.3f} us at 512 "
              f"(alone {fmt_us(bp[512][2])})", flush=True)

        # the main path's match inputs: frame 0's stereo pair and frame
        # 1's left features against frame 0's
        s0 = vo.init_state(rig, cfg, device=dev)
        s1, _ = vo.vo_step(s0, lefts[0], rights[0], rig, cfg)
        d0l, d0r = grid.detect_pair(imgs[0], imgs[1], s0.thresholds_l,
                                    s0.thresholds_r, cfg.grid)
        kl, kr = d0l.keypoints, d0r.keypoints
        kl = kl.replace(valid=kl.valid & brief.valid_mask(kl.xy, W, H))
        kr = kr.replace(valid=kr.valid & brief.valid_mask(kr.xy, W, H))
        dl, dr = brief.describe_pair(sm[0], sm[1], kl.xy, kr.xy,
                                     cfg.desc_bytes)

        # BRIEF at frame 0's 2 x 2304 keypoints (padding rows included):
        # against its twin and against the gathered dense planes
        kxy = torch.stack([kl.xy, kr.xy])
        check(kxy.shape == (2, cfg.grid.capacity, 2),
              f"keypoint shape {tuple(kxy.shape)}")
        bk = {}
        for n_bits in (8 * cfg.desc_bytes, 128, 512):
            table = brief.table_on(n_bits, 7, dev)
            got = brief_keypoints.brief_keypoints(sm, kxy, table)
            ref = brief_keypoints.plain(sm, kxy, table)
            planes = brief_planes.brief_planes(sm, brief.brief_pattern(n_bits))
            dense = torch.stack([brief.gather_words(planes[b], kxy[b]).packed
                                 for b in range(2)])
            torch.cuda.synchronize()
            check(same(torch, got, ref),
                  f"brief_keypoints ({n_bits} bits) != plain")
            check(same(torch, got, dense),
                  f"brief_keypoints ({n_bits} bits) != gathered dense planes")
            bk[n_bits] = (
                cuda_ms(torch, lambda: brief_keypoints.brief_keypoints(
                    sm, kxy, table), 100),
                max(max_abs_err(torch, [got], [ref]),
                    max_abs_err(torch, [got], [dense])),
                table.numel() * 4 + got.numel() * 4)
            del planes
        n_bits = 8 * cfg.desc_bytes
        table = brief.table_on(n_bits, 7, dev)
        check(same(torch, torch.stack([dl.packed, dr.packed]),
                   brief_keypoints.brief_keypoints(sm, kxy, table)),
              "describe_pair != brief_keypoints")
        plain_ms = cuda_ms(torch, lambda: brief_keypoints.plain(
            sm, kxy, table), 10)
        by = sm.numel() * 4 + kxy.numel() * 4 + bk[n_bits][2]
        ops = kxy.shape[0] * kxy.shape[1] * n_bits     # compares
        kernels.append(dict(
            name="brief_keypoints", route="cuda",
            source="front_end_tpu_torch/csrc/brief_keypoints.cu",
            replaces="front_end_tpu/ops/pallas/brief_kernel.py:76",
            max_abs_err=max(v[1] for v in bk.values()), ms=bk[n_bits][0],
            plain_ms=plain_ms, ms_128=bk[128][0], ms_512=bk[512][0],
            bytes=by, ops=ops,
            bound_s=(by / HBM_BYTES_S, ops / MINMAX_OPS_S), library_ms=None))
        print(f"kernel brief_keypoints: exact (twin and gathered dense "
              f"planes; 128, 256, 512 bits); {bk[n_bits][0] * 1e3:.1f} us vs "
              f"plain {plain_ms * 1e3:.1f} us at {n_bits} bits; "
              f"{bk[128][0] * 1e3:.1f} us at 128, {bk[512][0] * 1e3:.1f} us "
              f"at 512", flush=True)
        s2, _ = vo.vo_step(s1, lefts[1], rights[1], rig, cfg)
        cases = {
            "stereo": ((dl.packed, dr.packed, kl.xy, kr.xy, kl.valid,
                        kr.valid),
                       dict(mode="stereo", p1=cfg.epi_threshold, p2=0.0,
                            p3=cfg.max_disparity)),
            "roi": ((s2.prev.packed, s1.prev.packed, s2.prev.kps.xy,
                     s1.prev.kps.xy, s2.prev.kps.valid, s1.prev.kps.valid),
                    dict(mode="roi", p1=cfg.track_box))}
        times = {}
        for mode, (args, kw) in cases.items():
            check(args[0].shape == (cfg.grid.capacity, 8),
                  f"match input shape {tuple(args[0].shape)}")
            times[mode] = match_case(args, kw, mode)
            check(int((match_reduce.match_reduce(*args, **kw)[0]
                       < match.BIG / 2).sum()) > 100,
                  f"match_reduce ({mode}): too few ungated rows")
        nq, nw = cases["stereo"][0][0].shape
        nt = cases["stereo"][0][1].shape[0]
        by, ops, bound_s = match_work(nq, nt, nw)

        # the same kernel at 16 words, FREAK's 512 bits (BRISK's are as
        # wide): frame 0's stereo pair and frame 1's left features against
        # frame 0's, as the swap set's paths give them
        cfg16 = cfg.replace(descriptor="freak")
        b16 = vo.DESCRIPTORS["freak"]["border"]
        f0l, f0r = grid.detect_pair(imgs[0], imgs[1], s0.thresholds_l,
                                    s0.thresholds_r, cfg.grid)
        k16l, k16r = (k.replace(valid=k.valid & brief.valid_mask(
            k.xy, W, H, border=b16)) for k in (f0l.keypoints, f0r.keypoints))
        k16l, k16r, d16l, d16r = vo._describe(imgs[0], imgs[1], k16l, k16r,
                                              cfg16)
        t1, _ = vo.vo_step(vo.init_state(rig, cfg16, device=dev), lefts[0],
                           rights[0], rig, cfg16)
        t2, _ = vo.vo_step(t1, lefts[1], rights[1], rig, cfg16)
        cases16 = {
            "stereo": ((d16l.words(), d16r.words(), k16l.xy, k16r.xy,
                        k16l.valid, k16r.valid), cases["stereo"][1]),
            "roi": ((t2.prev.packed, t1.prev.packed, t2.prev.kps.xy,
                     t1.prev.kps.xy, t2.prev.kps.valid, t1.prev.kps.valid),
                    cases["roi"][1])}
        times16 = {}
        for mode, (args, kw) in cases16.items():
            check(args[0].shape == (cfg.grid.capacity, 16),
                  f"16-word match input shape {tuple(args[0].shape)}")
            times16[mode] = match_case(args, kw, f"{mode}, 16 words")
            check(int((match_reduce.match_reduce(*args, **kw)[0]
                       < match.BIG / 2).sum()) > 100,
                  f"match_reduce ({mode}, 16 words): too few ungated rows")

        kernels.append(dict(
            name="match_reduce", route="cuda",
            source="front_end_tpu_torch/csrc/match_reduce.cu",
            replaces="front_end_tpu/ops/pallas/match_kernel.py:110",
            max_abs_err=max(v["err"] for v in list(times.values())
                            + list(times16.values())),
            ms=times["stereo"]["ms"], plain_ms=times["stereo"]["plain"],
            ms_roi=times["roi"]["ms"], plain_ms_roi=times["roi"]["plain"],
            ms_16w=times16["stereo"]["ms"],
            plain_ms_16w=times16["stereo"]["plain"],
            ms_roi_16w=times16["roi"]["ms"],
            plain_ms_roi_16w=times16["roi"]["plain"],
            bytes=by, ops=ops, bound_s=bound_s,
            library_ms=None))

        # ---- the dense FAST kernels at the service path's shapes -------
        img0 = imgs[0].contiguous()
        rs = np.random.RandomState(5)
        tmap = torch.as_tensor(rs.randint(-2, 40, (2, H, W)).astype(
            np.float32)).to(dev)
        worst_m = worst_d = 0.0
        for ft in fast_ops.TYPES:
            got = fast_margins.fast_margins(imgs, ft)
            ref = fast_margins.plain(imgs, ft)
            torch.cuda.synchronize()
            check(all(same(torch, g, r) for g, r in zip(got, ref)),
                  f"fast_margins ({ft}) != plain")
            worst_m = max(worst_m, max_abs_err(torch, got, ref))
            # and at the shape the service path launches it at: one image
            got = fast_margins.fast_margins(img0, ft)
            ref = fast_margins.plain(img0, ft)
            torch.cuda.synchronize()
            check(all(same(torch, g, r) for g, r in zip(got, ref)),
                  f"fast_margins ({ft}, one image) != plain")
            worst_m = max(worst_m, max_abs_err(torch, got, ref))
            for nms in (True, False):
                for thr_d in (-torch.inf, -1.0, 1.0, 15.0, 60.0, tmap):
                    ref = fast_detect.plain(imgs, thr_d, ft, nms)
                    got = fast_detect.fast_detect(imgs, thr_d, ft, nms)
                    torch.cuda.synchronize()
                    what = (f"fast_detect ({ft}, nms={nms}, threshold "
                            f"{'map' if thr_d is tmap else thr_d})")
                    check(same(torch, got, ref), f"{what} != plain")
                    worst_d = max(worst_d, max_abs_err(torch, [got], [ref]))
        check(int((fast_margins.fast_margins(img0)[0] > 15).sum()) > 1000,
              "fast_margins found too few corners")
        # every shape the sweep launches the detect kernel at: ORB's levels
        # at the table's three scale factors, BRISK's octaves (the small
        # ones take score windows of 16 rows, the others of 32)
        level_ms = {}
        held = [("ORB level 0", img0)]
        for sf in features.ORB_PARAMS["scale_factor"]:
            for lvl in range(1, max(features.ORB_PARAMS["n_levels"])):
                held.append((f"ORB scale {sf} level {lvl}", image.resize_linear(
                    img0, *orb.level_shape(H, W, lvl, sf))))
        octave = img0
        for o in range(1, max(features.BRISK_PARAMS["n_octaves"])):
            octave = brisk.next_octave(octave).contiguous()
            held.append((f"BRISK octave {o}", octave))
        for what, lv in held:
            h, w = lv.shape
            got = fast_detect.fast_detect(lv, 1.0, "9_16", True)
            ref = fast_detect.plain(lv, 1.0, "9_16", True)
            torch.cuda.synchronize()
            check(same(torch, got, ref),
                  f"fast_detect ({what}, {h}x{w}) != plain")
            worst_d = max(worst_d, max_abs_err(torch, [got], [ref]))
            check(int((got > 0).sum()) > h * w // 2000,
                  f"{what}: too few corners")
            if what.startswith(("ORB level 0", "ORB scale 1.2 ")):
                level_ms[f"{h}x{w}"] = cuda_ms(
                    torch,
                    lambda: fast_detect.fast_detect(lv, 1.0, "9_16", True),
                    100)
        # timed at the shape the service path launches them at: one image;
        # the wrapper by CUDA events, the kernel alone by the profiler
        npix = img0.numel()
        fm = {}
        for ft in fast_ops.TYPES:
            call = (lambda ft=ft: fast_margins.fast_margins(img0, ft))
            fm[ft] = (cuda_ms(torch, call, 100),
                      device_ms(torch, call, "fast_margins_kernel"))
        ms_pair = cuda_ms(torch, lambda: fast_margins.fast_margins(imgs), 100)
        plain_ms = cuda_ms(torch, lambda: fast_margins.plain(img0), 10)
        by, per_px = npix * 12, segment_ops_per_pixel(16, 9)
        kernels.append(dict(
            name="fast_margins", route="cuda",
            source="front_end_tpu_torch/csrc/fast_margins.cu",
            replaces="front_end_tpu/ops/pallas/fast_kernel.py:420",
            max_abs_err=worst_m, ms=fm["9_16"][0], device_ms=fm["9_16"][1],
            plain_ms=plain_ms, ms_7_12=fm["7_12"][0],
            device_ms_7_12=fm["7_12"][1], ms_5_8=fm["5_8"][0],
            device_ms_5_8=fm["5_8"][1], ms_pair=ms_pair, bytes=by,
            ops=sum(per_px) * npix, minmax_per_pixel={
                ft: segment_ops_per_pixel(len(fast_ops.TYPES[ft][0]),
                                          fast_ops.TYPES[ft][1])[0]
                for ft in fast_ops.TYPES},
            bound_s=(by / HBM_BYTES_S, fast_ops_seconds(per_px, npix)),
            library_ms=None))
        print("kernel fast_margins: exact (3 circle types); per image "
              + ", ".join(f"{ft} {v[0] * 1e3:.3f} us (kernel alone "
                          f"{fmt_us(v[1])})" for ft, v in fm.items())
              + f", pair {ms_pair * 1e3:.3f} us, vs plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)
        ms = cuda_ms(torch, lambda: fast_detect.fast_detect(img0, 1.0), 100)
        dev_ms = device_ms(torch, lambda: fast_detect.fast_detect(img0, 1.0),
                           "fast_detect_kernel")
        plain_ms = cuda_ms(torch, lambda: fast_detect.plain(img0, 1.0), 10)
        variants = {
            "ms_all_candidates": lambda: fast_detect.fast_detect(
                img0, -torch.inf),
            "ms_no_candidates": lambda: fast_detect.fast_detect(
                img0, torch.inf),
            "ms_no_nms": lambda: fast_detect.fast_detect(img0, 1.0, "9_16",
                                                         False),
            "ms_threshold_15": lambda: fast_detect.fast_detect(img0, 15.0),
            "ms_map": lambda: fast_detect.fast_detect(img0, tmap[0]),
            "ms_pair": lambda: fast_detect.fast_detect(imgs, 15.0)}
        extra_ms = {k: cuda_ms(torch, f, 100) for k, f in variants.items()}
        fd, fb = fast_ops.candidate_masks(img0, 1.0)
        share = float((fd | fb).float().mean())
        by, per_px = npix * 8, detect_ops_per_pixel(16, 9, True)
        # as for the grid kernel: work is skipped, so the bound is the bytes
        kernels.append(dict(
            name="fast_detect", route="cuda",
            source="front_end_tpu_torch/csrc/fast_detect.cu",
            replaces="front_end_tpu/ops/pallas/fast_kernel.py:219",
            max_abs_err=worst_d, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            **extra_ms, candidate_share=share, ms_orb_levels=level_ms,
            bytes=by,
            ops=sum(per_px) * npix,
            bound_s=(by / HBM_BYTES_S, 0.0), library_ms=None))
        print(f"kernel fast_detect: exact (3 types x nms x thresholds -inf "
              f"to 60 and a map, {len(held)} level and octave shapes); "
              f"{ms * 1e3:.3f} us at the sweep's threshold 1.0 (kernel alone "
              f"{fmt_us(dev_ms)}; {share:.1%} of pixels candidates), "
              f"{extra_ms['ms_all_candidates'] * 1e3:.1f} us with every "
              f"pixel a candidate, {extra_ms['ms_no_candidates'] * 1e3:.1f} "
              f"us with none, vs plain {plain_ms * 1e3:.1f} us per "
              f"image", flush=True)

        # ---- phase 3: the VO path ------------------------------------
        LW = torch.as_tensor(lefts).to(dev)
        RW = torch.as_tensor(rights).to(dev)
        L, R = LW[:FRAMES], RW[:FRAMES]
        torch.cuda.synchronize()
        reset_counts()
        state = vo.init_state(rig, cfg, seed=0, device=dev)
        state, outs = vo.run_sequence(state, L, R, rig, cfg)
        torch.cuda.synchronize()
        launches = by_path["vo"] = read_counts()
        expect = {"fast_grid": FRAMES, "brief_planes": 0,
                  "brief_keypoints": FRAMES, "match_reduce": 2 * FRAMES,
                  "fast_detect": 0, "fast_margins": 0}
        check(launches == expect, f"launches {launches}, want {expect}")
        poses = vo_poses = outs.pose.cpu()
        check(bool(torch.isfinite(poses).all()), "non-finite pose")
        ok_frac = float(outs.motion_ok.float().mean())
        check(ok_frac >= 0.9, f"motion_ok on {ok_frac:.0%} of frames")
        # make_sequence pans 3 px/frame at a 12 px disparity: the camera
        # moves +x by 3 * baseline / 12 per frame, without rotation
        step_m = 3 * rig.baseline / 12
        t_final = poses[-1, :3, 3].double()
        t_true = torch.tensor([(FRAMES - 1) * step_m, 0.0, 0.0],
                              dtype=torch.float64)
        drift = float((t_final - t_true).norm())
        rot = float(se3.rotation_geodesic_error(poses[-1, :3, :3],
                                                torch.eye(3)))
        check(drift < 0.05 * float(t_true.norm()),
              f"final position {t_final.tolist()} vs {t_true.tolist()}")
        check(rot < 0.01, f"final rotation error {rot} rad")
        stats = {f: outs[i].float().mean().item() for i, f in
                 enumerate(outs._fields) if f.startswith("n_")}
        print(f"VO path: {FRAMES} frames, launches {launches}, motion_ok "
              f"{ok_frac:.0%}, final t {t_final.tolist()} (true "
              f"{t_true.tolist()}), drift {drift:.4f} m, rot {rot:.2e} rad, "
              f"mean counts {json.dumps(stats)}", flush=True)

        timed = []
        for _ in range(3):
            s = vo.init_state(rig, cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, o = vo.run_sequence(s, L, R, rig, cfg)
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0) / FRAMES * 1e3)
        ms_frame = min(timed)
        print(f"vo_step: {ms_frame:.3f} ms/frame ({1e3 / ms_frame:.1f} fps) "
              f"at {H}x{W}, runs {[round(x, 3) for x in timed]} ms/frame "
              f"[{card}]", flush=True)

        # ---- phase 4: the CPU run of the first frames ----------------
        res = {}
        for d in ("cuda", "cpu"):
            s = vo.init_state(rig, cfg, seed=0, device=d)
            s, o = vo.run_sequence(s, lefts[:CPU_FRAMES], rights[:CPU_FRAMES],
                                   rig, cfg)
            res[d] = (s, o)
        (sg, og), (sc, oc) = res["cuda"], res["cpu"]
        for f in ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks"):
            check(torch.equal(getattr(og, f).cpu(), getattr(oc, f)),
                  f"card vs CPU {f}: {getattr(og, f).tolist()} vs "
                  f"{getattr(oc, f).tolist()}")
        for f in ("xy", "score", "valid"):
            check(torch.equal(getattr(sg.prev.kps, f).cpu(),
                              getattr(sc.prev.kps, f)),
                  f"card vs CPU keypoints.{f}")
        check(same(torch, sg.prev.packed.cpu(), sc.prev.packed),
              "card vs CPU descriptors")
        dpose = float((og.pose.cpu() - oc.pose).abs().max())
        check(dpose <= POSE_TOL, f"card vs CPU pose differs by {dpose}")
        print(f"cpu vs card: {CPU_FRAMES} frames, counts and keypoints "
              f"equal, pose max diff {dpose:.2e} (tolerance {POSE_TOL})",
              flush=True)

        # ---- phase 4b: the VO descriptor swap set -------------------
        Ls, Rs = LW[:SWAP_FRAMES], RW[:SWAP_FRAMES]
        swap_ms = {}
        for name, use_subpix in SWAP:
            label = name + ("+subpix" if use_subpix else "")
            c = cfg.replace(descriptor=name, subpix=use_subpix)
            binary = c.desc_norm == "hamming"
            torch.cuda.synchronize()
            reset_counts()
            s = vo.init_state(rig, c, seed=0, device=dev)
            s, o = vo.run_sequence(s, Ls, Rs, rig, c)
            torch.cuda.synchronize()
            launches = by_path[f"vo {label}"] = read_counts()
            n = SWAP_FRAMES
            expect = {"fast_grid": n, "brief_planes": 0,
                      "brief_keypoints": n if name == "brief" else 0,
                      "match_reduce": 2 * n if binary else 0,
                      "fast_detect": 0, "fast_margins": 0}
            check(launches == expect,
                  f"{label}: launches {launches}, want {expect}")
            check((s.prev.packed is None) == (not binary)
                  and s.prev.bits.shape == (cfg.grid.capacity, c.desc_dim),
                  f"{label}: descriptor layout")
            poses = o.pose.cpu()
            check(bool(torch.isfinite(poses).all()), f"{label}: non-finite "
                  "pose")
            ok_frac = float(o.motion_ok.float().mean())
            check(ok_frac >= 0.9, f"{label}: motion_ok on {ok_frac:.0%}")
            t_final = poses[-1, :3, 3].double()
            t_true = torch.tensor([(n - 1) * step_m, 0.0, 0.0],
                                  dtype=torch.float64)
            drift = float((t_final - t_true).norm())
            rot = float(se3.rotation_geodesic_error(poses[-1, :3, :3],
                                                    torch.eye(3)))
            check(drift < 0.05 * float(t_true.norm()) and rot < 0.01,
                  f"{label}: final position {t_final.tolist()} vs "
                  f"{t_true.tolist()}, rotation error {rot}")
            timed = []
            for _ in range(3):
                st = vo.init_state(rig, c, seed=0, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vo.run_sequence(st, Ls, Rs, rig, c)
                torch.cuda.synchronize()
                timed.append((time.perf_counter() - t0) / n * 1e3)
            swap_ms[label] = min(timed)
            print(f"VO {label}: {n} frames, launches {launches}, motion_ok "
                  f"{ok_frac:.0%}, drift {drift:.4f} m, rot {rot:.2e} rad, "
                  f"mean stereo {float(o.n_stereo.float().mean()):.0f}, "
                  f"inliers {float(o.n_inliers.float().mean()):.0f}; "
                  f"{swap_ms[label]:.3f} ms/frame (runs "
                  f"{[round(x, 3) for x in timed]}; brief "
                  f"{ms_frame:.3f} in phase 3) [{card}]", flush=True)

            # the same frames on the CPU
            res = {}
            for d in ("cuda", "cpu"):
                st = vo.init_state(rig, c, seed=0, device=d)
                res[d] = vo.run_sequence(st, lefts[:CPU_FRAMES],
                                         rights[:CPU_FRAMES], rig, c)
            (sg, og), (sc, oc) = res["cuda"], res["cpu"]
            for f in ("n_detect_l", "n_detect_r"):
                check(torch.equal(getattr(og, f).cpu(), getattr(oc, f)),
                      f"{label}: card vs CPU {f}")
            kp_diff = float((sg.prev.kps.xy.cpu() - sc.prev.kps.xy).abs()
                            .max())
            check(torch.equal(sg.prev.kps.valid.cpu(), sc.prev.kps.valid)
                  and torch.equal(sg.prev.kps.score.cpu(), sc.prev.kps.score)
                  and kp_diff <= (SUBPIX_TOL if use_subpix else 0.0),
                  f"{label}: card vs CPU keypoints (xy differ by {kp_diff})")
            if binary:
                desc_diff = float((sg.prev.bits.cpu() != sc.prev.bits)
                                  .float().mean())
                desc_tol, what = BIT_SHARE, "share of bits differing"
            else:
                desc_diff = float((sg.prev.bits.cpu() - sc.prev.bits).abs()
                                  .max())
                desc_tol, what = SURF_TOL, "largest value difference"
            check(desc_diff <= desc_tol, f"{label}: card vs CPU descriptors, "
                  f"{what} {desc_diff} (tolerance {desc_tol})")
            exact = desc_diff == 0.0 and kp_diff == 0.0
            count_diff = 0.0
            for f in ("n_stereo", "n_tracks"):
                a, b = getattr(og, f).cpu(), getattr(oc, f)
                count_diff = max(count_diff, float(
                    ((a - b).abs() / b.clamp(min=1)).max()))
            dpose = float((og.pose.cpu() - oc.pose).abs().max())
            count_tol = 0.0 if exact else COUNT_SHARE
            pose_tol = POSE_TOL if count_diff == 0.0 else SWAP_POSE_TOL
            check(count_diff <= count_tol and dpose <= pose_tol,
                  f"{label}: card vs CPU stereo/track counts differ by "
                  f"{count_diff:.2%} (tolerance {count_tol:.0%}), poses by "
                  f"{dpose} (tolerance {pose_tol})")
            print(f"VO {label} cpu vs card: {CPU_FRAMES} frames, detections "
                  f"equal, keypoints differ by {kp_diff:.2e} px, {what} "
                  f"{desc_diff:.2e} (tolerance {desc_tol}), stereo/track "
                  f"counts by {count_diff:.2%} (tolerance {count_tol:.0%}), "
                  f"pose max diff {dpose:.2e} (tolerance {pose_tol})",
                  flush=True)

        # ---- phase 4c: the essential-matrix egomotion ---------------
        # (a) the synthetic pan: a single fronto-parallel plane, on which
        # the 8-point E is not determined; the LM polish fixes the pose
        ecfg = cfg.replace(motion="essential")
        n = SWAP_FRAMES
        torch.cuda.synchronize()
        reset_counts()
        s, o = vo.run_sequence(vo.init_state(rig, ecfg, seed=0, device=dev),
                               Ls, Rs, rig, ecfg)
        torch.cuda.synchronize()
        launches = by_path["vo essential"] = read_counts()
        expect = {"fast_grid": n, "brief_planes": 0, "brief_keypoints": n,
                  "match_reduce": 2 * n, "fast_detect": 0, "fast_margins": 0}
        check(launches == expect,
              f"essential: launches {launches}, want {expect}")
        poses = o.pose.cpu()
        check(bool(torch.isfinite(poses).all()), "essential: non-finite pose")
        ok_frac = float(o.motion_ok.float().mean())
        check(ok_frac >= 0.9, f"essential: motion_ok on {ok_frac:.0%}")
        t_final = poses[-1, :3, 3].double()
        t_true = torch.tensor([(n - 1) * step_m, 0.0, 0.0],
                              dtype=torch.float64)
        drift = float((t_final - t_true).norm())
        rot = float(se3.rotation_geodesic_error(poses[-1, :3, :3],
                                                torch.eye(3)))
        check(drift < 0.05 * float(t_true.norm()) and rot < 0.01,
              f"essential: final position {t_final.tolist()} vs "
              f"{t_true.tolist()}, rotation error {rot}")
        timed = []
        for _ in range(3):
            st = vo.init_state(rig, ecfg, seed=0, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vo.run_sequence(st, Ls, Rs, rig, ecfg)
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0) / n * 1e3)
        ess_ms = min(timed)
        print(f"VO essential: {n} frames, launches {launches}, motion_ok "
              f"{ok_frac:.0%}, drift {drift:.4f} m, rot {rot:.2e} rad, mean "
              f"inliers {float(o.n_inliers.float().mean()):.0f}; "
              f"{ess_ms:.3f} ms/frame (runs {[round(x, 3) for x in timed]}; "
              f"rigid brief {ms_frame:.3f} in phase 3) [{card}]", flush=True)

        # (b) the rendered corridor, through the start of its 180° turn:
        # the rotation-rich world the essential path is meant for; ATE
        # after a rigid alignment, beside the rigid path's on the frames
        scene = render.corridor_scene(np.random.RandomState(11),
                                      tex_size=1024, capped=True,
                                      uniform_texel_scale=True)
        gt = render.corridor_trajectory_reversal(120, turn_frames=48)[
            CORRIDOR_FRAMES]
        t0 = time.perf_counter()
        cl, cr = render.render_stereo_sequence(scene, rig, gt)
        render_s = time.perf_counter() - t0
        CL, CR = torch.as_tensor(cl).to(dev), torch.as_tensor(cr).to(dev)
        ates = {}
        for label, c in (("essential", ecfg), ("rigid", cfg)):
            st = vo.init_state(rig, c, seed=0, device=dev)
            _, oc_ = vo.run_sequence(st, CL, CR, rig, c)
            cp = oc_.pose.cpu().numpy()
            check(np.isfinite(cp).all(), f"corridor {label}: non-finite pose")
            ates[label] = (ate_rmse(cp, gt),
                           float(oc_.motion_ok.float().mean()),
                           float(oc_.n_inliers.float().mean()))
        g_rel = np.linalg.inv(gt[0]) @ gt
        path = float(np.linalg.norm(np.diff(g_rel[:, :3, 3], axis=0),
                                    axis=1).sum())
        yaw = float(np.degrees(np.arccos(np.clip(
            (np.trace(g_rel[-1, :3, :3]) - 1) / 2, -1, 1))))
        ate_e = ates["essential"][0]
        check(ate_e < 0.1 * path and ates["essential"][1] >= 0.9,
              f"corridor essential: ATE {ate_e:.4f} m over a {path:.3f} m "
              f"path, motion_ok {ates['essential'][1]:.0%}")
        print(f"VO essential, rendered corridor: {len(gt)} frames "
              f"({path:.3f} m, {yaw:.1f} deg of yaw; rendered in "
              f"{render_s:.1f} s), ATE essential {ate_e:.4f} m (motion_ok "
              f"{ates['essential'][1]:.0%}, mean inliers "
              f"{ates['essential'][2]:.0f}), rigid {ates['rigid'][0]:.4f} m "
              f"(motion_ok {ates['rigid'][1]:.0%}, mean inliers "
              f"{ates['rigid'][2]:.0f})", flush=True)

        # (c) the first frames of the pan on the CPU, the same draws
        res = {}
        for d in ("cuda", "cpu"):
            st = vo.init_state(rig, ecfg, seed=0, device=d)
            res[d] = vo.run_sequence(st, lefts[:CPU_FRAMES],
                                     rights[:CPU_FRAMES], rig, ecfg)
        (sg, og), (sc, oc) = res["cuda"], res["cpu"]
        for f in ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks"):
            check(torch.equal(getattr(og, f).cpu(), getattr(oc, f)),
                  f"essential: card vs CPU {f}")
        for f in ("xy", "score", "valid"):
            check(torch.equal(getattr(sg.prev.kps, f).cpu(),
                              getattr(sc.prev.kps, f)),
                  f"essential: card vs CPU keypoints.{f}")
        dpose = float((og.pose.cpu() - oc.pose).abs().max())
        check(torch.equal(og.n_inliers.cpu(), oc.n_inliers)
              and dpose <= ESS_POSE_TOL,
              f"essential: card vs CPU inlier counts {og.n_inliers.tolist()} "
              f"vs {oc.n_inliers.tolist()}, poses {dpose} apart (tolerance "
              f"{ESS_POSE_TOL})")
        print(f"VO essential cpu vs card: {CPU_FRAMES} frames, detections, "
              f"keypoints, stereo, track and inlier counts equal, pose max "
              f"diff {dpose:.2e} (tolerance {ESS_POSE_TOL})", flush=True)

        # (d) the 5-point solver on one KITTI-sized correspondence set
        rs5 = np.random.RandomState(21)
        n5 = 2304
        X5 = np.stack([rs5.uniform(-8, 8, n5), rs5.uniform(-2, 2, n5),
                       rs5.uniform(4, 40, n5)], -1)
        R5 = se3.so3_exp(torch.tensor([0.01, 0.04, -0.005],
                                      dtype=torch.float64)).numpy()
        T5 = np.array([0.05, -0.01, 0.9])
        Xb5 = X5 @ R5.T + T5
        pp = np.array([rig.cx, rig.cy])
        uva5 = X5[:, :2] / X5[:, 2:] * rig.fx + pp
        uvb5 = Xb5[:, :2] / Xb5[:, 2:] * rig.fx + pp
        bad5 = rs5.uniform(size=n5) < 0.3
        uvb5[bad5] += rs5.uniform(-40, 40, (bad5.sum(), 2))
        args5 = [torch.as_tensor(a, dtype=torch.float32)
                 for a in (uva5, uvb5, X5, Xb5)]
        valid5 = torch.ones(n5, dtype=torch.bool)

        def five(d):
            sampler = ransac.InverseCdfSampler(
                torch.Generator().manual_seed(5))
            return essential.essential_scaled_motion(
                sampler, *[a.to(d) for a in args5], valid5.to(d), rig,
                n_hyps=64, solver="five_point")

        five_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r5 = five(dev)
            torch.cuda.synchronize()
            five_ms.append((time.perf_counter() - t0) * 1e3)
        r5c = five("cpu")
        ang5 = float(se3.rotation_geodesic_error(r5.R.cpu(), r5c.R))
        apart5 = float((r5.inliers.cpu() != r5c.inliers).float().mean())
        err5 = float(se3.rotation_geodesic_error(
            r5.R.cpu().double(), torch.as_tensor(R5)))
        check(ang5 <= FIVE_POINT_ANGLE and apart5 <= FIVE_POINT_SHARE
              and err5 < 5e-3 and int(r5.n_inliers) > 0.9 * (~bad5).sum(),
              f"5-point: card vs CPU R {ang5:.2e} rad (tolerance "
              f"{FIVE_POINT_ANGLE}), inlier sets {apart5:.2%} apart "
              f"(tolerance {FIVE_POINT_SHARE:.0%}), R {err5:.2e} rad from "
              f"the truth, {int(r5.n_inliers)} inliers")
        print(f"5-point: {n5} correspondences, 30 % outliers, 64 minimal "
              f"sets: {int(r5.n_inliers)} inliers ({int((~bad5).sum())} "
              f"true), R {err5:.2e} rad from the truth; card vs CPU R "
              f"{ang5:.2e} rad, inlier sets {apart5:.2%} apart; "
              f"{min(five_ms):.3f} ms per call (runs "
              f"{[round(x, 3) for x in five_ms]}) [{card}]", flush=True)

        # ---- phase 5: the service path ------------------------------
        dtab = features.detector_table()
        fam_ids = {f: features.ids_for(f, dtab)
                   for f in ("FAST", "ORB", "BRISK", "SURF", "AKAZE")}
        check({f: len(v) for f, v in fam_ids.items()}
              == {"FAST": 354, "ORB": 270, "BRISK": 88, "SURF": 432,
                  "AKAZE": 64}, "detector table")
        sweep = sum(fam_ids.values(), [])
        check(len(sweep) == len(dtab) == 1208, f"{len(sweep)} swept IDs")
        akaze_groups = {(dtab[i]["Param"]["n_octaves"],
                         dtab[i]["Param"]["n_octave_layers"],
                         dtab[i]["Param"]["diffusivity"])
                        for i in fam_ids["AKAZE"]}
        surf_groups = {(dtab[i]["Param"]["n_octaves"],
                        dtab[i]["Param"]["n_octave_layers"])
                       for i in fam_ids["SURF"]}
        # one margin launch per circle type and image; one detect launch
        # per pyramid level (ORB layout) or octave (BRISK) and image; SURF's
        # Hessian maps and AKAZE's scale spaces launch none of the kernels
        orb_groups = {(dtab[i]["Param"]["n_levels"],
                       dtab[i]["Param"]["scale_factor"],
                       dtab[i]["Param"]["edge_threshold"])
                      for i in fam_ids["ORB"]}
        brisk_groups = {max(1, dtab[i]["Param"]["n_octaves"])
                        for i in fam_ids["BRISK"]}
        types = {dtab[i]["Param"]["d_type"] for i in fam_ids["FAST"]}
        want_margins = 2 * len(types)
        want_detect = 2 * (sum(g[0] for g in orb_groups) + sum(brisk_groups))
        left0, right0 = lefts[0], rights[0]
        services.single_image_detection(sweep[::40], left0, right0,
                                        device=dev)          # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        recs = services.single_image_detection(sweep, left0, right0,
                                               device=dev)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        got_counts = read_counts()
        print(f"service sweep: {len(sweep)} IDs in {sweep_s:.3f} s; launches "
              f"fast_margins {got_counts['fast_margins']} (derived "
              f"{want_margins} = 2 images x {len(types)} circle types), "
              f"fast_detect {got_counts['fast_detect']} (derived "
              f"{want_detect} = 2 images x levels of {len(orb_groups)} ORB "
              f"layouts + octaves of {len(brisk_groups)} BRISK layouts); "
              f"{len(surf_groups)} SURF layouts, {len(akaze_groups)} AKAZE "
              f"groups", flush=True)
        check(got_counts["fast_margins"] == want_margins
              and got_counts["fast_detect"] == want_detect,
              f"service launches {got_counts}")
        check(all(r["supported"] for r in recs), "an ID came back unsupported")
        check([r["detID"] for r in recs] == sweep, "record order")
        check(not any(r["approximate"] for r in recs if
                      dtab[r["detID"]]["Name"] in ("FAST", "BRISK", "AKAZE")),
              "a FAST/BRISK/AKAZE record flagged approximate")
        n_approx = {f: sum(r["approximate"] for r in recs
                           if dtab[r["detID"]]["Name"] == f)
                    for f in ("ORB", "SURF")}
        rec_of = {r["detID"]: r for r in recs}
        fam_ms = {}
        for fam, ids in fam_ids.items():
            secs = [rec_of[i]["processingTime"][0]["seconds"] for i in ids]
            fam_ms[fam] = 1e3 * sum(secs) / len(ids)
        print("service: ms per swept ID (both images): "
              + ", ".join(f"{f} {v:.3f}" for f, v in fam_ms.items())
              + f" [{card}]; records flagged approximate {n_approx}",
              flush=True)
        # counts fall as the threshold rises wherever that is a theorem:
        # without NMS always; with NMS for the 16-point circle, whose gate
        # IS its score (for 12/8 points a corner with a high score and a
        # low gate can drop out first and free a neighbour, so there the
        # outcome is only printed)
        rises = {}
        for ft in sorted(types):
            for nms in (True, False):
                ids = [i for i in fam_ids["FAST"]
                       if dtab[i]["Param"]["d_type"] == ft and
                       dtab[i]["Param"]["non_maximum_suppression"] == nms]
                ids.sort(key=lambda i: dtab[i]["Param"]["threshold"])
                c = [rec_of[i]["leftFeatures"]["nPoints"] for i in ids]
                up = sum(b > a for a, b in zip(c, c[1:]))
                rises[f"{ft}/{'nms' if nms else 'raw'}"] = up
                if not nms or ft == "9_16":
                    check(up == 0, f"FAST {ft} nms={nms}: count rises with "
                          f"the threshold: {c}")
                check(c[0] > 1000 or ft == "5_8", f"FAST {ft}: counts {c[:3]}")
        print(f"service: FAST count rises along the threshold {rises}",
              flush=True)
        # an AKAZE group thresholds one map: counts never rise
        for g in sorted(akaze_groups):
            ids = sorted((i for i in fam_ids["AKAZE"]
                          if (dtab[i]["Param"]["n_octaves"],
                              dtab[i]["Param"]["n_octave_layers"],
                              dtab[i]["Param"]["diffusivity"]) == g),
                         key=lambda i: dtab[i]["Param"]["threshold"])
            for side in ("leftFeatures", "rightFeatures"):
                c = [rec_of[i][side]["nPoints"] for i in ids]
                check(c == sorted(c, reverse=True) and c[-1] > 0,
                      f"AKAZE {g} {side}: counts {c}")

        t0 = time.perf_counter()
        recs_cpu = services.single_image_detection(sweep, left0, right0,
                                                   device="cpu")
        print(f"service sweep on the CPU: {time.perf_counter() - t0:.1f} s",
              flush=True)
        # the card's and the CPU's pyramid images
        l0c = torch.as_tensor(left0)
        level_diff = 0.0
        for sf in sorted({g[1] for g in orb_groups}):
            for lvl in range(1, max(g[0] for g in orb_groups)):
                h, w = orb.level_shape(H, W, lvl, sf)
                d = (image.resize_linear(img0, h, w).cpu()
                     - image.resize_linear(l0c, h, w)).abs().max()
                level_diff = max(level_diff, float(d))
        oct_diff, lc, lg = 0.0, l0c, img0
        for _ in range(1, max(brisk_groups)):
            lc, lg = brisk.next_octave(lc), brisk.next_octave(lg)
            oct_diff = max(oct_diff, float((lg.cpu() - lc).abs().max()))
        print(f"service: card vs CPU level images, largest difference: ORB "
              f"levels >= 1 {level_diff:.3e}, BRISK octaves >= 1 "
              f"{oct_diff:.3e}", flush=True)
        # SURF's integral image is exact on both (float64 scans of an
        # integer image), its Hessian maps elementwise: exact
        # AKAZE: its divisions stay true divisions on the card
        # (`utils.precision.true_div`), so its maps are the CPU's
        worst = {"FAST": 0.0, "ORB": 0.0, "BRISK": 0.0, "SURF": 0.0,
                 "AKAZE": 0.0}
        for g, c in zip(recs, recs_cpu):
            fam = dtab[g["detID"]]["Name"]
            exact = (fam in ("FAST", "SURF")
                     or (fam == "ORB" and level_diff == 0.0)
                     or (fam == "BRISK" and oct_diff == 0.0)
                     or fam == "AKAZE")
            check(g["approximate"] == c["approximate"] or not exact,
                  f"{g['detID']}: approximate flag differs")
            for side in ("leftFeatures", "rightFeatures"):
                a, b = g[side], c[side]
                rel = abs(a["nPoints"] - b["nPoints"]) / max(b["nPoints"], 1)
                worst[fam] = max(worst[fam], rel)
                if exact:
                    check(a["nPoints"] == b["nPoints"] and
                          features_close(a, b, 1e-3),
                          f"{g['detID']} {side}: card {a} vs CPU {b}")
                else:
                    check(rel <= 0.005 or abs(a["nPoints"] - b["nPoints"])
                          <= 2, f"{g['detID']} {side}: card {a} vs CPU {b}")
        print(f"service: card vs CPU, largest relative count difference "
              f"{worst} (FAST, SURF and AKAZE exact; ORB and BRISK exact "
              f"when their level images are equal, else within 0.5 %)",
              flush=True)

        ds = features.descriptor_table()
        det_id = [i for i in fam_ids["FAST"] if dtab[i]["Param"] == dict(
            threshold=15, d_type="9_16", non_maximum_suppression=True)][0]
        pairs = {"BRIEF-32": [i for i in features.ids_for("BRIEF", ds)
                              if ds[i]["Param"]["bytes"] == 32][0],
                 "ORB": features.ids_for("ORB", ds)[0]}
        for label, desc_id in pairs.items():
            out = {}
            for d in (dev, "cpu"):
                (kl, dl), (kr, dr) = services.get_stereo_features(
                    det_id, desc_id, left0, right0, device=d)
                out[str(d)] = (kl, dl, kr, dr,
                               services.stereo_matching(kl, dl, kr, dr))
            (kl, dl, kr, dr, m), (ckl, cdl, ckr, cdr, cm) = out.values()
            for f in ("xy", "score", "valid"):
                check(torch.equal(getattr(kl, f).cpu(), getattr(ckl, f))
                      and torch.equal(getattr(kr, f).cpu(), getattr(ckr, f)),
                      f"stereo features ({label}): keypoints.{f} differ")
            flipped = float((dl.bits.cpu() != cdl.bits).float().mean())
            agree = float((m.valid.cpu() == cm.valid).float().mean())
            both = m.valid.cpu() & cm.valid
            same_idx = bool((m.train_idx.cpu()[both]
                             == cm.train_idx[both]).all())
            n_match = int(cm.valid.sum())
            check(n_match > 300, f"stereo matching ({label}): {n_match}")
            if flipped == 0.0:
                check(agree == 1.0 and same_idx,
                      f"stereo matching ({label}): card != CPU")
            else:   # ORB only: the moment convolution sums in another order
                check(label == "ORB" and flipped < 1e-3 and agree > 0.99,
                      f"stereo features ({label}): {flipped:.2e} of bits "
                      f"flipped, matches agree on {agree:.4f}")
            print(f"service: stereo features + matching (FAST, {label}): "
                  f"{n_match} matches, card vs CPU bits flipped "
                  f"{flipped:.2e}, match masks agree {agree:.4f}", flush=True)
        torch.cuda.synchronize()
        by_path["service"] = read_counts()
        expect = {"fast_margins": want_margins, "fast_detect": want_detect,
                  "fast_grid": 4, "brief_planes": 0, "brief_keypoints": 2,
                  "match_reduce": 2}
        check(by_path["service"] == expect,
              f"service launches {by_path['service']}, want {expect}")

        # ---- phase 5b: AKAZE and SIFT, detection and description ----
        img_c = torch.as_tensor(left0)
        for label, run_dd in (
                ("AKAZE mldb", lambda im: akaze.detect_and_describe(im)),
                ("AKAZE msurf", lambda im: akaze.detect_and_describe(
                    im, descriptor="msurf")),
                ("SIFT", lambda im: sift.detect_and_describe(im))):
            (dg, Dg), (dg2, Dg2) = run_dd(img0), run_dd(img0)
            torch.cuda.synchronize()
            check(torch.equal(dg.keypoints.xy, dg2.keypoints.xy)
                  and torch.equal(dg.keypoints.angle, dg2.keypoints.angle)
                  and torch.equal(Dg.bits, Dg2.bits),
                  f"{label}: two card runs differ")
            dd_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_dd(img0)
                torch.cuda.synchronize()
                dd_ms.append((time.perf_counter() - t0) * 1e3)
            dc, Dc = run_dd(img_c)
            kg, kc = dg.keypoints, dc.keypoints
            n_kp = int(kc.valid.sum())
            check(n_kp > 100, f"{label}: {n_kp} keypoints")
            for f in ("xy", "score", "valid"):
                check(torch.equal(getattr(kg, f).cpu(), getattr(kc, f)),
                      f"{label}: card vs CPU keypoints.{f}")
            dang = (kg.angle.cpu() - kc.angle).abs()
            same_ang = dang <= 1e-5
            ang_share = float((~same_ang).float().mean())
            check(ang_share <= ANGLE_SHARE, f"{label}: {ang_share:.2%} of "
                  f"orientations differ (tolerance {ANGLE_SHARE:.1%})")
            if Dc.norm == "hamming":
                d_err = float((Dg.bits.cpu() != Dc.bits).float().mean())
                d_tol, what = BIT_SHARE, "share of bits differing"
            else:
                d_err = float((Dg.bits.cpu() - Dc.bits)[same_ang].abs().max())
                d_tol, what = SURF_TOL, ("largest value difference where "
                                         "the orientations agree")
            check(d_err <= d_tol, f"{label}: card vs CPU descriptors, {what} "
                  f"{d_err} (tolerance {d_tol})")
            print(f"{label} detect_and_describe on frame 0's left image: "
                  f"{n_kp} keypoints, card twice identical; card vs CPU "
                  f"keypoints equal, orientations differing on "
                  f"{ang_share:.2%} (largest {float(dang.max()):.2e} rad), "
                  f"{what} {d_err:.2e} (tolerance {d_tol}); "
                  f"{min(dd_ms):.3f} ms per image (runs "
                  f"{[round(x, 3) for x in dd_ms]}) [{card}]", flush=True)

        # ---- phase 6: the windowed path ----------------------------
        wcfg = window_vo.WindowVOConfig.create(cfg)
        check((wcfg.tracker.window, wcfg.tracker.capacity, wcfg.ba_every,
               wcfg.ba_iters, wcfg.ba_max_landmarks) == (3, 4608, 1, 6, 1024),
              f"windowed configuration {wcfg}")
        n_w = WINDOW_FRAMES
        reset_counts()
        ws = window_vo.init_state(rig, wcfg, seed=0, device=dev)
        ws, wouts = window_vo.run_sequence(ws, LW, RW, rig, wcfg)
        torch.cuda.synchronize()
        by_path["window"] = read_counts()
        expect = {"fast_grid": n_w, "brief_planes": 0,
                  "brief_keypoints": n_w, "match_reduce": 3 * n_w,
                  "fast_detect": 0, "fast_margins": 0}
        check(by_path["window"] == expect,
              f"windowed launches {by_path['window']}, want {expect}")
        ran = wouts.ba_ran.cpu().tolist()
        check(ran == [False, False] + [True] * (n_w - 2),
              f"BA did not run on every full-window frame: {ran}")
        wposes = wouts.frame.pose.cpu()
        check(bool(torch.isfinite(wposes).all()), "windowed: non-finite pose")
        t_final = wposes[-1, :3, 3].double()
        t_true = torch.tensor([(n_w - 1) * step_m, 0.0, 0.0],
                              dtype=torch.float64)
        drift = float((t_final - t_true).norm())
        check(drift < 0.05 * float(t_true.norm()),
              f"windowed final position {t_final.tolist()} vs "
              f"{t_true.tolist()}")
        rms = wouts.ba_rms_px.cpu()[2:]
        check(bool(torch.isfinite(rms).all()) and float(rms.max()) < 1.0,
              f"ba_rms_px {rms.tolist()}")
        check(int(wouts.n_tracked[1:].min()) > 100,
              f"n_tracked {wouts.n_tracked.tolist()}")
        print(f"windowed path: {n_w} frames, launches {by_path['window']}, "
              f"BA on {sum(ran)} frames, final t {t_final.tolist()} (true "
              f"{t_true.tolist()}), drift {drift:.4f} m, ba_rms_px mean "
              f"{float(rms.mean()):.3e} max {float(rms.max()):.3e}, n_tracked "
              f"mean {float(wouts.n_tracked[1:].float().mean()):.0f}, n_new "
              f"mean {float(wouts.n_new[1:].float().mean()):.0f}", flush=True)
        # the tracker's association, the windowed path's third match launch:
        # the last frame's features against the 4608-slot store
        prev, store = ws.vo.prev, ws.win.store
        recent = store.valid & (ws.win.frame_idx - store.last_seen
                                <= wcfg.tracker.max_age)
        args = (prev.packed, store.packed, prev.kps.xy, store.xy,
                prev.kps.valid & prev.stereo_valid, recent)
        kw = dict(mode="roi", p1=wcfg.tracker.roi_box)
        check(args[0].shape == (2304, 8) and args[1].shape == (4608, 8),
              f"tracker match shapes {tuple(args[0].shape)}, "
              f"{tuple(args[1].shape)}")
        tr = match_case(args, kw, "tracker association, 2304 x 4608")
        check(int((match_reduce.match_reduce(*args, **kw)[0] < 32).sum())
              > 1000, "match_reduce (tracker association): too few close rows")
        mk = [k for k in kernels if k["name"] == "match_reduce"][0]
        mk["max_abs_err"] = max(mk["max_abs_err"], tr["err"])
        mk["ms_tracker"], mk["plain_ms_tracker"] = tr["ms"], tr["plain"]

        timed = []
        for _ in range(3):
            s = window_vo.init_state(rig, wcfg, seed=0, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window_vo.run_sequence(s, LW, RW, rig, wcfg)
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0) / n_w * 1e3)
        print(f"window_vo_step: {min(timed):.3f} ms/frame "
              f"({1e3 / min(timed):.1f} fps) at {H}x{W}, runs "
              f"{[round(x, 3) for x in timed]} ms/frame [{card}]", flush=True)

        res = {}
        for d in ("cuda", "cpu"):
            s = window_vo.init_state(rig, wcfg, seed=0, device=d)
            res[d] = window_vo.run_sequence(s, lefts[:CPU_FRAMES],
                                            rights[:CPU_FRAMES], rig, wcfg)
        (sg, og), (sc, oc) = res["cuda"], res["cpu"]
        for f in ("n_tracked", "n_new", "ba_ran"):
            check(torch.equal(getattr(og, f).cpu(), getattr(oc, f)),
                  f"windowed card vs CPU {f}: {getattr(og, f).tolist()} vs "
                  f"{getattr(oc, f).tolist()}")
        for f in ("valid", "last_seen", "track_len", "vis", "xy", "meas"):
            check(torch.equal(getattr(sg.win.store, f).cpu(),
                              getattr(sc.win.store, f)),
                  f"windowed card vs CPU store.{f}")
        check(same(torch, sg.win.store.packed.cpu(), sc.win.store.packed),
              "windowed card vs CPU store descriptors")
        dpose = float((og.frame.pose.cpu() - oc.frame.pose).abs().max())
        check(dpose <= POSE_TOL, f"windowed card vs CPU pose differs by "
              f"{dpose}")
        print(f"windowed cpu vs card: {CPU_FRAMES} frames, counts and store "
              f"slots equal, pose max diff {dpose:.2e} (tolerance "
              f"{POSE_TOL})", flush=True)

        # the windowed path with SURF: a float landmark store, associations
        # on the L2 distance matrix, no match launch
        n_s = WINDOW_SURF_FRAMES
        scfg = window_vo.WindowVOConfig.create(cfg.replace(descriptor="surf"))
        check(scfg.tracker.norm == "l2" and scfg.tracker.desc_bits == 64,
              f"windowed SURF configuration {scfg.tracker}")
        reset_counts()
        ws, wouts = window_vo.run_sequence(
            window_vo.init_state(rig, scfg, seed=0, device=dev),
            LW[:n_s], RW[:n_s], rig, scfg)
        torch.cuda.synchronize()
        by_path["window surf"] = read_counts()
        expect = {"fast_grid": n_s, "brief_planes": 0, "brief_keypoints": 0,
                  "match_reduce": 0, "fast_detect": 0, "fast_margins": 0}
        check(by_path["window surf"] == expect,
              f"windowed SURF launches {by_path['window surf']}, want "
              f"{expect}")
        store = ws.win.store
        check(store.packed is None and store.bits.shape == (4608, 64)
              and bool(store.valid.any()), "windowed SURF store layout")
        norms = store.bits[store.valid].norm(dim=-1)
        check(float((norms - 1).abs().max()) < 1e-4, "SURF store holds "
              "descriptors that are not unit vectors")
        ran = wouts.ba_ran.cpu().tolist()
        check(ran == [False, False] + [True] * (n_s - 2),
              f"windowed SURF: BA runs {ran}")
        wposes = wouts.frame.pose.cpu()
        check(bool(torch.isfinite(wposes).all()), "windowed SURF: non-finite "
              "pose")
        t_final = wposes[-1, :3, 3].double()
        t_true = torch.tensor([(n_s - 1) * step_m, 0.0, 0.0],
                              dtype=torch.float64)
        drift = float((t_final - t_true).norm())
        check(drift < 0.05 * float(t_true.norm()),
              f"windowed SURF final position {t_final.tolist()} vs "
              f"{t_true.tolist()}")
        rms = wouts.ba_rms_px.cpu()[2:]
        check(bool(torch.isfinite(rms).all()) and float(rms.max()) < 1.0,
              f"windowed SURF ba_rms_px {rms.tolist()}")
        check(int(wouts.n_tracked[1:].min()) > 100,
              f"windowed SURF n_tracked {wouts.n_tracked.tolist()}")
        t0 = time.perf_counter()
        window_vo.run_sequence(
            window_vo.init_state(rig, scfg, seed=0, device=dev),
            LW[:n_s], RW[:n_s], rig, scfg)
        torch.cuda.synchronize()
        surf_window_ms = (time.perf_counter() - t0) / n_s * 1e3
        print(f"windowed path, SURF: {n_s} frames, launches "
              f"{by_path['window surf']}, BA on {sum(ran)} frames, drift "
              f"{drift:.4f} m, ba_rms_px max {float(rms.max()):.3e}, "
              f"n_tracked mean {float(wouts.n_tracked[1:].float().mean()):.0f}"
              f", {surf_window_ms:.3f} ms/frame (second run) [{card}]",
              flush=True)

        # the tracker's association at 16 words: a short windowed FREAK run
        # (3 match launches a frame), then its last frame against the store
        n_f = 4
        fcfg = window_vo.WindowVOConfig.create(cfg16)
        reset_counts()
        ws, wouts = window_vo.run_sequence(
            window_vo.init_state(rig, fcfg, seed=0, device=dev),
            LW[:n_f], RW[:n_f], rig, fcfg)
        torch.cuda.synchronize()
        by_path["window freak"] = read_counts()
        expect = {"fast_grid": n_f, "brief_planes": 0, "brief_keypoints": 0,
                  "match_reduce": 3 * n_f, "fast_detect": 0,
                  "fast_margins": 0}
        check(by_path["window freak"] == expect,
              f"windowed FREAK launches {by_path['window freak']}, want "
              f"{expect}")
        check(int(wouts.n_tracked[1:].min()) > 100,
              f"windowed FREAK n_tracked {wouts.n_tracked.tolist()}")
        prev, store = ws.vo.prev, ws.win.store
        recent = store.valid & (ws.win.frame_idx - store.last_seen
                                <= fcfg.tracker.max_age)
        args = (prev.packed, store.packed, prev.kps.xy, store.xy,
                prev.kps.valid & prev.stereo_valid, recent)
        check(args[0].shape == (2304, 16) and args[1].shape == (4608, 16),
              f"16-word tracker match shapes {tuple(args[0].shape)}, "
              f"{tuple(args[1].shape)}")
        tr16 = match_case(args, dict(mode="roi", p1=fcfg.tracker.roi_box),
                          "tracker association, 2304 x 4608, 16 words")
        mk["max_abs_err"] = max(mk["max_abs_err"], tr16["err"])
        mk["ms_tracker_16w"] = tr16["ms"]
        mk["plain_ms_tracker_16w"] = tr16["plain"]

        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            # ---- phase 7: the command line on disk ------------------
            by_path["cli"], ctx = cli_phase(
                torch, dev, card, lefts, rights, rig, cfg, vo_poses,
                ms_frame, reset_counts, read_counts, tmp)
            # ---- phase 8: studies and distribution ------------------
            paths, m4 = studies_phase(torch, dev, card, tmp, ctx,
                                      reset_counts, read_counts)
            by_path.update(paths)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        mk["max_abs_err"] = max(mk["max_abs_err"], m4["err"])
        mk["ms_stereo_4w"], mk["plain_ms_stereo_4w"] = m4["ms"], m4["plain"]
        # ---- phase 9: the benchmark ----------------------------------
        by_path.update(bench_phase(torch, card, reset_counts, read_counts))
        by_path.update(window_phase(torch, card, reset_counts, read_counts))

    line = []
    for k in kernels:
        by_s, ops_s = k.pop("bound_s")
        name = k["name"]
        line.append(dict(
            k, launches=sum(c[name] for c in by_path.values()),
            launches_by_path={p: c[name] for p, c in by_path.items()},
            bound_ms=max(by_s, ops_s) * 1e3,
            bound_by="bytes" if by_s >= ops_s else "operations"))
        if name in OFF_PATH:
            check(line[-1]["launches"] == 0, f"{name} is launched by a path")
        else:
            check(line[-1]["launches"] > 0, f"{name} was never launched")
            check(line[-1]["launches_by_path"]["cli"] > 0,
                  f"{name} was never launched by the command line")
    for path, names in (("report", ("fast_grid", "brief_keypoints",
                                     "match_reduce")),
                        ("bench", ("fast_grid", "brief_keypoints",
                                   "match_reduce")),
                        ("window", ("fast_grid", "brief_keypoints",
                                    "match_reduce")),
                        ("explore", ("fast_margins",))):
        for name in names:
            check(by_path[path][name] > 0, f"{name} not launched by {path}")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

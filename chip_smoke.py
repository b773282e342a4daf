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
     none;
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
  5. the service path: `services.single_image_detection` over every FAST
     (354), ORB (270) and BRISK (88) ID of the detector table on frame 0's
     pair, then `get_stereo_features` + `stereo_matching` for a (FAST,
     BRIEF-32) and a (FAST, ORB) ID pair; counters reset before and read
     after (6 margin launches, one detect launch per pyramid level, octave
     and image); every record supported, counts monotone in the threshold
     where that is a theorem, everything held against the same calls on
     the CPU; ms per swept ID per family;
  6. the windowed path: `window_vo.run_sequence` over 40 frames with
     `WindowVOConfig.create` defaults (1 grid, 1 keypoint BRIEF, 3 match
     launches per frame), BA on every frame once the window is full,
     trajectory
     within 5 % of the true motion, ms/frame; the match kernel held
     against its twin at the tracker's 2304 × 4608 association; first 3
     frames against the CPU;
  7. a JSON line describing every kernel, the card line, and as the last
     line {"ok": true, "device": {...}}.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 20            # VO path
WINDOW_FRAMES = 40     # windowed path
CPU_FRAMES = 3
POSE_TOL = 1e-4      # card vs CPU: float32 geometry summed in another order

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
SLEEP_CYCLES_S = 1.98e9   # `torch.cuda._sleep` spins this many clocks a second


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


def segment_ops_per_pixel(n: int, K: int) -> tuple[int, int]:
    """(min/max/compare, add/subtract) operations of the full FAST segment
    test per pixel, on the ring's pixel values: per brightness class the
    arc passes (n min or max each), the n - 1 of the other kind and one
    subtraction; the score max; for 12/8-point circles the quick gates (8 +
    7 per class, a subtraction each) and 3 combines."""
    passes = (K - 1).bit_length() - (1 if K & (K - 1) == 0 else 0)
    minmax = 2 * (passes * n + n - 1) + 1
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


def features_close(a, b, tol):
    return (abs(a["X"][0] - b["X"][0]) <= tol
            and abs(a["X"][1] - b["X"][1]) <= tol
            and abs(a["Y"][0] - b["Y"][0]) <= tol
            and abs(a["Y"][1] - b["Y"][1]) <= tol)


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
    from front_end_tpu_torch.ops import brief, brisk, grid, image, match, orb
    from front_end_tpu_torch.ops import fast as fast_ops
    from front_end_tpu_torch.ops.kernels import (_build, brief_keypoints,
                                                 brief_planes, fast_detect,
                                                 fast_grid, fast_margins,
                                                 match_reduce)
    from front_end_tpu_torch.pipeline import vo, window_vo
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
            max_abs_err=err, ms=ms, ms_all_candidates=ms_all,
            ms_no_candidates=ms_none, candidate_share=share,
            plain_ms=plain_ms, bytes=by, ops=sum(per_px) * imgs.numel(),
            bound_s=(by / HBM_BYTES_S, 0.0), library_ms=None))
        print(f"kernel fast_grid: exact (thresholds -inf to 60 and per "
              f"cell, 3 circle types); {ms * 1e3:.1f} us at the path's "
              f"thresholds ({share:.1%} of pixels candidates), "
              f"{ms_all * 1e3:.1f} us with every pixel a candidate, "
              f"{ms_none * 1e3:.1f} us with none, vs plain "
              f"{plain_ms * 1e3:.1f} us; {corners} corners", flush=True)

        sm = brief.smooth(imgs)
        pat = brief.brief_pattern(8 * cfg.desc_bytes)
        got = brief_planes.brief_planes(sm, pat)
        ref = brief_planes.plain(sm, pat)
        torch.cuda.synchronize()
        check(same(torch, got, ref), "brief_planes != plain")
        err = max_abs_err(torch, [got], [ref])
        ms = cuda_ms(torch, lambda: brief_planes.brief_planes(sm, pat), 100)
        plain_ms = cuda_ms(torch, lambda: brief_planes.plain(sm, pat), 5)
        by = sm.numel() * 4 + got.numel() * 4
        ops = sm.numel() * pat.shape[0]
        kernels.append(dict(
            name="brief_planes", route="cuda",
            source="front_end_tpu_torch/csrc/brief_planes.cu",
            replaces="front_end_tpu/ops/pallas/brief_kernel.py:76",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=by, ops=ops,
            bound_s=(by / HBM_BYTES_S, ops / F32_OPS_S), library_ms=None))
        print(f"kernel brief_planes: exact; {ms * 1e3:.1f} us vs plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)

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
        ops = kxy.shape[0] * kxy.shape[1] * n_bits
        kernels.append(dict(
            name="brief_keypoints", route="cuda",
            source="front_end_tpu_torch/csrc/brief_keypoints.cu",
            replaces="front_end_tpu/ops/pallas/brief_kernel.py:76",
            max_abs_err=max(v[1] for v in bk.values()), ms=bk[n_bits][0],
            plain_ms=plain_ms, ms_128=bk[128][0], ms_512=bk[512][0],
            bytes=by, ops=ops, bound_s=(by / HBM_BYTES_S, ops / F32_OPS_S),
            library_ms=None))
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
        pairs = nq * nt
        by = (nq + nt) * (nw * 4 + 8 + 1) + nq * 12 + nt * 8
        # the popcounts run on the tensor cores (an AND and a count per
        # bit); the CUDA cores keep the gate, key and min operations.  The
        # two pipes issue side by side, so the bound is the longer of them
        ops = pairs * (2 * 32 * nw + MATCH_CORE_OPS)
        ops_s = max(pairs * 2 * 32 * nw / TENSOR_INT_OPS_S,
                    pairs * MATCH_CORE_OPS / CORE_OPS_S)
        kernels.append(dict(
            name="match_reduce", route="cuda",
            source="front_end_tpu_torch/csrc/match_reduce.cu",
            replaces="front_end_tpu/ops/pallas/match_kernel.py:110",
            max_abs_err=max(v["err"] for v in times.values()),
            ms=times["stereo"]["ms"], plain_ms=times["stereo"]["plain"],
            ms_roi=times["roi"]["ms"], plain_ms_roi=times["roi"]["plain"],
            bytes=by, ops=ops, bound_s=(by / HBM_BYTES_S, ops_s),
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
        # timed at the shape the service path launches them at: one image
        npix = img0.numel()
        ms = cuda_ms(torch, lambda: fast_margins.fast_margins(img0), 100)
        plain_ms = cuda_ms(torch, lambda: fast_margins.plain(img0), 10)
        by_type = {ft: cuda_ms(
            torch, lambda: fast_margins.fast_margins(img0, ft), 100)
            for ft in ("7_12", "5_8")}
        by, per_px = npix * 12, segment_ops_per_pixel(16, 9)
        kernels.append(dict(
            name="fast_margins", route="cuda",
            source="front_end_tpu_torch/csrc/fast_margins.cu",
            replaces="front_end_tpu/ops/pallas/fast_kernel.py:420",
            max_abs_err=worst_m, ms=ms, plain_ms=plain_ms, ms_7_12=by_type[
                "7_12"], ms_5_8=by_type["5_8"], bytes=by,
            ops=sum(per_px) * npix,
            bound_s=(by / HBM_BYTES_S, fast_ops_seconds(per_px, npix)),
            library_ms=None))
        print(f"kernel fast_margins: exact (3 circle types); {ms * 1e3:.1f} "
              f"us vs plain {plain_ms * 1e3:.1f} us per image", flush=True)
        ms = cuda_ms(torch, lambda: fast_detect.fast_detect(img0, 1.0), 100)
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
            max_abs_err=worst_d, ms=ms, plain_ms=plain_ms, **extra_ms,
            candidate_share=share, ms_orb_levels=level_ms, bytes=by,
            ops=sum(per_px) * npix,
            bound_s=(by / HBM_BYTES_S, 0.0), library_ms=None))
        print(f"kernel fast_detect: exact (3 types x nms x thresholds -inf "
              f"to 60 and a map, {len(held)} level and octave shapes); "
              f"{ms * 1e3:.1f} us at the sweep's threshold 1.0 "
              f"({share:.1%} of pixels candidates), "
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
        poses = outs.pose.cpu()
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

        # ---- phase 5: the service path ------------------------------
        dtab = features.detector_table()
        fam_ids = {f: features.ids_for(f, dtab)
                   for f in ("FAST", "ORB", "BRISK")}
        check({f: len(v) for f, v in fam_ids.items()}
              == {"FAST": 354, "ORB": 270, "BRISK": 88}, "detector table")
        sweep = fam_ids["FAST"] + fam_ids["ORB"] + fam_ids["BRISK"]
        # one margin launch per circle type and image; one detect launch
        # per pyramid level (ORB layout) or octave (BRISK) and image
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
              f"layouts + octaves of {len(brisk_groups)} BRISK layouts)",
              flush=True)
        check(got_counts["fast_margins"] == want_margins
              and got_counts["fast_detect"] == want_detect,
              f"service launches {got_counts}")
        check(all(r["supported"] for r in recs), "an ID came back unsupported")
        check([r["detID"] for r in recs] == sweep, "record order")
        check(not any(r["approximate"] for r in recs if
                      dtab[r["detID"]]["Name"] != "ORB"),
              "a FAST/BRISK record flagged approximate")
        rec_of = {r["detID"]: r for r in recs}
        fam_ms = {}
        for fam, ids in fam_ids.items():
            secs = [rec_of[i]["processingTime"][0]["seconds"] for i in ids]
            fam_ms[fam] = 1e3 * sum(secs) / len(ids)
        print("service: ms per swept ID (both images): "
              + ", ".join(f"{f} {v:.3f}" for f, v in fam_ms.items())
              + f" [{card}]", flush=True)
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
        worst = {"FAST": 0.0, "ORB": 0.0, "BRISK": 0.0}
        for g, c in zip(recs, recs_cpu):
            fam = dtab[g["detID"]]["Name"]
            exact = (fam == "FAST" or (fam == "ORB" and level_diff == 0.0)
                     or (fam == "BRISK" and oct_diff == 0.0))
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
              f"{worst} (FAST exact; others exact when their level images "
              f"are equal, else within 0.5 %)", flush=True)

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
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

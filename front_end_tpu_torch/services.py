"""Service-layer API: the reference system's services as plain functions
(counterpart of `front_end_tpu/services.py`).

- `single_image_detection`: sweep detector IDs over one stereo pair and
  return counts, coordinate statistics and per-ID timing.
- `get_stereo_features`: detect + describe both images for one ID pair.
- `stereo_matching`: epipolar mask -> masked kNN -> Lowe -> uniqueness.
- `control_detection` and the window reset live in `pipeline.control`.

The three entry points run on the card unless the caller passes
`device="cpu"`.  Transport is the caller's concern.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from front_end_tpu_torch import features as features_mod
from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops import grid as grid_mod
from front_end_tpu_torch.ops import match as match_mod
from front_end_tpu_torch.ops import surf as surf_mod
from front_end_tpu_torch.types import Keypoints
from front_end_tpu_torch.utils.precision import f32_precision, resolve_device

# largest (K, H, W) float batch a vectorised stats pass may hold
STATS_CHUNK_BYTES = 64 << 20
# static top-k keypoint capacity behind the shared ORB map
ORB_MAP_CAPACITY = 2048


def keypoint_stats(score_map) -> dict:
    """Count + mean/std of x and y over the corners of one score map."""
    s = np.asarray(score_map.cpu() if isinstance(score_map, torch.Tensor)
                   else score_map)
    ys, xs = np.nonzero(s > 0)
    if len(xs) == 0:
        return {"nPoints": 0, "X": (0.0, 0.0), "Y": (0.0, 0.0)}
    return {"nPoints": int(len(xs)),
            "X": (float(xs.mean()), float(xs.std())),
            "Y": (float(ys.mean()), float(ys.std()))}


def _mask_stats(m):
    """count, mean/std of x, mean/std of y over boolean corner masks
    (..., H, W) -> five float64 tensors (...).

    The sums are integer sums of per-column and per-row counts, exact in
    any order, so the card and the CPU give the same statistics; the JAX
    package sums in float32, from which these differ by its rounding."""
    H, W = m.shape[-2:]
    i64, f64 = torch.int64, torch.float64
    xs = torch.arange(W, device=m.device, dtype=i64)
    ys = torch.arange(H, device=m.device, dtype=i64)
    col = m.sum(-2, dtype=i64)                     # (..., W)
    row = m.sum(-1, dtype=i64)                     # (..., H)
    n = col.sum(-1)
    d = n.clamp(min=1).to(f64)
    mx = (col * xs).sum(-1).to(f64) / d
    my = (row * ys).sum(-1).to(f64) / d
    sx = torch.sqrt(((col * xs * xs).sum(-1).to(f64) / d
                     - mx * mx).clamp(min=0.0))
    sy = torch.sqrt(((row * ys * ys).sum(-1).to(f64) / d
                     - my * my).clamp(min=0.0))
    return n.to(f64), mx, sx, my, sy


def _chunks(n_members: int, H: int, W: int):
    k = max(1, STATS_CHUNK_BYTES // (4 * H * W))
    return [slice(i, min(i + k, n_members)) for i in range(0, n_members, k)]


def _map_stats_batch(smap, thresholds):
    """Per-threshold keypoint statistics from ONE response map.
    smap: (H, W); thresholds: (K,) -> five (K,) tensors, on the device."""
    t = torch.as_tensor(thresholds, dtype=torch.float32, device=smap.device)
    parts = [_mask_stats(smap[None] > t[c, None, None])
             for c in _chunks(len(t), *smap.shape)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _fast_stats_batch(detect_map, score_map, thresholds, nms_flags):
    """Per-(threshold, nms) cv2-exact FAST statistics from the two shared
    margin maps.

    cv2's NMS runs on the SPARSE thresholded response map (a neighbour
    that fails the threshold cannot suppress), and for 7_12/5_8 the
    detection gate differs from the response, so NMS does not commute with
    thresholding and runs per member.  The members are evaluated in chunks
    of a bounded (K, H, W) batch; the results do not depend on the chunk
    size."""
    dev = detect_map.device
    t = torch.as_tensor(thresholds, dtype=torch.float32, device=dev)
    use_nms = torch.as_tensor(nms_flags, dtype=torch.bool, device=dev)
    parts = []
    for c in _chunks(len(t), *detect_map.shape):
        corner = detect_map[None] > t[c, None, None]
        s = torch.where(corner, score_map[None], torch.zeros((), device=dev))
        surviving = torch.where(use_nms[c, None, None],
                                fast_mod.nms_cv2(s) > 0, corner)
        parts.append(_mask_stats(surviving))
    return tuple(torch.cat(p) for p in zip(*parts))


def _structural_response_fn(settings):
    """Settings -> (key, fn(img) -> threshold-independent response, member).

    The FAST margin score is exactly the largest threshold at which a
    pixel stays a corner, so `map > t` reproduces the detector at ANY
    threshold.  Families whose threshold only gates a margin-score
    response share one map per structural configuration (circle type;
    pyramid layout; octave count); `member` is what distinguishes an ID
    inside its group.  Families outside the table give (None, None,
    None)."""
    name, p = settings["Name"], settings["Param"]
    if name == "FAST":
        # ONE (detect, score) margin-map pair serves every (threshold,
        # nms) member of the circle type; per-member NMS happens in
        # _fast_stats_batch.
        d_type = p.get("d_type", "9_16")
        nms = bool(p.get("non_maximum_suppression", True))

        def fn(img):
            return torch.stack(fast_mod.fast_margins(img, d_type))
        thr = float(p.get("threshold", p.get("fast_threshold", 15)))
        return ("FAST2", d_type), fn, (thr, nms)
    if name == "ORB":
        from front_end_tpu_torch.ops import orb as orb_mod
        nl = int(p.get("n_levels", 4))
        sf = float(p.get("scale_factor", 1.2))
        et = int(p.get("edge_threshold", 31))

        def fn(img):
            return orb_mod.detect_dense_pyramid(
                img, n_levels=nl, scale_factor=sf, fast_threshold=1.0,
                edge_threshold=et)
        return ("ORBPYR", nl, sf, et), fn, float(p.get("fast_threshold", 20))
    if name == "BRISK":
        # BRISK scores are per-octave FAST margins -> exact at any t
        from front_end_tpu_torch.ops import brisk as brisk_mod
        no = max(1, int(p.get("n_octaves", 3)))

        def fn(img):
            return brisk_mod.detect_dense(img, threshold=1.0, n_octaves=no)
        return ("BRISK", no), fn, float(p.get("threshold", 30))
    if name == "SURF":
        # the NMS'd det(H) maxima; hessian_threshold only gates them, so
        # one map per layout built at a tiny threshold serves the group,
        # exact above the largest response its top-k's left out (`cut`;
        # the records below it are flagged `approximate`)
        no = int(p.get("n_octaves", 3))
        nl = int(p.get("n_octave_layers", 2))

        def fn(img):
            return surf_mod.dense_map(img, hessian_threshold=1e-6,
                                      n_octaves=no, n_octave_layers=nl)
        return ("SURF", no, nl), fn, float(p.get("hessian_threshold", 100))
    if name == "AKAZE":
        # the det-Hessian maxima; the threshold only gates them and no
        # keypoint capacity stands behind the map, so one map per layout
        # and diffusivity, built at a tiny threshold, is exact at any t
        from front_end_tpu_torch.ops import akaze as akaze_mod
        no = int(p.get("n_octaves", 4))
        ns = int(p.get("n_octave_layers", p.get("n_sublevels", 4)))
        diff = str(p.get("diffusivity", "pm_g2"))

        def fn(img):
            return akaze_mod.detect_dense(img, threshold=1e-8, n_octaves=no,
                                          n_sublevels=ns, diffusivity=diff)
        return ("AKAZE", no, ns, diff), fn, float(p.get("threshold", 1e-3))
    return None, None, None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _features(stats, i):
    n, mx, sx, my, sy = (a[i] for a in stats)
    return {"nPoints": int(n), "X": (float(mx), float(sx)),
            "Y": (float(my), float(sy))}


def _thresholded_maps(key, resp, member):
    """The numpy score map of one member of a group (for `return_kp`)."""
    if key[0] == "FAST2":
        t_i, nms_i = member
        s = torch.where(resp[0] > t_i, resp[1], torch.zeros_like(resp[1]))
        return (fast_mod.nms_cv2(s) if nms_i else s).cpu().numpy()
    return torch.where(resp > member, resp,
                       torch.zeros_like(resp)).cpu().numpy()


@f32_precision
def single_image_detection(det_ids, left, right, return_kp: bool = False,
                           device="cuda"):
    """Sweep detector IDs over a stereo pair.

    Returns a list of `frameDetection`-shaped dicts in the order of
    `det_ids`: per ID the L/R keypoint statistics and a processing-time
    record.  IDs that share a structural configuration are batched: the
    FAST family computes ONE margin-map pair per circle type and image
    (one margin-kernel launch) and evaluates every (threshold, nms) member
    against it, so the full FAST sweep costs six kernel launches; ORB,
    BRISK and SURF build one response map per pyramid or octave layout.
    AKAZE builds one per octave layout and diffusivity.  A group's time is
    spread evenly over its members.  `approximate` flags records whose
    count may be cut by the static keypoint capacity behind an ORB map, or
    is cut by the per-layer capacity behind a SURF map (JAX's pixel-count
    probe misses the SURF case: see `surf.detect`'s `cut`); an AKAZE map
    has no capacity.  Settings of a family outside the table come back
    `supported: False`."""
    dev = resolve_device(device)
    left = torch.as_tensor(left).to(device=dev, dtype=torch.float32)
    right = torch.as_tensor(right).to(device=dev, dtype=torch.float32)

    def slot(det_id):
        return det_id if isinstance(det_id, str) else id(det_id)

    groups: dict = {}
    records = {}
    for det_id in det_ids:
        settings = (features_mod.detector_table()[det_id]
                    if isinstance(det_id, str) else det_id)
        key, fn, member = _structural_response_fn(settings)
        if key is None:
            records[slot(det_id)] = {"detID": det_id, "supported": False}
        else:
            groups.setdefault(key, (fn, []))[1].append((det_id, member))

    for key, (fn, members) in groups.items():
        _sync(dev)
        t0 = time.perf_counter()
        sl, sr = fn(left), fn(right)
        if key[0] == "SURF":
            (sl, cut_l), (sr, cut_r) = sl, sr
        if key[0] == "FAST2":
            thrs = [t for _, (t, _n) in members]
            nmsf = [n for _, (_t, n) in members]
            stats_l = _fast_stats_batch(sl[0], sl[1], thrs, nmsf)
            stats_r = _fast_stats_batch(sr[0], sr[1], thrs, nmsf)
        else:
            thrs = [t for _, t in members]
            stats_l = _map_stats_batch(sl, thrs)
            stats_r = _map_stats_batch(sr, thrs)
        _sync(dev)
        dt = (time.perf_counter() - t0) / max(len(members), 1)
        # the saturation probes fetch from the device, so they stay
        # outside the timed region
        flags = [False] * len(members)
        if key[0] == "SURF":
            cut = max(float(cut_l), float(cut_r))
            flags = [float(t) < cut for t in thrs]
        elif key[0] == "ORBPYR":
            nz = max(int((sl > 0).sum()), int((sr > 0).sum()))
            if nz >= ORB_MAP_CAPACITY:
                smin = min(float(sl[sl > 0].min()), float(sr[sr > 0].min()))
                flags = [float(t) <= smin for t in thrs]
        stats_l = [a.cpu() for a in stats_l]
        stats_r = [a.cpu() for a in stats_r]
        for i, (det_id, member) in enumerate(members):
            rec = {"detID": det_id, "supported": True,
                   "approximate": flags[i],
                   "processingTime": [{"label": "detection", "seconds": dt}],
                   "leftFeatures": _features(stats_l, i),
                   "rightFeatures": _features(stats_r, i)}
            if return_kp:
                rec["left_score_map"] = _thresholded_maps(key, sl, member)
                rec["right_score_map"] = _thresholded_maps(key, sr, member)
            records[slot(det_id)] = rec

    return [records[slot(d)] for d in det_ids]


@f32_precision
def get_stereo_features(det_id, desc_id, left, right,
                        cell_capacity: int = 384, device="cuda"):
    """Detect + describe both images for one (det, desc) ID pair ->
    ((keypoints_left, desc_left), (keypoints_right, desc_right))."""
    det_settings = features_mod.detector_table()[det_id]
    desc_fn, ok = features_mod.make_descriptor(desc_id)
    if not ok:
        raise ValueError(f"descriptor {desc_id} unsupported")
    dev = resolve_device(device)
    left = torch.as_tensor(left).to(device=dev, dtype=torch.float32)
    right = torch.as_tensor(right).to(device=dev, dtype=torch.float32)

    cfg = grid_mod.GridConfig(
        cell_capacity=cell_capacity,
        init_threshold=float(det_settings["Param"].get("threshold", 15)))
    detl = grid_mod.detect(left, cfg.init_thresholds(dev), cfg)
    detr = grid_mod.detect(right, cfg.init_thresholds(dev), cfg)
    dl = desc_fn(left, detl.keypoints.xy)
    dr = desc_fn(right, detr.keypoints.xy)
    return (detl.keypoints, dl), (detr.keypoints, dr)


@f32_precision
def stereo_matching(kl: Keypoints, dl, kr: Keypoints, dr, *,
                    epi_threshold: float = 1.0, ratio: float = 0.8):
    """The StereoCamera recipe on the features' device: epipolar mask ->
    masked kNN(2) -> Lowe -> uniqueness."""
    return match_mod.stereo_match_knn(kl, dl, kr, dr,
                                      epi_threshold=epi_threshold,
                                      ratio=ratio)

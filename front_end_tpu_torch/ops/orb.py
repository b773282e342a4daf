"""ORB: oriented FAST + rotated BRIEF with a scale pyramid and
WTA_K in {2, 3, 4} (counterpart of `front_end_tpu/ops/orb.py`).

- scale pyramid: level l is the image resized by `scale_factor**-l`
  (`image.resize_linear`, JAX's antialiased linear resize); FAST 9_16 runs
  per level (the detect kernel on the card) with per-level top-k capacities
  allocated by area share, `edge_threshold` border rejection, keypoint
  coordinates and sizes mapped back to level-0 pixels;
- orientation by the intensity centroid of a circular 31-px patch at the
  keypoint's level, atan2(m01, m10);
- descriptor: the pattern rotated by the keypoint angle, sampled on the
  smoothed level image;
- WTA_K 3/4: groups of K pattern points, each emitting the argmax index
  one-hot encoded into K bits, so the Hamming distance of two codes is
  twice the NORM_HAMMING2 distance and ordering, cross-check and Lowe
  ratios are those of OpenCV's HAMMING2 matcher.

Top-k everywhere is `lax.top_k`'s: lower index first among equal values.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from front_end_tpu_torch.ops import brief as brief_mod
from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops import image as image_ops
from front_end_tpu_torch.ops.grid import _stable_topk
from front_end_tpu_torch.types import Descriptors, Keypoints

ORIENT_PATCH = 31


@functools.lru_cache(maxsize=None)
def _moment_kernels(device):
    """The (circ·x, circ·y) windows, (2, 1, kh, kw), made once per device:
    a call copies no constant to the card."""
    r = ORIENT_PATCH // 2
    gy, gx = np.mgrid[-r:r + 1, -r:r + 1].astype(np.float32)
    circ = (gx**2 + gy**2 <= r * r).astype(np.float32)
    return torch.as_tensor(np.stack([gx * circ, gy * circ])[:, None],
                           device=device)


def intensity_centroid_angle(img, xy):
    """Keypoint orientation: angle of the intensity centroid of the 31×31
    circular patch (radians).  img: (H, W) raw image; xy: (N, 2).

    The windowed moments m10/m01 are correlations of the image with the
    (circ·x) / (circ·y) windows, zero-padded: one two-channel `conv2d`
    (run under the callers' precision pin, so true float32 on the card),
    then two point samples per keypoint."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    mom = F.conv2d(img[None, None], _moment_kernels(img.device),
                   padding=ORIENT_PATCH // 2)[0]
    xi = torch.round(xy[:, 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(xy[:, 1]).to(torch.int64).clamp(0, H - 1)
    flat = mom.reshape(2, -1)
    idx = yi * W + xi
    return torch.atan2(flat[1, idx], flat[0, idx])


@functools.lru_cache(maxsize=16)
def _wta_pattern_np(groups: int, k: int, patch: int, seed: int):
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal(0.0, patch / 5.0, (groups, k, 2)),
                   -(patch // 2), patch // 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pattern_on(n_bits: int, wta_k: int, seed: int, device):
    """The (G, k, 2) float32 sampling pattern, made once per device."""
    if wta_k == 2:
        pts = brief_mod.brief_pattern(n_bits, brief_mod.PATCH,
                                      seed).astype(np.float32)
    else:
        pts = _wta_pattern_np(n_bits // 2, wta_k, 31, seed)
    return torch.as_tensor(pts, device=device)


def describe(img_smooth, xy, angle, n_bytes: int = 32, *, wta_k: int = 2,
             pattern_seed: int = 7) -> Descriptors:
    """Steered BRIEF / WTA_K descriptor.

    img_smooth: output of `brief.smooth`; xy: (N, 2); angle: (N,) radians.
    wta_k=2: n_bytes*8 pairwise sign bits (classic rBRIEF).
    wta_k=3/4: n_bytes*4 groups, each one-hot over its K points."""
    H, W = img_smooth.shape[-2:]
    patf = _pattern_on(8 * n_bytes, wta_k, pattern_seed,
                       img_smooth.device)                     # (G, k, 2)

    ca, sa = torch.cos(angle), torch.sin(angle)               # (N,)
    px = (patf[None, ..., 0] * ca[:, None, None]
          - patf[None, ..., 1] * sa[:, None, None])
    py = (patf[None, ..., 0] * sa[:, None, None]
          + patf[None, ..., 1] * ca[:, None, None])
    cx = torch.round(xy[:, 0]).to(torch.int64)
    cy = torch.round(xy[:, 1]).to(torch.int64)
    ix = (cx[:, None, None] + torch.round(px).to(torch.int64)).clamp(0, W - 1)
    iy = (cy[:, None, None] + torch.round(py).to(torch.int64)).clamp(0, H - 1)
    vals = img_smooth.reshape(-1)[iy * W + ix]                # (N, G, k)
    if wta_k == 2:
        bits = (vals[..., 0] < vals[..., 1]).to(torch.float32)
    else:
        win = vals.argmax(-1)                                 # first maximum
        bits = F.one_hot(win, wta_k).to(torch.float32).reshape(
            vals.shape[0], -1)
    return Descriptors(bits=bits)


class OrbDetections(NamedTuple):
    keypoints: Keypoints      # xy in level-0 coords; angle filled
    octave: torch.Tensor      # (K,) int32 pyramid level
    size: torch.Tensor        # (K,) patch diameter at level-0 scale


def _level_budgets(total: int, n_levels: int, scale_factor: float):
    """OpenCV's geometric per-level feature allocation: level l gets a
    share ∝ (1/scale_factor²)^l (area share), summing to at least
    `total` (the global top-k needs enough rows)."""
    f = 1.0 / (scale_factor * scale_factor)
    w = np.power(f, np.arange(n_levels))
    b = np.maximum((total * w / w.sum()).astype(int), 16)
    b[0] += max(total - int(b.sum()), 0)
    return [int(x) for x in b]


def level_shape(H: int, W: int, lvl: int, scale_factor: float):
    """Size of pyramid level `lvl` (never under 64 a side)."""
    s = float(scale_factor) ** lvl
    return max(int(round(H / s)), 64), max(int(round(W / s)), 64)


def detect_describe_pyramid(img, *, n_levels: int = 4,
                            scale_factor: float = 1.2,
                            fast_threshold: float = 20.0,
                            edge_threshold: int = 31,
                            max_keypoints: int = 1024, n_bytes: int = 32,
                            wta_k: int = 2, pattern_seed: int = 7,
                            with_descriptors: bool = True):
    """Full ORB: pyramid FAST + centroid orientation + steered WTA_K
    descriptors.  Returns (OrbDetections, Descriptors) of capacity
    `max_keypoints` (invalid rows padded).  with_descriptors=False skips
    smoothing, orientation and sampling (the detection-only sweep path)
    and returns zero angles and empty descriptors."""
    img = img.to(torch.float32)
    H, W = img.shape
    dev = img.device
    budgets = _level_budgets(max_keypoints, n_levels, scale_factor)

    per_level = []
    for lvl in range(n_levels):
        s = float(scale_factor) ** lvl
        h, w = level_shape(H, W, lvl, scale_factor)
        lv = img if lvl == 0 else image_ops.resize_linear(img, h, w)
        smap = fast_mod.detect_dense(lv, fast_threshold, "9_16", nms=True)
        et = int(edge_threshold)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        interior = (ys >= et) & (ys < h - et) & (xs >= et) & (xs < w - et)
        smap = torch.where(interior, smap, torch.zeros_like(smap))

        k = budgets[lvl]
        v, idx = _stable_topk(smap.reshape(-1), k)
        xy_lvl = torch.stack([(idx % w).to(torch.float32),
                              (idx // w).to(torch.float32)], -1)
        if with_descriptors:
            ang = intensity_centroid_angle(lv, xy_lvl)
            bits = describe(brief_mod.smooth(lv), xy_lvl, ang, n_bytes,
                            wta_k=wta_k, pattern_seed=pattern_seed).bits
        else:
            ang = torch.zeros(k, dtype=torch.float32, device=dev)
            bits = torch.zeros((k, 0), dtype=torch.float32, device=dev)
        per_level.append(dict(
            xy=xy_lvl * s, score=v, angle=ang, valid=v > 0,
            octave=torch.full((k,), lvl, dtype=torch.int32, device=dev),
            size=torch.full((k,), 31.0 * s, dtype=torch.float32, device=dev),
            bits=bits))

    cat = {k: torch.cat([p[k] for p in per_level]) for k in per_level[0]}
    # global top max_keypoints by score, so the capacity is exact
    v, sel = _stable_topk(
        torch.where(cat["valid"], cat["score"],
                    torch.full_like(cat["score"], -1.0)), max_keypoints)
    kps = Keypoints(xy=cat["xy"][sel], score=v, angle=cat["angle"][sel],
                    valid=v > 0)
    det = OrbDetections(keypoints=kps, octave=cat["octave"][sel],
                        size=cat["size"][sel])
    return det, Descriptors(bits=cat["bits"][sel])


def detect_dense_pyramid(img, *, n_levels: int = 4, scale_factor: float = 1.2,
                         fast_threshold: float = 20.0,
                         edge_threshold: int = 31,
                         max_keypoints: int = 2048):
    """Score-map form for the sweep/services API: the pyramid's keypoints
    scattered into a level-0 map (corners = map > 0); keypoints landing on
    one pixel keep the largest score."""
    det, _ = detect_describe_pyramid(
        img, n_levels=n_levels, scale_factor=scale_factor,
        fast_threshold=fast_threshold, edge_threshold=edge_threshold,
        max_keypoints=max_keypoints, with_descriptors=False)
    H, W = img.shape
    k = det.keypoints
    yy = k.xy[:, 1].to(torch.int64).clamp(0, H - 1)
    xx = k.xy[:, 0].to(torch.int64).clamp(0, W - 1)
    vals = torch.where(k.valid, k.score, torch.zeros_like(k.score))
    out = torch.zeros(H * W, dtype=torch.float32, device=img.device)
    out.scatter_reduce_(0, yy * W + xx, vals, "amax", include_self=True)
    return out.reshape(H, W)


def detect_describe(img, keypoints: Keypoints, n_bytes: int = 32, *,
                    wta_k: int = 2):
    """Orientation + steered descriptors for a Keypoints set from the
    grid/FAST detector (single-level path)."""
    sm = brief_mod.smooth(img)
    ang = intensity_centroid_angle(img, keypoints.xy)
    desc = describe(sm, keypoints.xy, ang, n_bytes, wta_k=wta_k)
    return keypoints.replace(angle=ang), desc

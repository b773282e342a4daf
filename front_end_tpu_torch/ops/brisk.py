"""BRISK: scale-pyramid segment-test detection and the concentric-ring
binary descriptor (counterpart of `front_end_tpu/ops/brisk.py`).

Detection: the dense FAST margin score (`ops/fast.py`, the detect kernel
on the card) runs per pyramid octave with 3×3 NMS — AGAST and FAST share
the segment-test family, and the margin score makes the threshold a
post-hoc compare; octave o+1 is octave o blurred (sigma 1) and decimated
by 2.  `detect` merges a static top-K per octave; `detect_dense` gives the
base-resolution score map.

Descriptor: 60 points on five staggered rings, each ring sampled bilinearly
from its own Gaussian blur (sigma growing with the radius).  The long
pairs give the orientation (gradient-weighted sum), the 512 shortest pairs
the bits, compared on the pattern rotated by that angle.  The pattern is
this package's own copy of the JAX package's, built the same way.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops.grid import _stable_topk
from front_end_tpu_torch.ops.image import bilinear_sample, gaussian_blur
from front_end_tpu_torch.types import Descriptors, Keypoints

# ring layout (radius in pattern units, number of points, smoothing sigma)
RINGS = ((0.0, 1, 0.6), (2.9, 10, 0.75), (4.9, 14, 1.1),
         (7.4, 15, 1.6), (10.8, 20, 2.4))
N_POINTS = sum(n for _, n, _ in RINGS)           # 60
LONG_PAIR_MIN = 13.67
N_BITS = 512


@functools.lru_cache(maxsize=1)
def _pattern():
    """Host constants: point offsets (P, 2) [dy, dx], ring id per point,
    short pairs (512, 2), long pairs (L, 2)."""
    pts, ring_id = [], []
    for r, (radius, n, _sigma) in enumerate(RINGS):
        for i in range(n):
            a = 2 * np.pi * i / n + (0.5 * r)    # stagger rings
            pts.append((radius * np.sin(a), radius * np.cos(a)))
            ring_id.append(r)
    pts = np.asarray(pts, np.float32)
    ring_id = np.asarray(ring_id, np.int32)
    pairs = np.asarray([(i, j) for i in range(N_POINTS)
                        for j in range(i + 1, N_POINTS)], np.int32)
    d = np.linalg.norm(pts[pairs[:, 0]] - pts[pairs[:, 1]], axis=1)
    short = pairs[np.argsort(d)][:N_BITS]
    long = pairs[d > LONG_PAIR_MIN]
    return pts, ring_id, short, long


def ring_blurs(img, sigmas):
    """One Gaussian blur of an (..., H, W) image (or stack) per ring."""
    img = img.to(torch.float32)
    return [gaussian_blur(img, float(s)) for s in sigmas]


def blurs(img):
    """BRISK's ring blurs of an image or a stack of images (the VO path
    blurs a stereo pair once, for the orientation and the descriptor)."""
    return ring_blurs(img, [s for _r, _n, s in RINGS])


def on_device(arrays, device):
    """Host constants as tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def ring_columns(ring_id, device):
    """Per ring, the (int64) pattern columns it samples, on `device`."""
    return on_device([np.nonzero(ring_id == r)[0]
                      for r in range(int(ring_id.max()) + 1)], device)


def sample_rings(ring_imgs, xy, offsets, cols):
    """Sample each pattern point from its ring's blurred image.  offsets:
    (N, P, 2) [dy, dx]; cols: `ring_columns`.  Returns (N, P) in pattern
    order: each ring gathers only its own columns."""
    px = xy[:, 0:1] + offsets[..., 1]
    py = xy[:, 1:2] + offsets[..., 0]
    N = px.shape[0]
    out = px.new_empty(px.shape)
    for b, c in zip(ring_imgs, cols):
        pr = torch.stack([px[:, c], py[:, c]], -1).reshape(-1, 2)
        out[:, c] = bilinear_sample(b, pr).reshape(N, -1)
    return out


@functools.lru_cache(maxsize=8)
def _consts(device):
    """(offsets, short pairs, long pairs, ring columns) on `device`, made
    once per device: a step copies no constant to the card."""
    pts, ring_id, short, long = _pattern()
    return (*on_device((pts, short.astype(np.int64), long.astype(np.int64)),
                       device), ring_columns(ring_id, device))


def orientations(img, xy, valid, *, pattern_scale: float = 1.0,
                 kp_scale=None, ring_imgs=None):
    """BRISK orientation: the gradient-weighted sum over the long pairs,
    g = Σ (I(pj) − I(pi)) · (pj − pi) / ‖pj − pi‖², as atan2(gy, gx).
    `ring_imgs`: the image's `blurs`, when the caller has them."""
    pts, _short, long_pairs, cols = _consts(xy.device)
    offs = pts * pattern_scale                          # (P, 2) [dy, dx]
    per_kp = offs.expand(xy.shape[0], -1, -1)
    if kp_scale is not None:
        per_kp = per_kp * kp_scale[:, None, None]
    samples = sample_rings(blurs(img) if ring_imgs is None else ring_imgs,
                           xy, per_kp, cols)
    pi, pj = long_pairs[:, 0], long_pairs[:, 1]
    dvec = offs[pj] - offs[pi]                          # (L, 2) [dy, dx]
    d2 = (dvec * dvec).sum(-1)
    wgt = (samples[:, pj] - samples[:, pi]) / d2[None]
    gy = (wgt * dvec[None, :, 0]).sum(-1)
    gx = (wgt * dvec[None, :, 1]).sum(-1)
    return torch.where(valid, torch.atan2(gy, gx), torch.zeros_like(gx))


def rotate(offs, angle):
    """(P, 2) [dy, dx] offsets rotated by (N,) angles -> (N, P, 2)."""
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    ry = offs[None, :, 0] * ca + offs[None, :, 1] * sa
    rx = -offs[None, :, 0] * sa + offs[None, :, 1] * ca
    return torch.stack([ry, rx], -1)


def describe(img, xy, angle, valid, *, pattern_scale: float = 1.0,
             kp_scale=None, ring_imgs=None) -> Descriptors:
    """512 short-pair comparisons on the rotated pattern; rows that are
    not `valid` are zero.  `ring_imgs`: as for `orientations`."""
    pts, short_pairs, _long, cols = _consts(xy.device)
    rot = rotate(pts * pattern_scale, angle)
    if kp_scale is not None:
        rot = rot * kp_scale[:, None, None]
    samples = sample_rings(blurs(img) if ring_imgs is None else ring_imgs,
                           xy, rot, cols)
    pi, pj = short_pairs[:, 0], short_pairs[:, 1]
    bits = (samples[:, pi] > samples[:, pj]).to(torch.float32)
    return Descriptors(bits=bits * valid[:, None])


class BriskDetections(NamedTuple):
    keypoints: Keypoints
    octave: torch.Tensor     # (K,) int32


def next_octave(level):
    """Blur (sigma 1) and keep every second row and column."""
    return gaussian_blur(level, 1.0)[::2, ::2]


def detect(img, *, threshold: float = 30.0, n_octaves: int = 3,
           max_keypoints: int = 512) -> BriskDetections:
    """Pyramid segment-test detection: dense FAST score per octave + NMS,
    static top-K merge (cv::BRISK's AGAST-pyramid role)."""
    img = img.to(torch.float32)
    dev = img.device
    per = max(16, max_keypoints // max(1, n_octaves))
    xs_l, ys_l, sc_l, oc_l = [], [], [], []
    level = img
    for o in range(n_octaves):
        s = fast_mod.detect_dense(level, threshold, fast_type="9_16",
                                  nms=True)
        w = s.shape[1]
        v, idx = _stable_topk(s.reshape(-1), per)
        scale = float(1 << o)
        xs_l.append((idx % w).to(torch.float32) * scale)
        ys_l.append((idx // w).to(torch.float32) * scale)
        sc_l.append(v)
        oc_l.append(torch.full((per,), o, dtype=torch.int32, device=dev))
        if o + 1 < n_octaves:
            level = next_octave(level)
    xs, ys, sc, oc = (torch.cat(a) for a in (xs_l, ys_l, sc_l, oc_l))
    if xs.shape[0] < max_keypoints:
        pad = (0, max_keypoints - xs.shape[0])
        xs, ys, sc, oc = (F.pad(a, pad) for a in (xs, ys, sc, oc))
    v, sel = _stable_topk(torch.where(sc > 0, sc, torch.full_like(sc, -1.0)),
                          max_keypoints)
    kps = Keypoints(xy=torch.stack([xs[sel], ys[sel]], -1), score=v,
                    angle=torch.zeros_like(v), valid=v > 0)
    return BriskDetections(keypoints=kps, octave=oc[sel])


def detect_dense(img, *, threshold: float = 30.0, n_octaves: int = 3):
    """Base-resolution score map (max over octave layers, coarse layers
    nearest-upsampled); corners are `map > 0`."""
    img = img.to(torch.float32)
    h, w = img.shape
    out = torch.zeros_like(img)
    level = img
    for o in range(n_octaves):
        s = fast_mod.detect_dense(level, threshold, fast_type="9_16",
                                  nms=True)
        f = 1 << o
        if f > 1:
            s = s.repeat_interleave(f, 0).repeat_interleave(f, 1)
        out = torch.maximum(out, s[:h, :w])
        if o + 1 < n_octaves:
            level = next_octave(level)
    return out


def detect_and_describe(img, *, threshold: float = 30.0, n_octaves: int = 3,
                        pattern_scale: float = 1.0,
                        max_keypoints: int = 512):
    """Detection, then orientation and descriptor with the pattern grown
    by the detection octave (2^octave)."""
    det = detect(img, threshold=threshold, n_octaves=n_octaves,
                 max_keypoints=max_keypoints)
    kps = det.keypoints
    kp_scale = torch.exp2(det.octave.to(torch.float32))
    ring_imgs = blurs(img)
    ang = orientations(img, kps.xy, kps.valid, pattern_scale=pattern_scale,
                       kp_scale=kp_scale, ring_imgs=ring_imgs)
    desc = describe(img, kps.xy, ang, kps.valid, pattern_scale=pattern_scale,
                    kp_scale=kp_scale, ring_imgs=ring_imgs)
    return det._replace(keypoints=kps.replace(angle=ang)), desc

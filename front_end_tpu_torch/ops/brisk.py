"""BRISK, the detection half (counterpart of `front_end_tpu/ops/brisk.py`
lines 75-125): scale-pyramid segment-test detection.

The dense FAST margin score (`ops/fast.py`, the detect kernel on the card)
runs per pyramid octave with 3×3 NMS — AGAST and FAST share the
segment-test family, and the margin score makes the threshold a post-hoc
compare; octave o+1 is octave o blurred (sigma 1) and decimated by 2.
`detect` merges a static top-K per octave; `detect_dense` gives the
base-resolution score map.  The descriptor half (the concentric-ring
pattern) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops.grid import _stable_topk
from front_end_tpu_torch.ops.image import gaussian_blur
from front_end_tpu_torch.types import Keypoints


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

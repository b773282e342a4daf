"""The plain forms of the three kernels on the VO paths (`fast_grid`,
`brief_keypoints`, `match_reduce`), frozen from the port's kernel
modules: the whole computation in PyTorch operations, with the kernels'
tie and clamping rules."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference import fast as fast_mod
from vobench.reference.precision import pinned_f32
from vobench.reference.types import pack_bits, unpack_bits

BIG = 1e9
MAX_BITS = 512


# ---- fast_grid -----------------------------------------------------------

def pooled_dims(ch: int, cw: int) -> tuple[int, int]:
    return -(-ch // 2), -(-cw // 2)


def threshold_map(thresholds, H: int, W: int, ch: int, cw: int):
    """(..., Gr, Gc) -> (..., H, W) per-pixel thresholds; pixels beyond
    the last whole cell take the edge cell's."""
    Gr, Gc = thresholds.shape[-2:]
    dev = thresholds.device
    iy = (torch.arange(H, device=dev) // ch).clamp_(max=Gr - 1)
    ix = (torch.arange(W, device=dev) // cw).clamp_(max=Gc - 1)
    return thresholds.index_select(-2, iy).index_select(-1, ix)


def pool_cells(smap, cell):
    """Surviving-score map (..., H, W) -> pooled (..., Gr, Gc, ph·pw),
    code uint8 (same shape), counts int32 (..., Gr, Gc)."""
    Gr, Gc, ch, cw = cell
    lead = smap.shape[:-2]
    s4 = smap[..., :Gr * ch, :Gc * cw].reshape(*lead, Gr, ch, Gc, cw)
    counts = (s4 > 0).sum((-3, -1), dtype=torch.int32)
    s4p = F.pad(s4, (0, cw % 2, 0, 0, 0, ch % 2))
    colA, colB = s4p[..., 0::2], s4p[..., 1::2]
    m1 = torch.maximum(colA, colB)
    w1 = colB > colA
    rowA, rowB = m1[..., 0::2, :, :], m1[..., 1::2, :, :]
    pooled = torch.maximum(rowA, rowB)
    w2 = rowB > rowA
    sub_x = torch.where(w2, w1[..., 1::2, :, :], w1[..., 0::2, :, :])
    code = 2 * w2.to(torch.uint8) + sub_x.to(torch.uint8)
    ph, pw = pooled_dims(ch, cw)

    def cells(a):
        return a.transpose(-3, -2).reshape(*lead, Gr, Gc, ph * pw)

    return cells(pooled), cells(code), counts


def fast_grid(imgs, thresholds, cell, fast_type: str = "9_16"):
    """(B, H, W) images + (B, Gr, Gc) thresholds -> (pooled, code,
    counts): the dense detect with NMS, then per-cell pooling."""
    Gr, Gc, ch, cw = cell
    H, W = imgs.shape[-2:]
    tmaps = threshold_map(thresholds, H, W, ch, cw)
    smap = fast_mod.detect_dense_plain(imgs, tmaps, fast_type, nms=True)
    return pool_cells(smap, cell)


# ---- brief_keypoints -----------------------------------------------------

def keypoint_pixels(xy, H: int, W: int):
    """(…, 2) float xy -> integer (px, py): round half to even, then clamp
    into the image (in float, so ±inf lands on the edge, NaN on 0)."""
    r = torch.round(xy.to(torch.float32))
    lo = torch.fmax(r, r.new_zeros(()))
    hi = r.new_tensor([W - 1, H - 1])
    c = torch.minimum(lo, hi).to(torch.int64)
    return c[..., 0], c[..., 1]


def brief_words(img, xy, pattern):
    """(B, H, W) float32 smoothed images, (B, N, 2) keypoints and the
    (n_bits, 2, 2) offset pattern -> (B, N, n_words) uint32."""
    pat = torch.as_tensor(np.asarray(pattern), dtype=torch.int64,
                          device=img.device)
    n_bits = pat.shape[0]
    if n_bits % 32 or not 0 < n_bits <= MAX_BITS:
        raise ValueError(f"BRIEF of {n_bits} bits")
    B, H, W = img.shape
    px, py = keypoint_pixels(xy, H, W)
    sx = (px[..., None, None] + pat[..., 0]).clamp(0, W - 1)
    sy = (py[..., None, None] + pat[..., 1]).clamp(0, H - 1)
    vals = img.reshape(B, -1).gather(1, (sy * W + sx).reshape(B, -1))
    vals = vals.reshape(sx.shape)
    return pack_bits(vals[..., 0] < vals[..., 1])


# ---- match_reduce --------------------------------------------------------

def gate_mask(xyq, xyt, valid_q, valid_t, mode: str, p1=0.0, p2=0.0,
              p3=0.0):
    ok = valid_q[:, None] & valid_t[None, :]
    dx = xyq[:, None, 0] - xyt[None, :, 0]
    dy = (xyq[:, None, 1] - xyt[None, :, 1]).abs()
    if mode == "stereo":
        ok = ok & (dy <= p1) & (dx >= p2) & (dx <= p3)
    elif mode == "epi":
        ok = ok & (dy <= p1)
    elif mode == "roi":
        ok = ok & (dx.abs() <= p1) & (dy <= p1)
    elif mode != "none":
        raise ValueError(f"unknown match mode {mode!r}")
    return ok


def match_reduce(words_q, words_t, xyq, xyt, valid_q, valid_t, *,
                 mode: str = "none", p1: float = 0.0, p2: float = 0.0,
                 p3: float = 0.0):
    """The whole masked Hamming matrix, then (d1, d2, i1) per query and
    (min, arg) per train; ties go to the first index."""
    bq, bt = unpack_bits(words_q), unpack_bits(words_t)
    with pinned_f32():      # {0,1} float32 products: exact integer sums
        ham = bq.sum(-1)[:, None] + bt.sum(-1)[None, :] - 2.0 * (bq @ bt.T)
    ok = gate_mask(xyq, xyt, valid_q, valid_t, mode, p1, p2, p3)
    dist = torch.where(ok, ham, torch.full_like(ham, BIG))
    i1 = dist.argmin(1)
    d1 = dist.gather(1, i1[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(cols[None, :] == i1[:, None], BIG, dist).amin(1)
    col_arg = dist.argmin(0)
    col_min = dist.gather(0, col_arg[None, :])[0]
    return d1, d2, i1.to(torch.int32), col_min, col_arg.to(torch.int32)

"""Fused grid FAST kernel: margins + threshold + NMS + per-cell 2×2 pool +
exact per-cell counts in one pass (`csrc/fast_grid.cu`).

Replaces `front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_grid_pallas`
(Pallas body `_detect_grid_kernel`, core `_nms_survivors`).

What bounds it on the H100: compute.  Every pixel runs the 16-tap segment
test and ~170 float min/max ops of the arc margins (plus the NMS), while
the bytes are one image read and a quarter-size pooled map written —
about 190 float32 ops per 4 bytes read, far above the card's ~20
ops/byte balance point of its non-tensor float32 rate.

Design: one block per 32×32-pixel tile of ONE grid cell.  The tile's
image plus a 4-pixel halo (3 for the circle, 1 for NMS) is staged in
shared memory once with clamped reads; the thresholded scores of the
34×34 ring are computed into shared memory (each pixel's threshold looked
up from the (Gr, Gc) table, so no (H, W) threshold map exists), then each
thread applies the tie-annihilating NMS to its 2×2 block and pools it.
Pooling is per cell, from the cell's origin, with odd cell dims padded by
zeros — the XLA path's `_detect_from_map` layout, so the keypoint set
equals the JAX CPU path's at odd cells too (the TPU kernel pools on the
global even grid and does not).  Counts are warp sums plus an integer
`atomicAdd`, exact in any order.  The full-resolution response map never
reaches device memory.

Outputs, in the XLA path's layout: pooled scores (B, Gr, Gc, ph·pw),
the winner's sub-position code 2·w2 + w1 (uint8), counts (B, Gr, Gc).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops.kernels import _build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fast_grid_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P]}


def pooled_dims(ch: int, cw: int) -> tuple[int, int]:
    return -(-ch // 2), -(-cw // 2)


def threshold_map(thresholds, H: int, W: int, ch: int, cw: int):
    """(..., Gr, Gc) -> (..., H, W) per-pixel thresholds; pixels beyond
    the last whole cell take the edge cell's (`grid.py:110-117`)."""
    Gr, Gc = thresholds.shape[-2:]
    dev = thresholds.device
    iy = (torch.arange(H, device=dev) // ch).clamp_(max=Gr - 1)
    ix = (torch.arange(W, device=dev) // cw).clamp_(max=Gc - 1)
    return thresholds.index_select(-2, iy).index_select(-1, ix)


def pool_cells(smap, cell):
    """Surviving-score map (..., H, W) -> pooled (..., Gr, Gc, ph·pw),
    code uint8 (same shape), counts int32 (..., Gr, Gc): the pooling
    stage of `grid.py::_detect_from_map` (lines 149-176), per cell."""
    Gr, Gc, ch, cw = cell
    lead = smap.shape[:-2]
    s4 = smap[..., :Gr * ch, :Gc * cw].reshape(*lead, Gr, ch, Gc, cw)
    counts = (s4 > 0).sum((-3, -1), dtype=torch.int32)
    s4p = F.pad(s4, (0, cw % 2, 0, 0, 0, ch % 2))
    colA, colB = s4p[..., 0::2], s4p[..., 1::2]
    m1 = torch.maximum(colA, colB)               # (..., Gr, ch2, Gc, pw)
    w1 = colB > colA
    rowA, rowB = m1[..., 0::2, :, :], m1[..., 1::2, :, :]
    pooled = torch.maximum(rowA, rowB)           # (..., Gr, ph, Gc, pw)
    w2 = rowB > rowA
    sub_x = torch.where(w2, w1[..., 1::2, :, :], w1[..., 0::2, :, :])
    code = 2 * w2.to(torch.uint8) + sub_x.to(torch.uint8)
    ph, pw = pooled_dims(ch, cw)

    def cells(a):
        return a.transpose(-3, -2).reshape(*lead, Gr, Gc, ph * pw)

    return cells(pooled), cells(code), counts


def plain(imgs, thresholds, cell, fast_type: str = "9_16"):
    """The plain PyTorch twin: the plain dense detect (never the detect
    kernel, so the twin stays an independent check on the card), then
    per-cell pooling."""
    Gr, Gc, ch, cw = cell
    H, W = imgs.shape[-2:]
    tmaps = threshold_map(thresholds, H, W, ch, cw)
    smap = fast_mod.detect_dense_plain(imgs, tmaps, fast_type, nms=True)
    return pool_cells(smap, cell)


def fast_grid(imgs, thresholds, cell, fast_type: str = "9_16"):
    """(B, H, W) float32 images + (B, Gr, Gc) float32 thresholds ->
    (pooled, code, counts); cell = (Gr, Gc, ch, cw)."""
    if imgs.device.type == "cpu":
        return plain(imgs, thresholds, cell, fast_type)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_grid: unsupported device {imgs.device}")
    global launches
    Gr, Gc, ch, cw = cell
    B, H, W = imgs.shape
    if imgs.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise TypeError("fast_grid takes float32 images and thresholds")
    if thresholds.shape != (B, Gr, Gc) or thresholds.device != imgs.device:
        raise ValueError(f"fast_grid: thresholds {tuple(thresholds.shape)} "
                         f"on {thresholds.device}, want {(B, Gr, Gc)}")
    n = len(fast_mod.TYPES[fast_type][0])
    imgs = imgs.contiguous()
    thresholds = thresholds.contiguous()
    ph, pw = pooled_dims(ch, cw)
    pooled = torch.empty((B, Gr, Gc, ph * pw), dtype=torch.float32,
                         device=imgs.device)
    code = torch.empty((B, Gr, Gc, ph * pw), dtype=torch.uint8,
                       device=imgs.device)
    counts = torch.zeros((B, Gr, Gc), dtype=torch.int32, device=imgs.device)
    lib = _build.library("fast_grid", _SIG)
    rc = lib.fast_grid_launch(
        imgs.data_ptr(), thresholds.data_ptr(), pooled.data_ptr(),
        code.data_ptr(), counts.data_ptr(), B, H, W, Gr, Gc, ch, cw, n,
        _build.stream_handle(imgs.device))
    _build.check(rc, "fast_grid")
    launches += 1
    return pooled, code, counts

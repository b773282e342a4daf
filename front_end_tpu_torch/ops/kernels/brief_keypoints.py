"""BRIEF at the keypoints (`csrc/brief_keypoints.cu`).

Replaces `front_end_tpu/ops/pallas/brief_kernel.py::describe_dense_pallas`
and `describe_pair_pallas`: what they compute as dense bitplanes
(`brief_bitplanes`) followed by a gather at the keypoints
(`_gather_words`), in one launch and without the planes.  For keypoint
pixel p = clamp(round(xy)) and pattern pair (a, b) the bit is
img[clamp(p + a)] < img[clamp(p + b)], packed 32 to a uint32 word; output
(B, N, n_words).  The same bits as the dense route everywhere, the image
border, keypoints outside the image and padding rows included.

What bounds it on the H100: nothing but the launch.  The dense planes are
a TPU device (no gather there): 256 compares at every one of 2 × 376 × 1241
pixels is 1.9 GB through the shared-memory pipe, ≥ 57 µs on this card
whatever the tiling, for 30 MB of planes of which the paths read 4608 × 8
words.  At the keypoints the work is 4608 × 256 compares, 2.4 M loads
against 478 M, over 3.9 MB of input that sits in L2.

Design: one warp per keypoint.  A gather costs the load unit one pass for
every distinct 128-byte line that a warp's load touches, and a lane that
loads the two samples of "its" bit scatters each load over ~30 lines.  So
the sample points come as a table sorted by (dy, dx) (`sample_table`):
lanes walk it in order, 32 neighbouring samples lie on a few image rows,
and each value is dropped into a 4 KB per-warp shared buffer at its sample
index.  Then lane j compares the two samples of bit j of each word and
`__ballot_sync` delivers the packed word: no shift/or chain, no image
tile.  The table is a device tensor passed by pointer, made once by the
caller (`ops/brief.py` caches it per bits, seed and device), so a launch
does no host-to-device copy and no synchronisation and can be captured in
a CUDA graph.  Bits are float compares only: they equal the plain
version's exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from front_end_tpu_torch.ops.kernels import _build
from front_end_tpu_torch.types import pack_bits

launches = 0
MAX_BITS = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"brief_keypoints_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


def keypoint_pixels(xy, H: int, W: int):
    """(…, 2) float xy -> integer (px, py): round half to even, then clamp
    into the image.  The clamp is made in float, as the kernel makes it, so
    that ±inf lands on the edge and NaN on pixel 0 before the integer cast."""
    r = torch.round(xy.to(torch.float32))
    lo = torch.fmax(r, r.new_zeros(()))          # fmax: NaN -> 0, as fmaxf
    hi = r.new_tensor([W - 1, H - 1])
    c = torch.minimum(lo, hi).to(torch.int64)
    return c[..., 0], c[..., 1]


def sample_table(pattern) -> torch.Tensor:
    """(n_bits, 2, 2) integer offsets [(ax, ay), (bx, by)] -> the kernel's
    int32 table of the 2 n_bits sample points, sorted by (dy, dx):
    dx | dy << 8 | (2 bit + side) << 16, offsets as signed bytes."""
    pts = np.asarray(pattern).reshape(-1, 2).astype(np.int64)
    n_bits = pts.shape[0] // 2
    if (np.asarray(pattern).shape != (n_bits, 2, 2) or n_bits % 32
            or not 0 < n_bits <= MAX_BITS or np.abs(pts).max() > 127):
        raise ValueError(f"brief_keypoints: pattern "
                         f"{np.asarray(pattern).shape}; takes (n_bits, 2, 2) "
                         f"with n_bits a multiple of 32 up to {MAX_BITS} and "
                         f"|offset| <= 127")
    order = np.lexsort((pts[:, 0], pts[:, 1]))
    dx, dy = pts[order, 0] & 0xff, pts[order, 1] & 0xff
    return torch.as_tensor((dx | dy << 8 | order << 16).astype(np.int32))


def _offsets(table):
    """The table back to (n_bits, 2, 2) int64 offsets."""
    e = table.to(torch.int64)
    dxy = torch.stack([e & 0xff, (e >> 8) & 0xff], -1)
    dxy = (dxy ^ 0x80) - 0x80                                # sign-extend
    pts = torch.empty_like(dxy)
    pts[(e >> 16) & 0xffff] = dxy
    return pts.reshape(-1, 2, 2)


def plain(img, xy, table):
    """The plain PyTorch twin, the gather form with the kernel's clamping.
    img (B, H, W) float32; xy (B, N, 2); table from `sample_table`
    -> (B, N, n_words) uint32."""
    B, H, W = img.shape
    px, py = keypoint_pixels(xy, H, W)                       # (B, N)
    pat = _offsets(table)
    sx = (px[..., None, None] + pat[..., 0]).clamp(0, W - 1)  # (B, N, n, 2)
    sy = (py[..., None, None] + pat[..., 1]).clamp(0, H - 1)
    vals = img.reshape(B, -1).gather(1, (sy * W + sx).reshape(B, -1))
    vals = vals.reshape(sx.shape)
    return pack_bits(vals[..., 0] < vals[..., 1])


def brief_keypoints(img, xy, table):
    """(B, H, W) float32 blurred images, (B, N, 2) float32 keypoints (x, y)
    and the pattern's `sample_table` on the images' device
    -> (B, N, n_words) uint32; N = 0 gives an empty result without a
    launch.  Non-contiguous inputs are copied; any other dtype or rank
    raises."""
    n_bits = table.shape[0] // 2
    if (table.ndim != 1 or table.dtype != torch.int32 or n_bits % 32
            or not 0 < n_bits <= MAX_BITS):
        raise ValueError(f"brief_keypoints: table {tuple(table.shape)} "
                         f"{table.dtype}; takes `sample_table` of a pattern")
    if img.ndim != 3 or xy.ndim != 3 or xy.shape[0] != img.shape[0] \
            or xy.shape[2] != 2:
        raise ValueError(f"brief_keypoints takes (B, H, W) images and "
                         f"(B, N, 2) keypoints, got {tuple(img.shape)} and "
                         f"{tuple(xy.shape)}")
    if xy.shape[1] == 0:
        return torch.empty((img.shape[0], 0, n_bits // 32),
                           dtype=torch.uint32, device=img.device)
    if img.device.type == "cpu":
        return plain(img, xy, table)
    if img.device.type != "cuda":
        raise ValueError(f"brief_keypoints: unsupported device {img.device}")
    if img.dtype != torch.float32 or xy.dtype != torch.float32:
        raise TypeError("brief_keypoints takes float32 images and keypoints")
    if xy.device != img.device or table.device != img.device:
        raise ValueError("brief_keypoints: images, keypoints and table "
                         "must lie on one device")
    global launches
    img, xy, table = img.contiguous(), xy.contiguous(), table.contiguous()
    B, H, W = img.shape
    N = xy.shape[1]
    out = torch.empty((B, N, n_bits // 32), dtype=torch.uint32,
                      device=img.device)
    lib = _build.library("brief_keypoints", _SIG)
    rc = lib.brief_keypoints_launch(
        img.data_ptr(), xy.data_ptr(), table.data_ptr(), out.data_ptr(),
        B, N, H, W, n_bits, _build.stream_handle(img.device))
    _build.check(rc, "brief_keypoints")
    launches += 1
    return out

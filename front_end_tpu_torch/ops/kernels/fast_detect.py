"""Dense FAST detect kernel: margins + threshold gate + optional
tie-annihilating NMS -> the map of surviving corner scores
(`csrc/fast_detect.cu`).

Replaces `front_end_tpu/ops/pallas/fast_kernel.py::fast_detect_pallas`
(Pallas body `_detect_kernel`, core `_nms_survivors`).

What bounds it on the H100: operations, narrowly.  One float32 image is
read and one map written (8 bytes per pixel, 12 with a threshold map)
against ~200 float32 ops per pixel of the 16-point segment test plus the
NMS; at 67 TFLOP/s the operations take slightly longer than the bytes at
3.35 TB/s.

Design: one block per 32×32-pixel tile.  The tile with a 4-pixel halo (3
for the circle, 1 for the NMS) is staged in shared memory with clamped
reads — the TPU kernel edge-pads a copy of the image and of the threshold
map in memory; here neither copy exists, and a scalar threshold travels
as a scalar (a map pointer is taken only when the caller has a map).  The
gated scores of the tile and its 1-pixel ring go to shared memory, since
cv2's NMS compares the THRESHOLDED sparse scores; then each thread applies
the strict `>` NMS to four pixels.  Without NMS there is no ring.  The
segment-test code is shared with the other two FAST kernels
(`csrc/fast_segment.cuh`).  Any H, W >= 7; the ragged edge is masked.  The
map equals `fast.detect_dense_plain` bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops.kernels import _build
from front_end_tpu_torch.ops.kernels.fast_margins import as_batch

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fast_detect_launch": [_P, ctypes.c_float, _P, ctypes.c_longlong, _P,
                               _I, _I, _I, _I, _I, _P]}

plain = fast_mod.detect_dense_plain


def _threshold_args(threshold, imgs, shape):
    """-> (scalar, map tensor | None, batch stride) for the (B, H, W)
    batch `imgs` of an image of `shape`.  A Python number or a one-element
    tensor is a scalar; a (H, W) map is shared by the batch (stride 0);
    anything else is broadcast to the image's shape."""
    B, H, W = imgs.shape
    if not isinstance(threshold, torch.Tensor):
        return float(threshold), None, 0
    if threshold.numel() == 1:
        return float(threshold), None, 0
    if threshold.device != imgs.device:
        raise ValueError(f"fast_detect: threshold map on {threshold.device}, "
                         f"image on {imgs.device}")
    if threshold.dtype != torch.float32:
        raise TypeError("fast_detect takes a float32 threshold map, got "
                        f"{threshold.dtype}")
    if threshold.shape == (H, W):
        return 0.0, threshold.contiguous(), 0
    tmap = torch.broadcast_to(threshold, shape).reshape(B, H, W).contiguous()
    return 0.0, tmap, H * W


def fast_detect(img, threshold, fast_type: str = "9_16", nms: bool = True):
    """(..., H, W) float32 image + scalar or per-pixel threshold
    -> surviving-corner response map of the image's shape."""
    if img.device.type == "cpu":
        return plain(img, threshold, fast_type, nms)
    global launches
    imgs = as_batch(img, "fast_detect")
    B, H, W = imgs.shape
    n = len(fast_mod.TYPES[fast_type][0])
    t, tmap, tstride = _threshold_args(threshold, imgs, img.shape)
    out = torch.empty_like(imgs)
    lib = _build.library("fast_detect", _SIG)
    rc = lib.fast_detect_launch(
        imgs.data_ptr(), t, None if tmap is None else tmap.data_ptr(),
        tstride, out.data_ptr(), B, H, W, n, int(bool(nms)),
        _build.stream_handle(imgs.device))
    _build.check(rc, "fast_detect")
    launches += 1
    return out.reshape(img.shape)

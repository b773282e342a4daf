"""Dense FAST margin kernel: the (detect, score) margin maps of an image
with the 3-pixel border zeroed (`csrc/fast_margins.cu`).

Replaces `front_end_tpu/ops/pallas/fast_kernel.py::fast_margins_pallas`
(Pallas body `_kernel`).

What bounds it on the H100: operations.  One float32 image is read and
two maps of the same size are written (12 bytes per pixel, 1.7 µs for a
KITTI image at 3.35 TB/s) against 83 float min/max per pixel of the
16-point segment test (the arc network of `csrc/fast_segment.cuh`, 41 a
brightness class, and the score max), which run at 64 results per clock
and SM, half the rate of an addition: 2.3 µs.  There is no threshold
here, so nothing can be skipped.

Design: one block per 32×16-pixel window, four warps, each taking a
window row at a time (4 rows a warp); the window plus its 3-pixel circle
halo is staged in shared memory once with
clamped reads, all of a thread's loads in flight (the TPU kernel pads a
copy of the image in memory instead); every pixel takes the segment test
shared with the other two FAST kernels, cv2's border is zeroed by a
select, and a warp writes 32 consecutive floats of each map.  Any H, W >=
7; the ragged edge is masked.  Only min, max, compares and one
subtraction per margin touch the values, and rounding is monotone, so the
maps equal `fast.fast_margins_plain`, which subtracts first, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from front_end_tpu_torch.ops import fast as fast_mod
from front_end_tpu_torch.ops.kernels import _build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fast_margins_launch": [_P, _P, _P, _I, _I, _I, _I, _P]}

plain = fast_mod.fast_margins_plain


def as_batch(img, what: str):
    """A float32 CUDA image (..., H, W) -> contiguous (B, H, W), the
    leading dims flattened into the batch."""
    if img.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 images, got {img.dtype}")
    if img.ndim < 2:
        raise ValueError(f"{what} takes (..., H, W) images, got "
                         f"{tuple(img.shape)}")
    b = img.reshape((-1,) + img.shape[-2:]).contiguous()
    B, H, W = b.shape
    if H < 7 or W < 7 or not 1 <= B <= 65535:
        raise ValueError(f"{what}: image batch {tuple(b.shape)} (needs "
                         "H, W >= 7 and 1 <= B <= 65535)")
    return b


def fast_margins(img, fast_type: str = "9_16"):
    """(..., H, W) float32 -> (detect, score) of the same shape."""
    if img.device.type == "cpu":
        return plain(img, fast_type)
    global launches
    imgs = as_batch(img, "fast_margins")
    B, H, W = imgs.shape
    n = len(fast_mod.TYPES[fast_type][0])
    detect = torch.empty_like(imgs)
    score = torch.empty_like(imgs)
    lib = _build.library("fast_margins", _SIG)
    rc = lib.fast_margins_launch(
        imgs.data_ptr(), detect.data_ptr(), score.data_ptr(), B, H, W, n,
        _build.stream_handle(imgs.device))
    _build.check(rc, "fast_margins")
    launches += 1
    return detect.reshape(img.shape), score.reshape(img.shape)

"""Dense FAST margin kernel: the (detect, score) margin maps of an image
with the 3-pixel border zeroed (`csrc/fast_margins.cu`).

Replaces `front_end_tpu/ops/pallas/fast_kernel.py::fast_margins_pallas`
(Pallas body `_kernel`).

What bounds it on the H100: bytes, narrowly.  One float32 image is read
and two maps of the same size are written (12 bytes per pixel) against
~190 float32 min/max/subtract ops per pixel of the 16-point segment test;
at the card's 3.35 TB/s and 67 TFLOP/s the bytes take about a quarter
longer than the operations.

Design: one block per 32×32-pixel tile; the tile plus its 3-pixel circle
halo is staged in shared memory once with clamped reads (the TPU kernel
pads a copy of the image in memory instead), each thread computes four
pixels with the segment-test code shared with the other two FAST kernels
(`csrc/fast_segment.cuh`) and writes both maps.  Any H, W >= 7; the
ragged edge is masked.  Only subtractions, min, max and compares touch
the values, so the maps equal `fast.fast_margins_plain` bit for bit.
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

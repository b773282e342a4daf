"""The float32 pin of the reference, and the switch of its control.

Every entry of the reference computes matrix products in true float32
(TF32 off), as the configurations state.  `control()` turns TF32 on for
everything the reference computes inside it: the nearest precision below
the stated one, whose results `correct` must refuse."""
from __future__ import annotations

import contextlib
import functools

import torch

_TF32 = [False]     # inside `control()`


@contextlib.contextmanager
def pinned_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = _TF32[0]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_precision(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with pinned_f32():
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def control():
    """The reference's products in TF32 instead of float32."""
    _TF32[0] = True
    try:
        yield
    finally:
        _TF32[0] = False


def resolve_device(device="cuda") -> torch.device:
    return torch.device(device)

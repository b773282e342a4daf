"""Static-shaped data contracts (counterpart of `front_end_tpu/types.py`).

Every keypoint / descriptor / match set is padded to a fixed capacity
with a validity mask, as in the JAX package; invalid rows carry finite
garbage and consumers must mask.  Plain dataclasses of tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class Keypoints:
    xy: torch.Tensor        # (N, 2) float32 — x (col), y (row)
    score: torch.Tensor     # (N,) float32 — detector response
    angle: torch.Tensor     # (N,) float32 — radians, 0 if undefined
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self):
        return self.valid.sum(-1)

    @classmethod
    def empty(cls, n: int, device=None):
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return cls(xy=torch.zeros(n, 2, dtype=torch.float32, device=device),
                   score=z, angle=z.clone(),
                   valid=torch.zeros(n, dtype=torch.bool, device=device))

    def replace(self, **kw) -> "Keypoints":
        return dataclasses.replace(self, **kw)


@dataclass
class Descriptors:
    """Descriptors of N keypoints.

    Binary (`norm="hamming"`, matched by Hamming distance): `bits` (N, D)
    float32 in {0, 1} and `packed` (N, D // 32) uint32, either may be None.
    Float (`norm="l2"`, SURF; matched by L2 distance): `bits` (N, D)
    float32 values and `packed` None — float descriptors have no packed
    layout."""
    bits: torch.Tensor | None
    packed: torch.Tensor | None = None
    norm: str = "hamming"

    def words(self) -> torch.Tensor:
        """The packed layout, packing `bits` when it was not kept.  Raises
        for float descriptors: packing would read their values as bits."""
        if self.norm != "hamming":
            raise TypeError(f"{self.norm!r} descriptors are float values; "
                            "they have no packed layout")
        return self.packed if self.packed is not None else pack_bits(
            self.bits)


@dataclass
class Matches:
    train_idx: torch.Tensor   # (Nq,) int64 — matched train row
    distance: torch.Tensor    # (Nq,) float32
    valid: torch.Tensor       # (Nq,) bool

    @property
    def count(self):
        return self.valid.sum(-1)

    def replace(self, **kw) -> "Matches":
        return dataclasses.replace(self, **kw)


def words_to_uint32(words):
    """Integer tensor of 32-bit words (values in [0, 2^32)) -> uint32.

    PyTorch has few kernels for uint32, on CUDA especially, so the port
    computes on int64/int32 and only reinterprets the final bits."""
    return words.to(torch.int32).view(torch.uint32)


def pack_bits(bits):
    """{0,1} (..., D) -> uint32 (..., D//32), bit j of word w = bit 32w+j
    (the JAX package's order, `types.py:69-76`)."""
    d = bits.shape[-1]
    if d % 32:
        raise ValueError(f"descriptor length {d} is not a multiple of 32")
    b = bits.reshape(bits.shape[:-1] + (d // 32, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return words_to_uint32((b << shifts).sum(-1))


def unpack_bits(packed, dtype=torch.float32):
    """uint32 (..., W) -> {0,1} (..., 32W)."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    b = (packed.view(torch.int32).to(torch.int64)[..., None] >> shifts) & 1
    return b.reshape(packed.shape[:-1] + (packed.shape[-1] * 32,)).to(dtype)

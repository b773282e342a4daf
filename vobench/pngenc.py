"""8-bit grey PNG files as libpng writes them by default: each row takes
the filter whose filtered bytes have the least sum of absolute values
read as signed bytes (libpng's heuristic for 8-bit images; on a tie the
earlier of None, Sub, Up, Average, Paeth), the rows are deflated with
zlib at level 6 and the `Z_FILTERED` strategy, and the stream is cut into
IDAT chunks of 8192 bytes.  Real KITTI files carry such filtered rows,
so a decoder meets the same row filters here as there."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
IDAT_BYTES = 8192
ZLIB_LEVEL = 6


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W + 1) uint8: each row's filter type, then its
    filtered bytes."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                       # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                             # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]                    # up-left
    cand = np.stack([x, x - a, x - b, x - (a + b) // 2,
                     x - _paeth(a, b, c)]) & 0xFF        # (5, H, W)
    signed = np.where(cand < 128, cand, 256 - cand)
    choice = signed.sum(-1).argmin(0)                    # first minimum
    rows = np.take_along_axis(cand, choice[None, :, None], 0)[0]
    return np.concatenate([choice[:, None], rows], 1).astype(np.uint8)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """(H, W) uint8 grey -> PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"encode takes (H, W) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape
    z = zlib.compressobj(ZLIB_LEVEL, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    data = z.compress(filter_rows(img).tobytes()) + z.flush()
    idat = b"".join(_chunk(b"IDAT", data[i:i + IDAT_BYTES])
                    for i in range(0, len(data), IDAT_BYTES))
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + idat + _chunk(b"IEND", b""))

"""A small 8-bit PNG codec on numpy and `zlib`, for machines without PIL.

`decode` reads non-interlaced 8-bit gray (colour type 0), RGB (2) and
RGBA (6) files with any of the five row filters, and reduces colour to
gray as PIL's `convert("L")` does (ITU-R 601-2 luma in 16-bit fixed
point, alpha ignored).  `encode` writes 8-bit gray or RGB with filter 0
in one IDAT chunk.  Any other PNG raises `ValueError`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (rowbytes + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = rows.reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:                       # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), 0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:                       # Up
            cur = line + prev
        elif ft in (3, 4):                  # Average, Paeth: sequential
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(rowbytes):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ft} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 gray."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    ihdr, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): this decoder reads non-interlaced "
            "8-bit gray, RGB and RGBA; install PIL for others")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch == 1:
        return px[..., 0]
    rgb = px[..., :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
    return ((luma + 0x8000) >> 16).astype(np.uint8)


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def encode(img) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes (filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"cannot encode an image of shape {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def write(path, img) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))

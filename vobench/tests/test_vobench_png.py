"""The libpng-style encoder round-trips through the port's KITTI reader,
with PIL and with the port's own decoder."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from front_end_tpu_torch.io import kitti
from front_end_tpu_torch.utils import png as port_png
from vobench import frames, pngenc


def filter_counts(data: bytes) -> list[int]:
    """How many rows of a grey 8-bit PNG use each of the five filters."""
    pos, w, h, idat = len(pngenc.SIGNATURE), 0, 0, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    kinds = raw.reshape(h, w + 1)[:, 0]
    return [int((kinds == k).sum()) for k in range(5)]


def _image(seed=0, h=40, w=57):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    img[:, : w // 2] = np.cumsum(rng.integers(-3, 4, (h, w // 2)),
                                 1).astype(np.uint8)    # smooth rows
    return img


def test_round_trip_through_read_image(tmp_path):
    img = _image()
    path = tmp_path / "000000.png"
    path.write_bytes(pngenc.encode(img))
    assert np.array_equal(kitti._read_image(str(path)), img)
    assert np.array_equal(port_png.decode(path.read_bytes()), img)


def test_rows_take_every_filter_the_heuristic_picks():
    img = _image(1, 64, 300)
    img[10] = 7                                       # a flat row: Sub
    counts = filter_counts(pngenc.encode(img))
    assert sum(counts) == 64
    assert counts[4] > 0 and counts[1] > 0            # Paeth and Sub rows


def test_filter_choice_is_least_signed_sum():
    img = _image(2, 12, 30)
    rows = pngenc.filter_rows(img)
    x = img.astype(int)
    for y in range(12):
        a = np.r_[0, x[y, :-1]]
        b = x[y - 1] if y else np.zeros(30, int)
        c = np.r_[0, b[:-1]]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        cands = [x[y], x[y] - a, x[y] - b, x[y] - (a + b) // 2,
                 x[y] - paeth]
        sums = [np.where(v % 256 < 128, v % 256, 256 - v % 256).sum()
                for v in cands]
        assert rows[y, 0] == int(np.argmin(sums))
        assert np.array_equal(rows[y, 1:], cands[rows[y, 0]] % 256)


def test_multiple_idat_chunks(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (200, 300)).astype(
        np.uint8)
    data = pngenc.encode(img)
    assert data.count(b"IDAT") > 1
    assert np.array_equal(port_png.decode(data), img)


def test_png_cache_keeps_the_keys_used_last(tmp_path, monkeypatch):
    """A seed's files are written once and read again by later runs of
    that seed; past `PNG_KEEP` keys the one used longest ago goes."""
    monkeypatch.setattr(frames, "PNG_KEEP", 2)
    cfg = {"name": "tiny", "rig": {"fx": 10.0, "fy": 10.0, "cx": 4.0,
                                   "cy": 3.0, "baseline": 0.5,
                                   "width": 9, "height": 7}}
    traffic = {"unique_pairs": 2}
    img = np.arange(2 * 7 * 9, dtype=np.uint8).reshape(2, 7, 9)
    fr = frames.Frames(img, img[::-1].copy(), np.zeros((2, 4, 4)), None)
    roots = {s: frames.write_png(fr, cfg, traffic, s, tmp_path)
             for s in (1, 2)}
    first = roots[1] / "sequences/00/image_0/000000.png"
    before = first.stat().st_mtime_ns
    assert frames.write_png(fr, cfg, traffic, 1, tmp_path) == roots[1]
    assert first.stat().st_mtime_ns == before           # read, not written
    assert np.array_equal(kitti._read_image(str(first)), img[0])
    frames.write_png(fr, cfg, traffic, 3, tmp_path)     # 2 goes, not 1
    assert roots[1].exists() and not roots[2].exists()
    assert len(list((tmp_path / "png").iterdir())) == 2

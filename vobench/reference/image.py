"""Dense image primitives (frozen from the port's `ops/image.py`).

Images are (..., H, W) float32 in [0, 255]; keypoints are (x=col, y=row).
"""
from __future__ import annotations

import torch


def _edge_index(n: int, lo: int, hi: int, device):
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def shift_views(img, ry: int, rx: int | None = None):
    """Pad once by (ry, rx) edge pixels; `view(dy, dx)` gives
    out[y, x] = img[clamp(y+dy), clamp(x+dx)] as a slice of that buffer."""
    if rx is None:
        rx = ry
    H, W = img.shape[-2:]
    p = img.index_select(-2, _edge_index(H, ry, ry, img.device)) \
        .index_select(-1, _edge_index(W, rx, rx, img.device))

    def view(dy: int, dx: int):
        return p[..., ry + dy:ry + dy + H, rx + dx:rx + dx + W]

    return view


def _box1d(x, size: int, dim: int):
    """Sliding-window sum along `dim` with edge padding, via cumsum — the
    JAX package's exact form (`image.py:79-95`), so for integer-valued
    frames every partial sum is an exact float32 integer in any order."""
    r = size // 2
    n = x.shape[dim]
    idx = _edge_index(n, r, size - 1 - r, x.device)
    c = torch.cumsum(x.index_select(dim, idx), dim=dim)
    zshape = list(c.shape)
    zshape[dim] = 1
    c = torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device), c],
                  dim)
    return c.narrow(dim, size, n) - c.narrow(dim, 0, n)


def box_blur(img, size: int):
    """size×size mean filter (the BRIEF pre-smoothing; OpenCV uses 9×9)."""
    img = img.to(torch.float32)
    s = _box1d(_box1d(img, size, img.ndim - 1), size, img.ndim - 2)
    return s * (1.0 / (size * size))   # the scalar rounds to float32 first


def integral_image(img):
    """Summed-area table with a leading zero row and column: (..., H+1,
    W+1) float32; the sum over [y0, y1) × [x0, x1) is ii[y1, x1] −
    ii[y0, x1] − ii[y1, x0] + ii[y0, x0].

    The JAX package scans in float32, exact only while every partial sum
    stays below 2^24 (integer images up to 255 over about 65 k pixels); a
    KITTI frame sums to ~10^8, where each library's scan rounds in its own
    order.  The port scans in float64, exact for integer-valued images of
    any realistic size, and rounds each entry to float32 once: the card and
    the CPU give the same table, equal to the JAX package's wherever that
    one is exact."""
    ii = torch.cumsum(torch.cumsum(img.to(torch.float64), -1), -2)
    return torch.nn.functional.pad(ii.to(torch.float32), (1, 0, 1, 0))



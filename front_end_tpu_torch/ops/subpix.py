"""Sub-pixel corner refinement, batched `cv::cornerSubPix` (counterpart of
`front_end_tpu/ops/subpix.py`).

At the true corner q, ∇I(p)·(q − p) = 0 for every window pixel p, weighted
by exp(−(r/win)²): A = Σ w ∇I∇Iᵀ, b = Σ w (∇I∇Iᵀ)·p, q = A⁻¹b, repeated.
The windowed sums are separable convolutions of five dense gradient-product
maps, built once; each iteration then samples the five maps bilinearly at
the current estimates and solves N 2×2 systems in closed form.
"""
from __future__ import annotations

import numpy as np
import torch

from front_end_tpu_torch.ops import image as image_ops


def corner_subpix(img, xy, valid=None, *, win: int = 5, iters: int = 5,
                  max_shift: float | None = None):
    """Refine (N, 2) keypoints on one (H, W) image.

    win=5 gives the 11×11 window of the reference.  Steps are clamped to
    the window; a refinement that ends more than 1.5·win from its seed is
    reverted; `max_shift` caps the total distance (the VO path uses 0.3
    px); rows that are not `valid` pass through unchanged."""
    img = img.to(torch.float32)
    xy = xy.to(torch.float32)
    H, W = img.shape
    dev = img.device

    v = image_ops.shift_views(img, 1, 1)
    gx = 0.5 * (v(0, 1) - v(0, -1))
    gy = 0.5 * (v(1, 0) - v(-1, 0))
    X = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    Y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    mxx, mxy, myy = gx * gx, gx * gy, gy * gy
    px = mxx * X + mxy * Y
    py = mxy * X + myy * Y

    t = np.arange(-win, win + 1, dtype=np.float32)
    k = np.exp(-(t * t) / (win * win)).astype(np.float32)
    maps = image_ops._sep_conv(torch.stack([mxx, mxy, myy, px, py]), k,
                               k).reshape(5, -1)

    def sample5(pts):
        """The five maps at (N, 2) points, one set of bilinear weights."""
        x = pts[:, 0].clamp(0.0, W - 1.001)
        y = pts[:, 1].clamp(0.0, H - 1.001)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx, fy = x - x0, y - y0
        i00 = y0 * W + x0
        v00, v01 = maps[:, i00], maps[:, i00 + 1]
        v10, v11 = maps[:, i00 + W], maps[:, i00 + W + 1]
        return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
                + fy * ((1 - fx) * v10 + fx * v11))        # (5, N)

    q = xy
    for _ in range(iters):
        sxx, sxy, syy, sbx, sby = sample5(q)
        det = sxx * syy - sxy * sxy
        ok = det.abs() > 1e-9
        det = torch.where(ok, det, torch.ones_like(det))
        nx = (syy * sbx - sxy * sby) / det
        ny = (sxx * sby - sxy * sbx) / det
        shift = torch.where(ok[:, None], torch.stack([nx, ny], -1) - q,
                            torch.zeros_like(q))
        q = q + shift.clamp(-float(win), float(win))

    q = q.clamp(min=0.0)        # no host copy: a CUDA graph may hold it
    q = torch.stack([q[:, 0].clamp(max=W - 1.0), q[:, 1].clamp(max=H - 1.0)],
                    -1)
    d = q - xy
    moved = torch.sqrt((d * d).sum(-1))
    q = torch.where((moved <= win * 1.5)[:, None], q, xy)
    if max_shift is not None:
        d = q - xy
        n = torch.sqrt((d * d).sum(-1, keepdim=True)).clamp(min=1e-9)
        q = xy + d * torch.clamp(max_shift / n, max=1.0)
    if valid is not None:
        q = torch.where(valid[:, None], q, xy)
    return q

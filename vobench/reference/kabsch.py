"""Rigid 3D-3D alignment (frozen from the port's `motion/kabsch.py`).

Returns H = [R | t] with Xb ≈ R·Xa + t, the extrinsic map frame a -> b.
"""
from __future__ import annotations

import torch

from vobench.reference import se3
from vobench.reference.precision import f32_precision


@f32_precision
def rigid_transform_3d(Xa, Xb, weights=None):
    """Weighted Kabsch.  Xa, Xb: (..., N, 3); weights: (..., N) or None.
    SVD of the weighted cross-covariance with the det < 0 reflection fix;
    zero-weight rows are ignored."""
    if weights is None:
        weights = torch.ones(Xa.shape[:-1], dtype=Xa.dtype, device=Xa.device)
    w = weights.to(Xa.dtype)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    ca = (wn[..., None] * Xa).sum(-2)
    cb = (wn[..., None] * Xb).sum(-2)
    A = Xa - ca[..., None, :]
    B = Xb - cb[..., None, :]
    Hc = torch.einsum("...ni,...nj->...ij", wn[..., None] * A, B)
    U, _, Vt = torch.linalg.svd(Hc)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    R = V @ Ut
    flip = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0)
    V = torch.cat([V[..., :2], V[..., 2:] * flip[..., None, None]], -1)
    R = V @ Ut
    t = cb - torch.einsum("...ij,...j->...i", R, ca)
    return se3.create_homog(R, t)


def alignment_residuals(H, Xa, Xb):
    """Per-landmark Euclidean residual ||H·Xa − Xb||: (..., N)."""
    return torch.linalg.norm(se3.transform_points(H, Xa) - Xb, dim=-1)

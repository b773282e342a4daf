"""SE(3) / SO(3) utilities (frozen from the port's `geometry/se3.py`).

Batched over leading dims, built from out-of-place ops only (`stack`,
`cat`, `where`) so `torch.func.jacfwd` can differentiate through them —
the LM solver takes its Jacobian that way.
"""
from __future__ import annotations

import math

import torch

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi


def create_homog(R=None, T=None):
    """Pack [R|T; 0 1] -> (..., 4, 4)."""
    if R is None:
        R = torch.eye(3, dtype=T.dtype, device=T.device)
    if T is None:
        T = torch.zeros(3, dtype=R.dtype, device=R.device)
    T = T.reshape(R.shape[:-2] + (3,))
    top = torch.cat([R, T[..., None]], -1)                     # (..., 3, 4)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                       -1)
    return torch.cat([top, bottom], -2)


def euler_matrix(ai, aj, ak):
    """Rotation (..., 3, 3) from static-frame 'szxy' Euler angles (radians),
    tf's `euler_matrix` for that axis sequence (the reference composes
    every motion with it)."""
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    # szxy: i = z (2), j = x (0), k = y (1)
    rows = {2: (cj * ck, sj * sc - cs, sj * cc + ss),
            0: (cj * sk, sj * ss + cc, sj * cs - sc),
            1: (-sj, cj * si, cj * ci)}
    order = (2, 0, 1)            # column of each (i, j, k) slot
    M = [[None] * 3 for _ in range(3)]
    for r, vals in rows.items():
        for c, v in zip(order, vals):
            M[r][c] = v
    return torch.stack([torch.stack(row, -1) for row in M], -2)


def invert_homog(H):
    """Rigid inverse: [R|t]⁻¹ = [Rᵀ | -Rᵀ t]."""
    R = H[..., :3, :3]
    t = H[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    return create_homog(Rt, (-Rt @ t)[..., 0])


def hat(w):
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_log(R):
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3)."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(c)
    small = theta < 1e-6
    scale = torch.where(
        small, 0.5 + theta ** 2 / 12.0,
        theta / (2.0 * torch.sin(torch.where(small, torch.ones_like(theta),
                                             theta))))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return scale[..., None] * w


def se3_exp(xi):
    """se(3) exp: (..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta < 1e-6
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    W = hat(w)
    WW = W @ W
    eye = _eye_like(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return create_homog(R, t)


def se3_log(H):
    """se(3) log: (..., 4, 4) -> (..., 6) [v, w]."""
    R = H[..., :3, :3]
    t = H[..., :3, 3]
    w = so3_log(R)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta < 1e-6
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / theta2)
    W = hat(w)
    Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def transform_points(H, X):
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return X @ H[..., :3, :3].transpose(-1, -2) + H[..., None, :3, 3]

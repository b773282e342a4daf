"""Essential-matrix egomotion (counterpart of
`front_end_tpu/motion/essential.py`): the normalised 8-point fit inside
batched RANSAC, decomposition, the cheirality vote and the metric scale
from stereo-triangulated pairs.

    RANSAC(E) on the left-camera tracks a -> b  ->  4 (R, t) candidates
    -> the one with the most inliers in front of both cameras
    -> T = per-axis median of the inliers' 3-D displacements Xb - R·Xa

As in `motion/ransac.py`, the minimal sets come from a sampler
`(valid, n_hyps, k) -> (n_hyps, k)` row indices, where the JAX package
draws from a PRNG key.  Two forms differ from the JAX package's on
purpose, and both give its numbers:
- a design matrix of fewer than 9 rows is padded with zero rows before a
  reduced SVD, which leaves V unchanged and gives the null vector as the
  last row of Vᵀ, as JAX's `full_matrices=True` does, without building a
  full U for the 2304-row refit;
- the per-axis median averages the two middle values of an even count,
  as `jnp.nanmedian` does (`torch.nanmedian` returns the lower one).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.motion import ransac as ransac_mod
from front_end_tpu_torch.utils.precision import f32_precision, true_div


def normalize_points(x):
    """Hartley normalisation of (..., N, 2) points: zero centroid, mean
    distance sqrt(2) -> (x_norm, T (..., 3, 3)) with x_norm = T·x."""
    c = x.mean(-2, keepdim=True)
    d = torch.linalg.norm(x - c, dim=-1).mean(-1)
    s = torch.full_like(d, math.sqrt(2.0)) / d.clamp(min=1e-9)
    z = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * c[..., 0, 0]], -1),
                     torch.stack([z, s, -s * c[..., 0, 1]], -1),
                     torch.stack([z, z, one], -1)], -2)
    return (x - c) * s[..., None, None], T


def null_vector(A):
    """The right singular vector of the smallest singular value of
    (..., M, n) matrices: rows padded with zeros to n when M < n."""
    m, n = A.shape[-2:]
    if m < n:
        A = F.pad(A, (0, 0, 0, n - m))
    return torch.linalg.svd(A, full_matrices=False)[2][..., -1, :]


def _epipolar_rows(xa, xb):
    """(..., N, 9) rows of xbᵀ·E·xa = 0."""
    x1, y1 = xa[..., 0], xa[..., 1]
    x2, y2 = xb[..., 0], xb[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                        x1, y1, torch.ones_like(x1)], -1)


def eight_point(xa, xb, weights=None):
    """Normalised 8-point essential matrices of (..., N, 2) normalised
    camera coordinates (N >= 8), optionally row-weighted -> (..., 3, 3),
    rank 2 with singular values (1, 1, 0)."""
    na, Ta = normalize_points(xa)
    nb, Tb = normalize_points(xb)
    A = _epipolar_rows(na, nb)
    if weights is not None:
        A = A * weights[..., None]
    Fm = null_vector(A).reshape(A.shape[:-2] + (3, 3))
    Fm = Tb.transpose(-1, -2) @ Fm @ Ta
    U, _, Vt = torch.linalg.svd(Fm)
    diag = torch.tensor([1.0, 1.0, 0.0], device=Fm.device)
    return (U * diag) @ Vt


def sampson_error(E, xa, xb):
    """First-order geometric error of (N, 2) correspondences under
    (..., 3, 3) essential matrices -> (..., N)."""
    one = torch.ones_like(xa[:, :1])
    xa_h = torch.cat([xa, one], -1)
    xb_h = torch.cat([xb, one], -1)
    Ex1 = xa_h @ E.transpose(-1, -2)                 # (..., N, 3) E·xa
    Etx2 = xb_h @ E                                  # (..., N, 3) Eᵀ·xb
    num = (xb_h * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return torch.sqrt(num / den.clamp(min=1e-12))


# the reference's D matrix (getDNister)
_D_NISTER = np.array([[0.0, 1.0, 0.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0]], np.float32)


def decompose_essential(E):
    """E -> (Ra, Rb, t): the two rotations and the translation direction,
    determinant signs of U and Vᵀ fixed to +1."""
    U, _, Vt = torch.linalg.svd(E)
    U = torch.where(torch.linalg.det(U)[..., None, None] < 0, -U, U)
    Vt = torch.where(torch.linalg.det(Vt)[..., None, None] < 0, -Vt, Vt)
    D = torch.as_tensor(_D_NISTER, device=E.device)
    return U @ D @ Vt, U @ D.T @ Vt, U[..., :, 2]


def triangulate_two_view(R, t, xa, xb):
    """DLT triangulation of (N, 2) normalised correspondences under P0 =
    [I|0], P1 = [R|t] for (..., 3, 3) R and (..., 3) t -> points (..., N,
    3) in frame a and the depths (za, zb), each (..., N)."""
    dev = xa.device
    P0 = torch.cat([torch.eye(3, device=dev), torch.zeros(3, 1, device=dev)],
                   -1)
    P1 = torch.cat([R, t[..., None]], -1)

    def rows(P, x):
        # two rows per view: x*P3 - P1, y*P3 - P2 -> (..., N, 2, 4)
        P = P[..., None, :, :]
        return torch.stack([x[:, 0:1] * P[..., 2, :] - P[..., 0, :],
                            x[:, 1:2] * P[..., 2, :] - P[..., 1, :]], -2)

    r0, r1 = rows(P0, xa), rows(P1, xb)
    A = torch.cat(torch.broadcast_tensors(r0, r1), -2)     # (..., N, 4, 4)
    Xh = torch.linalg.svd(A)[2][..., -1, :]
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    X = Xh[..., :3] / w[..., None]
    zb = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    return X, X[..., 2], zb


def select_cheirality(E, xa, xb, inliers):
    """The 4-way vote: the (R, t) with the most inliers triangulating in
    front of both cameras (first candidate among equal votes)."""
    Ra, Rb, t = decompose_essential(E)
    cands_R = torch.stack([Ra, Ra, Rb, Rb])
    cands_t = torch.stack([t, -t, t, -t])
    _, za, zb = triangulate_two_view(cands_R, cands_t, xa, xb)
    votes = ((za > 0) & (zb > 0) & inliers).sum(-1)
    best = votes.argmax()
    return cands_R[best], cands_t[best], votes


def _nanmedian0(vals, ok):
    """Per-column median of the rows of (N, C) `vals` where `ok`: the mean
    of the two middle values for an even count, 0 for none — `jnp.nanmedian`
    followed by `nan_to_num`."""
    s = torch.sort(torch.where(ok[:, None], vals,
                               torch.full_like(vals, math.inf)), 0)[0]
    k = ok.sum()
    lo = ((k - 1).clamp(min=0) // 2).reshape(1, 1).expand(1, vals.shape[1])
    hi = (k // 2).clamp(max=vals.shape[0] - 1).reshape(1, 1).expand_as(lo)
    med = (s.gather(0, lo) + s.gather(0, hi))[0] * 0.5
    return torch.where(k > 0, med, torch.zeros_like(med))


def estimate_scale(Xa, Xb, R, inliers, *, robust: bool = True,
                   max_range: float = 50.0):
    """Metric translation from stereo-triangulated pairs: the inliers'
    per-axis median displacement Xb - R·Xa, rows beyond `max_range` dropped
    (`robust=False`: the inlier mean, the reference's closed form)."""
    disp = Xb - Xa @ R.T
    ok = inliers
    if robust:
        ok = ok & (Xa[:, 2] < max_range) & (Xb[:, 2] < max_range)
        return _nanmedian0(disp, ok)
    w = ok.to(torch.float32)
    return (disp * w[:, None]).sum(0) / w.sum().clamp(min=1e-9)


class EssentialResult(NamedTuple):
    H: torch.Tensor            # (4, 4) extrinsic map a -> b, metric T
    R: torch.Tensor
    T: torch.Tensor
    E: torch.Tensor
    inliers: torch.Tensor      # (N,) bool
    n_inliers: torch.Tensor
    votes: torch.Tensor        # (4,) cheirality votes


@f32_precision
def essential_scaled_motion(sampler: Callable, uva, uvb, Xa, Xb, valid, rig,
                            *, n_hyps: int = 256, threshold_px: float = 1.0,
                            solver: str = "eight_point") -> EssentialResult:
    """RANSAC essential estimation on the left-camera pixel tracks (a ->
    b), the cheirality vote, then the metric scale from the stereo
    triangulations Xa, Xb of the same rows.  uva, uvb: (N, >= 2) pixels
    (left view in columns 0:2); threshold in pixels.  solver "eight_point"
    (one batched fit per hypothesis) or "five_point" (`motion.five_point`,
    up to 10 candidates per minimal set); both refit the winning consensus
    with the weighted 8-point and keep the refit unless it shrinks it."""
    pp = torch.tensor([rig.cx, rig.cy], dtype=torch.float32,
                      device=uva.device)
    xa = true_div(uva[:, :2] - pp, rig.fx)            # normalised coords
    xb = true_div(uvb[:, :2] - pp, rig.fx)
    thr = float(np.float32(threshold_px) / np.float32(rig.fx))

    if solver == "five_point":
        from front_end_tpu_torch.motion import five_point as fp
        E0, inliers0, _, _ = fp.ransac_five_point(
            sampler, xa, xb, valid, n_hyps=n_hyps, threshold=thr)
        E1 = eight_point(xa, xb, inliers0.to(torch.float32))
        inliers1 = (sampson_error(E1, xa, xb) < thr) & valid
        better = inliers1.sum() >= inliers0.sum()
        E = torch.where(better, E1, E0)
        inliers = torch.where(better, inliers1, inliers0)
        n_inl = inliers.sum()
    elif solver == "eight_point":
        res = ransac_mod.ransac(
            sampler, lambda sub: eight_point(sub[0], sub[1]),
            lambda E, d: sampson_error(E, d[0], d[1]), (xa, xb), valid,
            k=8, n_hyps=n_hyps, threshold=thr,
            refit_fn=lambda d, w: eight_point(d[0], d[1], w))
        E, inliers, n_inl = res.H, res.inliers, res.n_inliers
    else:
        raise ValueError(f"unknown solver {solver!r}")
    R, t, votes = select_cheirality(E, xa, xb, inliers)
    T = estimate_scale(Xa, Xb, R, inliers)
    return EssentialResult(H=se3.create_homog(R, T), R=R, T=T, E=E,
                           inliers=inliers, n_inliers=n_inl, votes=votes)

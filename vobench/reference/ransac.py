"""Batched-hypothesis RANSAC (frozen from the port's `motion/ransac.py`).

All hypotheses are evaluated as one batch: draw (B, k) minimal sets ->
fit each -> (B, N) residuals -> inlier counts -> argmax -> refit on the
winner's inliers.

Minimal sets come from a SAMPLER, a callable `(valid, n_hyps, k) ->
(n_hyps, k) int64` row indices.  The JAX package draws from its PRNG,
which torch cannot reproduce; `InverseCdfSampler` draws uniforms from a
CPU `torch.Generator` and maps them through the same inverse CDF of the
validity cumsum (`ransac.py:38-52`), so CPU and CUDA runs of the port
draw identical sets, and parity tests pass a sampler that returns the
JAX-drawn sets.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vobench.reference import se3
from vobench.reference import kabsch
from vobench.reference.precision import f32_precision


class RansacResult(NamedTuple):
    H: torch.Tensor                # (4, 4) best (refit) model
    inliers: torch.Tensor          # (N,) bool consensus of the refit model
    n_inliers: torch.Tensor        # () int64
    best_hypothesis: torch.Tensor  # (4, 4) pre-refit winning model
    scores: torch.Tensor           # (B,) inlier counts of every hypothesis


def inverse_cdf(valid, u):
    """Map uniforms u in [0, 1) to valid row indices, uniformly: draw r in
    [0, #valid) and find the r-th valid row by `searchsorted`."""
    n = valid.shape[0]
    c = torch.cumsum(valid.to(torch.int64), 0)
    total = torch.clamp(c[-1], min=1)
    r = torch.minimum(torch.floor(u * total).to(torch.int64), total - 1)
    idx = torch.searchsorted(c, r, right=True)
    return torch.clamp(idx, max=n - 1)


class InverseCdfSampler:
    """Default sampler: uniforms from a CPU generator, moved to the data's
    device, through `inverse_cdf`.  Draws the same sets on every device.
    On the card the uniforms go through pinned memory, so the copy does
    not wait for the stream."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, valid, n_hyps: int, k: int):
        u = torch.rand((n_hyps, k), generator=self.generator,
                       dtype=torch.float64)
        if valid.device.type == "cuda":
            u = u.pin_memory().to(valid.device, non_blocking=True)
        return inverse_cdf(valid, u)


def ransac(sampler: Callable, fit_fn: Callable, residual_fn: Callable, data,
           valid, *, k: int, n_hyps: int = 512, threshold: float = 0.05,
           refit_fn: Callable | None = None) -> RansacResult:
    """Generic batched RANSAC.  fit_fn maps a batch of minimal sets
    (tuple of (B, k, ...) tensors) to (B, ...) models; residual_fn maps
    (..., models) and the full data to (..., N) residuals."""
    idx = sampler(valid, n_hyps, k)                       # (B, k)
    models = fit_fn(tuple(a[idx] for a in data))
    inl = (residual_fn(models, data) < threshold) & valid
    scores = inl.sum(-1)
    best_model = models[scores.argmax()]
    inliers = (residual_fn(best_model, data) < threshold) & valid
    if refit_fn is not None:
        model = refit_fn(data, inliers.to(torch.float32))
        inliers2 = (residual_fn(model, data) < threshold) & valid
        # keep the refit only if it did not shrink the consensus
        better = inliers2.sum() >= inliers.sum()
        model = torch.where(better, model, best_model)
        inliers = torch.where(better, inliers2, inliers)
    else:
        model = best_model
    return RansacResult(H=model, inliers=inliers, n_inliers=inliers.sum(),
                        best_hypothesis=best_model, scores=scores)


def _triangle_frame(P):
    """Orthonormal frames (..., 3, 3) (columns e1, e2, e3) of (..., 3, 3)
    point triples."""
    v1 = P[..., 1, :] - P[..., 0, :]
    v2 = P[..., 2, :] - P[..., 0, :]
    e1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-12)
    n = torch.linalg.cross(v1, v2)
    e3 = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    e2 = torch.linalg.cross(e3, e1)
    return torch.stack([e1, e2, e3], -1)


def fit_rigid_minimal(Pa, Pb):
    """Closed-form rigid fit of minimal 3-point sets (..., 3, 3): compose
    the triangles' orthonormal frames, R = Fb·Faᵀ (no SVD)."""
    Fa = _triangle_frame(Pa)
    Fb = _triangle_frame(Pb)
    R = Fb @ Fa.transpose(-1, -2)
    t = Pb.mean(-2) - (R @ Pa.mean(-2)[..., None])[..., 0]
    return se3.create_homog(R, t)


@f32_precision
def rigid_ransac(sampler: Callable, Xa, Xb, valid, *, n_hyps: int = 512,
                 threshold: float = 0.05) -> RansacResult:
    """3-point rigid 3D-3D RANSAC with Euclidean alignment residuals and a
    weighted-Kabsch refit of the winner's inliers."""
    return ransac(sampler,
                  lambda sub: fit_rigid_minimal(sub[0], sub[1]),
                  lambda H, d: kabsch.alignment_residuals(H, d[0], d[1]),
                  (Xa, Xb), valid, k=3, n_hyps=n_hyps,
                  threshold=threshold,
                  refit_fn=lambda d, w: kabsch.rigid_transform_3d(d[0], d[1],
                                                                  w))

"""Windowed bundle adjustment: Schur-complement Levenberg-Marquardt
(counterpart of `front_end_tpu/ba/schur.py`).

The window is small (W poses, W ≤ ~10) while landmarks are many, so the
classic Schur trick applies:

  H = [ Hpp  Hpl ]   with Hll block-diagonal (3×3 per landmark)
      [ Hlp  Hll ]
  S   = Hpp − Hpl·Hll⁻¹·Hlp          (6W × 6W, small)
  rhs = bp − Hpl·Hll⁻¹·bl
  δp  = solve(S, rhs);   δl = Hll⁻¹(bl − Hlp·δp)

Everything lies on the dense (L, W) observation grid with a visibility
mask; each stage is one einsum over the grid.  Gauge: the first pose is
held by a large diagonal prior on its block.  The loop never reads a
value back to the host: accept/reject is a `torch.where` on device
scalars, as the JAX package's scan carries it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from front_end_tpu_torch.ba import factors
from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.utils.precision import f32_precision

GAUGE_PRIOR = 1e12


class BAResult(NamedTuple):
    poses: torch.Tensor        # (W, 4, 4) camera_from_world
    landmarks: torch.Tensor    # (L, 3) world frame
    cost: torch.Tensor         # final robust cost
    cost0: torch.Tensor        # initial robust cost
    rms_px: torch.Tensor       # final masked RMS reprojection error (px)


def _local(*ts):
    """The sum over landmark blocks when one block holds every landmark."""
    return ts


def _normal_equations(poses, X, meas, vis_w, rig, huber_px, total=_local):
    """All H/b blocks at the current linearisation point.

    poses: (W, 4, 4); X: (L, 3); meas: (L, W, 4); vis_w: (L, W) weights.
    Returns (Hpp (W,6,6), Hpl (L,W,6,3), Hll (L,3,3), bp (W,6), bl (L,3),
    cost); Hpp, bp and cost summed over the landmark blocks by `total`."""
    r, Jp, Jl = factors.residual_and_jacobians(
        poses[None, :], X[:, None, :], meas, rig)        # (L, W, 4[, ·])
    r2 = (r * r).sum(-1)
    w = factors.huber_weight(r2, huber_px) * vis_w        # (L, W)
    cost = (factors.robust_cost(r2, huber_px) * vis_w).sum()

    Jpw = Jp * w[..., None, None]
    Jlw = Jl * w[..., None, None]
    Hpp = torch.einsum("lwri,lwrj->wij", Jpw, Jp)         # (W, 6, 6)
    Hll = torch.einsum("lwri,lwrj->lij", Jlw, Jl)         # (L, 3, 3)
    Hpl = torch.einsum("lwri,lwrj->lwij", Jpw, Jl)        # (L, W, 6, 3)
    bp = -torch.einsum("lwri,lwr->wi", Jpw, r)            # (W, 6)
    bl = -torch.einsum("lwri,lwr->li", Jlw, r)            # (L, 3)
    Hpp, bp, cost = total(Hpp, bp, cost)
    return Hpp, Hpl, Hll, bp, bl, cost


def _inv3x3(M):
    """Batched closed-form (adjugate) 3×3 inverse.

    Padded all-zero landmark blocks carry only the LM damping floor:
    lam·1e-8·I has a determinant that is subnormal in float32 once lam is
    small, which a device may or may not flush to zero.  A vanishing
    determinant is therefore replaced by 1, so the adjugate (itself ~0)
    gives the ~0 inverse — no contribution — under either behaviour."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    inv = torch.stack([torch.stack([ca, cd, cg], -1),
                       torch.stack([cb, ce, ch], -1),
                       torch.stack([cc, cf, ci], -1)], -2)
    return inv / det[..., None, None]


def _schur_reduce(Hpp, Hpl, Hll, bp, bl, lam, total=_local):
    """The reduced camera system (S_off, rhs) and the landmark inverse.
    `total` sums S_off and the landmark term of the rhs over the landmark
    blocks; bp is already a sum."""
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll_d = Hll + lam * (eye3 * Hll + 1e-8 * eye3)        # LM-damped diag
    Hll_inv = _inv3x3(Hll_d)                              # (L, 3, 3)
    HplHinv = torch.einsum("lwij,ljk->lwik", Hpl, Hll_inv)  # (L, W, 6, 3)
    S_off, lm_term = total(
        torch.einsum("lwik,lvjk->wvij", HplHinv, Hpl),      # (W, W, 6, 6)
        torch.einsum("lwij,lj->wi", HplHinv, bl))           # (W, 6)
    return S_off, bp - lm_term, Hll_inv


def _assemble_and_solve(Hpp, S_off, rhs, lam):
    """Dense 6W×6W solve of the damped reduced system.  Like the JAX
    package's solve it does not raise on a singular system (the LM step is
    then rejected by its cost), so the factorisation's status is not read
    back from the device."""
    W = Hpp.shape[0]
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    diag = Hpp + lam * (eye6 * Hpp + 1e-8 * eye6)
    diag = torch.cat([(diag[0] + eye6 * GAUGE_PRIOR)[None], diag[1:]])
    ar = torch.arange(W, device=Hpp.device)
    S = -S_off
    S[ar, ar] = S[ar, ar] + diag                          # (W, W, 6, 6)
    Sd = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    dxi, _ = torch.linalg.solve_ex(Sd, rhs.reshape(-1), check_errors=False)
    return dxi.reshape(W, 6)


def _back_substitute(Hll_inv, bl, Hpl, dxi):
    """δl = Hll⁻¹ (bl − Hlp·δp)."""
    corr = torch.einsum("lwij,wi->lj", Hpl, dxi)
    return torch.einsum("lij,lj->li", Hll_inv, bl - corr)


def _apply(poses, X, dxi, dX):
    return se3.se3_exp(dxi) @ poses, X + dX


@f32_precision
def ba_solve(poses0, X0, meas, vis, rig: StereoRig, *, iters: int = 12,
             huber_px: float = 3.0, lam0: float = 1e-4,
             total=_local) -> BAResult:
    """Run LM on a window.  poses0: (W, 4, 4) camera_from_world initial;
    X0: (L, 3); meas: (L, W, 4); vis: (L, W) bool.

    One linearisation per iteration: the normal-equation blocks of the
    last ACCEPTED state are carried, the tentative state's pass doubles as
    its cost evaluation, and a rejected step keeps the carried blocks.

    `total(*tensors)` sums tensors over the landmark blocks of a sharded
    solve (`distributed.ba_solve_sharded`); X0, meas and vis are then this
    block's, and the landmarks returned too.  One call before the loop,
    two an iteration, two for the rms."""
    vis_w = vis.to(torch.float32)
    poses, X = poses0, X0
    *ne, cost = _normal_equations(poses, X, meas, vis_w, rig, huber_px,
                                  total)
    cost0 = cost
    lam = torch.as_tensor(lam0, dtype=torch.float32, device=X0.device)

    for _ in range(iters):
        Hpp, Hpl, Hll, bp, bl = ne
        S_off, rhs, Hll_inv = _schur_reduce(Hpp, Hpl, Hll, bp, bl, lam,
                                            total)
        dxi = _assemble_and_solve(Hpp, S_off, rhs, lam)
        dX = _back_substitute(Hll_inv, bl, Hpl, dxi)
        new_poses, new_X = _apply(poses, X, dxi, dX)
        *new_ne, new_cost = _normal_equations(new_poses, new_X, meas, vis_w,
                                              rig, huber_px, total)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        X = torch.where(accept, new_X, X)
        cost = torch.where(accept, new_cost, cost)
        ne = [torch.where(accept, new, old) for new, old in zip(new_ne, ne)]
        lam = torch.where(accept, lam * 0.3, lam * 5.0).clamp(1e-9, 1e8)

    r = factors.residual(poses[None, :], X[:, None, :], meas, rig)
    (r2,) = total(((r * r).sum(-1) * vis_w).sum())
    (n_vis,) = total(vis_w.sum())
    rms = torch.sqrt(r2 / (n_vis * 4.0).clamp(min=1.0))
    return BAResult(poses=poses, landmarks=X, cost=cost, cost0=cost0,
                    rms_px=rms)

"""Motion-only bundle adjustment: 6-DoF Levenberg-Marquardt on SE(3)
(counterpart of `front_end_tpu/motion/lm.py`).

Residual: stereo reprojection of frame-a landmarks into frame b's pair,
Huber-weighted; the pose is exp(xi)·H0 and moves by left updates
xi <- log(exp(dx)·exp(xi)), as in the JAX solver.  The JAX solver takes
∂r/∂xi by forward-mode AD; here it is written out — the projection's
derivative, times the left-perturbation derivative [I | -p^] of the
transformed point, times the SE(3) left Jacobian of xi — because
`torch.func.jacfwd` costs ~15 ms of host dispatch per iteration on the
card (measured, `profile_torch_vo.py`).  A fixed number of iterations with
accept/reject and damping as tensor selects: no step waits on the host.

On the card the loop is some 370 small kernels an iteration, each
dispatched from Python; `refine_motion` replays it as one CUDA graph a
key through `pipeline/cuda_graphs.py`, with `_refine` as the eager body.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.pipeline import cuda_graphs, telemetry
from front_end_tpu_torch.utils.precision import f32_precision


class LMResult(NamedTuple):
    H: torch.Tensor          # (4, 4) refined extrinsic map a -> b
    cost: torch.Tensor       # final robust cost
    cost0: torch.Tensor      # initial robust cost


def _points(xi, H0, Xa):
    """Frame-a landmarks moved by exp(xi)·H0: (N, 3).  The exp map runs on
    a batch of one: forward-mode AD (which the tests apply to
    `_residuals`) of a 0-dim tensor with a Python scalar yields a float64
    tangent in torch."""
    return se3.transform_points(se3.se3_exp(xi[None])[0] @ H0, Xa)


def _residuals(xi, H0, Xa, uvb, rig: StereoRig):
    """(N, 4) residual: project exp(xi)·H0·Xa into frame b's pair."""
    return rig.project4(_points(xi, H0, Xa)) - uvb


def left_jacobian(xi):
    """SE(3) left Jacobian of xi = [v, w]: Σ_k ad^k / (k+1)!, with
    ad = [[w^, v^], [0, w^]], to k = 4.  The solver's xi stays small (a
    correction of the RANSAC pose, |xi| ~ 1e-2), where the truncation
    error, ~|xi|^5 / 720, is far below float32 rounding."""
    W, V = se3.hat(xi[3:]), se3.hat(xi[:3])
    ad = torch.cat([torch.cat([W, V], 1),
                    torch.cat([torch.zeros_like(W), W], 1)], 0)
    J = torch.eye(6, dtype=xi.dtype, device=xi.device)
    term = J
    for k in range(1, 5):
        term = term @ ad / (k + 1)
        J = J + term
    return J


def _jacobian(xi, p, rig: StereoRig):
    """∂r/∂xi (N, 4, 6) at the moved points p = exp(xi)·H0·Xa."""
    X, Y, Z = p[:, 0], p[:, 1], p[:, 2]
    flat = Z.abs() < 1e-6           # project() clamps Z here: no Z slope
    Zc = torch.where(flat, torch.sign(Z) * 1e-6 + 1e-12, Z)
    iz = 1.0 / Zc
    gz = torch.where(flat, 0.0, -iz * iz)
    zero = torch.zeros_like(X)
    row_u = torch.stack([rig.fx * iz, zero, rig.fx * X * gz], -1)
    row_v = torch.stack([zero, rig.fy * iz, rig.fy * Y * gz], -1)
    row_r = torch.stack([rig.fx * iz, zero,
                         rig.fx * (X - rig.baseline) * gz], -1)
    dproj = torch.stack([row_u, row_v, row_r, row_v], 1)      # (N, 4, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(len(p), 3, 3)
    dp = torch.cat([eye, -se3.hat(p)], -1)                    # (N, 3, 6)
    return dproj @ dp @ left_jacobian(xi)


def _huber_w(r2, delta):
    r = torch.sqrt(r2 + 1e-12)
    return torch.where(r <= delta, 1.0, delta / r)


def refine_motion(H0, Xa, uvb, valid, rig: StereoRig, *, iters: int = 10,
                  huber_px: float = 3.0, lm_lambda0: float = 1e-3
                  ) -> LMResult:
    """LM refinement of the extrinsic map a -> b.  Xa (N, 3) frame-a
    landmarks, uvb (N, 4) measured [ul, vl, ur, vr] in frame b, valid (N,).

    Counts one `lm.accepted` (0/1) an iteration and `lm.graph`
    (`pipeline/cuda_graphs.py`)."""
    return _refine_graphs((H0, Xa, uvb, valid),
                          (rig, iters, huber_px, lm_lambda0))


@f32_precision
def _refine(H0, Xa, uvb, valid, rig: StereoRig, iters: int, huber_px: float,
            lm_lambda0: float) -> LMResult:
    """The solver, run eagerly; counts each iteration's accept flag (a
    0-dim bool tensor) as `lm.accepted`."""
    w_valid = valid.to(torch.float32)
    d = huber_px

    def robust_cost(r):
        r2 = (r * r).sum(-1)
        rho = torch.where(r2 <= d * d, r2,
                          2.0 * d * torch.sqrt(r2 + 1e-12) - d * d)
        return (rho * w_valid).sum()

    xi = torch.zeros(6, dtype=Xa.dtype, device=Xa.device)
    lam = torch.full((), lm_lambda0, dtype=torch.float32, device=Xa.device)
    p = _points(xi, H0, Xa)
    r = rig.project4(p) - uvb
    cost0 = cost = robust_cost(r)
    for _ in range(iters):
        J = _jacobian(xi, p, rig)                           # (N, 4, 6)
        w = _huber_w((r * r).sum(-1), huber_px) * w_valid   # (N,)
        Jw = J * w[:, None, None]
        A = torch.einsum("nri,nrj->ij", Jw, J)              # (6, 6)
        g = torch.einsum("nri,nr->i", Jw, r)                # (6,)
        A_lm = A + lam * torch.diag(torch.diagonal(A) + 1e-8)
        dx = -torch.linalg.solve_ex(A_lm, g).result        # no host sync
        xi_new = se3.se3_log(se3.se3_exp(dx) @ se3.se3_exp(xi))
        p_new = _points(xi_new, H0, Xa)
        r_new = rig.project4(p_new) - uvb
        cost_new = robust_cost(r_new)
        accept = cost_new < cost
        telemetry.count("lm.accepted", accept)
        xi = torch.where(accept, xi_new, xi)
        p = torch.where(accept, p_new, p)
        r = torch.where(accept, r_new, r)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9,
                          1e6)
    return LMResult(H=se3.se3_exp(xi) @ H0, cost=cost, cost0=cost0)


_refine_graphs = cuda_graphs.Replayed(_refine, "lm")

"""Stereo reprojection factors for windowed bundle adjustment
(frozen from the port's `ba/factors.py`).

A binary factor between a 6-DoF pose and a 3-D landmark whose 4-vector
residual is the stereo reprojection error [ul, vl, ur, vr] in both
rectified cameras.  Jacobians are written out (not AD), so the (L, W)
observation grid evaluates as a few einsums: with Xc = T·Xw,
  d r / d Xc  : the 4×3 projection derivative,
  d Xc / d xi = [I | −[Xc]×]  (left-multiplied local se3 update),
  d Xc / d Xw = R.
"""
from __future__ import annotations

import torch

from vobench.reference import se3
from vobench.reference.camera import StereoRig


def residual(T, Xw, z, rig: StereoRig):
    """r = project4(T·Xw) − z.
    T: (..., 4, 4) camera_from_world; Xw: (..., 3); z: (..., 4)."""
    Xc = se3.transform_points(T, Xw[..., None, :])[..., 0, :]
    return rig.project4(Xc) - z


def residual_and_jacobians(T, Xw, z, rig: StereoRig):
    """Residual plus Jacobians wrt the local pose update and the landmark,
    for a broadcastable batch of observations.

    T: (..., 4, 4); Xw: (..., 3); z: (..., 4).
    Returns (r (..., 4), Jp (..., 4, 6), Jl (..., 4, 3)).  The pose update
    convention is the solvers': T <- se3_exp(δ)·T with δ = [v, w], so
    dXc/dδ = [ I  −[Xc]× ]."""
    R = T[..., :3, :3]
    Xc = torch.einsum("...ij,...j->...i", R, Xw) + T[..., :3, 3]
    x, y = Xc[..., 0], Xc[..., 1]
    z_ = torch.where(Xc[..., 2].abs() < 1e-6,
                     torch.full_like(x, 1e-6), Xc[..., 2])
    iz = 1.0 / z_
    iz2 = iz * iz
    fx, fy, b = rig.fx, rig.fy, rig.baseline

    ul = fx * x * iz + rig.cx
    vl = fy * y * iz + rig.cy
    ur = fx * (x - b) * iz + rig.cx
    r = torch.stack([ul, vl, ur, vl], -1) - z

    zero = torch.zeros_like(x)
    dul = torch.stack([fx * iz, zero, -fx * x * iz2], -1)
    dvl = torch.stack([zero, fy * iz, -fy * y * iz2], -1)
    dur = torch.stack([fx * iz, zero, -fx * (x - b) * iz2], -1)
    dP = torch.stack([dul, dvl, dur, dvl], -2)            # (..., 4, 3)

    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape + (3,))
    dXc = torch.cat([eye, -se3.hat(Xc)], -1)              # (..., 3, 6)
    Jp = torch.einsum("...ri,...ij->...rj", dP, dXc)      # (..., 4, 6)
    Jl = torch.einsum("...ri,...ij->...rj", dP, R)        # (..., 4, 3)
    return r, Jp, Jl


def huber_weight(r2, delta: float):
    """IRLS weight of the Huber kernel on the squared residual norm."""
    rn = torch.sqrt(r2 + 1e-12)
    return torch.where(rn <= delta, torch.ones_like(rn), delta / rn)


def robust_cost(r2, delta: float):
    rn = torch.sqrt(r2 + 1e-12)
    return torch.where(rn <= delta, r2, 2.0 * delta * rn - delta * delta)

"""Rectified stereo camera model (counterpart of
`front_end_tpu/geometry/camera.py`).

Conventions: rectified pair, identical intrinsics, baseline along +x of
the left camera, disparity d = ul - ur > 0 in front of the rig, OpenCV Q.

The JAX rig holds float32 numpy scalars, so a product of two of them
(`fx * baseline`) rounds to float32 before it meets an array.  The fields
here are Python floats holding the same float32 values, and scalar
products are formed in float32 too (`_f32`), so the arithmetic on tensors
rounds exactly as the JAX package's does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclass(frozen=True)
class StereoRig:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float               # metres
    width: int = 1024
    height: int = 768

    @classmethod
    def create(cls, fx, fy=None, cx=None, cy=None, baseline=0.12,
               width=1024, height=768):
        fy = fx if fy is None else fy
        cx = (width - 1) / 2.0 if cx is None else cx
        cy = (height - 1) / 2.0 if cy is None else cy
        return cls(fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
                   baseline=_f32(baseline), width=int(width),
                   height=int(height))

    def Q(self, device=None):
        """OpenCV reprojection matrix: Q·[u,v,d,1]ᵀ ∝ [X,Y,Z,1]ᵀ."""
        return torch.tensor(
            [[1.0, 0.0, 0.0, -self.cx], [0.0, 1.0, 0.0, -self.cy],
             [0.0, 0.0, 0.0, self.fx],
             [0.0, 0.0, _f32(np.float32(1.0) / np.float32(self.baseline)),
              0.0]], dtype=torch.float32, device=device)

    def triangulate(self, xy_left, xy_right):
        """Q-matrix stereo triangulation -> (..., 3) left-frame points.
        Disparity is floored at 1e-3 so padded rows stay finite."""
        d = torch.clamp(xy_left[..., 0] - xy_right[..., 0], min=1e-3)
        Z = _f32(np.float32(self.fx) * np.float32(self.baseline)) / d
        X = (xy_left[..., 0] - self.cx) * Z / self.fx
        Y = (xy_left[..., 1] - self.cy) * Z / self.fy
        return torch.stack([X, Y, Z], -1)

    def project(self, X):
        """Left-frame points (..., 3) -> ((ul, vl), (ur, vr)); Z is kept
        away from 0 so invalid rows stay finite."""
        Z = X[..., 2]
        Z = torch.where(Z.abs() < 1e-6, torch.sign(Z) * 1e-6 + 1e-12, Z)
        ul = self.fx * X[..., 0] / Z + self.cx
        vl = self.fy * X[..., 1] / Z + self.cy
        ur = self.fx * (X[..., 0] - self.baseline) / Z + self.cx
        return torch.stack([ul, vl], -1), torch.stack([ur, vl], -1)

    def project4(self, X):
        """(..., 3) -> (..., 4) stacked [ul, vl, ur, vr]."""
        left, right = self.project(X)
        return torch.cat([left, right], -1)

    def in_view(self, X, margin: float = 0.0, min_z: float = 0.1):
        """Visibility mask of left-frame points in both cameras."""
        left, right = self.project(X)

        def inside(p):
            return ((p[..., 0] >= margin)
                    & (p[..., 0] <= self.width - 1 - margin)
                    & (p[..., 1] >= margin)
                    & (p[..., 1] <= self.height - 1 - margin))
        return inside(left) & inside(right) & (X[..., 2] > min_z)


def kitti_rig() -> StereoRig:
    """KITTI odometry sequence 00-02 rectified geometry (P0 grayscale)."""
    return StereoRig.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                            baseline=0.5371657, width=1241, height=376)


def bumblebee_rig() -> StereoRig:
    """A Bumblebee-like 1024×768 rig (the reference's camera; its
    calibration lived on the ROS parameter server, these are
    representative)."""
    return StereoRig.create(fx=900.0, fy=900.0, cx=511.5, cy=383.5,
                            baseline=0.12, width=1024, height=768)

"""Stereo rectification: the maps computed once, the remap per frame on
the frame's device (counterpart of `front_end_tpu/io/rectify.py`).

The calibration math (Bouguet-style rectifying rotations, common
intrinsics, the inverse maps through radial-tangential distortion) runs
once in numpy float64 when a sequence opens; `StereoRectifier` moves the
float32 maps to its device then, and each frame pair costs two bilinear
gathers there.  The rectified pair feeds the `StereoRig` pipeline
unchanged (rows aligned, positive disparity).
"""
from __future__ import annotations

import numpy as np
import torch

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.utils.precision import resolve_device


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix."""
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def rotation_vector(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues)."""
    ct = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(ct))
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2.0 * np.sin(th)) * th


def radtan_distort(x, y, D):
    """Radial-tangential distortion of normalized coordinates."""
    k1, k2, p1, p2 = D
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def stereo_rectify(K0, D0, K1, D1, R, t, size):
    """Rectifying rotations + common intrinsics for a stereo pair.

    R, t: cam0 -> cam1 (x1 = R @ x0 + t).  Returns (R_rect0, R_rect1,
    K_new, baseline), the left camera the rectified reference: R_recti
    rotates camera-i coordinates into the rectified frame, whose x axis
    runs along the baseline, so disparity is positive.
    """
    K0, K1, R, t = map(np.asarray, (K0, K1, R, t))
    om = rotation_vector(R)
    r_half = rodrigues(-om / 2.0)         # split the rotation equally
    t_new = r_half @ t
    B = float(np.linalg.norm(t_new))

    # rectified x axis = -t, so cam1 sits at +B x
    e1 = -t_new / B
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3])           # rows

    # rotating cam0 by r_half @ R and cam1 by r_half gives both the same
    # orientation; Rw then levels the baseline
    R_rect1 = Rw @ r_half
    R_rect0 = Rw @ r_half @ R

    f = (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1]) / 4.0
    cx = (K0[0, 2] + K1[0, 2]) / 2.0
    cy = (K0[1, 2] + K1[1, 2]) / 2.0
    K_new = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    return R_rect0, R_rect1, K_new, B


def rectify_map(K_src, D_src, R_rect, K_new, size):
    """Inverse map of one camera: for every rectified output pixel, the
    source pixel to sample.  Returns (map_x, map_y), each (H, W) float32."""
    W, H = size
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    Kinv = np.linalg.inv(K_new)
    rays = np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1)
    rays = np.linalg.inv(R_rect) @ (Kinv @ rays)     # back to source cam
    x = rays[0] / rays[2]
    y = rays[1] / rays[2]
    xd, yd = radtan_distort(x, y, D_src)
    mx = K_src[0, 0] * xd + K_src[0, 2]
    my = K_src[1, 1] * yd + K_src[1, 2]
    return (mx.reshape(H, W).astype(np.float32),
            my.reshape(H, W).astype(np.float32))


def remap_bilinear(img, map_x, map_y):
    """Sample `img` at fractional (map_x, map_y) on the maps' device: the
    cv2.remap step, float32, clamped taps, 0 outside the image."""
    img = torch.as_tensor(img).to(device=map_x.device, dtype=torch.float32)
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    out = ((1 - fx) * (1 - fy) * at(y0i, x0i)
           + fx * (1 - fy) * at(y0i, x1i)
           + (1 - fx) * fy * at(y1i, x0i)
           + fx * fy * at(y1i, x1i))
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(inb, out, torch.zeros_like(out))


class StereoRectifier:
    """Precomputed rectifier of a calibrated stereo pair; its maps live on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, K0, D0, K1, D1, R, t, size, device="cuda"):
        self.R0, self.R1, self.K_new, self.baseline = stereo_rectify(
            K0, D0, K1, D1, R, t, size)
        self.size = size
        self.device = resolve_device(device)
        self.map0 = tuple(torch.from_numpy(m).to(self.device) for m in
                          rectify_map(np.asarray(K0), D0, self.R0,
                                      self.K_new, size))
        self.map1 = tuple(torch.from_numpy(m).to(self.device) for m in
                          rectify_map(np.asarray(K1), D1, self.R1,
                                      self.K_new, size))

    def rig(self) -> StereoRig:
        W, H = self.size
        return StereoRig.create(
            fx=float(self.K_new[0, 0]), cx=float(self.K_new[0, 2]),
            cy=float(self.K_new[1, 2]), baseline=float(self.baseline),
            width=W, height=H)

    def __call__(self, left, right):
        return (remap_bilinear(left, *self.map0),
                remap_bilinear(right, *self.map1))

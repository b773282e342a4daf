"""Synthetic stereo-landmark worlds, the Monte-Carlo backend of the motion
estimators (counterpart of `front_end_tpu/sim/synthetic.py`).

Known ground-truth motion, in-frustum stereo landmarks, Gaussian pixel
noise and outliers, with the reference's parameter contracts
(`~simulation.py`): motion categories Slow / Medium / Fast (translation
mean 0.022 / 0.044 / 0.066 m along +Z, noise 10 % of the mean, rotation
noise 1 / 4 / 8 degrees, 'szxy'); landmark prior x, y ~ N(0, 5), z ~
N(0, 4); validity = all four projections inside the image and both
depths positive; noise x += N(0, sigma), y += U(0, 1) per projection,
then re-triangulation; outliers a uniform image point at least 3 px from
the true one.  Rejection sampling is a fixed oversampled batch with the
valid rows gathered first by a stable sort.

The JAX package draws from its PRNG, which torch cannot reproduce.  So,
as with the RANSAC sampler, every function takes its draws as its first
argument: either the tuple of standard normal and uniform float32 tensors
it consumes (each function's docstring gives their shapes, in order; the
parity tests pass JAX-drawn values), or a CPU `torch.Generator` to draw
them from.  Ground truth follows `~simulation.py:424-429`: `H =
createHomog(R, T)` is the reported pose, `Ht = [R | -R T]` the extrinsic
map Xb = Ht · Xa that generates the data.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.utils.precision import f32_precision

NOISE_LEVELS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5)       # px sigma
OUTLIER_LEVELS = (0.05, 0.10, 0.15, 0.20, 0.25)            # fraction
OPERATING_CURVES = (100, 250, 500, 1000, 2500)             # landmark counts
MIN_OUTLIER_SHIFT = 3.0                                    # px
OUTLIER_CANDIDATES = 8


class MotionCategory(NamedTuple):
    translation_mean: float     # metres, dominant +Z
    translation_noise: float    # metres (sigma)
    rotation_noise_deg: float   # degrees (sigma, all three angles)


def motion_category(name: str) -> MotionCategory:
    tm, rn = {"slow": (0.022, 1.0), "medium": (0.044, 4.0),
              "fast": (0.066, 8.0)}[name.lower()]
    f32 = np.float32
    return MotionCategory(float(f32(tm)), float(f32(0.1 * tm)),
                          float(f32(rn)))


class StereoWorld(NamedTuple):
    """N stereo landmark correspondences (`valid` masks real rows); pixel
    rows are [ul, vl, ur, vr]."""
    H: torch.Tensor           # (4, 4) ground-truth pose createHomog(R, T)
    Ht: torch.Tensor          # (4, 4) extrinsic map a -> b, [R | -R T]
    Xa: torch.Tensor          # (N, 3) landmarks in frame a
    Xb: torch.Tensor          # (N, 3) landmarks in frame b (= Ht · Xa)
    uva: torch.Tensor         # (N, 4) pixels in frame a
    uvb: torch.Tensor         # (N, 4) pixels in frame b
    valid: torch.Tensor       # (N,) bool


class WindowWorld(NamedTuple):
    """A W-frame sliding-window ground-truth problem; frame 0 is the world
    frame, `poses[w]` camera_from_world of frame w."""
    poses: torch.Tensor       # (W, 4, 4)
    X: torch.Tensor           # (N, 3) landmarks in the world frame
    meas: torch.Tensor        # (N, W, 4) pixel measurements
    vis: torch.Tensor         # (N, W) bool, in view at frame w
    valid: torch.Tensor       # (N,) bool, a real landmark row


def _draws(draws, spec):
    """`spec`: ((kind, shape), ...) with kind "normal" or "uniform" ->
    the float32 tensors, drawn from `draws` if it is a generator, else
    `draws` itself checked against the shapes."""
    if isinstance(draws, torch.Generator):
        return tuple((torch.randn if kind == "normal" else torch.rand)(
            shape, generator=draws, dtype=torch.float32)
            for kind, shape in spec)
    out = tuple(d.to(torch.float32) if isinstance(d, torch.Tensor)
                else torch.from_numpy(np.array(d, np.float32)) for d in draws)
    want = [tuple(shape) for _, shape in spec]
    if [tuple(d.shape) for d in out] != want:
        raise ValueError(f"draws of shapes {[tuple(d.shape) for d in out]}, "
                         f"want {want}")
    return out


def _motion(cat: MotionCategory, ang_z, t_z):
    R = se3.compose_R(*(ang_z * cat.rotation_noise_deg), degrees=True)
    txy = t_z * cat.translation_noise
    T = torch.stack([txy[0], txy[1],
                     torch.abs(txy[2] + cat.translation_mean)])
    return se3.create_homog(R, T), se3.compose_transform(R, T)


def sample_motion(draws, cat: MotionCategory):
    """The reference's noisy rotation + dominant translation, |Z| a folded
    normal.  Draws: normal (3,) angles, normal (3,) translation.
    Returns (H, Ht)."""
    return _motion(cat, *_draws(draws, (("normal", (3,)),
                                        ("normal", (3,)))))


def _validity(rig: StereoRig, Xa, Xb, uva, uvb):
    def in_img(uv):
        return ((uv[..., 0] > 0) & (uv[..., 0] < rig.width)
                & (uv[..., 1] > 0) & (uv[..., 1] < rig.height)
                & (uv[..., 2] > 0) & (uv[..., 2] < rig.width)
                & (uv[..., 3] > 0) & (uv[..., 3] < rig.height))
    return in_img(uva) & in_img(uvb) & (Xa[..., 2] > 0) & (Xb[..., 2] > 0)


def _landmarks(pts_z):
    return pts_z * torch.tensor([5.0, 5.0, 4.0])


@f32_precision
def sample_world(draws, rig: StereoRig, cat: MotionCategory, n: int,
                 oversample: int = 48) -> StereoWorld:
    """N valid in-frustum stereo landmarks under a random motion: draw
    `oversample * n` candidates, gather the valid rows first (a stable
    sort).  Draws: the motion's two normal (3,), normal (oversample * n,
    3) landmark coordinates (x, y, z columns)."""
    ang_z, t_z, pts_z = _draws(draws, (("normal", (3,)), ("normal", (3,)),
                                       ("normal", (oversample * n, 3))))
    H, Ht = _motion(cat, ang_z, t_z)
    X = _landmarks(pts_z)
    Xb = se3.transform_points(Ht, X)
    uva, uvb = rig.project4(X), rig.project4(Xb)
    ok = _validity(rig, X, Xb, uva, uvb)
    order = torch.argsort((~ok).to(torch.int32), stable=True)[:n]
    return StereoWorld(H=H, Ht=Ht, Xa=X[order], Xb=Xb[order],
                       uva=uva[order], uvb=uvb[order], valid=ok[order])


@f32_precision
def add_gaussian_noise(draws, world: StereoWorld, rig: StereoRig,
                       sigma) -> StereoWorld:
    """Per projection x += N(0, sigma), y += U(0, 1); Xa, Xb re-triangulated
    from the noisy pixels.  Draws: normal (N, 2) and uniform (N, 2) for
    frame a, the same for frame b."""
    n = world.uva.shape[0]
    dxa, dya, dxb, dyb = _draws(draws, (("normal", (n, 2)),
                                        ("uniform", (n, 2)),
                                        ("normal", (n, 2)),
                                        ("uniform", (n, 2))))

    def noisy(uv, dx, dy):
        dx = dx * sigma
        return uv + torch.stack([dx[:, 0], dy[:, 0], dx[:, 1], dy[:, 1]], -1)

    uva = noisy(world.uva, dxa, dya)
    uvb = noisy(world.uvb, dxb, dyb)
    return world._replace(uva=uva, uvb=uvb,
                          Xa=rig.triangulate(uva[:, :2], uva[:, 2:]),
                          Xb=rig.triangulate(uvb[:, :2], uvb[:, 2:]))


@f32_precision
def add_outliers(draws, world: StereoWorld, rig: StereoRig, fraction):
    """For a `fraction` of rows, replace frame b's left projection by a
    uniform image point more than MIN_OUTLIER_SHIFT px away on both axes
    (the first of 8 candidates that is), draw the right view's x
    uniformly, re-triangulate Xb.  Draws: uniform (N,) selection, uniform
    (N, 8, 2) candidates, uniform (N,) right x.  Returns (world',
    outlier mask)."""
    n = world.uvb.shape[0]
    u_sel, u_cand, u_rx = _draws(draws, (
        ("uniform", (n,)), ("uniform", (n, OUTLIER_CANDIDATES, 2)),
        ("uniform", (n,))))
    is_out = u_sel < fraction
    cand = u_cand * torch.tensor([rig.width, rig.height],
                                 dtype=torch.float32)
    diff = torch.abs(cand - world.uvb[:, None, :2])
    far = (diff[..., 0] > MIN_OUTLIER_SHIFT) & (diff[..., 1]
                                                > MIN_OUTLIER_SHIFT)
    pick = torch.argmax(far.to(torch.int32), 1)     # the first far one
    pt = cand[torch.arange(n), pick]
    rx = u_rx * rig.width
    uvb_out = torch.stack([pt[:, 0], pt[:, 1], rx, pt[:, 1]], -1)
    uvb = torch.where(is_out[:, None], uvb_out, world.uvb)
    return (world._replace(uvb=uvb,
                           Xb=rig.triangulate(uvb[:, :2], uvb[:, 2:])),
            is_out & world.valid)


def sample_worlds(draws, rig: StereoRig, cat: MotionCategory, n: int,
                  batch: int, oversample: int = 48) -> StereoWorld:
    """A batch of independent worlds, fields stacked.  Draws: those of
    `sample_world` with a leading batch axis."""
    if isinstance(draws, torch.Generator):
        per = [draws] * batch
    else:
        per = list(zip(*draws))
        if len(per) != batch:
            raise ValueError(f"draws for {len(per)} worlds, want {batch}")
    worlds = [sample_world(d, rig, cat, n, oversample) for d in per]
    return StereoWorld(*(torch.stack(f) for f in zip(*worlds)))


@f32_precision
def sample_window_world(draws, rig: StereoRig, cat: MotionCategory, n: int,
                        window: int = 3, oversample: int = 48) -> WindowWorld:
    """One landmark cloud seen from a chain of `window` poses, each step a
    `sample_motion`.  Rows visible in every frame come first, then rows
    visible in frame 0.  Draws: normal (window - 1, 2, 3), each step's
    angles and translation; normal (oversample * n, 3) landmarks."""
    steps, pts_z = _draws(draws, (("normal", (window - 1, 2, 3)),
                                  ("normal", (oversample * n, 3))))
    T = torch.eye(4)
    poses = [T]
    for ang_z, t_z in steps:
        T = _motion(cat, ang_z, t_z)[1] @ T
        poses.append(T)
    poses = torch.stack(poses)                                # (W, 4, 4)
    X = _landmarks(pts_z)
    Xw = se3.transform_points(poses, X)                       # (W, m, 3)
    meas = rig.project4(Xw).transpose(0, 1)                   # (m, W, 4)
    vis = rig.in_view(Xw).transpose(0, 1)                     # (m, W)
    ok0 = vis[:, 0]
    ok_all = vis.all(1)
    key = (~ok_all).to(torch.int32) * 2 + (~ok0).to(torch.int32) * 2
    order = torch.argsort(key, stable=True)[:n]
    return WindowWorld(poses=poses, X=X[order], meas=meas[order],
                       vis=vis[order] & ok0[order, None], valid=ok0[order])


@f32_precision
def window_add_noise(draws, ww: WindowWorld, sigma) -> WindowWorld:
    """`add_gaussian_noise`'s model on every frame's measurement.  Draws:
    normal (N, W, 2), uniform (N, W, 2)."""
    n, W, _ = ww.meas.shape
    dx, dy = _draws(draws, (("normal", (n, W, 2)), ("uniform", (n, W, 2))))
    dx = dx * sigma
    noise = torch.stack([dx[..., 0], dy[..., 0], dx[..., 1], dy[..., 1]], -1)
    return ww._replace(meas=ww.meas + noise)


@f32_precision
def window_add_outliers(draws, ww: WindowWorld, rig: StereoRig, fraction):
    """Replace a `fraction` of the observations in frames >= 1 by image
    points more than MIN_OUTLIER_SHIFT px off.  Draws: uniform (N, W)
    selection, uniform (N, W, 2) points, uniform (N, W) right x.  Returns
    (ww', mask (N, W))."""
    n, W, _ = ww.meas.shape
    u_sel, u_cand, u_rx = _draws(draws, (("uniform", (n, W)),
                                         ("uniform", (n, W, 2)),
                                         ("uniform", (n, W))))
    is_out = u_sel < fraction
    is_out[:, 0] = False
    size = torch.tensor([rig.width, rig.height], dtype=torch.float32)
    cand = u_cand * size
    d = cand - ww.meas[..., :2]
    shift = torch.clamp(torch.abs(d), min=MIN_OUTLIER_SHIFT + 1.0)
    pt = ww.meas[..., :2] + torch.sign(d + 0.5) * shift
    pt = torch.minimum(torch.clamp(pt, min=0.0), size - 1.0)
    rx = u_rx * rig.width
    out_meas = torch.stack([pt[..., 0], pt[..., 1], rx, pt[..., 1]], -1)
    meas = torch.where(is_out[..., None], out_meas, ww.meas)
    return ww._replace(meas=meas), is_out & ww.vis

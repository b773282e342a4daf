"""Rendered stereo frames on the card: textured box scenes, smooth camera
paths, and a torch rewrite of the port's numpy ray caster
(`front_end_tpu_torch/sim/render.py::render_view`, frozen as
`vobench/tests/render_np.py`).

A scene is an axis-aligned box of textured planes (floor, walls, far
wall, and optionally a ceiling and a near wall) with one texel size on
every plane, so the texture's density per square metre is even along the
whole path (the `make_texture(area_density=True)` pattern).  Textures
are made on the device from a `torch.Generator`: blobs of uniform grey
painted in order (a later blob covers an earlier one), then Gaussian
noise, rounded to integers.  Rendering is inverse ray casting with
bilinear texture sampling in float64, rounded to uint8 as a sensor
delivers.  Conventions of the port's `StereoRig`: x right, y down, z
forward; the right camera sits +baseline along x; poses are
world_T_camera.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

VOID = 8.0          # grey of a ray that hits nothing (the sky)
BLOB_CHUNK = 4096   # blobs painted per scatter


class Plane(NamedTuple):
    p0: tuple           # origin corner (world)
    u: tuple            # unit texture axis along the rows
    v: tuple            # unit texture axis along the columns
    extent: tuple       # (len_u, len_v) metres
    tex: torch.Tensor   # (rows, cols) float32
    scale: float        # metres per texel


def _paint(ids, gen, n, rows, cols, smin, smax, id0):
    """Blobs id0 .. id0+n-1: squares of side in [smin, smax) at uniform
    corners; each texel keeps the largest id that covers it."""
    dev = ids.device
    span = torch.arange(smax - 1, device=dev)
    dy, dx = (g.reshape(-1) for g in torch.meshgrid(span, span,
                                                     indexing="ij"))
    y = torch.randint(0, rows - smax, (n,), generator=gen, device=dev)
    x = torch.randint(0, cols - smax, (n,), generator=gen, device=dev)
    s = torch.randint(smin, smax, (n,), generator=gen, device=dev)
    for a in range(0, n, BLOB_CHUNK):
        b = min(n, a + BLOB_CHUNK)
        cover = (dy[None] < s[a:b, None]) & (dx[None] < s[a:b, None])
        idx = (y[a:b, None] + dy[None]) * cols + x[a:b, None] + dx[None]
        bid = torch.arange(id0 + a, id0 + b, device=dev)[:, None]
        ids.scatter_reduce_(0, idx[cover], bid.expand_as(idx)[cover],
                            "amax")


def make_texture(gen: torch.Generator, rows: int, cols: int,
                 lo: float = 20.0, hi: float = 235.0) -> torch.Tensor:
    """(rows, cols) float32 integer-valued texture on the generator's
    device: rows·cols/256 blobs of side 6-23 texels, then rows·cols/512 of
    side 2-7, grey uniform in [lo, hi), on 128; plus N(0, 2) noise."""
    if rows <= 24 or cols <= 24:
        raise ValueError(f"texture {rows}x{cols} is too small for its blobs")
    dev = gen.device
    area = rows * cols
    n1, n2 = area // 256, area // 512
    ids = torch.full((area,), -1, dtype=torch.int64, device=dev)
    _paint(ids, gen, n1, rows, cols, 6, 24, 0)
    _paint(ids, gen, n2, rows, cols, 2, 8, n1)
    vals = lo + (hi - lo) * torch.rand(n1 + n2, generator=gen, device=dev,
                                       dtype=torch.float64)
    t = torch.where(ids >= 0, vals[ids.clamp(min=0)], 128.0)
    t = t + 2.0 * torch.randn(area, generator=gen, device=dev,
                              dtype=torch.float64)
    return t.round().clamp(0, 255).to(torch.float32).reshape(rows, cols)


def box_scene(spec: dict, gen: torch.Generator) -> list[Plane]:
    """The planes of a box scene from a configuration's `scene` entry:
    x in [x_left_m, x_right_m], y in [y_top_m, y_floor_m] (y down),
    z in [z_near_m, z_far_m]; `ceiling` and `near_wall` optional."""
    x0, x1 = spec["x_left_m"], spec["x_right_m"]
    yt, yf = spec["y_top_m"], spec["y_floor_m"]
    z0, z1 = spec["z_near_m"], spec["z_far_m"]
    texel = spec["texel_m"]
    ex, ey, ez = (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    faces = [((x0, yf, z0), ez, ex, z1 - z0, x1 - x0),      # floor
             ((x0, yt, z0), ez, ey, z1 - z0, yf - yt),      # left wall
             ((x1, yt, z0), ez, ey, z1 - z0, yf - yt),      # right wall
             ((x0, yt, z1), ex, ey, x1 - x0, yf - yt)]      # far wall
    if spec.get("ceiling", False):
        faces.append(((x0, yt, z0), ez, ex, z1 - z0, x1 - x0))
    if spec.get("near_wall", False):
        faces.append(((x0, yt, z0), ex, ey, x1 - x0, yf - yt))
    return [Plane(p0=p0, u=u, v=v, extent=(eu, ev),
                  tex=make_texture(gen, math.ceil(eu / texel),
                                   math.ceil(ev / texel)),
                  scale=texel)
            for p0, u, v, eu, ev in faces]


def camera_path(spec: dict, n: int, hz: float) -> np.ndarray:
    """(n, 4, 4) float64 world_T_camera at the camera's rate: forward along
    +z at `speed_m_s`, a sinusoidal sway in x and y, and yaw, pitch and
    roll oscillating with the given amplitudes and periods (seconds)."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        t = k / hz

        def wave(amp, period, phase=0.0):
            return amp * math.sin(2 * math.pi * t / period + phase)

        yaw = math.radians(wave(spec["yaw_deg"], spec["yaw_period_s"]))
        pitch = math.radians(wave(spec["pitch_deg"], spec["pitch_period_s"],
                                  0.5))
        roll = math.radians(wave(spec["roll_deg"], spec["roll_period_s"],
                                 1.3))
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        cr, sr = math.cos(roll), math.sin(roll)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
        poses[k, :3, :3] = Ry @ Rx @ Rz
        poses[k, :3, 3] = [
            wave(spec["sway_x_m"], spec["sway_period_s"], 1.0),
            wave(spec["sway_y_m"], spec["sway_period_s"] / 2.3),
            spec["speed_m_s"] * t]
    return poses


def render_views(planes, rig: dict, poses: torch.Tensor, *,
                 right: bool = False) -> torch.Tensor:
    """(B, 4, 4) float64 world_T_camera on the planes' device -> (B, H, W)
    uint8 views of the left (or right) camera; `render_view`'s arithmetic
    in float64, pixel for pixel."""
    dev, f64 = poses.device, torch.float64
    H, W = int(rig["height"]), int(rig["width"])
    fx, fy = float(np.float32(rig["fx"])), float(np.float32(rig["fy"]))
    cx, cy = float(np.float32(rig["cx"])), float(np.float32(rig["cy"]))
    R = poses[:, :3, :3]
    o = poses[:, :3, 3]
    if right:
        base = float(np.float32(rig["baseline"]))
        o = o + R @ torch.tensor([base, 0.0, 0.0], dtype=f64, device=dev)
    xs = (torch.arange(W, dtype=f64, device=dev) - cx) / fx
    ys = (torch.arange(H, dtype=f64, device=dev) - cy) / fy
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = torch.stack([dx, dy, torch.ones_like(dx)], -1)      # (H, W, 3)
    d = dirs[None] @ R.transpose(-1, -2)[:, None]              # (B,H,W,3)

    B = poses.shape[0]
    best_t = torch.full((B, H, W), math.inf, dtype=f64, device=dev)
    img = torch.full((B, H, W), VOID, dtype=f64, device=dev)
    for pl in planes:
        p0, u, v = (torch.tensor(a, dtype=f64, device=dev)
                    for a in (pl.p0, pl.u, pl.v))
        n = torch.linalg.cross(u, v)
        dn = d @ n
        denom = torch.where(dn.abs() < 1e-12, math.nan, dn)
        t = ((p0 - o) @ n)[:, None, None] / denom
        hit = torch.isfinite(t) & (t > 1e-6) & (t < best_t)
        X = o[:, None, None] + t[..., None] * d
        rel = X - p0
        a = rel @ u
        b = rel @ v
        inb = (hit & (a >= 0) & (a < pl.extent[0]) & (b >= 0)
               & (b < pl.extent[1]))
        Ht, Wt = pl.tex.shape
        ta = torch.nan_to_num(a / pl.scale).clamp(0, Ht - 1.001)
        tb = torch.nan_to_num(b / pl.scale).clamp(0, Wt - 1.001)
        i0 = ta.to(torch.int64)
        j0 = tb.to(torch.int64)
        wa = ta - i0
        wb = tb - j0
        tex = pl.tex.to(f64).reshape(-1)
        i1 = torch.clamp(i0 + 1, max=Ht - 1)
        j1 = torch.clamp(j0 + 1, max=Wt - 1)
        val = ((1 - wa) * (1 - wb) * tex[i0 * Wt + j0]
               + wa * (1 - wb) * tex[i1 * Wt + j0]
               + (1 - wa) * wb * tex[i0 * Wt + j1]
               + wa * wb * tex[i1 * Wt + j1])
        img = torch.where(inb, val, img)
        best_t = torch.where(inb, t, best_t)
    return img.round().clamp(0, 255).to(torch.uint8)

"""Rendered-world backend: textured 3D scenes -> stereo image sequences
(counterpart of `front_end_tpu/sim/render.py`, on the port's `StereoRig`).

A scene is a set of finite textured planes (a corridor: floor, ceiling,
two walls, far wall), rendered by inverse ray casting with bilinear
texture sampling — pure numpy on the host, the data generator and not the
compute path.  Frames are rounded to integers, like 8-bit sensor data.

Conventions match `geometry.camera.StereoRig`: x right, y down, z
forward; the right camera sits +baseline along x; poses are
world_T_camera.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from front_end_tpu_torch.geometry.camera import StereoRig


class TexturedPlane(NamedTuple):
    p0: np.ndarray       # (3,) origin corner (world)
    u: np.ndarray        # (3,) texture u axis (unit, world)
    v: np.ndarray        # (3,) texture v axis (unit, world)
    extent: tuple        # (len_u, len_v) metres
    tex: np.ndarray      # (Ht, Wt) float32 texture
    scale: float         # metres per texel


def make_texture(rng, size: int = 512, lo: float = 20.0,
                 hi: float = 235.0,
                 area_density: bool = False) -> np.ndarray:
    """Multi-scale blob + noise texture with integer-rounded values (ties
    in FAST scores are annihilated by cv2-exact NMS; real sensors don't
    tie, so neither does this).

    area_density=True scales the blob COUNT with the texel AREA instead
    of linearly with `size`, so fine textures keep the same corner
    density per square metre — without it a 1024² texture is 2x sparser
    per texel than the 512² default and close-range views go nearly
    featureless (measured: the reversal trajectory's mid-turn frames
    dropped to ~5 stereo matches).  Opt-in to keep r4 textures
    bit-identical."""
    t = np.full((size, size), 128.0)
    n1 = size * size // 256 if area_density else size
    n2 = size * size // 512 if area_density else size // 2
    for _ in range(n1):
        y, x = rng.randint(0, size - 24, 2)
        s = rng.randint(6, 24)
        t[y:y + s, x:x + s] = rng.uniform(lo, hi)
    for _ in range(n2):
        y, x = rng.randint(0, size - 8, 2)
        s = rng.randint(2, 8)
        t[y:y + s, x:x + s] = rng.uniform(lo, hi)
    t += rng.normal(0, 2.0, t.shape)
    return np.clip(np.round(t), 0, 255).astype(np.float32)


def corridor_scene(rng, *, width: float = 4.0, height: float = 3.0,
                   length: float = 40.0, tex_size: int = 512,
                   capped: bool = False,
                   uniform_texel_scale: bool = False
                   ) -> list[TexturedPlane]:
    """A closed corridor along +z: floor, ceiling, both walls, far wall.
    The camera starts near the origin looking down +z.  `capped` adds a
    NEAR end-wall behind the start (z = -2) so a camera that turns
    around mid-corridor (heading-reversal trajectories) still faces
    texture instead of the open end.

    `uniform_texel_scale`: give every plane the SAME metres-per-texel
    (the long walls' scale) instead of one texture size for all.  The
    default stretches `tex_size` texels over each plane's longest edge,
    which makes the small end-walls ~10x finer than the side walls —
    sub-pixel texels at viewing distance alias and jitter corner
    positions frame to frame (measured: the reversal trajectory's
    return leg, which faces the near cap, accumulated 2-5x larger
    per-step errors from exactly this).  Kept opt-in so the r4
    rendered-world oracle numbers stay comparable."""
    w2, h2 = width / 2.0, height / 2.0
    ex, ey, ez = np.eye(3)
    span_max = length + (2.0 if capped else 0.0)

    def plane(p0, u, v, eu, ev):
        ts = tex_size
        if uniform_texel_scale:
            ts = max(64, int(round(tex_size * max(eu, ev) / span_max)))
        return TexturedPlane(
            p0=np.asarray(p0, np.float64), u=np.asarray(u, np.float64),
            v=np.asarray(v, np.float64), extent=(eu, ev),
            tex=make_texture(rng, ts, area_density=uniform_texel_scale),
            scale=max(eu, ev) / ts)

    z0 = -2.0 if capped else 0.0
    span = length - z0
    scene = [
        plane([-w2, h2, z0], ez, ex, span, width),         # floor (y=+h2)
        plane([-w2, -h2, z0], ez, ex, span, width),        # ceiling
        plane([-w2, -h2, z0], ez, ey, span, height),       # left wall
        plane([w2, -h2, z0], ez, ey, span, height),        # right wall
        plane([-w2, -h2, length], ex, ey, width, height),  # far wall
    ]
    if capped:
        scene.append(plane([-w2, -h2, z0], ex, ey, width, height))
    return scene


def render_view(scene: Sequence[TexturedPlane], rig: StereoRig,
                T_wc: np.ndarray, *, right: bool = False) -> np.ndarray:
    """Render one camera view.  T_wc: (4,4) world_T_camera."""
    H, W = rig.height, rig.width
    fx, fy = float(rig.fx), float(rig.fy)
    cx, cy = float(rig.cx), float(rig.cy)
    R = np.asarray(T_wc, np.float64)[:3, :3]
    o = np.asarray(T_wc, np.float64)[:3, 3].copy()
    if right:
        o = o + R @ np.array([float(rig.baseline), 0.0, 0.0])

    xs = (np.arange(W, dtype=np.float64) - cx) / fx
    ys = (np.arange(H, dtype=np.float64) - cy) / fy
    dx, dy = np.meshgrid(xs, ys)                     # (H, W)
    dirs = np.stack([dx, dy, np.ones_like(dx)], -1)  # camera frame
    d = dirs @ R.T                                   # world frame (H,W,3)

    best_t = np.full((H, W), np.inf)
    img = np.full((H, W), 8.0, np.float64)           # void: near-black
    for pl in scene:
        n = np.cross(pl.u, pl.v)
        dn = d @ n
        denom = np.where(np.abs(dn) < 1e-12, np.nan, dn)
        t = ((pl.p0 - o) @ n) / denom                # (H, W)
        hit = np.isfinite(t) & (t > 1e-6) & (t < best_t)
        if not hit.any():
            continue
        X = o + t[..., None] * d                     # (H, W, 3)
        rel = X - pl.p0
        a = rel @ pl.u                               # metres along u
        b = rel @ pl.v
        inb = hit & (a >= 0) & (a < pl.extent[0]) \
            & (b >= 0) & (b < pl.extent[1])
        if not inb.any():
            continue
        Ht, Wt = pl.tex.shape
        ta = np.clip(a / pl.scale, 0, Ht - 1.001)
        tb = np.clip(b / pl.scale, 0, Wt - 1.001)
        i0 = ta.astype(np.int64)
        j0 = tb.astype(np.int64)
        wa = ta - i0
        wb = tb - j0
        tex = pl.tex
        val = ((1 - wa) * (1 - wb) * tex[i0, j0]
               + wa * (1 - wb) * tex[np.minimum(i0 + 1, Ht - 1), j0]
               + (1 - wa) * wb * tex[i0, np.minimum(j0 + 1, Wt - 1)]
               + wa * wb * tex[np.minimum(i0 + 1, Ht - 1),
                               np.minimum(j0 + 1, Wt - 1)])
        img = np.where(inb, val, img)
        best_t = np.where(inb, t, best_t)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


def render_stereo_sequence(scene, rig: StereoRig, poses_wc):
    """poses_wc: (T,4,4) world_T_camera -> (lefts, rights) (T,H,W) f32."""
    lefts, rights = [], []
    for T_wc in poses_wc:
        lefts.append(render_view(scene, rig, T_wc, right=False))
        rights.append(render_view(scene, rig, T_wc, right=True))
    return np.stack(lefts), np.stack(rights)


def corridor_trajectory(n_frames: int, *, step: float = 0.12,
                        yaw_amp_deg: float = 3.0,
                        pitch_amp_deg: float = 1.5,
                        sway: float = 0.15,
                        period: float = 18.0) -> np.ndarray:
    """Rotation-rich 6-DoF walk down the corridor: forward +z steps with
    sinusoidal yaw/pitch and lateral/vertical sway.  Returns (T,4,4)
    world_T_camera ground truth."""
    poses = []
    for t in range(n_frames):
        ph = 2 * np.pi * t / period
        yaw = np.deg2rad(yaw_amp_deg) * np.sin(ph)
        pitch = np.deg2rad(pitch_amp_deg) * np.sin(1.7 * ph + 0.5)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = [sway * np.sin(ph + 1.0), 0.4 * sway * np.sin(2.3 * ph),
                    step * t]
        poses.append(T)
    return np.stack(poses)


def corridor_trajectory_reversal(n_frames: int = 100, *,
                                 step: float = 0.12,
                                 turn_frames: int = 24,
                                 sway: float = 0.08,
                                 period: float = 18.0) -> np.ndarray:
    """Out-and-back walk: a forward leg with gentle sway, a smooth in-place
    180° yaw turn over `turn_frames`, then the way back facing −z.  Drift
    cannot cancel: the camera ends near its start, so every metre of error
    shows.  Use with `corridor_scene(capped=True)` so the turned camera
    faces texture.  Returns (T, 4, 4) world_T_camera."""
    fwd = (n_frames - turn_frames) // 2
    z_turn = step * fwd
    poses = []
    for t in range(n_frames):
        ph = 2 * np.pi * t / period
        if t < fwd:                       # forward leg
            yaw = 0.0
            z = step * t
        elif t < fwd + turn_frames:       # smooth 180° turn (smoothstep)
            k = (t - fwd + 1) / turn_frames
            s = k * k * (3 - 2 * k)
            yaw = np.pi * s
            z = z_turn
        else:                             # return leg, facing −z
            yaw = np.pi
            z = z_turn - step * (t - fwd - turn_frames + 1)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        T = np.eye(4)
        T[:3, :3] = Ry
        T[:3, 3] = [sway * np.sin(ph + 1.0),
                    0.4 * sway * np.sin(2.3 * ph), z]
        poses.append(T)
    return np.stack(poses)

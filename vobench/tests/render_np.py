"""A frozen copy of the port's numpy ray caster
(`front_end_tpu_torch/sim/render.py::render_view`), the reference the
torch renderer of `vobench/scene.py` is held against.  `rig` is any
object with the `StereoRig` fields; a plane has `p0`, `u`, `v`, `extent`,
`tex` (numpy) and `scale`."""
from __future__ import annotations

import numpy as np


def render_view(scene, rig,
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

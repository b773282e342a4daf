"""Debug rendering: keypoints, stereo matches, anaglyphs, track overlays
(counterpart of `front_end_tpu/viz/draw.py`).

Host-side numpy rasterization, never on a pipeline's path.  Inputs are
numpy arrays or tensors on any device (moved to the CPU); images are
grayscale in [0, 255]; every function returns an (H, W, 3) uint8 canvas,
which `utils.png.write` saves.
"""
from __future__ import annotations

import numpy as np
import torch

GREEN = (0, 255, 0)
RED = (255, 0, 0)
BLUE = (0, 128, 255)
YELLOW = (255, 255, 0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_rgb(img):
    img = _np(img)
    if img.ndim == 3:                       # already RGB (e.g. anaglyph)
        return np.ascontiguousarray(img.astype(np.uint8))
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], -1)


def _plot_line(canvas, p0, p1, color):
    """A line by dense sampling, rounded to pixels."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    H, W = canvas.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    canvas[ys[ok], xs[ok]] = color


def _plot_cross(canvas, p, color, r=2):
    x, y = int(round(float(p[0]))), int(round(float(p[1])))
    H, W = canvas.shape[:2]
    for d in range(-r, r + 1):
        if 0 <= y + d < H and 0 <= x < W:
            canvas[y + d, x] = color
        if 0 <= y < H and 0 <= x + d < W:
            canvas[y, x + d] = color


def _side_by_side(left, right):
    L, R = _to_rgb(left), _to_rgb(right)
    out = np.zeros((max(L.shape[0], R.shape[0]), L.shape[1] + R.shape[1], 3),
                   np.uint8)
    out[:L.shape[0], :L.shape[1]] = L
    out[:R.shape[0], L.shape[1]:] = R
    return out, L.shape[1]


def draw_keypoints(img, kps, color=GREEN):
    """Keypoints overlay (cv2.drawKeypoints capability)."""
    out = _to_rgb(img)
    xy = _np(kps.xy)
    for i in np.nonzero(_np(kps.valid))[0]:
        _plot_cross(out, xy[i], color)
    return out


def draw_matches(left, kl, right, kr, matches, color=GREEN):
    """Side-by-side stereo match rendering (`visualize.py:7-50`)."""
    out, wl = _side_by_side(left, right)
    xl, xr = _np(kl.xy), _np(kr.xy)
    ti = _np(matches.train_idx)
    for q in np.nonzero(_np(matches.valid))[0]:
        p0 = xl[q]
        p1 = xr[ti[q]] + np.array([wl, 0.0])
        _plot_line(out, p0, p1, color)
        _plot_cross(out, p0, RED)
        _plot_cross(out, p1, BLUE)
    return out


def draw_stereo_uv4(left, right, uv4, valid, color=GREEN):
    """Side-by-side stereo matches from the pipeline's (N, 4) [ul, vl, ur,
    vr] rows (`FrameFeatures.uv4`, `stereo_valid`)."""
    out, wl = _side_by_side(left, right)
    uv = _np(uv4)
    for i in np.nonzero(_np(valid))[0]:
        p0 = uv[i, :2]
        p1 = uv[i, 2:] + np.array([wl, 0.0])
        _plot_line(out, p0, p1, color)
        _plot_cross(out, p0, RED)
        _plot_cross(out, p1, BLUE)
    return out


def anaglyph(left, right):
    """Red/cyan stereoscopic composite (`visualize.py:52-64`): left ->
    red, right -> green and blue."""
    L = np.clip(_np(left), 0, 255).astype(np.uint8)
    R = np.clip(_np(right), 0, 255).astype(np.uint8)
    return np.stack([L, R, R], -1)


def draw_tracks(img, xy_prev, xy_cur, inliers, valid):
    """Inter-frame track overlay (`visualize.py:66-109`): green = motion
    inliers, red = outliers."""
    out = _to_rgb(img)
    xp, xc, inl = _np(xy_prev), _np(xy_cur), _np(inliers)
    for i in np.nonzero(_np(valid))[0]:
        col = GREEN if inl[i] else RED
        _plot_line(out, xp[i], xc[i], col)
        _plot_cross(out, xc[i], col, r=1)
    return out

"""SURF: the Fast-Hessian detector and the 64/128-d descriptor
(frozen from the port's `ops/surf.py`).

Stages: integral image; box-filter Hessian layers at full resolution for
every octave; 3×3×3 scale-space maxima; quadratic sub-pixel interpolation;
Haar-wavelet orientation (a 60° window sliding in 10° steps); a 4×4
subregion descriptor of Haar responses, L2-normalised.  Every per-pixel
loop is a dense stencil over shifted integral-image slices, and the
per-keypoint work is batched over a fixed keypoint capacity.

Where the JAX package pools the 400 samples of a descriptor into its 16
subregions by a one-hot matrix product, the port reshapes them to (row
block, row, column block, column) and sums the two inner axes; top-k is a
stable sort (lower index first among equal values, `lax.top_k`'s rule).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference.grid import _stable_topk
from vobench.reference.image import integral_image, shift_views
from vobench.reference.types import Descriptors, Keypoints

# keypoint capacity behind `detect_dense`'s score map
DENSE_CAPACITY = 1024


def _boxes(ii, r: int):
    """`box(x0, y0, x1, y1)`: dense box sums over [y0, y1) × [x0, x1),
    offsets relative to each pixel and at most `r` in size, from static
    slices of one edge-padded copy of ii (..., H+1, W+1) -> (..., H, W).
    Windows past the image clamp to its edge."""
    H, W = ii.shape[-2] - 1, ii.shape[-1] - 1
    v = shift_views(ii, r, r)

    def tap(dy, dx):
        return v(dy, dx)[..., :H, :W]

    def box(x0, y0, x1, y1):
        return tap(y1, x1) - tap(y0, x1) - tap(y1, x0) + tap(y0, x0)

    return box


def hessian_layer(ii, size: int):
    """(det(H), trace) of one box-filter size."""
    lobe = size // 3
    half = size // 2
    w = 2 * lobe - 1                 # lateral width
    x0, x1 = -(w // 2), w // 2 + 1
    box = _boxes(ii, half + 1)
    Dyy = (box(x0, -half, x1, -half + 3 * lobe)
           - 3.0 * box(x0, -half + lobe, x1, -half + 2 * lobe))
    Dxx = (box(-half, x0, -half + 3 * lobe, x1)
           - 3.0 * box(-half + lobe, x0, -half + 2 * lobe, x1))
    Dxy = (box(-lobe, -lobe, 0, 0) + box(1, 1, lobe + 1, lobe + 1)
           - box(1, -lobe, lobe + 1, 0) - box(-lobe, 1, 0, lobe + 1))
    inv = 1.0 / (size * size)
    Dxx, Dyy, Dxy = Dxx * inv, Dyy * inv, Dxy * inv
    return Dxx * Dyy - (0.9 * Dxy) ** 2, Dxx + Dyy


class SurfDetections(NamedTuple):
    keypoints: Keypoints         # xy; score = det(H) response
    size: torch.Tensor           # (K,) filter size per keypoint
    laplacian: torch.Tensor      # (K,) sign of the trace
    cut: torch.Tensor            # () largest response a top-k dropped, or 0


def _gather9(layer, ys, xs):
    """3×3 neighbourhoods at integer centres, clamped: (N, 3, 3)."""
    H, W = layer.shape
    d = torch.arange(-1, 2, device=layer.device)
    yy = (ys[:, None, None] + d[None, :, None]).clamp(0, H - 1)
    xx = (xs[:, None, None] + d[None, None, :]).clamp(0, W - 1)
    return layer.reshape(-1)[yy * W + xx]


def interpolate_keypoints(d_lo, d_mid, d_hi, ys, xs, size, step):
    """3-D quadratic interpolation of det(H) around each maximum over (x,
    y, scale): offset = −H⁻¹g, accepted when every |offset| < 1.  Returns
    (x, y, size, ok), all (N,); `step` is the filter-size spacing of
    adjacent layers."""
    v = torch.stack([_gather9(d, ys, xs) for d in (d_lo, d_mid, d_hi)], 1)
    gx = (v[:, 1, 1, 2] - v[:, 1, 1, 0]) * 0.5
    gy = (v[:, 1, 2, 1] - v[:, 1, 0, 1]) * 0.5
    gs = (v[:, 2, 1, 1] - v[:, 0, 1, 1]) * 0.5
    c = v[:, 1, 1, 1]
    dxx = v[:, 1, 1, 2] + v[:, 1, 1, 0] - 2 * c
    dyy = v[:, 1, 2, 1] + v[:, 1, 0, 1] - 2 * c
    dss = v[:, 2, 1, 1] + v[:, 0, 1, 1] - 2 * c
    dxy = (v[:, 1, 2, 2] - v[:, 1, 2, 0]
           - v[:, 1, 0, 2] + v[:, 1, 0, 0]) * 0.25
    dxs = (v[:, 2, 1, 2] - v[:, 2, 1, 0]
           - v[:, 0, 1, 2] + v[:, 0, 1, 0]) * 0.25
    dys = (v[:, 2, 2, 1] - v[:, 2, 0, 1]
           - v[:, 0, 2, 1] + v[:, 0, 0, 1]) * 0.25
    Hm = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                      torch.stack([dxy, dyy, dys], -1),
                      torch.stack([dxs, dys, dss], -1)], -2)
    g = torch.stack([gx, gy, gs], -1)
    # damped: singular fits stay finite or fail the gate; solve_ex does not
    # raise on a singular system, it returns what the factorisation gives
    eye = torch.eye(3, device=v.device) * 1e-12
    off = -torch.linalg.solve_ex(Hm + eye, g[..., None])[0][..., 0]
    ok = torch.isfinite(off).all(-1) & (off.abs() < 1.0).all(-1)
    zero = torch.zeros_like(gx)
    x_ref = xs.to(torch.float32) + torch.where(ok, off[:, 0], zero)
    y_ref = ys.to(torch.float32) + torch.where(ok, off[:, 1], zero)
    size_ref = size + torch.where(ok, off[:, 2], zero) * step
    return x_ref, y_ref, size_ref, ok


def _layer_sizes(n_octaves: int, n_octave_layers: int):
    """Per candidate layer (size, lower size, upper size, step): octave o
    has sizes 3·(2^(o+1) + 1) + 6·2^o·k, its middle layers are the
    candidates."""
    out = []
    for o in range(n_octaves):
        step = 6 << o
        first = 3 * ((1 << (o + 1)) + 1)
        sizes = [first + step * k for k in range(n_octave_layers + 2)]
        for j in range(1, n_octave_layers + 1):
            out.append((sizes[j], sizes[j - 1], sizes[j + 1], step))
    return out


def detect(img, *, hessian_threshold: float = 100.0, n_octaves: int = 3,
           n_octave_layers: int = 2, max_keypoints: int = 1024,
           subpix: bool = True) -> SurfDetections:
    """Fast-Hessian keypoints of one (H, W) image: per candidate layer the
    3×3×3 maxima above the threshold away from the border, a top-k of
    max(max_keypoints // layers, 16) each, then the global top
    max_keypoints.  Where the layers' shares hold fewer candidates than
    max_keypoints (3 or 5 layers an octave: 1020 of 1024), the rest of the
    capacity is invalid rows; the JAX package's `lax.top_k` refuses that
    case.  `cut` is the largest response either top-k left out (0 when
    none did): a count of responses above t is exact iff t >= cut."""
    img = img.to(torch.float32)
    H, W = img.shape
    dev = img.device
    ii = integral_image(img)
    layers = {}

    def det_for(size):
        if size not in layers:
            layers[size] = hessian_layer(ii, size)
        return layers[size]

    cand = _layer_sizes(n_octaves, n_octave_layers)
    k_per_layer = max(max_keypoints // max(len(cand), 1), 16)
    ys_i = torch.arange(H, device=dev)[:, None]
    xs_i = torch.arange(W, device=dev)[None, :]
    xs_all, ys_all, sc_all, sz_all, lap_all = [], [], [], [], []
    cut = torch.zeros((), device=dev)
    for size, lo, hi, step in cand:
        d_lo, d_mid, d_hi = det_for(lo)[0], det_for(size)[0], det_for(hi)[0]
        t_mid = det_for(size)[1]
        neigh = None
        for layer in (d_lo, d_mid, d_hi):
            view = shift_views(layer, 1, 1)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if layer is d_mid and dy == 0 and dx == 0:
                        continue
                    s = view(dy, dx)
                    neigh = s if neigh is None else torch.maximum(neigh, s)
        margin = size // 2 + 1
        interior = ((ys_i >= margin) & (ys_i < H - margin)
                    & (xs_i >= margin) & (xs_i < W - margin))
        is_max = (d_mid > hessian_threshold) & (d_mid > neigh) & interior
        score = torch.where(is_max, d_mid, torch.zeros_like(d_mid))
        v, idx = _stable_topk(score.reshape(-1), k_per_layer + 1)
        if v.shape[0] > k_per_layer:
            cut = torch.maximum(cut, v[k_per_layer])
        v, idx = v[:k_per_layer], idx[:k_per_layer]
        yy, xx = idx // W, idx % W
        szf = torch.full((k_per_layer,), float(size), device=dev)
        if subpix:
            xr, yr, sr, ok = interpolate_keypoints(d_lo, d_mid, d_hi, yy, xx,
                                                   szf, float(step))
            v = torch.where(ok, v, torch.zeros_like(v))
        else:
            xr, yr, sr = xx.to(torch.float32), yy.to(torch.float32), szf
        xs_all.append(xr)
        ys_all.append(yr)
        sz_all.append(sr)
        sc_all.append(v)
        lap_all.append(torch.sign(t_mid.reshape(-1)[idx]))

    xs, ys, sc, sz, lap = (torch.cat(a) for a in
                           (xs_all, ys_all, sc_all, sz_all, lap_all))
    if xs.shape[0] < max_keypoints:
        pad = (0, max_keypoints - xs.shape[0])
        xs, ys, sc, sz, lap = (F.pad(a, pad) for a in (xs, ys, sc, sz, lap))
    v, sel = _stable_topk(torch.where(sc > 0, sc, torch.full_like(sc, -1.0)),
                          max_keypoints + 1)
    if v.shape[0] > max_keypoints:
        cut = torch.maximum(cut, v[max_keypoints])
    v, sel = v[:max_keypoints], sel[:max_keypoints]
    kps = Keypoints(xy=torch.stack([xs[sel], ys[sel]], -1), score=v,
                    angle=torch.zeros_like(v), valid=v > 0)
    return SurfDetections(keypoints=kps, size=sz[sel], laplacian=lap[sel],
                          cut=cut)


def dense_map(img, *, hessian_threshold: float = 100.0,
              n_octaves: int = 3, n_octave_layers: int = 2):
    """Score map of the maxima's det(H) at their pixels (`DENSE_CAPACITY`
    at most, no interpolation) and the detection's `cut`: a count of
    `map > t` is exact iff t >= cut."""
    det = detect(img, hessian_threshold=hessian_threshold,
                 n_octaves=n_octaves, n_octave_layers=n_octave_layers,
                 max_keypoints=DENSE_CAPACITY, subpix=False)
    H, W = img.shape[-2:]
    k = det.keypoints
    flat = (k.xy[:, 1].to(torch.int64) * W + k.xy[:, 0].to(torch.int64))
    vals = torch.where(k.valid, k.score, torch.zeros_like(k.score))
    smap = torch.zeros(H * W, dtype=torch.float32, device=img.device)
    return smap.scatter_reduce(0, flat, vals, "amax").reshape(H, W), det.cut


def detect_dense(img, *, hessian_threshold: float = 100.0,
                 n_octaves: int = 3, n_octave_layers: int = 2):
    """Score-map form of `dense_map`; corners are `map > 0`."""
    return dense_map(img, hessian_threshold=hessian_threshold,
                     n_octaves=n_octaves, n_octave_layers=n_octave_layers)[0]


# ---------------------------------------------------------------------------
# descriptor
# ---------------------------------------------------------------------------

def _haar_xy(ii, px, py, s):
    """Haar responses (dx, dy) of size 2s at integer points (4-tap
    integral lookups, clamped to the table)."""
    H, W = ii.shape[-2] - 1, ii.shape[-1] - 1
    flat = ii.reshape(-1)

    def at(yy, xx):
        return flat[yy.clamp(0, H) * (W + 1) + xx.clamp(0, W)]

    def box(x0, y0, x1, y1):
        return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)

    dx = box(px, py - s, px + s, py + s) - box(px - s, py - s, px, py + s)
    dy = box(px - s, py, px + s, py + s) - box(px - s, py - s, px + s, py)
    return dx, dy


def _haar_maps(ii, hs: int):
    """Dense Haar maps dx(y, x), dy(y, x) for one constant half-size: the
    responses of `_haar_xy` at every pixel."""
    box = _boxes(ii, hs)
    return (box(0, -hs, hs, hs) - box(-hs, -hs, 0, hs),
            box(-hs, 0, hs, hs) - box(-hs, -hs, hs, 0))


@functools.lru_cache(maxsize=8)
def _descriptor_grid(device):
    """20×20 sample offsets (x, y) in units of s (cell centres), row-major,
    and their Gaussian weights (sigma 3.3), on `device`."""
    grid = np.mgrid[-10:10, -10:10].astype(np.float32) + 0.5
    gy = grid[0].reshape(-1)
    gx = grid[1].reshape(-1)
    gw = np.exp(-(gx**2 + gy**2) / (2 * 3.3**2)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (gx, gy, gw))


def _pool(v):
    """(N, 400) samples -> (N, 16) subregion sums, subregion (column block)
    · 4 + (row block) as in the JAX package."""
    n = v.shape[0]
    blocks = v.reshape(n, 4, 5, 4, 5).sum((2, 4))      # (N, row b, col b)
    return blocks.transpose(1, 2).reshape(n, 16)


def describe(img, xy, *, size=None, angle=None, extended: bool = False,
             upright: bool = False) -> Descriptors:
    """64-d (128-d extended) descriptors at (N, 2) keypoints: a 20s window
    of 4×4 subregions of 5×5 samples, Haar size 2s, Gaussian weight 3.3s;
    per subregion (Σdx, Σdy, Σ|dx|, Σ|dy|), split by the sign of the other
    response when extended; L2-normalised.  Without `size` every keypoint
    has size 9 and the responses come from dense Haar maps."""
    img = img.to(torch.float32)
    dev = img.device
    n = xy.shape[0]
    const_size = size is None
    if size is None:
        size = torch.full((n,), 9.0, device=dev)
    if angle is None or upright:
        angle = torch.zeros(n, device=dev)
    ii = integral_image(img)
    s = (1.2 * size / 9.0).clamp(min=1.0)
    gx, gy, gw = _descriptor_grid(dev)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    rx = (gx[None] * ca - gy[None] * sa) * s[:, None]
    ry = (gx[None] * sa + gy[None] * ca) * s[:, None]
    px = torch.round(xy[:, 0:1] + rx).to(torch.int64)        # (N, 400)
    py = torch.round(xy[:, 1:2] + ry).to(torch.int64)
    if const_size:
        H, W = img.shape[-2:]
        dxm, dym = _haar_maps(ii, 1)
        idx = py.clamp(0, H - 1) * W + px.clamp(0, W - 1)
        dx, dy = dxm.reshape(-1)[idx], dym.reshape(-1)[idx]
    else:
        hs = torch.round(s).clamp(min=1.0).to(torch.int64)[:, None] \
            .expand_as(px)
        dx, dy = _haar_xy(ii, px, py, hs)
    rdx = (dx * ca + dy * sa) * gw[None]
    rdy = (-dx * sa + dy * ca) * gw[None]

    if not extended:
        feats = [_pool(rdx), _pool(rdy), _pool(rdx.abs()), _pool(rdy.abs())]
    else:
        zero = torch.zeros_like(rdx)
        pos_y, pos_x = rdy >= 0, rdx >= 0
        feats = [_pool(torch.where(pos_y, rdx, zero)),
                 _pool(torch.where(~pos_y, rdx, zero)),
                 _pool(torch.where(pos_y, rdx.abs(), zero)),
                 _pool(torch.where(~pos_y, rdx.abs(), zero)),
                 _pool(torch.where(pos_x, rdy, zero)),
                 _pool(torch.where(~pos_x, rdy, zero)),
                 _pool(torch.where(pos_x, rdy.abs(), zero)),
                 _pool(torch.where(~pos_x, rdy.abs(), zero))]
    vec = torch.cat(feats, -1)
    norm = torch.sqrt((vec * vec).sum(-1, keepdim=True)).clamp(min=1e-9)
    return Descriptors(bits=vec / norm, norm="l2")



"""AKAZE: the nonlinear (FED) scale space detector with M-SURF and MLDB
descriptors (counterpart of `front_end_tpu/ops/akaze.py`).

- nonlinear scale space by Fast Explicit Diffusion: per level, explicit
  4-neighbour diffusion steps of host-computed sizes (a Python loop over a
  constant tau list, where JAX scans), the conductivity from the smoothed
  gradient, its contrast factor k the 70th percentile of the gradient
  magnitudes; halfsampled between octaves, k shrunk by 0.75;
- the scale-normalised determinant of the Hessian, its 3×3 maxima above the
  threshold and above the same octave's neighbouring levels, an in-level
  quadratic sub-pixel fit, a per-level top-k merged into one capacity;
- the dominant orientation (a 60° window over 42 centres), M-SURF 64 and
  full MLDB (486 bits, padded to 512) from bilinear samples of each
  keypoint's own level.

Every map is a dense stencil of shifted views.  The contrast factor is
JAX's `nanquantile` step by step (sorted magnitudes, a float32 rank, the
two neighbours weighted), the orientation centres JAX's float32
`linspace`, and each top-k a stable sort (lower index first among equal
values, `lax.top_k`'s rule).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from front_end_tpu_torch.ops.grid import _stable_topk
from front_end_tpu_torch.ops.image import (bilinear_sample,
                                           central_gradient, gaussian_blur,
                                           quadratic_fit, rotated_samples,
                                           shift_views)
from front_end_tpu_torch.types import Descriptors, Keypoints
from front_end_tpu_torch.utils.precision import linspace_f32, true_div

# defaults of the reference's AKAZEOptions
SOFFSET = 1.6
DTHRESHOLD = 1e-3
KCONTRAST_PERCENTILE = 0.7


# --- FED step sizes (host-side constants) --------------------------------

def fed_tau_by_process_time(T: float, tau_max: float = 0.25) -> np.ndarray:
    """FED cycle step sizes whose sum is the diffusion time T: n steps of
    varying tau, each one stable."""
    n = max(1, int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5
                             - 1e-8)))
    j = np.arange(n, dtype=np.float64)
    tau = tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    scale = T / tau.sum()
    return (tau * scale).astype(np.float32)


# --- conductivities -------------------------------------------------------

def conductivity(lx, ly, k, kind: str = "pm_g2"):
    """g(|∇L|) diffusivities: Perona-Malik g1 / g2, Weickert,
    Charbonnier."""
    s = (lx * lx + ly * ly) / (k * k)
    if kind == "pm_g1":
        return torch.exp(-s)
    if kind == "pm_g2":
        return 1.0 / (1.0 + s)
    if kind == "weickert":
        return 1.0 - torch.exp(-3.315 / torch.clamp(s * s * s * s,
                                                    min=1e-12))
    if kind == "charbonnier":
        return 1.0 / torch.sqrt(1.0 + s)
    raise ValueError(f"unknown diffusivity {kind!r}")


def nanquantile_linear(x, q: float):
    """`jnp.nanquantile(x.ravel(), q)` (linear) in JAX's steps: sort with
    the NaNs last, rank q·(count − 1) in float32, the two neighbours'
    values weighted low·(1 − f) + high·f, which XLA's CPU code contracts
    to fma(high, f, low·(1 − f)) (here a product exact in float64, rounded
    once).  NaN when every value is NaN."""
    flat = x.reshape(-1)
    ok = ~torch.isnan(flat)
    s = torch.sort(torch.where(ok, flat, torch.full_like(flat, math.inf)))[0]
    counts = ok.sum().to(torch.float32)
    rank = torch.tensor(q, dtype=torch.float32, device=x.device) * (counts - 1)
    low, high = torch.floor(rank), torch.ceil(rank)
    hw = rank - low
    lw = 1.0 - hw
    top = counts - 1

    def at(i):
        return s[torch.clamp(torch.minimum(i, top), min=0).to(torch.int64)]

    f64 = torch.float64
    out = (at(high).to(f64) * hw.to(f64)
           + (at(low) * lw).to(f64)).to(torch.float32)
    return torch.where(counts > 0, out, torch.full_like(out, math.nan))


def compute_k_percentile(img, perc: float = KCONTRAST_PERCENTILE,
                         gscale: float = 1.0):
    """Contrast factor: the perc-percentile of the nonzero gradient
    magnitudes of the gscale-smoothed image, 0.03 when there are none."""
    gx, gy = central_gradient(gaussian_blur(img, gscale))
    mag = torch.sqrt(gx * gx + gy * gy)[2:-2, 2:-2]
    mag = torch.where(mag > 1e-6, mag, torch.full_like(mag, math.nan))
    k = nanquantile_linear(mag, perc)
    return torch.where(torch.isfinite(k) & (k > 1e-8), k,
                       torch.full_like(k, 0.03))


def nld_step(lt, g, tau: float):
    """One explicit diffusion step Lt += tau · div(g ∇Lt), edge-clamped
    neighbours."""
    vl, vg = shift_views(lt, 1, 1), shift_views(g, 1, 1)
    xp = (g + vg(0, 1)) * (vl(0, 1) - lt)
    xn = (g + vg(0, -1)) * (lt - vl(0, -1))
    yp = (g + vg(1, 0)) * (vl(1, 0) - lt)
    yn = (g + vg(-1, 0)) * (lt - vl(-1, 0))
    return lt + 0.5 * float(tau) * (xp - xn + yp - yn)


# --- nonlinear scale space ------------------------------------------------

class Evolution(NamedTuple):
    lt: torch.Tensor       # (h_o, w_o) diffused image
    lx: torch.Tensor       # first derivatives at the detection scale
    ly: torch.Tensor
    ldet: torch.Tensor     # scale-normalised det-Hessian response
    sigma: float           # absolute scale at base resolution
    octave: int
    sublevel: int


def _derivative_stack(lt, sigma_local: float):
    """Central differences dilated to step round(sigma), normalised back
    to unit step."""
    d = max(1, int(round(sigma_local)))
    inv = 1.0 / (2.0 * d)
    v = shift_views(lt, d, d)
    lx = (v(0, d) - v(0, -d)) * inv
    ly = (v(d, 0) - v(-d, 0)) * inv
    vx, vy = shift_views(lx, d, d), shift_views(ly, d, 0)
    lxx = (vx(0, d) - vx(0, -d)) * inv
    lyy = (vy(d, 0) - vy(-d, 0)) * inv
    lxy = (vx(d, 0) - vx(-d, 0)) * inv
    return lx, ly, lxx, lyy, lxy


def nonlinear_scale_space(img, *, n_octaves: int = 4, n_sublevels: int = 4,
                          soffset: float = SOFFSET,
                          diffusivity: str = "pm_g2") -> list[Evolution]:
    """The evolution: per level, FED steps from t_{i-1} to t_i with the
    conductivity of the smoothed gradient; halfsampled at octave
    boundaries, where k shrinks by 0.75."""
    img = true_div(img.to(torch.float32), 255.0)
    lt = gaussian_blur(img, soffset)
    k = compute_k_percentile(img)
    evolution = []
    t_prev = 0.5 * soffset ** 2
    for o in range(n_octaves):
        if o > 0:
            lt = gaussian_blur(lt, 1.0)[::2, ::2]
            k = k * 0.75
            t_prev = t_prev / 4.0   # time in octave-local pixel units
        for s in range(n_sublevels):
            sigma = soffset * (2.0 ** (o + s / n_sublevels))
            sigma_local = sigma / (1 << o)
            t_i = 0.5 * sigma_local ** 2
            if t_i > t_prev:
                gx, gy = central_gradient(gaussian_blur(lt, 1.0))
                g = conductivity(gx, gy, k, diffusivity)
                for tau in fed_tau_by_process_time(t_i - t_prev):
                    lt = nld_step(lt, g, tau)
            t_prev = t_i
            lx, ly, lxx, lyy, lxy = _derivative_stack(lt, sigma_local)
            norm = sigma_local ** 2
            ldet = (lxx * lyy - lxy * lxy) * (norm * norm)
            root = float(np.sqrt(np.float32(norm)))
            evolution.append(Evolution(lt=lt, lx=lx * root, ly=ly * root,
                                       ldet=ldet, sigma=float(sigma),
                                       octave=o, sublevel=s))
    return evolution


# --- detection ------------------------------------------------------------

class AkazeDetections(NamedTuple):
    keypoints: Keypoints
    sigma: torch.Tensor     # (K,) absolute scale
    level: torch.Tensor     # (K,) int64 evolution index


def _maxima(evo, i: int, threshold: float):
    """Level i's strict maxima over its 8 neighbours, above the threshold
    and above the same octave's neighbouring levels."""
    ld = evo[i].ldet
    v = shift_views(ld, 1, 1)
    mx = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                mx = v(dy, dx) if mx is None else torch.maximum(mx, v(dy, dx))
    is_max = (ld > mx) & (ld > threshold)
    for j in (i - 1, i + 1):
        if 0 <= j < len(evo) and evo[j].octave == evo[i].octave:
            is_max = is_max & (ld > evo[j].ldet)
    return is_max


def detect(img, *, n_octaves: int = 4, n_sublevels: int = 4,
           threshold: float = DTHRESHOLD, max_keypoints: int = 512,
           diffusivity: str = "pm_g2",
           evolution: list[Evolution] | None = None) -> AkazeDetections:
    """Scale-space extrema of the det-Hessian response: per level (the
    first skipped: it has no finer neighbour) the top max(16,
    max_keypoints // (levels − 1)) maxima away from a 3σ border, each
    moved by an in-level quadratic fit; then the global top
    max_keypoints.  Where the levels' shares hold fewer rows than
    max_keypoints, the capacity is padded with invalid rows, as JAX
    pads it."""
    img = img.to(torch.float32)
    dev = img.device
    evo = evolution if evolution is not None else nonlinear_scale_space(
        img, n_octaves=n_octaves, n_sublevels=n_sublevels,
        diffusivity=diffusivity)
    per = max(16, max_keypoints // max(1, len(evo) - 1))
    xs_l, ys_l, sc_l, sg_l, lv_l = [], [], [], [], []
    for i, ev in enumerate(evo):
        if ev.sublevel == 0 and ev.octave == 0:
            continue
        ld = ev.ldet
        h, w = ld.shape
        is_max = _maxima(evo, i, threshold)
        border = max(4, int(round(ev.sigma / (1 << ev.octave))) * 3)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        interior = ((ys >= border) & (ys < h - border)
                    & (xs >= border) & (xs < w - border))
        score = torch.where(is_max & interior, ld, torch.zeros_like(ld))

        offx, offy, _, _ = quadratic_fit(ld, 1e-18)   # in-level sub-pixel

        val, idx = _stable_topk(score.reshape(-1), per)
        scale = float(1 << ev.octave)
        ys_l.append(((idx // w).to(torch.float32)
                     + offy.reshape(-1)[idx]) * scale)
        xs_l.append(((idx % w).to(torch.float32)
                     + offx.reshape(-1)[idx]) * scale)
        sc_l.append(val)
        sg_l.append(torch.full((val.shape[0],), ev.sigma, device=dev))
        lv_l.append(torch.full((val.shape[0],), i, dtype=torch.int64,
                               device=dev))
    xs, ys, sc, sg, lv = (torch.cat(a) for a in
                          (xs_l, ys_l, sc_l, sg_l, lv_l))
    if xs.shape[0] < max_keypoints:  # pad so the capacity stays fixed
        pad = (0, max_keypoints - xs.shape[0])
        xs, ys, sc, lv = (F.pad(a, pad) for a in (xs, ys, sc, lv))
        sg = F.pad(sg, pad, value=1.0)
    v, sel = _stable_topk(torch.where(sc > 0, sc, torch.full_like(sc, -1.0)),
                          max_keypoints)
    kps = Keypoints(xy=torch.stack([xs[sel], ys[sel]], -1), score=v,
                    angle=torch.zeros_like(v), valid=v > 0)
    return AkazeDetections(keypoints=kps, sigma=sg[sel], level=lv[sel])


def detect_dense(img, *, threshold: float = DTHRESHOLD, n_octaves: int = 4,
                 n_sublevels: int = 4, diffusivity: str = "pm_g2"):
    """Base-resolution score map: the max over levels of each level's
    maxima (coarse levels nearest-upsampled); corners are `map > 0`.  No
    keypoint capacity stands behind it, so a count of `map > t` is exact
    at every t."""
    img = img.to(torch.float32)
    h, w = img.shape
    evo = nonlinear_scale_space(img, n_octaves=n_octaves,
                                n_sublevels=n_sublevels,
                                diffusivity=diffusivity)
    out = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for i, ev in enumerate(evo):
        if ev.sublevel == 0 and ev.octave == 0:
            continue
        ld = ev.ldet
        score = torch.where(_maxima(evo, i, threshold), ld,
                            torch.zeros_like(ld))
        f = 1 << ev.octave
        if f > 1:
            score = score.repeat_interleave(f, 0).repeat_interleave(f, 1)
        out = torch.maximum(out, score[:h, :w])
    return out


# --- per-keypoint sampling from the evolution -----------------------------

def _sample_levels(evo, field: str, xy_base, level_id):
    """Bilinear samples of `field` of each point's own level: (..., 2)
    base-resolution points, level ids of the same leading shape."""
    out = torch.zeros(xy_base.shape[:-1], dtype=torch.float32,
                      device=xy_base.device)
    for i, ev in enumerate(evo):
        pts = xy_base / float(1 << ev.octave)
        vals = bilinear_sample(getattr(ev, field),
                               pts.reshape(-1, 2)).reshape(out.shape)
        out = torch.where(level_id == i, vals, out)
    return out


@functools.lru_cache(maxsize=8)
def _orientation_consts(device):
    """The 113-sample disc of radius 6 ([dy, dx]), its Gaussian weights
    (sigma 2.5) and the 42 window centres, JAX's float32 values."""
    offs = np.asarray([(dy, dx) for dy in range(-6, 7) for dx in range(-6, 7)
                       if dy * dy + dx * dx <= 36], np.float32)
    w_g = np.exp(-(offs ** 2).sum(1) / (2 * 2.5 ** 2)).astype(np.float32)
    centres = linspace_f32(-np.pi, np.pi, 42, endpoint=False)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (offs, w_g, centres))


def orientations(evo, xy, sigma, level_id, valid):
    """Dominant orientation from Lx, Ly in a 6σ disc: the strongest of 42
    sliding 60° windows (first among equals)."""
    offs, wj, centres = _orientation_consts(xy.device)
    step = sigma[:, None]
    px = xy[:, 0:1] + offs[None, :, 1] * step
    py = xy[:, 1:2] + offs[None, :, 0] * step
    pts = torch.stack([px, py], -1)
    lid = level_id[:, None].expand(px.shape)
    rx = _sample_levels(evo, "lx", pts, lid) * wj[None]
    ry = _sample_levels(evo, "ly", pts, lid) * wj[None]
    ang = torch.atan2(ry, rx)                              # (N, P)
    d = (ang[:, None, :] - centres[None, :, None]).abs()
    d = torch.minimum(d, 2 * math.pi - d)
    in_win = (d <= math.pi / 6.0).to(torch.float32)        # (N, C, P)
    sx = torch.einsum("ncp,np->nc", in_win, rx)
    sy = torch.einsum("ncp,np->nc", in_win, ry)
    best = (sx * sx + sy * sy).argmax(-1)
    bi = torch.arange(xy.shape[0], device=xy.device)
    angle = torch.atan2(sy[bi, best], sx[bi, best])
    return torch.where(valid, angle, torch.zeros_like(angle))


# --- M-SURF 64 ------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _msurf_consts(device):
    """The 20×20 sample lattice ([dy, dx]) and its (400, 16) subregion
    weights: each sample counts for every 9×9 window (stride 5) that covers
    it, Gaussian sigma 2.5 inside, 7.5 over the subregion centres."""
    S = 20
    offs = (np.mgrid[0:S, 0:S].reshape(2, -1).T.astype(np.float32)
            - (S - 1) / 2.0)
    wmat = np.zeros((offs.shape[0], 16), np.float32)
    for ci in range(4):
        for cj in range(4):
            cy = (ci - 1.5) * 5.0
            cx = (cj - 1.5) * 5.0
            d2 = ((offs[:, 0] - cy) ** 2 + (offs[:, 1] - cx) ** 2)
            inside = (np.abs(offs[:, 0] - cy) <= 4.5) & \
                     (np.abs(offs[:, 1] - cx) <= 4.5)
            g = np.exp(-d2 / (2 * 2.5 ** 2)) * inside
            g_global = math.exp(-(cy ** 2 + cx ** 2) / (2 * (1.5 * 5) ** 2))
            wmat[:, ci * 4 + cj] = g * g_global
    return (torch.as_tensor(offs, device=device),
            torch.as_tensor(wmat, device=device))


def describe_msurf(evo, xy, sigma, angle, level_id, valid) -> Descriptors:
    """M-SURF 64: 4×4 overlapping subregions over a 24σ patch; per
    subregion the weighted sums of (dx, dy, |dx|, |dy|) of the rotated
    derivatives; L2-normalised.  Float values, matched by L2 distance."""
    n = xy.shape[0]
    offs, wmat = _msurf_consts(xy.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    pts = rotated_samples(xy, offs, ca, sa,
                          true_div(sigma * 24.0, 20.0)[:, None])
    lid = level_id[:, None].expand(pts.shape[:-1])
    gx = _sample_levels(evo, "lx", pts, lid)
    gy = _sample_levels(evo, "ly", pts, lid)
    dx = gx * ca[:, None] + gy * sa[:, None]
    dy = -gx * sa[:, None] + gy * ca[:, None]
    feats = torch.stack([dx, dy, dx.abs(), dy.abs()], -1)   # (N, P, 4)
    vec = torch.einsum("npf,pc->ncf", feats, wmat).reshape(n, 64)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True).clamp(min=1e-9)
    return Descriptors(bits=vec * valid[:, None], norm="l2")


# --- MLDB -----------------------------------------------------------------

MLDB_BITS = 486          # 3 channels x (6 + 36 + 120) pairwise comparisons
MLDB_PADDED = 512


def _mldb_pattern():
    """Per grid (2×2, 3×3, 4×4): each cell's 3×3 sample offsets in
    pattern units ([-1, 1] patch, [dy, dx]) and the cell pairs."""
    grids = []
    for div in (2, 3, 4):
        cells = []
        for ci in range(div):
            for cj in range(div):
                cy = (ci + 0.5) / div * 2.0 - 1.0
                cx = (cj + 0.5) / div * 2.0 - 1.0
                half = 1.0 / div
                sub = (np.mgrid[0:3, 0:3].reshape(2, -1).T
                       .astype(np.float32) - 1.0) * (half * 2 / 3)
                cells.append(np.stack([cy + sub[:, 0], cx + sub[:, 1]], -1))
        n_cells = div * div
        pairs = [(i, j) for i in range(n_cells) for j in range(i + 1,
                                                               n_cells)]
        grids.append((np.asarray(cells, np.float32),
                      np.asarray(pairs, np.int64)))
    return grids


_MLDB_GRIDS = _mldb_pattern()


def describe_mldb(evo, xy, sigma, angle, level_id, valid) -> Descriptors:
    """Full MLDB: for the 2×2, 3×3 and 4×4 grids over the rotated 10σ
    patch, per-cell means of (Lt, Lx', Ly') from 9 samples each, then
    every pairwise comparison per channel: 486 bits, zero-padded to 512."""
    n = xy.shape[0]
    dev = xy.device
    ca, sa = torch.cos(angle), torch.sin(angle)
    radius = (sigma * 5.0)[:, None]
    groups = []
    for cells, pairs in _MLDB_GRIDS:
        n_cells, n_sub = cells.shape[:2]
        offs = torch.as_tensor(cells.reshape(-1, 2), device=dev)
        pts = rotated_samples(xy, offs, ca, sa, radius)
        lid = level_id[:, None].expand(pts.shape[:-1])
        lt = _sample_levels(evo, "lt", pts, lid)
        gx = _sample_levels(evo, "lx", pts, lid)
        gy = _sample_levels(evo, "ly", pts, lid)
        dx = gx * ca[:, None] + gy * sa[:, None]
        dy = -gx * sa[:, None] + gy * ca[:, None]
        chans = torch.stack([lt, dx, dy], 1).reshape(n, 3, n_cells, n_sub)
        total = chans[..., 0]
        for k in range(1, n_sub):     # one order of sums on every device
            total = total + chans[..., k]
        means = true_div(total, float(n_sub))                # (N, 3, C)
        pi = torch.as_tensor(pairs[:, 0], device=dev)
        pj = torch.as_tensor(pairs[:, 1], device=dev)
        groups.append((means[:, :, pi] > means[:, :, pj]).reshape(n, -1))
    bits = torch.cat(groups, -1).to(torch.float32)
    bits = F.pad(bits, (0, MLDB_PADDED - bits.shape[-1]))
    return Descriptors(bits=bits * valid[:, None])


def detect_and_describe(img, *, n_octaves: int = 4, n_sublevels: int = 4,
                        threshold: float = DTHRESHOLD,
                        max_keypoints: int = 512, descriptor: str = "mldb",
                        diffusivity: str = "pm_g2"):
    """Detection, orientation and description ("mldb" or "msurf") of one
    (H, W) image -> (AkazeDetections with the angles set, Descriptors)."""
    img = img.to(torch.float32)
    evo = nonlinear_scale_space(img, n_octaves=n_octaves,
                                n_sublevels=n_sublevels,
                                diffusivity=diffusivity)
    det = detect(img, threshold=threshold, max_keypoints=max_keypoints,
                 evolution=evo)
    kps = det.keypoints
    ang = orientations(evo, kps.xy, det.sigma, det.level, kps.valid)
    if descriptor == "mldb":
        desc = describe_mldb(evo, kps.xy, det.sigma, ang, det.level,
                             kps.valid)
    elif descriptor == "msurf":
        desc = describe_msurf(evo, kps.xy, det.sigma, ang, det.level,
                              kps.valid)
    else:
        raise ValueError(f"unknown AKAZE descriptor {descriptor!r}")
    return det._replace(keypoints=kps.replace(angle=ang)), desc

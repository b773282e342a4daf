"""SIFT: the DoG pyramid detector and the 128-d gradient-histogram
descriptor (counterpart of `front_end_tpu/ops/sift.py`).

Per octave a Gaussian stack and its differences; 3×3×3 scale-space
extrema with the contrast and edge-ratio tests and an in-layer quadratic
sub-pixel fit; a top-k per layer merged into one capacity; one dominant
orientation per keypoint from a 36-bin histogram; the 4×4×8 descriptor,
L2-normalised, clipped at 0.2 and normalised again.

The orientation histogram is a scatter-add in the JAX package.  On the
card a scatter-add sums with atomics in no fixed order, so the
histogram's argmax could change from run to run; the port adds the
samples one after another (a fixed order, the CPU's scatter order), the
same sums on the card and the CPU.  Each top-k is a stable sort (lower
index first among equal values, `lax.top_k`'s rule).
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
from front_end_tpu_torch.utils.precision import true_div

N_SPLITS = 3            # layers per octave (OpenCV nOctaveLayers)
SIGMA0 = 1.6
CONTRAST_THR = 0.04     # on the [0, 1] scale, OpenCV's contrastThreshold
EDGE_THR = 10.0


def build_pyramid(img, n_octaves: int, n_layers: int = N_SPLITS,
                  sigma0: float = SIGMA0) -> list[torch.Tensor]:
    """Per octave a (n_layers + 3, h_o, w_o) Gaussian stack; the next
    octave starts from layer n_layers halfsampled."""
    img = true_div(img.to(torch.float32), 255.0)
    k = 2.0 ** (1.0 / n_layers)
    sigmas = [sigma0 * (k ** i) for i in range(n_layers + 3)]
    octaves = []
    base = gaussian_blur(img, sigma0)
    for _ in range(n_octaves):
        stack = [base]
        for i in range(1, n_layers + 3):
            inc = np.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6))
            stack.append(gaussian_blur(stack[-1], float(inc)))
        octaves.append(torch.stack(stack))
        base = stack[n_layers][::2, ::2]
    return octaves


def dog_stack(gauss):
    """(L+3, h, w) -> (L+2, h, w) difference-of-Gaussians."""
    return gauss[1:] - gauss[:-1]


class SiftDetections(NamedTuple):
    keypoints: Keypoints
    sigma: torch.Tensor      # (K,) absolute scale at base resolution
    octave: torch.Tensor     # (K,) int64


def _extrema_one_octave(dog, k_per_layer: int, contrast_thr: float):
    """Scale-space extrema of one octave's (L+2, h, w) DoG stack: per
    middle layer j, (x, y, |response|, j) of its top k_per_layer."""
    L = dog.shape[0] - 2
    h, w = dog.shape[1:]
    dev = dog.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= 5) & (ys < h - 5) & (xs >= 5) & (xs < w - 5)
    outs = []
    for j in range(1, L + 1):
        mid = dog[j]
        views = [shift_views(d, 1, 1) for d in (dog[j - 1], mid, dog[j + 1])]
        mx = mn = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                for li, v in enumerate(views):
                    if li == 1 and dx == 0 and dy == 0:
                        continue
                    s = v(dy, dx)
                    mx = s if mx is None else torch.maximum(mx, s)
                    mn = s if mn is None else torch.minimum(mn, s)
        is_ext = (((mid > mx) & (mid > contrast_thr))
                  | ((mid < mn) & (mid < -contrast_thr)))
        # sub-pixel offsets within the layer; edge rejection by the 2×2
        # Hessian's ratio
        offx, offy, tr, det = quadratic_fit(mid, 1e-12)
        r = EDGE_THR
        ok_edge = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        score = torch.where(is_ext & ok_edge & interior, mid.abs(),
                            torch.zeros_like(mid))
        val, idx = _stable_topk(score.reshape(-1), k_per_layer)
        yy = (idx // w).to(torch.float32) + offy.reshape(-1)[idx]
        xx = (idx % w).to(torch.float32) + offx.reshape(-1)[idx]
        outs.append((xx, yy, val, j))
    return outs


def detect(img, *, n_octaves: int = 3, n_layers: int = N_SPLITS,
           contrast_threshold: float = CONTRAST_THR,
           max_keypoints: int = 1024) -> SiftDetections:
    """DoG extrema of one (H, W) image: the contrast test at
    contrast_threshold / n_layers (OpenCV's), per layer the top max(16,
    max_keypoints // (octaves · layers)), then the global top
    max_keypoints; a short pool is padded with invalid rows."""
    img = img.to(torch.float32)
    dev = img.device
    k = 2.0 ** (1.0 / n_layers)
    dog_thr = contrast_threshold / n_layers
    per = max(16, max_keypoints // (n_octaves * n_layers))
    xs_l, ys_l, sc_l, sg_l, oc_l = [], [], [], [], []
    for o, gauss in enumerate(build_pyramid(img, n_octaves, n_layers)):
        scale = float(1 << o)
        for xx, yy, v, j in _extrema_one_octave(dog_stack(gauss), per,
                                                dog_thr):
            xs_l.append(xx * scale)
            ys_l.append(yy * scale)
            sc_l.append(v)
            sg_l.append(torch.full((v.shape[0],), SIGMA0 * (k ** j) * scale,
                                   device=dev))
            oc_l.append(torch.full((v.shape[0],), o, dtype=torch.int64,
                                   device=dev))
    xs, ys, sc, sg, oc = (torch.cat(a) for a in
                          (xs_l, ys_l, sc_l, sg_l, oc_l))
    if sc.shape[0] < max_keypoints:
        pad = (0, max_keypoints - sc.shape[0])
        xs, ys, oc = (F.pad(a, pad) for a in (xs, ys, oc))
        sc = F.pad(sc, pad, value=-1.0)
        sg = F.pad(sg, pad, value=1.0)
    v, sel = _stable_topk(torch.where(sc > 0, sc, torch.full_like(sc, -1.0)),
                          max_keypoints)
    kps = Keypoints(xy=torch.stack([xs[sel], ys[sel]], -1), score=v,
                    angle=torch.zeros_like(v), valid=v > 0)
    return SiftDetections(keypoints=kps, sigma=sg[sel], octave=oc[sel])


@functools.lru_cache(maxsize=8)
def _orientation_grid(device):
    """The 9×9 sample offsets ([dy, dx]) and their Gaussian weights."""
    R = 4
    offs = np.mgrid[-R:R + 1, -R:R + 1].reshape(2, -1).T.astype(np.float32)
    w_g = np.exp(-(offs ** 2).sum(1) / (2 * (0.5 * R) ** 2)).astype(
        np.float32)
    return (torch.as_tensor(offs, device=device),
            torch.as_tensor(w_g, device=device))


def orientations(img, xy, sigma, valid, nbins: int = 36):
    """Dominant gradient orientation: a 36-bin histogram of Gaussian-
    weighted magnitudes, circularly smoothed, its first peak's centre."""
    gx, gy = central_gradient(img.to(torch.float32))
    offs, wj = _orientation_grid(xy.device)
    step = (1.5 * sigma / 4)[:, None]
    px = xy[:, 0:1] + offs[None, :, 1] * step
    py = xy[:, 1:2] + offs[None, :, 0] * step
    pts = torch.stack([px, py], -1).reshape(-1, 2)
    sgx = bilinear_sample(gx, pts).reshape(px.shape)
    sgy = bilinear_sample(gy, pts).reshape(px.shape)
    mag = torch.sqrt(sgx ** 2 + sgy ** 2) * wj[None]
    ang = torch.atan2(sgy, sgx)
    bin_f = true_div(ang + math.pi, 2 * math.pi) * nbins
    b0 = torch.floor(bin_f).to(torch.int64) % nbins
    # the samples added one after another: one order on every device
    bins = torch.arange(nbins, device=xy.device)
    hist = torch.zeros((xy.shape[0], nbins), device=xy.device)
    for p in range(mag.shape[1]):
        hist = hist + torch.where(b0[:, p:p + 1] == bins, mag[:, p:p + 1],
                                  torch.zeros((), device=xy.device))
    hist = true_div(hist.roll(1, -1) + hist + hist.roll(-1, -1), 3.0)
    peak = hist.argmax(-1)
    angle = (true_div(peak.to(torch.float32) + 0.5, float(nbins)) * 2
             * math.pi - math.pi)
    return torch.where(valid, angle, torch.zeros_like(angle))


@functools.lru_cache(maxsize=8)
def _descriptor_grid(device, n_spatial: int = 4):
    """The 16×16 sample offsets ([dy, dx]), their Gaussian weights and the
    (256, 16) one-hot of each sample's cell (x-block · 4 + y-block)."""
    S = 4 * n_spatial
    offs = (np.mgrid[0:S, 0:S].reshape(2, -1).T.astype(np.float32)
            - (S - 1) / 2.0)
    cell = np.floor((offs + S / 2) / n_spatial).astype(np.int32)
    cell_id = cell[:, 1] * n_spatial + cell[:, 0]
    w_g = np.exp(-(offs ** 2).sum(1) / (2 * (0.5 * S) ** 2)).astype(
        np.float32)
    onehot = np.eye(n_spatial * n_spatial, dtype=np.float32)[cell_id]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (offs, w_g, onehot))


def describe(img, xy, sigma, angle, *, n_spatial: int = 4,
             n_orient: int = 8) -> Descriptors:
    """The 4×4×8 = 128-d descriptor: rotated gradients on a σ-scaled
    16×16 grid, votes linear in orientation pooled per cell; L2-normalised,
    clipped at 0.2, normalised again.  Float values, matched by L2
    distance."""
    gx, gy = central_gradient(img.to(torch.float32))
    n = xy.shape[0]
    offs, wj, onehot = _descriptor_grid(xy.device, n_spatial)
    ca, sa = torch.cos(angle), torch.sin(angle)
    step = (sigma * 3.0 / n_spatial / 2.0)[:, None]
    pts = rotated_samples(xy, offs, ca, sa, step).reshape(-1, 2)
    sgx = bilinear_sample(gx, pts).reshape(n, -1)
    sgy = bilinear_sample(gy, pts).reshape(n, -1)
    rgx = sgx * ca[:, None] + sgy * sa[:, None]
    rgy = -sgx * sa[:, None] + sgy * ca[:, None]
    mag = torch.sqrt(rgx ** 2 + rgy ** 2) * wj[None]
    ang = torch.atan2(rgy, rgx)
    bin_f = true_div(ang + math.pi, 2 * math.pi) * n_orient
    b0 = torch.floor(bin_f).to(torch.int64) % n_orient
    b1 = (b0 + 1) % n_orient
    f = bin_f - torch.floor(bin_f)
    votes = (F.one_hot(b0, n_orient) * (mag * (1 - f))[..., None]
             + F.one_hot(b1, n_orient) * (mag * f)[..., None])   # (N, P, 8)
    vec = torch.einsum("npo,pc->nco", votes, onehot).reshape(n, -1)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True).clamp(min=1e-9)
    vec = torch.clamp(vec, max=0.2)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True).clamp(min=1e-9)
    return Descriptors(bits=vec, norm="l2")


def detect_and_describe(img, *, n_octaves: int = 3,
                        max_keypoints: int = 1024,
                        contrast_threshold: float = CONTRAST_THR):
    """Detection, orientation and description of one (H, W) image ->
    (SiftDetections with the angles set, Descriptors)."""
    img = img.to(torch.float32)
    det = detect(img, n_octaves=n_octaves, max_keypoints=max_keypoints,
                 contrast_threshold=contrast_threshold)
    kps = det.keypoints
    ang = orientations(img, kps.xy, det.sigma, kps.valid)
    desc = describe(img, kps.xy, det.sigma, ang)
    return det._replace(keypoints=kps.replace(angle=ang)), desc

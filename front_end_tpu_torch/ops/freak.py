"""FREAK: the retinal sampling pattern binary descriptor (counterpart of
`front_end_tpu/ops/freak.py`).

43 receptive fields — a foveal centre and 7 rings of 6 points — whose
radius and smoothing grow toward the periphery; each ring is sampled
bilinearly from its own Gaussian blur.  The orientation comes from 45
symmetric pairs, the descriptor from 512 point-pair comparisons ordered
coarse to fine (the JAX package's deterministic pair choice; OpenCV learns
its pairs offline).  The pattern is this package's own copy, built the
same way.  FREAK is descriptor-only: it rides another detector's
keypoints.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from front_end_tpu_torch.ops.brisk import (on_device, ring_blurs,
                                           ring_columns, rotate, sample_rings)
from front_end_tpu_torch.types import Descriptors

N_RINGS = 8                      # the foveal centre counts as ring 0
N_BITS = 512


@functools.lru_cache(maxsize=1)
def _retina():
    """(P, 2) [dy, dx] offsets, ring id, sigma per ring, 512 descriptor
    pairs, 45 orientation pairs."""
    pts, ring_id, sigmas = [(0.0, 0.0)], [0], [0.5]
    for r in range(1, N_RINGS):
        radius = 1.2 * r ** 1.4           # coarse-to-fine spacing
        sigmas.append(0.4 + 0.35 * r)
        phase = (np.pi / 6.0) * (r % 2)   # stagger alternate rings
        for i in range(6):
            a = 2 * np.pi * i / 6 + phase
            pts.append((radius * np.sin(a), radius * np.cos(a)))
            ring_id.append(r)
    pts = np.asarray(pts, np.float32)
    ring_id = np.asarray(ring_id, np.int32)

    n = pts.shape[0]
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)],
                       np.int32)
    coarse = ring_id[pairs[:, 0]] + ring_id[pairs[:, 1]]
    dist = np.linalg.norm(pts[pairs[:, 0]] - pts[pairs[:, 1]], axis=1)
    order = np.lexsort((dist, -coarse.astype(np.float64)))
    desc_pairs = pairs[order][:N_BITS]

    # opposite points on each ring (3 a ring) and ring-to-centre spokes
    opairs = []
    base = 1
    for r in range(1, N_RINGS):
        for i in range(3):
            opairs.append((base + i, base + i + 3))
        for i in range(0, 6, 2):
            opairs.append((0, base + i))
        base += 6
    opairs = np.asarray(opairs[:45], np.int32)
    return pts, ring_id, np.asarray(sigmas, np.float32), desc_pairs, opairs


def blurs(img):
    """FREAK's ring blurs of an image or a stack of images (the VO path
    blurs a stereo pair once, for the orientation and the descriptor)."""
    return ring_blurs(img, [float(s) for s in _retina()[2]])


@functools.lru_cache(maxsize=8)
def _consts(device):
    """(offsets, descriptor pairs, orientation pairs, ring columns) on
    `device`, made once per device."""
    pts, ring_id, _sigmas, desc_pairs, opairs = _retina()
    return (*on_device((pts, desc_pairs.astype(np.int64),
                        opairs.astype(np.int64)), device),
            ring_columns(ring_id, device))


def _sample(img, xy, offsets, ring_imgs, cols):
    return sample_rings(blurs(img) if ring_imgs is None else ring_imgs, xy,
                        offsets, cols)


def orientations(img, xy, valid, *, pattern_scale: float = 1.0,
                 ring_imgs=None):
    """Orientation from the 45 symmetric pairs:
    g = Σ (I(pi) − I(pj)) · (pi − pj) / ‖pi − pj‖², as atan2(gy, gx).
    `ring_imgs`: the image's `blurs`, when the caller has them."""
    pts, _dp, opairs, cols = _consts(xy.device)
    offs = pts * pattern_scale
    samples = _sample(img, xy, offs.expand(xy.shape[0], -1, -1), ring_imgs,
                      cols)
    pi, pj = opairs[:, 0], opairs[:, 1]
    dvec = offs[pi] - offs[pj]
    dn = torch.sqrt((dvec * dvec).sum(-1)).clamp(min=1e-6)
    w = (samples[:, pi] - samples[:, pj]) / dn[None]
    gy = (w * dvec[None, :, 0] / dn[None]).sum(-1)
    gx = (w * dvec[None, :, 1] / dn[None]).sum(-1)
    return torch.where(valid, torch.atan2(gy, gx), torch.zeros_like(gx))


def describe(img, xy, angle, valid, *, pattern_scale: float = 1.0,
             ring_imgs=None) -> Descriptors:
    """512-bit retinal descriptor on the rotated pattern; rows that are not
    `valid` are zero.  `ring_imgs`: as for `orientations`."""
    pts, desc_pairs, _op, cols = _consts(xy.device)
    samples = _sample(img, xy, rotate(pts * pattern_scale, angle),
                      ring_imgs, cols)
    pi, pj = desc_pairs[:, 0], desc_pairs[:, 1]
    bits = (samples[:, pi] > samples[:, pj]).to(torch.float32)
    return Descriptors(bits=bits * valid[:, None])


def describe_keypoints(img, keypoints, *, pattern_scale: float = 1.0,
                       oriented: bool = True):
    """Descriptor-only entry: (keypoints with their angle, descriptors)."""
    ring_imgs = blurs(img)
    ang = (orientations(img, keypoints.xy, keypoints.valid,
                        pattern_scale=pattern_scale, ring_imgs=ring_imgs)
           if oriented else keypoints.angle)
    desc = describe(img, keypoints.xy, ang, keypoints.valid,
                    pattern_scale=pattern_scale, ring_imgs=ring_imgs)
    return keypoints.replace(angle=ang), desc

"""BRIEF binary descriptors in plain PyTorch (frozen from the port's
`ops/brief.py`): the image is box-smoothed once (9x9), then each bit
compares two samples of a fixed Gaussian pair pattern (seed 7, PATCH 48)
at the keypoint's pixel, clamped into the image (`twins.brief_words`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from vobench.reference import image as image_ops
from vobench.reference import twins
from vobench.reference.types import Descriptors, unpack_bits

PATCH = 48            # sampling window (OpenCV BRIEF: 48+9 borders)
SMOOTH = 9            # box smoothing size


@functools.lru_cache(maxsize=None)
def _brief_pattern_np(n_bits: int, patch: int, seed: int):
    rs = np.random.RandomState(seed)
    sigma = patch / 5.0
    pts = rs.normal(0.0, sigma, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -(patch // 2 - 1),
                   patch // 2 - 1).astype(np.int32)


def brief_pattern(n_bits: int, patch: int = PATCH, seed: int = 7):
    """(n_bits, 2, 2) int32 offsets [(dxA, dyA), (dxB, dyB)], clipped."""
    return _brief_pattern_np(n_bits, patch, seed)


def smooth(img):
    return image_ops.box_blur(img.to(torch.float32), SMOOTH)


def _at_keypoints(imgs, xy, n_bytes: int, seed: int):
    packed = twins.brief_words(imgs.to(torch.float32), xy.to(torch.float32),
                               brief_pattern(8 * n_bytes, seed=seed))
    return [Descriptors(bits=unpack_bits(p), packed=p) for p in packed]


def describe_dense(img_smooth, xy, n_bytes: int = 16, *,
                   pattern_seed: int = 7) -> Descriptors:
    """BRIEF at (N, 2) keypoints of one (H, W) pre-smoothed image: the
    words of its dense bitplanes at the keypoints' pixels."""
    return _at_keypoints(img_smooth[None], xy[None], n_bytes,
                         pattern_seed)[0]


def describe_pair(sm_left, sm_right, xy_left, xy_right, n_bytes: int = 16,
                  *, pattern_seed: int = 7):
    """Stereo pair -> (desc_left, desc_right): in ONE launch where the two
    sets are of one size (every path's are), else one per image."""
    if xy_left.shape[0] != xy_right.shape[0]:
        return (describe_dense(sm_left, xy_left, n_bytes,
                               pattern_seed=pattern_seed),
                describe_dense(sm_right, xy_right, n_bytes,
                               pattern_seed=pattern_seed))
    return tuple(_at_keypoints(torch.stack([sm_left, sm_right]),
                               torch.stack([xy_left, xy_right]), n_bytes,
                               pattern_seed))


def valid_mask(xy, width: int, height: int,
               border: int = PATCH // 2 + SMOOTH):
    """Keypoints too close to the border cannot be described."""
    return ((xy[:, 0] >= border) & (xy[:, 0] < width - border)
            & (xy[:, 1] >= border) & (xy[:, 1] < height - border))

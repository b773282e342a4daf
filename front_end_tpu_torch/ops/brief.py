"""BRIEF binary descriptors (counterpart of `front_end_tpu/ops/brief.py`).

The image is box-smoothed once (9×9), then each bit compares two samples
of a fixed Gaussian pair pattern (seed 7, PATCH 48 — the JAX package's
table, generated the same way).  `describe_dense` and `describe_pair`
evaluate the pattern at the keypoints (`ops/kernels/brief_keypoints.py`,
the CUDA kernel on the card) and give exactly the words that gathering
the dense bitplanes at the keypoints gives, the border included; the
dense form is `ops/kernels/brief_planes.py` and `gather_words` reads it;
`describe` is the per-keypoint gather form in unpacked bits.  All give
the same bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from front_end_tpu_torch.ops import image as image_ops
from front_end_tpu_torch.ops.kernels import brief_keypoints
from front_end_tpu_torch.types import Descriptors, unpack_bits

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


@functools.lru_cache(maxsize=None)
def table_on(n_bits: int, seed: int, device: torch.device):
    """The keypoint kernel's sample table on `device`, made once per
    (bits, seed, device): the kernel takes it by pointer."""
    return brief_keypoints.sample_table(
        brief_pattern(n_bits, seed=seed)).to(device)


def smooth(img):
    return image_ops.box_blur(img.to(torch.float32), SMOOTH)


def describe(img_smooth, xy, n_bytes: int = 16, *, pattern_seed: int = 7
             ) -> Descriptors:
    """Per-keypoint gather form on a pre-smoothed (H, W) image."""
    pat = torch.as_tensor(brief_pattern(8 * n_bytes, seed=pattern_seed),
                          device=img_smooth.device, dtype=torch.int64)
    H, W = img_smooth.shape[-2:]
    c = torch.round(xy).to(torch.int64)
    pos = c[:, None, None, :] + pat[None]            # (N, n_bits, 2, 2)
    px = pos[..., 0].clamp(0, W - 1)
    py = pos[..., 1].clamp(0, H - 1)
    vals = img_smooth.reshape(-1)[py * W + px]       # (N, n_bits, 2)
    return Descriptors(bits=(vals[..., 0] < vals[..., 1]).to(torch.float32))


def gather_words(planes, xy) -> Descriptors:
    """(n_words, H, W) bitplanes -> descriptors at (N, 2) keypoints."""
    n_words, H, W = planes.shape
    px, py = brief_keypoints.keypoint_pixels(xy, H, W)
    words = planes.view(torch.int32).reshape(n_words, -1)[:, py * W + px]
    packed = words.T.contiguous().view(torch.uint32)
    return Descriptors(bits=unpack_bits(packed), packed=packed)


def _at_keypoints(imgs, xy, n_bytes: int, seed: int):
    packed = brief_keypoints.brief_keypoints(
        imgs.to(torch.float32), xy.to(torch.float32),
        table_on(8 * n_bytes, seed, imgs.device))
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

"""FAST corner detection, cv2-exact, in plain PyTorch (frozen from the
port's `ops/fast.py`): every pixel's segment test as elementwise ops
over static shifted views of one padded image, the quick-rejection pair
gates of the 12- and 8-point circles, and the tie-annihilating 3x3
non-max suppression.  The score is the margin (cv2 response + 1)."""
from __future__ import annotations

import torch

from vobench.reference.image import shift_views

# Circle offsets (dx, dy), y down, in OpenCV's `makeOffsets` order — the
# quick-test pairs are (k, (k+8) mod n) in THIS order.
CIRCLE_16 = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
             (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
             (-3, 1), (-2, 2), (-1, 3))
CIRCLE_12 = ((0, 2), (1, 2), (2, 1), (2, 0), (2, -1), (1, -2), (0, -2),
             (-1, -2), (-2, -1), (-2, 0), (-2, 1), (-1, 2))
CIRCLE_8 = ((0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
            (-1, 1))

# (circle, contiguous run length) per OpenCV type
TYPES = {"9_16": (CIRCLE_16, 9), "7_12": (CIRCLE_12, 7),
         "5_8": (CIRCLE_8, 5)}


def _arc_margin(d, K: int):
    """max over circular starts s of min over the K-window of d[(s+j) % n]
    (sparse-table doubling; min is idempotent, so bit-exact)."""
    w = d
    width = 1
    while width * 2 <= K:
        w = torch.minimum(w, torch.roll(w, -width, dims=0))
        width *= 2
    if width < K:
        w = torch.minimum(w, torch.roll(w, -(K - width), dims=0))
    return w.amax(0)


def _quick_margin(d):
    """min over cv2's 8 quick-test pairs (k, (k+8) mod n) of the pair max."""
    n = d.shape[0]
    m = None
    for k in range(8):
        pair = torch.maximum(d[k % n], d[(k + 8) % n])
        m = pair if m is None else torch.minimum(m, pair)
    return m


def _dark_diffs(img, circle):
    """(n, ..., H, W): p − c_i over the edge-padded image."""
    r = max(max(abs(dx), abs(dy)) for dx, dy in circle)
    view = shift_views(img, r)
    return img[None] - torch.stack([view(dy, dx) for (dx, dy) in circle])


def border_mask(H: int, W: int, device=None):
    """cv2 processes rows/cols [3, size-4] for every pattern size."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= 3) & (ys <= H - 4) & (xs >= 3) & (xs <= W - 4)


def fast_margins_plain(img, fast_type: str = "9_16"):
    """The plain dense form of `fast_margins` (the margin kernel's twin)."""
    circle, K = TYPES[fast_type]
    img = img.to(torch.float32)
    n = len(circle)
    dark = _dark_diffs(img, circle)                # p − c_i
    bright = -dark                                 # c_i − p
    run_d = _arc_margin(dark, K)
    run_b = _arc_margin(bright, K)
    score = torch.maximum(run_d, run_b)
    if n == 16:
        detect = score
    else:
        detect = torch.maximum(torch.minimum(run_d, _quick_margin(dark)),
                               torch.minimum(run_b, _quick_margin(bright)))
    interior = border_mask(*img.shape[-2:], device=img.device)
    zero = torch.zeros_like(score)
    return torch.where(interior, detect, zero), torch.where(interior, score,
                                                            zero)


def nms_cv2(score):
    """OpenCV FAST NMS: a corner survives iff its score is STRICTLY greater
    than all 8 neighbours' (ties annihilate)."""
    view = shift_views(score, 1)
    neigh_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            v = view(dy, dx)
            neigh_max = v if neigh_max is None else torch.maximum(neigh_max,
                                                                  v)
    return torch.where(score > neigh_max, score, torch.zeros_like(score))


def detect_dense_plain(img, threshold, fast_type: str = "9_16",
                       nms: bool = True):
    """The plain dense form of `detect_dense` (the detect kernel's twin)."""
    detect, score = fast_margins_plain(img, fast_type)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=detect.device)
    s = torch.where(detect > t, score, torch.zeros_like(score))
    return nms_cv2(s) if nms else s



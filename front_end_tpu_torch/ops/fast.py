"""FAST corner detection, cv2-exact (counterpart of
`front_end_tpu/ops/fast.py`).

`fast_margins` and `detect_dense` hand a float32 copy of the image to the
kernel wrappers (`ops/kernels/fast_margins.py`, `ops/kernels/fast_detect.py`).
As with every wrapper of the package, the CPU/card decision is the
wrapper's alone: a CUDA tensor of any number of leading dims launches the
kernel or raises, a CPU tensor takes the plain dense forms below
(`fast_margins_plain`, `detect_dense_plain`), which are the kernels' plain
twins: every pixel's segment test as elementwise ops over static shifted
views of one padded image.  Two OpenCV quirks are kept as
in the JAX package (see its module docstring): the quick-rejection pair
gates of `FAST_t` for the 12- and 8-point circles, and the
tie-annihilating 3×3 non-max suppression.  The per-pixel score is the
margin (cv2 response + 1), so `margin > t` reproduces the detector at any
threshold.

The plain forms are also the arithmetic of the grid kernel's plain twin
(`ops/kernels/fast_grid.py`).
"""
from __future__ import annotations

import torch

from front_end_tpu_torch.ops.image import shift_views

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


def reject_bounds(dark):
    """Upper bounds (dark class, bright class) on what each brightness
    class can contribute to `detect`, from `dark` = p − c_i stacked on dim
    0: detect <= max of the two, and a class whose bound is <= t cannot lift
    `detect` above t.  16 points: every arc of 9 holds one point of each
    antipodal pair, so the arc margin is at most min(max(d0, d8),
    max(d4, d12)), four taps; for the bright class d -> −d turns that into
    −max(min(d0, d8), min(d4, d12)).  12 and 8 points: cv2's quick margins,
    which gate `detect` already.  Exact in floats (min, max and negation
    only select or flip values).  The plain form of the CUDA kernels'
    early rejection (`csrc/fast_segment.cuh`)."""
    if dark.shape[0] == 16:
        d0, d4, d8, d12 = dark[0], dark[4], dark[8], dark[12]
        bd = torch.minimum(torch.maximum(d0, d8), torch.maximum(d4, d12))
        bb = -torch.maximum(torch.minimum(d0, d8), torch.minimum(d4, d12))
        return bd, bb
    return _quick_margin(dark), _quick_margin(-dark)


def _dark_diffs(img, circle):
    """(n, ..., H, W): p − c_i over the edge-padded image."""
    r = max(max(abs(dx), abs(dy)) for dx, dy in circle)
    view = shift_views(img, r)
    return img[None] - torch.stack([view(dy, dx) for (dx, dy) in circle])


def candidate_masks(img, threshold, fast_type: str = "9_16"):
    """(dark, bright) boolean maps of the pixels whose class bound exceeds
    the threshold; every other pixel scores exactly 0 in `detect_dense`."""
    img = img.to(torch.float32)
    bd, bb = reject_bounds(_dark_diffs(img, TYPES[fast_type][0]))
    t = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    interior = border_mask(*img.shape[-2:], device=img.device)
    return (bd > t) & interior, (bb > t) & interior


def border_mask(H: int, W: int, device=None):
    """cv2 processes rows/cols [3, size-4] for every pattern size."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= 3) & (ys <= H - 4) & (xs >= 3) & (xs <= W - 4)


def fast_margins(img, fast_type: str = "9_16"):
    """Dense FAST margins: (..., H, W) -> (detect_margin, score).

    score[p]  = max over contiguous arcs A of length K of
                max(min_{i in A}(c_i - p), min_{i in A}(p - c_i)), the pure
                segment-test margin; cv2 response = score - 1.
    detect[p] = the same, additionally gated per brightness class by cv2's
                quick-rejection pair tests; the pixel is a cv2 corner at
                threshold t iff detect[p] > t.  For 9_16 detect == score.
    Border pixels (within 3 of the edge) are 0 in both."""
    from front_end_tpu_torch.ops.kernels import fast_margins as kernel
    return kernel.fast_margins(img.to(torch.float32), fast_type)


def fast_score_map(img, fast_type: str = "9_16"):
    """Pure segment-test margin map (= cv2 FAST response + 1)."""
    return fast_margins(img, fast_type)[1]


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


def nms3x3(score):
    """3×3 NMS with a deterministic tie-break (first index wins) — NOT cv2
    semantics, kept for callers that need exactly one survivor per
    plateau.  Scores are quantized to quarters, as in the JAX package."""
    H, W = score.shape[-2:]
    q = torch.round(score.to(torch.float32) * 4.0).to(torch.int64)
    idx = (torch.arange(H, device=score.device)[:, None] * W
           + torch.arange(W, device=score.device)[None, :])
    # higher score wins; equal score -> smaller index (wrapped to 20 bits:
    # within a 3×3 window indices differ by <= W + 1)
    comp = q * (1 << 20) + ((1 << 20) - 1 - (idx & 0xFFFFF))
    view = shift_views(comp, 1)
    neigh_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                v = view(dy, dx)
                neigh_max = v if neigh_max is None else torch.maximum(
                    neigh_max, v)
    return torch.where(comp > neigh_max, score, torch.zeros_like(score))


def detect_dense(img, threshold, fast_type: str = "9_16", nms: bool = True):
    """cv2-exact FAST: the response map of surviving corners (score where
    corner, else 0); corners = map > 0.  `threshold` is a scalar or a
    per-pixel map (the adaptive grid controller's threshold image)."""
    from front_end_tpu_torch.ops.kernels import fast_detect as kernel
    return kernel.fast_detect(img.to(torch.float32), threshold, fast_type,
                              nms)


def detect_dense_plain(img, threshold, fast_type: str = "9_16",
                       nms: bool = True):
    """The plain dense form of `detect_dense` (the detect kernel's twin)."""
    detect, score = fast_margins_plain(img, fast_type)
    t = torch.as_tensor(threshold, dtype=torch.float32, device=detect.device)
    s = torch.where(detect > t, score, torch.zeros_like(score))
    return nms_cv2(s) if nms else s


def detect_dense_two_phase(img, threshold, fast_type: str = "9_16",
                           nms: bool = True):
    """`detect_dense_plain` the way the CUDA kernels evaluate it, in plain
    PyTorch (held against the one-pass form by the tests; no path calls
    it): the cheap bounds of `reject_bounds` at every pixel, the segment
    test only at the pixels a bound lets through.  For the 16-point circle
    a class whose bound is <= t has its arc margin <= t, so it is left out
    (−inf): if the other class's margin r exceeds t, max(rd, rb) = r."""
    circle, K = TYPES[fast_type]
    img = img.to(torch.float32)
    fd, fb = candidate_masks(img, threshold, fast_type)
    cand = fd | fb
    t = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    tc = torch.broadcast_to(t, img.shape)[cand]
    dark = _dark_diffs(img, circle)[:, cand]       # (n, candidates)
    rd, rb = _arc_margin(dark, K), _arc_margin(-dark, K)
    if len(circle) == 16:
        never = torch.full_like(rd, -torch.inf)
        rd = torch.where(fd[cand], rd, never)
        rb = torch.where(fb[cand], rb, never)
        detect = score = torch.maximum(rd, rb)
    else:
        score = torch.maximum(rd, rb)
        detect = torch.maximum(torch.minimum(rd, _quick_margin(dark)),
                               torch.minimum(rb, _quick_margin(-dark)))
    s = torch.zeros_like(img)
    s[cand] = torch.where(detect > tc, score, torch.zeros_like(score))
    return nms_cv2(s) if nms else s

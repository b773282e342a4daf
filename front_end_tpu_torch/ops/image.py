"""Dense image primitives (counterpart of `front_end_tpu/ops/image.py`).

Images are (..., H, W) float32 in [0, 255]; keypoints are (x=col, y=row).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def to_gray(rgb):
    """(..., H, W, 3) uint8 or float -> (..., H, W) float32, ITU-R BT.601."""
    rgb = torch.as_tensor(rgb).to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _edge_index(n: int, lo: int, hi: int, device):
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def shift_views(img, ry: int, rx: int | None = None):
    """Pad once by (ry, rx) edge pixels; `view(dy, dx)` gives
    out[y, x] = img[clamp(y+dy), clamp(x+dx)] as a slice of that buffer."""
    if rx is None:
        rx = ry
    H, W = img.shape[-2:]
    p = img.index_select(-2, _edge_index(H, ry, ry, img.device)) \
        .index_select(-1, _edge_index(W, rx, rx, img.device))

    def view(dy: int, dx: int):
        return p[..., ry + dy:ry + dy + H, rx + dx:rx + dx + W]

    return view


def _box1d(x, size: int, dim: int):
    """Sliding-window sum along `dim` with edge padding, via cumsum — the
    JAX package's exact form (`image.py:79-95`), so for integer-valued
    frames every partial sum is an exact float32 integer in any order."""
    r = size // 2
    n = x.shape[dim]
    idx = _edge_index(n, r, size - 1 - r, x.device)
    c = torch.cumsum(x.index_select(dim, idx), dim=dim)
    zshape = list(c.shape)
    zshape[dim] = 1
    c = torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device), c],
                  dim)
    return c.narrow(dim, size, n) - c.narrow(dim, 0, n)


def box_blur(img, size: int):
    """size×size mean filter (the BRIEF pre-smoothing; OpenCV uses 9×9)."""
    img = img.to(torch.float32)
    s = _box1d(_box1d(img, size, img.ndim - 1), size, img.ndim - 2)
    return s * (1.0 / (size * size))   # the scalar rounds to float32 first


def _sep_conv(img, kx, ky):
    """Separable 2-D correlation with edge padding, (..., H, W): shift and
    accumulate over pad-once views, taps added left to right (the JAX
    package's order, `image.py:52-63`)."""
    img = img.to(torch.float32)
    rx, ry = len(kx) // 2, len(ky) // 2
    vx = shift_views(img, 0, rx)
    out = None
    for i in range(len(kx)):
        term = float(kx[i]) * vx(0, i - rx)
        out = term if out is None else out + term
    vy = shift_views(out, ry, 0)
    acc = None
    for j in range(len(ky)):
        term = float(ky[j]) * vy(j - ry, 0)
        acc = term if acc is None else acc + term
    return acc


def sobel(img):
    """-> (gx, gy), OpenCV's 3×3 Sobel kernels with edge padding."""
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    return _sep_conv(img, d, s), _sep_conv(img, s, d)


def gaussian_kernel(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, sigma: float, radius: int | None = None):
    k = gaussian_kernel(sigma, radius)
    return _sep_conv(img, k, k)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of `jax.image.resize(method="linear")`
    along one axis, computed in float32 step by step as JAX does: a
    triangle kernel, widened by 1/scale when shrinking (antialias), columns
    normalised to sum 1, samples outside the input zeroed.  The sample
    positions are formed with one rounding (multiply-add), as the compiled
    JAX function forms them; the weights then agree with JAX's to one unit
    in the last place."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)              # Python floats, as in JAX
    kernel_scale = max(f32(inv_scale), f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * np.float64(f32(inv_scale))
                - 0.5).astype(f32)
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True)                # row after row, float32
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(f32).eps)),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(img, h: int, w: int):
    """(H, W) -> (h, w), the result of `jax.image.resize(img, (h, w),
    method="linear")`: antialiased when shrinking.  The per-axis weight
    matrices are JAX's; they are applied by two float32 matrix products
    (under the callers' precision pin), whose summation order is the
    library's, so the result agrees with JAX's to a few units in the last
    place, not bit for bit."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    out = img
    if h != H:
        wh = torch.as_tensor(_resize_weights_np(H, h), device=img.device)
        out = wh.T @ out
    if w != W:
        ww = torch.as_tensor(_resize_weights_np(W, w), device=img.device)
        out = out @ ww
    return out


def integral_image(img):
    """Summed-area table with a leading zero row and column: (..., H+1,
    W+1) float32; the sum over [y0, y1) × [x0, x1) is ii[y1, x1] −
    ii[y0, x1] − ii[y1, x0] + ii[y0, x0].

    The JAX package scans in float32, exact only while every partial sum
    stays below 2^24 (integer images up to 255 over about 65 k pixels); a
    KITTI frame sums to ~10^8, where each library's scan rounds in its own
    order.  The port scans in float64, exact for integer-valued images of
    any realistic size, and rounds each entry to float32 once: the card and
    the CPU give the same table, equal to the JAX package's wherever that
    one is exact."""
    ii = torch.cumsum(torch.cumsum(img.to(torch.float64), -1), -2)
    return torch.nn.functional.pad(ii.to(torch.float32), (1, 0, 1, 0))


def shift2d(img, dy: int, dx: int):
    """Static shift with edge padding: out[y, x] = img[y+dy, x+dx]."""
    return shift_views(img, abs(dy), abs(dx))(dy, dx)


def central_gradient(img):
    """(gx, gy): central differences with edge padding."""
    v = shift_views(img, 1, 1)
    return 0.5 * (v(0, 1) - v(0, -1)), 0.5 * (v(1, 0) - v(-1, 0))


def quadratic_fit(img, det_floor: float):
    """The in-plane quadratic fit at every pixel, from central differences
    with edge padding: the offsets −H⁻¹g, each clipped to [−0.5, 0.5] (a
    determinant at most `det_floor` in size divides by 1), and H's trace
    and determinant -> (offx, offy, trace, det)."""
    v = shift_views(img, 1, 1)
    dxx = v(0, 1) + v(0, -1) - 2 * img
    dyy = v(1, 0) + v(-1, 0) - 2 * img
    dxy = 0.25 * (v(1, 1) + v(-1, -1) - v(1, -1) - v(-1, 1))
    gx = 0.5 * (v(0, 1) - v(0, -1))
    gy = 0.5 * (v(1, 0) - v(-1, 0))
    det = dxx * dyy - dxy * dxy
    den = torch.where(det.abs() > det_floor, det, torch.ones_like(det))
    offx = torch.clamp(-(dyy * gx - dxy * gy) / den, -0.5, 0.5)
    offy = torch.clamp(-(dxx * gy - dxy * gx) / den, -0.5, 0.5)
    return offx, offy, dxx + dyy, det


def rotated_samples(xy, offs, ca, sa, step):
    """(N, P, 2) sample points: (P, 2) [dy, dx] offsets rotated by each
    keypoint's angle (cos ca, sin sa, (N,)) and scaled by `step` (N, 1),
    around the (N, 2) keypoints."""
    rx = (offs[None, :, 1] * ca[:, None] - offs[None, :, 0] * sa[:, None]) \
        * step
    ry = (offs[None, :, 1] * sa[:, None] + offs[None, :, 0] * ca[:, None]) \
        * step
    return torch.stack([xy[:, 0:1] + rx, xy[:, 1:2] + ry], -1)


def extract_patches(img, xy, patch: int):
    """(P, P) patches of an (H, W) image at the rounded (N, 2) keypoints
    (x, y) -> (N, P, P) float32.  A patch near the border slides inward to
    stay inside the image."""
    H, W = img.shape[-2:]
    r = patch // 2
    x0 = (torch.round(xy[:, 0]).to(torch.int64) - r).clamp(0, W - patch)
    y0 = (torch.round(xy[:, 1]).to(torch.int64) - r).clamp(0, H - patch)
    off = torch.arange(patch, device=img.device)
    rows = (y0[:, None] + off)[:, :, None]
    cols = (x0[:, None] + off)[:, None, :]
    return img.to(torch.float32)[rows, cols]


def bilinear_sample(img, xy):
    """Bilinear interpolation of an (H, W) image at (N, 2) float (x, y),
    clamped to [0, W − 1.001] × [0, H − 1.001] (the JAX package's form)."""
    H, W = img.shape[-2:]
    x = xy[:, 0].clamp(0.0, W - 1.001)
    y = xy[:, 1].clamp(0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1)
    i00 = y0 * W + x0
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + W], flat[i00 + W + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))

"""The port's dense FAST forms (`fast_margins`, `detect_dense`: on CPU
tensors the plain twins of the two CUDA kernels) against the JAX package's
Pallas kernels run in interpret mode.

Exact: only subtractions, min, max and compares touch the pixel values.
Shapes: an odd one (101 x 137, not a multiple of any tile) and one smaller
than a 32 x 32 tile (23 x 31).

Also the plain form of the CUDA kernels' early rejection: the bounds of
`reject_bounds` dominate `detect` at every pixel, and the two-phase
`detect_dense_two_phase` (bounds everywhere, segment test at the
candidates only) equals the one-pass form, and through it the JAX
package's `detect_dense`, bit for bit at any threshold.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.ops import fast as jfast
from front_end_tpu.ops.pallas import fast_kernel
from front_end_tpu_torch.ops import fast as tfast
from front_end_tpu_torch.ops import image as timage
from front_end_tpu_torch.ops.kernels import fast_detect, fast_margins
from torch_parity import image, n, t

SHAPES = [(101, 137), (23, 31)]
TYPES = ["9_16", "7_12", "5_8"]


def _img(shape, fast_type, seed=1):
    # the 8-point circle fires on per-pixel noise, the others on blocks
    return image(*shape, seed=seed, block=1 if fast_type == "5_8" else 6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fast_type", TYPES)
def test_fast_margins_equals_pallas_interpret(fast_type, shape):
    img = _img(shape, fast_type)
    d_ref, s_ref = fast_kernel.fast_margins_pallas(jnp.asarray(img),
                                                   fast_type, interpret=True)
    d, s = tfast.fast_margins(t(img), fast_type)
    np.testing.assert_array_equal(n(d), np.asarray(d_ref))
    np.testing.assert_array_equal(n(s), np.asarray(s_ref))
    assert (n(d) > 10).sum() > (20 if shape[0] > 50 else 0)
    # the wrapper on a CPU tensor is its plain twin
    dw, sw = fast_margins.fast_margins(t(img), fast_type)
    assert torch.equal(dw, d) and torch.equal(sw, s)
    assert torch.equal(tfast.fast_score_map(t(img), fast_type), s)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", ["scalar", "map"])
@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("fast_type", TYPES)
def test_detect_dense_equals_pallas_interpret(fast_type, nms, threshold,
                                              shape):
    img = _img(shape, fast_type, seed=2)
    if threshold == "scalar":
        thr = 12.0
    else:   # a per-cell threshold image like the grid controller's
        rs = np.random.RandomState(3)
        h, w = shape
        thr = np.kron(rs.uniform(5, 40, (3, 4)).astype(np.float32),
                      np.ones((h // 3 + 1, w // 4 + 1), np.float32))[:h, :w]
    ref = fast_kernel.fast_detect_pallas(
        jnp.asarray(img), thr if threshold == "scalar" else jnp.asarray(thr),
        fast_type, nms, interpret=True)
    tthr = thr if threshold == "scalar" else t(thr)
    got = tfast.detect_dense(t(img), tthr, fast_type, nms)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    if shape[0] > 50:
        assert (n(got) > 0).sum() > 5
    assert torch.equal(fast_detect.fast_detect(t(img), tthr, fast_type, nms),
                       got)


def test_batched_detect_and_shared_map_equal_singles():
    imgs = np.stack([_img((60, 70), "9_16", s) for s in (4, 5)])
    tm = torch.as_tensor(np.random.RandomState(6).uniform(
        5, 30, (60, 70)).astype(np.float32))
    got = tfast.detect_dense(t(imgs), tm, "9_16", True)
    ref = fast_kernel.fast_detect_pallas(jnp.asarray(imgs), jnp.asarray(n(tm)),
                                         "9_16", True, interpret=True)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    for b in range(2):
        assert torch.equal(got[b],
                           tfast.detect_dense(t(imgs[b]), tm, "9_16", True))


def test_four_dim_stack_equals_singles():
    """A (T, 2, H, W) stack with a map of the same shape goes through the
    same entry points as a single image, and gives each image's map."""
    imgs = np.stack([_img((40, 50), "7_12", s) for s in range(6)]).reshape(
        3, 2, 40, 50)
    tm = torch.as_tensor(np.random.RandomState(8).uniform(
        5, 30, (3, 2, 40, 50)).astype(np.float32))
    got = tfast.detect_dense(t(imgs), tm, "7_12", True)
    d, s = tfast.fast_margins(t(imgs), "7_12")
    assert got.shape == d.shape == s.shape == (3, 2, 40, 50)
    for i in range(3):
        for j in range(2):
            one = t(imgs[i, j])
            assert torch.equal(got[i, j],
                               tfast.detect_dense(one, tm[i, j], "7_12", True))
            d1, s1 = tfast.fast_margins(one, "7_12")
            assert torch.equal(d[i, j], d1) and torch.equal(s[i, j], s1)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """Device, dtype and shape checks run before any launch, so they can
    be held here; `meta` stands in for a device that is neither."""
    img = torch.zeros((8, 9), device="meta")
    for fn in (lambda x: fast_margins.fast_margins(x),
               lambda x: fast_detect.fast_detect(x, 5.0)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(img)


def _level(shape, fast_type, seed):
    """A resized pyramid level: non-integer pixel values."""
    h, w = shape
    src = t(_img((h * 6 // 5 + 1, w * 6 // 5 + 1), fast_type, seed))
    return timage.resize_linear(src, h, w)


@pytest.mark.parametrize("kind", ["integer", "level"])
@pytest.mark.parametrize("fast_type", TYPES)
def test_reject_bounds_dominate_detect(fast_type, kind):
    """detect <= max(dark bound, bright bound) at every pixel cv2 scores,
    so both bounds <= t prove a score of exactly 0; for 9_16 each class's
    arc margin stays under its own bound."""
    img = (t(_img((70, 90), fast_type, 11)) if kind == "integer"
           else _level((70, 90), fast_type, 12))
    assert kind == "integer" or bool((img != img.round()).any())
    circle, K = tfast.TYPES[fast_type]
    dark = tfast._dark_diffs(img, circle)
    bd, bb = tfast.reject_bounds(dark)
    detect, _ = tfast.fast_margins_plain(img, fast_type)
    inside = tfast.border_mask(70, 90)
    assert bool((detect <= torch.maximum(bd, bb))[inside].all())
    if fast_type == "9_16":
        assert bool((tfast._arc_margin(dark, K) <= bd).all())
        assert bool((tfast._arc_margin(-dark, K) <= bb).all())
    # the bound lets through fewer pixels than it tests
    fd, fb = tfast.candidate_masks(img, 15.0, fast_type)
    share = float((fd | fb).float().mean())
    assert float((detect > 15.0).float().mean()) <= share < 0.8


THRESHOLDS = [-np.inf, -1.0, 0.0, 1.0, 15.0, 60.0, "map"]


@pytest.mark.parametrize("threshold", THRESHOLDS, ids=str)
@pytest.mark.parametrize("fast_type", TYPES)
def test_two_phase_equals_plain_and_jax(fast_type, threshold):
    img = _img((60, 83), fast_type, seed=13)
    if threshold == "map":      # per-pixel, negative values included
        thr = np.random.RandomState(14).randint(-2, 40, (60, 83)).astype(
            np.float32)
        tthr = t(thr)
    else:
        thr = tthr = threshold
    for nms in (True, False):
        plain = tfast.detect_dense_plain(t(img), tthr, fast_type, nms)
        two = tfast.detect_dense_two_phase(t(img), tthr, fast_type, nms)
        assert torch.equal(two, plain)
        ref = jfast.detect_dense(img, thr, fast_type, nms, backend="xla")
        np.testing.assert_array_equal(n(two), n(ref))
    if threshold == -np.inf:    # every scored pixel is a candidate
        fd, fb = tfast.candidate_masks(t(img), -np.inf, fast_type)
        inside = tfast.border_mask(60, 83)
        assert bool((fd | fb)[inside].all()) and not bool((fd | fb)[
            ~inside].any())
    if threshold in (1.0, 15.0):
        assert int((plain > 0).sum()) > 5


@pytest.mark.parametrize("case", ["flat", "on_the_bound", "just_under",
                                  "level", "batch"])
@pytest.mark.parametrize("fast_type", TYPES)
def test_two_phase_special_images(fast_type, case):
    """A flat image (every difference 0); a per-pixel threshold equal to
    the larger bound at every pixel (no candidate, and the one-pass form
    agrees that nothing scores) and one float below it (every pixel a
    candidate); a resized level; a batch with a batched map."""
    img = t(_img((48, 64), fast_type, seed=15))
    thr = 5.0
    if case == "flat":
        img = torch.full((48, 64), 7.0)
        thr = 0.0
    elif case in ("on_the_bound", "just_under"):
        bd, bb = tfast.reject_bounds(tfast._dark_diffs(
            img, tfast.TYPES[fast_type][0]))
        thr = torch.maximum(bd, bb)
        if case == "just_under":
            thr = torch.nextafter(thr, torch.full_like(thr, -torch.inf))
        fd, fb = tfast.candidate_masks(img, thr, fast_type)
        inside = tfast.border_mask(48, 64)
        assert bool((fd | fb)[inside].all()) == (case == "just_under")
        assert bool((fd | fb)[inside].any()) == (case == "just_under")
    elif case == "level":
        img = _level((48, 64), fast_type, 16)
    elif case == "batch":
        img = torch.stack([img, t(_img((48, 64), fast_type, seed=17))])
        thr = torch.as_tensor(np.random.RandomState(18).uniform(
            0, 30, (2, 48, 64)).astype(np.float32))
    for nms in (True, False):
        plain = tfast.detect_dense_plain(img, thr, fast_type, nms)
        assert torch.equal(
            tfast.detect_dense_two_phase(img, thr, fast_type, nms), plain)
        if case in ("flat", "on_the_bound"):
            assert not bool(plain.any())
    for neg in (-1.0, -0.5):    # negative scores survive a negative gate
        assert torch.equal(
            tfast.detect_dense_two_phase(img, neg, fast_type, False),
            tfast.detect_dense_plain(img, neg, fast_type, False))

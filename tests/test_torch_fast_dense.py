"""The port's dense FAST forms (`fast_margins`, `detect_dense`: on CPU
tensors the plain twins of the two CUDA kernels) against the JAX package's
Pallas kernels run in interpret mode.

Exact: only subtractions, min, max and compares touch the pixel values.
Shapes: an odd one (101 x 137, not a multiple of any tile) and one smaller
than a 32 x 32 tile (23 x 31).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.ops.pallas import fast_kernel
from front_end_tpu_torch.ops import fast as tfast
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

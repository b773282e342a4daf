"""Parity of the port's SIFT (`ops/sift.py`) with the JAX package.

Stated tolerances: the Gaussian pyramid, the DoG stack, the detections
(positions, responses, scales, octaves) and the orientations are exact —
the blurs add their taps in JAX's order, every stencil is elementwise, and
the orientation histogram adds its samples in the order of JAX's CPU
scatter-add; descriptors within 5e-6 (the per-cell pooling is a matrix
product whose sums each library orders its own way; measured 2.4e-6).
"""
import numpy as np
import pytest
import torch


from front_end_tpu.ops import sift as jsift
from front_end_tpu_torch.ops import sift as tsift
from torch_parity import image, n, t

IMG = image(120, 160, seed=4)


@pytest.fixture(scope="module")
def jax_det():
    return jsift.detect(IMG, n_octaves=3, max_keypoints=256)


def test_pyramid_and_dog_equal_jax():
    got = tsift.build_pyramid(t(IMG), 3)
    ref = jsift.build_pyramid(IMG, 3)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] == \
        [(6, 120, 160), (6, 60, 80), (6, 30, 40)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), np.asarray(r))
        np.testing.assert_array_equal(n(tsift.dog_stack(g)),
                                      np.asarray(jsift.dog_stack(r)))


def test_extrema_of_one_octave_equal_jax():
    dog = jsift.dog_stack(jsift.build_pyramid(IMG, 1)[0])
    got = tsift._extrema_one_octave(t(dog), 40, 0.04 / 3)
    ref = jsift._extrema_one_octave(dog, 40, 0.04 / 3)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g[3] == r[3]
        for a, b in zip(g[:3], r[:3]):
            np.testing.assert_array_equal(n(a), np.asarray(b))
        assert (np.asarray(r[2]) > 0).sum() > 5


def test_detect_equals_jax(jax_det):
    got = tsift.detect(t(IMG), n_octaves=3, max_keypoints=256)
    k, rk = got.keypoints, jax_det.keypoints
    assert int(rk.valid.sum()) > 50
    for f in ("xy", "score", "valid"):
        np.testing.assert_array_equal(n(getattr(k, f)),
                                      np.asarray(getattr(rk, f)))
    np.testing.assert_array_equal(n(got.sigma), np.asarray(jax_det.sigma))
    np.testing.assert_array_equal(n(got.octave), np.asarray(jax_det.octave))


def test_detect_pads_a_short_pool_like_jax():
    """At 96×128 the per-layer shares undershoot the capacity (3 octaves ×
    3 layers × 113 = 1017 < 1024): invalid rows fill the rest."""
    small = image(96, 128, seed=5)
    got = tsift.detect(t(small), n_octaves=3, max_keypoints=1024)
    ref = jsift.detect(small, n_octaves=3, max_keypoints=1024)
    assert got.keypoints.capacity == 1024
    for f in ("xy", "score", "valid"):
        np.testing.assert_array_equal(n(getattr(got.keypoints, f)),
                                      np.asarray(getattr(ref.keypoints, f)))
    np.testing.assert_array_equal(n(got.sigma), np.asarray(ref.sigma))


def test_orientations_equal_jax_and_repeat(jax_det):
    k = jax_det.keypoints
    got = tsift.orientations(t(IMG), t(k.xy), t(jax_det.sigma), t(k.valid))
    ref = jsift.orientations(IMG, k.xy, jax_det.sigma, k.valid)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    again = tsift.orientations(t(IMG), t(k.xy), t(jax_det.sigma),
                               t(k.valid))
    assert torch.equal(got, again)
    assert len(np.unique(n(got)[np.asarray(k.valid)])) > 5


def test_describe_matches_jax(jax_det):
    k = jax_det.keypoints
    ang = jsift.orientations(IMG, k.xy, jax_det.sigma, k.valid)
    got = tsift.describe(t(IMG), t(k.xy), t(jax_det.sigma), t(ang))
    ref = jsift.describe(IMG, k.xy, jax_det.sigma, ang)
    assert got.norm == "l2" and got.bits.shape == (256, 128)
    np.testing.assert_allclose(n(got.bits), np.asarray(ref.bits), atol=5e-6)
    v = np.asarray(k.valid)
    b = n(got.bits)[v]
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)


def test_detect_and_describe_matches_jax():
    got_d, got = tsift.detect_and_describe(t(IMG), max_keypoints=256)
    ref_d, ref = jsift.detect_and_describe(IMG, max_keypoints=256)
    for f in ("xy", "score", "valid", "angle"):
        np.testing.assert_array_equal(n(getattr(got_d.keypoints, f)),
                                      np.asarray(getattr(ref_d.keypoints, f)))
    np.testing.assert_allclose(n(got.bits), np.asarray(ref.bits), atol=5e-6)

"""`ops/image.py` (blur, resize), `ops/orb.py` and the detection half of
`ops/brisk.py` against the JAX package, on the same numpy inputs.

What is reached, and stated per test:
- Gaussian kernel and blur, BRISK `detect` / `detect_dense`: exact (the
  same taps added in the same order; FAST is exact).
- `resize_linear` vs `jax.image.resize`: within 2e-4 absolute on [0, 255]
  images (measured 1.1e-4, up to 10 units in the last place): the weight
  matrices agree to one unit in the last place and the two float32 matrix
  products sum in each library's order.
- ORB level-0 response maps exact; pyramids with levels >= 1 may flip a
  corner where a resized pixel sits on the FAST threshold: at most 4
  differing map pixels here (measured 0, 0 and 2).
- centroid angle within 1e-5 rad (measured 2.4e-7): a float32 31x31
  correlation summed in another order; descriptor bits equal for equal
  angles, and at most 0.1 % of bits flip from the port's own angles
  (measured 0).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from front_end_tpu.ops import brief as jbrief
from front_end_tpu.ops import brisk as jbrisk
from front_end_tpu.ops import image as jimage
from front_end_tpu.ops import orb as jorb
from front_end_tpu_torch.ops import brief as tbrief
from front_end_tpu_torch.ops import brisk as tbrisk
from front_end_tpu_torch.ops import image as timage
from front_end_tpu_torch.ops import orb as torb
from torch_parity import image, kps_to_torch, n, t

IMG = image(180, 300, seed=3)
KP = ("xy", "score", "angle", "valid")


def _xy(count=200, seed=0):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(20, 280, count),
                     rs.uniform(20, 160, count)], -1).astype(np.float32)


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (0.6, None),
                                          (2.4, 5)])
def test_gaussian_kernel_and_blur_exact(sigma, radius):
    np.testing.assert_array_equal(timage.gaussian_kernel(sigma, radius),
                                  jimage.gaussian_kernel(sigma, radius))
    ref = jimage.gaussian_blur(jnp.asarray(IMG), sigma, radius)
    np.testing.assert_array_equal(
        n(timage.gaussian_blur(t(IMG), sigma, radius)), np.asarray(ref))


@pytest.mark.parametrize("hw", [(150, 250), (104, 174), (64, 64), (200, 320),
                                (180, 250)])
def test_resize_linear_close_to_jax_resize(hw):
    ref = np.asarray(jax.image.resize(jnp.asarray(IMG), hw, method="linear"))
    got = n(timage.resize_linear(t(IMG), *hw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_intensity_centroid_angle():
    xy = _xy()
    ref = np.asarray(jorb.intensity_centroid_angle(jnp.asarray(IMG),
                                                   jnp.asarray(xy)))
    got = n(torb.intensity_centroid_angle(t(IMG), t(xy)))
    diff = np.abs(np.angle(np.exp(1j * (got - ref))))
    assert diff.max() < 1e-5, diff.max()
    assert np.abs(ref).max() > 1.0        # angles spread over the circle


@pytest.mark.parametrize("wta_k", [2, 3, 4])
def test_orb_describe(wta_k):
    xy = _xy(seed=wta_k)
    sm = np.asarray(jbrief.smooth(jnp.asarray(IMG)))
    np.testing.assert_array_equal(n(tbrief.smooth(t(IMG))), sm)
    ang = np.asarray(jorb.intensity_centroid_angle(jnp.asarray(IMG),
                                                   jnp.asarray(xy)))
    ref = np.asarray(jorb.describe(jnp.asarray(sm), jnp.asarray(xy),
                                   jnp.asarray(ang), 32, wta_k=wta_k).bits)
    got = n(torb.describe(t(sm), t(xy), t(ang), 32, wta_k=wta_k).bits)
    assert got.shape == ref.shape == (200, 256 if wta_k == 2 else 128 * wta_k)
    np.testing.assert_array_equal(got, ref)       # same angles: same bits
    own = n(torb.describe(t(sm), t(xy),
                          torb.intensity_centroid_angle(t(IMG), t(xy)), 32,
                          wta_k=wta_k).bits)
    assert (own != ref).mean() <= 1e-3
    assert 0.2 < ref.mean() < 0.8 if wta_k == 2 else ref.sum(1).min() == 128


@pytest.mark.parametrize("total,levels,sf", [(1024, 4, 1.2), (2048, 2, 1.3),
                                             (100, 8, 1.1), (2048, 1, 1.2)])
def test_level_budgets(total, levels, sf):
    assert torb._level_budgets(total, levels, sf) == jorb._level_budgets(
        total, levels, sf)


@pytest.mark.parametrize("kw", [
    dict(n_levels=1, scale_factor=1.2), dict(n_levels=4, scale_factor=1.2),
    dict(n_levels=2, scale_factor=1.3), dict(n_levels=4, scale_factor=1.1)])
def test_detect_dense_pyramid(kw):
    args = dict(fast_threshold=10.0, edge_threshold=15, **kw)
    ref = np.asarray(jorb.detect_dense_pyramid(jnp.asarray(IMG), **args))
    got = n(torb.detect_dense_pyramid(t(IMG), **args))
    assert (ref > 0).sum() > 500
    differing = int(((ref > 0) != (got > 0)).sum())
    if kw["n_levels"] == 1:
        np.testing.assert_array_equal(got, ref)
    else:
        assert differing <= 4, differing
        same = (ref > 0) & (got > 0)
        np.testing.assert_allclose(got[same], ref[same], rtol=0, atol=2e-3)


@pytest.mark.parametrize("wta_k", [2, 3])
def test_detect_describe_pyramid(wta_k):
    args = dict(n_levels=4, fast_threshold=10.0, edge_threshold=15,
                max_keypoints=256, wta_k=wta_k)
    dj, qj = jorb.detect_describe_pyramid(jnp.asarray(IMG), **args)
    dt, qt = torb.detect_describe_pyramid(t(IMG), **args)
    assert int(dj.keypoints.valid.sum()) == 256
    np.testing.assert_array_equal(n(dt.keypoints.valid),
                                  np.asarray(dj.keypoints.valid))
    np.testing.assert_array_equal(n(dt.keypoints.xy),
                                  np.asarray(dj.keypoints.xy))
    np.testing.assert_array_equal(n(dt.octave), np.asarray(dj.octave))
    np.testing.assert_array_equal(n(dt.size), np.asarray(dj.size))
    assert len(np.unique(n(dt.octave))) > 1
    # scores of resized levels carry the resize's rounding
    np.testing.assert_allclose(n(dt.keypoints.score),
                               np.asarray(dj.keypoints.score), atol=2e-3)
    np.testing.assert_allclose(n(dt.keypoints.angle),
                               np.asarray(dj.keypoints.angle), atol=1e-3)
    assert (n(qt.bits) != np.asarray(qj.bits)).mean() <= 1e-3


def test_detect_describe_single_level():
    from front_end_tpu.ops import grid as jgrid
    cfg = jgrid.GridConfig(cell_capacity=32, init_threshold=12.0)
    kj = jgrid.detect(jnp.asarray(IMG), cfg.init_thresholds(), cfg).keypoints
    k2j, dj = jorb.detect_describe(jnp.asarray(IMG), kj, 32, wta_k=2)
    k2t, dt = torb.detect_describe(t(IMG), kps_to_torch(kj), 32, wta_k=2)
    assert int(kj.valid.sum()) > 100
    np.testing.assert_allclose(n(k2t.angle), np.asarray(k2j.angle),
                               atol=1e-5)
    assert (n(dt.bits) != np.asarray(dj.bits)).mean() <= 1e-3


@pytest.mark.parametrize("n_octaves", [1, 2, 4])
def test_brisk_detect_and_dense_exact(n_octaves):
    bj = jbrisk.detect(jnp.asarray(IMG), threshold=12.0,
                       n_octaves=n_octaves, max_keypoints=256)
    bt = tbrisk.detect(t(IMG), threshold=12.0, n_octaves=n_octaves,
                       max_keypoints=256)
    for f in KP:
        np.testing.assert_array_equal(n(getattr(bt.keypoints, f)),
                                      np.asarray(getattr(bj.keypoints, f)), f)
    np.testing.assert_array_equal(n(bt.octave), np.asarray(bj.octave))
    assert int(bt.keypoints.valid.sum()) > 200
    ref = jbrisk.detect_dense(jnp.asarray(IMG), threshold=12.0,
                              n_octaves=n_octaves)
    np.testing.assert_array_equal(
        n(tbrisk.detect_dense(t(IMG), threshold=12.0, n_octaves=n_octaves)),
        np.asarray(ref))


def test_brisk_detect_pads_below_capacity():
    """max_keypoints above n_octaves * per-octave share: rows are padded
    and the merge still equals JAX's."""
    bj = jbrisk.detect(jnp.asarray(IMG), threshold=12.0, n_octaves=3,
                       max_keypoints=100)
    bt = tbrisk.detect(t(IMG), threshold=12.0, n_octaves=3,
                       max_keypoints=100)
    np.testing.assert_array_equal(n(bt.keypoints.xy),
                                  np.asarray(bj.keypoints.xy))
    np.testing.assert_array_equal(n(bt.octave), np.asarray(bj.octave))

"""The descriptor modules of the VO swap set against the JAX package, on the
same numpy inputs: `ops/image.py` (bilinear sample, integral image,
shift), `ops/subpix.py`, BRISK's descriptor half, `ops/freak.py` and
`ops/surf.py`.

Tolerances, each with what it measured here:
- image helpers, SURF box sums and `hessian_layer`: exact (integer images
  below 2^24 in every partial sum, the same operations in the same order);
- `corner_subpix`: within 1e-4 px with the VO path's 0.3 px cap (3.1e-5)
  and 1e-3 px uncapped, where refinements travel up to 7 px (6.0e-4): the
  JAX iteration runs compiled (`lax.scan`), which contracts multiply-adds
  the eager port rounds apart;
- BRISK / FREAK / SURF orientations within 1e-3 rad (at most 4.8e-7: a
  float32 sum over the pattern in another order); descriptor bits at most
  0.1 % differing at the JAX angles and at the port's own (0 measured),
  bit for bit at angle 0;
- SURF detection without interpolation exact; with it, positions and sizes
  within 1e-4 (3.8e-6: a 3×3 LU solve in another order); descriptors
  within 1e-6 (1.2e-7: subregion sums and the norm in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.ops import brisk as jbrisk
from front_end_tpu.ops import freak as jfreak
from front_end_tpu.ops import image as jimage
from front_end_tpu.ops import subpix as jsubpix
from front_end_tpu.ops import surf as jsurf
from front_end_tpu_torch.ops import brisk as tbrisk
from front_end_tpu_torch.ops import freak as tfreak
from front_end_tpu_torch.ops import image as timage
from front_end_tpu_torch.ops import subpix as tsubpix
from front_end_tpu_torch.ops import surf as tsurf
from front_end_tpu_torch.types import Keypoints
from torch_parity import image, kps_to_torch, n, t

IMG = image(180, 300, seed=3)
J = jnp.asarray(IMG)


def _xy(count=300, seed=0, lo=20):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(lo, 300 - lo, count),
                     rs.uniform(lo, 180 - lo, count)], -1).astype(np.float32)


def _valid(count=300, seed=0):
    return np.random.RandomState(seed + 100).uniform(size=count) > 0.1


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


# --- image helpers -----------------------------------------------------------

def test_bilinear_sample_exact_inside_and_clamped():
    xy = _xy(400, seed=1, lo=-8)          # some outside: clamped to the edge
    ref = np.asarray(jimage.bilinear_sample(J, jnp.asarray(xy)))
    np.testing.assert_array_equal(n(timage.bilinear_sample(t(IMG), t(xy))),
                                  ref)
    assert np.ptp(ref) > 100


@pytest.mark.parametrize("shape", [(180, 300), (2, 37, 41)])
def test_integral_image_exact(shape):
    img = np.random.RandomState(2).randint(0, 256, shape).astype(np.float32)
    ref = np.asarray(jimage.integral_image(jnp.asarray(img)))
    got = n(timage.integral_image(t(img)))
    assert got.shape == ref.shape == shape[:-2] + (shape[-2] + 1,
                                                   shape[-1] + 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -3), (-1, 0), (0, 5),
                                   (-4, -4)])
def test_shift2d_exact(dy, dx):
    np.testing.assert_array_equal(n(timage.shift2d(t(IMG), dy, dx)),
                                  np.asarray(jimage.shift2d(J, dy, dx)))


# --- sub-pixel refinement ----------------------------------------------------

@pytest.mark.parametrize("max_shift,tol", [(0.3, 1e-4), (None, 1e-3)])
def test_corner_subpix(max_shift, tol):
    xy, valid = _xy(), _valid()
    ref = np.asarray(jsubpix.corner_subpix(J, jnp.asarray(xy),
                                           jnp.asarray(valid),
                                           max_shift=max_shift))
    got = n(tsubpix.corner_subpix(t(IMG), t(xy), t(valid),
                                  max_shift=max_shift))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_array_equal(got[~valid], xy[~valid])
    moved = np.linalg.norm(ref - xy, axis=-1)
    assert (moved > 0.05).mean() > 0.5             # not vacuous
    if max_shift is not None:
        assert moved.max() <= max_shift + 1e-5


def test_corner_subpix_without_a_mask():
    xy = _xy(50, seed=4)
    np.testing.assert_allclose(
        n(tsubpix.corner_subpix(t(IMG), t(xy), max_shift=0.3)),
        np.asarray(jsubpix.corner_subpix(J, jnp.asarray(xy), max_shift=0.3)),
        rtol=0, atol=1e-4)


# --- BRISK and FREAK ---------------------------------------------------------

def test_patterns_equal_the_jax_packages():
    for a, b in zip(tbrisk._pattern(), jbrisk._pattern()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfreak._retina(), jfreak._retina()):
        np.testing.assert_array_equal(a, b)
    assert tbrisk._pattern()[2].shape == (512, 2)
    assert tfreak._retina()[3].shape == (512, 2)


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("jmod,tmod", [(jbrisk, tbrisk), (jfreak, tfreak)],
                         ids=["brisk", "freak"])
def test_orientations_and_describe(jmod, tmod, scale):
    xy, valid = _xy(seed=5), _valid(seed=5)
    ref_ang = np.asarray(jmod.orientations(J, jnp.asarray(xy),
                                           jnp.asarray(valid),
                                           pattern_scale=scale))
    ang = n(tmod.orientations(t(IMG), t(xy), t(valid), pattern_scale=scale))
    assert _angle_diff(ang, ref_ang).max() < 1e-3
    assert np.all(ang[~valid] == 0) and np.ptp(ref_ang) > 4.0
    for a_ref, a_got in ((ref_ang, ref_ang), (ref_ang, ang)):
        ref = np.asarray(jmod.describe(J, jnp.asarray(xy), jnp.asarray(a_ref),
                                       jnp.asarray(valid),
                                       pattern_scale=scale).bits)
        got = n(tmod.describe(t(IMG), t(xy), t(a_got), t(valid),
                              pattern_scale=scale).bits)
        assert got.shape == ref.shape == (300, 512)
        assert (got != ref).mean() <= 1e-3
        assert 0.3 < ref[valid].mean() < 0.7 and not got[~valid].any()
    zero = np.zeros(300, np.float32)
    np.testing.assert_array_equal(
        n(tmod.describe(t(IMG), t(xy), t(zero), t(valid),
                        pattern_scale=scale).bits),
        np.asarray(jmod.describe(J, jnp.asarray(xy), jnp.asarray(zero),
                                 jnp.asarray(valid),
                                 pattern_scale=scale).bits))


def test_brisk_detect_and_describe_scales_the_pattern_by_octave():
    dj, qj = jbrisk.detect_and_describe(J, threshold=12.0, n_octaves=3,
                                        max_keypoints=192)
    dt, qt = tbrisk.detect_and_describe(t(IMG), threshold=12.0, n_octaves=3,
                                        max_keypoints=192)
    np.testing.assert_array_equal(n(dt.keypoints.xy),
                                  np.asarray(dj.keypoints.xy))
    np.testing.assert_array_equal(n(dt.octave), np.asarray(dj.octave))
    assert len(np.unique(n(dt.octave))) > 1
    assert _angle_diff(n(dt.keypoints.angle),
                       np.asarray(dj.keypoints.angle)).max() < 1e-3
    assert (n(qt.bits) != np.asarray(qj.bits)).mean() <= 1e-3


@pytest.mark.parametrize("oriented", [True, False])
def test_freak_describe_keypoints(oriented):
    from front_end_tpu.types import Keypoints as JKeypoints
    xy = _xy(120, seed=6, lo=35)
    rs = np.random.RandomState(7)
    kj = JKeypoints(xy=jnp.asarray(xy), score=jnp.ones(120),
                    angle=jnp.asarray(rs.uniform(-3, 3, 120), jnp.float32),
                    valid=jnp.asarray(rs.uniform(size=120) > 0.2))
    kj2, qj = jfreak.describe_keypoints(J, kj, oriented=oriented)
    kt2, qt = tfreak.describe_keypoints(t(IMG), kps_to_torch(kj),
                                        oriented=oriented)
    assert _angle_diff(n(kt2.angle), np.asarray(kj2.angle)).max() < 1e-3
    assert (n(qt.bits) != np.asarray(qj.bits)).mean() <= 1e-3


# --- SURF --------------------------------------------------------------------

II_J = jimage.integral_image(J)
II_T = timage.integral_image(t(IMG))


@pytest.mark.parametrize("box", [(-2, -1, 3, 2), (0, -5, 4, 5), (-9, 1, 0, 7)])
def test_surf_box_exact(box):
    r = max(map(abs, box))
    np.testing.assert_array_equal(n(tsurf._boxes(II_T, r)(*box)),
                                  np.asarray(jsurf._box(II_J, *box)))


@pytest.mark.parametrize("size", [9, 15, 21, 27, 39, 51, 75, 99])
def test_surf_hessian_layer_exact(size):
    dj, tj = jsurf.hessian_layer(II_J, size)
    dt, tt = tsurf.hessian_layer(II_T, size)
    np.testing.assert_array_equal(n(dt), np.asarray(dj))
    np.testing.assert_array_equal(n(tt), np.asarray(tj))


@pytest.mark.parametrize("subpix", [False, True])
def test_surf_detect(subpix):
    args = dict(hessian_threshold=50.0, n_octaves=2, n_octave_layers=2,
                max_keypoints=512, subpix=subpix)
    dj = jsurf.detect(J, **args)
    dt = tsurf.detect(t(IMG), **args)
    tol = 1e-4 if subpix else 0.0
    np.testing.assert_array_equal(n(dt.keypoints.valid),
                                  np.asarray(dj.keypoints.valid))
    np.testing.assert_allclose(n(dt.keypoints.xy),
                               np.asarray(dj.keypoints.xy), rtol=0, atol=tol)
    np.testing.assert_allclose(n(dt.size), np.asarray(dj.size), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(n(dt.keypoints.score),
                                  np.asarray(dj.keypoints.score))
    np.testing.assert_array_equal(n(dt.laplacian), np.asarray(dj.laplacian))
    assert int(dj.keypoints.valid.sum()) > 300


def test_surf_detect_pads_a_capacity_the_layers_do_not_fill():
    """3 layers an octave over 2 octaves share 1024 as 6 × 170 = 1020
    candidates: the JAX `lax.top_k` refuses k = 1024, the port pads 4
    invalid rows; its first 1020 rows are the JAX detection at 1020."""
    args = dict(hessian_threshold=1e-6, n_octaves=2, n_octave_layers=3,
                subpix=False)
    with pytest.raises(ValueError):
        jsurf.detect(J, max_keypoints=1024, **args)
    dj = jsurf.detect(J, max_keypoints=1020, **args)
    dt = tsurf.detect(t(IMG), max_keypoints=1024, **args)
    for f in ("xy", "score", "valid"):
        np.testing.assert_array_equal(n(getattr(dt.keypoints, f))[:1020],
                                      np.asarray(getattr(dj.keypoints, f)))
    assert not n(dt.keypoints.valid)[1020:].any()
    ref = np.zeros(IMG.shape, np.float32)
    kj = dj.keypoints
    yy = np.asarray(kj.xy[:, 1]).astype(int)
    xx = np.asarray(kj.xy[:, 0]).astype(int)
    np.maximum.at(ref, (yy, xx), np.where(np.asarray(kj.valid),
                                          np.asarray(kj.score), 0.0))
    np.testing.assert_array_equal(
        n(tsurf.detect_dense(t(IMG), hessian_threshold=1e-6, n_octaves=2,
                             n_octave_layers=3)), ref)


@pytest.mark.parametrize("no,nl", [(2, 2), (2, 4), (4, 2)])
def test_surf_detect_dense_exact(no, nl):
    ref = np.asarray(jsurf.detect_dense(J, hessian_threshold=1e-6,
                                        n_octaves=no, n_octave_layers=nl))
    got = n(tsurf.detect_dense(t(IMG), hessian_threshold=1e-6,
                               n_octaves=no, n_octave_layers=nl))
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 300


@pytest.fixture(scope="module")
def surf_kps():
    dj = jsurf.detect(J, hessian_threshold=50.0, n_octaves=2,
                      max_keypoints=256)
    ang = np.asarray(jsurf.orientations(II_J, dj.keypoints.xy, dj.size,
                                        dj.keypoints.valid))
    return dj, ang


def test_surf_orientations(surf_kps):
    dj, ref = surf_kps
    k = dj.keypoints
    got = n(tsurf.orientations(II_T, t(k.xy), t(dj.size), t(k.valid)))
    assert _angle_diff(got, ref).max() < 1e-3
    assert np.ptp(ref) > 4.0 and int(k.valid.sum()) > 200


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("upright", [False, True])
@pytest.mark.parametrize("sized", [False, True])
def test_surf_describe(surf_kps, extended, upright, sized):
    dj, ang = surf_kps
    xy = dj.keypoints.xy
    kw = dict(size=dj.size, angle=jnp.asarray(ang)) if sized else {}
    kwt = dict(size=t(dj.size), angle=t(ang)) if sized else {}
    ref = np.asarray(jsurf.describe(J, xy, extended=extended,
                                    upright=upright, **kw).bits)
    d = tsurf.describe(t(IMG), t(xy), extended=extended, upright=upright,
                       **kwt)
    assert d.norm == "l2" and d.packed is None
    got = n(d.bits)
    assert got.shape == ref.shape == (256, 128 if extended else 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_surf_detect_and_describe():
    args = dict(hessian_threshold=50.0, n_octaves=2, n_octave_layers=2,
                max_keypoints=256)
    dj, qj = jsurf.detect_and_describe(J, **args)
    dt, qt = tsurf.detect_and_describe(t(IMG), **args)
    v = np.asarray(dj.keypoints.valid)
    np.testing.assert_array_equal(n(dt.keypoints.valid), v)
    assert _angle_diff(n(dt.keypoints.angle)[v],
                       np.asarray(dj.keypoints.angle)[v]).max() < 1e-3
    np.testing.assert_allclose(n(qt.bits)[v], np.asarray(qj.bits)[v],
                               rtol=0, atol=1e-5)


def test_keypoints_type_carries_through_freak():
    kps = Keypoints.empty(4)
    kt, d = tfreak.describe_keypoints(t(IMG), kps.replace(
        xy=torch.tensor([[50.0, 50.0]] * 4)))
    assert d.bits.shape == (4, 512) and not d.bits.any()


def test_integral_image_is_exact_beyond_a_float32_scan():
    """A KITTI-sized integer frame sums to ~10^8, past 2^24, where float32
    scans round in each library's order; the port's table is the exact
    sum rounded once to float32 (so the card's and the CPU's are equal),
    and differs from the JAX package's float32 scan by its roundings."""
    img = np.random.RandomState(9).randint(0, 256, (376, 1241)) \
        .astype(np.float32)
    exact = np.pad(np.cumsum(np.cumsum(img.astype(np.float64), -1), -2),
                   ((1, 0), (1, 0))).astype(np.float32)
    got = n(timage.integral_image(t(img)))
    np.testing.assert_array_equal(got, exact)
    assert exact[-1, -1] > 2 ** 24
    ref = np.asarray(jimage.integral_image(jnp.asarray(img)))
    np.testing.assert_allclose(ref, exact, rtol=1e-6)

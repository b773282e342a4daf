"""L2 matching of float (SURF) descriptors against the JAX package:
`l2sq_matrix` and the dense `norm="l2"` branch of the three recipes (live
stereo crossCheck with epipolar and disparity gates, StereoCamera kNN +
Lowe + uniqueness, the inter-frame ROI recipe).

Both packages form ‖a‖² + ‖b‖² − 2a·b from one float32 matrix product, and
the two libraries' products sum in different orders, so:
- `l2sq_matrix` agrees within 2e-6 absolute on unit-norm descriptors
  (measured up to 1.2e-6);
- the match sets are held to a stated tolerance, not to equality: at most
  1 % of queries may differ in validity, and the queries both accept have
  the same train index on at least 99 % of them (a near-tie of two
  distances, or a Lowe ratio on its threshold, can flip; measured: equal
  sets on every case here), distances within 2e-3: the square root of the
  squared distance's 2e-6, reached where a true match's squared distance
  is a cancellation residue near 0 (measured 9.1e-4).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu import types as jtypes
from front_end_tpu.ops import grid as jgrid
from front_end_tpu.ops import match as jmatch
from front_end_tpu.ops import surf as jsurf
from front_end_tpu_torch import types as ttypes
from front_end_tpu_torch.ops import match as tmatch
from torch_parity import image, kps_to_torch, n, t

SHARE = 0.01        # queries whose validity may differ
SAME_IDX = 0.99     # agreeing train indices among queries both accept


@pytest.fixture(scope="module")
def features():
    """SURF descriptors (64 and 128) at grid-FAST keypoints of a frame and
    of the frame shifted 6 px (stereo) / moved 3 px down (next frame)."""
    left = image(150, 260, seed=11)
    shifted = {"stereo": np.roll(left, -6, axis=1),
               "next": np.roll(left, 3, axis=0)}
    cfg = jgrid.GridConfig(cell_capacity=48, init_threshold=12.0)
    out = {}
    for name, img in [("left", left)] + list(shifted.items()):
        k = jgrid.detect(jnp.asarray(img), cfg.init_thresholds(),
                         cfg).keypoints
        out[name] = (k, {ext: np.asarray(jsurf.describe(
            jnp.asarray(img), k.xy, extended=ext).bits)
            for ext in (False, True)})
    return out


def _pair(features, other, ext):
    (kq, dq), (kt, dt) = features["left"], features[other]
    jq = (kq, jtypes.Descriptors(bits=jnp.asarray(dq[ext])))
    jt = (kt, jtypes.Descriptors(bits=jnp.asarray(dt[ext])))
    tq = (kps_to_torch(kq), ttypes.Descriptors(t(dq[ext]), norm="l2"))
    tt = (kps_to_torch(kt), ttypes.Descriptors(t(dt[ext]), norm="l2"))
    return jq, jt, tq, tt


def _hold(got, ref, min_valid):
    gv, rv = n(got.valid), n(ref.valid)
    assert rv.sum() >= min_valid, "vacuous comparison"
    assert (gv != rv).mean() <= SHARE
    both = gv & rv
    same = n(got.train_idx)[both] == n(ref.train_idx)[both]
    assert same.mean() >= SAME_IDX
    np.testing.assert_allclose(n(got.distance)[both][same],
                               n(ref.distance)[both][same], rtol=0,
                               atol=2e-3)
    return int((gv != rv).sum()), int((~same).sum())


@pytest.mark.parametrize("ext", [False, True])
def test_l2sq_matrix(features, ext):
    a = features["left"][1][ext]
    b = features["stereo"][1][ext]
    ref = np.asarray(jmatch.l2sq_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = n(tmatch.l2sq_matrix(t(a), t(b)))
    assert got.shape == ref.shape == (a.shape[0], b.shape[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert got.min() >= 0.0 and ref.max() > 1.0


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("max_disparity", [None, 40.0])
def test_stereo_match_live_l2(features, ext, max_disparity):
    (jkq, jdq), (jkt, jdt), (tkq, tdq), (tkt, tdt) = _pair(features,
                                                           "stereo", ext)
    ref = jmatch.stereo_match_live(jkq, jdq, jkt, jdt, epi_threshold=0.7,
                                   max_disparity=max_disparity,
                                   backend="xla", norm="l2")
    got = tmatch.stereo_match_live(tkq, tdq, tkt, tdt, epi_threshold=0.7,
                                   max_disparity=max_disparity, norm="l2")
    _hold(got, ref, min_valid=100)


@pytest.mark.parametrize("ext", [False, True])
def test_stereo_match_knn_l2(features, ext):
    (jkq, jdq), (jkt, jdt), (tkq, tdq), (tkt, tdt) = _pair(features,
                                                           "stereo", ext)
    ref = jmatch.stereo_match_knn(jkq, jdq, jkt, jdt, norm="l2",
                                  backend="xla")
    got = tmatch.stereo_match_knn(tkq, tdq, tkt, tdt, norm="l2")
    _hold(got, ref, min_valid=100)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("box", [100.0, 6.0])
def test_interframe_match_l2(features, ext, box):
    (jkq, jdq), (jkt, jdt), (tkq, tdq), (tkt, tdt) = _pair(features,
                                                           "next", ext)
    ref = jmatch.interframe_match(jkq, jdq, jkt, jdt, box=box,
                                  backend="xla", norm="l2")
    got = tmatch.interframe_match(tkq, tdq, tkt, tdt, box=box, norm="l2")
    _hold(got, ref, min_valid=100)


def test_l2_matching_never_packs():
    """The float branch reads `bits` only: descriptors whose `words()`
    raises still match, and Hamming descriptors keep the kernel path."""
    rs = np.random.RandomState(3)
    f = rs.normal(size=(20, 64)).astype(np.float32)
    k = ttypes.Keypoints(xy=t(rs.uniform(0, 50, (20, 2)).astype(np.float32)),
                         score=torch.ones(20), angle=torch.zeros(20),
                         valid=torch.ones(20, dtype=torch.bool))
    d = ttypes.Descriptors(t(f), norm="l2")
    with pytest.raises(TypeError):
        d.words()
    m = tmatch.interframe_match(k, d, k, d, box=100.0, norm="l2")
    assert bool(m.valid.all())
    assert torch.equal(m.train_idx, torch.arange(20))

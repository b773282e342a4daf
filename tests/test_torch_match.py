"""Parity of the port's matching with the JAX package: the match kernel's
plain twin against the Pallas kernel in interpret mode (all five
reductions, every gate mode), the three recipes against the JAX XLA
matrix path, the matrix helpers, and the twin of the kernel's merge of
per-block partials against the reductions over the whole sets."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu import types as jtypes
from front_end_tpu.ops import match as jmatch
from front_end_tpu.ops.pallas import match_kernel
from front_end_tpu_torch import types as ttypes
from front_end_tpu_torch.ops import match as tmatch
from front_end_tpu_torch.ops.kernels import match_reduce
from torch_parity import assert_matches_equal, n, t


def _pair(nq=192, nt=256, D=256, seed=0, flip=0.04, w=600.0, h=200.0):
    """Train set = shuffled queries with bit noise and offset keypoints,
    so real mutual/Lowe matches exist (the JAX kernel tests' generator)."""
    rs = np.random.RandomState(seed)
    bq = (rs.uniform(size=(nq, D)) > 0.5).astype(np.float32)
    perm = rs.permutation(nt) % nq
    bt = np.abs(bq[perm] - (rs.uniform(size=(nt, D)) < flip))
    bt = bt.astype(np.float32)
    xyq = np.stack([rs.uniform(50, w - 50, nq),
                    rs.uniform(20, h - 20, nq)], -1).astype(np.float32)
    xyt = xyq[perm] + rs.normal(0, 5, (nt, 2)).astype(np.float32)
    vq = rs.uniform(size=nq) > 0.1
    vt = rs.uniform(size=nt) > 0.1
    return bq, bt, xyq, xyt, vq, vt


def _kps(xy, v, lib):
    if lib is jtypes:
        return jtypes.Keypoints(xy=jnp.asarray(xy),
                                score=jnp.ones(len(xy)),
                                angle=jnp.zeros(len(xy)),
                                valid=jnp.asarray(v))
    return ttypes.Keypoints(xy=t(xy), score=torch.ones(len(xy)),
                            angle=torch.zeros(len(xy)), valid=t(v))


def _both(seed=0, **kw):
    bq, bt, xyq, xyt, vq, vt = _pair(seed=seed, **kw)
    jq = (_kps(xyq, vq, jtypes), jtypes.Descriptors(bits=jnp.asarray(bq)))
    jt = (_kps(xyt, vt, jtypes), jtypes.Descriptors(bits=jnp.asarray(bt)))
    tq = (_kps(xyq, vq, ttypes), ttypes.Descriptors(bits=t(bq)))
    tt = (_kps(xyt, vt, ttypes), ttypes.Descriptors(bits=t(bt)))
    return jq, jt, tq, tt


@pytest.mark.parametrize("mode,p", [
    ("stereo", dict(p1=15.0, p2=0.0, p3=300.0)),
    ("epi", dict(p1=15.0)), ("roi", dict(p1=40.0)), ("none", {}),
    ("roi", dict(p1=0.5))])
@pytest.mark.parametrize("D", [128, 256])
def test_kernel_plain_matches_pallas_interpret(mode, p, D):
    """d1, d2, i1, col_min, col_arg all equal, gated rows and columns
    included (the tight ROI leaves most rows and columns fully gated)."""
    bq, bt, xyq, xyt, vq, vt = _pair(seed=1, D=D)
    ref = match_kernel.match_reduce_pallas(
        bq, bt, xyq, xyt, vq, vt, mode=mode, tile_j=128, interpret=True,
        **p)
    got = match_reduce.match_reduce(
        ttypes.pack_bits(t(bq)), ttypes.pack_bits(t(bt)), t(xyq), t(xyt),
        t(vq), t(vt), mode=mode, **p)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), n(r))


@pytest.mark.parametrize("recipe,kw", [
    ("live", dict(epi_threshold=15.0, max_disparity=300.0)),
    ("live", dict(epi_threshold=15.0)),
    ("knn", dict(epi_threshold=15.0)),
    ("knn", dict(epi_threshold=15.0, ratio=0.7)),
    ("interframe", dict(box=40.0)),
    ("interframe", dict(box=100.0, ratio=0.9)),
])
def test_recipes_match_jax(recipe, kw):
    (jkq, jdq), (jkt, jdt), (tkq, tdq), (tkt, tdt) = _both(seed=3)
    fn = {"live": "stereo_match_live", "knn": "stereo_match_knn",
          "interframe": "interframe_match"}[recipe]
    got = getattr(tmatch, fn)(tkq, tdq, tkt, tdt, **kw)
    ref = getattr(jmatch, fn)(jkq, jdq, jkt, jdt, backend="xla", **kw)
    assert_matches_equal(got, ref, min_valid=20)


def test_recipes_take_packed_words_when_bits_are_absent():
    (_, _), (_, _), (tkq, tdq), (tkt, tdt) = _both(seed=4)
    packed = [ttypes.Descriptors(bits=None, packed=d.words())
              for d in (tdq, tdt)]
    a = tmatch.interframe_match(tkq, tdq, tkt, tdt, box=60.0)
    b = tmatch.interframe_match(tkq, packed[0], tkt, packed[1], box=60.0)
    assert_matches_equal(a, b, min_valid=20)


def test_matrix_helpers_match_jax():
    (jkq, jdq), (jkt, jdt), (tkq, tdq), (tkt, tdt) = _both(seed=5)
    dist_t = (tmatch.hamming_matrix(tdq, tdt)
              + tmatch.validity_mask(tkq.valid, tkt.valid)
              + tmatch.epipolar_mask(tkq, tkt, 15.0)
              + tmatch.disparity_mask(tkq, tkt, 300.0))
    dist_j = (jmatch.hamming_matrix(jdq, jdt)
              + jmatch.validity_mask(jkq.valid, jkt.valid)
              + jmatch.epipolar_mask(jkq, jkt, 15.0)
              + jmatch.disparity_mask(jkq, jkt, 300.0))
    np.testing.assert_array_equal(n(dist_t), n(dist_j))
    assert_matches_equal(tmatch.mutual_match(dist_t),
                         jmatch.mutual_match(dist_j), min_valid=20)
    roi_t = tmatch.hamming_matrix(tdq, tdt) + tmatch.roi_mask(tkq, tkt, 50.)
    roi_j = jmatch.hamming_matrix(jdq, jdt) + jmatch.roi_mask(jkq, jkt, 50.)
    np.testing.assert_array_equal(n(roi_t), n(roi_j))
    assert_matches_equal(tmatch.knn_lowe(roi_t), jmatch.knn_lowe(roi_j),
                         min_valid=20)


def test_unique_per_train_matches_jax():
    rs = np.random.RandomState(6)
    ti = rs.randint(0, 12, 40)
    d = rs.randint(0, 5, 40).astype(np.float32)
    v = rs.uniform(size=40) > 0.2
    got = tmatch.unique_per_train(
        ttypes.Matches(train_idx=t(ti).long(), distance=t(d), valid=t(v)),
        12)
    ref = jmatch.unique_per_train(
        jtypes.Matches(train_idx=jnp.asarray(ti, jnp.int32),
                       distance=jnp.asarray(d), valid=jnp.asarray(v)), 12)
    np.testing.assert_array_equal(n(got.valid), n(ref.valid))


def test_float_norm_is_a_later_item():
    (_, _), (_, _), (tkq, tdq), (tkt, tdt) = _both(seed=7)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tmatch.stereo_match_live(tkq, tdq, tkt, tdt, norm="l2")


def _split_starts(total, parts):
    """Uneven cuts: the last piece is the short one (or a single row)."""
    step = -(-total // parts)
    return list(range(0, total, step))


def _case(kind, nq=45, nt=101, D=128):
    """Packed inputs for `plain`: random, with duplicate descriptors
    (ties in rows and columns), or with fully gated rows and columns."""
    bq, bt, xyq, xyt, vq, vt = _pair(nq=nq, nt=nt, D=D, seed=8, w=300.0,
                                     h=120.0)
    if kind == "ties":
        bt[nt // 2:] = bt[: nt - nt // 2]          # every train twice
        xyt[nt // 2:] = xyt[: nt - nt // 2]
        bq[1::3] = bq[0]                            # equal queries
        xyq[1::3] = xyq[0]
    elif kind == "gated":
        vq[:7] = False
        vt[30:64] = False                           # a whole split and more
        xyq[20:25] = 1e4                            # outside every box
    return (ttypes.pack_bits(t(bq)), ttypes.pack_bits(t(bt)), t(xyq), t(xyt),
            t(vq), t(vt))


@pytest.mark.parametrize("mode,p", [("roi", dict(p1=60.0)), ("none", {})])
@pytest.mark.parametrize("kind", ["random", "ties", "gated"])
@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_merged_partials_equal_the_whole(splits, tiles, kind, mode, p):
    """`plain` on every (query tile, train split) block, merged as the
    kernel's second step merges them, is `plain` on the whole sets: first
    index among equal distances, d2 == d1 for equal bests, BIG and index 0
    for all-gated rows and columns."""
    q, tr, xyq, xyt, vq, vt = _case(kind)
    nq, nt = q.shape[0], tr.shape[0]
    assert nt % splits or splits == 1
    rows, cols = _split_starts(nq, tiles), _split_starts(nt, splits)
    blocks = [[match_reduce.plain(
        q[r0:r1], tr[c0:c1], xyq[r0:r1], xyt[c0:c1], vq[r0:r1], vt[c0:c1],
        mode, **p) for c0, c1 in zip(cols, cols[1:] + [nt])]
        for r0, r1 in zip(rows, rows[1:] + [nq])]
    got = match_reduce.merge_partials(blocks, rows, cols)
    ref = match_reduce.plain(q, tr, xyq, xyt, vq, vt, mode, **p)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(n(g), n(r))
    if kind == "gated" and mode == "roi":
        assert (ref[0][:7] == match_reduce.BIG).all() and not ref[2][:7].any()
        assert (ref[3][30:64] == match_reduce.BIG).all()
    if kind == "ties":
        assert (ref[0] == ref[1]).sum() > nq // 3


@pytest.mark.parametrize("nq,nt", [(2304, 2304), (2304, 4608), (1, 4608),
                                   (4608, 1), (17, 1000), (1, 1),
                                   (129, 4194303)])
def test_plan_covers_every_column_in_whole_tiles(nq, nt):
    tiles, cols, splits = match_reduce.plan(nq, nt, 132)
    assert tiles == -(-nq // match_reduce.QUERIES_PER_BLOCK)
    assert cols % 8 == 0 and cols >= match_reduce.MIN_SPLIT
    assert (splits - 1) * cols < nt <= splits * cols
    if nq == 2304:      # the paths' shapes: about four blocks on each SM
        assert 0.9 * 132 * 4 <= tiles * splits <= 132 * 4


def test_cpu_tensors_take_the_twin():
    args = _case("random")
    a = match_reduce.match_reduce(*args, mode="roi", p1=60.0)
    b = match_reduce.plain(*args, "roi", p1=60.0)
    before = match_reduce.launches
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(x), n(y))
    assert match_reduce.launches == before

"""Parity of the port's FAST and adaptive-grid detector with the JAX
package, bit for bit: margins, NMS, the grid kernel's plain twin (against
the Pallas kernel in interpret mode), two-stage top-k tie order, the
threshold controller, and whole `detect_pair` keypoint sets at even and
odd cell dims for every circle type."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.ops import fast as jfast
from front_end_tpu.ops import grid as jgrid
from front_end_tpu.ops.pallas import fast_kernel
from front_end_tpu_torch.ops import fast as tfast
from front_end_tpu_torch.ops import grid as tgrid
from front_end_tpu_torch.ops.kernels import fast_grid
from torch_parity import image, n, t

TYPES = ["9_16", "7_12", "5_8"]


def _image(fast_type, *shape, seed):
    return image(*shape, seed=seed, block=1 if fast_type == "5_8" else 6)


@pytest.mark.parametrize("fast_type", TYPES)
def test_margins_bit_identical(fast_type):
    img = _image(fast_type, 180, 300, seed=1)
    d_t, s_t = tfast.fast_margins(t(img), fast_type)
    d_j, s_j = jfast.fast_margins(img, fast_type, backend="xla")
    np.testing.assert_array_equal(n(d_t), n(d_j))
    np.testing.assert_array_equal(n(s_t), n(s_j))


@pytest.mark.parametrize("fast_type", TYPES)
@pytest.mark.parametrize("nms", [True, False])
def test_detect_dense_bit_identical(fast_type, nms):
    img = _image(fast_type, 180, 300, seed=2)
    rs = np.random.RandomState(3)
    tm = np.kron(rs.uniform(5, 40, (3, 5)), np.ones((60, 60)))[:180, :300]
    tm = tm.astype(np.float32)
    got = tfast.detect_dense(t(img), t(tm), fast_type, nms)
    ref = jfast.detect_dense(img, tm, fast_type, nms, backend="xla")
    np.testing.assert_array_equal(n(got), n(ref))
    assert (n(got) > 0).sum() > 50


def test_nms3x3_matches_jax():
    """The first-index tie-break NMS, on a map full of plateaus."""
    rs = np.random.RandomState(4)
    score = (rs.randint(0, 4, (60, 90)) * rs.uniform(size=(60, 90)) > 0.5)
    score = (score * rs.randint(1, 5, (60, 90))).astype(np.float32)
    np.testing.assert_array_equal(n(tfast.nms3x3(t(score))),
                                  n(jfast.nms3x3(score)))


def _cfg(**kw):
    base = dict(grid_rows=2, grid_cols=3, cell_capacity=64, set_point=300,
                init_threshold=10.0)
    base.update(kw)
    return tgrid.GridConfig(**base), jgrid.GridConfig(**base)


@pytest.mark.parametrize("fast_type", TYPES)
def test_kernel_plain_matches_pallas_interpret(fast_type):
    """The grid kernel's plain twin against the TPU kernel at even cell
    dims, where per-cell and global-grid pooling coincide: pooled scores,
    sub-position codes and counts, exactly."""
    imgs = np.stack([_image(fast_type, 192, 252, seed=s) for s in (5, 6)])
    tc, jc = _cfg(fast_type=fast_type)
    H, W = imgs.shape[-2:]
    ch, cw = H // 2, W // 3                       # 96 x 84, both even
    rs = np.random.RandomState(7)
    thr = rs.randint(6, 20, (2, 2, 3)).astype(np.float32)
    tmaps = np.stack([np.asarray(jgrid.threshold_image(th, H, W, jc))
                      for th in thr])
    jp, jcode, jcnt = fast_kernel.fast_detect_grid_pallas(
        imgs, tmaps, fast_type, nms=True, cell=(2, 3, ch, cw),
        interpret=True)
    pooled, code, counts = fast_grid.fast_grid(t(imgs), t(thr),
                                               (2, 3, ch, cw), fast_type)
    np.testing.assert_array_equal(n(counts), n(jcnt))
    ph, pw = ch // 2, cw // 2
    ref_p = n(jp)[:, :2 * ph, :3 * pw].reshape(2, 2, ph, 3, pw)
    ref_c = n(jcode)[:, :2 * ph, :3 * pw].reshape(2, 2, ph, 3, pw)
    np.testing.assert_array_equal(
        n(pooled), ref_p.transpose(0, 1, 3, 2, 4).reshape(2, 2, 3, -1))
    np.testing.assert_array_equal(
        n(code).astype(np.float32),
        ref_c.transpose(0, 1, 3, 2, 4).reshape(2, 2, 3, -1))
    assert n(counts).min() > 0


@pytest.mark.parametrize("fast_type", TYPES)
@pytest.mark.parametrize("shape", [(192, 252), (186, 279), (190, 256)],
                         ids=["even", "odd", "odd_rows"])
def test_detect_pair_exact(fast_type, shape):
    """Keypoints (order included), scores, validity, counts and the
    updated thresholds equal the JAX XLA path's, also at odd cell dims
    (93×93, and 95×85) where the TPU kernel's global pooling would not."""
    H, W = shape
    left = _image(fast_type, H, W, seed=8)
    right = _image(fast_type, H, W, seed=9)
    tc, jc = _cfg(fast_type=fast_type)
    tl = np.full((2, 3), 10.0, np.float32)
    tr = np.array([[8, 12, 9], [11, 10, 14]], np.float32)
    got = tgrid.detect_pair(t(left), t(right), t(tl), t(tr), tc)
    ref = jgrid.detect_pair(left, right, tl, tr, jc)
    for g, r in zip(got, ref):
        for f in ("xy", "score", "valid"):
            np.testing.assert_array_equal(n(getattr(g.keypoints, f)),
                                          n(getattr(r.keypoints, f)))
        np.testing.assert_array_equal(n(g.cell_counts), n(r.cell_counts))
        np.testing.assert_array_equal(n(g.thresholds), n(r.thresholds))
        assert n(g.keypoints.valid).sum() > 50


@pytest.mark.parametrize("init", [4.0, 80.0, 1.0, -1.0],
                         ids=["min", "max", "one", "negative"])
def test_detect_pair_exact_across_the_threshold_range(init):
    """The controller keeps thresholds in [min_threshold, max_threshold] =
    [4, 80]; the grid kernel's twin also holds below that range, where
    most or all pixels are candidates."""
    left, right = image(186, 279, seed=20), image(186, 279, seed=21)
    tc, jc = _cfg(min_threshold=-2.0)
    th = np.full((2, 3), init, np.float32)
    got = tgrid.detect_pair(t(left), t(right), t(th), t(th), tc)
    ref = jgrid.detect_pair(left, right, th, th, jc)
    for g, r in zip(got, ref):
        for f in ("xy", "score", "valid"):
            np.testing.assert_array_equal(n(getattr(g.keypoints, f)),
                                          n(getattr(r.keypoints, f)))
        np.testing.assert_array_equal(n(g.cell_counts), n(r.cell_counts))
        np.testing.assert_array_equal(n(g.thresholds), n(r.thresholds))


@pytest.mark.parametrize("fast_type", TYPES)
@pytest.mark.parametrize("lo,hi", [(6, 20), (-2, 3), (60, 61)])
def test_grid_twin_from_the_two_phase_map(fast_type, lo, hi):
    """Pooling the two-phase map (the kernels' evaluation order) gives the
    grid kernel's twin exactly, at odd cell dims and any thresholds."""
    imgs = t(np.stack([_image(fast_type, 93, 139, seed=s) for s in (22, 23)]))
    thr = t(np.random.RandomState(24).randint(lo, hi, (2, 2, 3)).astype(
        np.float32))
    cell = (2, 3, 46, 46)
    tmaps = fast_grid.threshold_map(thr, 93, 139, 46, 46)
    smap = tfast.detect_dense_two_phase(imgs, tmaps, fast_type, True)
    for g, r in zip(fast_grid.pool_cells(smap, cell),
                    fast_grid.fast_grid(imgs, thr, cell, fast_type)):
        assert torch.equal(g, r)


def test_detect_single_image_matches_jax():
    img = image(186, 279, seed=10)
    tc, jc = _cfg(cell_capacity=32)
    th = np.full((2, 3), 9.0, np.float32)
    got = tgrid.detect(t(img), t(th), tc)
    ref = jgrid.detect(img, th, jc)
    np.testing.assert_array_equal(n(got.keypoints.xy), n(ref.keypoints.xy))
    np.testing.assert_array_equal(n(got.thresholds), n(ref.thresholds))


@pytest.mark.parametrize("M,k,chunk,k0", [(5000, 64, 1024, 128),
                                          (3000, 200, 256, 16),
                                          (300, 384, 1024, 128)])
def test_topk_2stage_tie_order(M, k, chunk, k0):
    """Heavy ties (small integer scores): `lax.top_k` puts lower indices
    first; the port's stable sort must reproduce the order, the -1 padding
    and the chunk pre-selection (inexact on purpose when a chunk holds more
    than k0 winners: the second case)."""
    rs = np.random.RandomState(M)
    cells = rs.randint(-1, 6, (2, 3, M)).astype(np.float32)
    v_t, i_t = tgrid._topk_2stage(t(cells), k, chunk, k0)
    v_j, i_j = jgrid._topk_2stage(jnp.asarray(cells), k, chunk, k0)
    np.testing.assert_array_equal(n(v_t), n(v_j))
    np.testing.assert_array_equal(n(i_t), n(i_j))


def test_threshold_image_matches_jax():
    tc, jc = _cfg()
    th = np.arange(6, dtype=np.float32).reshape(2, 3) + 5
    np.testing.assert_array_equal(
        n(tgrid.threshold_image(t(th), 191, 257, tc)),
        n(jgrid.threshold_image(th, 191, 257, jc)))


@pytest.mark.parametrize("row_shares", [None, (0.5, 2.0)])
def test_controller_update_matches_jax(row_shares):
    tc, jc = _cfg(row_shares=row_shares, set_point=600, min_threshold=6.0)
    counts = np.array([[0, 100, 119], [121, 80, 400]], np.int32)
    th = np.array([[6, 20, 30], [79, 80, 7]], np.float32)
    got = tgrid.update_thresholds(t(counts), t(th), tc)
    err = counts - np.asarray(jc.cell_set_points())
    move = np.abs(err) > jc.hysteresis * np.asarray(jc.cell_set_points())
    ref = np.clip(th + np.where(err > 0, 1.0, -1.0) * move,
                  jc.min_threshold, jc.max_threshold)
    np.testing.assert_array_equal(n(got), ref.astype(np.float32))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        fast_grid.fast_grid(torch.zeros(1, 32, 32, device="meta"),
                            torch.zeros(1, 2, 3, device="meta"),
                            (2, 3, 16, 10))


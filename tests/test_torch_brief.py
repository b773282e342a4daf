"""Parity of the port's BRIEF with the JAX package: the pattern table, the
box blur, packed words of the dense-bitplane and the gather forms, the
bitplane kernel's plain twin against the Pallas kernel in interpret mode,
the keypoint kernel's plain twin against the gathered dense planes (border,
outside the image, half-integer coordinates, padding rows), and the border
mask."""
import numpy as np
import pytest
import torch

from front_end_tpu.ops import brief as jbrief
from front_end_tpu.ops.pallas import brief_kernel
from front_end_tpu_torch.ops import brief as tbrief
from front_end_tpu_torch.ops.kernels import brief_keypoints, brief_planes
from torch_parity import image, n, t


def _interior_xy(h, w, count=200, seed=0, border=34):
    rs = np.random.RandomState(seed)
    return np.stack([rs.randint(border, w - border, count),
                     rs.randint(border, h - border, count)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_pattern_table_matches_jax(n_bits):
    np.testing.assert_array_equal(tbrief.brief_pattern(n_bits),
                                  np.asarray(jbrief.brief_pattern(n_bits)))


@pytest.mark.parametrize("n_bytes", [16, 32])
def test_describe_dense_words_match_jax(n_bytes):
    img = image(96, 160, seed=11)
    sm_t, sm_j = tbrief.smooth(t(img)), jbrief.smooth(img)
    np.testing.assert_array_equal(n(sm_t), n(sm_j))
    xy = _interior_xy(96, 160, seed=n_bytes)
    d_t = tbrief.describe_dense(sm_t, t(xy), n_bytes)
    d_j = jbrief.describe_dense(sm_j, xy, n_bytes)
    np.testing.assert_array_equal(n(d_t.packed), n(d_j.packed))
    np.testing.assert_array_equal(n(d_t.bits), n(d_j.bits))


def test_describe_gather_form_matches_jax_and_dense():
    img = image(96, 160, seed=12)
    sm = tbrief.smooth(t(img))
    xy = _interior_xy(96, 160, seed=3)
    d_t = tbrief.describe(sm, t(xy), 32)
    d_j = jbrief.describe(n(sm), xy, 32)
    np.testing.assert_array_equal(n(d_t.bits), n(d_j.bits))
    np.testing.assert_array_equal(n(d_t.bits),
                                  n(tbrief.describe_dense(sm, t(xy),
                                                          32).bits))


def test_describe_pair_is_two_singles():
    a, b = image(96, 160, seed=13), image(96, 160, seed=14)
    sa, sb = tbrief.smooth(t(a)), tbrief.smooth(t(b))
    xa, xb = _interior_xy(96, 160, seed=4), _interior_xy(96, 160, seed=5)
    pa, pb = tbrief.describe_pair(sa, sb, t(xa), t(xb), 32)
    np.testing.assert_array_equal(
        n(pa.packed), n(tbrief.describe_dense(sa, t(xa), 32).packed))
    np.testing.assert_array_equal(
        n(pb.packed), n(tbrief.describe_dense(sb, t(xb), 32).packed))


@pytest.mark.parametrize("n_bits", [128, 256])
def test_kernel_plain_matches_pallas_interpret(n_bits):
    """All bitplane words of a blurred pair, border included (both clamp
    at the image edge)."""
    imgs = np.stack([image(100, 140, seed=s) for s in (15, 16)])
    sm = n(tbrief.smooth(t(imgs)))
    got = brief_planes.brief_planes(t(sm), tbrief.brief_pattern(n_bits))
    ref = brief_kernel.brief_bitplanes(sm, n_bits, interpret=True)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(n(got), n(ref))


def test_kernel_rejects_offsets_beyond_its_halo():
    pat = np.zeros((32, 2, 2), np.int32)
    pat[0, 0, 0] = 24
    with pytest.raises(ValueError, match="offset"):
        brief_planes.brief_planes(torch.zeros(1, 64, 64), pat)


def test_valid_mask_matches_jax():
    xy = np.array([[33, 33], [32, 40], [126, 62], [127, 62], [60, 63]],
                  np.float32)
    np.testing.assert_array_equal(
        n(tbrief.valid_mask(t(xy), 160, 96)),
        n(jbrief.valid_mask(xy, 160, 96)))


H, W = 72, 100


def _keypoints(kind, count=40, seed=0):
    """(count, 2) float32 keypoints of one kind of trouble."""
    rs = np.random.RandomState(seed)
    if kind == "border":         # on and next to every edge and corner
        xs = rs.choice([0, 1, 2, W - 3, W - 2, W - 1], count)
        ys = rs.choice([0, 1, 2, H - 3, H - 2, H - 1], count)
        xs[::2] = rs.randint(0, W, count)[::2]
        xy = np.stack([xs, ys], -1)
    elif kind == "outside":      # clamped into the image first
        xy = np.stack([rs.uniform(-40, W + 40, count),
                       rs.uniform(-40, H + 40, count)], -1)
        xy[::2, 0] = rs.choice([-25.0, -0.6, W - 0.4, W + 30.0], count)[::2]
    elif kind == "half":         # x.5 rounds to the even neighbour
        xy = np.stack([rs.randint(-2, W + 2, count),
                       rs.randint(-2, H + 2, count)], -1) + 0.5
    else:                        # padding rows: zeros
        xy = np.zeros((count, 2))
        xy[: count // 4] = np.stack([rs.uniform(0, W, count // 4),
                                     rs.uniform(0, H, count // 4)], -1)
    return xy.astype(np.float32)


@pytest.mark.parametrize("kind", ["border", "outside", "half", "padding"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_keypoint_twin_equals_gathered_planes(n_bits, batch, kind):
    """Word for word what the dense route gives: planes, then a gather at
    clamp(round(xy))."""
    sm = tbrief.smooth(t(np.stack([image(H, W, seed=20 + b)
                                   for b in range(batch)])))
    xy = t(np.stack([_keypoints(kind, seed=b) for b in range(batch)]))
    pat = tbrief.brief_pattern(n_bits)
    got = brief_keypoints.brief_keypoints(
        sm, xy, brief_keypoints.sample_table(pat))
    planes = brief_planes.plain(sm, pat)
    assert got.dtype == torch.uint32 and got.shape == (batch, 40, n_bits // 32)
    for b in range(batch):
        ref = tbrief.gather_words(planes[b], xy[b])
        np.testing.assert_array_equal(n(got[b]), n(ref.packed))


def test_half_integer_keypoints_round_to_even():
    xy = t(np.array([[0.5, 1.5], [2.5, 3.5], [-0.5, 70.5]], np.float32))
    px, py = brief_keypoints.keypoint_pixels(xy, H, W)
    assert px.tolist() == [0, 2, 0] and py.tolist() == [2, 4, 70]


def test_non_finite_keypoints_clamp_as_the_kernel_clamps():
    """+-inf goes to the edge and NaN to pixel 0, and the words are those of
    the finite keypoint at that pixel."""
    inf, nan = float("inf"), float("nan")
    xy = t(np.array([[inf, -inf], [-inf, inf], [nan, 5.0], [7.0, nan],
                     [nan, nan]], np.float32))
    at = t(np.array([[W - 1, 0], [0, H - 1], [0, 5], [7, 0], [0, 0]],
                    np.float32))
    px, py = brief_keypoints.keypoint_pixels(xy, H, W)
    assert px.tolist() == [W - 1, 0, 0, 7, 0]
    assert py.tolist() == [0, H - 1, 5, 0, 0]
    sm = tbrief.smooth(t(image(H, W, seed=23)))[None]
    table = brief_keypoints.sample_table(tbrief.brief_pattern(256))
    np.testing.assert_array_equal(
        n(brief_keypoints.brief_keypoints(sm, xy[None], table)),
        n(brief_keypoints.brief_keypoints(sm, at[None], table)))


@pytest.mark.parametrize("batch", [1, 2])
def test_no_keypoints_give_an_empty_result(batch):
    sm = torch.zeros(batch, 32, 32)
    table = brief_keypoints.sample_table(tbrief.brief_pattern(128))
    got = brief_keypoints.brief_keypoints(sm, torch.zeros(batch, 0, 2), table)
    assert got.shape == (batch, 0, 4) and got.dtype == torch.uint32
    d = tbrief.describe_dense(sm[0], torch.zeros(0, 2), 16)
    assert d.packed.shape == (0, 4) and d.bits.shape == (0, 128)


@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_sample_table_is_sorted_by_rows_and_decodes_to_the_pattern(n_bits):
    pat = tbrief.brief_pattern(n_bits)
    table = brief_keypoints.sample_table(pat)
    assert table.dtype == torch.int32 and table.shape == (2 * n_bits,)
    np.testing.assert_array_equal(n(brief_keypoints._offsets(table)), pat)
    e = n(table).astype(np.int64)
    dy = ((e >> 8 & 0xff) ^ 0x80) - 0x80
    assert (np.diff(dy) >= 0).all()
    assert sorted(e >> 16) == list(range(2 * n_bits))


def test_describe_pair_takes_sets_of_different_sizes():
    a, b = image(96, 160, seed=17), image(96, 160, seed=18)
    sa, sb = tbrief.smooth(t(a)), tbrief.smooth(t(b))
    xa = _interior_xy(96, 160, count=50, seed=6)
    xb = _interior_xy(96, 160, count=31, seed=7)
    pa, pb = tbrief.describe_pair(sa, sb, t(xa), t(xb), 16)
    assert pa.packed.shape == (50, 4) and pb.bits.shape == (31, 128)
    np.testing.assert_array_equal(
        n(pa.packed), n(tbrief.describe_dense(sa, t(xa), 16).packed))
    np.testing.assert_array_equal(
        n(pb.packed), n(tbrief.describe_dense(sb, t(xb), 16).packed))


@pytest.mark.parametrize("what", ["offset", "bits", "table", "rank"])
def test_keypoint_kernel_rejects_what_it_does_not_take(what):
    img, xy = torch.zeros(1, 32, 32), torch.zeros(1, 5, 2)
    table = brief_keypoints.sample_table(tbrief.brief_pattern(128))
    with pytest.raises(ValueError):
        if what == "offset":     # offsets are stored as signed bytes
            pat = np.zeros((32, 2, 2), np.int32)
            pat[3, 1, 0] = 128
            brief_keypoints.sample_table(pat)
        elif what == "bits":
            brief_keypoints.sample_table(np.zeros((48, 2, 2), np.int32))
        elif what == "table":
            brief_keypoints.brief_keypoints(img, xy, table.to(torch.int64))
        else:
            brief_keypoints.brief_keypoints(img[0], xy, table)

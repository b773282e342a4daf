"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: a CUDA kernel has no interpret mode, so these skip where
torch sees no CUDA device.  On a machine with an H100 and nvcc (JAX need
not be installed there, hence no conftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every comparison is exact: the kernels use only compares, min/max,
subtractions and integer popcounts, which round the same in any order.
"""
import numpy as np
import pytest
import torch

from front_end_tpu_torch import features
from front_end_tpu_torch.ops import brief as tbrief
from front_end_tpu_torch.ops import brisk as tbrisk
from front_end_tpu_torch.ops import fast as tfast
from front_end_tpu_torch.ops import image as timage
from front_end_tpu_torch.ops import orb as torb
from front_end_tpu_torch.ops.kernels import (brief_keypoints, brief_planes,
                                             fast_detect, fast_grid,
                                             fast_margins, match_reduce)
from front_end_tpu_torch.types import pack_bits

pytestmark = pytest.mark.cuda


def image(h, w, seed, block=6):
    """Blocky integer-valued texture with per-pixel noise."""
    rs = np.random.RandomState(seed)
    img = np.kron(rs.uniform(0, 255, (h // block + 1, w // block + 1)),
                  np.ones((block, block)))[:h, :w]
    return np.round(img + rs.uniform(0, 2, img.shape)).astype(np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("fast_type", ["9_16", "7_12", "5_8"])
@pytest.mark.parametrize("shape", [(192, 252), (186, 279), (376, 1241)])
def test_fast_grid_kernel_equals_plain(dev, fast_type, shape):
    H, W = shape
    block = 1 if fast_type == "5_8" else 6
    imgs = torch.as_tensor(np.stack([image(H, W, seed=s, block=block)
                                     for s in (1, 2)]))
    thr = torch.as_tensor(np.random.RandomState(3).randint(
        6, 20, (2, 2, 3)).astype(np.float32))
    cell = (2, 3, H // 2, W // 3)
    before = fast_grid.launches
    got = fast_grid.fast_grid(imgs.to(dev), thr.to(dev), cell, fast_type)
    torch.cuda.synchronize()
    assert fast_grid.launches == before + 1
    ref = fast_grid.plain(imgs, thr, cell, fast_type)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert int(ref[2].sum()) > 100


# odd KITTI width, a shape smaller than one 32x32 tile, ORB's smallest
# level, a batch of one and of two, and a (T, 2, H, W) stack whose leading
# dims the wrappers flatten into the batch
DENSE_SHAPES = [(2, 376, 1241), (1, 23, 31), (64, 64), (2, 7, 9), (97, 130),
                (3, 2, 40, 50)]


def _dense_images(shape, fast_type):
    block = 1 if fast_type == "5_8" else 6
    H, W = shape[-2:]
    lead = shape[:-2]
    n = int(np.prod(lead)) if lead else 1
    imgs = np.stack([image(H, W, seed=10 + s, block=block)
                     for s in range(n)])
    return torch.as_tensor(imgs.reshape(shape))


@pytest.mark.parametrize("fast_type", ["9_16", "7_12", "5_8"])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_fast_margins_kernel_equals_plain(dev, fast_type, shape):
    img = _dense_images(shape, fast_type)
    before = fast_margins.launches
    got = tfast.fast_margins(img.to(dev), fast_type)
    torch.cuda.synchronize()
    assert fast_margins.launches == before + 1
    ref = fast_margins.plain(img, fast_type)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g.cpu(), r)
    if min(shape[-2:]) > 20:
        assert int((ref[0] > 10).sum()) > 20


@pytest.mark.parametrize("threshold", ["scalar", "map", "shared_map"])
@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("fast_type", ["9_16", "7_12", "5_8"])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_fast_detect_kernel_equals_plain(dev, fast_type, nms, threshold,
                                         shape):
    img = _dense_images(shape, fast_type)
    rs = np.random.RandomState(5)
    if threshold == "scalar":
        thr_cpu = thr_dev = 12.0
    else:
        tshape = shape if threshold == "map" else shape[-2:]
        thr_cpu = torch.as_tensor(
            rs.randint(4, 30, tshape).astype(np.float32))
        thr_dev = thr_cpu.to(dev)
    before = fast_detect.launches
    got = tfast.detect_dense(img.to(dev), thr_dev, fast_type, nms)
    torch.cuda.synchronize()
    assert fast_detect.launches == before + 1
    ref = fast_detect.plain(img, thr_cpu, fast_type, nms)
    assert got.shape == ref.shape and torch.equal(got.cpu(), ref)
    if min(shape[-2:]) > 60:
        assert int((ref > 0).sum()) > 10


INF = float("inf")


def _threshold_case(case, img, fast_type):
    """A threshold for the (..., H, W) CPU image `img`."""
    if not isinstance(case, str):
        return case
    if case == "map":           # per-pixel, negative values included
        rs = np.random.RandomState(7)
        return torch.as_tensor(rs.randint(-2, 40, tuple(img.shape)).astype(
            np.float32))
    # the larger rejection bound itself: no pixel is a candidate ("bound"),
    # or one float below it: every scored pixel is one ("under")
    bd, bb = tfast.reject_bounds(tfast._dark_diffs(
        img, tfast.TYPES[fast_type][0]))
    thr = torch.maximum(bd, bb)
    if case == "under":
        thr = torch.nextafter(thr, torch.full_like(thr, -INF))
    return thr


def _image_case(kind, shape, fast_type):
    img = _dense_images(shape, fast_type)
    if kind == "flat":
        return torch.full_like(img, 7.0)
    if kind == "level":         # a resized pyramid level: non-integer pixels
        big = _dense_images(shape[:-2] + (shape[-2] * 6 // 5 + 1,
                                          shape[-1] * 6 // 5 + 1), fast_type)
        return timage.resize_linear(big, *shape[-2:])
    return img


@pytest.mark.parametrize("shape", [(2, 61, 95), (1, 331, 1010)], ids=str)
@pytest.mark.parametrize("threshold", [-INF, -1.0, 0.0, 1.0, 15.0, 60.0,
                                       "map", "bound", "under"], ids=str)
@pytest.mark.parametrize("kind", ["integer", "flat", "level"])
@pytest.mark.parametrize("fast_type", ["9_16", "7_12", "5_8"])
def test_fast_detect_thresholds_and_images(dev, fast_type, kind, threshold,
                                           shape):
    """Every pixel a candidate (-inf, "under"), none ("bound", a flat
    image at 0), negative gates, a per-pixel map; integer and resized
    pixels; a small batch of two, whose windows are 16 rows high on a card
    of 100 SMs or more, and an image large enough for windows of 32 rows;
    NMS on and off."""
    img = _image_case(kind, shape, fast_type)
    thr = _threshold_case(threshold, img, fast_type)
    thr_dev = thr.to(dev) if isinstance(thr, torch.Tensor) else thr
    for nms in (True, False):
        got = fast_detect.fast_detect(img.to(dev), thr_dev, fast_type, nms)
        torch.cuda.synchronize()
        ref = fast_detect.plain(img, thr, fast_type, nms)
        assert torch.equal(got.cpu(), ref), nms
    if threshold == "bound":
        assert not bool(ref.any())


def _sweep_shapes():
    """Every shape the service sweep launches the detect kernel at for a
    KITTI image: ORB's levels at the table's scale factors, BRISK's
    octaves."""
    H, W = 376, 1241
    shapes = {(H, W)}
    for sf in features.ORB_PARAMS["scale_factor"]:
        for lvl in range(1, max(features.ORB_PARAMS["n_levels"])):
            shapes.add(tuple(torb.level_shape(H, W, lvl, sf)))
    octave = torch.zeros(H, W)
    for _ in range(1, max(features.BRISK_PARAMS["n_octaves"])):
        octave = tbrisk.next_octave(octave)
        shapes.add(tuple(octave.shape))
    return sorted(shapes, reverse=True)


@pytest.mark.parametrize("shape", _sweep_shapes(), ids=str)
def test_fast_detect_at_every_sweep_shape(dev, shape):
    """Resized (non-integer) pixels at the sweep's threshold, 1.0, batch of
    one; the shapes fall on both sides of the window-height rule."""
    big = torch.as_tensor(image(376, 1241, seed=50)).to(dev)
    lv = timage.resize_linear(big, *shape).contiguous()
    got = fast_detect.fast_detect(lv, 1.0, "9_16", True)
    torch.cuda.synchronize()
    assert torch.equal(got, fast_detect.plain(lv, 1.0, "9_16", True))
    assert int((got > 0).sum()) > shape[0] * shape[1] // 2000


# (B, H, W), (Gr, Gc): cells below one tile, KITTI (odd cell width), batch
# of one and two, odd and even cells; the small images take windows of 16
# rows, KITTI's of 32
GRID_CASES = [((1, 20, 27), (2, 3)), ((2, 64, 96), (2, 3)),
              ((1, 376, 1241), (2, 3)), ((2, 376, 1241), (2, 3)),
              ((2, 93, 139), (3, 2))]


@pytest.mark.parametrize("lo,hi", [(-INF, -INF), (-2, 3), (1, 2), (6, 20),
                                   (60, 61)])
@pytest.mark.parametrize("shape,cells", GRID_CASES, ids=str)
def test_fast_grid_thresholds_shapes_and_batches(dev, shape, cells, lo, hi):
    B, H, W = shape
    Gr, Gc = cells
    for fast_type in ("9_16", "7_12", "5_8"):
        if fast_type != "9_16" and H > 100:
            continue            # the other circles at the small shapes
        imgs = _dense_images(shape, fast_type)
        if lo == -INF:          # every pixel a candidate: the full lists
            thr = torch.full((B, Gr, Gc), -INF)
        else:
            thr = torch.as_tensor(np.random.RandomState(3).randint(
                lo, hi, (B, Gr, Gc)).astype(np.float32))
        cell = (Gr, Gc, H // Gr, W // Gc)
        got = fast_grid.fast_grid(imgs.to(dev), thr.to(dev), cell, fast_type)
        torch.cuda.synchronize()
        ref = fast_grid.plain(imgs, thr, cell, fast_type)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r), fast_type


def test_fast_grid_on_resized_pixels_and_a_flat_image(dev):
    big = torch.as_tensor(np.stack([image(226, 335, seed=s)
                                    for s in (60, 61)]))
    imgs = timage.resize_linear(big, 186, 279)
    flat = torch.full((2, 186, 279), 9.0)
    cell = (2, 3, 93, 93)
    for x in (imgs, flat):
        for t in (0.0, 9.0, -1.0):
            thr = torch.full((2, 2, 3), t)
            got = fast_grid.fast_grid(x.to(dev), thr.to(dev), cell)
            ref = fast_grid.plain(x, thr, cell)
            for g, r in zip(got, ref):
                assert torch.equal(g.cpu(), r)


def test_dense_kernels_take_strided_input_and_reject_other_types(dev):
    img = _dense_images((2, 80, 120), "9_16").to(dev)
    view = img[:, ::2, 1::3]                      # non-contiguous
    assert torch.equal(fast_detect.fast_detect(view, 9.0),
                       fast_detect.plain(view.contiguous(), 9.0))
    with pytest.raises(TypeError):
        fast_detect.fast_detect(img.double(), 9.0)
    with pytest.raises(TypeError):
        fast_margins.fast_margins(img.to(torch.uint8))
    with pytest.raises(ValueError):
        fast_detect.fast_detect(img, torch.full((80, 120), 9.0))  # CPU map


def test_match_reduce_at_the_tracker_association_shape(dev):
    """2304 frame features against a 4608-slot landmark store, roi gate:
    the third match launch of a windowed frame."""
    nq, nt, D = 2304, 4608, 256
    rs = np.random.RandomState(11)
    bt = (rs.uniform(size=(nt, D)) > 0.5).astype(np.float32)
    perm = rs.randint(0, nt, nq)
    bq = np.abs(bt[perm] - (rs.uniform(size=(nq, D)) < 0.04))
    xyt = np.stack([rs.uniform(30, 1200, nt), rs.uniform(30, 340, nt)], -1)
    xyq = xyt[perm] + rs.normal(0, 5, (nq, 2))
    args = [pack_bits(torch.as_tensor(bq.astype(np.float32))),
            pack_bits(torch.as_tensor(bt)),
            torch.as_tensor(xyq, dtype=torch.float32),
            torch.as_tensor(xyt, dtype=torch.float32),
            torch.as_tensor(rs.uniform(size=nq) > 0.1),
            torch.as_tensor(rs.uniform(size=nt) > 0.4)]
    got = match_reduce.match_reduce(*[a.to(dev) for a in args], mode="roi",
                                    p1=100.0)
    torch.cuda.synchronize()
    ref = match_reduce.plain(*args, "roi", p1=100.0)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert int((ref[0] < 64).sum()) > 1000


def _ints(x):
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_brief_planes_kernel_equals_plain(dev, n_bits):
    imgs = torch.as_tensor(np.stack([image(100, 141, seed=s)
                                     for s in (4, 5)]))
    sm = tbrief.smooth(imgs)
    pat = tbrief.brief_pattern(n_bits)
    got = brief_planes.brief_planes(sm.to(dev), pat)
    torch.cuda.synchronize()
    assert torch.equal(_ints(got).cpu(), _ints(brief_planes.plain(sm, pat)))


def _brief_images(case):
    rs = np.random.RandomState(6)
    if case == "below_a_tile":
        return tbrief.smooth(torch.as_tensor(image(20, 25, seed=1)[None]))
    if case == "ragged":
        return tbrief.smooth(torch.as_tensor(np.stack(
            [image(37, 53, seed=2), image(37, 53, seed=3)])))
    if case == "wide":
        return tbrief.smooth(torch.as_tensor(image(100, 261, seed=4)[None]))
    if case == "ties":           # integer values, few of them
        return torch.as_tensor(rs.randint(0, 4, (2, 70, 90)).astype(
            np.float32))
    x = rs.randint(0, 6, (1, 70, 90)).astype(np.float32)   # non-finite
    x[0, 10:14, 20:23] = np.nan
    x[0, 30, 5:40] = np.inf
    x[0, 2:60, 60] = -np.inf
    x[0, 40, 40] = -0.0
    return torch.as_tensor(x)


@pytest.mark.parametrize("case", ["below_a_tile", "ragged", "wide", "ties",
                                  "non_finite"])
@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_brief_planes_kernel_on_ragged_tied_and_non_finite_images(
        dev, n_bits, case):
    img = _brief_images(case)
    pat = tbrief.brief_pattern(n_bits)
    before = brief_planes.launches
    got = brief_planes.brief_planes(img.to(dev), pat)
    torch.cuda.synchronize()
    assert brief_planes.launches == before + 1
    assert torch.equal(_ints(got).cpu(), _ints(brief_planes.plain(img, pat)))


@pytest.mark.parametrize("mode,p", [
    ("stereo", dict(p1=15.0, p2=0.0, p3=300.0)), ("epi", dict(p1=15.0)),
    ("roi", dict(p1=40.0)), ("none", {}), ("roi", dict(p1=0.5))])
@pytest.mark.parametrize("nq,nt,D", [(192, 256, 256), (2304, 2304, 256),
                                     (37, 1100, 128), (300, 45, 512)])
def test_match_reduce_kernel_equals_plain(dev, mode, p, nq, nt, D):
    rs = np.random.RandomState(nq + nt)
    bq = (rs.uniform(size=(nq, D)) > 0.5).astype(np.float32)
    perm = rs.randint(0, nq, nt)
    bt = np.abs(bq[perm] - (rs.uniform(size=(nt, D)) < 0.04))
    xyq = np.stack([rs.uniform(50, 550, nq), rs.uniform(20, 180, nq)], -1)
    xyt = xyq[perm] + rs.normal(0, 5, (nt, 2))
    args = [pack_bits(torch.as_tensor(bq)),
            pack_bits(torch.as_tensor(bt.astype(np.float32))),
            torch.as_tensor(xyq, dtype=torch.float32),
            torch.as_tensor(xyt, dtype=torch.float32),
            torch.as_tensor(rs.uniform(size=nq) > 0.1),
            torch.as_tensor(rs.uniform(size=nt) > 0.1)]
    got = match_reduce.match_reduce(*[a.to(dev) for a in args], mode=mode,
                                    **p)
    torch.cuda.synchronize()
    ref = match_reduce.plain(*args, mode, **p)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


# odd widths, an image smaller than the pattern's reach, one keypoint
@pytest.mark.parametrize("n_bits", [128, 256, 512])
@pytest.mark.parametrize("shape,count", [((1, 100, 141), 300),
                                         ((2, 97, 131), 257),
                                         ((2, 376, 1241), 2304),
                                         ((1, 19, 23), 64), ((2, 64, 64), 1)])
def test_brief_keypoints_kernel_equals_plain_and_dense(dev, n_bits, shape,
                                                       count):
    B, H, W = shape
    sm = tbrief.smooth(torch.as_tensor(np.stack(
        [image(H, W, seed=30 + b) for b in range(B)])))
    rs = np.random.RandomState(count + n_bits)
    xy = np.stack([rs.uniform(-30, W + 30, (B, count)),
                   rs.uniform(-30, H + 30, (B, count))], -1)
    xy[:, ::5] = np.round(xy[:, ::5]) + 0.5          # round half to even
    xy[:, 1::7] = 0.0                                # padding rows
    xy = torch.as_tensor(xy.astype(np.float32))
    table = brief_keypoints.sample_table(tbrief.brief_pattern(n_bits))
    before = brief_keypoints.launches
    got = brief_keypoints.brief_keypoints(sm.to(dev), xy.to(dev),
                                          table.to(dev))
    torch.cuda.synchronize()
    assert brief_keypoints.launches == before + 1
    assert torch.equal(_ints(got).cpu(),
                       _ints(brief_keypoints.plain(sm, xy, table)))
    planes = brief_planes.brief_planes(sm.to(dev),
                                       tbrief.brief_pattern(n_bits))
    for b in range(B):
        dense = tbrief.gather_words(planes[b], xy[b].to(dev)).packed
        assert torch.equal(_ints(got[b]), _ints(dense))


def test_brief_keypoints_copies_strided_input_and_rejects_other_types(dev):
    sm = tbrief.smooth(torch.as_tensor(np.stack(
        [image(80, 120, seed=s) for s in (40, 41)]))).to(dev)
    rs = np.random.RandomState(2)
    xy = torch.as_tensor(rs.uniform(0, 60, (2, 50, 4)).astype(
        np.float32)).to(dev)
    table = tbrief.table_on(256, 7, dev)
    view, xy_view = sm[:, ::2, 1::2], xy[..., ::2]   # non-contiguous
    assert not view.is_contiguous() and not xy_view.is_contiguous()
    got = brief_keypoints.brief_keypoints(view, xy_view, table)
    ref = brief_keypoints.plain(view.contiguous(), xy_view.contiguous(),
                                table)
    assert torch.equal(_ints(got), _ints(ref))
    with pytest.raises(TypeError):
        brief_keypoints.brief_keypoints(sm.double(), xy_view, table)
    with pytest.raises(TypeError):
        brief_keypoints.brief_keypoints(sm, xy_view.to(torch.float16), table)
    with pytest.raises(ValueError):      # the table on another device
        brief_keypoints.brief_keypoints(sm, xy_view, table.cpu())
    d = tbrief.describe_dense(view[0], xy_view[0], 32)
    assert torch.equal(_ints(d.packed), _ints(ref[0]))


def test_brief_keypoints_non_finite_and_empty_sets_equal_the_twin(dev):
    sm = tbrief.smooth(torch.as_tensor(np.stack(
        [image(80, 120, seed=s) for s in (42, 43)]))).to(dev)
    inf, nan = float("inf"), float("nan")
    xy = torch.tensor([[[inf, -inf], [-inf, inf], [nan, 5.0], [7.0, nan],
                        [nan, nan], [3e9, -3e9]]] * 2, device=dev)
    table = tbrief.table_on(256, 7, dev)
    got = brief_keypoints.brief_keypoints(sm, xy, table)
    assert torch.equal(_ints(got), _ints(brief_keypoints.plain(sm, xy, table)))
    before = brief_keypoints.launches
    empty = brief_keypoints.brief_keypoints(sm, xy[:, :0], table)
    assert empty.shape == (2, 0, 8) and empty.device == sm.device
    assert brief_keypoints.launches == before


def _match_inputs(nq, nt, D, seed, dev, kind="random"):
    rs = np.random.RandomState(seed)
    bt = (rs.uniform(size=(nt, D)) > 0.5).astype(np.float32)
    perm = rs.randint(0, nt, nq)
    bq = np.abs(bt[perm] - (rs.uniform(size=(nq, D)) < 0.04))
    xyt = np.stack([rs.uniform(30, 1200, nt), rs.uniform(30, 340, nt)], -1)
    xyq = xyt[perm] + rs.normal(0, 5, (nq, 2))
    vq, vt = rs.uniform(size=nq) > 0.1, rs.uniform(size=nt) > 0.3
    if kind == "equal":                  # every distance 0: ties everywhere
        bq[:], bt[:] = bt[0], bt[0]
    elif kind == "gated":
        vq[:], xyq[:] = rs.uniform(size=nq) > 0.5, xyq + 5000.0
    elif kind == "invalid":
        vt[:] = False
    return [a.to(dev) for a in (
        pack_bits(torch.as_tensor(bq.astype(np.float32))),
        pack_bits(torch.as_tensor(bt)),
        torch.as_tensor(xyq, dtype=torch.float32),
        torch.as_tensor(xyt, dtype=torch.float32),
        torch.as_tensor(vq), torch.as_tensor(vt))]


MATCH_MODES = [("stereo", dict(p1=15.0, p2=0.0, p3=300.0)),
               ("epi", dict(p1=15.0)), ("roi", dict(p1=40.0)), ("none", {})]


@pytest.mark.parametrize("mode,p", MATCH_MODES)
@pytest.mark.parametrize("D", [128, 256, 512])
@pytest.mark.parametrize("nq,nt", [(1, 1), (1, 17), (17, 1), (17, 1000),
                                   (1000, 17), (1000, 2304), (2304, 1000),
                                   (1, 4608), (4608, 1), (2304, 4608),
                                   (4608, 2304)])
def test_match_reduce_mixed_sizes_equal_plain(dev, nq, nt, D, mode, p):
    args = _match_inputs(nq, nt, D, nq * 7 + nt + D, dev)
    before = match_reduce.launches
    got = match_reduce.match_reduce(*args, mode=mode, **p)
    torch.cuda.synchronize()
    assert match_reduce.launches == before + 1
    ref = match_reduce.plain(*args, mode, **p)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("mode,p", [("roi", dict(p1=40.0)), ("none", {})])
@pytest.mark.parametrize("kind", ["equal", "gated", "invalid"])
@pytest.mark.parametrize("nq,nt", [(1000, 2304), (130, 77)])
def test_match_reduce_ties_and_gated_sets_equal_plain(dev, nq, nt, kind,
                                                      mode, p):
    """All descriptors equal (every tie goes to the first index, d2 == d1);
    every pair gated by the box, or every train invalid (BIG, index 0)."""
    args = _match_inputs(nq, nt, 256, 3, dev, kind)
    got = match_reduce.match_reduce(*args, mode=mode, **p)
    ref = match_reduce.plain(*args, mode, **p)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if kind == "invalid" or (kind == "gated" and mode == "roi"):
        assert (got[0] == match_reduce.BIG).all() and not got[2].any()
        assert (got[3] == match_reduce.BIG).all() and not got[4].any()


def test_match_reduce_rejects_sets_too_long_for_its_keys(dev):
    small = _match_inputs(8, 8, 128, 1, dev)
    n = match_reduce.MAX_N
    words = torch.zeros((n, 4), dtype=torch.int32, device=dev).view(
        torch.uint32)
    xy = torch.zeros((n, 2), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="queries"):
        match_reduce.match_reduce(words, small[1], xy, small[3], valid,
                                  small[5])
    with pytest.raises(ValueError, match="queries"):
        match_reduce.match_reduce(small[0], words, small[2], xy, small[4],
                                  valid)


def test_vo_step_on_the_card_equals_the_cpu(dev):
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.ops.grid import GridConfig
    from front_end_tpu_torch.pipeline import vo
    from front_end_tpu_torch.sim.sequence import make_sequence
    rig = StereoRig.create(fx=300.0, baseline=0.3, width=256, height=192)
    cfg = vo.VOConfig(grid=GridConfig(cell_capacity=64, set_point=300,
                                      init_threshold=12.0),
                      ransac_hyps=128, ransac_threshold=0.5,
                      max_disparity=64.0)
    lefts, rights = make_sequence(4, 192, 256)
    outs = {}
    for d in ("cpu", "cuda"):
        s = vo.init_state(rig, cfg, seed=1, device=d)
        outs[d] = vo.run_sequence(s, lefts, rights, rig, cfg)[1]
    for f in ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks"):
        assert torch.equal(getattr(outs["cuda"], f).cpu(),
                           getattr(outs["cpu"], f)), f
    np.testing.assert_allclose(outs["cuda"].pose.cpu().numpy(),
                               outs["cpu"].pose.numpy(), atol=1e-4)


@pytest.mark.parametrize("mode,p,nq,nt", [
    ("stereo", dict(p1=0.7, p2=0.0, p3=192.0), 2304, 2304),
    ("roi", dict(p1=100.0), 2304, 2304), ("roi", dict(p1=100.0), 2304, 4608)])
def test_match_reduce_at_16_words_at_the_swap_set_shapes(dev, mode, p, nq,
                                                         nt):
    """512-bit (FREAK / BRISK) descriptors at the stereo, inter-frame and
    tracker shapes of the swap set's paths."""
    rs = np.random.RandomState(nt + len(mode))
    bq = (rs.uniform(size=(nq, 512)) > 0.5).astype(np.float32)
    perm = rs.randint(0, nq, nt)
    bt = np.abs(bq[perm] - (rs.uniform(size=(nt, 512)) < 0.05))
    xyq = np.stack([rs.uniform(0, 1241, nq), rs.uniform(0, 376, nq)], -1)
    xyt = xyq[perm] + np.stack([rs.normal(8, 3, nt), rs.normal(0, 0.4, nt)],
                               -1)
    args = [pack_bits(torch.as_tensor(bq)),
            pack_bits(torch.as_tensor(bt.astype(np.float32))),
            torch.as_tensor(xyq, dtype=torch.float32),
            torch.as_tensor(xyt, dtype=torch.float32),
            torch.as_tensor(rs.uniform(size=nq) > 0.1),
            torch.as_tensor(rs.uniform(size=nt) > 0.1)]
    assert args[0].shape == (nq, 16)
    before = match_reduce.launches
    got = match_reduce.match_reduce(*[a.to(dev) for a in args], mode=mode,
                                    **p)
    torch.cuda.synchronize()
    assert match_reduce.launches == before + 1
    ref = match_reduce.plain(*args, mode, **p)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert int((ref[0] < 1e8).sum()) > 100


@pytest.mark.parametrize("descriptor,subpix", [
    ("orb", False), ("brisk", False), ("freak", False), ("surf", False),
    ("surf_ext", False), ("brief", True)])
def test_swap_set_vo_step_on_the_card_against_the_cpu(dev, descriptor,
                                                      subpix):
    """Detections equal; keypoints equal (within 1e-3 px refined);
    binary descriptors with at most 0.1 % of bits differing (CUDA's
    sin/cos/atan2 and reductions), SURF's within 1e-5; stereo and track
    counts within 1 %, poses within 1e-3; the launch counts of the path."""
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.ops.grid import GridConfig
    from front_end_tpu_torch.ops.kernels import brief_keypoints
    from front_end_tpu_torch.pipeline import vo
    from front_end_tpu_torch.sim.sequence import make_sequence
    rig = StereoRig.create(fx=300.0, baseline=0.3, width=256, height=192)
    cfg = vo.VOConfig(grid=GridConfig(cell_capacity=64, set_point=300,
                                      init_threshold=12.0),
                      descriptor=descriptor, subpix=subpix, ransac_hyps=128,
                      ransac_threshold=0.5, max_disparity=64.0)
    lefts, rights = make_sequence(4, 192, 256)
    res = {}
    for d in ("cpu", "cuda"):
        before = (fast_grid.launches, match_reduce.launches,
                  brief_keypoints.launches)
        res[d] = vo.run_sequence(vo.init_state(rig, cfg, seed=1, device=d),
                                 lefts, rights, rig, cfg)
        torch.cuda.synchronize()
        after = (fast_grid.launches, match_reduce.launches,
                 brief_keypoints.launches)
        launched = tuple(a - b for a, b in zip(after, before))
    binary = cfg.desc_norm == "hamming"
    assert launched == (4, 8 if binary else 0,
                        4 if descriptor == "brief" else 0)
    (sg, og), (sc, oc) = res["cuda"], res["cpu"]
    for f in ("n_detect_l", "n_detect_r"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    xy_diff = float((sg.prev.kps.xy.cpu() - sc.prev.kps.xy).abs().max())
    assert xy_diff <= (1e-3 if subpix else 0.0)
    if binary:
        assert (sg.prev.bits.cpu() != sc.prev.bits).float().mean() <= 1e-3
    else:
        assert sg.prev.packed is None
        assert float((sg.prev.bits.cpu() - sc.prev.bits).abs().max()) <= 1e-5
    for f in ("n_stereo", "n_tracks"):
        a, b = getattr(og, f).cpu(), getattr(oc, f)
        assert bool(((a - b).abs() <= 0.01 * b + 1).all()), f
    np.testing.assert_allclose(og.pose.cpu().numpy(), oc.pose.numpy(),
                               atol=1e-3)


def _corridor(n_frames=6, start=10):
    """Frames of the rendered corridor's 180° turn at 256×192, the rig."""
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.sim import render
    rig = StereoRig.create(fx=200.0, cx=127.5, cy=95.5, baseline=0.3,
                           width=256, height=192)
    scene = render.corridor_scene(np.random.RandomState(11), tex_size=384,
                                  capped=True, uniform_texel_scale=True)
    gt = render.corridor_trajectory_reversal(40, turn_frames=16)[
        start:start + n_frames]
    return rig, render.render_stereo_sequence(scene, rig, gt), gt


def test_essential_vo_step_on_the_card_against_the_cpu(dev):
    """`motion="essential"` on the rendered corridor: 1 grid, 1 keypoint
    BRIEF and 2 match launches a frame; detections, stereo and track
    counts equal; consensus sizes within 2 rows a frame and poses within
    2e-2 (the refit's E is weakly determined at a few metres, and the
    card's SVDs round otherwise than LAPACK's; `ROADMAP.md` Queue 3)."""
    from front_end_tpu_torch.ops.grid import GridConfig
    from front_end_tpu_torch.pipeline import vo
    rig, (lefts, rights), _ = _corridor()
    cfg = vo.VOConfig(grid=GridConfig(cell_capacity=128, set_point=700,
                                      init_threshold=12.0),
                      ransac_hyps=96, ransac_threshold=0.12,
                      max_disparity=60.0, min_track_inliers=10,
                      motion="essential")
    res = {}
    for d in ("cpu", "cuda"):
        before = (fast_grid.launches, brief_keypoints.launches,
                  match_reduce.launches)
        res[d] = vo.run_sequence(vo.init_state(rig, cfg, seed=1, device=d),
                                 lefts, rights, rig, cfg)[1]
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (fast_grid.launches, brief_keypoints.launches,
             match_reduce.launches), before))
    assert launched == (6, 6, 12)
    og, oc = res["cuda"], res["cpu"]
    for f in ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks"):
        assert torch.equal(getattr(og, f).cpu(), getattr(oc, f)), f
    assert bool(((og.n_inliers.cpu() - oc.n_inliers).abs() <= 2).all())
    assert bool(og.motion_ok.all())
    np.testing.assert_allclose(og.pose.cpu().numpy(), oc.pose.numpy(),
                               atol=2e-2)


def test_five_point_on_the_card_against_the_cpu(dev):
    """The 5-point solver with the same draws: the same basis is not
    promised (cuSOLVER and LAPACK), so R within 2e-3 rad and consensus
    sets at most 2 % apart; the card twice gives the same answer."""
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.motion import essential, ransac
    rs = np.random.RandomState(4)
    n_pts = 600
    X = np.stack([rs.uniform(-4, 4, n_pts), rs.uniform(-2, 2, n_pts),
                  rs.uniform(4, 30, n_pts)], -1)
    c, s = np.cos(0.03), np.sin(0.03)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    Xb = X @ R.T + np.array([0.1, 0.0, 0.8])
    uva = X[:, :2] / X[:, 2:] * 700 + [620, 188]
    uvb = Xb[:, :2] / Xb[:, 2:] * 700 + [620, 188]
    bad = rs.uniform(size=n_pts) < 0.3
    uvb[bad] += rs.uniform(-40, 40, (bad.sum(), 2))
    rig = StereoRig.create(fx=700.0, cx=620.0, cy=188.0, baseline=0.54,
                           width=1241, height=376)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (uva, uvb, X,
                                                              Xb)]
    valid = torch.ones(n_pts, dtype=torch.bool)
    out = []
    for d in ("cpu", "cuda", "cuda"):
        sampler = ransac.InverseCdfSampler(torch.Generator().manual_seed(5))
        out.append(essential.essential_scaled_motion(
            sampler, *[a.to(d) for a in args], valid.to(d), rig, n_hyps=64,
            solver="five_point"))
    cpu, card, again = out
    assert torch.equal(card.inliers, again.inliers)
    assert torch.equal(card.R, again.R)
    apart = int((card.inliers.cpu() != cpu.inliers).sum())
    assert apart <= 0.02 * n_pts
    ang = float(torch.arccos(((card.R.cpu().T @ cpu.R).trace() - 1)
                             .clamp(-2, 2) / 2))
    assert ang < 2e-3
    np.testing.assert_allclose(card.R.cpu().numpy(), R, atol=5e-3)


@pytest.mark.parametrize("descriptor", ["mldb", "msurf"])
def test_akaze_on_the_card_against_the_cpu(dev, descriptor):
    """CUDA's exp may round otherwise than the CPU's (the g1 and Weickert
    conductivities; these use g2, elementwise and exact), and the
    orientation windows and descriptor pools are matrix products summed in
    another order, whose window argmax can flip on a near tie: keypoints
    equal; orientations within 1e-5 rad on all but 0.5 % of keypoints;
    MLDB bits at most 0.1 % differing, M-SURF values within 1e-5 where the
    orientations agree; the card twice gives the same output."""
    from front_end_tpu_torch.ops import akaze
    img = torch.as_tensor(image(188, 620, seed=7))
    runs = [akaze.detect_and_describe(img.to(d), n_octaves=2, n_sublevels=4,
                                      descriptor=descriptor)
            for d in ("cpu", "cuda", "cuda")]
    (dc, Dc), (dg, Dg), (dg2, Dg2) = runs
    assert torch.equal(dg.keypoints.xy, dg2.keypoints.xy)
    assert torch.equal(Dg.bits, Dg2.bits)
    for f in ("xy", "score", "valid"):
        assert torch.equal(getattr(dg.keypoints, f).cpu(),
                           getattr(dc.keypoints, f)), f
    assert int(dc.keypoints.valid.sum()) > 200
    same = (dg.keypoints.angle.cpu() - dc.keypoints.angle).abs() <= 1e-5
    assert float((~same).float().mean()) <= 0.005
    if descriptor == "mldb":
        assert (Dg.bits.cpu() != Dc.bits).float().mean() <= 1e-3
    else:
        assert float((Dg.bits.cpu() - Dc.bits)[same].abs().max()) <= 1e-5


def test_akaze_sweep_records_on_the_card_equal_the_cpu(dev):
    """All 64 AKAZE IDs: every record supported; counts equal to the
    CPU's for the g2 and Charbonnier groups (elementwise arithmetic only),
    within 0.5 % for g1 and Weickert (CUDA's exp)."""
    from front_end_tpu_torch import services
    dt = features.detector_table()
    ids = features.ids_for("AKAZE", dt)
    L, R = image(188, 620, seed=8), image(188, 620, seed=9)
    got = services.single_image_detection(ids, L, R, device="cuda")
    ref = services.single_image_detection(ids, L, R, device="cpu")
    for g, r in zip(got, ref):
        assert g["supported"] and not g["approximate"]
        exact = dt[g["detID"]]["Param"]["diffusivity"] in ("pm_g2",
                                                           "charbonnier")
        for side in ("leftFeatures", "rightFeatures"):
            a, b = g[side]["nPoints"], r[side]["nPoints"]
            assert a == b if exact else abs(a - b) <= 0.005 * b + 1, \
                (g["detID"], a, b)


def test_sift_on_the_card_against_the_cpu(dev):
    """The orientation histogram adds its samples in one fixed order, so
    the card gives the same angles twice; against the CPU's, all but 0.5 %
    equal (CUDA's atan2 may put a sample on the other side of a bin edge);
    detections equal; descriptors within 1e-5 where the angles agree (the
    cell pooling is a matrix product)."""
    from front_end_tpu_torch.ops import sift
    img = torch.as_tensor(image(188, 620, seed=6))
    runs = [sift.detect_and_describe(img.to(d)) for d in ("cpu", "cuda",
                                                          "cuda")]
    (dc, Dc), (dg, Dg), (dg2, _) = runs
    assert torch.equal(dg.keypoints.angle, dg2.keypoints.angle)
    for f in ("xy", "score", "valid"):
        assert torch.equal(getattr(dg.keypoints, f).cpu(),
                           getattr(dc.keypoints, f)), f
    assert int(dc.keypoints.valid.sum()) > 100
    same = dg.keypoints.angle.cpu() == dc.keypoints.angle
    assert float((~same).float().mean()) <= 0.005
    assert float((Dg.bits.cpu() - Dc.bits)[same].abs().max()) <= 1e-5


def _bench_rig(config):
    """The rig of a benchmark configuration (`vobench/configs/`)."""
    import json
    from pathlib import Path

    from front_end_tpu_torch.geometry.camera import StereoRig
    path = (Path(__file__).resolve().parents[1] / "vobench" / "configs"
            / f"{config}.json")
    return StereoRig.create(**json.loads(path.read_text())["rig"])


def _lm_inputs(rig, n, seed, valid, dev):
    """An LM problem as `vo_step` poses it: landmarks in front of the rig,
    their stereo projections after a small motion with 0.3 px noise and
    15 % outliers, and a starting pose off the true one."""
    from front_end_tpu_torch.geometry import se3
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)
    X = (u(n, 3) * torch.tensor([20.0, 6.0, 35.0])
         + torch.tensor([-10.0, -3.0, 5.0]))
    xi = (u(6) - 0.5) * torch.tensor([0.1, 0.05, 1.6, 0.02, 0.04, 0.01])
    H = se3.se3_exp(xi[None])[0]
    uvb = rig.project4(se3.transform_points(H, X)) + 0.3 * (u(n, 4) - 0.5)
    uvb = torch.where(u(n, 1) < 0.15, uvb + 20.0, uvb)
    H0 = se3.se3_exp((xi + 0.01 * (u(6) - 0.5))[None])[0]
    mask = {"all": torch.ones(n, dtype=torch.bool),
            "none": torch.zeros(n, dtype=torch.bool),
            "mixed": u(n) < 0.7}[valid]
    return tuple(t.to(dev) for t in (H0, X, uvb, mask))


def _fresh_graphs(monkeypatch):
    from collections import OrderedDict

    from front_end_tpu_torch.motion import lm
    graphs = OrderedDict()
    monkeypatch.setattr(lm._refine_graphs, "graphs", graphs)
    return lm, graphs


def _lm_eager(lm, args, rig, iters):
    """`_refine` run eagerly: its result and the accept flags it counted,
    kept out of any recording."""
    from front_end_tpu_torch.pipeline import telemetry
    with telemetry.diverted() as counts:
        ref = lm._refine(*args, rig, iters, 3.0, 1e-3)
    return ref, [v for _, v in counts]


@pytest.mark.parametrize("iters", [6, 25])
@pytest.mark.parametrize("config", ["kitti00-vo-brief",
                                    "euroc-mh01-window-surfext"])
def test_lm_graph_replays_equal_the_eager_solver(dev, monkeypatch, config,
                                                 iters):
    """Successive calls with fresh inputs (`valid` mixed, all and none)
    replay one graph, and each replay's H, cost and cost0 equal `_refine`
    run eagerly on the same inputs bit for bit: the static inputs are
    refreshed.  What a call returned stays as it was after later replays."""
    from front_end_tpu_torch.pipeline import telemetry
    lm, graphs = _fresh_graphs(monkeypatch)
    rig = _bench_rig(config)
    kept = []
    with telemetry.recording() as rec:
        for k, valid in enumerate(["mixed", "all", "none", "mixed", "all",
                                   "mixed"]):
            args = _lm_inputs(rig, 2304, 100 * iters + k, valid, dev)
            got = lm.refine_motion(*args, rig, iters=iters)
            ref, accepts = _lm_eager(lm, args, rig, iters)
            for a, b in zip(got, ref):
                assert bool(torch.isfinite(a).all())
                assert torch.equal(a, b)
            if valid == "mixed":
                assert float(got.cost) < float(got.cost0)
            kept.append((got, tuple(t.clone() for t in got)))
    assert len(graphs) == 1
    for got, copy in kept:
        assert all(torch.equal(a, b) for a, b in zip(got, copy))
    c = rec.counters()
    assert [v for _, v in c["lm.graph"]] == [1.0] * 6
    assert len(c["lm.accepted"]) == 6 * iters


def test_lm_graph_counts_its_accept_flags(dev, monkeypatch):
    """Capturing counts nothing: after each replay with a recording open,
    the first call's (which captures) too, the accept buffer's copy gives
    exactly `iters` values, the eager run's."""
    from front_end_tpu_torch.pipeline import telemetry
    lm, graphs = _fresh_graphs(monkeypatch)
    rig = _bench_rig("kitti00-vo-brief")
    for k in range(3):
        args = _lm_inputs(rig, 2304, 40 + k, "mixed", dev)
        with telemetry.recording() as rec:
            lm.refine_motion(*args, rig, iters=6)     # the first captures
        _, accepts = _lm_eager(lm, args, rig, 6)
        c = rec.counters()
        assert [v for _, v in c["lm.accepted"]] == [float(a)
                                                     for a in accepts]
        assert [v for _, v in c["lm.graph"]] == [1.0]
    assert len(graphs) == 1


@pytest.mark.parametrize("case", ["vmap", "grad", "capture"])
def test_lm_runs_eagerly_on_the_card_where_no_graph_serves(dev, monkeypatch,
                                                           case):
    """A vmapped call (the `extract-motion` study's), inputs that require
    grad and a call inside another capture run `_refine` eagerly and
    capture nothing; a capture keeps no count.  The outer capture replays
    the eager kernels bit for bit; the batched and the differentiated
    solves may round otherwise."""
    from front_end_tpu_torch.pipeline import telemetry
    lm, graphs = _fresh_graphs(monkeypatch)
    rig = _bench_rig("kitti00-vo-brief")
    H0, X, uvb, valid = _lm_inputs(rig, 2304, 7, "mixed", dev)
    ref = lm._refine(H0, X, uvb, valid, rig, 25, 3.0, 1e-3)
    with telemetry.recording() as rec:
        if case == "vmap":
            H = torch.func.vmap(
                lambda Xb: lm.refine_motion(H0, Xb, uvb, valid, rig,
                                            iters=25).H)(X[None])
            assert torch.allclose(H[0], ref.H, atol=1e-5)
        elif case == "grad":
            got = lm.refine_motion(H0, X.requires_grad_(True), uvb, valid,
                                   rig, iters=25)
            got.cost.backward()
            assert bool(torch.isfinite(X.grad).all())
            assert torch.allclose(got.H.detach(), ref.H, atol=1e-5)
        else:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), telemetry.diverted():
                lm._refine(H0, X, uvb, valid, rig, 25, 3.0, 1e-3)
            outer = torch.cuda.CUDAGraph()
            with torch.cuda.graph(outer, stream=side):
                got = lm.refine_motion(H0, X, uvb, valid, rig, iters=25)
            outer.replay()
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    c = rec.counters()
    assert not graphs
    assert {v for _, v in c.get("lm.graph", [])} <= {0.0}
    if case == "capture":
        assert c == {}


def _fresh_ba_graphs(monkeypatch):
    from collections import OrderedDict

    from front_end_tpu_torch.window import tracker
    graphs = OrderedDict()
    monkeypatch.setattr(tracker._window_ba_graphs, "graphs", graphs)
    return tracker, graphs


def _ba_equal(got, ref):
    """`run_window_ba`'s (state, BAResult) against the eager body's (Xw,
    BAResult), bit for bit."""
    (state, res), (Xw, ref_res) = got, ref
    return (torch.equal(state.store.Xw, Xw)
            and torch.equal(state.poses, ref_res.poses)
            and all(torch.equal(a, b) for a, b in zip(res, ref_res)))


# the windowed cells' BA: (rig's configuration, iterations)
BA_CELLS = [("euroc-mh01-window-surfext", 6), ("kitti00-window-brief", 2)]


@pytest.mark.parametrize("K", [1024, None], ids=["compacted", "full"])
@pytest.mark.parametrize("config,iters", BA_CELLS,
                         ids=[c for c, _ in BA_CELLS])
def test_ba_graph_replays_equal_the_eager_body(dev, monkeypatch, config,
                                               iters, K):
    """Successive calls with fresh stores of 4608 slots (W = 3; K = 1024
    of them, or the full grid) replay one graph, and each replay's store
    positions, poses, cost, cost0, rms and landmarks equal `_window_ba`
    run eagerly on the same inputs bit for bit: the static inputs are
    refreshed.  What a call returned stays as it was after later
    replays."""
    from _window_ba_problem import eager, window_state
    from front_end_tpu_torch.pipeline import telemetry
    tracker, graphs = _fresh_ba_graphs(monkeypatch)
    rig = _bench_rig(config)
    kept = []
    with telemetry.recording() as rec:
        for k in range(4):
            st = window_state(rig, 4608, seed=10 * iters + k, device=dev)
            got = tracker.run_window_ba(st, rig, iters=iters,
                                        max_landmarks=K)
            with telemetry.diverted():          # the reference's counts
                ref = eager(st, rig, iters=iters, max_landmarks=K)
            assert _ba_equal(got, ref)
            state, res = got
            assert float(res.cost) < float(res.cost0)
            assert bool(torch.isfinite(state.store.Xw).all())
            kept.append((got, (state.store.Xw.clone(),
                               type(res)(*(t.clone() for t in res)))))
    assert len(graphs) == 1
    for got, copy in kept:
        assert _ba_equal(got, copy)
    c = rec.counters()
    assert [v for _, v in c["ba.graph"]] == [1.0] * 4
    assert len(c["ba.accepted"]) == 4 * iters
    assert len(c["ba.landmarks"]) == 4


def test_ba_graph_counts_equal_the_eager_run(dev, monkeypatch):
    """Capturing counts nothing: after each replay with a recording open,
    the first call's (which captures) too, `ba.accepted` and
    `ba.landmarks` are the eager body's, value for value."""
    from _window_ba_problem import eager, window_state
    from front_end_tpu_torch.pipeline import telemetry
    tracker, graphs = _fresh_ba_graphs(monkeypatch)
    rig = _bench_rig("euroc-mh01-window-surfext")
    for k in range(3):
        st = window_state(rig, 4608, seed=70 + k, device=dev)
        with telemetry.recording() as rec:
            tracker.run_window_ba(st, rig, iters=6, max_landmarks=1024)
        with telemetry.recording() as ref:
            eager(st, rig, iters=6, max_landmarks=1024)
        c = rec.counters()
        assert [v for _, v in c.pop("ba.graph")] == [1.0]
        assert c == ref.counters()
    assert len(graphs) == 1


def _lm_keys(monkeypatch, dev):
    """The LM's keys (rig, N, iters), and a call that checks its replay
    against `_refine`."""
    lm, graphs = _fresh_graphs(monkeypatch)
    kitti, euroc = (_bench_rig(c) for c in ("kitti00-vo-brief",
                                            "euroc-mh01-window-surfext"))
    keys = [(kitti, 2304, 6), (kitti, 2304, 25), (euroc, 2304, 6),
            (kitti, 1000, 6), (euroc, 4608, 6)]

    def call(key, seed):
        rig, n, iters = key
        args = _lm_inputs(rig, n, seed, "mixed", dev)
        got = lm.refine_motion(*args, rig, iters=iters)
        ref = lm._refine(*args, rig, iters, 3.0, 1e-3)
        return all(torch.equal(a, b) for a, b in zip(got, ref))
    return graphs, keys, call


def _ba_keys(monkeypatch, dev):
    """The BA's keys (rig, store size, iters, K), and a call that checks
    its replay against `_window_ba`."""
    from _window_ba_problem import eager, window_state
    tracker, graphs = _fresh_ba_graphs(monkeypatch)
    euroc, kitti = (_bench_rig(c) for c, _ in BA_CELLS)
    keys = [(euroc, 4608, 6, 1024), (kitti, 4608, 2, 1024),
            (euroc, 4608, 6, None), (euroc, 2304, 6, 1024),
            (kitti, 4608, 6, 1024)]

    def call(key, seed):
        rig, M, iters, K = key
        st = window_state(rig, M, seed=seed, device=dev)
        got = tracker.run_window_ba(st, rig, iters=iters, max_landmarks=K)
        return _ba_equal(got, eager(st, rig, iters=iters, max_landmarks=K))
    return graphs, keys, call


@pytest.mark.parametrize("keys", [_lm_keys, _ba_keys],
                         ids=["lm_refine", "ba_window"])
def test_graph_keys_and_bound(dev, monkeypatch, keys):
    """A new key (the LM's N, rig or iters; the BA's K, iters, store size
    or rig) captures a new graph; a key met again replays its graph; past
    `MAX_GRAPHS` keys the least recently used goes."""
    from front_end_tpu_torch.pipeline.cuda_graphs import MAX_GRAPHS
    graphs, keys, call = keys(monkeypatch, dev)
    seen = []
    for k, key in enumerate(keys):
        assert call(key, k)
        assert len(graphs) == min(k + 1, MAX_GRAPHS)
        seen.append(next(reversed(graphs.values())))
    assert len(set(map(id, seen))) == len(keys)
    # the first key went; the second, met again, replays its own graph
    assert call(keys[1], 9)
    assert next(reversed(graphs.values())) is seen[1]
    assert seen[0] not in graphs.values()
    assert len(graphs) == MAX_GRAPHS


@pytest.mark.parametrize("case", ["capture", "grad", "group"])
def test_ba_runs_eagerly_on_the_card_where_no_graph_serves(dev, monkeypatch,
                                                           tmp_path, case):
    """A call inside another capture, inputs that require grad and a
    process group (one gloo rank, its tensors on the card) run the eager
    body and capture nothing; a capture keeps no count.  The outer
    capture replays the eager kernels bit for bit; the differentiated
    solve may round otherwise, the group's sums go through the host."""
    import torch.distributed as dist
    from _window_ba_problem import eager, window_state
    from front_end_tpu_torch.pipeline import telemetry
    tracker, graphs = _fresh_ba_graphs(monkeypatch)
    rig = _bench_rig("euroc-mh01-window-surfext")
    st = window_state(rig, 4608, seed=3, device=dev)
    ref = eager(st, rig, iters=6, max_landmarks=1024)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager(st, rig, iters=6, max_landmarks=1024)
    with telemetry.recording() as rec:
        if case == "capture":
            outer = torch.cuda.CUDAGraph()
            with torch.cuda.graph(outer, stream=side):
                got = tracker.run_window_ba(st, rig, iters=6,
                                            max_landmarks=1024)
            outer.replay()
            torch.cuda.synchronize()
            assert _ba_equal(got, ref)
        elif case == "grad":
            Xw = st.store.Xw.clone().requires_grad_(True)
            state, res = tracker.run_window_ba(
                st._replace(store=st.store._replace(Xw=Xw)), rig, iters=6,
                max_landmarks=1024)
            res.cost.backward()
            assert bool(torch.isfinite(Xw.grad).all())
            assert torch.allclose(state.poses.detach(), ref[1].poses,
                                  atol=1e-5)
        else:
            dist.init_process_group("gloo",
                                    init_method=f"file://{tmp_path}/s",
                                    world_size=1, rank=0)
            try:
                state, res = tracker.run_window_ba(
                    st, rig, iters=6, max_landmarks=1024,
                    group=dist.group.WORLD)
            finally:
                dist.destroy_process_group()
            assert torch.allclose(state.poses, ref[1].poses, atol=1e-5)
    c = rec.counters()
    assert not graphs
    if case == "capture":
        assert c == {}
    else:
        assert [v for _, v in c["ba.graph"]] == [0.0]
        assert len(c["ba.accepted"]) == 6

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

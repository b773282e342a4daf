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

from front_end_tpu_torch.ops import brief as tbrief
from front_end_tpu_torch.ops import fast as tfast
from front_end_tpu_torch.ops.kernels import (brief_planes, fast_detect,
                                             fast_grid, fast_margins,
                                             match_reduce)
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

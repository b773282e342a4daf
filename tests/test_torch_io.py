"""The port's I/O layer against the JAX package's: the KITTI and EuRoC
loaders, the PNG decoder used where PIL is missing, rectification, the
device feed and the native feed.

Loaders: rig fields, images, poses and ground truth equal exactly (the
port's frames are the files' uint8 values, JAX's the same values as
float32).  Rectification maps equal exactly (the same float64 numpy);
the remap within REMAP_TOL of JAX's (float32 bilinear weights summed in
another order: measured 3.1e-5 on the EuRoC fixture, 4.6e-5 on random
752×480 maps, 2-3 ulp at 255).
"""
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.io import euroc as jeuroc
from front_end_tpu.io import kitti as jkitti
from front_end_tpu.io import rectify as jrect
from front_end_tpu_torch.io import euroc, kitti, rectify
from front_end_tpu_torch.io.feed import DeviceFeed
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import vo
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.utils import png
from torch_parity import (n, pan_poses, rig_fields, write_euroc,
                          write_kitti)

REMAP_TOL = 1e-4     # grey levels in [0, 255]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    L, R = make_sequence(4, 64, 96)
    write_kitti(root, L, R, fx=150.0, baseline=0.3,
                poses=pan_poses(4, 0.3), seq="03")
    return root, L, R


@pytest.fixture(scope="module")
def euroc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc"))
    gt = write_euroc(root, 3)
    return root, gt


def test_kitti_sequence_equals_jax(kitti_root):
    root, L, R = kitti_root
    ts = kitti.KittiSequence(root, "03")
    js = jkitti.KittiSequence(root, "03")
    assert rig_fields(ts.rig) == rig_fields(js.rig)
    np.testing.assert_array_equal(ts.poses, js.poses)
    assert len(ts) == len(js) == 4
    for i in range(4):
        (tl, tr), (jl, jr) = ts[i], js[i]
        assert tl.dtype == np.uint8
        np.testing.assert_array_equal(tl.astype(np.float32), jl)
        np.testing.assert_array_equal(tr.astype(np.float32), jr)
        np.testing.assert_array_equal(tl, L[i])


def test_kitti_missing_sequence_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        kitti.KittiSequence(str(tmp_path), "00")


def _png_filtered(img, filters):
    """An 8-bit PNG of `img` (H, W[, C]) whose row y uses filter
    filters[y % len(filters)] (the PNG spec's five)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, c))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_decode_equals_pil(channels, filters):
    from PIL import Image
    rs = np.random.RandomState(len(filters) * 10 + channels)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    data = _png_filtered(img, filters)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(png.decode(data), ref)


def test_png_decode_reads_matplotlib_rgba_files(tmp_path):
    """The JAX EuRoC fixture's files (`tests/test_euroc_format.py`):
    RGBA written by matplotlib."""
    import matplotlib.pyplot as plt
    from PIL import Image
    g = np.random.RandomState(3).randint(0, 256, (24, 40)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    plt.imsave(path, np.stack([g, g, g], -1))
    ref = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(png.read(path), ref)
    np.testing.assert_array_equal(png.read(path), g)


def test_png_decode_refuses_other_pngs():
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(b, "PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode(b.getvalue())


def test_read_image_without_pil(kitti_root, monkeypatch, tmp_path):
    """The loader's fallback where PIL cannot be imported: the port's PNG
    decoder, and PGM, give the files' values."""
    root, L, _ = kitti_root
    path = os.path.join(root, "sequences", "03", "image_0", "000001.png")
    with_pil = kitti._read_image(path)
    pgm = str(tmp_path / "f.pgm")
    with open(pgm, "wb") as f:
        f.write(b"P5\n# c\n96 64\n255\n" + L[2].astype(np.uint8).tobytes())
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(kitti._read_image(path), with_pil)
    np.testing.assert_array_equal(kitti._read_image(path), L[1])
    np.testing.assert_array_equal(kitti._read_image(pgm), L[2])


_YAML = """# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


@pytest.mark.parametrize("which", ["euroc_file", "fixture_cam1", "missing"])
def test_read_sensor_yaml_equals_jax(which, euroc_root, tmp_path):
    root, _ = euroc_root
    path = {"euroc_file": str(tmp_path / "sensor.yaml"),
            "fixture_cam1": os.path.join(root, "V9_99_synth", "mav0", "cam1",
                                         "sensor.yaml"),
            "missing": str(tmp_path / "none.yaml")}[which]
    if which == "euroc_file":
        with open(path, "w") as f:
            f.write(_YAML)
    a, b = euroc.read_sensor_yaml(path), jeuroc.read_sensor_yaml(path)
    assert a.keys() == b.keys() and a["size"] == b["size"]
    for k in ("K", "D", "T_BS"):
        np.testing.assert_array_equal(a[k], b[k])


def test_euroc_sequence_equals_jax(euroc_root):
    root, gt = euroc_root
    seq_dir = os.path.join(root, "V9_99_synth")
    assert rig_fields(euroc.load_rig(seq_dir)) == rig_fields(
        jeuroc.load_rig(seq_dir))
    ts = euroc.EurocSequence(root, "V9_99_synth", rectify=False)
    js = jeuroc.EurocSequence(root, "V9_99_synth", rectify=False)
    assert ts.names == js.names and len(ts) == 3
    for i in range(3):
        for a, b in zip(ts[i], js[i]):
            np.testing.assert_array_equal(a.astype(np.float32), b)
    (t_ts, t_pos), (j_ts, j_pos) = ts.ground_truth(), js.ground_truth()
    np.testing.assert_array_equal(t_ts, j_ts)
    np.testing.assert_array_equal(t_pos, j_pos)
    np.testing.assert_allclose(t_pos, gt[:, :3, 3], atol=1e-12)


def test_rectifier_maps_equal_jax_and_remap_within_tolerance(euroc_root):
    root, _ = euroc_root
    seq_dir = os.path.join(root, "V9_99_synth")
    tr = euroc.build_rectifier(seq_dir, device="cpu")
    jr = jeuroc.build_rectifier(seq_dir)
    for k in ("R0", "R1", "K_new"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))
    assert tr.baseline == jr.baseline
    assert rig_fields(tr.rig()) == rig_fields(jr.rig())
    for tm, jm in ((tr.map0, jr.map0), (tr.map1, jr.map1)):
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(n(a), b)
    seq = euroc.EurocSequence(root, "V9_99_synth", rectify=False)
    l, r = seq[1]
    (tl, trr), (jl, jrr) = tr(l, r), jr(l, r)
    err = max(float(np.abs(n(tl) - np.asarray(jl)).max()),
              float(np.abs(n(trr) - np.asarray(jrr)).max()))
    assert err <= REMAP_TOL, err
    assert tl.dtype == torch.float32 and tl.shape == (192, 256)


def test_remap_bilinear_edges_equal_jax():
    """Out-of-bounds samples are 0, the last row and column clamp."""
    rs = np.random.RandomState(2)
    img = rs.uniform(0, 255, (9, 11)).astype(np.float32)
    mx = rs.uniform(-1.5, 11.5, (7, 8)).astype(np.float32)
    my = rs.uniform(-1.5, 9.5, (7, 8)).astype(np.float32)
    mx[0, :3] = [0.0, 10.0, 10.0]
    my[0, :3] = [0.0, 8.0, 8.25]
    got = rectify.remap_bilinear(img, torch.from_numpy(mx),
                                 torch.from_numpy(my))
    ref = jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                               jnp.asarray(my))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0,
                               atol=REMAP_TOL)
    assert float(got[0, 2]) == 0.0 and float(got[0, 1]) == img[8, 10]


def test_port_tracks_on_the_pitched_euroc_pair_only_once_rectified(
        euroc_root):
    """The 2°-pitched pair (`tests/test_euroc_format.py`, 256×192): the
    port's VO finds stereo matches on every rectified frame and tracks
    across them; on the raw pair stereo collapses."""
    root, _ = euroc_root
    cfg = vo.VOConfig(
        grid=grid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=128,
                             set_point=700, init_threshold=12.0),
        desc_bytes=32, ransac_hyps=64, ransac_threshold=0.12,
        max_disparity=60.0, min_track_inliers=10)

    def run(rectify_):
        seq = euroc.EurocSequence(root, "V9_99_synth", rectify=rectify_,
                                  device="cpu")
        assert seq.rig.width == 256 and seq.rig.height == 192
        state = vo.init_state(seq.rig, cfg, device="cpu")
        outs = []
        for l, r in seq.frames():
            state, o = vo.vo_step(state, l, r, seq.rig, cfg)
            outs.append(o)
        return outs

    rect, raw = run(True), run(False)
    n_rect = [int(o.n_stereo) for o in rect]
    n_raw = [int(o.n_stereo) for o in raw]
    assert min(n_rect) > 50, n_rect
    assert min(n_rect) > 1.5 * max(n_raw), (n_rect, n_raw)
    assert all(bool(o.motion_ok) for o in rect), [int(o.n_inliers)
                                                  for o in rect]
    assert int(rect[-1].n_inliers) >= 10


def _frames(k, dtype=np.uint8):
    return [(np.full((6, 8), i, dtype), np.full((6, 8), i + 100, dtype))
            for i in range(k)]


@pytest.mark.parametrize("threaded", [True, False])
def test_device_feed_order_and_dtype(threaded):
    got = list(DeviceFeed(iter(_frames(5)), depth=2, device="cpu",
                          threaded=threaded))
    assert len(got) == 5
    for i, (l, r) in enumerate(got):
        assert l.dtype == torch.uint8 and l.device.type == "cpu"
        assert int(l[0, 0]) == i and int(r[0, 0]) == i + 100


def test_device_feed_converts_dtype_and_copies_views():
    """`dtype` converts on the host; a frame is copied before the
    upstream is asked for the next one, so a reused buffer is safe."""
    buf = np.zeros((6, 8), np.uint8)

    def reused():
        for i in range(4):
            buf[:] = i
            yield buf, buf

    got = list(DeviceFeed(reused(), depth=2, device="cpu", threaded=False))
    assert [int(l[0, 0]) for l, _ in got] == [0, 1, 2, 3]
    f32 = list(DeviceFeed(iter(_frames(2)), device="cpu",
                          dtype=np.float32))
    assert f32[1][0].dtype == torch.float32 and float(f32[1][1][0, 0]) == 101


@pytest.mark.parametrize("threaded", [True, False])
def test_device_feed_propagates_errors(threaded):
    def bad():
        yield np.zeros((4, 4), np.uint8), np.zeros((4, 4), np.uint8)
        raise RuntimeError("decode failed")

    it = DeviceFeed(bad(), depth=2, device="cpu", threaded=threaded)
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_device_feed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        DeviceFeed(iter([]))


# ---- the native feed: csrc/feed.cc built by the port's helper ----------

@pytest.fixture
def native_feed():
    from front_end_tpu_torch.io import native_feed as nf
    if not nf.available():
        pytest.skip("g++ or libpng unavailable: the native feed cannot be "
                    "built here")
    return nf.NativeStereoFeed


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n# comment line\n%d %d\n255\n"
                % (img.shape[1], img.shape[0]) + img.tobytes())


def _imgs(k, h, w, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (h, w)).astype(np.uint8) for _ in range(k)]


def test_native_feed_pgm_order(native_feed, tmp_path):
    h, w, k = 24, 32, 20
    ls, rs = _imgs(k, h, w, 0), _imgs(k, h, w, 1)
    lp = [str(tmp_path / f"l{i:03d}.pgm") for i in range(k)]
    rp = [str(tmp_path / f"r{i:03d}.pgm") for i in range(k)]
    for i in range(k):
        _write_pgm(lp[i], ls[i])
        _write_pgm(rp[i], rs[i])
    # many threads + a tiny ring stress the ordered consumption
    with native_feed(lp, rp, h, w, ring=3, threads=6) as feed:
        got = list(feed)
    assert len(got) == k
    for i, (l, r) in enumerate(got):
        np.testing.assert_array_equal(l, ls[i])
        np.testing.assert_array_equal(r, rs[i])


def test_native_feed_png_and_raw(native_feed, tmp_path):
    h, w = 16, 20
    img_l, img_r = _imgs(2, h, w, 2)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.raw")
    png.write(lp, img_l)
    with open(rp, "wb") as f:
        f.write(img_r.tobytes())
    with native_feed([lp], [rp], h, w) as feed:
        frames = list(feed)
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0][0], img_l)
    np.testing.assert_array_equal(frames[0][1], img_r)


def test_native_feed_zero_copy_through_the_device_feed(native_feed,
                                                       kitti_root):
    """The KITTI fixture's PNGs through the native decoder's ring views and
    a depth-2 `DeviceFeed`: every frame equal to the loader's."""
    root, L, R = kitti_root
    seq = kitti.KittiSequence(root, "03")
    with native_feed(*seq.paths(), 64, 96, ring=2, threads=2) as feed:
        got = list(DeviceFeed(feed.frames_zero_copy(), depth=2,
                              device="cpu"))
    assert len(got) == 4
    for i, (l, r) in enumerate(got):
        np.testing.assert_array_equal(n(l), L[i])
        np.testing.assert_array_equal(n(r), R[i])


def test_native_feed_missing_file_raises(native_feed, tmp_path):
    img = _imgs(1, 8, 8, 3)[0]
    good, bad = str(tmp_path / "g.pgm"), str(tmp_path / "nope.pgm")
    _write_pgm(good, img)
    with native_feed([good, bad], [good, good], 8, 8) as feed:
        with pytest.raises(RuntimeError, match="native feed"):
            list(feed)


def test_native_feed_size_mismatch_raises(native_feed, tmp_path):
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, _imgs(1, 8, 8, 4)[0])
    with native_feed([p], [p], 16, 16) as feed:
        with pytest.raises(RuntimeError, match="mismatch"):
            list(feed)

"""The port's trajectory metrics (`eval/metrics.py`, float64 on the CPU)
against the JAX package's within 1e-5; its debug canvases (`viz/draw.py`)
equal to JAX's pixel for pixel; its PNG writer read back by PIL.

The JAX metrics run on the same float64 inputs under `jax.enable_x64`:
at float32 JAX's arccos of a near-identity relative rotation is itself
off by 0.005° (RPE 0.0239° against 0.0188° on a trajectory whose
relative rotations are exact), so the float64 run is the reference the
port's float64 evaluation is held to.
"""
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from front_end_tpu import types as jtypes
from front_end_tpu.eval import metrics as jmetrics
from front_end_tpu.geometry import se3 as jse3
from front_end_tpu.viz import draw as jdraw
from front_end_tpu_torch import types as ttypes
from front_end_tpu_torch.eval import metrics
from front_end_tpu_torch.utils import png
from front_end_tpu_torch.viz import draw
from torch_parity import image, kps_to_jax, n, t

TOL = 1e-5


def _trajectory(k=12, seed=0):
    """(est, gt) float64 world_T_camera poses: a curved walk, and an
    estimate of it in another frame with noise on every pose."""
    rs = np.random.RandomState(seed)

    def exp(xi):
        return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)),
                          np.float64)

    gt = np.stack([exp([0.02 * np.sin(i / 3), 0.01 * i, 0.3 * i,
                        0.01 * np.cos(i / 2), 0.05 * i, 0.0])
                   for i in range(k)])
    off = exp([0.5, -0.2, 0.1, 0.05, -0.1, 0.2])
    noise = np.stack([exp(np.concatenate([rs.normal(0, 0.02, 3),
                                          rs.normal(0, 0.01, 3)]))
                      for _ in range(k)])
    return off @ gt @ noise, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_align_trajectories_equals_jax(with_scale):
    est, gt = _trajectory()
    a, H, s = metrics.align_trajectories(est[:, :3, 3] * 1.3, gt[:, :3, 3],
                                         with_scale)
    with jax.enable_x64(True):
        ja, jH, js = jmetrics.align_trajectories(est[:, :3, 3] * 1.3,
                                                 gt[:, :3, 3], with_scale)
    np.testing.assert_allclose(n(a), np.asarray(ja), atol=TOL)
    np.testing.assert_allclose(n(H), np.asarray(jH), atol=TOL)
    assert abs(s - float(js)) <= TOL


@pytest.mark.parametrize("align,with_scale", [(True, False), (True, True),
                                              (False, False)])
def test_ate_rmse_equals_jax(align, with_scale):
    est, gt = _trajectory(seed=1)
    got = metrics.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align, with_scale)
    with jax.enable_x64(True):
        ref = jmetrics.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align,
                                with_scale)
    assert abs(got - ref) <= TOL, (got, ref)
    # tensors on any device are accepted
    assert metrics.ate_rmse(t(est[:, :3, 3]), t(gt[:, :3, 3]), align,
                            with_scale) == got


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_equals_jax(delta):
    est, gt = _trajectory(seed=2)
    got = metrics.rpe(est, gt, delta)
    with jax.enable_x64(True):
        ref = jmetrics.rpe(est, gt, delta)
    assert got.keys() == ref.keys()
    for k in got:
        assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])


def test_poses_from_motions_equals_jax():
    est, _ = _trajectory(seed=3)
    motions = np.stack([np.linalg.inv(est[i + 1]) @ est[i]
                        for i in range(len(est) - 1)])
    got = metrics.poses_from_motions(motions)
    with jax.enable_x64(True):
        ref = jmetrics.poses_from_motions(motions)
    assert got.shape == ref.shape == (len(est), 4, 4)
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_scaling_efficiency_equals_jax():
    th = {1: 100.0, 2: 190.0, 4: 360.0, 8: 640.0}
    assert metrics.scaling_efficiency(th) == jmetrics.scaling_efficiency(th)


# ---- debug canvases -----------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rs = np.random.RandomState(5)
    h, w, k = 40, 56, 24
    left, right = image(h, w, seed=1), image(h, w, seed=2)
    xy_l = rs.uniform(-3, w + 3, (k, 2)).astype(np.float32)
    xy_r = (xy_l - [rs.uniform(0, 9), 0]).astype(np.float32)
    valid = rs.rand(k) < 0.7
    kl = ttypes.Keypoints(xy=t(xy_l), score=torch.ones(k),
                          angle=torch.zeros(k), valid=t(valid))
    kr = ttypes.Keypoints(xy=t(xy_r), score=torch.ones(k),
                          angle=torch.zeros(k), valid=t(valid))
    m = ttypes.Matches(train_idx=t(rs.permutation(k)),
                       distance=torch.zeros(k), valid=t(rs.rand(k) < 0.6))
    return dict(left=left, right=right, kl=kl, kr=kr, m=m,
                uv4=np.concatenate([xy_l, xy_r], 1), valid=valid,
                inl=rs.rand(k) < 0.5)


def _jm(m):
    return jtypes.Matches(train_idx=jnp.asarray(n(m.train_idx)),
                          distance=jnp.asarray(n(m.distance)),
                          valid=jnp.asarray(n(m.valid)))


@pytest.mark.parametrize("which", ["keypoints", "matches", "stereo_uv4",
                                   "anaglyph", "tracks"])
def test_draw_canvases_equal_jax(which, scene):
    s = scene
    if which == "keypoints":
        got = draw.draw_keypoints(t(s["left"]), s["kl"])
        ref = jdraw.draw_keypoints(s["left"], kps_to_jax(s["kl"]))
    elif which == "matches":
        got = draw.draw_matches(t(s["left"]), s["kl"], t(s["right"]),
                                s["kr"], s["m"])
        ref = jdraw.draw_matches(s["left"], kps_to_jax(s["kl"]),
                                 s["right"], kps_to_jax(s["kr"]),
                                 _jm(s["m"]))
    elif which == "stereo_uv4":
        got = draw.draw_stereo_uv4(t(s["left"]), t(s["right"]),
                                   t(s["uv4"]), t(s["valid"]))
        ref = jdraw.draw_stereo_uv4(s["left"], s["right"], s["uv4"],
                                    s["valid"])
    elif which == "anaglyph":
        got = draw.anaglyph(t(s["left"]), t(s["right"]))
        ref = jdraw.anaglyph(s["left"], s["right"])
    else:
        canvas = draw.anaglyph(s["left"], s["right"])
        got = draw.draw_tracks(canvas, t(s["uv4"][:, 2:]),
                               t(s["uv4"][:, :2]), t(s["inl"]),
                               t(s["valid"]))
        ref = jdraw.draw_tracks(canvas, s["uv4"][:, 2:], s["uv4"][:, :2],
                                s["inl"], s["valid"])
    assert got.dtype == np.uint8 and got.ndim == 3
    np.testing.assert_array_equal(got, np.asarray(ref))
    if which != "anaglyph":      # something was drawn
        assert ((got == draw.GREEN).all(-1) | (got == draw.RED).all(-1)).any()


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3)])
def test_png_writer_read_back_by_pil(shape, tmp_path):
    from PIL import Image
    img = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    png.write(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(png.encode(img)))), img)
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 2), np.uint8))

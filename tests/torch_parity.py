"""Helpers for the parity tests of the PyTorch port against the JAX package.

Data crosses between the two packages as numpy arrays only.
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

import jax.numpy as jnp

from front_end_tpu import types as jtypes
from front_end_tpu_torch import types as ttypes

# The suite runs in several pytest workers on one host.  A torch thread
# pool per worker oversubscribes the cores, and at these small shapes the
# spinning pool threads cost far more than they save (a 0.5 s test took
# over a minute under six workers), so each worker keeps one thread.
torch.set_num_threads(1)


def image(h=180, w=300, seed=0, block=6):
    """Blocky integer-valued texture with per-pixel noise: many FAST
    corners, no score plateaus (the JAX kernel tests' generator, rounded
    so the box-blur sums are exact in any order).  `block=1` gives
    per-pixel noise, whose isolated extrema are what the 8-point circle
    (which needs all 8 neighbours on one side) detects."""
    rs = np.random.RandomState(seed)
    img = np.kron(rs.uniform(0, 255, (h // block + 1, w // block + 1)),
                  np.ones((block, block)))[:h, :w]
    img = img + rs.uniform(0, 2, img.shape)
    return np.round(img).astype(np.float32)


def run_main(main, argv) -> str:
    """A script's `main(argv)` in this process -> what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def t(a, dtype=None):
    """JAX/numpy array -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kps_to_torch(k: jtypes.Keypoints) -> ttypes.Keypoints:
    return ttypes.Keypoints(xy=t(k.xy), score=t(k.score), angle=t(k.angle),
                            valid=t(k.valid))


def kps_to_jax(k: ttypes.Keypoints) -> jtypes.Keypoints:
    return jtypes.Keypoints(xy=jnp.asarray(n(k.xy)),
                            score=jnp.asarray(n(k.score)),
                            angle=jnp.asarray(n(k.angle)),
                            valid=jnp.asarray(n(k.valid)))


def state_fields(s) -> dict:
    """A JAX `VOState` in the layout `interop.from_jax` takes."""
    p = s.prev
    return dict(
        thresholds_l=n(s.thresholds_l), thresholds_r=n(s.thresholds_r),
        pose=n(s.pose), frame_idx=int(s.frame_idx),
        prev=dict(kps=dict(xy=n(p.kps.xy), score=n(p.kps.score),
                           angle=n(p.kps.angle), valid=n(p.kps.valid)),
                  bits=n(p.bits), X=n(p.X), stereo_valid=n(p.stereo_valid),
                  uv4=n(p.uv4)))


def rig_fields(rig) -> dict:
    return {k: (v if k in ("width", "height") else float(v))
            for k, v in ((k, getattr(rig, k)) for k in
                         ("fx", "fy", "cx", "cy", "baseline", "width",
                          "height"))}


def assert_matches_equal(a, b, min_valid=1):
    """Same valid mask; same train index and distance on valid rows (the
    train index of an invalid row is garbage in both packages)."""
    av, bv = n(a.valid), n(b.valid)
    np.testing.assert_array_equal(av, bv)
    assert av.sum() >= min_valid, "vacuous comparison (no matches)"
    np.testing.assert_array_equal(n(a.train_idx)[av], n(b.train_idx)[bv])
    np.testing.assert_array_equal(n(a.distance)[av], n(b.distance)[bv])


# ---- dataset fixtures on disk, written with the port's PNG encoder ------

def write_kitti(root, lefts, rights, *, fx, baseline, poses=None, seq="00"):
    """A KITTI odometry layout under `root`: sequences/<seq>/image_{0,1}
    PNGs, calib.txt (P0, P1), and poses/<seq>.txt if `poses` is given."""
    import os

    from front_end_tpu_torch.utils import png
    sd = os.path.join(root, "sequences", seq)
    for cam, imgs in (("image_0", lefts), ("image_1", rights)):
        os.makedirs(os.path.join(sd, cam), exist_ok=True)
        for i, im in enumerate(imgs):
            png.write(os.path.join(sd, cam, f"{i:06d}.png"),
                      np.clip(np.round(im), 0, 255).astype(np.uint8))
    h, w = np.shape(lefts[0])
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    with open(os.path.join(sd, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * baseline} 0 {fx} {cy} 0 0 0 1 0\n")
    if poses is not None:
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        np.savetxt(os.path.join(root, "poses", f"{seq}.txt"),
                   np.asarray(poses)[:, :3, :].reshape(len(poses), 12))
    return root


def pan_poses(n, baseline, disp=12, shift=3):
    """The known motion of `make_sequence`: +x by shift / disp baselines a
    frame, no rotation."""
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 0, 3] = np.arange(n) * shift * baseline / disp
    return T


EUROC_FX, EUROC_CX, EUROC_CY = 200.0, 127.5, 95.5
EUROC_W, EUROC_H, EUROC_BASELINE = 256, 192, 0.11


def euroc_cam1_T_body(tilt_deg=2.0):
    """body (= cam0) <- cam1: +x baseline and a pitch that shifts the
    epipolar rows by ~fx tan(tilt) px (`tests/test_euroc_format.py`)."""
    a = np.deg2rad(tilt_deg)
    T = np.eye(4)
    T[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                 [0, np.sin(a), np.cos(a)]]
    T[0, 3] = EUROC_BASELINE
    return T


def write_euroc(root, n_frames, seq="V9_99_synth", rgb=True):
    """An ASL layout whose cam1 is pitched 2°, rendered from the corridor
    (`tests/test_euroc_format.py`'s fixture with the port's renderer and
    PNG encoder; RGB files by default, as matplotlib writes them there).
    Returns the world_T_camera ground truth."""
    import os

    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.sim import render
    from front_end_tpu_torch.utils import png

    rig = StereoRig.create(fx=EUROC_FX, cx=EUROC_CX, cy=EUROC_CY,
                           baseline=EUROC_BASELINE, width=EUROC_W,
                           height=EUROC_H)
    scene = render.corridor_scene(np.random.RandomState(13), tex_size=256)
    gt = render.corridor_trajectory(n_frames)
    T1 = euroc_cam1_T_body()
    mav = os.path.join(root, seq, "mav0")
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"))
    for i in range(n_frames):
        ts = 1403636579763555584 + i * 50000000
        for cam, T in (("cam0", gt[i]), ("cam1", gt[i] @ T1)):
            g = render.render_view(scene, rig, T).astype(np.uint8)
            png.write(os.path.join(mav, cam, "data", f"{ts}.png"),
                      np.stack([g, g, g], -1) if rgb else g)
    for cam, T in (("cam0", np.eye(4)), ("cam1", T1)):
        rows = ", ".join(str(float(x)) for x in T.ravel())
        with open(os.path.join(mav, cam, "sensor.yaml"), "w") as f:
            f.write(f"sensor_type: camera\n"
                    f"intrinsics: [{EUROC_FX}, {EUROC_FX}, {EUROC_CX}, "
                    f"{EUROC_CY}]\n"
                    f"resolution: [{EUROC_W}, {EUROC_H}]\n"
                    "distortion_model: radial-tangential\n"
                    "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
                    f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{rows}]\n")
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        for i in range(n_frames):
            p = gt[i, :3, 3]
            f.write(f"{1403636579763555584 + i * 50000000},"
                    f"{p[0]},{p[1]},{p[2]}\n")
    return gt

"""Monte-Carlo estimator study: the operating curves (counterpart of
`front_end_tpu/analysis/sweeps.py`).

For every (motion speed × landmark curve × noise level × outlier
fraction) condition, the motion estimators run on synthetic worlds of
known motion and their errors are recorded: PCL (3-point rigid RANSAC),
Nister (essential RANSAC with the stereo scale), BA (the LM polish from
the identity) and WindowBA (the Schur BA over a W-frame window, the
newest pose reset to the previous one).

A condition is one batch of worlds: the worlds and the minimal sets are
drawn up front from the condition's `torch.Generator` (`draw_condition`,
world by world, on the host), then each method runs as ONE
`torch.func.vmap` of its estimator over the world axis
(`estimate_condition`), the sampler returning the pre-drawn sets.
Results land in one `.npz` per condition, named as the JAX package names
them, and a condition whose file exists is skipped (resume).

The JAX package seeds a condition with `hash(name) % 2**31`, which Python
salts per process; the port seeds from `zlib.crc32` of the seed and the
name, the same in every run (`condition_seed`).
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch
from torch.func import vmap

from front_end_tpu_torch.ba import schur
from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig, bumblebee_rig
from front_end_tpu_torch.motion import essential, lm, ransac
from front_end_tpu_torch.sim import synthetic as sim
from front_end_tpu_torch.utils.precision import f32_precision, resolve_device

SPEEDS = ("slow", "medium", "fast")
EXTRACTORS = ("PCL", "Nister", "BA", "WindowBA")
# minimal sets per world: (hypotheses, set size) of each RANSAC's defaults
MINIMAL_SETS = {"PCL": (512, 3), "Nister": (256, 8)}


def condition_name(method: str, speed: str, n_points: int, noise: float,
                   frac: float) -> str:
    return f"{method}_{speed}_{n_points:05d}_n{noise:g}_o{frac:g}.npz"


def condition_seed(seed: int, name: str) -> int:
    return zlib.crc32(f"{seed}:{name}".encode())


def draw_condition(gen: torch.Generator, method: str, rig: StereoRig, cat,
                   n_points: int, noise_px: float, outlier_frac: float,
                   batch: int):
    """The condition's worlds, noisy and contaminated (a zero level applies
    nothing), and the minimal sets of its RANSAC: (StereoWorld with a
    leading batch axis, (batch, hypotheses, k) row indices or None)."""
    worlds = []
    for _ in range(batch):
        w = sim.sample_world(gen, rig, cat, n_points)
        if noise_px > 0:
            w = sim.add_gaussian_noise(gen, w, rig, noise_px)
        if outlier_frac > 0:
            w = sim.add_outliers(gen, w, rig, outlier_frac)[0]
        worlds.append(w)
    worlds = sim.StereoWorld(*(torch.stack(f) for f in zip(*worlds)))
    sets = None
    if method in MINIMAL_SETS:
        n_hyps, k = MINIMAL_SETS[method]
        u = torch.rand((batch, n_hyps, k), generator=gen,
                       dtype=torch.float64)
        sets = vmap(ransac.inverse_cdf)(worlds.valid, u)
    return worlds, sets


def draw_window_condition(gen: torch.Generator, rig: StereoRig, cat,
                          n_points: int, noise_px: float,
                          outlier_frac: float, batch: int,
                          window: int = 3) -> sim.WindowWorld:
    """The WindowBA condition's windows, stacked on a leading batch axis."""
    out = []
    for _ in range(batch):
        ww = sim.sample_window_world(gen, rig, cat, n_points, window)
        if noise_px > 0:
            ww = sim.window_add_noise(gen, ww, noise_px)
        if outlier_frac > 0:
            ww = sim.window_add_outliers(gen, ww, rig, outlier_frac)[0]
        out.append(ww)
    return sim.WindowWorld(*(torch.stack(f) for f in zip(*out)))


def _errors(H, Ht):
    """Per-world rotation error (degrees) and translation error (m)."""
    ang = se3.rotation_geodesic_error(H[..., :3, :3], Ht[..., :3, :3])
    return (torch.rad2deg(ang),
            torch.linalg.norm(H[..., :3, 3] - Ht[..., :3, 3], dim=-1))


@f32_precision
def estimate_motion(method: str, worlds: sim.StereoWorld, sets,
                    rig: StereoRig, threshold: float = 0.08):
    """One method over a batch of worlds, one vmapped call: the estimated
    motions (batch, 4, 4) and their consensus counts (batch,)."""
    if method == "PCL":
        def one(w, idx):
            res = ransac.rigid_ransac(lambda valid, n, k: idx, w.Xa, w.Xb,
                                      w.valid, threshold=threshold)
            return res.H, res.n_inliers
    elif method == "Nister":
        def one(w, idx):
            res = essential.essential_scaled_motion(
                lambda valid, n, k: idx, w.uva, w.uvb, w.Xa, w.Xb, w.valid,
                rig, threshold_px=3.0)
            return res.H, res.n_inliers
    elif method == "BA":
        def one(w, idx):
            eye = torch.eye(4, device=w.Xa.device)
            res = lm.refine_motion(eye, w.Xa, w.uvb, w.valid, rig, iters=25,
                                   huber_px=3.0)
            return res.H, w.valid.sum()
    else:
        raise ValueError(method)
    return vmap(one, in_dims=(0, None if sets is None else 0))(worlds, sets)


def estimate_condition(method: str, worlds: sim.StereoWorld, sets,
                       rig: StereoRig, threshold: float = 0.08) -> dict:
    """Per-world errors of `estimate_motion`: {rot_err_deg, trans_err_m,
    n_inliers}, each (batch,)."""
    H, n_inl = estimate_motion(method, worlds, sets, rig, threshold)
    rot, trans = _errors(H, worlds.Ht)
    return {"rot_err_deg": rot, "trans_err_m": trans, "n_inliers": n_inl}


@f32_precision
def estimate_window_motion(ww: sim.WindowWorld, rig: StereoRig, *,
                           iters: int = 20, huber_px: float = 3.0):
    """The full-window BA over a batch of windows, one vmapped call: the
    poses already estimated keep their truth, the newest starts at the
    previous one (zero motion), the landmarks re-triangulate from the
    anchor frame's measurements.  The newest relative motion estimated and
    true (batch, 4, 4), the observation counts and the window rms
    (batch,)."""
    def one(w):
        poses0 = torch.cat([w.poses[:-1], w.poses[-2:-1]])
        X0 = rig.triangulate(w.meas[:, 0, :2], w.meas[:, 0, 2:])
        vis = w.vis & w.valid[:, None]
        res = schur.ba_solve(poses0, X0, w.meas, vis, rig, iters=iters,
                             huber_px=huber_px)
        rel_est = res.poses[-1] @ se3.invert_homog(res.poses[-2])
        rel_gt = w.poses[-1] @ se3.invert_homog(w.poses[-2])
        return rel_est, rel_gt, vis.sum(), res.rms_px

    return vmap(one)(ww)


def estimate_window_condition(ww: sim.WindowWorld, rig: StereoRig, *,
                              iters: int = 20,
                              huber_px: float = 3.0) -> dict:
    """Per-window errors of `estimate_window_motion`: {rot_err_deg,
    trans_err_m, n_inliers, window_rms_px}, each (batch,)."""
    rel_est, rel_gt, n_obs, rms = estimate_window_motion(
        ww, rig, iters=iters, huber_px=huber_px)
    rot, trans = _errors(rel_est, rel_gt)
    return {"rot_err_deg": rot, "trans_err_m": trans, "n_inliers": n_obs,
            "window_rms_px": rms}


def _on_devices(fn, devs, *batches) -> dict:
    """Split each batch (a NamedTuple of tensors, a tensor or None) along
    its first axis over `devs`, run `fn` on each part on its device (the
    launches of one card do not wait for another's), and concatenate the
    results on the host as numpy."""
    n = len(devs)

    def part(b, i):
        if b is None:
            return None
        if isinstance(b, tuple):
            return type(b)(*(part(f, i) for f in b))
        m = b.shape[0] // n
        return b[i * m:(i + 1) * m].to(devs[i], non_blocking=True)

    outs = [fn(*(part(b, i) for b in batches)) for i in range(n)]
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
            for k in outs[0]}


def _devices(device, devices: int | None) -> list[torch.device]:
    dev = resolve_device(device)
    if not devices or devices <= 1:
        return [dev]
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if have < devices:
        raise ValueError(f"need {devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(devices)]


def run_condition(gen: torch.Generator, method: str, rig: StereoRig,
                  speed: str, n_points: int, noise_px: float,
                  outlier_frac: float, batch: int = 64,
                  threshold: float = 0.08, devices: int | None = None,
                  device="cuda") -> dict:
    """Per-world motion errors of one condition: dict of (batch,) numpy
    arrays.  `devices` > 1 splits the world batch over that many cards
    (batch a multiple of it)."""
    devs = _devices(device, devices)
    worlds, sets = draw_condition(gen, method, rig,
                                  sim.motion_category(speed), n_points,
                                  noise_px, outlier_frac, batch)
    return _on_devices(lambda w, s: estimate_condition(method, w, s, rig,
                                                       threshold),
                       devs, worlds, sets)


def run_window_condition(gen: torch.Generator, rig: StereoRig, speed: str,
                         n_points: int, noise_px: float,
                         outlier_frac: float, *, window: int = 3,
                         batch: int = 64, iters: int = 20,
                         huber_px: float = 3.0, devices: int | None = None,
                         device="cuda") -> dict:
    devs = _devices(device, devices)
    ww = draw_window_condition(gen, rig, sim.motion_category(speed),
                               n_points, noise_px, outlier_frac, batch,
                               window)
    return _on_devices(lambda w: estimate_window_condition(
        w, rig, iters=iters, huber_px=huber_px), devs, ww)


def run_study(out_dir: str, *, methods=EXTRACTORS, speeds=SPEEDS,
              curves=sim.OPERATING_CURVES,
              noises=(0.0,) + sim.NOISE_LEVELS,
              outliers=(0.0,) + sim.OUTLIER_LEVELS, batch: int = 64,
              rig: StereoRig | None = None, seed: int = 0,
              ideal_only: bool = False, verbose: bool = True,
              devices: int | None = None, device="cuda") -> dict:
    """The full `extractMotion` grid, resumable: a condition whose `.npz`
    exists is skipped.  `devices` > 1 splits each condition's world batch
    over that many cards (the batch rounded up to a multiple of it)."""
    rig = rig or bumblebee_rig()
    os.makedirs(out_dir, exist_ok=True)
    if devices and devices > 1:
        _devices(device, devices)
        batch = -(-batch // devices) * devices
    if ideal_only:
        noises, outliers = (0.0,), (0.0,)
    done = ran = 0
    for method in methods:
        for speed in speeds:
            for n_points in curves:
                for noise in noises:
                    for frac in outliers:
                        name = condition_name(method, speed, int(n_points),
                                              noise, frac)
                        path = os.path.join(out_dir, name)
                        if os.path.exists(path):
                            done += 1
                            continue
                        gen = torch.Generator().manual_seed(
                            condition_seed(seed, name))
                        if method == "WindowBA":
                            res = run_window_condition(
                                gen, rig, speed, int(n_points), noise, frac,
                                batch=batch, devices=devices, device=device)
                        else:
                            res = run_condition(
                                gen, method, rig, speed, int(n_points),
                                noise, frac, batch=batch, devices=devices,
                                device=device)
                        np.savez(path, **res)
                        ran += 1
                        if verbose:
                            print(f"{name}: rot_med="
                                  f"{np.median(res['rot_err_deg']):.4f}deg "
                                  f"trans_med="
                                  f"{np.median(res['trans_err_m'])*1000:.2f}"
                                  "mm")
    return {"ran": ran, "skipped": done}


def load_study(out_dir: str) -> dict:
    """Every condition file aggregated into {method: {speed: {(points,
    noise, outlier fraction): {field: array}}}}."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".npz"):
            continue
        method, speed, pts, n, o = name[:-4].split("_")
        with np.load(os.path.join(out_dir, name)) as z:
            out.setdefault(method, {}).setdefault(speed, {})[
                (int(pts), float(n[1:]), float(o[1:]))] = {
                    k: z[k].copy() for k in z.files}
    return out

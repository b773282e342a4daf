"""Trajectory evaluation: ATE, RPE and scaling efficiency (counterpart of
`front_end_tpu/eval/metrics.py`).

- ATE: RMS position error after an optional SE(3) / Sim(3) alignment
  (Umeyama through the port's weighted Kabsch);
- RPE: relative pose error over a fixed frame delta (KITTI-style);
- scaling efficiency: throughput(N devices) / (N · throughput(1)).

These are host-side evaluations of whole trajectories: they compute in
float64 on the CPU whatever device the poses came from.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.motion import kabsch


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def align_trajectories(est_t, gt_t, with_scale: bool = False):
    """Umeyama alignment of (T, 3) estimated positions onto the ground
    truth.  Returns (aligned_est, H, scale)."""
    est_t, gt_t = _f64(est_t), _f64(gt_t)
    s = 1.0
    if with_scale:
        ce, cg = est_t.mean(0), gt_t.mean(0)
        s = float(torch.linalg.norm(gt_t - cg, dim=-1).sum()
                  / max(float(torch.linalg.norm(est_t - ce, dim=-1).sum()),
                        1e-12))
    H = kabsch.rigid_transform_3d(est_t * s, gt_t)
    return se3.transform_points(H, est_t * s), H, s


def ate_rmse(est_t, gt_t, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of positions, metres)."""
    est_t, gt_t = _f64(est_t), _f64(gt_t)
    if align:
        est_t, _, _ = align_trajectories(est_t, gt_t, with_scale)
    err = torch.linalg.norm(est_t - gt_t, dim=-1)
    return float(torch.sqrt((err ** 2).mean()))


def rpe(est_poses, gt_poses, delta: int = 1) -> dict:
    """Relative pose error over frame pairs (i, i + delta) of (T, 4, 4)
    world_T_camera poses: translational RMSE (m), rotational RMSE (deg)."""
    est, gt = _f64(est_poses), _f64(gt_poses)
    de = se3.invert_homog(est[:-delta]) @ est[delta:]
    dg = se3.invert_homog(gt[:-delta]) @ gt[delta:]
    rel = se3.invert_homog(dg) @ de
    t_err = torch.linalg.norm(rel[:, :3, 3], dim=-1)
    eye = torch.eye(3, dtype=torch.float64).expand(rel[:, :3, :3].shape)
    r_err = se3.rotation_geodesic_error(eye, rel[:, :3, :3])
    return {"trans_rmse_m": float(torch.sqrt((t_err ** 2).mean())),
            "rot_rmse_deg": math.degrees(
                float(torch.sqrt((r_err ** 2).mean())))}


def poses_from_motions(motions) -> np.ndarray:
    """Integrate (T, 4, 4) per-frame extrinsic maps prev -> cur into
    world_T_camera poses (pose 0 = identity)."""
    poses = [torch.eye(4, dtype=torch.float64)]
    for H in _f64(motions):
        poses.append(poses[-1] @ se3.invert_homog(H))
    return torch.stack(poses).numpy()


def scaling_efficiency(throughputs: dict[int, float]) -> dict[int, float]:
    """{n_devices: items/s} -> {n_devices: efficiency}, eff(1) = 1."""
    nmin = min(throughputs)
    base = throughputs[nmin]
    return {n: (v / (base * n / nmin)) for n, v in throughputs.items()}

"""What decides `correct`: the plain reference (`vobench/reference/`) run
over the same uint8 pairs in the same order from the same RANSAC seed,
and the program's frames of the window compared with it frame by frame.

Numbers compared, each against the limit its configuration file states
under `check` (`PERF.md` gives the readings each limit was set from):
  counts_mismatch  frames whose detection, stereo-match or inter-frame
                   track counts differ from the reference's (integer
                   stages, exact: limit 0)
  inliers_gap      the widest gap of the RANSAC consensus size
  tracked_gap      the widest gap of the tracker's associations (window)
  motion_gap_m     the widest gap between the program's and the
                   reference's frame-to-frame motion (translation, m),
                   read from the poses the program handed to the host
  motion_gap_deg   the same for the rotation (degrees)
  pixels_mismatch  frames whose pair, as the feed handed it to the step
                   (decoded from the files in the png cell), differs from
                   the rendered pair the reference reads (exact: limit 0)

The pixels are compared by a checksum taken on the card in the window:
the sum of each image's pixels times weights drawn from the seed, in
[1, 2**23).  Two pairs that differ anywhere give the same sum with a
chance of about 2**-23 per frame.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vobench import spec
from vobench.reference import precision as ref_precision

COUNTS = ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks")
NUMBERS = ("counts_mismatch", "inliers_gap", "tracked_gap", "motion_gap_m",
           "motion_gap_deg", "pixels_mismatch")
PIXEL_WEIGHT_BITS = 23      # 255 * weight stays inside int32


class Reference:
    """The configuration's entry in plain PyTorch
    (`vobench/reference/entries/<entry>.py`, found by name)."""

    def __init__(self, config: dict, device, root=spec.ROOT):
        self.device = torch.device(device)
        self.entry = config["entry"]
        self.mod = spec.load_reference_entry(self.entry, root)
        self.rig, self.cfg = self.mod.setup(config)

    def run(self, lefts, rights, order, seed: int):
        """Step over the pairs in `order` -> (poses (M, 4, 4) float64,
        {name: (M,) array} of the compared scalars)."""
        state = self.mod.init_state(self.rig, self.cfg, seed, self.device)
        poses, rows = [], []
        for i in order:
            left = torch.from_numpy(lefts[i]).to(self.device)
            right = torch.from_numpy(rights[i]).to(self.device)
            state, out = self.mod.step(state, left, right, self.rig,
                                       self.cfg)
            poses.append(self.mod.frame(out).pose)
            rows.append(torch.stack([v.to(torch.float64)
                                     for v in scalars(self.mod, out)]))
        poses = torch.stack(poses).cpu().numpy().astype(np.float64)
        vals = torch.stack(rows).cpu().numpy()
        return poses, {k: vals[:, j] for j, k in enumerate(fields(self.mod))}


def fields(entry) -> tuple:
    """The names of the per-frame scalars compared for an entry (port or
    reference): the frame's counts and inliers, then its `EXTRA`."""
    return COUNTS + ("n_inliers",) + tuple(entry.EXTRA)


def scalars(entry, out) -> list:
    """One frame's compared scalars as device tensors, in `fields` order,
    from an entry's step outputs."""
    f = entry.frame(out)
    return ([getattr(f, k) for k in COUNTS + ("n_inliers",)]
            + list(entry.extras(out)))


def _relative(poses: np.ndarray) -> np.ndarray:
    """Frame-to-frame motions pose[k-1]^-1 pose[k]; the first frame's is
    its pose."""
    out = np.empty_like(poses)
    out[0] = poses[0]
    out[1:] = np.linalg.inv(poses[:-1]) @ poses[1:]
    return out


def rotation_angle(T: np.ndarray) -> np.ndarray:
    """Angles (rad) of the rotations of (..., 4, 4) transforms, from the
    skew part and the trace together (arccos of the trace alone loses all
    digits near 0)."""
    R = T[..., :3, :3]
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arctan2(0.5 * np.linalg.norm(w, axis=-1),
                      0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1))


def gaps(prog_poses, prog: dict, ref_poses, ref: dict) -> dict:
    """The numbers compared, program against reference, over the frames
    both have."""
    m = min(len(prog_poses), len(ref_poses))
    d = np.linalg.inv(_relative(prog_poses[:m])) @ _relative(ref_poses[:m])
    out = {
        "counts_mismatch": float(sum(
            int(np.any([prog[k][j] != ref[k][j] for k in COUNTS]))
            for j in range(m))),
        "inliers_gap": float(np.max(np.abs(prog["n_inliers"][:m]
                                           - ref["n_inliers"][:m]))),
        "motion_gap_m": float(np.max(np.linalg.norm(d[:, :3, 3], axis=1))),
        "motion_gap_deg": float(np.degrees(np.max(rotation_angle(d)))),
    }
    if "n_tracked" in ref:
        out["tracked_gap"] = float(np.max(np.abs(
            prog["n_tracked"][:m] - ref["n_tracked"][:m])))
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: math.inf for k in out}
    return out


def pixel_weights(shape, seed: int, device) -> torch.Tensor:
    """(H, W) int32 weights of the pixel checksum, drawn from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 0x5eed) % (1 << 63))
    return torch.randint(1, 1 << PIXEL_WEIGHT_BITS, tuple(shape),
                         generator=gen, device=device, dtype=torch.int32)


def pixel_sums(weights: torch.Tensor, left, right) -> torch.Tensor:
    """(2,) int64 checksums of a fed pair, on its device (no copy)."""
    return (torch.stack((left, right)).to(torch.int32)
            * weights).sum((1, 2))


def pixels_mismatch(fed: np.ndarray, lefts, rights, order,
                    weights: torch.Tensor) -> float:
    """Frames whose fed checksums (M, 2) differ from those of the host
    pairs in `order`."""
    w = weights.cpu().numpy().astype(np.int64)
    sums = {i: (int((lefts[i] * w).sum()), int((rights[i] * w).sum()))
            for i in set(order[:len(fed)])}
    return float(sum(tuple(int(v) for v in fed[j]) != sums[i]
                     for j, i in enumerate(order[:len(fed)])))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number not finite fails."""
    table = {k: {"value": numbers[k], "limit": limits[k]}
             for k in NUMBERS if k in numbers}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table


def control(run):
    """Run `run()` with the reference's products in TF32."""
    with ref_precision.control():
        return run()

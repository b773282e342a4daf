"""Live windowed VO: frame step + sliding-window tracking + windowed BA
(counterpart of `front_end_tpu/pipeline/window_vo.py`).

Per frame:
  1. the plain VO frame step (detect / describe / match / triangulate /
     motion);
  2. `window.tracker.update`: landmark-store association + allocation
     (a third match-kernel launch per frame on the card);
  3. every `ba_every` frames, once the window holds W poses, the
     Schur-complement LM windowed BA over the W in-window poses and the
     tracked landmarks; the REFINED pose replaces the integrated one, and
     the carried VO state adopts it, so later frames integrate on top of
     the BA result.

Whether the BA runs is decided on the host from the frame count alone, so
the step never waits on the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import torch

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.pipeline import vo as vo_mod
from front_end_tpu_torch.types import Descriptors
from front_end_tpu_torch.utils.precision import f32_precision
from front_end_tpu_torch.window import tracker as tracker_mod


@dataclass(frozen=True)
class WindowVOConfig:
    vo: vo_mod.VOConfig = field(default_factory=vo_mod.VOConfig)
    tracker: tracker_mod.TrackerConfig = field(
        default_factory=tracker_mod.TrackerConfig)
    ba_every: int = 1
    ba_iters: int = 6
    huber_px: float = 3.0
    min_obs: int = 2
    # size of the compacted problem handed to the BA (divisible by the
    # group's size when ba_group is set)
    ba_max_landmarks: int = 1024
    # a torch.distributed process group (the JAX package's `ba_mesh`): the
    # per-window BA then runs landmark-sharded over its ranks
    # (`ba/distributed.py`), each rank running the rest of the step on the
    # same frames with the same RANSAC seed.  None: single-device BA.
    ba_group: object = None

    @staticmethod
    def create(vo_cfg: vo_mod.VOConfig, *, window: int = 3,
               capacity: int | None = None, **kw) -> "WindowVOConfig":
        """Tracker capacity defaults to twice the detector capacity;
        descriptor width always follows the VO config."""
        tr = tracker_mod.TrackerConfig(
            capacity=capacity or 2 * vo_cfg.grid.capacity, window=window,
            desc_bits=vo_cfg.desc_dim, roi_box=vo_cfg.track_box,
            lowe_ratio=vo_cfg.lowe_ratio, norm=vo_cfg.desc_norm)
        return WindowVOConfig(vo=vo_cfg, tracker=tr, **kw)

    def replace(self, **kw) -> "WindowVOConfig":
        return dataclasses.replace(self, **kw)


class WindowVOState(NamedTuple):
    vo: vo_mod.VOState
    win: tracker_mod.WindowState


class WindowVOOutput(NamedTuple):
    frame: vo_mod.VOFrameOutput   # frame-to-frame outputs (pose = refined)
    pose_raw: torch.Tensor        # (4, 4) pose before BA this frame
    n_tracked: torch.Tensor       # landmark-store associations
    n_new: torch.Tensor           # newly allocated landmarks
    ba_ran: torch.Tensor          # bool
    ba_cost: torch.Tensor         # robust cost after BA (0 when not run)
    ba_rms_px: torch.Tensor       # masked RMS reprojection error (px)


def init_state(rig: StereoRig, cfg: WindowVOConfig, seed: int = 0,
               device="cuda") -> WindowVOState:
    return WindowVOState(
        vo=vo_mod.init_state(rig, cfg.vo, seed, device=device),
        win=tracker_mod.init_state(cfg.tracker, device=device))


@f32_precision
def window_vo_step(state: WindowVOState, left, right, rig: StereoRig,
                   cfg: WindowVOConfig, sampler: Callable | None = None):
    """One windowed-VO frame on the state's device."""
    new_vo, out = vo_mod.vo_step(state.vo, left, right, rig, cfg.vo, sampler)
    cur = new_vo.prev                         # this frame's features
    dev = new_vo.pose.device
    pose_cw = se3.invert_homog(new_vo.pose)   # camera_from_world

    upd = tracker_mod.update(
        state.win, cur.kps,
        Descriptors(cur.bits, cur.packed, cfg.vo.desc_norm), cur.X,
        cur.stereo_valid, cur.uv4, pose_cw, cfg.tracker, rig)
    win = upd.state

    # BA needs a full window of poses and runs every ba_every frames; the
    # window holds min(frames ingested, W) valid poses
    W = cfg.tracker.window
    do_ba = win.frame_idx >= W and win.frame_idx % cfg.ba_every == 0
    if do_ba:
        win, res = tracker_mod.run_window_ba(
            win, rig, iters=cfg.ba_iters, huber_px=cfg.huber_px,
            min_obs=cfg.min_obs, max_landmarks=cfg.ba_max_landmarks,
            group=cfg.ba_group)
        pose_cw_ref, ba_cost, ba_rms = res.poses[-1], res.cost, res.rms_px
    else:
        pose_cw_ref = pose_cw
        ba_cost = ba_rms = torch.zeros((), dtype=torch.float32, device=dev)

    pose_ref = se3.invert_homog(pose_cw_ref)  # world_T_camera, refined
    new_vo = new_vo._replace(pose=pose_ref)
    out = out._replace(pose=pose_ref)
    return (WindowVOState(vo=new_vo, win=win),
            WindowVOOutput(frame=out, pose_raw=se3.invert_homog(pose_cw),
                           n_tracked=upd.n_tracked, n_new=upd.n_new,
                           ba_ran=torch.tensor(do_ba, device=dev),
                           ba_cost=ba_cost, ba_rms_px=ba_rms))


def run_sequence(state: WindowVOState, lefts, rights, rig: StereoRig,
                 cfg: WindowVOConfig, sampler: Callable | None = None):
    """Step over a (T, H, W) stacked sequence; outputs stacked per field."""
    outs = []
    for left, right in zip(lefts, rights):
        state, out = window_vo_step(state, left, right, rig, cfg, sampler)
        outs.append(out)
    frame = vo_mod.VOFrameOutput(
        *(torch.stack(f) for f in zip(*(o.frame for o in outs))))
    rest = (torch.stack(f) for f in zip(*(o[1:] for o in outs)))
    return state, WindowVOOutput(frame, *rest)

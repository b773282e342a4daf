"""Control plane: runtime reset / reconfiguration (counterpart of
`front_end_tpu/pipeline/control.py`).

- `control_detection`: re-seed the adaptive detector's set-point and
  thresholds at runtime, returning the applied set-point;
- `reset_window`: clear the sliding window, its poses and its tracks;
- `reset_vo`: a fresh front-end state.

Plain functions over the pipeline's state tuples; the caller owns
transport.
"""
from __future__ import annotations

import dataclasses

import torch


def control_detection(state, cfg, *, threshold: float, set_point: int):
    """Apply a `controlDetection` request to a `vo.VOState`.

    Returns (new_state, new_cfg, applied_set_point).  Thresholds are reset
    uniformly; the set-point lives in the grid config, so a new cfg is
    returned."""
    new_grid = dataclasses.replace(cfg.grid, set_point=int(set_point),
                                   init_threshold=float(threshold))
    new_cfg = dataclasses.replace(cfg, grid=new_grid)
    t = torch.full_like(state.thresholds_l, float(threshold))
    new_state = state._replace(thresholds_l=t, thresholds_r=t.clone())
    return new_state, new_cfg, int(set_point)


def reset_window(tracker_state, tracker_cfg):
    """`windowMatching` reset: drop all landmarks, window poses and tracks,
    on the device the old state lived on."""
    from front_end_tpu_torch.window import tracker as tracker_mod
    return tracker_mod.init_state(tracker_cfg,
                                  device=tracker_state.poses.device)


def reset_vo(rig, cfg, seed: int = 0, device="cuda"):
    """Full front-end reset (fresh VOState)."""
    from front_end_tpu_torch.pipeline import vo as vo_mod
    return vo_mod.init_state(rig, cfg, seed, device=device)

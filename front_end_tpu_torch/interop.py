"""Carry configuration and state across from the JAX package.

The system has no weights: what crosses is the rig, the configuration and
the carried VO state, as numpy arrays and plain values (this module never
imports JAX).  Layout of the state:

    {"thresholds_l", "thresholds_r", "pose", "frame_idx",
     "prev": {"kps": {"xy", "score", "angle", "valid"},
              "bits", "X", "stereo_valid", "uv4"}}

— the field names of the JAX `VOState` / `FrameFeatures` / `Keypoints`.
The windowed path crosses the same way (`window_from_jax`,
`ba_result_from_jax`): a `WindowState` is

    {"store": {"Xw", "bits", "xy", "last_seen", "valid", "meas", "vis",
               "track_len"}, "poses", "pose_valid", "frame_idx"}

and the port adds what it keeps beside those fields (the packed words of
binary descriptors; the frame index as a host integer).  Float (SURF)
descriptors cross as they are and get no packed words.  The descriptor's
norm comes from the configuration; a state that crosses without one is
binary, and one whose descriptors are not all 0 or 1 is refused.
"""
from __future__ import annotations

import numpy as np
import torch

from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops.grid import GridConfig
from front_end_tpu_torch.ba.schur import BAResult
from front_end_tpu_torch.pipeline.vo import FrameFeatures, VOConfig, VOState
from front_end_tpu_torch.pipeline.window_vo import WindowVOConfig
from front_end_tpu_torch.types import Keypoints, pack_bits
from front_end_tpu_torch.utils.precision import resolve_device
from front_end_tpu_torch.window.tracker import (LandmarkStore, TrackerConfig,
                                                WindowState)

_RIG = ("fx", "fy", "cx", "cy", "baseline", "width", "height")


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def _vo_config(cfg) -> VOConfig:
    c = dict(cfg)
    g = dict(c.pop("grid"))
    if g.get("row_shares") is not None:
        g["row_shares"] = tuple(float(v) for v in g["row_shares"])
    return VOConfig(grid=GridConfig(**g), **c)


def _packed(bits, norm: str | None):
    """The packed words of binary descriptors, None for float ones;
    `norm` None (no configuration) takes the descriptors as binary."""
    if norm is None:
        if not bool(((bits == 0) | (bits == 1)).all()):
            raise ValueError("a state of float descriptors crosses with its "
                             "configuration, which gives their norm")
        norm = "hamming"
    return pack_bits(bits) if norm == "hamming" else None


def from_jax(rig=None, cfg=None, state=None, *, device="cuda", seed=0):
    """-> (StereoRig | None, VOConfig | None, VOState | None) on `device`.

    rig: {fx, fy, cx, cy, baseline, width, height}; cfg: the VOConfig
    fields with `grid` as a dict of GridConfig fields; state: the layout
    above, its descriptors of `cfg`'s norm (binary without a cfg).  The
    port's RANSAC generator (not JAX's key) is seeded `seed`."""
    out_rig = out_cfg = out_state = None
    if rig is not None:
        out_rig = StereoRig.create(**{k: rig[k] for k in _RIG})
    if cfg is not None:
        out_cfg = _vo_config(cfg)
    if state is not None:
        dev = resolve_device(device)
        f32 = torch.float32
        p = state["prev"]
        k = p["kps"]
        bits = _t(p["bits"], dev, f32)
        prev = FrameFeatures(
            kps=Keypoints(xy=_t(k["xy"], dev, f32),
                          score=_t(k["score"], dev, f32),
                          angle=_t(k["angle"], dev, f32),
                          valid=_t(k["valid"], dev, torch.bool)),
            bits=bits,
            packed=_packed(bits, out_cfg.desc_norm if out_cfg else None),
            X=_t(p["X"], dev, f32),
            stereo_valid=_t(p["stereo_valid"], dev, torch.bool),
            uv4=_t(p["uv4"], dev, f32))
        out_state = VOState(
            thresholds_l=_t(state["thresholds_l"], dev, f32),
            thresholds_r=_t(state["thresholds_r"], dev, f32),
            prev=prev, pose=_t(state["pose"], dev, f32),
            frame_idx=int(state["frame_idx"]),
            generator=torch.Generator().manual_seed(seed))
    return out_rig, out_cfg, out_state


def window_from_jax(cfg=None, state=None, *, device="cuda", group=None):
    """-> (TrackerConfig | WindowVOConfig | None, WindowState | None).

    cfg: the fields of a JAX `TrackerConfig`, or of a `WindowVOConfig`
    (recognised by its `vo` and `tracker` entries).  A `ba_mesh` there
    becomes `ba_group=group`, the caller's process group, whose size must
    equal the mesh's `landmark` axis.  state: a `WindowState` in the
    layout of the module docstring, its descriptors of the tracker's norm
    (binary without a cfg)."""
    out_cfg = out_state = None
    if cfg is not None:
        c = dict(cfg)
        if "tracker" in c:
            mesh = c.pop("ba_mesh", None)
            if mesh is not None:
                if group is None:
                    raise ValueError("ba_mesh: pass the process group the "
                                     "sharded BA runs over (group=)")
                n_lm = mesh.shape["landmark"]
                if n_lm != group.size():
                    raise ValueError(
                        f"ba_mesh's landmark axis has {n_lm} devices, the "
                        f"group {group.size()} ranks")
                c["ba_group"] = group
            out_cfg = WindowVOConfig(
                vo=_vo_config(c.pop("vo")),
                tracker=TrackerConfig(**c.pop("tracker")), **c)
        else:
            out_cfg = TrackerConfig(**c)
    if state is not None:
        dev = resolve_device(device)
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        st = state["store"]
        bits = _t(st["bits"], dev, f32)
        norm = (None if out_cfg is None
                else getattr(out_cfg, "tracker", out_cfg).norm)
        store = LandmarkStore(
            Xw=_t(st["Xw"], dev, f32), bits=bits, packed=_packed(bits, norm),
            xy=_t(st["xy"], dev, f32),
            last_seen=_t(st["last_seen"], dev, i32),
            valid=_t(st["valid"], dev, b8), meas=_t(st["meas"], dev, f32),
            vis=_t(st["vis"], dev, b8),
            track_len=_t(st["track_len"], dev, i32))
        out_state = WindowState(
            store=store, poses=_t(state["poses"], dev, f32),
            pose_valid=_t(state["pose_valid"], dev, b8),
            frame_idx=int(state["frame_idx"]))
    return out_cfg, out_state


def ba_result_from_jax(result, *, device="cuda") -> BAResult:
    """{"poses", "landmarks", "cost", "cost0", "rms_px"} -> BAResult."""
    dev = resolve_device(device)
    return BAResult(*(_t(result[f], dev, torch.float32)
                      for f in BAResult._fields))

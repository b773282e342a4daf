"""Per-stage timing telemetry (counterpart of
`front_end_tpu/pipeline/telemetry.py`), the `ProcTime` primitive.

- `FrameClock` times a whole frame step;
- `staged_timings` runs a VO frame's stages one at a time, each waited
  for, to recover the reference's per-stage breakdown (for diagnosis; the
  waits make it slower than the plain step).

On the card a call returns before the device finishes, so both wait for
the device (`torch.cuda.synchronize`) before they read the clock.
Records aggregate into `TelemetryLog` and persist with `save_log` in the
JAX package's `.npz` layout (`stage_*`, `counter_*`, `_meta`), so either
package's `load_log` reads the other's recordings.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


class ProcTime(NamedTuple):
    label: str
    seconds: float


@dataclass
class TelemetryLog:
    frames: list = field(default_factory=list)   # list[list[ProcTime]]
    counters: dict = field(default_factory=dict)  # label -> list[float]

    def add_frame(self, records):
        self.frames.append(list(records))

    def count(self, label, value):
        self.counters.setdefault(label, []).append(float(value))

    def stage_means(self):
        agg = {}
        for fr in self.frames:
            for r in fr:
                agg.setdefault(r.label, []).append(r.seconds)
        return {k: sum(v) / len(v) for k, v in agg.items()}

    def to_dict(self):
        return {"stage_means_s": self.stage_means(),
                "counters": {k: list(v) for k, v in self.counters.items()}}


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_log(path: str, log: TelemetryLog, meta: dict | None = None) -> str:
    """Persist a run's telemetry (.npz): per-frame stage times (NaN where a
    frame lacks a stage) and counter series.  Returns the path written."""
    labels = sorted({r.label for fr in log.frames for r in fr})
    arrs = {}
    for lb in labels:
        series = []
        for fr in log.frames:
            vals = [r.seconds for r in fr if r.label == lb]
            series.append(vals[0] if vals else np.nan)
        arrs[f"stage_{lb}"] = np.asarray(series, np.float64)
    for k, v in log.counters.items():
        arrs[f"counter_{k}"] = np.asarray(v, np.float64)
    arrs["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    path = _npz(path)
    np.savez(path, **arrs)
    return path


def load_log(path: str):
    """-> (stages: {label: (T,) seconds}, counters: {label: (T,)},
    meta: dict)."""
    stages, counters, meta = {}, {}, {}
    with np.load(_npz(path)) as z:
        for k in z.files:
            if k.startswith("stage_"):
                stages[k[len("stage_"):]] = z[k]
            elif k.startswith("counter_"):
                counters[k[len("counter_"):]] = z[k]
            elif k == "_meta":
                meta = json.loads(z[k].tobytes().decode() or "{}")
    return stages, counters, meta


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class FrameClock:
    """Times a frame step into `log`; on a CUDA `device` the clock stops
    only once the device has finished the step's work."""

    def __init__(self, log: TelemetryLog, label: str = "frame",
                 device=None):
        self.log = log
        self.label = label
        self.device = device

    def __enter__(self):
        _sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.log.add_frame([ProcTime(self.label,
                                     time.perf_counter() - self.t0)])
        return False


def timed(label: str, fn, *args, device=None):
    """Run `fn(*args)`, wait for the device, return (result, ProcTime)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, ProcTime(label, time.perf_counter() - t0)


def staged_timings(state, left, right, rig, cfg):
    """Reference-style per-stage breakdown of one VO frame on the state's
    device.  Returns (records, outputs dict); the labels are the JAX
    package's: Detection, Description+Stereo, KNN_Match, MotionExtraction.
    """
    from front_end_tpu_torch.motion.ransac import InverseCdfSampler
    from front_end_tpu_torch.ops import grid as grid_mod
    from front_end_tpu_torch.ops import match as match_mod
    from front_end_tpu_torch.pipeline import vo as vo_mod
    from front_end_tpu_torch.types import Descriptors
    from front_end_tpu_torch.utils.precision import pinned_f32

    dev = state.pose.device
    left = torch.as_tensor(left).to(device=dev, dtype=torch.float32)
    right = torch.as_tensor(right).to(device=dev, dtype=torch.float32)
    tl, tr, prev = state.thresholds_l, state.thresholds_r, state.prev
    norm = cfg.desc_norm
    with pinned_f32():
        _, r0 = timed("Detection", grid_mod.detect_pair, left, right, tl,
                      tr, cfg.grid, device=dev)
        feats, r1 = timed(
            "Description+Stereo",
            lambda: vo_mod._extract_frame(left, right, tl, tr, rig, cfg)[0],
            device=dev)
        tm, r2 = timed(
            "KNN_Match",
            lambda: match_mod.interframe_match(
                feats.kps, Descriptors(feats.bits, feats.packed, norm),
                prev.kps, Descriptors(prev.bits, prev.packed, norm),
                box=cfg.track_box, ratio=cfg.lowe_ratio, norm=norm),
            device=dev)
        sampler = InverseCdfSampler(torch.Generator().manual_seed(0))
        (H, stats), r3 = timed(
            "MotionExtraction",
            lambda: vo_mod._estimate_motion(sampler, feats, prev, rig, cfg),
            device=dev)
    return [r0, r1, r2, r3], {"features": feats, "tracks": tm, "motion": H,
                              "stats": stats}

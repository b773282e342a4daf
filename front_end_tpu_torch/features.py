"""Detector/descriptor parameter-sweep tables with stable hex IDs
(counterpart of `front_end_tpu/features.py`; the tables are this package's
own copy, so the port imports nothing of the JAX package).

Every detector family enumerates a parameter grid; the ordered
concatenation of all family combination lists is numbered to stable IDs
`Det%010X` / `Desc%010X`, which flow through the services, the YAML export
and benchmark reports.  The grids mirror the reference system's value
ranges exactly, so ID sets have the same cardinality per family and the
same order as the JAX package's.

`make_detector` / `make_descriptor` return callables for every family of
the tables — detectors FAST, ORB, BRISK, SURF, AKAZE; descriptors BRIEF,
SURF, FREAK, ORB — and `(None, False)` for settings of any other family,
the factory's own miss contract.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable

import torch

# --- parameter grids (the reference system's value ranges) ----------------

FAST_PARAMS = {
    "threshold": list(range(1, 60)),
    "d_type": ["5_8", "7_12", "9_16"],
    "non_maximum_suppression": [True, False],
}
BRIEF_PARAMS = {
    "bytes": [16, 32, 64],
    "use_orientation": [1, 0],
}
SURF_PARAMS = {
    "hessian_threshold": list(range(10, 550, 10)),
    "n_octaves": [2, 4],
    "n_octave_layers": [2, 3, 4, 5],
    "extended": [1, 0],
    "upright": [1, 0],
}
BRISK_PARAMS = {
    "threshold": list(range(4, 70, 3)),
    "n_octaves": [2, 4],
    "pattern_scale": [1.0],
}
AKAZE_PARAMS = {
    "threshold": [1e-4, 5e-4, 1e-3, 5e-3],
    "n_octaves": [2, 4],
    "n_octave_layers": [2, 4],
    "diffusivity": ["weickert", "charbonnier", "pm_g1", "pm_g2"],
    "descriptor_size": [64, 256, 486],
}
ORB_PARAMS = {
    "scale_factor": [1.1, 1.2, 1.3],
    "n_levels": [2, 4],
    "edge_threshold": list(range(5, 50, 10)),
    "wta_k": [3, 4],
    "score_type": ["fast"],
    "patch_size": [10, 30, 50],
    "fast_threshold": list(range(1, 50, 6)),
}


def _combos(name, grid, keys, norm):
    vals = [grid[k] for k in keys]
    return [{"Name": name, "Param": dict(zip(keys, c)), "NormType": norm}
            for c in itertools.product(*vals)]


def fast_combinations():
    return _combos("FAST", FAST_PARAMS,
                   ["threshold", "d_type", "non_maximum_suppression"],
                   "NORM_HAMMING")


def brief_combinations():
    return _combos("BRIEF", BRIEF_PARAMS, ["bytes", "use_orientation"],
                   "NORM_HAMMING")


def surf_detector_combinations():
    return _combos("SURF", SURF_PARAMS,
                   ["hessian_threshold", "n_octaves", "n_octave_layers"],
                   "NORM_L2")


def surf_descriptor_combinations():
    return _combos("SURF", SURF_PARAMS, ["extended", "upright"], "NORM_L2")


def brisk_combinations():
    return _combos("BRISK", BRISK_PARAMS,
                   ["threshold", "n_octaves", "pattern_scale"],
                   "NORM_HAMMING")


def akaze_detector_combinations():
    return _combos("AKAZE", AKAZE_PARAMS,
                   ["threshold", "n_octaves", "n_octave_layers",
                    "diffusivity"], "NORM_HAMMING")


def orb_detector_combinations():
    return _combos("ORB", ORB_PARAMS,
                   ["scale_factor", "n_levels", "edge_threshold",
                    "fast_threshold"], "NORM_HAMMING")


@functools.lru_cache(maxsize=1)
def detector_table():
    """ID -> settings, in the reference system's order (ORB, BRISK, FAST,
    SURF, BRISK again, AKAZE — the duplicate is in the reference)."""
    allset = (orb_detector_combinations() + brisk_combinations()
              + fast_combinations() + surf_detector_combinations()
              + brisk_combinations() + akaze_detector_combinations())
    return {f"Det{d:010X}": s for d, s in enumerate(allset)}


FREAK_PARAMS = {"pattern_scale": [0.5, 1.0, 1.5, 2.0]}
ORB_DESC_PARAMS = {"bytes": [32], "wta_k": [2, 3, 4]}   # HAMMING2 for 3/4


def freak_combinations():
    return _combos("FREAK", FREAK_PARAMS, ["pattern_scale"], "NORM_HAMMING")


def orb_descriptor_combinations():
    return _combos("ORB", ORB_DESC_PARAMS, ["bytes", "wta_k"],
                   "NORM_HAMMING")


@functools.lru_cache(maxsize=1)
def descriptor_table():
    """The reference table is SURF-descriptors-only; the BRIEF/FREAK/ORB
    descriptor configurations its detect node constructs directly are
    appended, so every benchmarked configuration has a stable ID here."""
    allset = (brief_combinations() + surf_descriptor_combinations()
              + freak_combinations() + orb_descriptor_combinations())
    return {f"Desc{d:010X}": s for d, s in enumerate(allset)}


def ids_for(name: str, table: dict) -> list[str]:
    return [k for k, v in table.items() if v["Name"] == name]


# --- factories -------------------------------------------------------------

def make_detector(settings) -> tuple[Callable | None, bool]:
    """Settings (or Det-ID) -> (detect_fn, supported).

    detect_fn(img) -> score map (H, W) on the image's device; corners are
    `map > 0`.  Families outside the table return (None, False)."""
    if isinstance(settings, str):
        settings = detector_table()[settings]
    name, p = settings["Name"], settings["Param"]
    if name == "FAST":
        from front_end_tpu_torch.ops import fast as fast_mod

        def detect(img):
            return fast_mod.detect_dense(
                img, float(p["threshold"]), fast_type=p["d_type"],
                nms=bool(p["non_maximum_suppression"]))
        return detect, True
    if name == "ORB":
        from front_end_tpu_torch.ops import orb as orb_mod

        def detect(img):
            return orb_mod.detect_dense_pyramid(
                img, n_levels=int(p.get("n_levels", 4)),
                scale_factor=float(p.get("scale_factor", 1.2)),
                fast_threshold=float(p["fast_threshold"]),
                edge_threshold=int(p.get("edge_threshold", 31)))
        return detect, True
    if name == "SURF":
        from front_end_tpu_torch.ops import surf as surf_mod

        def detect(img):
            return surf_mod.detect_dense(
                img, hessian_threshold=float(p["hessian_threshold"]),
                n_octaves=int(p["n_octaves"]),
                n_octave_layers=int(p["n_octave_layers"]))
        return detect, True
    if name == "BRISK":
        from front_end_tpu_torch.ops import brisk as brisk_mod

        def detect(img):
            return brisk_mod.detect_dense(
                img, threshold=float(p["threshold"]),
                n_octaves=max(1, int(p["n_octaves"])))
        return detect, True
    if name == "AKAZE":
        from front_end_tpu_torch.ops import akaze as akaze_mod

        def detect(img):
            return akaze_mod.detect_dense(
                img, threshold=float(p["threshold"]),
                n_octaves=int(p["n_octaves"]),
                n_sublevels=int(p["n_octave_layers"]),
                diffusivity=str(p["diffusivity"]))
        return detect, True
    return None, False


def make_descriptor(settings) -> tuple[Callable | None, bool]:
    """Settings (or Desc-ID) -> (describe_fn, supported).

    describe_fn(img, xy) -> Descriptors."""
    if isinstance(settings, str):
        settings = descriptor_table()[settings]
    name, p = settings["Name"], settings["Param"]
    if name == "BRIEF":
        from front_end_tpu_torch.ops import brief as brief_mod

        def describe(img, xy):
            sm = brief_mod.smooth(img)
            return brief_mod.describe_dense(sm, xy, int(p["bytes"]))
        return describe, True
    if name == "SURF":
        from front_end_tpu_torch.ops import surf as surf_mod

        def describe(img, xy):
            return surf_mod.describe(img, xy, extended=bool(p["extended"]),
                                     upright=bool(p["upright"]))
        return describe, True
    if name == "FREAK":
        from front_end_tpu_torch.ops import freak as freak_mod
        from front_end_tpu_torch.types import Keypoints

        def describe(img, xy):
            n = xy.shape[0]
            kps = Keypoints(
                xy=xy, score=torch.ones(n, device=xy.device),
                angle=torch.zeros(n, device=xy.device),
                valid=torch.ones(n, dtype=torch.bool, device=xy.device))
            return freak_mod.describe_keypoints(
                img.to(torch.float32), kps,
                pattern_scale=float(p.get("pattern_scale", 1.0)))[1]
        return describe, True
    if name == "ORB":
        from front_end_tpu_torch.ops import brief as brief_mod
        from front_end_tpu_torch.ops import orb as orb_mod

        def describe(img, xy):
            sm = brief_mod.smooth(img.to(torch.float32))
            ang = orb_mod.intensity_centroid_angle(sm, xy)
            return orb_mod.describe(sm, xy, ang,
                                    n_bytes=int(p.get("bytes", 32)),
                                    wta_k=int(p.get("wta_k", 2)))
        return describe, True
    return None, False


def matcher_norm(settings) -> str:
    """The reference's `getMatcher` capability plus its WTA_K-driven norm
    selection:
    NORM_HAMMING -> the Hamming matcher; NORM_L2 -> squared L2;
    NORM_HAMMING2 (ORB WTA_K 3/4) -> the same Hamming matcher over the
    one-hot group codes, which gives 2x the HAMMING2 distance
    (order-identical; see ops/orb.py module doc)."""
    p = settings.get("Param", {})
    if settings.get("Name") == "ORB" and int(p.get("wta_k", 2)) > 2:
        return "NORM_HAMMING2"
    return settings.get("NormType", "NORM_HAMMING")


def export_table_yaml(path: str):
    """Dump the tables in a YAML-ish FileStorage layout for external
    consumers (the reference's `genDetectorDescriptorTable`)."""
    lines = ["%YAML:1.0", "---"]
    for table, _tag in ((detector_table(), "det"),
                        (descriptor_table(), "desc")):
        for k, v in table.items():
            params = ", ".join(f'"{x}"' for x in map(str, v["Param"].values()))
            lines.append(f"{k}:")
            lines.append(f"   Name: {v['Name']}")
            lines.append(f"   Param: [ {params} ]")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(detector_table()) + len(descriptor_table())

"""`ops/kernels/fast_grid.py` (`csrc/fast_grid.cu`): its bound over its
profiled device time, in %.  One launch a frame covers the stereo pair;
the bound is the bytes of that work over the HBM rate
(`vobench/roofline.py`)."""
from vobench import roofline

LAYER = "kernels"
UNIT = "%"
WRAP = None


def read(trace):
    p = trace.profile
    if p is None:
        return None
    spans = p.kernels(r"\bfast_grid_kernel\b")
    device_s = sum(e - s for s, e in spans)
    if device_s <= 0:
        return None
    rig, g = trace.config["rig"], trace.config["vo"]["grid"]
    bound = trace.profiled_frames * roofline.fast_grid_seconds(
        2, rig["height"], rig["width"], g["grid_rows"], g["grid_cols"])
    return 100.0 * bound / device_s

"""`ops/kernels/match_reduce.py` (`csrc/match_reduce.cu`, its
`match_kernel` and `finalize`): the bound of a frame's binary matches
over their profiled device time, in %.  A frame matches the stereo pair
and the previous frame's features, each capacity x capacity, and on the
windowed path also the tracker's store (capacity x store slots)."""
from vobench import roofline

LAYER = "kernels"
UNIT = "%"
WRAP = None


def read(trace):
    p = trace.profile
    if p is None:
        return None
    spans = p.kernels(r"\bmatch_kernel\b|(^|\s)finalize\(")
    device_s = sum(e - s for s, e in spans)
    if device_s <= 0:
        return None
    cfg = trace.config
    g = cfg["vo"]["grid"]
    cap = g["grid_rows"] * g["grid_cols"] * g["cell_capacity"]
    nw = cfg["vo"]["desc_bytes"] // 4
    per_frame = 2 * roofline.match_seconds(cap, cap, nw)
    if cfg["entry"] == "window":
        per_frame += roofline.match_seconds(cap, cfg["window"]["capacity"],
                                            nw)
    return 100.0 * trace.profiled_frames * per_frame / device_s

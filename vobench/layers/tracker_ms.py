"""Serialized ms per frame of the landmark tracker's association and
allocation, `window/tracker.py::update`."""
LAYER = "window"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.window.tracker", "update", True)


def read(trace):
    return trace.per_frame_ms("tracker_ms")

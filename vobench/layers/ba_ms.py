"""Serialized ms per frame of the windowed BA,
`window/tracker.py::run_window_ba` -> `ba/schur.py::ba_solve`."""
LAYER = "window"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.window.tracker", "run_window_ba", True)


def read(trace):
    return trace.per_frame_ms("ba_ms")

"""Serialized ms per frame of `pipeline/vo.py::_estimate_motion`: the
inter-frame match, `motion/ransac.py` and the LM polish."""
LAYER = "motion"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.pipeline.vo", "_estimate_motion", True)


def read(trace):
    return trace.per_frame_ms("motion_ms")

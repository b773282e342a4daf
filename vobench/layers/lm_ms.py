"""Serialized ms per frame of the LM polish, `motion/lm.py::refine_motion`
(inside `motion_ms`)."""
LAYER = "motion"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.motion.lm", "refine_motion", True)


def read(trace):
    return trace.per_frame_ms("lm_ms")

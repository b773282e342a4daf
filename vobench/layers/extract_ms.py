"""Serialized ms per frame of `pipeline/vo.py::_extract_frame`: grid FAST
(`ops/grid.py`), the descriptor, the stereo match and triangulation."""
LAYER = "extraction"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.pipeline.vo", "_extract_frame", True)


def read(trace):
    return trace.per_frame_ms("extract_ms")

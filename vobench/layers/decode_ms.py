"""Mean ms to decode one image of a png cell: the port's
`io/kitti.py::_read_image` (PIL where it is installed, else
`utils/png.py`), wrapped where the feed's thread calls it."""
LAYER = "io"
UNIT = "ms"
WRAP = ("front_end_tpu_torch.io.kitti", "_read_image", False)


def read(trace):
    return trace.per_call_ms("decode_ms")

"""Kernels that ran on the card in the profiled window, per frame."""
LAYER = "device"
UNIT = "launches"
WRAP = None


def read(trace):
    p = trace.profile
    if p is None or not trace.profiled_frames:
        return None
    n = sum(1 for _, kind, _, _ in p.device if kind == "kernel")
    return n / trace.profiled_frames if n else None

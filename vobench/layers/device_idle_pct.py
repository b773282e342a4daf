"""The share of the profiled window's wall time that no kernel, copy or
fill covers on the card (the union of their intervals)."""
LAYER = "device"
UNIT = "%"
WRAP = None


def read(trace):
    p = trace.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)

"""Mean ms per profiled frame of an open loop in which the card ran
nothing while the frame was in the loop's hands (from the pair in hand
to the pose on the host; `trace.Profile.idle`): the host's dispatch and
waits on the frame's critical path.  The wait for the next due frame is
not in it.  No reading in a closed loop, whose frames are not marked."""
LAYER = "device"
UNIT = "ms"
WRAP = None


def read(trace):
    p = trace.profile
    if p is None or not p.active or not p.device:
        return None
    return 1e3 * sum(e - s for s, e in p.idle()) / len(p.active)

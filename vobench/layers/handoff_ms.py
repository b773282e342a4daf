"""Mean ms per frame of an open loop from the source's hand-off of the
frame to the pair in the loop's hand, counted from the loop's request
where that came later: the port's `io/feed.py::DeviceFeed` alone (the
pinned copy and the copy's issue in the feed's thread, the queue, the
loop's wake-up).  The source's lateness (a note of the run) and the wait
behind an earlier frame (in `frame_ms_p95`) are not in it.  No reading
in a closed loop, which has no hand-off times."""
LAYER = "feed"
UNIT = "ms"
WRAP = None         # the harness times next(feed) itself


def read(trace):
    return trace.per_frame_ms("handoff_ms")

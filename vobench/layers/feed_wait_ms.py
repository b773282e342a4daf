"""Mean ms per frame the loop stood blocked in `next(feed)` on the port's
`io/feed.py::DeviceFeed`: the wait for a frame the feed has not readied."""
LAYER = "feed"
UNIT = "ms"
WRAP = None         # the harness times next(feed) itself


def read(trace):
    return trace.per_frame_ms("feed_wait_ms")

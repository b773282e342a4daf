"""The 95th percentile over every frame of the window of the time to its
pose on the host from the request, or in an open loop from the frame's
due time: waits on the feed and the decode included, and in an open loop
the wait behind a late frame too."""
from vobench import stats


def read(window):
    return 1e3 * stats.percentile(window.latencies, 95)

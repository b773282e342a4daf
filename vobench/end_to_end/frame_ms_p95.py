"""The 95th percentile over every frame of the window of the time from
the loop's request for the frame to its pose on the host, waits on the
feed and the decode included."""
from vobench import stats


def read(window):
    return 1e3 * stats.percentile(window.latencies, 95)

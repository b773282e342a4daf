"""The 95th percentile of the frames' times as `frame_ms_p95` takes them
(request, or due time, to pose on the host), over the traced run's
frames after the profiled ones: the other readers' wrappers are on and
synchronize the card around their calls, so it reads higher than the
untraced run's.  A tail for a cell whose untraced `frame_ms_p95` spreads
too widely between runs to hold a bound end to end."""
from vobench import stats

LAYER = "frame"
UNIT = "ms"
WRAP = None         # the harness times each frame itself


def read(trace):
    times = trace.spans.get("frame_s")
    return 1e3 * stats.percentile(times, 95) if times else None

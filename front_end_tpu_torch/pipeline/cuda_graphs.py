"""An eager body of small kernels, such as the LM polish
(`motion/lm.py::_refine`) or the windowed BA
(`window/tracker.py::_window_ba`), replayed as one CUDA graph a key.

`Replayed(body, name)` captures the body once per key (device, the
shapes and dtypes of its tensor inputs, its static arguments, whose
values are baked into the kernels) on static inputs; a call copies its
tensors in, replays, and returns copies of the static outputs, bit for
bit what the body returns eagerly.  CPU tensors, tensors under a
`torch.func` transform (a study's vmap) or that require grad, calls made
while the current stream is being captured and calls with `eager=True`
(a solve with collectives) run the body eagerly.  The graphs serve calls
from one stream at a time, as every caller makes them.  Nothing may copy
from the host inside a capture (`torch.as_tensor(x, device=...)` of a
Python number refuses; `torch.full` does not).

The body counts through `telemetry.count`.  A capture diverts the counts
(their tensors hold values only at each replay) and stacks them by name
into static tensors, which a replay counts while a recording is open.  A
call with CUDA inputs counts `<name>.graph`: 1 for a replay, 0 for an
eager run.  Inside a capture nothing is counted.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from front_end_tpu_torch.pipeline import telemetry

MAX_GRAPHS = 4      # captured keys kept a body; a benchmark cell needs one


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Captured:
    """The body captured as one CUDA graph on static inputs.  A replay
    refreshes them from the call's tensors, and hands back copies of the
    static outputs, which the next replay overwrites."""

    def __init__(self, body, tensors, static):
        self.inputs = [t.detach().clone(memory_format=torch.contiguous_format)
                       for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # one eager run creates the libraries' handles and work space (and
        # the sort's) on the capture's stream, which the capture may not
        with torch.cuda.stream(side), telemetry.diverted():
            body(*self.inputs, *static)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a feed thread's calls on its own stream stay legal
        with telemetry.diverted() as counts, torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            # flattened once: a replay clones the leaves, unflattens them
            self.out, self.spec = tree_flatten(body(*self.inputs, *static))
            by_name: dict = {}
            for name, value in counts:
                by_name.setdefault(name, []).append(value)
            self.counts = {name: torch.stack(vs)
                           for name, vs in by_name.items()}

    def replay(self, tensors):
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.graph.replay()
        if telemetry.is_recording():
            for name, values in self.counts.items():
                for v in values.clone().unbind():
                    telemetry.count(name, v)
        return tree_unflatten([t.clone() for t in self.out], self.spec)


class Replayed:
    """`body(*tensors, *static)` served by a CUDA graph where one can
    serve it; its graphs, at most `MAX_GRAPHS` keys, least recently used
    first out."""

    def __init__(self, body, name: str):
        self.body = body
        self.name = name
        self.graphs: OrderedDict = OrderedDict()    # key -> _Captured

    def __call__(self, tensors: tuple, static: tuple, *,
                 eager: bool = False):
        capturing = _capturing()
        cuda = all(t.is_cuda for t in tensors)
        if cuda and not (eager or capturing or any(
                t.requires_grad
                or torch._C._functorch.is_functorch_wrapped_tensor(t)
                for t in tensors)):
            out = self._replay(tensors, static)
            served = 1
        else:
            # a capture's tensors hold values only at replay: count none
            with telemetry.diverted() if capturing else \
                    contextlib.nullcontext():
                out = self.body(*tensors, *static)
            served = 0
        if cuda and not capturing:
            telemetry.count(f"{self.name}.graph", served)
        return out

    def _replay(self, tensors, static):
        dev = tensors[0].device
        key = (dev, tuple((t.shape, t.dtype) for t in tensors), static)
        with torch.cuda.device(dev):
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = _Captured(self.body, tensors, static)
                while len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            return g.replay(tensors)

"""The CUDA-graph replay helper's dispatch (`pipeline/cuda_graphs.py`) on the
CPU, on a toy body that counts: CPU tensors, tensors that require grad,
a `torch.func.vmap`, a call inside a capture and a caller's `eager=True`
run the body eagerly and capture nothing; what is counted in each case;
a call a graph can serve goes to the replay.  The LM and the windowed BA
each hold one helper.  The replay itself runs on the card
(`tests/test_torch_cuda.py -k "lm_ or ba_"`).

A tensor that says it is on CUDA (`_OnCuda`) stands in for a card's
inputs, so the dispatch's other conditions are reached here.
"""
from typing import NamedTuple

import pytest
import torch

from front_end_tpu_torch.motion import lm
from front_end_tpu_torch.pipeline import cuda_graphs, telemetry
from front_end_tpu_torch.window import tracker


class _OnCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class Pair(NamedTuple):
    total: torch.Tensor
    mean: torch.Tensor


def _toy(calls):
    def body(x, y, scale):
        calls.append(scale)
        out = x * scale + y
        telemetry.count("toy.positive", out > 0)
        telemetry.count("toy.calls", 1)
        return out, Pair(out.sum(), x.mean())
    return body


@pytest.fixture
def no_recording():
    assert telemetry._active is None
    yield
    assert telemetry._active is None, "a test left a recording open"


def _inputs(case):
    x = torch.tensor([1.0, -2.0, 3.0])
    y = torch.tensor([0.5, 0.5, -9.0])
    if case in ("grad", "capture", "eager"):
        x, y = x.as_subclass(_OnCuda), y.as_subclass(_OnCuda)
    if case == "grad":
        x.requires_grad_(True)
    return x, y


# what each case keeps, {counter: values}: x * 2 + y has one positive
BODY = {"toy.positive": [1.0], "toy.calls": [1.0]}
KEPT = {
    "cpu": BODY,
    "grad": dict(BODY, **{"toy.graph": [0.0]}),
    "vmap": {"toy.calls": [1.0]},
    "capture": {},
    "eager": dict(BODY, **{"toy.graph": [0.0]}),
}


@pytest.mark.parametrize("case", list(KEPT))
def test_runs_the_body_eagerly_where_no_graph_serves(case, monkeypatch,
                                                     no_recording):
    """The body runs once, eagerly, and returns its own structure; no
    graph is captured.  `toy.graph` is counted (0) for CUDA inputs only;
    a count under `vmap` is dropped where its value is a wrapped tensor;
    a capture keeps no count at all."""
    calls = []
    graphs = cuda_graphs.Replayed(_toy(calls), "toy")

    def refuse(*a):
        raise AssertionError("no graph can serve these inputs")

    monkeypatch.setattr(graphs, "_replay", refuse)
    if case == "capture":
        monkeypatch.setattr(cuda_graphs, "_capturing", lambda: True)
    x, y = _inputs(case)
    with telemetry.recording() as rec:
        if case == "vmap":
            out = torch.func.vmap(
                lambda xb: graphs((xb, y), (2.0,))[0])(torch.stack([x, x]))
            assert torch.equal(out, torch.stack([x * 2.0 + y] * 2))
        else:
            out, pair = graphs((x, y), (2.0,), eager=case == "eager")
            assert isinstance(pair, Pair)
            assert torch.equal(out.detach(), (x * 2.0 + y).detach())
            assert torch.equal(pair.total.detach(), out.sum().detach())
    assert calls == [2.0]
    assert not graphs.graphs
    c = rec.counters()
    assert {k: [v for _, v in vs] for k, vs in c.items()} == KEPT[case]
    if case == "grad":
        pair.total.backward()
        assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_a_call_a_graph_can_serve_goes_to_the_replay(monkeypatch,
                                                     no_recording):
    """CUDA inputs that need no grad, outside a capture and without
    `eager=True`, go to the replay with the key's static arguments, and
    count `toy.graph` 1; the body does not run eagerly."""
    calls, replays = [], []
    graphs = cuda_graphs.Replayed(_toy(calls), "toy")

    def replay(tensors, static):
        replays.append(static)
        return "replayed"

    monkeypatch.setattr(graphs, "_replay", replay)
    x, y = _inputs("eager")
    with telemetry.recording() as rec:
        assert graphs((x, y), (2.0,)) == "replayed"
    assert calls == [] and replays == [(2.0,)]
    assert rec.counters() == {"toy.graph": [(None, 1.0)]}


@pytest.mark.parametrize("module,body", [(lm, "_refine"),
                                         (tracker, "_window_ba")],
                         ids=["lm", "tracker"])
def test_each_replayed_body_holds_one_helper(module, body):
    """The LM and the windowed BA each hold one helper around their eager
    body, and no capture machinery of their own."""
    held = [v for v in vars(module).values()
            if isinstance(v, cuda_graphs.Replayed)]
    assert len(held) == 1
    assert held[0].body is getattr(module, body)
    for name in ("_Captured", "MAX_GRAPHS", "_graphs", "_replay",
                 "_capturing", "_wrapped"):
        assert not hasattr(module, name), name

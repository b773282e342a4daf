"""Shared pieces of the harness's tests.  Run them from the repository's
root: `python -m pytest vobench/tests -q` (on the card the `cuda` tests
run too).  No test decides at import time whether there is a card."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from vobench import run, spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


def shrink(cell: spec.Cell, scale: float = 0.25,
           pairs: int = 8) -> spec.Cell:
    """The cell at a quarter of its resolution with fewer keypoints, for
    the CPU: same code paths, small shapes."""
    cfg = copy.deepcopy(cell.config)
    r = cfg["rig"]
    r.update(fx=r["fx"] * scale, fy=r["fy"] * scale, cx=r["cx"] * scale,
             cy=r["cy"] * scale, width=int(r["width"] * scale),
             height=int(r["height"] * scale))
    cfg["vo"]["grid"].update(cell_capacity=48, set_point=250)
    cfg["scene"]["texel_m"] *= 3
    if cfg["entry"] == "window":
        cfg["window"].update(capacity=576, ba_max_landmarks=128)
    traffic = dict(cell.traffic, unique_pairs=pairs)
    return spec.Cell(cell.name, cfg, traffic, cell.chips, cell.end_to_end,
                     cell.per_layer, cell.root)


@pytest.fixture
def tiny(monkeypatch):
    """Cells cut by `shrink`, with fewer warm-up, profiled and compared
    frames."""
    torch.set_num_threads(2)
    monkeypatch.setattr(run, "WARMUP_FRAMES", 2)
    monkeypatch.setattr(run, "PROFILE_FRAMES", 2)
    monkeypatch.setattr(run, "CHECK_FRAMES", 6)

    def make(name, **kw):
        return shrink(load(name), **kw)
    return make


def load(name: str) -> spec.Cell:
    """A cell of `BENCHMARK.json`, or else `<config>.<traffic>` built from
    the two files (the png mix, which no cell runs, keeps its tests)."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.rsplit(".", 1)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1})
    return spec.load_cell(name, bench)


@pytest.fixture
def clock():
    return time.perf_counter()

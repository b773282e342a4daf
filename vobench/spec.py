"""Find a cell's files by name: `BENCHMARK.json` at the checkout's root,
the cell's configuration and traffic mix, and the per-layer readers that
apply to it.  Nothing here knows a particular cell."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "vobench" / "traffic" / f"{name}.json"


def layer_path(metric: str, root: Path = ROOT) -> Path:
    return root / "vobench" / "layers" / f"{metric}.py"


def end_to_end_path(metric: str, root: Path = ROOT) -> Path:
    return root / "vobench" / "end_to_end" / f"{metric}.py"


def _load_module(kind: str, name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"vobench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_end_to_end(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of one end-to-end metric,
    `vobench/end_to_end/<metric>.py`: `read(window) -> float`."""
    return _load_module("end_to_end", metric, end_to_end_path(metric, root))


def load_layer(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of one per-layer metric, `vobench/layers/<metric>.py`.
    A reader has `LAYER`, `UNIT`, `WRAP` (None, or the dotted module, the
    function name and whether to synchronize the device around each call)
    and `read(trace) -> float | None`."""
    path = layer_path(metric, root)
    mod = _load_module("layers", metric, path)
    for attr in ("LAYER", "UNIT", "WRAP", "read"):
        if not hasattr(mod, attr):
            raise ValueError(f"{path}: a reader needs {attr}")
    return mod


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple       # the metric entries this cell reports
    per_layer: tuple
    root: Path = ROOT       # where its readers are found


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """A cell of `bench` (default: `BENCHMARK.json` under `root`) with its
    configuration and traffic files read from under `root`."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(traffic_path(w["traffic"], root))
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
        root=root)

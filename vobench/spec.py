"""Find a cell's files by name: `BENCHMARK.json` at the checkout's root,
the cell's configuration and traffic mix, the step its configuration's
`entry` names (the port's and the plain reference's), and the per-layer
readers that apply to it.  Nothing here knows a particular cell."""
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


def entry_path(entry: str, root: Path = ROOT) -> Path:
    return root / "vobench" / "entries" / f"{entry}.py"


def reference_entry_path(entry: str, root: Path = ROOT) -> Path:
    return root / "vobench" / "reference" / "entries" / f"{entry}.py"


def _load_module(kind: str, name: str, path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"vobench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_checked(kind: str, name: str, path: Path, attrs: tuple,
                  what: str) -> ModuleType:
    mod = _load_module(kind, name, path)
    for attr in attrs:
        if not hasattr(mod, attr):
            raise ValueError(f"{path}: {what} needs {attr}")
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
    return _load_checked("layers", metric, layer_path(metric, root),
                         ("LAYER", "UNIT", "WRAP", "read"), "a reader")


ENTRY = ("EXTRA", "setup", "init_state", "step", "frame", "extras")


def load_entry(entry: str, root: Path = ROOT) -> ModuleType:
    """The port's step of one entry, `vobench/entries/<entry>.py` (it may
    import the port).  An entry, here and in the reference, has `EXTRA`
    (the names of the scalars a frame adds to its counts and inliers for
    the check), `setup(config) -> (rig, cfg)`, `init_state(rig, cfg, seed,
    device)`, `step(state, left, right, rig, cfg) -> (state, out)`,
    `frame(out)` (the outputs with `pose`, `motion_ok`, the counts and
    `n_inliers`) and `extras(out)` (the `EXTRA` as device tensors)."""
    return _load_checked("entries", entry, entry_path(entry, root), ENTRY,
                         "an entry")


def load_reference_entry(entry: str, root: Path = ROOT) -> ModuleType:
    """The plain step of one entry, `vobench/reference/entries/<entry>.py`
    (it imports neither the port nor JAX), as `load_entry` describes."""
    return _load_checked("reference.entries", entry,
                         reference_entry_path(entry, root), ENTRY,
                         "a reference entry")


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple       # the metric entries this cell reports
    per_layer: tuple
    root: Path = ROOT       # where its entries and readers are found


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

"""Every cell resolves by name to its files, and a new cell is data."""
from __future__ import annotations

import json
import shutil
import time

import pytest

from vobench import run, spec


def bench():
    return spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_every_cell_resolves():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["source"] in ("mem", "png")
        assert cell.traffic["loop"] in ("closed", "open")
        entry = cell.config["entry"]
        assert spec.entry_path(entry).is_file(), entry
        assert spec.reference_entry_path(entry).is_file(), entry
        for key in ("rig", "camera_hz", "entry", "vo", "scene", "motion",
                    "reduced", "assumed", "check"):
            assert key in cell.config, (w["name"], key)


def test_config_files_state_reduced_keys():
    for c in bench()["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg


def test_metrics_name_real_cells_and_readers():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
        mod = spec.load_layer(m["name"])
        assert mod.UNIT == m["unit"] and mod.LAYER == m["layer"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m.get("workloads", cells):  # each reports what it moves
            reported = {e["name"] for e in spec.load_cell(cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)
    for m in b["end_to_end"]:
        assert callable(spec.load_end_to_end(m["name"]).read)
    for name in cells:      # every cell reports setup_s, another end-to-end
        cell = spec.load_cell(name)     # metric and a per-layer one
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_a_new_cell_is_new_files_and_entries(tmp_path, tiny, clock):
    """A cell of a new configuration and a new traffic mix, added as data
    alone, runs through the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "vobench", root / "vobench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = bench()
    cfg = spec.load_json(spec.ROOT / "vobench/configs/kitti00-vo-brief.json")
    cfg["name"] = "kitti00-vo-brief128"
    cfg["vo"]["desc_bytes"] = 16
    (root / "vobench/configs/kitti00-vo-brief128.json").write_text(
        json.dumps(cfg))
    traffic = spec.load_json(spec.traffic_path("replay-mem"))
    traffic["unique_pairs"] = 12
    (root / "vobench/traffic/replay-mem-d2.json").write_text(
        json.dumps(traffic))
    b["configs"].append({"name": cfg["name"], "source": "x",
                         "file": "vobench/configs/kitti00-vo-brief128.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "kitti00-vo-brief128.replay-mem-d2",
                           "config": cfg["name"], "traffic": "replay-mem-d2",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "kitti00-vo-brief.replay-mem" in \
                m["workloads"]:
            m["workloads"].append("kitti00-vo-brief128.replay-mem-d2")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("kitti00-vo-brief128.replay-mem-d2", root=root)
    assert cell.config["vo"]["desc_bytes"] == 16
    assert cell.traffic["unique_pairs"] == 12
    from conftest import shrink
    res = run.run_cell(shrink(cell), 5, 1.5, False, "cpu", clock)
    assert res.correct
    assert set(res.metrics) == {"frames_per_s", "setup_s"}


def test_build_clock_times_only_builds_that_compile(tmp_path, monkeypatch):
    from front_end_tpu_torch.ops.kernels import _build
    from vobench.program import BuildClock
    orig = _build.build
    have = tmp_path / "libhave.so"
    have.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path",
                        lambda n: have if n == "have" else tmp_path / n)
    monkeypatch.setattr(_build, "build",
                        lambda *names: time.sleep(1e-3) or {})
    patched = _build.build
    with BuildClock() as clock:
        _build.build("have")
        assert clock.built == 0 and clock.seconds == 0.0
        _build.build("have", "new")
    assert clock.built == 1 and clock.seconds > 0.0
    assert _build.build is patched and patched is not orig


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")

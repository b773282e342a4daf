"""What the harness and its reference load, by whole top-level names."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "front_end_tpu"}


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _loaded("import vobench.run, vobench.program, vobench.check, "
                   "vobench.calibrate, vobench.trace\n"
                   "from vobench import spec\n"
                   "[spec.load_layer(m['name']) for m in "
                   "spec.load_json(spec.ROOT / 'BENCHMARK.json')"
                   "['per_layer']]\n"
                   "[spec.load_entry(p.stem) for p in "
                   "(spec.ROOT / 'vobench/entries').glob('[!_]*.py')]")
    assert not tops & JAX
    assert "front_end_tpu_torch" in tops        # the port, loaded whole


def test_reference_loads_neither_jax_nor_the_port():
    """Every reference entry, found by name as the check finds it."""
    entries = sorted(p.stem for p in
                     (ROOT / "vobench/reference/entries").glob("[!_]*.py"))
    assert {"vo", "window"} <= set(entries)
    tops = _loaded("import vobench.check\n"
                   "from vobench import spec\n"
                   f"[spec.load_reference_entry(e) for e in {entries!r}]")
    assert not tops & (JAX | {"front_end_tpu_torch"})


def test_no_card_no_numbers():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "vobench", "--workload",
                        "kitti00-vo-brief.replay-mem", "--seed",
                        "9999999999", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with BENCHMARK.json and vobench/ only: no port."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "vobench", "--workload",
                        "kitti00-vo-brief.replay-mem", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout

"""The port stands alone: importing every module of `front_end_tpu_torch`,
and `chip_smoke.py`, loads neither JAX nor anything of the JAX package;
nor does the port's command line, which does not load the root
`bench.py` either; `chip_smoke.py` refuses to run, and prints no result,
without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import front_end_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "front_end_tpu"))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 73, out.stdout
    assert bad == "[]", bad


@pytest.mark.parametrize("script", ["profile_torch_vo",
                                    "tests._torch_dist_worker"])
def test_port_scripts_import_no_jax(script):
    """The measuring script beside `chip_smoke.py`, and the module the
    multi-process tests' ranks import, load no JAX."""
    code = (f"import sys, {script}\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'front_end_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_module_of_the_port_is_walked():
    """The probe above imports what `pkgutil` finds; hold that it finds
    the service, windowed and descriptor modules and the kernel wrappers."""
    import pkgutil

    import front_end_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in ("features", "services", "ops.orb", "ops.brisk", "ops.freak",
                "ops.surf", "ops.subpix",
                "ops.kernels.fast_detect", "ops.kernels.fast_margins",
                "pipeline.control", "pipeline.window_vo", "window.tracker",
                "ba.factors", "ba.schur",
                "cli", "io.feed", "io.kitti", "io.euroc", "io.rectify",
                "io.native_feed", "native", "pipeline.telemetry",
                "utils.checkpoint", "utils.png", "eval.metrics", "viz.draw",
                "sim.synthetic", "ba.distributed", "analysis.sweeps",
                "analysis.report", "analysis.explore", "viz.svg", "bench",
                "pipeline.cuda_graphs"):
        assert f"front_end_tpu_torch.{mod}" in names, mod


def test_cli_help_loads_no_jax_and_no_bench():
    """`python -m front_end_tpu_torch.cli --help` (and each command's
    help) loads no `jax`, `flax`, `front_end_tpu` or root `bench`
    module, and lists the commands the port has: all nine of the JAX
    command's, `bench` and `vo --shard-ba` among them."""
    code = (
        "import runpy, sys\n"
        "for argv in (['--help'], ['vo', '--help'], "
        "['detect-sweep', '--help'], ['extract-motion', '--help'], "
        "['ba-scaling', '--help'], ['report', '--help'], "
        "['explore', '--help'], ['bench', '--help']):\n"
        "    sys.argv = ['front_end_tpu_torch.cli', *argv]\n"
        "    try:\n"
        "        runpy.run_module('front_end_tpu_torch.cli', "
        "run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'front_end_tpu', 'bench')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert ("{gen-table,detect-sweep,extract-motion,ba-scaling,"
            "ransac-smoke,vo,report,explore,bench}") in out.stdout
    assert "--stage-calls" in out.stdout and "--rendered-frames" in out.stdout
    assert "--shard-ba" in out.stdout and "--device" in out.stdout
    assert "--multihost" in out.stdout and "--devices" in out.stdout


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None

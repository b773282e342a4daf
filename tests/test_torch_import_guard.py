"""The port stands alone: importing every module of `front_end_tpu_torch`,
and `chip_smoke.py`, loads neither JAX nor anything of the JAX package;
`chip_smoke.py` refuses to run, and prints no result, without a card."""
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
    assert int(count) >= 41, out.stdout
    assert bad == "[]", bad


@pytest.mark.parametrize("script", ["profile_torch_vo"])
def test_port_scripts_import_no_jax(script):
    """The measuring script beside `chip_smoke.py` runs where JAX is not
    installed."""
    code = (f"import sys, {script}\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'front_end_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_module_of_the_port_is_walked():
    """The probe above imports what `pkgutil` finds; hold that it finds
    the service and windowed modules and both new kernel wrappers."""
    import pkgutil

    import front_end_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in ("features", "services", "ops.orb", "ops.brisk",
                "ops.kernels.fast_detect", "ops.kernels.fast_margins",
                "pipeline.control", "pipeline.window_vo", "window.tracker",
                "ba.factors", "ba.schur"):
        assert f"front_end_tpu_torch.{mod}" in names, mod


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

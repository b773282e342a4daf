"""Build CUDA sources of `front_end_tpu_torch/csrc/` for the CPU: each
launch `k<<<grid, block, 0, s>>>(...)` is rewritten to `emu_launch(grid,
block, k, ...)`, and the host's `g++ -std=c++20` compiles the result
against the stand-in `cuda_runtime.h` beside this file into a shared
library that `ctypes` loads.  Tests call `build` from a fixture; it skips
the test where there is no such compiler.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = Path(__file__).resolve().parent
CSRC = SHIM.parents[1] / "front_end_tpu_torch" / "csrc"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(\w+), (\w+), 0, s>>>\(")


def rewrite_launches(src: str) -> str:
    out = _LAUNCH.sub(r"emu_launch(\2, \3, \1, ", src)
    assert "<<<" not in out
    return out


def build(sources: dict, out: Path, signatures: dict) -> dict:
    """sources: library name -> C++ source text (CUDA launches allowed);
    signatures: library name -> {C function: argtypes}.  Compiles all in
    parallel and returns {C function: loaded function}, each returning
    int."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    procs = {}
    for name, src in sources.items():
        (out / f"{name}.cpp").write_text(rewrite_launches(src))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(SHIM), "-I", str(CSRC), "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0 and b"c++20" in log.lower():
            pytest.skip("needs a g++ that knows -std=c++20")
        assert proc.returncode == 0, log.decode(errors="replace")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn_name, argtypes in signatures[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[fn_name] = fn
    return fns


def kernel_source(name: str) -> str:
    return (CSRC / f"{name}.cu").read_text()

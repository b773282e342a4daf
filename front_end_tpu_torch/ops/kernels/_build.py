"""Build the CUDA sources in `front_end_tpu_torch/csrc/` at first use.

Each source is compiled by `nvcc -shared` into its own library with a
plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with `ctypes`.  Libraries land in `front_end_tpu_torch/_build/`,
named by a digest of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  `build(...)` starts one `nvcc` per
source, all at once, and waits for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named source that has no library yet, in parallel.
    The compiler's register/spill report goes to `<library>.log`."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        log = out.decode(errors="replace")
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use.
    `signatures` maps each C function to its ctypes argument types; every
    function returns its `cudaGetLastError()` as an int."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)[name]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

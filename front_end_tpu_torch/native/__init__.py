"""Native (C++) host components of the port, built at first use with the
system toolchain.

The repository's `csrc/feed.cc` (a threaded PGM / PNG / raw decoder with
an ordered ring) is compiled as it is, read in place, into
`front_end_tpu_torch/_build/`, under a name that digests the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
The repository ships sources, not binaries.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG.parent / "csrc"
BUILD = PKG / "_build"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str, source: str, libs: tuple[str, ...] = ()) -> Path:
    """Compile csrc/<source> into _build/lib<name>-<digest>.so unless it is
    there already; return its path."""
    src = CSRC / source
    link = tuple(f"-l{lib}" for lib in libs)
    digest = hashlib.sha1(" ".join(FLAGS + link).encode() + b"\0"
                          + src.read_bytes()).hexdigest()[:12]
    out = BUILD / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(src), "-o", str(tmp), *link]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"no C++ toolchain: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"build of {source} failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def feed_library_path() -> Path:
    """Build (if needed) and return the stereo-feed shared object."""
    return build_library("fefeed", "feed.cc", libs=("png", "z", "pthread"))

"""The FAST CUDA kernels' own logic on the CPU: `csrc/fast_grid.cu`,
`fast_detect.cu` and `fast_margins.cu` compiled by the host's C++ compiler
against `tests/cuda_emulation/cuda_runtime.h` (threads of a block as host
threads, barriers for `__syncthreads` and the warp intrinsics) and held
against the plain PyTorch twins, bit for bit.

A CUDA kernel has no interpret mode; this is the nearest thing for kernels
that use nothing but shared memory, barriers and ballots.  It checks the
index arithmetic, the early rejection, the candidate lists and the NMS —
not that `nvcc` accepts the source or that the card runs it, which
`tests/test_torch_cuda.py` and `chip_smoke.py` do.  Skips where there is no
`g++` with C++20.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from front_end_tpu_torch.ops import fast as tfast
from front_end_tpu_torch.ops.kernels import fast_grid
from torch_parity import image

CSRC = Path(fast_grid.__file__).resolve().parents[2] / "csrc"
SHIM = Path(__file__).resolve().parent / "cuda_emulation"
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "fast_grid": [P] * 5 + [I] * 8 + [P],
    "fast_detect": [P, ctypes.c_float, P, ctypes.c_longlong, P] + [I] * 5
    + [P],
    "fast_margins": [P] * 3 + [I] * 4 + [P]}
TYPES = ["9_16", "7_12", "5_8"]
INF = float("inf")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU")
    out = tmp_path_factory.mktemp("emulated")
    procs = {}
    for name in SIGNATURES:
        src = (CSRC / f"{name}.cu").read_text()
        src, n = re.subn(r"(\w+<[^<>;]*>)\s*<<<(\w+), (\w+), 0, s>>>\(",
                         r"emu_launch(\2, \3, \1, ", src)
        assert n and "<<<" not in src
        (out / f"{name}.cpp").write_text(src)
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(SHIM), "-I", str(CSRC), "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    loaded = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0 and b"c++20" in log.lower():
            pytest.skip("needs a g++ that knows -std=c++20")
        assert proc.returncode == 0, log.decode(errors="replace")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = SIGNATURES[name], ctypes.c_int
        loaded[name] = fn
    return loaded


def _img(shape, fast_type, seed, integer=True):
    x = image(*shape, seed=seed, block=1 if fast_type == "5_8" else 6)
    if not integer:     # as a resized pyramid level has them
        x = x + np.random.RandomState(seed).uniform(0, 1, x.shape).astype(
            np.float32)
    return torch.as_tensor(x)


def _detect(libs, img, thr, fast_type, nms):
    imgs = img.reshape(-1, *img.shape[-2:]).contiguous()
    B, H, W = imgs.shape
    out = torch.full_like(imgs, float("nan"))
    tmap, scalar, stride = None, 0.0, 0
    if isinstance(thr, torch.Tensor):
        tmap = thr.contiguous()
        stride = 0 if tmap.dim() == 2 else H * W
    else:
        scalar = float(thr)
    rc = libs["fast_detect"](
        imgs.data_ptr(), scalar, None if tmap is None else tmap.data_ptr(),
        stride, out.data_ptr(), B, H, W, len(tfast.TYPES[fast_type][0]),
        int(nms), None)
    assert rc == 0
    return out.reshape(img.shape)


@pytest.mark.parametrize("nms", [True, False])
@pytest.mark.parametrize("fast_type", TYPES)
def test_emulated_detect_kernel_equals_plain(libs, fast_type, nms):
    """Thresholds from -inf (every pixel a candidate of both classes) to
    15, a per-pixel map with negative values, a batched map; shapes below
    one tile, odd ones, a batch; integer and non-integer pixels.  The
    stand-in reports 4 SMs, so the one-tile image takes windows of 16 rows
    and the others of 32."""
    rs = np.random.RandomState(7)
    for shape in [(45, 70), (7, 9), (2, 33, 40)]:
        n = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        img = torch.stack([_img(shape[-2:], fast_type, 3 + k, k == 0)
                           for k in range(n)]).reshape(shape)
        thrs = [-INF, -1.0, 1.0, 15.0, torch.as_tensor(
            rs.randint(-2, 30, shape[-2:]).astype(np.float32))]
        if len(shape) == 3:
            thrs.append(torch.as_tensor(rs.uniform(0, 30, shape).astype(
                np.float32)))
        for thr in thrs:
            got = _detect(libs, img, thr, fast_type, nms)
            ref = tfast.detect_dense_plain(img, thr, fast_type, nms)
            assert torch.equal(got, ref), (shape, thr)
    flat = torch.full((40, 50), 7.0)
    for thr in (-1.0, 0.0):
        assert torch.equal(_detect(libs, flat, thr, fast_type, nms),
                           tfast.detect_dense_plain(flat, thr, fast_type,
                                                    nms))


@pytest.mark.parametrize("fast_type", TYPES)
def test_emulated_grid_kernel_equals_plain(libs, fast_type):
    """Even and odd cells, cells smaller than a tile, thresholds per cell
    from every-pixel-a-candidate to none; the one-cell image takes windows
    of 16 rows, the others of 32."""
    for (H, W), (Gr, Gc) in [((93, 139), (2, 3)), ((40, 54), (2, 3)),
                             ((30, 44), (1, 1))]:
        imgs = torch.stack([_img((H, W), fast_type, 11),
                            _img((H, W), fast_type, 12, integer=False)])
        cell = (Gr, Gc, H // Gr, W // Gc)
        ph, pw = fast_grid.pooled_dims(cell[2], cell[3])
        for lo, hi in [(6, 20), (-2, 2), (-300, -299), (200, 201)]:
            thr = torch.as_tensor(np.random.RandomState(5).randint(
                lo, hi, (2, Gr, Gc)).astype(np.float32))
            pooled = torch.full((2, Gr, Gc, ph * pw), float("nan"))
            code = torch.full((2, Gr, Gc, ph * pw), 9, dtype=torch.uint8)
            counts = torch.zeros((2, Gr, Gc), dtype=torch.int32)
            rc = libs["fast_grid"](
                imgs.data_ptr(), thr.data_ptr(), pooled.data_ptr(),
                code.data_ptr(), counts.data_ptr(), 2, H, W, Gr, Gc, cell[2],
                cell[3], len(tfast.TYPES[fast_type][0]), None)
            assert rc == 0
            ref = fast_grid.plain(imgs, thr, cell, fast_type)
            for g, r in zip((pooled, code, counts), ref):
                assert torch.equal(g, r), (H, W, lo)


@pytest.mark.parametrize("fast_type", TYPES)
def test_emulated_margins_kernel_equals_plain(libs, fast_type):
    for shape, integer in [((45, 70), True), ((33, 38), False)]:
        img = _img(shape, fast_type, 1, integer)
        detect = torch.full_like(img, float("nan"))
        score = torch.full_like(img, float("nan"))
        rc = libs["fast_margins"](
            img.data_ptr(), detect.data_ptr(), score.data_ptr(), 1, *shape,
            len(tfast.TYPES[fast_type][0]), None)
        assert rc == 0
        ref_d, ref_s = tfast.fast_margins_plain(img, fast_type)
        assert torch.equal(detect, ref_d) and torch.equal(score, ref_s)

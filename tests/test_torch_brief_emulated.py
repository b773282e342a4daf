"""The dense BRIEF plane kernel's own logic on the CPU: `csrc/brief_planes.cu`
compiled by the host's C++ compiler against
`tests/cuda_emulation/cuda_runtime.h` (`cuda_emulation/emulate.py`) and held
against `ops/kernels/brief_planes.py::plain`, word for word: the staging
and its clamped halo, the pattern folded into address deltas on the host,
the rows of a thread, the ragged edge.  Not whether `nvcc` accepts the
source, which `tests/test_torch_cuda.py` and `chip_smoke.py` check.  Skips
where there is no `g++` with C++20.
"""
import ctypes

import numpy as np
import pytest
import torch

from cuda_emulation import emulate
from front_end_tpu_torch.ops import brief as tbrief
from front_end_tpu_torch.ops.kernels import brief_planes
from torch_parity import image

P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    return emulate.build(
        {"brief_planes": emulate.kernel_source("brief_planes")},
        tmp_path_factory.mktemp("brief"),
        {"brief_planes": {"brief_planes_launch": [P, P, P] + [I] * 4 + [P]}}
    )["brief_planes_launch"]


def _images(case):
    rs = np.random.RandomState(3)
    if case == "below_a_tile":
        return tbrief.smooth(torch.as_tensor(image(20, 25, seed=1)[None]))
    if case == "ragged_pair":
        return tbrief.smooth(torch.as_tensor(np.stack(
            [image(37, 53, seed=s) for s in (2, 3)])))
    if case == "wide":
        return tbrief.smooth(torch.as_tensor(image(100, 261, seed=4)[None]))
    if case == "ties":           # integer values, few of them
        return torch.as_tensor(rs.randint(0, 4, (1, 45, 70)).astype(
            np.float32))
    x = rs.randint(0, 6, (1, 45, 70)).astype(np.float32)   # non-finite
    x[0, 10:14, 20:23] = np.nan
    x[0, 30, 5:40] = np.inf
    x[0, 2:40, 60] = -np.inf
    x[0, 40, 40] = -0.0
    return torch.as_tensor(x)


@pytest.mark.parametrize(
    "case", ["below_a_tile", "ragged_pair", "wide", "ties", "non_finite"])
@pytest.mark.parametrize("n_bits", [128, 256, 512])
def test_emulated_brief_planes_kernel_equals_plain(launch, n_bits, case):
    img = _images(case).contiguous()
    B, H, W = img.shape
    pat = tbrief.brief_pattern(n_bits)
    offs = np.ascontiguousarray(np.asarray(pat).reshape(n_bits, 4), np.int8)
    out = torch.full((B, n_bits // 32, H, W), -1, dtype=torch.int32)
    assert launch(img.data_ptr(), out.data_ptr(), offs.ctypes.data, B, H, W,
                  n_bits, None) == 0
    ref = brief_planes.plain(img, pat).view(torch.int32)
    assert torch.equal(out, ref)


def test_emulated_brief_planes_rejects_bit_counts(launch):
    img = torch.zeros(1, 8, 8)
    out = torch.zeros(1, 17, 8, 8, dtype=torch.int32)
    offs = np.zeros((544, 4), np.int8)
    for n_bits in (0, 48, 544):
        assert launch(img.data_ptr(), out.data_ptr(), offs.ctypes.data, 1, 8,
                      8, n_bits, None) != 0

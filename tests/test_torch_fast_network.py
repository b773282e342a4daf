"""The FAST arc network of `csrc/fast_segment.cuh` (`arc_extreme`), the
segment test all three FAST kernels share, compiled for the CPU by the
host's C++ compiler (`cuda_emulation/emulate.py`) and held against a brute
force: per class the best over the N circular starts of the extreme over a
window of K ring values, for the three circle types.  Every binary ring
(2^16, 2^12, 2^8 of them: a min/max network that is right on all 0/1
inputs is right on all inputs, by the 0-1 principle of threshold
decomposition) and random float rings with ties and +-inf, bit for bit.
Skips where there is no `g++` with C++20.
"""
import ctypes

import numpy as np
import pytest

from cuda_emulation import emulate

HARNESS = r"""
#include "fast_segment.cuh"

template <int N, int K>
void run(const float* rings, long count, float* bright, float* dark) {
  for (long i = 0; i < count; ++i) {
    float w[N];
    for (int j = 0; j < N; ++j) w[j] = rings[i * N + j];
    bright[i] = arc_extreme<N, K, true>(w);
    dark[i] = arc_extreme<N, K, false>(w);
  }
}

extern "C" int arc_extremes(const float* rings, long count, int n,
                            float* bright, float* dark) {
  if (n == 16) run<16, 9>(rings, count, bright, dark);
  else if (n == 12) run<12, 7>(rings, count, bright, dark);
  else if (n == 8) run<8, 5>(rings, count, bright, dark);
  else return 1;
  return 0;
}
"""
P = ctypes.c_void_p
TYPES = {"9_16": (16, 9), "7_12": (12, 7), "5_8": (8, 5)}


@pytest.fixture(scope="module")
def arc_extremes(tmp_path_factory):
    return emulate.build(
        {"fast_network": HARNESS}, tmp_path_factory.mktemp("network"),
        {"fast_network": {"arc_extremes": [P, ctypes.c_long, ctypes.c_int,
                                           P, P]}})["arc_extremes"]


def _network(fn, rings):
    rings = np.ascontiguousarray(rings, np.float32)
    count, n = rings.shape
    bright = np.full(count, np.nan, np.float32)
    dark = np.full(count, np.nan, np.float32)
    assert fn(rings.ctypes.data, count, n, bright.ctypes.data,
              dark.ctypes.data) == 0
    return bright, dark


def _brute(rings, K):
    n = rings.shape[1]
    win = np.stack([rings[:, (s + np.arange(K)) % n] for s in range(n)], 1)
    return win.min(2).max(1), win.max(2).min(1)


def _rings(kind, n):
    if kind == "binary":
        return ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1).astype(
            np.float32)
    rs = np.random.RandomState(n)
    if kind == "ties":      # few distinct values, many ties, +-inf
        r = rs.randint(-3, 4, (20000, n)).astype(np.float32)
        r[rs.rand(*r.shape) < 0.05] = np.inf
        r[rs.rand(*r.shape) < 0.05] = -np.inf
        return r
    return rs.standard_normal((20000, n)).astype(np.float32) * 100.0


@pytest.mark.parametrize("kind", ["binary", "ties", "floats"])
@pytest.mark.parametrize("fast_type", list(TYPES))
def test_arc_network_equals_brute_force(arc_extremes, fast_type, kind):
    n, K = TYPES[fast_type]
    rings = _rings(kind, n)
    bright, dark = _network(arc_extremes, rings)
    ref_b, ref_d = _brute(rings, K)
    np.testing.assert_array_equal(bright, ref_b)
    np.testing.assert_array_equal(dark, ref_d)

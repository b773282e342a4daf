"""The table of peaks and the bytes and operations of the kernels whose
share of their roofline the benchmark reads (copied from the port's
`chip_smoke.py`).  Each input byte is counted read once and each output
byte written once; a launch's bound is the larger of its bytes over the
memory's rate and its operations over the rate of their kind.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit (a card set lower runs slower; the result line gives the limit).
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12          # HBM3
F32_OPS_S = 67e12              # float32 outside the tensor cores (FMA = 2)
CORE_OPS_S = F32_OPS_S / 2     # an add, subtract or logic op: 1 per lane
TENSOR_INT_OPS_S = 1979e12     # int8 tensor cores, standing in for 1-bit
# gate, key and min operations per pair the match kernel keeps on the CUDA
# cores, its popcounts being on the tensor cores (counted from the source)
MATCH_CORE_OPS = 12


def pooled_dims(ch: int, cw: int) -> tuple[int, int]:
    return -(-ch // 2), -(-cw // 2)


def fast_grid_seconds(B: int, H: int, W: int, Gr: int, Gc: int) -> float:
    """Least time of one `fast_grid` launch over B images of H x W: the
    float32 images and thresholds read, the pooled scores (float32) with
    their sub-position codes (uint8) and the int32 counts written.  The
    kernel skips the segment test where a bound proves a score 0, so the
    full test's operations are no floor: bytes bound it."""
    ch, cw = H // Gr, W // Gc
    ph, pw = pooled_dims(ch, cw)
    n_out = B * Gr * Gc * ph * pw
    by = B * H * W * 4 + B * Gr * Gc * 4 + n_out * 5 + B * Gr * Gc * 4
    return by / HBM_BYTES_S


def match_seconds(nq: int, nt: int, nw: int) -> float:
    """Least time of one `match_reduce` launch of nq queries against nt
    trains of nw 32-bit words: words, xy and validity read, (d1, d2, i1)
    per query and (min, arg) per train written; the popcounts on the
    tensor cores (an AND and a count per bit) beside the CUDA cores' gate,
    key and min operations, the longer of the two pipes."""
    pairs = nq * nt
    by = (nq + nt) * (nw * 4 + 8 + 1) + nq * 12 + nt * 8
    ops_s = max(pairs * 2 * 32 * nw / TENSOR_INT_OPS_S,
                pairs * MATCH_CORE_OPS / CORE_OPS_S)
    return max(by / HBM_BYTES_S, ops_s)

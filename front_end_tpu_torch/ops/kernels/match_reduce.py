"""Streaming masked-Hamming match kernel (`csrc/match_reduce.cu`).

Replaces `front_end_tpu/ops/pallas/match_kernel.py::match_reduce_pallas`
(Pallas body `_kernel`): descriptor matching without the (Nq, Nt)
distance matrix.  Per query: best distance d1, second best d2 = min over
columns other than the argmin (ties give d2 == d1), and the first-index
argmin i1.  Per train column: min and first-index arg.  Gates: `stereo`
(|Δy| ≤ p1, p2 ≤ Δx ≤ p3), `epi` (|Δy| ≤ p1), `roi` (box p1), `none`;
a gated pair counts as BIG = 1e9.

What bounds it on the H100: operations, and which ones is the design's
choice.  As XOR + `__popc` the Nq·Nt·(D/32) popcounts (2304² × 8 = 42 M at
the main path's shapes) run at 16 per clock per SM.  On the tensor cores
(`mma.sync.m16n8k256.b1.and.popc`: one instruction for 16 × 8 pairs of 256
bits) they cost next to nothing, and what is left is the dozen gate, key
and min operations per pair on the CUDA cores, then the two launches.
Inputs and outputs are ~150 KB.

Design: a 2-D grid, train splits × query tiles of 128, sized by `plan`
from Nq, Nt and the card's SM count to about four resident blocks on
every SM, so no wave leaves SMs idle.  A block stages its split's train
words and xy in shared memory once; each of its four warps holds 32
queries as register fragments and walks the split in tiles of 8 columns,
one shared read feeding the warp's 32 × 8 distances.  Hamming =
popc(a & ~b) + popc(~a & b): two products into one accumulator, the rows
held as a and ~a, so the distance leaves the tensor cores finished.
Validity is folded into the gate: an invalid or missing point gets NaN
coordinates, which fail every compare.  Distances are integers ≤ 512 or
"gated", so (distance, index) packs into a 32-bit key: 10 bits of
distance, 1023 for a gated pair, over 22 bits of index (hence N < 2²²).
The minimum key is "min distance, then lowest index", the argmin tie
rule, and the two smallest keys of a row give d1, i1 and d2 = the
distance of the second (equal best distances give d2 == d1).  Rows reduce
in registers; columns by a register min over the thread's rows, a warp
butterfly and one native 32-bit shared `atomicMin` per column and warp.
Blocks run in no order, so each writes a partial per (split, row) and per
(tile, column) into scratch from `torch.empty`, and a second small kernel,
`finalize` (one warp per row or column; `merge_partials` is its plain
twin), merges them: no memset, no global atomics, no host work.
`finalize` is a programmatic dependent launch: the card sets it up while
the main kernel drains.  No tile-divisibility limit: ragged edges are
masked with the all-ones key.  Integer popcounts are exact, so the kernel
equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from front_end_tpu_torch.ops.kernels import _build
from front_end_tpu_torch.types import unpack_bits
from front_end_tpu_torch.utils.precision import pinned_f32

launches = 0
BIG = 1e9
MODES = {"none": 0, "stereo": 1, "epi": 2, "roi": 3}
MAX_N = 1 << 22           # a key holds 22 bits of index
QUERIES_PER_BLOCK = 128   # csrc/match_reduce.cu: QPB
BLOCKS_PER_SM = 4         # resident blocks the grid is sized for
MIN_SPLIT = 32            # fewest train columns worth a block

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {"match_reduce_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                _P]}


def gate_mask(xyq, xyt, valid_q, valid_t, mode: str, p1=0.0, p2=0.0,
              p3=0.0):
    """(Nq, Nt) bool: pairs that pass validity and the mode's gate."""
    ok = valid_q[:, None] & valid_t[None, :]
    dx = xyq[:, None, 0] - xyt[None, :, 0]
    dy = (xyq[:, None, 1] - xyt[None, :, 1]).abs()
    if mode == "stereo":
        ok = ok & (dy <= p1) & (dx >= p2) & (dx <= p3)
    elif mode == "epi":
        ok = ok & (dy <= p1)
    elif mode == "roi":
        ok = ok & (dx.abs() <= p1) & (dy <= p1)
    elif mode != "none":
        raise ValueError(f"unknown match mode {mode!r}")
    return ok


def plain(words_q, words_t, xyq, xyt, valid_q, valid_t, mode: str,
          p1=0.0, p2=0.0, p3=0.0):
    """The plain PyTorch twin: the whole masked distance matrix, then the
    same five reductions (argmin/argmax ties go to the first index)."""
    bq, bt = unpack_bits(words_q), unpack_bits(words_t)
    with pinned_f32():      # {0,1} float32 products: exact integer sums
        ham = bq.sum(-1)[:, None] + bt.sum(-1)[None, :] - 2.0 * (bq @ bt.T)
    ok = gate_mask(xyq, xyt, valid_q, valid_t, mode, p1, p2, p3)
    dist = torch.where(ok, ham, torch.full_like(ham, BIG))
    i1 = dist.argmin(1)
    d1 = dist.gather(1, i1[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(cols[None, :] == i1[:, None], BIG, dist).amin(1)
    col_arg = dist.argmin(0)
    col_min = dist.gather(0, col_arg[None, :])[0]
    return d1, d2, i1.to(torch.int32), col_min, col_arg.to(torch.int32)


def merge_partials(blocks, row_starts, col_starts):
    """The plain twin of the kernel's `finalize` step.  `blocks[a][b]` is
    `plain(...)` of query tile a (rows from `row_starts[a]`) against train
    split b (columns from `col_starts[b]`); the result is `plain` of the
    whole sets.  Rows merge over splits: the winner by (d1, then lower
    index), d2 = min(d2a, d2b, max(d1a, d1b)).  Columns merge over tiles:
    min, then lower row."""
    rows = []
    for tile in blocks:
        d1, d2, i1 = tile[0][0], tile[0][1], tile[0][2] + col_starts[0]
        for blk, c0 in zip(tile[1:], col_starts[1:]):
            e1, e2, j1 = blk[0], blk[1], blk[2] + c0
            d2 = torch.minimum(torch.minimum(d2, e2), torch.maximum(d1, e1))
            take = e1 < d1                 # splits ascend: ties keep i1
            d1, i1 = torch.where(take, e1, d1), torch.where(take, j1, i1)
        rows.append((d1, d2, i1))
    cols = []
    for b in range(len(col_starts)):
        cmin, carg = blocks[0][b][3], blocks[0][b][4] + row_starts[0]
        for tile, r0 in zip(blocks[1:], row_starts[1:]):
            take = tile[b][3] < cmin       # tiles ascend: ties keep carg
            cmin = torch.where(take, tile[b][3], cmin)
            carg = torch.where(take, tile[b][4] + r0, carg)
        cols.append((cmin, carg))
    return tuple(torch.cat(x) for x in (*zip(*rows), *zip(*cols)))


def plan(Nq: int, Nt: int, sms: int):
    """(query tiles, train columns per split, splits): about
    `BLOCKS_PER_SM` blocks for each of the card's `sms` SMs."""
    tiles = -(-Nq // QUERIES_PER_BLOCK)
    want = max(1, round(sms * BLOCKS_PER_SM / tiles))
    cols = max(MIN_SPLIT, -(-Nt // want))
    cols = -(-cols // 8) * 8
    return tiles, cols, -(-Nt // cols)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(words):
    """Contiguous, 16-byte aligned words (the kernel reads uint4)."""
    x = words.view(torch.int32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def match_reduce(words_q, words_t, xyq, xyt, valid_q, valid_t, *,
                 mode: str = "none", p1: float = 0.0, p2: float = 0.0,
                 p3: float = 0.0):
    """Packed uint32 descriptors (N, D/32), xy (N, 2) float32, valid (N,)
    bool -> (d1, d2, i1) of shape (Nq,) and (col_min, col_arg) of (Nt,).
    Fewer than 2²² rows on either side."""
    if words_q.device.type == "cpu":
        return plain(words_q, words_t, xyq, xyt, valid_q, valid_t, mode,
                     p1, p2, p3)
    if words_q.device.type != "cuda":
        raise ValueError(f"match_reduce: unsupported device {words_q.device}")
    Nq, nw = words_q.shape
    Nt = words_t.shape[0]
    if (words_q.dtype != torch.uint32 or words_t.dtype != torch.uint32
            or words_t.shape[1] != nw or nw not in (4, 8, 16)):
        raise TypeError("match_reduce takes uint32 words, 4, 8 or 16 per "
                        "descriptor (128, 256 or 512 bits)")
    if not (0 < Nq < MAX_N and 0 < Nt < MAX_N):
        raise ValueError(f"match_reduce takes 1 to {MAX_N - 1} queries and "
                         f"trains, got {Nq} and {Nt}")
    dev = words_q.device
    f32, b8 = torch.float32, torch.bool
    q, t = _aligned(words_q), _aligned(words_t)
    xq, xt = xyq.to(f32).contiguous(), xyt.to(f32).contiguous()
    vq, vt = valid_q.to(b8).contiguous(), valid_t.to(b8).contiguous()
    d1 = torch.empty(Nq, dtype=f32, device=dev)
    d2 = torch.empty(Nq, dtype=f32, device=dev)
    i1 = torch.empty(Nq, dtype=torch.int32, device=dev)
    col_min = torch.empty(Nt, dtype=f32, device=dev)
    col_arg = torch.empty(Nt, dtype=torch.int32, device=dev)
    tiles, split_cols, splits = plan(Nq, Nt, _sm_count(dev))
    row_part = torch.empty((splits, Nq, 2), dtype=torch.int32, device=dev)
    col_part = torch.empty((tiles, Nt), dtype=torch.int32, device=dev)
    global launches
    lib = _build.library("match_reduce", _SIG)
    rc = lib.match_reduce_launch(
        q.data_ptr(), t.data_ptr(), xq.data_ptr(), xt.data_ptr(),
        vq.data_ptr(), vt.data_ptr(), Nq, Nt, nw, MODES[mode], p1, p2, p3,
        split_cols, tiles, d1.data_ptr(), d2.data_ptr(), i1.data_ptr(),
        col_min.data_ptr(), col_arg.data_ptr(), row_part.data_ptr(),
        col_part.data_ptr(), _build.stream_handle(dev))
    _build.check(rc, "match_reduce")
    launches += 1
    return d1, d2, i1, col_min, col_arg

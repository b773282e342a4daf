"""Row selection helpers (counterpart of `front_end_tpu/ops/dense_select.py`).

The JAX package replaces gathers and scatter-mins with one-hot matmuls on
the TPU only; off the TPU it uses the plain indexed forms, which are what
the GPU wants too.  Its sort-free top-k (`topk_onehot`, a bisection plus
an (M, K) one-hot matrix) is kept by its results only: `topk_select` is a
stable sort and plain indexing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9


def take_rows(X, idx):
    """X[idx] for (N,) integer idx."""
    return X[idx]


def lookup(table, idx):
    """table[idx] for an (M,) table."""
    return table[idx]


def segment_min(vals, seg, n: int, fill=BIG):
    """min over i with seg[i] == t of vals[i], for t in [0, n)."""
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg, vals, reduce="amin", include_self=True)


class TopK(NamedTuple):
    """A top-k selection over M rows, delivered in index order."""
    idx: torch.Tensor       # (k,) int64 selected rows, ascending; the
    #                         positions that are not valid hold M - 1
    valid: torch.Tensor     # (k,) bool — the first n_sel positions, where
    #                         n_sel = min(k, #rows with score > 0)


def topk_select(score, k: int) -> TopK:
    """The selection the JAX package's `topk_onehot` makes, without its
    bisection and one-hot matrix: the k rows of largest score among those
    with score > 0, ties to the lower index (`lax.top_k`'s rule, here a
    stable descending sort), delivered in INDEX order."""
    M = score.shape[0]
    v, i = torch.sort(score, descending=True, stable=True)
    kk = min(k, M)
    key = torch.where(v[:kk] > 0, i[:kk], M)     # M marks "not selected"
    if kk < k:
        key = torch.cat([key, key.new_full((k - kk,), M)])
    order = torch.sort(key).values
    return TopK(idx=order.clamp(max=M - 1), valid=order < M)


def compact_rows(sel: TopK, X):
    """(M, ...) -> (k, ...): the selected rows in index order, rows at the
    positions that are not valid zero (the JAX package's `compact_rows`)."""
    rows = X[sel.idx]
    keep = sel.valid.reshape((-1,) + (1,) * (X.ndim - 1))
    return rows & keep if X.dtype == torch.bool else rows * keep


def put_rows(dst, slot, val):
    """dst (M, ...) with val (N, ...) written at rows `slot` (N,), where
    slot == M means "discard".  Real slots must be distinct; the discards
    all land in one spare row that is dropped, so the result does not
    depend on the order of the writes."""
    M = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    buf[slot] = val.to(dst.dtype)
    return buf[:M]

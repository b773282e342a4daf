"""Descriptor matching (counterpart of `front_end_tpu/ops/match.py`).

The reference's three recipes — live stereo crossCheck with epipolar
(and disparity) gate, StereoCamera kNN(2) + Lowe + per-train uniqueness,
WindowMatcher inter-frame ROI + kNN + Lowe + uniqueness — on Hamming
distances for binary descriptors and L2 distances for float ones (`norm`,
the reference's `getMatcher` choice).  On Hamming distances the recipes
take their row and column reductions from the match kernel
(`ops/kernels/match_reduce.py`: the CUDA kernel on the card, its plain
twin on the CPU), so the (N, N) matrix is never built on the card;
mutuality, Lowe and uniqueness are O(N) epilogues.  On L2 distances they
build the matrix as the JAX package does — sqrt(‖a‖² + ‖b‖² − 2a·b) from
one float32 matrix product (TF32 off under the entry points' pin) plus
additive gate masks — and reduce it with `mutual_match` / `knn_lowe`.
"""
from __future__ import annotations

import torch

from front_end_tpu_torch.ops.dense_select import lookup, segment_min
from front_end_tpu_torch.ops.kernels.match_reduce import match_reduce
from front_end_tpu_torch.types import Descriptors, Keypoints, Matches
from front_end_tpu_torch.utils.precision import pinned_f32

BIG = 1e9


def hamming_matrix(da: Descriptors, db: Descriptors):
    """(Na, D), (Nb, D) {0,1} bits -> (Na, Nb) float32 Hamming distances."""
    a, b = da.bits, db.bits
    with pinned_f32():
        ab = a @ b.T
    return a.sum(-1)[:, None] + b.sum(-1)[None, :] - 2.0 * ab


def l2sq_matrix(a, b):
    """(Na, D), (Nb, D) float -> (Na, Nb) squared L2 distances, clamped at
    0 (the cancellation of ‖a‖² + ‖b‖² − 2a·b can go below)."""
    with pinned_f32():
        ab = a @ b.T
    sa = (a * a).sum(-1)
    sb = (b * b).sum(-1)
    return (sa[:, None] + sb[None, :] - 2.0 * ab).clamp(min=0.0)


def _l2_dist(kq: Keypoints, dq: Descriptors, kt: Keypoints, dt: Descriptors):
    """L2 distance matrix with the validity mask added."""
    return (torch.sqrt(l2sq_matrix(dq.bits, dt.bits))
            + validity_mask(kq.valid, kt.valid))


def validity_mask(valid_a, valid_b):
    """Additive BIG where either row or column is padding."""
    ok = valid_a[:, None] & valid_b[None, :]
    return torch.where(ok, 0.0, BIG)


def epipolar_mask(kpa: Keypoints, kpb: Keypoints, threshold: float = 0.7):
    dy = (kpa.xy[:, None, 1] - kpb.xy[None, :, 1]).abs()
    return torch.where(dy <= threshold, 0.0, BIG)


def disparity_mask(kpa: Keypoints, kpb: Keypoints, max_disparity: float,
                   min_disparity: float = 0.0):
    d = kpa.xy[:, None, 0] - kpb.xy[None, :, 0]
    return torch.where((d >= min_disparity) & (d <= max_disparity), 0.0, BIG)


def roi_mask(kpa: Keypoints, kpb: Keypoints, box: float = 100.0):
    d = (kpa.xy[:, None, :] - kpb.xy[None, :, :]).abs()
    return torch.where((d[..., 0] <= box) & (d[..., 1] <= box), 0.0, BIG)


def _mutual(d1, i1, col_arg) -> Matches:
    ti = i1.to(torch.int64)
    rows = torch.arange(ti.shape[0], device=ti.device)
    valid = (lookup(col_arg.to(torch.int64), ti) == rows) & (d1 < BIG / 2)
    return Matches(train_idx=ti, distance=d1, valid=valid)


def _lowe(d1, d2, i1, ratio: float) -> Matches:
    ok = (d1 < ratio * d2) & (d1 < BIG / 2)
    return Matches(train_idx=i1.to(torch.int64), distance=d1, valid=ok)


def mutual_match(dist) -> Matches:
    """BFMatcher crossCheck on a distance matrix."""
    i1 = dist.argmin(1)
    return _mutual(dist.gather(1, i1[:, None])[:, 0], i1, dist.argmin(0))


def knn_lowe(dist, ratio: float = 0.8) -> Matches:
    """knnMatch(k=2) + Lowe ratio test on a distance matrix."""
    i1 = dist.argmin(1)
    d1 = dist.gather(1, i1[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(cols[None, :] == i1[:, None], BIG, dist).amin(1)
    return _lowe(d1, d2, i1, ratio)


def unique_per_train(m: Matches, n_train: int) -> Matches:
    """Per-train dedup: among queries matched to one train index keep the
    lowest distance; exact ties go to the first query."""
    d = torch.where(m.valid, m.distance, BIG)
    best = segment_min(d, m.train_idx, n_train)
    keep = m.valid & (d <= lookup(best, m.train_idx))
    nq = d.shape[0]
    qidx = torch.arange(nq, device=d.device)
    first = segment_min(torch.where(keep, qidx, nq), m.train_idx, n_train,
                        fill=nq)
    return m.replace(valid=keep & (qidx == lookup(first, m.train_idx)))


def _reduce(kq: Keypoints, dq: Descriptors, kt: Keypoints, dt: Descriptors,
            **gate):
    return match_reduce(dq.words(), dt.words(), kq.xy, kt.xy, kq.valid,
                        kt.valid, **gate)


def _check_norm(norm: str):
    if norm not in ("hamming", "l2"):
        raise ValueError(f"unknown norm {norm!r}")


def stereo_match_live(kl: Keypoints, dl: Descriptors,
                      kr: Keypoints, dr: Descriptors,
                      *, epi_threshold: float = 0.7,
                      max_disparity: float | None = None,
                      norm: str = "hamming") -> Matches:
    """The live_stereo recipe: crossCheck match with the epipolar (and
    optional disparity) gate fused in."""
    _check_norm(norm)
    if norm == "l2":
        dist = _l2_dist(kl, dl, kr, dr) + epipolar_mask(kl, kr,
                                                        epi_threshold)
        if max_disparity is not None:
            dist = dist + disparity_mask(kl, kr, max_disparity)
        return mutual_match(dist)
    if max_disparity is not None:
        gate = dict(mode="stereo", p1=float(epi_threshold), p2=0.0,
                    p3=float(max_disparity))
    else:
        gate = dict(mode="epi", p1=float(epi_threshold))
    d1, _d2, i1, _cm, col_arg = _reduce(kl, dl, kr, dr, **gate)
    return _mutual(d1, i1, col_arg)


def stereo_match_knn(kl: Keypoints, dl: Descriptors,
                     kr: Keypoints, dr: Descriptors,
                     *, epi_threshold: float = 1.0, ratio: float = 0.8,
                     norm: str = "hamming") -> Matches:
    """The StereoCamera recipe: epipolar gate, kNN(2) + Lowe, per-train
    uniqueness."""
    _check_norm(norm)
    if norm == "l2":
        m = knn_lowe(_l2_dist(kl, dl, kr, dr)
                     + epipolar_mask(kl, kr, epi_threshold), ratio)
        return unique_per_train(m, kr.capacity)
    d1, d2, i1, _cm, _ca = _reduce(kl, dl, kr, dr, mode="epi",
                                   p1=float(epi_threshold))
    return unique_per_train(_lowe(d1, d2, i1, ratio), kr.capacity)


def interframe_match(kc: Keypoints, dc: Descriptors,
                     kp: Keypoints, dp: Descriptors,
                     *, box: float = 100.0, ratio: float = 0.8,
                     norm: str = "hamming") -> Matches:
    """WindowMatcher inter-frame recipe: ROI box gate, kNN(2) + Lowe,
    per-train uniqueness."""
    _check_norm(norm)
    if norm == "l2":
        m = knn_lowe(_l2_dist(kc, dc, kp, dp) + roi_mask(kc, kp, box), ratio)
        return unique_per_train(m, kp.capacity)
    d1, d2, i1, _cm, _ca = _reduce(kc, dc, kp, dp, mode="roi",
                                   p1=float(box))
    return unique_per_train(_lowe(d1, d2, i1, ratio), kp.capacity)

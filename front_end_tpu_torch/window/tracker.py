"""Sliding-window landmark tracker: the map state of the front end
(counterpart of `front_end_tpu/window/tracker.py`).

A FIXED-CAPACITY landmark store (capacity M) where every row is a
landmark slot carrying its world position, its current descriptor (binary:
bits and packed words, kept in step; SURF: float values, no words), its
last-seen frame index and a per-window-slot measurement history (W, 4) +
visibility.  Track association is one match of the current frame's
descriptors against the store (ROI-gated; Hamming on the match kernel on
the card, or the L2 distance matrix for float descriptors); unmatched
stereo features claim recycled slots — dead slots first, then expired
ones, each tier in index order.  The window is a shift register over the
W measurement slots: evict the oldest.

Where the JAX package writes rows through one-hot matrix products, the
port writes them by index into a buffer with one spare row that takes
every discarded feature (`dense_select.put_rows`): claimed slots are
distinct by construction, so the result is deterministic and equals the
JAX package's slot for slot.  The frame index rides on the host (a Python
int), so callers can schedule the windowed BA without waiting on the
device; the number of valid window poses is min(frame_idx, W) by
construction.

The windowed BA is several hundred small kernels an iteration, each
dispatched from Python; `run_window_ba` replays it as one CUDA graph a key
through `pipeline/cuda_graphs.py`, with `_window_ba` (the outlier gate, the
top-K selection, `schur.ba_solve` and the store write) as the eager body,
which a process group's sharded solve always runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from front_end_tpu_torch.ba import distributed, factors, schur
from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops import match as match_mod
from front_end_tpu_torch.ops.dense_select import (compact_rows, put_rows,
                                                  topk_select)
from front_end_tpu_torch.pipeline import cuda_graphs, telemetry
from front_end_tpu_torch.types import Descriptors, Keypoints
from front_end_tpu_torch.utils.precision import f32_precision, resolve_device


@dataclass(frozen=True)
class TrackerConfig:
    capacity: int = 4096        # M slots
    window: int = 3             # W frames
    desc_bits: int = 256
    roi_box: float = 100.0
    lowe_ratio: float = 0.8
    max_age: int = 3            # frames
    norm: str = "hamming"


class LandmarkStore(NamedTuple):
    Xw: torch.Tensor          # (M, 3) world-frame position
    bits: torch.Tensor        # (M, D) current descriptor: {0,1} or floats
    packed: torch.Tensor | None  # (M, D/32) uint32, the bits packed; None
    #                           for float descriptors (norm "l2")
    xy: torch.Tensor          # (M, 2) last observed left-image position
    last_seen: torch.Tensor   # (M,) int32 frame index, -1 = free
    valid: torch.Tensor       # (M,) bool
    meas: torch.Tensor        # (M, W, 4) [ul,vl,ur,vr] measurement window
    vis: torch.Tensor         # (M, W) bool — observed in window slot w
    track_len: torch.Tensor   # (M,) int32 — consecutive observations


class WindowState(NamedTuple):
    store: LandmarkStore
    poses: torch.Tensor       # (W, 4, 4) camera_from_world of window slots
    pose_valid: torch.Tensor  # (W,) bool
    frame_idx: int            # frames ingested so far (host)


class TrackUpdate(NamedTuple):
    state: WindowState
    matches: torch.Tensor     # (N,) int32 store slot per feature (-1)
    n_tracked: torch.Tensor
    n_new: torch.Tensor


def init_state(cfg: TrackerConfig, device="cuda") -> WindowState:
    """An empty window on `device` (the card unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    M, W, D = cfg.capacity, cfg.window, cfg.desc_bits
    f32, i32 = torch.float32, torch.int32
    store = LandmarkStore(
        Xw=torch.zeros((M, 3), dtype=f32, device=dev),
        bits=torch.zeros((M, D), dtype=f32, device=dev),
        packed=(torch.zeros((M, D // 32), dtype=i32,
                            device=dev).view(torch.uint32)
                if cfg.norm == "hamming" else None),
        xy=torch.full((M, 2), -1e6, dtype=f32, device=dev),
        last_seen=torch.full((M,), -1, dtype=i32, device=dev),
        valid=torch.zeros(M, dtype=torch.bool, device=dev),
        meas=torch.zeros((M, W, 4), dtype=f32, device=dev),
        vis=torch.zeros((M, W), dtype=torch.bool, device=dev),
        track_len=torch.zeros(M, dtype=i32, device=dev))
    return WindowState(
        store=store,
        poses=torch.eye(4, dtype=f32, device=dev).repeat(W, 1, 1),
        pose_valid=torch.zeros(W, dtype=torch.bool, device=dev),
        frame_idx=0)


def _advance_window(store: LandmarkStore, poses, pose_valid):
    """Shift the measurement window left by one (evict slot 0)."""
    meas = torch.cat([store.meas[:, 1:], torch.zeros_like(store.meas[:, :1])],
                     1)
    vis = torch.cat([store.vis[:, 1:], torch.zeros_like(store.vis[:, :1])], 1)
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device)[None]
    poses = torch.cat([poses[1:], eye])
    pose_valid = torch.cat([pose_valid[1:], torch.zeros_like(pose_valid[:1])])
    return store._replace(meas=meas, vis=vis), poses, pose_valid


def _hit(slot, M: int):
    """(M,) bool: slots named by `slot` (slot == M means none)."""
    hit = torch.zeros(M + 1, dtype=torch.bool, device=slot.device)
    hit[slot] = True
    return hit[:M]


def _put_words(dst, slot, words):
    """`put_rows` for packed uint32 words, through their int32 view (None
    where float descriptors keep no words)."""
    if dst is None or words is None:
        return None
    return put_rows(dst.view(torch.int32), slot,
                    words.view(torch.int32)).view(torch.uint32)


@f32_precision
def update(state: WindowState, kps: Keypoints, desc: Descriptors, X_cam,
           stereo_valid, uv4, pose_cur, cfg: TrackerConfig,
           rig: StereoRig) -> TrackUpdate:
    """Ingest one frame's stereo features.  Span `tracker.match` around
    the association; counters `tracker.tracked` (the features associated
    with a landmark) and `tracker.new` (the landmarks allocated).

    kps/desc/X_cam/stereo_valid/uv4: the frame's left features, stereo
    triangulations (camera frame) and stereo measurements (capacity N).
    pose_cur: (4, 4) camera_from_world extrinsic of this frame."""
    store = state.store
    M = cfg.capacity
    N = kps.capacity
    fidx = state.frame_idx
    dev = pose_cur.device
    norm = cfg.norm
    words = desc.words() if norm == "hamming" else None

    store, poses, pose_valid = _advance_window(store, state.poses,
                                               state.pose_valid)
    poses = torch.cat([poses[:-1], pose_cur[None]])
    pose_valid = torch.cat([pose_valid[:-1], torch.ones_like(pose_valid[:1])])

    # ---- track association --------------------------------------------
    recently = store.valid & (fidx - store.last_seen <= cfg.max_age)
    zeros = torch.zeros(M, dtype=torch.float32, device=dev)
    lm_kps = Keypoints(xy=store.xy, score=zeros, angle=zeros, valid=recently)
    cur_valid = kps.valid & stereo_valid
    with telemetry.span("tracker.match"):
        m = match_mod.interframe_match(
            kps.replace(valid=cur_valid), Descriptors(desc.bits, words, norm),
            lm_kps, Descriptors(store.bits, store.packed, norm),
            box=cfg.roi_box, ratio=cfg.lowe_ratio, norm=norm)
    tracked = m.valid & cur_valid                          # (N,)
    telemetry.count("tracker.tracked", tracked)
    slot_of_feature = torch.where(tracked, m.train_idx, -1)

    # ---- write tracked observations -----------------------------------
    Xw_cur = se3.transform_points(se3.invert_homog(pose_cur), X_cam)
    tslot = torch.where(tracked, m.train_idx, M)           # M = discard
    hit_t = _hit(tslot, M)
    last = store.meas.shape[1] - 1
    meas = store.meas.clone()
    meas[:, last] = put_rows(meas[:, last], tslot, uv4)
    vis = store.vis.clone()
    vis[:, last] |= hit_t
    store = store._replace(
        bits=put_rows(store.bits, tslot, desc.bits),
        packed=_put_words(store.packed, tslot, words),
        xy=put_rows(store.xy, tslot, kps.xy),
        last_seen=torch.where(hit_t, fidx, store.last_seen),
        meas=meas, vis=vis,
        track_len=store.track_len + hit_t.to(torch.int32))

    # ---- allocate new landmarks ---------------------------------------
    # Free slots: never used (dead) or expired (valid but unseen for more
    # than max_age frames).  All dead slots are claimed before ANY expired
    # one (an expired slot still holds a landmark the association could
    # re-acquire after a brief occlusion), each tier in index order, and
    # allocation stops at the free-slot count: live landmarks are never
    # overwritten.
    is_new = cur_valid & ~tracked
    dead = ~store.valid
    expired = store.valid & (fidx - store.last_seen > cfg.max_age)
    stale = dead | expired
    rank_dead = torch.cumsum(dead, 0) - 1                  # (M,)
    rank_exp = dead.sum() + torch.cumsum(expired, 0) - 1
    rank_slot = torch.where(dead, rank_dead, rank_exp)
    n_free = stale.sum()
    rank = torch.cumsum(is_new, 0) - 1                     # (N,)
    can_alloc = is_new & (rank < n_free)
    telemetry.count("tracker.new", can_alloc)
    # slot_for_rank[r] = the free slot of rank r; ranks at or beyond N and
    # occupied slots fall into a spare segment that is dropped
    seg = torch.where(stale, rank_slot, N).clamp(max=N)
    slot_for_rank = torch.full((N + 1,), M - 1, dtype=torch.int64,
                               device=dev).scatter_reduce(
        0, seg, torch.arange(M, device=dev), "amin", include_self=True)[:N]
    slot_new = slot_for_rank[rank.clamp(0, N - 1)]
    nslot = torch.where(can_alloc, slot_new, M)

    hit_n = _hit(nslot, M)
    # claimed slots restart: measurement window zeroed except the last
    # slot (this frame's uv4), visible only in the last slot
    meas = torch.where(hit_n[:, None, None], torch.zeros_like(store.meas),
                       store.meas)
    meas[:, last] = put_rows(meas[:, last], nslot, uv4)
    vis = store.vis & ~hit_n[:, None]
    vis[:, last] |= hit_n
    store = store._replace(
        Xw=put_rows(store.Xw, nslot, Xw_cur),
        bits=put_rows(store.bits, nslot, desc.bits),
        packed=_put_words(store.packed, nslot, words),
        xy=put_rows(store.xy, nslot, kps.xy),
        last_seen=torch.where(hit_n, fidx, store.last_seen),
        valid=store.valid | hit_n,
        meas=meas, vis=vis,
        track_len=torch.where(hit_n, 1, store.track_len))

    slot_of_feature = torch.where(can_alloc, slot_new, slot_of_feature)
    new_state = WindowState(store=store, poses=poses, pose_valid=pose_valid,
                            frame_idx=fidx + 1)
    return TrackUpdate(state=new_state,
                       matches=slot_of_feature.to(torch.int32),
                       n_tracked=tracked.sum(), n_new=can_alloc.sum())


def tracked_pairs(state_prev: WindowState, upd: TrackUpdate, X_cam_cur):
    """3D-3D correspondences between the previous state's landmark
    positions and the current frame's camera-frame triangulations, for
    the rigid RANSAC: (Xw_prev, X_cam_cur, valid)."""
    slot = upd.matches.clamp(min=0).to(torch.int64)
    return state_prev.store.Xw[slot], X_cam_cur, upd.matches >= 0


def run_window_ba(state: WindowState, rig: StereoRig, *, iters: int = 8,
                  huber_px: float = 3.0, min_obs: int = 2,
                  outlier_gate_px: float | None = 8.0,
                  max_landmarks: int | None = 1024, group=None):
    """Windowed BA over the store: optimise the W window poses and the
    landmarks observed at least `min_obs` times in the window.  Returns
    (updated state, BAResult).

    `outlier_gate_px`: observations whose reprojection residual at the
    initial state exceeds this are dropped before optimising (descriptor
    mis-associations land tens of pixels off; Huber alone still lets
    their saturated influence bias the window poses).

    `max_landmarks`: the solver runs on a COMPACTED problem — the top-K
    usable landmarks by in-window observation count (ties: longest track,
    then lowest slot).  None, or a K not below the capacity, solves the
    full grid.

    `group`: a `torch.distributed` process group (the JAX package's
    `mesh`).  The compacted block is then split by rank and solved
    landmark-sharded (`ba/distributed.py`); one `all_gather` gives every
    rank the refined landmarks back before the store write, where the JAX
    package gathers through its `out_specs`.  K must be below the capacity
    and divisible by the group's size.

    Counts `ba.landmarks` (the landmarks solved), one `ba.accepted` (0/1)
    an iteration and `ba.graph` (`pipeline/cuda_graphs.py`)."""
    store = state.store
    args = (store.Xw, store.meas, store.vis, store.valid, store.track_len,
            state.poses, state.pose_valid)
    Xw, res = _window_ba_graphs(
        args, (rig, iters, huber_px, min_obs, outlier_gate_px, max_landmarks,
               group), eager=group is not None)
    return state._replace(store=store._replace(Xw=Xw), poses=res.poses), res


@f32_precision
def _window_ba(Xw, meas, seen, valid, track_len, poses, pose_valid,
               rig: StereoRig, iters: int, huber_px: float, min_obs: int,
               outlier_gate_px: float | None, max_landmarks: int | None,
               group=None):
    """The windowed BA, run eagerly, on the store's positions `Xw`,
    measurements `meas`, visibility `seen`, `valid` and `track_len`, and
    the window's `poses` and `pose_valid`: (the store's new positions,
    BAResult)."""
    obs_count = seen.sum(1)
    use = valid & (obs_count >= min_obs)
    vis = seen & use[:, None] & pose_valid[None, :]
    if outlier_gate_px is not None:
        r = factors.residual(poses[None, :], Xw[:, None, :], meas, rig)
        vis = vis & ((r * r).sum(-1) < outlier_gate_px ** 2)

    M = Xw.shape[0]
    if group is not None and (max_landmarks is None or max_landmarks >= M):
        raise ValueError(
            "sharded window BA runs on the compacted problem: set "
            f"max_landmarks < store capacity {M} (and divisible by the "
            "group's size)")
    if max_landmarks is not None and max_landmarks < M:
        # integer-valued score: observation count, then track length
        score = torch.where(
            use, obs_count.to(torch.float32) * 1e4
            + track_len.clamp(max=9999).to(torch.float32) + 1.0,
            torch.zeros((), device=use.device))
        sel = topk_select(score, max_landmarks)
        telemetry.count("ba.landmarks", sel.valid)
        Xk, meask, visk = (compact_rows(sel, a) for a in (Xw, meas, vis))
        if group is None:
            res = schur.ba_solve(poses, Xk, meask, visk, rig,
                                 iters=iters, huber_px=huber_px)
            Xk = res.landmarks
        else:
            n, r = group.size(), group.rank()
            if max_landmarks % n:
                raise ValueError(f"max_landmarks={max_landmarks} not "
                                 f"divisible by the group's size {n}")
            res = distributed.ba_solve_sharded(
                group, poses,
                *(distributed.local_block(a, r, n) for a in (Xk, meask,
                                                             visk)),
                rig, iters=iters, huber_px=huber_px)
            Xk = distributed.all_gather(res.landmarks, group)
        return put_rows(Xw, torch.where(sel.valid, sel.idx, M), Xk), res

    telemetry.count("ba.landmarks", use)
    res = schur.ba_solve(poses, Xw, meas, vis, rig, iters=iters,
                         huber_px=huber_px)
    return torch.where(use[:, None], res.landmarks, Xw), res


_window_ba_graphs = cuda_graphs.Replayed(_window_ba, "ba")

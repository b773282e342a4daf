"""The stereo visual-odometry frame step (counterpart of
`front_end_tpu/pipeline/vo.py`).

    vo_step : (VOState, stereo pair) -> (VOState, VOFrameOutput)

Stages (the JAX package's stage map):
  1. adaptive grid FAST on L and R, one grid-kernel launch for the pair
  2. optional sub-pixel refinement (`ops/subpix.py`, capped at 0.3 px)
  3. description with the configured descriptor: BRIEF (one keypoint-
     kernel launch for the pair), ORB, BRISK, FREAK (binary) or SURF /
     SURF-extended (float, upright), after the descriptor's border mask
  4. stereo match: crossCheck + epipolar and disparity gates (Hamming:
     one match-kernel launch; SURF: the L2 distance matrix)
  5. Q triangulation of the matched pairs
  6. inter-frame match vs the previous left features: ROI + kNN + Lowe +
     uniqueness (Hamming: one match-kernel launch; SURF: L2 matrix)
  7. egomotion: 3-point rigid RANSAC, or (`motion="essential"`) 8-point
     essential RANSAC, the cheirality vote and the stereo scale; then the
     LM polish
  8. pose integration

Every stage keeps static shapes; thresholds, the previous frame's
features, the pose and the RANSAC generator ride in the carried state.
The step runs eagerly on the state's device and never waits on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import torch

from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.motion import essential as essential_mod
from front_end_tpu_torch.motion import lm as lm_mod
from front_end_tpu_torch.motion import ransac as ransac_mod
from front_end_tpu_torch.ops import brief as brief_mod
from front_end_tpu_torch.ops import brisk as brisk_mod
from front_end_tpu_torch.ops import freak as freak_mod
from front_end_tpu_torch.ops import grid as grid_mod
from front_end_tpu_torch.ops import match as match_mod
from front_end_tpu_torch.ops import orb as orb_mod
from front_end_tpu_torch.ops import subpix as subpix_mod
from front_end_tpu_torch.ops import surf as surf_mod
from front_end_tpu_torch.ops.dense_select import take_rows
from front_end_tpu_torch.types import Descriptors, Keypoints
from front_end_tpu_torch.utils.precision import f32_precision, resolve_device

# The live descriptor registry of the JAX package (the reference's
# benchmarked swap set plus BRISK): the matcher's norm, the width (None:
# 8 * desc_bytes) and the sampling radius inside which keypoints are
# dropped (None: BRIEF's).  "brief_pallas" picks a Pallas kernel on a TPU;
# here both BRIEF names run the keypoint kernel on the card.
DESCRIPTORS = {
    "brief": dict(norm="hamming", dim=None, border=None),
    "brief_pallas": dict(norm="hamming", dim=None, border=None),
    "orb": dict(norm="hamming", dim=None, border=None),
    "surf": dict(norm="l2", dim=64, border=24),
    "surf_ext": dict(norm="l2", dim=128, border=24),
    "freak": dict(norm="hamming", dim=512, border=30),
    "brisk": dict(norm="hamming", dim=512, border=30),
}
# the sub-pixel refinement's cap on the distance it moves a keypoint (px)
SUBPIX_MAX_SHIFT = 0.3


@dataclass(frozen=True)
class VOConfig:
    grid: grid_mod.GridConfig = field(default_factory=grid_mod.GridConfig)
    descriptor: str = "brief"
    desc_bytes: int = 32
    subpix: bool = False
    epi_threshold: float = 0.7
    max_disparity: float = 192.0
    track_box: float = 100.0
    lowe_ratio: float = 0.8
    ransac_hyps: int = 384
    ransac_threshold: float = 0.08
    motion: str = "rigid"
    lm_refine: bool = True
    lm_iters: int = 6
    min_track_inliers: int = 12

    def __post_init__(self):
        if self.descriptor not in DESCRIPTORS:
            raise ValueError(f"unknown descriptor {self.descriptor!r}")
        if self.motion not in ("rigid", "essential"):
            raise ValueError(f"unknown motion {self.motion!r}")

    @property
    def desc_dim(self) -> int:
        d = DESCRIPTORS[self.descriptor]["dim"]
        return d if d is not None else 8 * self.desc_bytes

    @property
    def desc_norm(self) -> str:
        return DESCRIPTORS[self.descriptor]["norm"]

    def replace(self, **kw) -> "VOConfig":
        from dataclasses import replace
        return replace(self, **kw)


class FrameFeatures(NamedTuple):
    """Per-frame feature state carried to the next step (capacity N)."""
    kps: Keypoints            # left keypoints
    bits: torch.Tensor        # (N, D) left descriptors: bits, or SURF's
    #                           float values
    packed: torch.Tensor | None  # (N, D/32) uint32, the bits packed; None
    #                           for float descriptors
    X: torch.Tensor           # (N, 3) stereo-triangulated landmarks
    stereo_valid: torch.Tensor  # (N,) had a stereo match
    uv4: torch.Tensor         # (N, 4) [ul, vl, ur, vr] of the stereo match


class VOState(NamedTuple):
    thresholds_l: torch.Tensor  # (Gr, Gc) adaptive controller state
    thresholds_r: torch.Tensor
    prev: FrameFeatures
    pose: torch.Tensor          # (4, 4) world_T_camera of current frame
    frame_idx: int
    generator: torch.Generator  # CPU generator of the default RANSAC draws


class VOFrameOutput(NamedTuple):
    pose: torch.Tensor          # (4, 4) world_T_camera after this frame
    motion: torch.Tensor        # (4, 4) extrinsic map prev -> cur
    n_detect_l: torch.Tensor
    n_detect_r: torch.Tensor
    n_stereo: torch.Tensor      # stereo matches this frame
    n_tracks: torch.Tensor      # inter-frame track candidates
    n_inliers: torch.Tensor     # motion consensus size
    motion_ok: torch.Tensor     # bool — enough inliers to trust the motion
    track_xy_prev: torch.Tensor  # (N, 2) prev-frame position of each track
    track_valid: torch.Tensor   # (N,) inter-frame candidate mask
    track_inliers: torch.Tensor  # (N,) motion-consensus mask


def empty_features(cfg: VOConfig, device) -> FrameFeatures:
    n, d = cfg.grid.capacity, cfg.desc_dim
    f32 = torch.float32
    return FrameFeatures(
        kps=Keypoints.empty(n, device),
        bits=torch.zeros((n, d), dtype=f32, device=device),
        packed=(torch.zeros((n, d // 32), dtype=torch.int32,
                            device=device).view(torch.uint32)
                if cfg.desc_norm == "hamming" else None),
        X=torch.zeros((n, 3), dtype=f32, device=device),
        stereo_valid=torch.zeros(n, dtype=torch.bool, device=device),
        uv4=torch.zeros((n, 4), dtype=f32, device=device))


def init_state(rig: StereoRig, cfg: VOConfig, seed: int = 0,
               device="cuda") -> VOState:
    """Initial state on `device` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    return VOState(
        thresholds_l=cfg.grid.init_thresholds(dev),
        thresholds_r=cfg.grid.init_thresholds(dev),
        prev=empty_features(cfg, dev),
        pose=torch.eye(4, dtype=torch.float32, device=dev),
        frame_idx=0,
        generator=torch.Generator().manual_seed(seed))


def _describe(left, right, kl, kr, cfg: VOConfig):
    """Stage 3 -> (kl, kr, desc_left, desc_right); ORB sets the keypoints'
    angles."""
    name = cfg.descriptor
    if name == "orb":
        sml, smr = brief_mod.smooth(left), brief_mod.smooth(right)
        angl = orb_mod.intensity_centroid_angle(left, kl.xy)
        angr = orb_mod.intensity_centroid_angle(right, kr.xy)
        kl, kr = kl.replace(angle=angl), kr.replace(angle=angr)
        return (kl, kr, orb_mod.describe(sml, kl.xy, angl, cfg.desc_bytes),
                orb_mod.describe(smr, kr.xy, angr, cfg.desc_bytes))
    if name in ("surf", "surf_ext"):
        # float descriptors, L2-matched (the reference's SURF and
        # SURF_EXTENDED live configurations), upright
        ext = name == "surf_ext"
        return (kl, kr,
                surf_mod.describe(left, kl.xy, extended=ext, upright=True),
                surf_mod.describe(right, kr.xy, extended=ext, upright=True))
    if name in ("freak", "brisk"):
        # the pair's ring blurs once, for both the angle and the bits
        mod = freak_mod if name == "freak" else brisk_mod
        pair = mod.blurs(torch.stack([left, right]))
        out = [kl, kr]
        for i, (img, k) in enumerate(((left, kl), (right, kr))):
            rings = [b[i] for b in pair]
            ang = mod.orientations(img, k.xy, k.valid, ring_imgs=rings)
            out.append(mod.describe(img, k.xy, ang, k.valid,
                                    ring_imgs=rings))
        return tuple(out)
    dl, dr = brief_mod.describe_pair(brief_mod.smooth(left),
                                     brief_mod.smooth(right), kl.xy, kr.xy,
                                     cfg.desc_bytes)
    return kl, kr, dl, dr


def _extract_frame(left, right, tl, tr, rig: StereoRig, cfg: VOConfig):
    """Stages 1-5: detection, refinement, description, stereo matching,
    triangulation."""
    detl, detr = grid_mod.detect_pair(left, right, tl, tr, cfg.grid)
    kl, kr = detl.keypoints, detr.keypoints
    if cfg.subpix:
        kl = kl.replace(xy=subpix_mod.corner_subpix(
            left, kl.xy, kl.valid, max_shift=SUBPIX_MAX_SHIFT))
        kr = kr.replace(xy=subpix_mod.corner_subpix(
            right, kr.xy, kr.valid, max_shift=SUBPIX_MAX_SHIFT))
    border = DESCRIPTORS[cfg.descriptor]["border"]
    bkw = {} if border is None else dict(border=border)
    kl = kl.replace(valid=kl.valid & brief_mod.valid_mask(
        kl.xy, rig.width, rig.height, **bkw))
    kr = kr.replace(valid=kr.valid & brief_mod.valid_mask(
        kr.xy, rig.width, rig.height, **bkw))

    kl, kr, dl, dr = _describe(left, right, kl, kr, cfg)
    if cfg.desc_norm == "hamming":   # packed once, read by both matches
        dl, dr = (Descriptors(d.bits, d.words()) for d in (dl, dr))
    m = match_mod.stereo_match_live(
        kl, dl, kr, dr, epi_threshold=cfg.epi_threshold,
        max_disparity=cfg.max_disparity, norm=cfg.desc_norm)

    xy_r = take_rows(kr.xy, m.train_idx)
    feats = FrameFeatures(kps=kl, bits=dl.bits, packed=dl.packed,
                          X=rig.triangulate(kl.xy, xy_r),
                          stereo_valid=m.valid,
                          uv4=torch.cat([kl.xy, xy_r], -1))
    stats = dict(n_detect_l=kl.count, n_detect_r=kr.count, n_stereo=m.count)
    return feats, detl.thresholds, detr.thresholds, stats


def _estimate_motion(sampler, cur: FrameFeatures, prev: FrameFeatures,
                     rig: StereoRig, cfg: VOConfig):
    """Stages 5-6: inter-frame association + egomotion."""
    norm = cfg.desc_norm
    tm = match_mod.interframe_match(
        cur.kps, Descriptors(cur.bits, cur.packed, norm),
        prev.kps, Descriptors(prev.bits, prev.packed, norm),
        box=cfg.track_box, ratio=cfg.lowe_ratio, norm=norm)
    Xp = take_rows(prev.X, tm.train_idx)
    uvp = take_rows(prev.uv4, tm.train_idx)
    pair_valid = (tm.valid & cur.stereo_valid
                  & take_rows(prev.stereo_valid, tm.train_idx))

    if cfg.motion == "essential":
        res = essential_mod.essential_scaled_motion(
            sampler, uvp, cur.uv4, Xp, cur.X, pair_valid, rig,
            n_hyps=cfg.ransac_hyps, threshold_px=1.0)
    else:
        res = ransac_mod.rigid_ransac(sampler, Xp, cur.X, pair_valid,
                                      n_hyps=cfg.ransac_hyps,
                                      threshold=cfg.ransac_threshold)
    H, inliers, n_inl = res.H, res.inliers, res.n_inliers
    if cfg.lm_refine:
        H = lm_mod.refine_motion(H, Xp, cur.uv4, inliers, rig,
                                 iters=cfg.lm_iters).H
    ok = n_inl >= cfg.min_track_inliers
    H = torch.where(ok, H, torch.eye(4, dtype=H.dtype, device=H.device))
    return H, dict(n_tracks=pair_valid.sum(), n_inliers=n_inl, motion_ok=ok,
                   track_xy_prev=uvp[:, :2], track_valid=pair_valid,
                   track_inliers=inliers)


@f32_precision
def vo_step(state: VOState, left, right, rig: StereoRig, cfg: VOConfig,
            sampler: Callable | None = None
            ) -> tuple[VOState, VOFrameOutput]:
    """Process one rectified stereo pair on the state's device.  `sampler`
    draws RANSAC minimal sets (default: `InverseCdfSampler` on the state's
    generator)."""
    dev = state.pose.device
    left = torch.as_tensor(left).to(device=dev, dtype=torch.float32)
    right = torch.as_tensor(right).to(device=dev, dtype=torch.float32)
    if sampler is None:
        sampler = ransac_mod.InverseCdfSampler(state.generator)

    cur, tl, tr, det = _extract_frame(left, right, state.thresholds_l,
                                      state.thresholds_r, rig, cfg)
    H, mot = _estimate_motion(sampler, cur, state.prev, rig, cfg)
    is_first = state.frame_idx == 0
    if is_first:     # no predecessor: identity motion
        H = torch.eye(4, dtype=H.dtype, device=dev)

    # X_cam_cur = H · X_cam_prev  =>  world_T_cur = world_T_prev · H⁻¹
    pose = state.pose @ se3.invert_homog(H)
    new_state = VOState(thresholds_l=tl, thresholds_r=tr, prev=cur,
                        pose=pose, frame_idx=state.frame_idx + 1,
                        generator=state.generator)
    out = VOFrameOutput(
        pose=pose, motion=H, n_detect_l=det["n_detect_l"],
        n_detect_r=det["n_detect_r"], n_stereo=det["n_stereo"],
        n_tracks=mot["n_tracks"], n_inliers=mot["n_inliers"],
        motion_ok=mot["motion_ok"] | is_first,
        track_xy_prev=mot["track_xy_prev"],
        track_valid=mot["track_valid"] & (not is_first),
        track_inliers=mot["track_inliers"] & (not is_first))
    return new_state, out


def swap_descriptor(state: VOState, new_cfg: VOConfig) -> VOState:
    """Mid-stream descriptor reconfig: pose, thresholds, frame index and
    generator carry over; the feature memory restarts at the new width and
    layout (descriptor families are not comparable across the swap, so the
    first frame after it finds no track and keeps the pose)."""
    return state._replace(prev=empty_features(new_cfg, state.pose.device))


def run_sequence(state: VOState, lefts, rights, rig: StereoRig,
                 cfg: VOConfig, sampler: Callable | None = None):
    """Step over a (T, H, W) stacked sequence; outputs stacked per field."""
    outs = []
    for left, right in zip(lefts, rights):
        state, out = vo_step(state, left, right, rig, cfg, sampler)
        outs.append(out)
    return state, VOFrameOutput(*(torch.stack(f) for f in zip(*outs)))

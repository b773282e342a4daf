"""Adaptive grid-bucketed FAST with per-cell threshold control, in plain
PyTorch (frozen from the port's `ops/grid.py`): 2x3 grid, per-cell float
threshold, +-1 feedback toward a per-cell set-point with a 20 % hysteresis
band, clipped to [min, max]; per-cell top-k by FAST score over the
2x2-pooled survivor map (the plain form of the grid kernel, `twins.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vobench.reference import twins as fast_grid
from vobench.reference.types import Keypoints


@dataclass(frozen=True)
class GridConfig:
    grid_rows: int = 2
    grid_cols: int = 3
    set_point: int = 1000
    min_threshold: float = 4.0
    max_threshold: float = 80.0
    init_threshold: float = 15.0
    hysteresis: float = 0.2
    cell_capacity: int = 512
    fast_type: str = "9_16"
    row_shares: tuple | None = None
    chunk_size: int = 1024
    chunk_topk: int = 128

    @property
    def capacity(self) -> int:
        return self.grid_rows * self.grid_cols * self.cell_capacity

    def cell_set_points(self, device=None):
        gs = self.set_point / (self.grid_rows * self.grid_cols)
        sp = torch.full((self.grid_rows, self.grid_cols), gs,
                        dtype=torch.float32, device=device)
        if self.row_shares is not None:
            sp = sp * torch.tensor(self.row_shares, dtype=torch.float32,
                                   device=device)[:, None]
        return sp

    def init_thresholds(self, device=None):
        return torch.full((self.grid_rows, self.grid_cols),
                          self.init_threshold, dtype=torch.float32,
                          device=device)


class GridDetections(NamedTuple):
    keypoints: Keypoints          # capacity Gr*Gc*cell_capacity
    thresholds: torch.Tensor      # (Gr, Gc) updated controller state
    cell_counts: torch.Tensor     # (Gr, Gc) post-NMS corner counts


def _cell_dims(H, W, cfg: GridConfig):
    return H // cfg.grid_rows, W // cfg.grid_cols


def _cell(H, W, cfg: GridConfig):
    return (cfg.grid_rows, cfg.grid_cols) + _cell_dims(H, W, cfg)


def _stable_topk(x, k: int):
    """Top-k along the last axis with `lax.top_k`'s tie rule: lower index
    first among equal values (`torch.topk` promises no tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _topk_2stage(cells, k: int, chunk: int, k0: int):
    """Per-chunk top-k0, then top-k over the chunk winners — the JAX
    package's hierarchical top-k (`grid.py:82-107`), reproduced as it is:
    it is exact only when no chunk holds more than k0 survivors."""
    *lead, M = cells.shape
    k0 = min(k0, chunk, k)
    C = -(-M // chunk)
    pad = C * chunk - M
    if pad:
        cells = torch.cat([cells, cells.new_full((*lead, pad), -1.0)], -1)
    v0, i0 = _stable_topk(cells.reshape(*lead, C, chunk), k0)
    base = (torch.arange(C, device=cells.device) * chunk)[:, None]
    flat0 = (i0 + base).reshape(*lead, C * k0)
    v0 = v0.reshape(*lead, C * k0)
    if C * k0 < k:  # small images: winner pool smaller than capacity
        short = k - C * k0
        v0 = torch.cat([v0, v0.new_full((*lead, short), -1.0)], -1)
        flat0 = torch.cat([flat0, flat0.new_zeros((*lead, short))], -1)
    v, sel = _stable_topk(v0, k)
    idx = torch.gather(flat0, -1, sel)
    return v, torch.clamp(idx, max=M - 1)


def update_thresholds(counts, thresholds, cfg: GridConfig):
    """The reference controller (`live_stereo.cpp:294-318`): ±1 when the
    post-NMS count misses the set-point by more than the hysteresis."""
    sp = cfg.cell_set_points(counts.device)
    err = counts.to(torch.float32) - sp
    move = err.abs() > cfg.hysteresis * sp
    delta = torch.where(err > 0, 1.0, -1.0) * move
    return torch.clamp(thresholds + delta, cfg.min_threshold,
                       cfg.max_threshold)


def _select_from_pooled(pooled, code, counts, thresholds, cfg: GridConfig,
                        H: int, W: int) -> GridDetections:
    """Controller update + per-cell top-k from the per-cell pooled maps
    (..., Gr, Gc, ph·pw) and their sub-position codes."""
    Gr, Gc = cfg.grid_rows, cfg.grid_cols
    ch, cw = _cell_dims(H, W, cfg)
    pw = fast_grid.pooled_dims(ch, cw)[1]
    lead = pooled.shape[:-3]
    new_t = update_thresholds(counts, thresholds, cfg)

    top, pool_idx = _topk_2stage(pooled, cfg.cell_capacity, cfg.chunk_size,
                                 cfg.chunk_topk)
    c = torch.gather(code, -1, pool_idx).to(torch.int64)
    row = 2 * (pool_idx // pw) + c // 2          # cell-local row, [0, ch2)
    col = 2 * (pool_idx % pw) + c % 2
    dev = pooled.device
    row0 = torch.arange(Gr, device=dev)[:, None, None] * ch
    col0 = torch.arange(Gc, device=dev)[None, :, None] * cw
    ys = (torch.clamp(row, max=ch - 1) + row0).reshape(*lead, -1)
    xs = (torch.clamp(col, max=cw - 1) + col0).reshape(*lead, -1)
    score = top.reshape(*lead, -1)
    kps = Keypoints(xy=torch.stack([xs, ys], -1).to(torch.float32),
                    score=score, angle=torch.zeros_like(score),
                    valid=score > 0)
    return GridDetections(keypoints=kps, thresholds=new_t, cell_counts=counts)


def _index(det: GridDetections, i: int) -> GridDetections:
    k = det.keypoints
    return GridDetections(
        keypoints=Keypoints(xy=k.xy[i], score=k.score[i], angle=k.angle[i],
                            valid=k.valid[i]),
        thresholds=det.thresholds[i], cell_counts=det.cell_counts[i])


def detect_pair(left, right, tl, tr, cfg: GridConfig):
    """Stereo pair: one grid-kernel launch covers both images."""
    H, W = left.shape[-2:]
    imgs = torch.stack([left, right]).to(torch.float32)
    ts = torch.stack([tl, tr])
    pooled, code, counts = fast_grid.fast_grid(imgs, ts, _cell(H, W, cfg),
                                               cfg.fast_type)
    det = _select_from_pooled(pooled, code, counts, ts, cfg, H, W)
    return _index(det, 0), _index(det, 1)

"""Rank functions for the port's multi-process tests
(`tests/test_torch_distributed.py`), run by `ba.distributed.launch`.

A spawned rank imports the module its function lives in; this one
imports torch and the port only, so no rank loads JAX.  Each function
takes (rank, group, device, ...) and writes what the test checks to
`{out}.{rank}.npz`.
"""
import dataclasses

import numpy as np
import torch

from front_end_tpu_torch.ba import distributed
from front_end_tpu_torch.pipeline import window_vo
from front_end_tpu_torch.window import tracker


def _save(out, rank, **arrays):
    np.savez(f"{out}.{rank}.npz", **arrays)


def sharded_solve(rank, group, dev, rig, problem, iters, out):
    """`ba_solve_sharded` on this rank's block of `problem` (T0, X0, meas,
    vis as numpy); the refined landmarks gathered back in rank order; the
    module's collective counts over the solve."""
    n = group.size()
    T0, X0, meas, vis = (torch.as_tensor(problem[k], device=dev)
                         for k in ("T0", "X0", "meas", "vis"))
    X0, meas, vis = distributed.pad_landmarks(X0, meas, vis, n)
    distributed.reset_counts()
    res = distributed.ba_solve_sharded(
        group, T0, *(distributed.local_block(a, rank, n)
                     for a in (X0, meas, vis)), rig, iters=iters)
    counts = (distributed.all_reduces, distributed.all_gathers)
    X = distributed.all_gather(res.landmarks, group)
    _save(out, rank, poses=res.poses.numpy(), cost=res.cost.numpy(),
          cost0=res.cost0.numpy(), rms=res.rms_px.numpy(), X=X.numpy(),
          counts=np.array(counts))


def window_errors(rank, group, dev, rig, cfg, out):
    """`run_window_ba` with the group: the two refusals of the JAX
    package's mesh check (capacity 1152; K = 1150 does not divide among
    four ranks, K = 4096 is not below the capacity)."""
    tcfg = tracker.TrackerConfig(capacity=1152, desc_bits=128)
    state = tracker.init_state(tcfg, device=dev)
    said = []
    for k in (1150, 4096):
        try:
            tracker.run_window_ba(state, rig, group=group, max_landmarks=k)
        except ValueError as e:
            said.append(str(e))
    _save(out, rank, said=np.array(said))


def live_window(rank, group, dev, rig, cfg, lefts, rights, out):
    """The windowed pipeline over the frames with its BA sharded over the
    group: every rank steps the same frames with the same seed."""
    cfg = dataclasses.replace(cfg, ba_group=group)
    state = window_vo.init_state(rig, cfg, device=dev)
    distributed.reset_counts()
    _, outs = window_vo.run_sequence(state, torch.as_tensor(lefts),
                                     torch.as_tensor(rights), rig, cfg)
    _save(out, rank, pose=outs.frame.pose.numpy(),
          ba_ran=outs.ba_ran.numpy(), ba_rms=outs.ba_rms_px.numpy(),
          ba_cost=outs.ba_cost.numpy(),
          counts=np.array((distributed.all_reduces,
                           distributed.all_gathers)))


def run(rank, group, dev, tasks):
    """Run each (function name, args) of `tasks` in order on this rank."""
    for name, args in tasks:
        globals()[name](rank, group, dev, *args)

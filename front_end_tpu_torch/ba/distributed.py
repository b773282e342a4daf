"""Landmark-sharded windowed BA over `torch.distributed` (counterpart of
`front_end_tpu/ba/distributed.py`).

Each rank holds one block of the landmarks, linearises ITS landmarks'
factors and reduces the only globally coupled quantity, the 6W×6W reduced
camera system, with `all_reduce` over the process group.  The small damped
solve is replicated on every rank; landmark back-substitution never leaves
the rank.  The communication per LM iteration is O(W²), independent of L.

Where the JAX package maps `_sharded_body` over a mesh axis, here every
rank of a process group runs `schur.ba_solve` on its block, and the
group's collectives make its sums in place of `psum` (`packed_sum`).  Rank placement (`placement`): rank r on
`cuda:r` with NCCL when there are as many cards as ranks; ranks that share
a card keep their tensors on it and reduce with gloo (NCCL refuses two
ranks on one device), which the JAX package's host-platform mesh reports
as a virtual mesh; on the CPU, gloo.

`all_reduces` and `all_gathers` count the module's own collective calls
(the counterpart of the JAX package's jaxpr walk, `count_collectives`).
"""
from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from front_end_tpu_torch.ba import schur
from front_end_tpu_torch.geometry.camera import StereoRig

all_reduces = 0
all_gathers = 0


def reset_counts() -> None:
    global all_reduces, all_gathers
    all_reduces = all_gathers = 0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the group in place (counted)."""
    global all_reduces
    all_reduces += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's equal-shaped `t` along dim 0, in rank
    order (counted)."""
    global all_gathers
    all_gathers += 1
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class Placement(NamedTuple):
    backend: str               # "nccl" or "gloo"
    devices: tuple             # torch.device of each rank
    virtual: bool              # ranks share a device (or run on the CPU)


def placement(world_size: int, device="cuda") -> Placement:
    """Where `world_size` ranks run: one card each with NCCL when there are
    enough cards; else every rank on a card (rank r on card r mod count)
    with gloo; on the CPU with gloo.  Never moves a rank to the CPU when
    the card was asked for."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return Placement("gloo", (dev,) * world_size, True)
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("CUDA was requested but there is no card; pass "
                           "device='cpu' to run the ranks on the CPU")
    if n_cards >= world_size:
        return Placement("nccl", tuple(torch.device("cuda", r)
                                       for r in range(world_size)), False)
    return Placement("gloo", tuple(torch.device("cuda", r % n_cards)
                                   for r in range(world_size)), True)


def describe(p: Placement) -> str:
    return (f"backend {p.backend}, ranks on "
            f"{', '.join(str(d) for d in p.devices)}"
            + (" (virtual mesh: ranks share a device)" if p.virtual else ""))


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None):
    """Join the process group and return it (counterpart of
    `initialize_multihost`).  With no arguments the rendezvous is read
    from `torchrun`'s environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); otherwise pass the rendezvous.  The backend defaults to
    NCCL where this host has a card for each of its ranks
    (LOCAL_WORLD_SIZE), else gloo."""
    if not dist.is_initialized():
        if init_method is None:
            init_method = "env://"
            world_size = int(os.environ["WORLD_SIZE"])
            rank = int(os.environ["RANK"])
        if backend is None:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
            backend = ("nccl" if torch.cuda.is_available()
                       and torch.cuda.device_count() >= local else "gloo")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return dist.group.WORLD


def _rank_main(rank, fn, world_size, init_method, device, args):
    torch.set_num_threads(1)
    p = placement(world_size, device)
    dev = p.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = initialize(p.backend, init_method, world_size, rank)
    try:
        return fn(rank, group, dev, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args=(), *, init_method: str,
           device="cuda", timeout: float | None = None) -> None:
    """Run `fn(rank, group, device, *args)` in `world_size` spawned
    processes placed as `placement` says, each pinned to one torch thread,
    joined to one group through `init_method` (e.g. a `file://` store).
    A rank's exception is raised here; past `timeout` seconds the ranks
    are killed and TimeoutError raised."""
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, init_method, str(device), args),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(None if deadline is None
                       else max(deadline - time.monotonic(), 0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in ctx.processes:
                proc.join()
            raise TimeoutError(f"{world_size} ranks ran past {timeout} s")


def packed_sum(group):
    """`schur.ba_solve`'s `total` over a process group: the tensors of one
    call summed over the ranks in ONE packed, counted all-reduce."""
    def total(*ts):
        flat = all_reduce(torch.cat([t.reshape(-1) for t in ts]), group)
        return tuple(part.reshape(t.shape) for part, t in
                     zip(flat.split([t.numel() for t in ts]), ts))
    return total


def ba_solve_sharded(group, poses0, X_local, meas_local, vis_local,
                     rig: StereoRig, *, iters: int = 12,
                     huber_px: float = 3.0,
                     lam0: float = 1e-4) -> schur.BAResult:
    """Landmark-sharded BA: this rank's block of landmarks (X_local (l, 3),
    meas_local (l, W, 4), vis_local (l, W)), the poses replicated.

    `schur.ba_solve`'s LM loop with its sums over the group: the last
    ACCEPTED state's reduced camera system rides in the carry, and each
    iteration makes exactly two packed all-reduces, sequentially
    dependent: (1) the carried state's (S_off | landmark rhs term) at the
    fresh damping, the solve's input (never the replicated bp); (2) the
    tentative state's (Hpp | bp | cost), the accept decision's input.  One
    (Hpp | bp | cost) before the loop and two for the rms after it:
    1 + 2·iters + 2 per solve.  Returns the replicated poses, cost, cost0
    and rms, and this rank's block of refined landmarks."""
    return schur.ba_solve(poses0, X_local, meas_local, vis_local, rig,
                          iters=iters, huber_px=huber_px, lam0=lam0,
                          total=packed_sum(group))


def comm_audit(W: int, iters: int) -> dict:
    """Per-solve communication of `ba_solve_sharded`, counted from the
    code: (Hpp | bp | cost) is 36W + 6W + 1 floats, (S_off | landmark rhs
    term) 36W² + 6W; one of the first before the loop, one of each per
    iteration (the rms's two scalar reductions after the loop are not
    counted here, as in the JAX package's audit)."""
    ne = 36 * W + 6 * W + 1
    schur_ = 36 * W * W + 6 * W
    per_iter = ne + schur_
    return {
        "psums_per_iter": 2,
        "floats_per_iter": per_iter,
        "bytes_per_iter": 4 * per_iter,
        "psums_per_solve": 1 + 2 * iters,
        "bytes_per_solve": 4 * (ne + iters * per_iter),
    }


def window_ba_audit(W: int, iters: int, max_landmarks: int) -> dict:
    """Collectives of one sharded windowed BA (`tracker.run_window_ba`
    with a group): the solve's `comm_audit` psums plus its two rms
    reductions, and the one `all_gather` of the refined (K, 3) landmarks
    before the store write, which the JAX package makes implicitly through
    its `out_specs`."""
    return {"all_reduces": comm_audit(W, iters)["psums_per_solve"] + 2,
            "all_gathers": 1, "gather_floats": 3 * max_landmarks}


def pad_landmarks(X0, meas, vis, n_ranks: int):
    """Pad the landmark dimension to a multiple of the rank count with
    zero rows (invisible: they add nothing to any reduction)."""
    pad = -(-X0.shape[0] // n_ranks) * n_ranks - X0.shape[0]
    if pad == 0:
        return X0, meas, vis
    return (F.pad(X0, (0, 0, 0, pad)), F.pad(meas, (0, 0, 0, 0, 0, pad)),
            F.pad(vis, (0, 0, 0, pad)))


def local_block(x, rank: int, world_size: int):
    """Rank `rank`'s contiguous block of the leading dimension, which the
    rank count must divide (`pad_landmarks`)."""
    if x.shape[0] % world_size:
        raise ValueError(f"{x.shape[0]} rows do not split into "
                         f"{world_size} equal blocks")
    n = x.shape[0] // world_size
    return x[rank * n:(rank + 1) * n]

"""A windowed-BA problem as the tracker hands it to `run_window_ba`, for
the CPU tests and the card's (this module imports no JAX).

A store of M slots, a share of them valid, each seen in some of the W
window slots: landmarks in front of the rig, their stereo projections
from W poses moving forward with 0.3 px noise and 5 % outliers 25 px
off, positions 5 cm off and the later poses off the true ones, so the
solve has work to do.  Track lengths repeat, so the top-K selection
breaks ties."""
import torch

from front_end_tpu_torch.ba import factors
from front_end_tpu_torch.geometry import se3
from front_end_tpu_torch.window import tracker


def window_state(rig, M: int, W: int = 3, seed: int = 0, device="cpu",
                 fill: float = 0.7) -> tracker.WindowState:
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)
    X = (u(M, 3) * torch.tensor([20.0, 6.0, 30.0])
         + torch.tensor([-10.0, -3.0, 4.0]))
    xi = torch.zeros(W, 6)
    xi[:, 2] = -0.3 * torch.arange(W, dtype=torch.float32)
    poses = se3.se3_exp(xi)                               # camera_from_world
    meas = factors.residual(poses[None], X[:, None], torch.zeros(M, W, 4),
                            rig)
    meas = meas + 0.3 * (u(M, W, 4) - 0.5)
    meas = torch.where(u(M, W, 1) < 0.05, meas + 25.0, meas)
    valid = u(M) < fill
    off = 0.01 * (u(W, 6) - 0.5)
    off[0] = 0.0
    store = tracker.LandmarkStore(
        Xw=X + 0.1 * (u(M, 3) - 0.5),
        bits=torch.zeros(M, 8),
        packed=None,
        xy=torch.zeros(M, 2),
        last_seen=torch.zeros(M, dtype=torch.int32),
        valid=valid,
        meas=meas,
        vis=(u(M, W) < 0.8) & valid[:, None],
        track_len=torch.randint(1, 12, (M,), generator=g,
                                dtype=torch.int32))
    state = tracker.WindowState(
        store=store, poses=se3.se3_exp(off) @ poses,
        pose_valid=torch.ones(W, dtype=torch.bool), frame_idx=W)
    return _to(state, device)


def _to(state: tracker.WindowState, device) -> tracker.WindowState:
    def mv(t):
        return None if t is None else t.to(device)
    return state._replace(store=tracker.LandmarkStore(*map(mv, state.store)),
                          poses=mv(state.poses),
                          pose_valid=mv(state.pose_valid))


def eager(state: tracker.WindowState, rig, *, iters: int,
          max_landmarks, huber_px: float = 3.0, min_obs: int = 2,
          outlier_gate_px=8.0):
    """`tracker._window_ba` on the state's tensors: (Xw, BAResult)."""
    s = state.store
    return tracker._window_ba(s.Xw, s.meas, s.vis, s.valid, s.track_len,
                              state.poses, state.pose_valid, rig, iters,
                              huber_px, min_obs, outlier_gate_px,
                              max_landmarks)

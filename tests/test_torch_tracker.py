"""`window/tracker.py` and the top-K compaction of `ops/dense_select.py`
against the JAX package, on the synthetic frames of `tests/test_tracker.py`.

`update` is exact, slot for slot: the association is integer Hamming
distances, and the writes copy integers, bools and floats (the world
position of a new landmark is one float32 rigid transform, compared within
1e-5).  `run_window_ba` inherits `ba_solve`'s tolerances
(`tests/test_torch_ba.py`): poses within 1e-4, refined landmarks within
2e-3 px of reprojection.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu.ops.dense_select import compact_rows as j_compact_rows
from front_end_tpu.ops.dense_select import topk_onehot
from front_end_tpu.window import tracker as jtracker
from front_end_tpu_torch import interop
from front_end_tpu_torch.ba import factors as tfactors
from front_end_tpu_torch.ops import dense_select as tsel
from front_end_tpu_torch.pipeline import control as tcontrol
from front_end_tpu_torch.types import Descriptors, pack_bits
from front_end_tpu_torch.window import tracker as ttracker
from test_tracker import make_frames
from torch_parity import kps_to_torch, n, rig_fields, t

STORE_EXACT = ("bits", "xy", "last_seen", "valid", "meas", "vis", "track_len")


def window_fields(s) -> dict:
    """A JAX `WindowState` in the layout `interop.window_from_jax` takes."""
    return dict(store={f: n(getattr(s.store, f)) for f in s.store._fields},
                poses=n(s.poses), pose_valid=n(s.pose_valid),
                frame_idx=int(s.frame_idx))


def _tframe(f):
    return dict(kps=kps_to_torch(f["kps"]), desc=Descriptors(t(f["desc"].bits)),
                X_cam=t(f["X_cam"]), stereo_valid=t(f["stereo_valid"]),
                uv4=t(f["uv4"]), pose_cur=t(f["pose_cur"]))


def _assert_state_equal(ts, js, msg=""):
    for f in STORE_EXACT:
        np.testing.assert_array_equal(n(getattr(ts.store, f)),
                                      np.asarray(getattr(js.store, f)),
                                      err_msg=f"{msg} store.{f}")
    np.testing.assert_allclose(n(ts.store.Xw), np.asarray(js.store.Xw),
                               atol=1e-5, err_msg=f"{msg} store.Xw")
    assert torch.equal(ts.store.packed.view(torch.int32),
                       pack_bits(ts.store.bits).view(torch.int32))
    np.testing.assert_array_equal(n(ts.poses), np.asarray(js.poses))
    np.testing.assert_array_equal(n(ts.pose_valid), np.asarray(js.pose_valid))
    assert ts.frame_idx == int(js.frame_idx)


def test_topk_select_equals_topk_onehot_under_heavy_ties():
    """The cases of `tests/test_tracker.py::TestTopkOnehot`: integer
    scores, many equal, k from 1 to M."""
    rs = np.random.RandomState(7)
    for trial in range(25):
        M = int(rs.randint(8, 300))
        k = int(rs.randint(1, M + 1))
        smax = int(rs.choice([5, 100, 39999]))
        nvalid = int(rs.randint(0, M + 1))
        score = np.zeros(M, np.float32)
        idx = rs.choice(M, nvalid, replace=False)
        score[idx] = rs.randint(1, smax + 1, nvalid)
        oh, mask, n_sel = topk_onehot(jnp.asarray(score), k, smax)
        sel = tsel.topk_select(t(score), k)
        sel_mask = np.zeros(M, bool)
        sel_mask[n(sel.idx[sel.valid])] = True
        np.testing.assert_array_equal(sel_mask, np.asarray(mask), trial)
        assert sel.idx.shape == (k,) and int(sel.valid.sum()) == int(n_sel)
        assert bool(sel.valid[:int(n_sel)].all())
        X = rs.rand(M, 3).astype(np.float32)
        np.testing.assert_array_equal(
            n(tsel.compact_rows(sel, t(X))),
            np.asarray(j_compact_rows(oh, jnp.asarray(X))))
        B = rs.rand(M, 2) > 0.5
        np.testing.assert_array_equal(
            n(tsel.compact_rows(sel, t(B))),
            np.asarray(j_compact_rows(oh, jnp.asarray(B))))
        # the scatter back through the same selection
        Y = rs.rand(k, 3).astype(np.float32)
        back = tsel.put_rows(t(X), torch.where(sel.valid, sel.idx, M), t(Y))
        ref = np.where(np.asarray(mask)[:, None],
                       np.asarray(oh) @ Y, X)
        np.testing.assert_array_equal(n(back), ref.astype(np.float32))


def test_topk_select_k_above_m_and_no_valid_row():
    sel = tsel.topk_select(torch.tensor([0.0, 3.0, 0.0, 3.0, 1.0]), 8)
    assert sel.idx.shape == (8,) and int(sel.valid.sum()) == 3
    assert sel.idx[:3].tolist() == [1, 3, 4] and not bool(sel.valid[3:].any())
    none = tsel.topk_select(torch.zeros(6), 4)
    assert none.idx.shape == (4,) and not bool(none.valid.any())
    assert torch.equal(tsel.compact_rows(none, torch.ones(6, 2)),
                       torch.zeros(4, 2))


@pytest.mark.parametrize("capacity,max_age,frames", [
    (256, 3, 5), (150, 1, 7)])
def test_update_equals_jax_slot_for_slot(capacity, max_age, frames):
    """The second case has fewer slots than two frames' features and a
    short max_age, so dead slots run out and expired ones are recycled."""
    jrig, jframes, _, _ = make_frames(n_frames=frames, L=128, seed=1)
    if capacity == 150:     # from frame 2 on, every frame brings new
        for i, f in enumerate(jframes[2:], 2):      # descriptors
            f["desc"] = f["desc"].replace(
                bits=jnp.roll(f["desc"].bits, 7 * i, axis=1))
    rig = interop.from_jax(rig_fields(jrig))[0]
    jcfg = jtracker.TrackerConfig(capacity=capacity, window=3, desc_bits=256,
                                  roi_box=150.0, max_age=max_age)
    import dataclasses
    tcfg, _ = interop.window_from_jax(dataclasses.asdict(jcfg))
    assert tcfg == ttracker.TrackerConfig(capacity=capacity, window=3,
                                          desc_bits=256, roi_box=150.0,
                                          max_age=max_age)
    js = jtracker.init_state(jcfg)
    ts = ttracker.init_state(tcfg, device="cpu")
    _assert_state_equal(ts, js, "init")
    recycled = 0
    for i, f in enumerate(jframes):
        if i == 3:      # pick the JAX state up mid-sequence
            _, ts = interop.window_from_jax(state=window_fields(js),
                                            device="cpu")
        before_valid = np.asarray(js.store.valid)
        ju = jtracker.update(js, **f, cfg=jcfg, rig=jrig)
        tu = ttracker.update(ts, **_tframe(f), cfg=tcfg, rig=rig)
        np.testing.assert_array_equal(n(tu.matches), np.asarray(ju.matches),
                                      err_msg=f"frame {i} matches")
        assert tu.matches.dtype == torch.int32
        assert int(tu.n_tracked) == int(ju.n_tracked)
        assert int(tu.n_new) == int(ju.n_new)
        _assert_state_equal(tu.state, ju.state, f"frame {i}")
        # a slot that held a landmark and now starts a new track
        after = ju.state.store
        recycled += int((before_valid & (np.asarray(after.track_len) == 1)
                         & (np.asarray(after.last_seen) == i)).sum())
        js, ts = ju.state, tu.state
        if i == 1:
            assert int(ju.n_tracked) > 50
            Xa, Xb, valid = ttracker.tracked_pairs(ts, tu, _tframe(f)["X_cam"])
            jXa, _, jvalid = jtracker.tracked_pairs(js, ju, f["X_cam"])
            np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
            np.testing.assert_allclose(n(Xa), np.asarray(jXa), atol=1e-5)
    if capacity == 150:
        assert recycled > 0, "no expired slot was recycled"
    assert ts.frame_idx == frames


@pytest.mark.parametrize("max_landmarks,gate", [(64, 8.0), (None, 8.0),
                                                (200, None), (1024, 8.0)])
def test_run_window_ba_equals_jax(max_landmarks, gate):
    """Compacted (K < M) and full-grid branches, from the same state."""
    jrig, jframes, _, _ = make_frames(n_frames=3, L=256, seed=2)
    rig = interop.from_jax(rig_fields(jrig))[0]
    jcfg = jtracker.TrackerConfig(capacity=512, window=3, desc_bits=256,
                                  roi_box=150.0)
    js = jtracker.init_state(jcfg)
    for f in jframes:
        js = jtracker.update(js, **f, cfg=jcfg, rig=jrig).state
    # perturb the window's later poses so the solve has work to do
    from front_end_tpu.geometry import se3 as jse3
    rs = np.random.RandomState(3)
    dxi = (0.002 * rs.normal(size=(3, 6))).astype(np.float32)
    dxi[0] = 0.0
    js = js._replace(poses=jnp.stack(
        [jse3.se3_exp(jnp.asarray(d)) @ T for d, T in zip(dxi, js.poses)]))
    _, ts = interop.window_from_jax(state=window_fields(js), device="cpu")
    kw = dict(iters=4, outlier_gate_px=gate, max_landmarks=max_landmarks)
    js2, jres = jtracker.run_window_ba(js, jrig, **kw)
    ts2, tres = ttracker.run_window_ba(ts, rig, **kw)
    assert float(jres.cost) < float(jres.cost0)
    np.testing.assert_allclose(n(tres.poses), np.asarray(jres.poses),
                               atol=1e-4)
    np.testing.assert_allclose(n(ts2.poses), np.asarray(js2.poses), atol=1e-4)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tres.rms_px), float(jres.rms_px),
                               rtol=1e-2, atol=1e-4)
    # only usable landmarks (valid, seen twice in the window) may move,
    # at most K of them; the rest keep their position bit for bit
    jXw, tXw = np.asarray(js2.store.Xw), n(ts2.store.Xw)
    use = n(ts.store.valid) & (n(ts.store.vis).sum(1) >= 2)
    moved = (tXw != n(ts.store.Xw)).any(1)
    assert not (moved & ~use).any()
    assert 20 < moved.sum() <= min(max_landmarks or 512, use.sum())
    assert not ((jXw != np.asarray(js.store.Xw)).any(1) & ~use).any()
    z = torch.zeros_like(ts.store.meas)
    uv = [tfactors.residual(ts2.poses[None, :], t(X)[:, None, :], z, rig)
          for X in (tXw, jXw)]
    seen = ts.store.vis & ts.store.valid[:, None]
    assert float(((uv[0] - uv[1]).abs().amax(-1) * seen).max()) < 2e-3
    for f in STORE_EXACT:
        assert torch.equal(getattr(ts2.store, f), getattr(ts.store, f))


def test_reset_window_clears_everything():
    jrig, jframes, _, _ = make_frames(n_frames=2, L=64)
    rig = interop.from_jax(rig_fields(jrig))[0]
    cfg = ttracker.TrackerConfig(capacity=128, window=3, roi_box=150.0)
    st = ttracker.init_state(cfg, device="cpu")
    for f in jframes:
        st = ttracker.update(st, **_tframe(f), cfg=cfg, rig=rig).state
    assert int(st.store.valid.sum()) > 20 and st.frame_idx == 2
    fresh = tcontrol.reset_window(st, cfg)
    assert fresh.frame_idx == 0 and not bool(fresh.store.valid.any())
    assert not bool(fresh.pose_valid.any())
    assert fresh.poses.device == st.poses.device

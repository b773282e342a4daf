"""The whole slice: the port's `vo_step`, started from a JAX state taken
mid-sequence, against the JAX package's jitted `vo_step` frame by frame;
the `from_jax` state carry; the configuration surface of this slice.

Per-frame stage counts (detections, stereo matches, tracks, inliers) are
exact: detection, description and matching are bit-exact and RANSAC is
fed the JAX-drawn minimal sets.  Poses agree within 1e-5: float32 geometry
(SVD, LM solve) sums in a different order in the two frameworks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from front_end_tpu.geometry.camera import StereoRig as JRig
from front_end_tpu.motion import ransac as jransac
from front_end_tpu.ops import grid as jgrid
from front_end_tpu.pipeline import vo as jvo
from front_end_tpu_torch import interop
from front_end_tpu_torch.ops import grid as tgrid
from front_end_tpu_torch.pipeline import vo as tvo
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.types import pack_bits
from torch_parity import n, rig_fields, state_fields, t

H, W, T, START = 192, 256, 8, 2
COUNTS = ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks", "n_inliers")


def _jax_cfg():
    # 192x256 in a 2x3 grid: 96x85 cells, an odd cell width
    return jvo.VOConfig(
        grid=jgrid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=64,
                              set_point=300, init_threshold=12.0),
        desc_bytes=32, ransac_hyps=128, ransac_threshold=0.5,
        max_disparity=64.0)


@pytest.fixture(scope="module")
def jax_run():
    rig = JRig.create(fx=300.0, baseline=0.3, width=W, height=H)
    cfg = _jax_cfg()
    lefts, rights = make_sequence(T, H, W)
    step = jax.jit(lambda s, l, r: jvo.vo_step(s, l, r, rig, cfg))
    s = jvo.init_state(rig, cfg)
    states, outs = [], []
    for i in range(T):
        states.append(s)
        s, o = step(s, lefts[i], rights[i])
        outs.append(jax.tree.map(np.asarray, o))
    states.append(s)
    return rig, cfg, lefts, rights, states, outs


def _port(jax_run, state_idx, device="cpu"):
    rig, cfg, _, _, states, _ = jax_run
    return interop.from_jax(rig_fields(rig), dataclasses.asdict(cfg),
                            state_fields(states[state_idx]), device=device)


def _sampler_for(jstate):
    """The minimal sets JAX's vo_step draws from this state's key."""
    sub = jax.random.split(jstate.key)[1]

    def sampler(valid, n_hyps, k):
        return t(jransac.sample_minimal_sets(sub, jnp.asarray(n(valid)),
                                             n_hyps, k)).long()
    return sampler


def test_whole_slice_matches_jax_from_a_mid_sequence_state(jax_run):
    _, _, lefts, rights, states, outs = jax_run
    rig, cfg, state = _port(jax_run, START)
    for i in range(START, T):
        state, o = tvo.vo_step(state, lefts[i], rights[i], rig, cfg,
                               sampler=_sampler_for(states[i]))
        ref = outs[i]
        for f in COUNTS:
            assert int(getattr(o, f)) == int(getattr(ref, f)), (i, f)
        assert bool(o.motion_ok) == bool(ref.motion_ok)
        np.testing.assert_array_equal(n(o.track_valid), ref.track_valid)
        np.testing.assert_allclose(n(o.motion), ref.motion, atol=1e-5)
        np.testing.assert_allclose(n(o.pose), ref.pose, atol=1e-5)
        assert int(ref.n_inliers) > 50
    # the carried controller state and features stayed identical too
    final = states[T]
    for a, b in ((state.thresholds_l, final.thresholds_l),
                 (state.thresholds_r, final.thresholds_r),
                 (state.prev.kps.xy, final.prev.kps.xy),
                 (state.prev.bits, final.prev.bits),
                 (state.prev.stereo_valid, final.prev.stereo_valid)):
        np.testing.assert_array_equal(n(a), n(b))


def test_first_frame_is_identity_like_jax(jax_run):
    _, _, lefts, rights, states, outs = jax_run
    rig, cfg, state = _port(jax_run, 0)
    state, o = tvo.vo_step(state, lefts[0], rights[0], rig, cfg,
                           sampler=_sampler_for(states[0]))
    assert torch.equal(o.pose, torch.eye(4))
    assert bool(o.motion_ok) and not bool(o.track_valid.any())
    for f in COUNTS:
        assert int(getattr(o, f)) == int(getattr(outs[0], f)), f
    np.testing.assert_array_equal(n(state.thresholds_l),
                                  n(states[1].thresholds_l))
    np.testing.assert_array_equal(n(state.prev.kps.xy),
                                  n(states[1].prev.kps.xy))
    np.testing.assert_array_equal(n(state.prev.bits), n(states[1].prev.bits))


def test_from_jax_round_trip(jax_run):
    """Every field crosses unchanged: the port's objects read back into
    the JAX layout equal the JAX state, rig and configuration."""
    rig, cfg, _, _, states, _ = jax_run
    trig, tcfg, tstate = _port(jax_run, 3)
    assert {k: getattr(trig, k) for k in rig_fields(rig)} == rig_fields(rig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    p = tstate.prev
    back = dict(
        thresholds_l=n(tstate.thresholds_l),
        thresholds_r=n(tstate.thresholds_r), pose=n(tstate.pose),
        frame_idx=tstate.frame_idx,
        prev=dict(kps={f: n(getattr(p.kps, f))
                       for f in ("xy", "score", "angle", "valid")},
                  bits=n(p.bits), X=n(p.X), stereo_valid=n(p.stereo_valid),
                  uv4=n(p.uv4)))
    flat = jax.tree_util.tree_leaves_with_path
    got = dict((jax.tree_util.keystr(k), v) for k, v in flat(back))
    ref = dict((jax.tree_util.keystr(k), v)
               for k, v in flat(state_fields(states[3])))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert torch.equal(p.packed, pack_bits(p.bits))
    assert int(p.kps.valid.sum()) > 50


def test_run_sequence_default_sampler_is_reproducible():
    rig = interop.from_jax(dict(fx=300.0, fy=300.0, cx=127.5, cy=95.5,
                                baseline=0.3, width=W, height=H))[0]
    cfg = tvo.VOConfig(grid=tgrid.GridConfig(cell_capacity=64,
                                             set_point=300,
                                             init_threshold=12.0),
                       ransac_hyps=64, ransac_threshold=0.5,
                       max_disparity=64.0)
    lefts, rights = make_sequence(3, H, W)
    runs = []
    for _ in range(2):
        s = tvo.init_state(rig, cfg, seed=3, device="cpu")
        s, outs = tvo.run_sequence(s, lefts, rights, rig, cfg)
        runs.append(outs)
    assert runs[0].pose.shape == (3, 4, 4)
    assert torch.equal(runs[0].pose, runs[1].pose)
    assert bool(runs[0].motion_ok.all())
    assert int(runs[0].n_inliers[-1]) > 50
    # constant 3 px shift at 7.5 m depth: 0.075 m per frame along +x
    np.testing.assert_allclose(n(runs[0].pose[-1, :3, 3]),
                               [0.15, 0.0, 0.0], atol=0.01)


def test_swap_descriptor_resets_features_only():
    cfg = tvo.VOConfig(grid=tgrid.GridConfig(cell_capacity=8))
    rig = interop.from_jax(dict(fx=300.0, fy=300.0, cx=1.0, cy=1.0,
                                baseline=0.3, width=W, height=H))[0]
    s = tvo.init_state(rig, cfg, device="cpu")._replace(frame_idx=5)
    s2 = tvo.swap_descriptor(s, cfg.replace(desc_bytes=16))
    assert s2.frame_idx == 5 and s2.prev.bits.shape == (48, 128)
    assert s2.prev.packed.shape == (48, 4)


@pytest.mark.parametrize("kw,item", [
    (dict(descriptor="orb"), "item 9"), (dict(descriptor="freak"), "item 9"),
    (dict(motion="essential"), "item 10"), (dict(subpix=True), "item 9")])
def test_later_slices_raise_naming_their_roadmap_item(kw, item):
    """Nothing of `VOConfig` is left to port: what items 9 and 10 ported
    (the descriptor swap set, sub-pixel refinement, the essential-matrix
    egomotion) is accepted and configured like the JAX package's
    VOConfig; an unknown descriptor or motion still raises."""
    cfg, ref = tvo.VOConfig(**kw), jvo.VOConfig(**kw)
    assert (cfg.descriptor, cfg.subpix, cfg.motion, cfg.desc_dim,
            cfg.desc_norm) == (ref.descriptor, ref.subpix, ref.motion,
                               ref.desc_dim, ref.desc_norm)
    with pytest.raises(ValueError, match="unknown descriptor"):
        tvo.VOConfig(descriptor="sift")
    with pytest.raises(ValueError, match="unknown motion"):
        tvo.VOConfig(motion="homography")


def test_brief_pallas_is_an_alias():
    assert tvo.VOConfig(descriptor="brief_pallas").desc_dim == 256

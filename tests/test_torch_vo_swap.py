"""The VO descriptor swap set: the port's `vo_step` with every descriptor of
the JAX registry (and with sub-pixel refinement) against the JAX package's
jitted `vo_step` on the same synthetic sequence, the port started from the
JAX state of frame 1 (`interop.from_jax`) and RANSAC fed the JAX-drawn
minimal sets; `window_vo_step` with a float (SURF) and a 16-word (FREAK)
landmark store; the brief -> freak mid-stream swap.

Tolerances (measured on this sequence in brackets):
- Stage counts (detections, stereo matches, tracks, inliers), keypoint
  validity and every motion_ok flag are exact for all six: detection is
  the grid kernel's exact twin; BRISK, FREAK and ORB rotate their patterns
  by cos/sin of an atan2 angle that the two libraries round alike here
  (bits equal); SURF's L2 matches and the sub-pixel BRIEF matches agree.
- Binary descriptor bits exact.  SURF and SURF-extended values within
  1e-6 (1.8e-7): the 16 subregion sums and the norm are float32 sums in
  another order than the JAX package's one-hot matrix product.
- Sub-pixel keypoints within 1e-4 px (6.1e-5): the compiled JAX iteration
  contracts multiply-adds that the eager port rounds apart.
- Poses within 1e-5 (2.9e-6), as `tests/test_torch_vo.py`: float32
  geometry summed in another order.
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
from front_end_tpu.pipeline import window_vo as jwvo
from front_end_tpu_torch import interop
from front_end_tpu_torch.pipeline import vo as tvo
from front_end_tpu_torch.pipeline import window_vo as twvo
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.types import Descriptors
from torch_parity import n, rig_fields, state_fields, t

H, W, T, START = 192, 256, 4, 1
COUNTS = ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks", "n_inliers")
# (descriptor, subpix) -> (descriptor tolerance, keypoint tolerance, px)
CASES = {
    ("orb", False): (0.0, 0.0),
    ("brisk", False): (0.0, 0.0),
    ("freak", False): (0.0, 0.0),
    ("surf", False): (1e-6, 0.0),
    ("surf_ext", False): (1e-6, 0.0),
    ("brief", True): (0.0, 1e-4),
}


def _jax_cfg(descriptor, subpix):
    return jvo.VOConfig(
        grid=jgrid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=64,
                              set_point=300, init_threshold=12.0),
        descriptor=descriptor, desc_bytes=32, subpix=subpix,
        ransac_hyps=128, ransac_threshold=0.5, max_disparity=64.0)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(T, H, W)


def _sampler_for(key):
    """The minimal sets JAX's vo_step draws from this state's key."""
    sub = jax.random.split(key)[1]

    def sampler(valid, n_hyps, k):
        return t(jransac.sample_minimal_sets(sub, jnp.asarray(n(valid)),
                                             n_hyps, k)).long()
    return sampler


def _jax_run(cfg, lefts, rights):
    rig = JRig.create(fx=300.0, baseline=0.3, width=W, height=H)
    step = jax.jit(lambda s, l, r: jvo.vo_step(s, l, r, rig, cfg))
    s = jvo.init_state(rig, cfg)
    states, outs = [], []
    for i in range(T):
        states.append(s)
        s, o = step(s, lefts[i], rights[i])
        outs.append(jax.tree.map(np.asarray, o))
    states.append(s)
    return rig, states, outs


@pytest.mark.parametrize("descriptor,subpix", list(CASES), ids=str)
def test_vo_step_matches_jax(seq, descriptor, subpix):
    desc_tol, kp_tol = CASES[(descriptor, subpix)]
    lefts, rights = seq
    jcfg = _jax_cfg(descriptor, subpix)
    jrig, states, outs = _jax_run(jcfg, lefts, rights)
    rig, cfg, state = interop.from_jax(
        rig_fields(jrig), dataclasses.asdict(jcfg),
        state_fields(states[START]), device="cpu")
    assert cfg.desc_dim == jcfg.desc_dim and cfg.desc_norm == jcfg.desc_norm
    assert (state.prev.packed is None) == (cfg.desc_norm == "l2")
    for i in range(START, T):
        state, o = tvo.vo_step(state, lefts[i], rights[i], rig, cfg,
                               sampler=_sampler_for(states[i].key))
        ref = outs[i]
        for f in COUNTS:
            assert int(getattr(o, f)) == int(getattr(ref, f)), (i, f)
        assert bool(o.motion_ok) == bool(ref.motion_ok)
        np.testing.assert_array_equal(n(o.track_valid), ref.track_valid)
        np.testing.assert_allclose(n(o.pose), ref.pose, atol=1e-5)
        assert int(ref.n_inliers) > 50
        jprev = states[i + 1].prev
        np.testing.assert_allclose(n(state.prev.kps.xy), n(jprev.kps.xy),
                                   rtol=0, atol=kp_tol)
        np.testing.assert_array_equal(n(state.prev.kps.valid),
                                      n(jprev.kps.valid))
        np.testing.assert_allclose(n(state.prev.bits), n(jprev.bits),
                                   rtol=0, atol=desc_tol)
    # descriptors of their family's width and layout
    bits = state.prev.bits
    assert bits.shape == (cfg.grid.capacity, cfg.desc_dim)
    if cfg.desc_norm == "l2":
        assert state.prev.packed is None
        v = state.prev.kps.valid
        np.testing.assert_allclose(n(bits[v].norm(dim=-1)), 1.0, atol=1e-5)
    else:
        assert state.prev.packed.shape == (cfg.grid.capacity,
                                           cfg.desc_dim // 32)
        assert set(np.unique(n(bits))) <= {0.0, 1.0}


def test_swap_set_configs_match_the_jax_registry():
    assert set(tvo.DESCRIPTORS) == set(jvo.DESCRIPTORS)
    for name, spec in jvo.DESCRIPTORS.items():
        assert tvo.DESCRIPTORS[name] == spec
        for nb in (16, 32, 64):
            j = jvo.VOConfig(descriptor=name, desc_bytes=nb)
            c = tvo.VOConfig(descriptor=name, desc_bytes=nb)
            assert (c.desc_dim, c.desc_norm) == (j.desc_dim, j.desc_norm)
    assert tvo.VOConfig(subpix=True).subpix


def test_float_descriptors_are_never_packed():
    bits = torch.rand(5, 64)
    with pytest.raises(TypeError, match="no packed layout"):
        Descriptors(bits, norm="l2").words()
    cfg = tvo.VOConfig(descriptor="surf_ext")
    assert tvo.empty_features(cfg, "cpu").packed is None
    assert tvo.empty_features(cfg, "cpu").bits.shape[1] == 128
    wcfg = twvo.WindowVOConfig.create(cfg)
    assert wcfg.tracker.norm == "l2" and wcfg.tracker.desc_bits == 128
    assert twvo.init_state(_rig(), wcfg, device="cpu").win.store \
        .packed is None


def _rig():
    from front_end_tpu_torch.geometry.camera import StereoRig as TRig
    return TRig.create(fx=300.0, baseline=0.3, width=W, height=H)


def test_mid_stream_swap_brief_to_freak_carries_the_pose(seq):
    """As the JAX package's `test_mid_stream_descriptor_swap_carries_pose`:
    after the swap the pose, thresholds and frame index carry over, the
    first frame finds no track (identity motion), and tracking resumes on
    the frame after; counts equal the JAX run's."""
    lefts, rights = seq
    jrig = JRig.create(fx=300.0, baseline=0.3, width=W, height=H)
    jb, jf = _jax_cfg("brief", False), _jax_cfg("freak", False)
    rig, cb, s = interop.from_jax(rig_fields(jrig), dataclasses.asdict(jb),
                                  state_fields(jvo.init_state(jrig, jb)),
                                  device="cpu")
    cf = cb.replace(descriptor="freak")
    js = jvo.init_state(jrig, jb)
    steps = {c: jax.jit(lambda st, l, r, c=c: jvo.vo_step(st, l, r, jrig, c))
             for c in (jb, jf)}
    for i in range(T):
        jc, tc = (jb, cb) if i < 2 else (jf, cf)
        if i == 2:
            js, s = jvo.swap_descriptor(js, jf), tvo.swap_descriptor(s, cf)
            assert s.prev.bits.shape == (cf.grid.capacity, 512)
            assert s.prev.packed.shape == (cf.grid.capacity, 16)
            assert s.frame_idx == 2
        key = js.key
        js, jo = steps[jc](js, lefts[i], rights[i])
        s, o = tvo.vo_step(s, lefts[i], rights[i], rig, tc,
                           sampler=_sampler_for(key))
        for f in COUNTS:
            assert int(getattr(o, f)) == int(getattr(jo, f)), (i, f)
        np.testing.assert_allclose(n(o.pose), n(jo.pose), atol=1e-5)
        if i == 2:
            assert int(o.n_tracks) == 0 and not bool(o.track_valid.any())
            np.testing.assert_allclose(n(o.motion), np.eye(4), atol=0)
        if i == 3:
            assert int(o.n_inliers) > 50 and bool(o.motion_ok)
    assert float(s.pose[0, 3]) > 0.1           # the pan carried across


def _window_cfgs(descriptor):
    jcfg = _jax_cfg(descriptor, False)
    jw = jwvo.WindowVOConfig.create(jcfg, window=3, ba_every=1)
    return jw, interop.window_from_jax(dataclasses.asdict(jw))[0]


@pytest.mark.parametrize("descriptor", ["surf", "freak"])
def test_window_vo_with_float_and_16_word_stores(seq, descriptor):
    """Per frame: tracked / new / stereo counts and BA runs equal JAX's,
    poses within 2e-4 (the frame step's 1e-5 plus a windowed BA summed in
    another order, as `tests/test_torch_window_vo.py`); the store holds
    SURF's floats without words, FREAK's bits with 16 words a slot."""
    lefts, rights = seq
    jw, cfg = _window_cfgs(descriptor)
    jrig = JRig.create(fx=300.0, baseline=0.3, width=W, height=H)
    rig = interop.from_jax(rig_fields(jrig))[0]
    step = jax.jit(lambda s, l, r: jwvo.window_vo_step(s, l, r, jrig, jw))
    js = jwvo.init_state(jrig, jw)
    s = twvo.init_state(rig, cfg, device="cpu")
    for i in range(T):
        key = js.vo.key
        js, jo = step(js, lefts[i], rights[i])
        s, o = twvo.window_vo_step(s, lefts[i], rights[i], rig, cfg,
                                   sampler=_sampler_for(key))
        for a, b in ((o.n_tracked, jo.n_tracked), (o.n_new, jo.n_new),
                     (o.frame.n_stereo, jo.frame.n_stereo)):
            assert int(a) == int(b), i
        assert bool(o.ba_ran) == bool(jo.ba_ran)
        np.testing.assert_allclose(n(o.frame.pose), n(jo.frame.pose),
                                   atol=2e-4)
    store = s.win.store
    assert int(o.n_tracked) > 100
    if descriptor == "surf":
        assert store.packed is None and store.bits.shape[1] == 64
        live = store.valid
        np.testing.assert_allclose(n(store.bits[live].norm(dim=-1)), 1.0,
                                   atol=1e-5)
    else:
        assert store.packed.shape == (cfg.tracker.capacity, 16)
        from front_end_tpu_torch.types import pack_bits
        assert torch.equal(store.packed.view(torch.int32),
                           pack_bits(store.bits).view(torch.int32))


@pytest.mark.parametrize("descriptor", ["surf", "brisk"])
def test_interop_packs_binary_descriptors_only(descriptor):
    """A JAX state crosses with packed words for binary descriptors and
    without for float ones, by the configuration's norm; the windowed
    store likewise.  Without a configuration a state is binary: a binary
    one is packed, a float one refused."""
    from front_end_tpu_torch.types import pack_bits
    jcfg = _jax_cfg(descriptor, False)
    jrig = JRig.create(fx=300.0, baseline=0.3, width=W, height=H)
    js = state_fields(jvo.init_state(jrig, jcfg))
    js["prev"]["bits"] = np.random.RandomState(1).uniform(
        size=js["prev"]["bits"].shape).astype(np.float32)
    if descriptor == "brisk":
        js["prev"]["bits"] = np.round(js["prev"]["bits"])
    norm = jvo.DESCRIPTORS[descriptor]["norm"]
    st = interop.from_jax(cfg=dataclasses.asdict(jcfg), state=js,
                          device="cpu")[2]
    np.testing.assert_array_equal(n(st.prev.bits), js["prev"]["bits"])
    if norm == "l2":
        assert st.prev.packed is None
        with pytest.raises(ValueError, match="float descriptors"):
            interop.from_jax(state=js, device="cpu")
    else:
        for s in (st, interop.from_jax(state=js, device="cpu")[2]):
            assert torch.equal(s.prev.packed.view(torch.int32),
                               pack_bits(s.prev.bits).view(torch.int32))
    jw = jwvo.WindowVOConfig.create(jcfg, window=3)
    jws = jwvo.init_state(jrig, jw).win
    fields = dict(store={f: n(getattr(jws.store, f)) for f in
                         ("Xw", "bits", "xy", "last_seen", "valid", "meas",
                          "vis", "track_len")},
                  poses=n(jws.poses), pose_valid=n(jws.pose_valid),
                  frame_idx=int(jws.frame_idx))
    wcfg, ws = interop.window_from_jax(dataclasses.asdict(jw), fields,
                                       device="cpu")
    assert wcfg.tracker.norm == norm
    assert (ws.store.packed is None) == (norm == "l2")
    bits = np.random.RandomState(2).uniform(
        size=fields["store"]["bits"].shape).astype(np.float32)
    fields["store"]["bits"] = np.round(bits) if norm == "hamming" else bits
    if norm == "l2":
        with pytest.raises(ValueError, match="float descriptors"):
            interop.window_from_jax(state=fields, device="cpu")
    else:
        _, ws2 = interop.window_from_jax(state=fields, device="cpu")
        assert torch.equal(ws2.store.packed.view(torch.int32),
                           pack_bits(ws2.store.bits).view(torch.int32))

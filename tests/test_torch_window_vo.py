"""The windowed slice as a whole: the port's `window_vo` against the JAX
package's on the planar sequences of `tests/test_window_vo.py`, RANSAC fed
the JAX-drawn minimal sets frame by frame.

Counts (`n_tracked`, `n_new`, `ba_ran`, the frame step's stage counts) are
exact; refined and raw poses agree within 2e-4 (the frame step's 1e-5,
`tests/test_torch_vo.py`, plus a windowed BA whose float32 solve sums in
another order in each framework, fed back into the next frame's start
pose); BA cost within 2 %.  The properties `tests/test_window_vo.py`
demands of the JAX package are demanded of the port too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from front_end_tpu.motion import ransac as jransac
from front_end_tpu.pipeline import window_vo as jwvo
from front_end_tpu_torch import interop
from front_end_tpu_torch.pipeline import vo as tvo
from front_end_tpu_torch.pipeline import window_vo as twvo
from test_pipeline import _cfg, _rig, make_planar_sequence
from test_window_vo import _gt_positions, _noisy_sequence
from torch_parity import n, rig_fields, t

T = 6
COUNTS = ("n_detect_l", "n_detect_r", "n_stereo", "n_tracks", "n_inliers")


def _port_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    return interop.window_from_jax(d)[0]


def _sampler_for(jstate):
    """The minimal sets JAX's vo_step draws from this state's key."""
    sub = jax.random.split(jstate.vo.key)[1]

    def sampler(valid, n_hyps, k):
        return t(jransac.sample_minimal_sets(sub, jnp.asarray(n(valid)),
                                             n_hyps, k)).long()
    return sampler


@pytest.fixture(scope="module")
def jax_run():
    lefts, rights = make_planar_sequence(n_frames=T)
    rig, vcfg = _rig(), _cfg()
    cfg = jwvo.WindowVOConfig.create(vcfg, window=3, ba_every=1)
    step = jax.jit(lambda s, l, r: jwvo.window_vo_step(s, l, r, rig, cfg))
    s = jwvo.init_state(rig, cfg)
    states, outs = [], []
    for i in range(T):
        states.append(s)
        s, o = step(s, jnp.asarray(lefts[i]), jnp.asarray(rights[i]))
        outs.append(jax.tree.map(np.asarray, o))
    states.append(s)
    return rig, cfg, lefts, rights, states, outs


def test_config_crosses_from_jax(jax_run, tmp_path):
    """The config crosses field for field; a `ba_mesh` becomes the
    caller's process group (`ba_group`), checked against the mesh's
    landmark axis."""
    import torch.distributed as dist

    from front_end_tpu.ba import distributed as jdist
    _, jcfg, *_ = jax_run
    cfg = _port_cfg(jcfg)
    assert cfg == twvo.WindowVOConfig.create(cfg.vo, window=3, ba_every=1)
    assert cfg.tracker.capacity == 2 * cfg.vo.grid.capacity == 1152
    assert cfg.tracker.desc_bits == 128 and cfg.ba_max_landmarks == 1024
    assert not hasattr(cfg, "ba_mesh") and cfg.ba_group is None
    fields = dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="process group"):
        interop.window_from_jax(dict(fields, ba_mesh=jdist.make_mesh(1)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        with pytest.raises(ValueError, match="landmark axis has 8"):
            interop.window_from_jax(dict(fields, ba_mesh=jdist.make_mesh(8)),
                                    group=group)
        got = interop.window_from_jax(dict(fields,
                                           ba_mesh=jdist.make_mesh(1)),
                                      group=group)[0]
        assert got.ba_group is group
        assert dataclasses.replace(got, ba_group=None) == cfg
    finally:
        dist.destroy_process_group()


def test_window_vo_matches_jax_frame_by_frame(jax_run):
    jrig, jcfg, lefts, rights, states, outs = jax_run
    rig = interop.from_jax(rig_fields(jrig))[0]
    cfg = _port_cfg(jcfg)
    state = twvo.init_state(rig, cfg, device="cpu")
    got = []
    for i in range(T):
        state, o = twvo.window_vo_step(state, lefts[i], rights[i], rig, cfg,
                                       sampler=_sampler_for(states[i]))
        ref = outs[i]
        for f in COUNTS:
            assert int(getattr(o.frame, f)) == int(getattr(ref.frame, f)), \
                (i, f)
        assert int(o.n_tracked) == int(ref.n_tracked), i
        assert int(o.n_new) == int(ref.n_new), i
        assert bool(o.ba_ran) == bool(ref.ba_ran), i
        np.testing.assert_allclose(n(o.frame.pose), ref.frame.pose, atol=2e-4)
        np.testing.assert_allclose(n(o.pose_raw), ref.pose_raw, atol=2e-4)
        np.testing.assert_allclose(float(o.ba_cost), float(ref.ba_cost),
                                   rtol=0.02, atol=1e-3)
        np.testing.assert_allclose(float(o.ba_rms_px), float(ref.ba_rms_px),
                                   rtol=0.02, atol=1e-3)
        got.append(o)
    # the carried window equals JAX's: the same slots hold the same tracks
    final = states[T].win
    for f in ("last_seen", "valid", "vis", "track_len", "bits", "xy", "meas"):
        np.testing.assert_array_equal(n(getattr(state.win.store, f)),
                                      np.asarray(getattr(final.store, f)), f)
    np.testing.assert_allclose(n(state.win.poses), np.asarray(final.poses),
                               atol=2e-4)
    assert state.win.frame_idx == int(final.frame_idx) == T

    # the properties demanded of the JAX package, demanded of the port
    assert all(int(o.n_tracked) > 100 for o in got[1:])
    assert not bool(got[0].ba_ran) and not bool(got[1].ba_ran)
    assert all(bool(o.ba_ran) for o in got[2:])
    assert all(np.isfinite(float(o.ba_cost)) for o in got[2:])
    assert all(float(o.ba_rms_px) < 1.0 for o in got[2:])
    gt = _gt_positions(T)
    p = np.stack([n(o.frame.pose)[:3, 3] for o in got])
    np.testing.assert_allclose(p[:, 0], gt[:, 0] + (p[0, 0] - gt[0, 0]),
                               atol=0.05)


def _port_setup(**kw):
    jrig, jvcfg = _rig(), _cfg()
    rig, vcfg, _ = interop.from_jax(rig_fields(jrig),
                                    dataclasses.asdict(jvcfg))
    return rig, vcfg, twvo.WindowVOConfig.create(vcfg, **kw)


def test_window_beats_frame_to_frame_on_the_noisy_sequence():
    """Windowed ATE <= 0.97 x frame-to-frame ATE and < 0.2 m, with the
    port's own seeded RANSAC draws (the same draws in both runs)."""
    frames = 8
    lefts, rights = _noisy_sequence(n_frames=frames)
    rig, vcfg, cfg = _port_setup(window=3, ba_every=1)
    gt = _gt_positions(frames)
    s0 = tvo.init_state(rig, vcfg, seed=0, device="cpu")
    _, plain = tvo.run_sequence(s0, lefts, rights, rig, vcfg)
    s1 = twvo.init_state(rig, cfg, seed=0, device="cpu")
    _, win = twvo.run_sequence(s1, lefts, rights, rig, cfg)
    assert win.frame.pose.shape == (frames, 4, 4)
    ate_plain = np.sqrt(np.mean(np.sum(
        (n(plain.pose)[:, :3, 3] - gt) ** 2, -1)))
    ate_win = np.sqrt(np.mean(np.sum(
        (n(win.frame.pose)[:, :3, 3] - gt) ** 2, -1)))
    assert ate_win <= ate_plain * 0.97, (ate_win, ate_plain)
    assert ate_win < 0.2, ate_win


def test_long_window_fills_and_refines():
    lefts, rights = make_planar_sequence(n_frames=8)
    rig, _, cfg = _port_setup(window=6, ba_every=2, ba_iters=2)
    state = twvo.init_state(rig, cfg, device="cpu")
    assert state.win.poses.shape == (6, 4, 4)
    state, outs = twvo.run_sequence(state, lefts, rights, rig, cfg)
    assert bool(state.win.pose_valid.all())
    ran = outs.ba_ran.tolist()
    assert ran == [False] * 5 + [True, False, True]
    last = max(i for i, r in enumerate(ran) if r)
    assert np.isfinite(float(outs.ba_cost[last]))
    assert float(outs.ba_rms_px[last]) < 1.0


def test_ba_every_two_skips_frames():
    lefts, rights = make_planar_sequence(n_frames=5)
    rig, _, cfg = _port_setup(window=3, ba_every=2)
    state = twvo.init_state(rig, cfg, device="cpu")
    state, outs = twvo.run_sequence(state, lefts, rights, rig, cfg)
    assert outs.frame.pose.shape == (5, 4, 4)
    assert outs.ba_ran.tolist() == [False, False, False, True, False]
    # without BA the refined pose is the raw pose
    skipped = ~outs.ba_ran
    assert torch.equal(outs.frame.pose[skipped], outs.pose_raw[skipped])
    assert float(outs.ba_cost[skipped].abs().max()) == 0.0

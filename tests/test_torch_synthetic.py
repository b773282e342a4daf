"""The port's synthetic worlds (`sim/synthetic.py`) on JAX-drawn values
against the JAX package's functions on the same PRNG keys, within TOL
(relative and absolute: pixel rows reach 1000, where a float32 ulp is
6e-5); validity masks and the valid-rows-first order exactly.  Then the
`torch.Generator` form: the validity share and the contracts."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from front_end_tpu.geometry.camera import bumblebee_rig as jbumblebee
from front_end_tpu.sim import synthetic as jsim
from front_end_tpu_torch.geometry.camera import bumblebee_rig
from front_end_tpu_torch.sim import synthetic as sim
from torch_parity import n

TOL = 1e-5
N, OVER, W = 60, 48, 3


def _close(a, b):
    a, b = n(a), np.asarray(b)
    if a.dtype == bool or b.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def _motion_draws(key):
    kr, kt = jax.random.split(key)
    return (jax.random.normal(kr, (3,)), jax.random.normal(kt, (3,)))


def _world_draws(key, n=N, oversample=OVER):
    km, kp = jax.random.split(key)
    kx, ky, kz = jax.random.split(kp, 3)
    m = oversample * n
    pts = jnp.stack([jax.random.normal(k, (m,)) for k in (kx, ky, kz)], -1)
    return tuple(np.asarray(d) for d in (*_motion_draws(km), pts))


def _port_world(jw):
    return sim.StereoWorld(*(torch.as_tensor(np.asarray(f)) for f in jw))


@pytest.mark.parametrize("name", ["slow", "medium", "fast"])
def test_motion_category_and_sample_motion_equal_jax(name):
    cat, jcat = sim.motion_category(name), jsim.motion_category(name)
    assert cat == (float(jcat.translation_mean),
                   float(jcat.translation_noise),
                   float(jcat.rotation_noise_deg))
    key = jax.random.PRNGKey(7)
    H, Ht = sim.sample_motion(_motion_draws(key), cat)
    jH, jHt = jsim.sample_motion(key, jcat)
    _close(H, jH)
    _close(Ht, jHt)


@pytest.fixture(scope="module")
def worlds():
    rig, jrig = bumblebee_rig(), jbumblebee()
    cat, jcat = sim.motion_category("medium"), jsim.motion_category("medium")
    key = jax.random.PRNGKey(3)
    return rig, jrig, cat, jcat, key, jsim.sample_world(key, jrig, jcat, N)


def test_sample_world_equals_jax(worlds):
    rig, _, cat, _, key, jw = worlds
    w = sim.sample_world(_world_draws(key), rig, cat, N)
    assert bool(w.valid.all())
    for f in w._fields:
        _close(getattr(w, f), getattr(jw, f))


def test_add_gaussian_noise_equals_jax(worlds):
    rig, jrig, _, _, _, jw = worlds
    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 4)
    draws = [np.asarray((jax.random.normal if i % 2 == 0 else
                         jax.random.uniform)(k, (N, 2)))
             for i, k in enumerate(ks)]
    got = sim.add_gaussian_noise(draws, _port_world(jw), rig, 0.75)
    ref = jsim.add_gaussian_noise(key, jw, jrig, 0.75)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f))


def test_add_outliers_equals_jax(worlds):
    rig, jrig, _, _, _, jw = worlds
    key = jax.random.PRNGKey(12)
    ksel, kpt, krx = jax.random.split(key, 3)
    draws = (jax.random.uniform(ksel, (N,)),
             jax.random.uniform(kpt, (N, sim.OUTLIER_CANDIDATES, 2)),
             jax.random.uniform(krx, (N,)))
    got, mask = sim.add_outliers([np.asarray(d) for d in draws],
                                 _port_world(jw), rig, 0.25)
    ref, jmask = jsim.add_outliers(key, jw, jrig, 0.25)
    _close(mask, jmask)
    assert 0 < int(mask.sum()) < N
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f))


def test_sample_worlds_equals_jax(worlds):
    rig, jrig, cat, jcat, _, _ = worlds
    key = jax.random.PRNGKey(5)
    per = [_world_draws(k, n=20) for k in jax.random.split(key, 4)]
    draws = tuple(np.stack(d) for d in zip(*per))
    got = sim.sample_worlds(draws, rig, cat, 20, batch=4)
    ref = jsim.sample_worlds(key, jrig, jcat, 20, batch=4)
    assert got.Xa.shape == (4, 20, 3)
    for f in got._fields:
        _close(getattr(got, f), getattr(ref, f))


@pytest.fixture(scope="module")
def window_worlds(worlds):
    rig, jrig, cat, jcat, _, _ = worlds
    key = jax.random.PRNGKey(21)
    km, kp = jax.random.split(key)
    steps = []
    for _ in range(W - 1):
        km, k = jax.random.split(km)
        steps.append(np.stack(_motion_draws(k)))
    kx, ky, kz = jax.random.split(kp, 3)
    pts = jnp.stack([jax.random.normal(k, (OVER * N,)) for k in (kx, ky, kz)],
                    -1)
    ww = sim.sample_window_world((np.stack(steps), np.asarray(pts)), rig,
                                 cat, N, window=W)
    jww = jsim.sample_window_world(key, jrig, jcat, N, window=W)
    return rig, jrig, ww, jww


def test_sample_window_world_equals_jax(window_worlds):
    _, _, ww, jww = window_worlds
    assert ww.meas.shape == (N, W, 4) and bool(ww.valid.all())
    for f in ww._fields:
        _close(getattr(ww, f), getattr(jww, f))


def test_window_add_noise_equals_jax(window_worlds):
    _, _, ww, jww = window_worlds
    key = jax.random.PRNGKey(31)
    kx, ky = jax.random.split(key)
    draws = (np.asarray(jax.random.normal(kx, (N, W, 2))),
             np.asarray(jax.random.uniform(ky, (N, W, 2))))
    _close(sim.window_add_noise(draws, ww, 1.5).meas,
           jsim.window_add_noise(key, jww, 1.5).meas)


def test_window_add_outliers_equals_jax(window_worlds):
    rig, jrig, ww, jww = window_worlds
    key = jax.random.PRNGKey(41)
    ksel, kpt, krx = jax.random.split(key, 3)
    draws = [np.asarray(d) for d in (
        jax.random.uniform(ksel, (N, W)), jax.random.uniform(kpt, (N, W, 2)),
        jax.random.uniform(krx, (N, W)))]
    got, mask = sim.window_add_outliers(draws, ww, rig, 0.2)
    ref, jmask = jsim.window_add_outliers(key, jww, jrig, 0.2)
    _close(mask, jmask)
    assert not bool(mask[:, 0].any()) and bool(mask.any())
    _close(got.meas, ref.meas)


def test_draws_of_the_wrong_shape_are_refused(worlds):
    rig, _, cat, _, _, _ = worlds
    with pytest.raises(ValueError, match="draws of shapes"):
        sim.sample_world((np.zeros(3), np.zeros(3), np.zeros((10, 3))), rig,
                         cat, N)


def test_generator_worlds_validity_share_and_contracts():
    """From a torch.Generator: ~4 % of the reference prior lands in both
    frusta, so 48× oversampling fills all rows; noise and outliers keep
    their contracts; the same seed draws the same world."""
    rig, cat = bumblebee_rig(), sim.motion_category("slow")
    g = torch.Generator().manual_seed(0)
    w = sim.sample_world(g, rig, cat, 200)
    assert bool(w.valid.all())
    one = sim.sample_world(torch.Generator().manual_seed(1), rig, cat, 4000,
                           oversample=1)
    share = float(one.valid.float().mean())
    assert 0.02 < share < 0.08, share
    torch.testing.assert_close(
        w.Xb, sim.sample_world(torch.Generator().manual_seed(0), rig, cat,
                               200).Xb, rtol=0, atol=0)
    step = float(torch.linalg.norm(w.Ht[:3, 3]))
    assert 0.01 < step < 0.05                 # slow: ~0.022 m a step
    noisy = sim.add_gaussian_noise(g, w, rig, 0.5)
    dy = noisy.uva[:, 1] - w.uva[:, 1]
    assert float(dy.min()) >= 0 and float(dy.max()) < 1
    out, mask = sim.add_outliers(g, w, rig, 0.2)
    shift = (out.uvb[mask, :2] - w.uvb[mask, :2]).abs()
    assert bool((shift > sim.MIN_OUTLIER_SHIFT).all())
    assert 0.1 < float(mask.float().mean()) < 0.3
    batch = sim.sample_worlds(g, rig, cat, 50, batch=3)
    assert batch.valid.shape == (3, 50) and bool(batch.valid.all())
    ww = sim.sample_window_world(g, rig, cat, 100, window=4)
    assert ww.poses.shape == (4, 4, 4) and bool(ww.valid.all())

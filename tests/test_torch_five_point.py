"""Parity of the port's 5-point solver (`motion/five_point.py`) with the
JAX package's.

The 4-D null space of the 5×9 system has no unique basis: two LAPACKs
return two bases, and from them the resultant's roots, the sign changes
and the candidates' order differ.  So the solver is compared in parts:
- `candidates_from_basis` on JAX's own basis: the same validity mask and
  order; every candidate that satisfies the ten cubic constraints to 1e-5
  on both sides agrees within 5e-3 (a root's sensitivity to rounding;
  measured 4.3e-3, median 1e-5 over 64 sets);
- each library on its own basis: another set of spurious resultant roots,
  and (grid cells holding two roots show no sign change) not always the
  same true ones.  Measured over 256 noise-free minimal sets: the true E
  found in 216 (JAX) and 213 (port); of the candidates that satisfy the
  constraints to 1e-6, 89 % matched on the other side.  Stated: the port
  finds the true E in at least as many sets as JAX less 5 % of them, and
  at least 80 % of tight candidates match;
- the θ grid equals JAX's float32 array exactly;
- RANSAC (`essential_scaled_motion(solver="five_point")`) on JAX's draws:
  where both reach the best consensus, the same set (or a row apart) and
  R within 2e-3 rad; `test_ransac_five_point_outcome_matches_jax` names
  the seed where JAX's candidates miss it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from front_end_tpu.geometry.camera import StereoRig as JRig
from front_end_tpu.motion import essential as jes
from front_end_tpu.motion import five_point as jfp
from front_end_tpu.motion import ransac as jransac
from front_end_tpu_torch.geometry.camera import StereoRig as TRig
from front_end_tpu_torch.motion import essential as tes
from front_end_tpu_torch.motion import five_point as tfp
from torch_parity import n, t


def _rot(ax, a):
    c, s = np.cos(a), np.sin(a)
    if ax == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if ax == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _sets(B, seed=0):
    """B noise-free minimal sets of 5 correspondences, each under its own
    motion, and the true (unit-norm) E of each."""
    rs = np.random.RandomState(seed)
    xa, xb, Es = [], [], []
    for _ in range(B):
        R = (_rot(0, rs.uniform(-0.2, 0.2)) @ _rot(1, rs.uniform(-0.2, 0.2))
             @ _rot(2, rs.uniform(-0.2, 0.2)))
        tv = rs.uniform(-1, 1, 3)
        tv /= np.linalg.norm(tv)
        X = np.stack([rs.uniform(-2, 2, 5), rs.uniform(-2, 2, 5),
                      rs.uniform(4, 10, 5)], -1)
        Xb = X @ R.T + tv
        xa.append(X[:, :2] / X[:, 2:])
        xb.append(Xb[:, :2] / Xb[:, 2:])
        E = _skew(tv) @ R
        Es.append(E / np.linalg.norm(E))
    f32 = np.float32
    return np.stack(xa).astype(f32), np.stack(xb).astype(f32), np.stack(Es)


def _unsign(E):
    flat = np.asarray(E, np.float64).reshape(np.shape(E)[:-2] + (9,))
    k = np.abs(flat).argmax(-1)
    return flat * np.sign(np.take_along_axis(flat, k[..., None], -1))


def _cubic_residual(E):
    E = np.asarray(E, np.float64)
    return np.abs(2 * E @ E.T @ E - np.trace(E @ E.T) * E).max()


def _jax_basis(xa, xb):
    def rows(a, b):
        x1, y1, x2, y2 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
        return jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                          jnp.ones_like(x1)], -1)
    Vt = np.asarray(jax.vmap(lambda a, b: jnp.linalg.svd(
        rows(a, b), full_matrices=True)[2])(xa, xb))
    B = len(xa)
    return [Vt[:, i].reshape(B, 3, 3) for i in (5, 6, 7, 8)]


def test_theta_grid_is_jaxs_float32_array():
    ref = np.asarray(jnp.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3,
                                  jfp.N_SCAN))
    assert tfp.THETAS.dtype == np.float32
    np.testing.assert_array_equal(tfp.THETAS, ref)
    # torch's own linspace rounds otherwise: the exact copy is needed
    tl = torch.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, 128).numpy()
    assert (tl != ref).sum() > 10
    assert (tfp.MAX_ROOTS, tfp.N_SCAN, tfp.N_BISECT) == \
        (jfp.MAX_ROOTS, jfp.N_SCAN, jfp.N_BISECT)


def test_constraint_tensor_matches_jax_on_jaxs_basis():
    xa, xb, _ = _sets(4, seed=2)
    X, Y, Z, W = _jax_basis(xa, xb)
    got = tfp._constraint_tensor(t(X), t(Y), t(Z), t(W))
    ref = jax.vmap(jfp._constraint_tensor)(X, Y, Z, W)
    assert got.shape == (4, 10, 10, 4)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-7)
    thetas = t(tfp.THETAS)
    np.testing.assert_array_equal(
        n(tfp._sign_at(got[0], thetas)),
        n(jfp._sign_at(ref[0], jnp.asarray(tfp.THETAS))))


def test_candidates_on_jaxs_basis():
    xa, xb, _ = _sets(64)
    basis = _jax_basis(xa, xb)
    got = tfp.candidates_from_basis(*(t(b) for b in basis))
    ref = jax.vmap(jfp.five_point_candidates)(xa, xb)
    gv, rv = n(got.valid), np.asarray(ref.valid)
    np.testing.assert_array_equal(gv, rv)          # same roots, same order
    assert rv.sum() > 150
    gE, rE = n(got.E), np.asarray(ref.E)
    tight = np.array([[v and _cubic_residual(a) < 1e-5
                       and _cubic_residual(b) < 1e-5
                       for v, a, b in zip(vr, ar, br)]
                      for vr, ar, br in zip(gv, gE, rE)])
    assert tight.sum() > 0.7 * rv.sum()
    d = np.abs(gE - rE).reshape(64, 10, 9).max(-1)[tight]
    assert d.max() <= 5e-3 and np.median(d) <= 1e-4, (d.max(), np.median(d))


def test_candidate_sets_on_each_librarys_own_basis():
    B = 96
    xa, xb, E_true = _sets(B, seed=1)
    got = tfp.five_point_candidates(t(xa), t(xb))
    ref = jax.vmap(jfp.five_point_candidates)(xa, xb)
    gv, gE = n(got.valid), n(got.E)
    rv, rE = np.asarray(ref.valid), np.asarray(ref.E)

    def found(E, v, b):
        return v[b].any() and np.abs(_unsign(E[b][v[b]])
                                     - _unsign(E_true[b])).max(-1).min() \
            < 5e-3
    hit_t = sum(found(gE, gv, b) for b in range(B))
    hit_j = sum(found(rE, rv, b) for b in range(B))
    assert hit_j > 0.7 * B and hit_t >= hit_j - 0.05 * B, (hit_t, hit_j)
    matched = total = 0
    for b in range(B):
        S, O = gE[b][gv[b]], rE[b][rv[b]]
        for one, other in ((S, O), (O, S)):
            for E in one:
                if _cubic_residual(E) > 1e-6:
                    continue
                total += 1
                matched += len(other) > 0 and np.abs(
                    _unsign(E) - _unsign(other)).max(-1).min() < 5e-3
    assert total > 200 and matched >= 0.8 * total, (matched, total)


def _jax_sampler(key):
    def sampler(valid, n_hyps, k):
        return t(jransac.sample_minimal_sets(key, jnp.asarray(n(valid)),
                                             n_hyps, k)).long()
    return sampler


def _scene(seed, n_pts=150, outliers=0.3):
    rs = np.random.RandomState(seed)
    R = _rot(1, 0.04) @ _rot(2, 0.02)
    tv = np.array([0.2, -0.05, 0.6])
    X = rs.uniform(-2, 2, (n_pts, 3))
    X[:, 2] = rs.uniform(4, 12, n_pts)
    Xb = X @ R.T + tv
    pp = np.array([160.0, 120.0])
    uva = X[:, :2] / X[:, 2:3] * 300.0 + pp
    uvb = Xb[:, :2] / Xb[:, 2:3] * 300.0 + pp
    bad = rs.uniform(size=n_pts) < outliers
    uvb[bad] += rs.uniform(-30, 30, (bad.sum(), 2))
    f32 = np.float32
    return (uva.astype(f32), uvb.astype(f32), X.astype(f32),
            Xb.astype(f32), np.ones(n_pts, bool), R, tv, bad)


@pytest.mark.parametrize("seed", range(6))
def test_ransac_five_point_outcome_matches_jax(seed):
    """Fed JAX's draws, each library scores its own candidates (its own
    basis): where both reach the best consensus (5 of these 6 seeds) the
    sets are equal or a row apart and R agrees within 2e-3 rad (measured
    1.5e-3); on seed 3
    JAX's candidates miss it (97 of 104 true inliers; the port 105, R 1.2e-3
    from the truth against JAX's 6.8e-3).  Stated: consensus sets apart in
    at most 7 % of rows, R within 1.2e-2 rad, each within 0.01 of the
    truth."""
    uva, uvb, Xa, Xb, valid, R, tv, bad = _scene(seed)
    key = jax.random.PRNGKey(seed)
    rig = dict(fx=300.0, cx=160.0, cy=120.0, baseline=0.5, width=320,
               height=240)
    got = tes.essential_scaled_motion(
        _jax_sampler(key), t(uva), t(uvb), t(Xa), t(Xb), t(valid),
        TRig.create(**rig), n_hyps=32, threshold_px=1.0, solver="five_point")
    ref = jes.essential_scaled_motion(
        key, uva, uvb, Xa, Xb, valid, JRig.create(**rig), n_hyps=32,
        threshold_px=1.0, solver="five_point")
    apart = (n(got.inliers) != np.asarray(ref.inliers)).sum()
    assert apart <= 0.07 * len(bad)
    assert int(got.n_inliers) >= (~bad).sum() - 2
    ang = np.arccos(np.clip((np.trace(n(got.R).T @ np.asarray(ref.R)) - 1)
                            / 2, -1, 1))
    assert ang < (2e-3 if apart <= 1 else 1.2e-2), (ang, apart)
    np.testing.assert_allclose(n(got.R), R, atol=0.01)
    np.testing.assert_allclose(n(got.T), tv, atol=0.05)
    # the 5-point RANSAC alone: its consensus is the true inlier set
    xa = (t(uva) - torch.tensor([160.0, 120.0])) / 300.0
    xb = (t(uvb) - torch.tensor([160.0, 120.0])) / 300.0
    E, inl, n_inl, scores = tfp.ransac_five_point(
        _jax_sampler(key), xa, xb, t(valid), n_hyps=32,
        threshold=1.0 / 300.0)
    assert scores.shape == (32 * tfp.MAX_ROOTS,)
    assert int(n_inl) == int(scores.max()) >= (~bad).sum() - 2

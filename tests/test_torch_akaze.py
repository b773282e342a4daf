"""Parity of the port's AKAZE (`ops/akaze.py`) and its 64 detector IDs
with the JAX package.

The JAX package scans its diffusion steps as one compiled body, where
XLA's CPU code contracts products and sums into fused multiply-adds; the
port adds them as they are written.  So evolution levels agree within a
few units in the last place, not bit for bit.  Stated tolerances: the
FED step sizes, the θ centres and the contrast factor k (sorted
magnitudes, the same float32 rank) are exact; diffused images within
1e-6, det-Hessian responses within 5e-6 relative to the level's largest
(measured 9.4e-7); sweep maps: the same corner pixels, responses within
1e-7 (measured 3.1e-8), sweep counts exact and statistics within 1e-4
(JAX sums in float32); keypoints: the same valid set, levels and scales,
positions within 5e-4 px (measured 2.7e-4: a quadratic fit's
offset divides by a small determinant), orientations within 1e-5 rad
(9.5e-7), M-SURF values within 5e-6 (8.9e-7), MLDB bits at most 0.1 %
differing (measured 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu import features as jfeatures
from front_end_tpu import services as jservices
from front_end_tpu.ops import akaze as jak
from front_end_tpu_torch import features as tfeatures
from front_end_tpu_torch import services as tservices
from front_end_tpu_torch.ops import akaze as tak
from torch_parity import image, n, t

IMG = image(120, 160, seed=1)
DIFFS = ("pm_g1", "pm_g2", "weickert", "charbonnier")


def test_fed_taus_and_orientation_centres_equal_jax():
    for T in (0.3, 0.5, 1.28, 2.0, 7.3):
        np.testing.assert_array_equal(tak.fed_tau_by_process_time(T),
                                      jak.fed_tau_by_process_time(T))
    offs, wj, centres = tak._orientation_consts(torch.device("cpu"))
    np.testing.assert_array_equal(
        n(centres), np.asarray(jnp.linspace(-jnp.pi, jnp.pi, 42,
                                            endpoint=False)))
    assert offs.shape == (113, 2) and wj.shape == (113,)   # r <= 6 disc


@pytest.mark.parametrize("kind", DIFFS)
def test_conductivity_matches_jax(kind):
    rs = np.random.RandomState(0)
    lx, ly = (rs.normal(0, 0.1, (40, 50)).astype(np.float32)
              for _ in range(2))
    k = np.float32(0.07)
    got = tak.conductivity(t(lx), t(ly), torch.tensor(k), kind)
    ref = jak.conductivity(jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(k),
                           kind)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="unknown diffusivity"):
        tak.conductivity(t(lx), t(ly), torch.tensor(k), "linear")


def test_k_percentile_equals_jax_on_a_kitti_frame():
    """JAX's `nanquantile`, step for step (with the fused multiply-add of
    its final sum), on 376×1241 frames: exact."""
    for seed in (0, 3):
        big = image(376, 1241, seed=seed) / 255.0
        got = tak.compute_k_percentile(t(big))
        ref = jak.compute_k_percentile(jnp.asarray(big))
        assert float(got) == float(ref) > 0.01
    # no nonzero gradient: the 0.03 floor, as JAX's
    flat = np.full((30, 40), 0.5, np.float32)
    assert float(tak.compute_k_percentile(t(flat))) == \
        float(jak.compute_k_percentile(jnp.asarray(flat))) == \
        pytest.approx(0.03)
    # the quantile itself, NaNs skipped, at several ranks
    x = np.random.RandomState(1).uniform(0, 1, 1001).astype(np.float32)
    x[::7] = np.nan
    for q in (0.0, 0.3, 0.7, 1.0):
        assert float(tak.nanquantile_linear(t(x), q)) == \
            float(jnp.nanquantile(jnp.asarray(x), q))


def test_nld_step_matches_jax():
    rs = np.random.RandomState(2)
    lt = rs.uniform(0, 1, (50, 60)).astype(np.float32)
    g = rs.uniform(0, 1, (50, 60)).astype(np.float32)
    got = tak.nld_step(t(lt), t(g), np.float32(0.37))
    ref = jak.nld_step(jnp.asarray(lt), jnp.asarray(g), np.float32(0.37))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("kind", DIFFS)
def test_scale_space_matches_jax(kind):
    got = tak.nonlinear_scale_space(t(IMG), n_octaves=2, n_sublevels=2,
                                    diffusivity=kind)
    ref = jak.nonlinear_scale_space(IMG, n_octaves=2, n_sublevels=2,
                                    diffusivity=kind)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert (a.sigma, a.octave, a.sublevel) == (b.sigma, b.octave,
                                                   b.sublevel)
        assert a.lt.shape == b.lt.shape
        np.testing.assert_allclose(n(a.lt), np.asarray(b.lt), atol=1e-6)
        for f in ("lx", "ly"):
            np.testing.assert_allclose(n(getattr(a, f)),
                                       np.asarray(getattr(b, f)), atol=1e-6)
        scale = np.abs(np.asarray(b.ldet)).max()
        np.testing.assert_allclose(n(a.ldet), np.asarray(b.ldet), rtol=0,
                                   atol=5e-6 * scale)


@pytest.mark.parametrize("kind,no,ns", [("pm_g2", 2, 2), ("weickert", 2, 4),
                                        ("charbonnier", 4, 2)])
def test_detect_dense_maps_match_jax(kind, no, ns):
    got = n(tak.detect_dense(t(IMG), threshold=1e-8, n_octaves=no,
                             n_sublevels=ns, diffusivity=kind))
    ref = np.asarray(jak.detect_dense(IMG, threshold=1e-8, n_octaves=no,
                                      n_sublevels=ns, diffusivity=kind))
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert (ref > 0).sum() > 300
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("descriptor", ["mldb", "msurf"])
def test_detect_and_describe_matches_jax(descriptor):
    got_d, got = tak.detect_and_describe(t(IMG), n_octaves=2, n_sublevels=4,
                                         max_keypoints=512,
                                         descriptor=descriptor)
    ref_d, ref = jak.detect_and_describe(IMG, n_octaves=2, n_sublevels=4,
                                         max_keypoints=512,
                                         descriptor=descriptor)
    gk, rk = got_d.keypoints, ref_d.keypoints
    v = np.asarray(rk.valid)
    np.testing.assert_array_equal(n(gk.valid), v)
    assert v.sum() > 150
    np.testing.assert_array_equal(n(got_d.level), np.asarray(ref_d.level))
    np.testing.assert_array_equal(n(got_d.sigma), np.asarray(ref_d.sigma))
    np.testing.assert_allclose(n(gk.xy)[v], np.asarray(rk.xy)[v], atol=5e-4)
    np.testing.assert_allclose(n(gk.score), np.asarray(rk.score),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(n(gk.angle), np.asarray(rk.angle), atol=1e-5)
    gb, rb = n(got.bits), np.asarray(ref.bits)
    assert gb.shape == rb.shape
    if descriptor == "mldb":
        assert gb.shape[1] == tak.MLDB_PADDED == 512
        assert got.norm == "hamming" and (gb[:, tak.MLDB_BITS:] == 0).all()
        assert (gb != rb).mean() <= 1e-3
        assert set(np.unique(gb)) == {0.0, 1.0}
    else:
        assert gb.shape[1] == 64 and got.norm == "l2"
        np.testing.assert_allclose(gb, rb, atol=5e-6)
        np.testing.assert_allclose(np.linalg.norm(gb[v], axis=1), 1.0,
                                   atol=1e-5)


def test_detect_pads_a_short_capacity_like_jax():
    """At 2 octaves × 2 layers three levels count, and max(16, 512 // 3)
    = 170 rows each fill 510 of 512 slots: both pad the rest with invalid
    rows (scale 1, level 0)."""
    got = tak.detect(t(IMG), n_octaves=2, n_sublevels=2, max_keypoints=512)
    ref = jak.detect(IMG, n_octaves=2, n_sublevels=2, max_keypoints=512)
    assert got.keypoints.capacity == 512
    np.testing.assert_array_equal(n(got.keypoints.valid),
                                  np.asarray(ref.keypoints.valid))
    np.testing.assert_array_equal(n(got.sigma), np.asarray(ref.sigma))
    np.testing.assert_array_equal(n(got.level), np.asarray(ref.level))
    np.testing.assert_allclose(n(got.keypoints.xy),
                               np.asarray(ref.keypoints.xy), atol=5e-4)


def test_orientations_and_descriptors_on_given_keypoints():
    """The per-keypoint stages alone, fed JAX's detections and evolution
    inputs: orientations, M-SURF and MLDB."""
    evo_t = tak.nonlinear_scale_space(t(IMG), n_octaves=2, n_sublevels=2)
    evo_j = jak.nonlinear_scale_space(IMG, n_octaves=2, n_sublevels=2)
    det = jak.detect(IMG, n_octaves=2, n_sublevels=2, max_keypoints=128,
                     evolution=evo_j)
    k = det.keypoints
    xy, sg, lv, vd = (t(a) for a in (k.xy, det.sigma, det.level, k.valid))
    ang = tak.orientations(evo_t, xy, sg, lv.long(), vd)
    rang = jak.orientations(evo_j, k.xy, det.sigma, det.level, k.valid)
    np.testing.assert_allclose(n(ang), np.asarray(rang), atol=1e-5)
    ms = tak.describe_msurf(evo_t, xy, sg, t(rang), lv.long(), vd)
    rms = jak.describe_msurf(evo_j, k.xy, det.sigma, rang, det.level,
                             k.valid)
    np.testing.assert_allclose(n(ms.bits), np.asarray(rms.bits), atol=5e-6)
    ml = tak.describe_mldb(evo_t, xy, sg, t(rang), lv.long(), vd)
    rml = jak.describe_mldb(evo_j, k.xy, det.sigma, rang, det.level,
                            k.valid)
    assert (n(ml.bits) != np.asarray(rml.bits)).mean() <= 1e-3


def _akaze_groups():
    dt = tfeatures.detector_table()
    groups = {}
    for i in tfeatures.ids_for("AKAZE", dt):
        p = dt[i]["Param"]
        groups.setdefault((p["n_octaves"], p["n_octave_layers"],
                           p["diffusivity"]), []).append(i)
    return groups


def test_sweep_answers_the_64_akaze_ids_like_jax():
    """The 64 IDs fall in 16 groups (2 or 4 octaves × 2 or 4 layers × 4
    diffusivities) of 4 thresholds; four groups, one per diffusivity,
    against the JAX package's records: counts exact, statistics within
    1e-4, nothing flagged approximate.  All 64 answer on the CPU, counts
    falling as the threshold rises."""
    groups = _akaze_groups()
    assert len(groups) == 16 and {len(v) for v in groups.values()} == {4}
    picks = (groups[(2, 2, "pm_g1")] + groups[(2, 4, "pm_g2")]
             + groups[(4, 2, "weickert")] + groups[(2, 2, "charbonnier")])
    L, R = IMG, image(120, 160, seed=2)
    got = tservices.single_image_detection(picks, L, R, device="cpu")
    ref = jservices.single_image_detection(picks, L, R)
    for g, r in zip(got, ref):
        assert g["detID"] == r["detID"] and g["supported"] and r["supported"]
        assert g["approximate"] is False
        for side in ("leftFeatures", "rightFeatures"):
            a, b = g[side], r[side]
            assert a["nPoints"] == b["nPoints"], (g["detID"], side)
            for ax in ("X", "Y"):
                assert abs(a[ax][0] - b[ax][0]) <= 1e-4
                assert abs(a[ax][1] - b[ax][1]) <= 1e-4
    ids = sum(groups.values(), [])
    recs = tservices.single_image_detection(ids, L, R, device="cpu")
    assert all(r["supported"] for r in recs)
    dt = tfeatures.detector_table()
    by_id = {r["detID"]: r for r in recs}
    for members in groups.values():
        members = sorted(members, key=lambda i: dt[i]["Param"]["threshold"])
        c = [by_id[i]["leftFeatures"]["nPoints"] for i in members]
        assert c == sorted(c, reverse=True) and c[0] > c[-1] > 0, c


@pytest.mark.parametrize("pick", [0, 37])
def test_make_detector_akaze_map(pick):
    det_id = tfeatures.ids_for("AKAZE", tfeatures.detector_table())[pick]
    ref = np.asarray(jfeatures.make_detector(det_id)[0](jnp.asarray(IMG)))
    got = n(tfeatures.make_detector(det_id)[0](torch.as_tensor(IMG)))
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert (ref > 0).sum() > 50
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)

"""`features.py`, `services.py` and `pipeline/control.py` against the JAX
package.

Tables: same IDs, same order, same settings, key by key.  Service records:
FAST, BRISK and SURF counts exact (the dense FAST forms are bit-exact,
BRISK's blur too, SURF's Hessian on integer images); ORB counts within 1 %
(a resized pyramid level can flip a corner that sits on the FAST
threshold: measured at most 1 of ~1100); means and standard deviations
within 1e-4 (the port sums exact integers, the JAX package float32); flags
and record order equal.  Stereo features and matches are exact; FREAK
bits at most 0.1 % differing (measured 0), SURF values within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from front_end_tpu import features as jfeatures
from front_end_tpu import services as jservices
from front_end_tpu.pipeline import control as jcontrol
from front_end_tpu_torch import features as tfeatures
from front_end_tpu_torch import services as tservices
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops import grid as tgrid
from front_end_tpu_torch.pipeline import control as tcontrol
from front_end_tpu_torch.pipeline import vo as tvo
from torch_parity import assert_matches_equal, image, n

LEFT, RIGHT = image(120, 160, seed=1), image(120, 160, seed=2)


def test_tables_equal_key_by_key():
    for tt, jt in ((tfeatures.detector_table(), jfeatures.detector_table()),
                   (tfeatures.descriptor_table(),
                    jfeatures.descriptor_table())):
        assert list(tt) == list(jt)                    # same IDs, same order
        assert tt == jt                                # same settings
    dt = tfeatures.detector_table()
    counts = {f: len(tfeatures.ids_for(f, dt))
              for f in ("FAST", "ORB", "BRISK", "SURF", "AKAZE")}
    assert counts == {"FAST": 354, "ORB": 270, "BRISK": 88, "SURF": 432,
                      "AKAZE": 64}
    assert len(tfeatures.descriptor_table()) == 17


@pytest.mark.parametrize("name", [
    "fast_combinations", "brief_combinations", "surf_detector_combinations",
    "surf_descriptor_combinations", "brisk_combinations",
    "akaze_detector_combinations", "orb_detector_combinations",
    "freak_combinations", "orb_descriptor_combinations"])
def test_combinations_equal(name):
    assert getattr(tfeatures, name)() == getattr(jfeatures, name)()


def test_matcher_norm_and_yaml_export(tmp_path):
    for table in (tfeatures.detector_table(), tfeatures.descriptor_table()):
        for settings in table.values():
            assert tfeatures.matcher_norm(settings) == \
                jfeatures.matcher_norm(settings)
    wta3 = [s for s in tfeatures.descriptor_table().values()
            if s["Name"] == "ORB" and s["Param"]["wta_k"] == 3][0]
    assert tfeatures.matcher_norm(wta3) == "NORM_HAMMING2"
    a, b = tmp_path / "t.yaml", tmp_path / "j.yaml"
    assert tfeatures.export_table_yaml(str(a)) == \
        jfeatures.export_table_yaml(str(b)) == 1208 + 17
    assert a.read_text() == b.read_text()


def test_factories_supported_and_missing():
    """Every detector family of the table, AKAZE included, and every one
    of the 17 descriptor IDs; a family outside the tables is the miss
    contract's (None, False)."""
    dt, ds = tfeatures.detector_table(), tfeatures.descriptor_table()
    for fam in ("FAST", "ORB", "BRISK", "SURF", "AKAZE"):
        fn, ok = tfeatures.make_detector(tfeatures.ids_for(fam, dt)[3])
        assert ok and callable(fn)
    answered = [tfeatures.make_descriptor(i) for i in ds]
    assert len(answered) == 17 and all(ok and callable(fn)
                                       for fn, ok in answered)
    assert sum(tfeatures.make_detector(i)[1] for i in dt) == 1208
    assert tfeatures.make_detector({"Name": "SIFT", "Param": {}}) == \
        (None, False)
    assert tfeatures.make_descriptor({"Name": "SIFT", "Param": {}}) == \
        (None, False)


@pytest.mark.parametrize("fam,pick", [("FAST", 8), ("FAST", 100),
                                      ("FAST", 207), ("ORB", 50),
                                      ("BRISK", 9)])
def test_make_detector_maps(fam, pick):
    det_id = tfeatures.ids_for(fam, tfeatures.detector_table())[pick]
    ref = np.asarray(jfeatures.make_detector(det_id)[0](jnp.asarray(LEFT)))
    got = n(tfeatures.make_detector(det_id)[0](torch.as_tensor(LEFT)))
    assert (ref > 0).sum() > 10
    if fam == "ORB":
        assert ((ref > 0) != (got > 0)).sum() <= 4
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fam,pick", [("BRIEF", 0), ("BRIEF", 2), ("ORB", 0),
                                      ("ORB", 1), ("ORB", 2), ("FREAK", 0),
                                      ("FREAK", 3)])
def test_make_descriptor_bits(fam, pick):
    desc_id = tfeatures.ids_for(fam, tfeatures.descriptor_table())[pick]
    rs = np.random.RandomState(4)
    xy = np.stack([rs.uniform(40, 120, 60), rs.uniform(40, 80, 60)],
                  -1).astype(np.float32)
    ref = np.asarray(jfeatures.make_descriptor(desc_id)[0](
        jnp.asarray(LEFT), jnp.asarray(xy)).bits)
    got = n(tfeatures.make_descriptor(desc_id)[0](
        torch.as_tensor(LEFT), torch.as_tensor(xy)).bits)
    assert got.shape == ref.shape
    # ORB, FREAK: a rotated offset that rounds the other way flips a bit
    assert (got != ref).mean() <= (0.0 if fam == "BRIEF" else 1e-3)


@pytest.mark.parametrize("pick", [0, 1, 2, 3])
def test_make_descriptor_surf(pick):
    """The 4 SURF IDs (extended x upright): 64 or 128 float values, within
    1e-6 of the JAX package's (subregion sums and the norm in another
    order)."""
    desc_id = tfeatures.ids_for("SURF", tfeatures.descriptor_table())[pick]
    p = tfeatures.descriptor_table()[desc_id]["Param"]
    rs = np.random.RandomState(4)
    xy = np.stack([rs.uniform(30, 130, 60), rs.uniform(30, 90, 60)],
                  -1).astype(np.float32)
    ref = np.asarray(jfeatures.make_descriptor(desc_id)[0](
        jnp.asarray(LEFT), jnp.asarray(xy)).bits)
    d = tfeatures.make_descriptor(desc_id)[0](torch.as_tensor(LEFT),
                                              torch.as_tensor(xy))
    assert d.norm == "l2" and d.packed is None
    assert ref.shape == (60, 128 if p["extended"] else 64)
    np.testing.assert_allclose(n(d.bits), ref, rtol=0, atol=1e-6)


def _mixed_ids():
    dt = tfeatures.detector_table()
    fast = tfeatures.ids_for("FAST", dt)
    # threshold-major order: 6 consecutive IDs cover 3 circle types x nms
    ids = fast[18:24] + fast[120:126] + fast[300:303]
    ids += tfeatures.ids_for("ORB", dt)[::45]
    ids += tfeatures.ids_for("BRISK", dt)[::20]
    ids.insert(4, {"Name": "SIFT", "Param": {"n_octave_layers": 3}})
    ids.append(dict(dt[fast[40]]))          # settings given as a dict
    return ids


def _close(a, b, tol=1e-4):
    return abs(a[0] - b[0]) <= tol and abs(a[1] - b[1]) <= tol


def test_single_image_detection_mixed_ids():
    ids = _mixed_ids()
    got = tservices.single_image_detection(ids, LEFT, RIGHT, device="cpu")
    ref = jservices.single_image_detection(ids, LEFT, RIGHT)
    assert len(got) == len(ref) == len(ids)
    types = set()
    for det_id, g, r in zip(ids, got, ref):
        assert g["detID"] == r["detID"] == det_id          # order kept
        assert g["supported"] == r["supported"]
        if not g["supported"]:
            assert det_id["Name"] == "SIFT"
            continue
        s = det_id if isinstance(det_id, dict) else \
            tfeatures.detector_table()[det_id]
        types.add((s["Name"], s["Param"].get("d_type"),
                   s["Param"].get("non_maximum_suppression")))
        assert g["approximate"] == r["approximate"]
        assert g["processingTime"][0]["seconds"] > 0
        for side in ("leftFeatures", "rightFeatures"):
            a, b = g[side], r[side]
            if s["Name"] == "ORB":
                assert abs(a["nPoints"] - b["nPoints"]) <= \
                    0.01 * b["nPoints"] + 1
                tol = 0.5            # a flipped corner moves the means
            else:
                assert a["nPoints"] == b["nPoints"]
                tol = 1e-4
            assert _close(a["X"], b["X"], tol) and _close(a["Y"], b["Y"], tol)
    assert len({t for t in types if t[0] == "FAST"}) == 6
    assert {"ORB", "BRISK"} <= {t[0] for t in types}
    assert sum(g["leftFeatures"]["nPoints"] > 0
               for g in got if g["supported"]) > 15


def test_single_image_detection_return_kp_and_saturation():
    """`return_kp` maps reproduce each record's count; a shared ORB map
    that fills its 2048-keypoint capacity flags low thresholds
    approximate, like the JAX package."""
    dt = tfeatures.detector_table()
    ids = (tfeatures.ids_for("FAST", dt)[60:62]
           + tfeatures.ids_for("BRISK", dt)[5:6])
    got = tservices.single_image_detection(ids, LEFT, RIGHT, return_kp=True,
                                           device="cpu")
    ref = jservices.single_image_detection(ids, LEFT, RIGHT, return_kp=True)
    for i, (g, r) in enumerate(zip(got, ref)):
        for side in ("left", "right"):
            a, b = g[f"{side}_score_map"], r[f"{side}_score_map"]
            if i < 2:                      # FAST: bit-exact
                np.testing.assert_array_equal(a, b)
            else:   # BRISK: the JAX service compiles the octave blur, whose
                # fused multiply-adds round differently from its own eager
                # form (which the port equals exactly); same corners
                np.testing.assert_array_equal(a > 0, b > 0)
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
            assert int((g[f"{side}_score_map"] > 0).sum()) == \
                g[f"{side}Features"]["nPoints"]
    big_l, big_r = (image(200, 320, seed=s, block=3) for s in (5, 6))
    # one level: no two keypoints share a pixel, so a full capacity shows
    orb_ids = [{"Name": "ORB", "Param": dict(
        n_levels=1, scale_factor=1.2, edge_threshold=5, fast_threshold=thr)}
        for thr in (7, 43, 250)]
    got = tservices.single_image_detection(orb_ids, big_l, big_r,
                                           device="cpu")
    ref = jservices.single_image_detection(orb_ids, big_l, big_r)
    flags = [g["approximate"] for g in got]
    assert flags == [r["approximate"] for r in ref]
    assert flags[0] and not flags[-1]
    assert [g["leftFeatures"]["nPoints"] for g in got] == \
        [r["leftFeatures"]["nPoints"] for r in ref]
    assert any(flags) and not all(flags)


def test_keypoint_stats_and_chunked_batches():
    s = np.zeros((20, 30), np.float32)
    s[3, 4] = s[10, 20] = 1.0
    assert tservices.keypoint_stats(s) == jservices.keypoint_stats(s)
    assert tservices.keypoint_stats(np.zeros((4, 4))) == \
        jservices.keypoint_stats(np.zeros((4, 4)))
    # results do not depend on the chunk size
    from front_end_tpu_torch.ops import fast as tfast
    d, sc = tfast.fast_margins(torch.as_tensor(LEFT), "7_12")
    thrs = [float(v) for v in range(1, 40, 3)]
    nms = [bool(i % 2) for i in range(len(thrs))]
    whole = tservices._fast_stats_batch(d, sc, thrs, nms)
    saved = tservices.STATS_CHUNK_BYTES
    tservices.STATS_CHUNK_BYTES = 3 * 4 * LEFT.size
    try:
        parts = tservices._fast_stats_batch(d, sc, thrs, nms)
        maps = tservices._map_stats_batch(sc, thrs)
    finally:
        tservices.STATS_CHUNK_BYTES = saved
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    ref = jservices._map_stats_batch(jnp.asarray(n(sc)), thrs)
    for a, b in zip(maps, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("desc_fam,pick", [("BRIEF", 2), ("ORB", 0)])
def test_stereo_features_and_matching(desc_fam, pick):
    dt, ds = tfeatures.detector_table(), tfeatures.descriptor_table()
    det_id = tfeatures.ids_for("FAST", dt)[70]
    desc_id = tfeatures.ids_for(desc_fam, ds)[pick]
    left = image(120, 200, seed=8)
    right = np.roll(left, -6, axis=1)                  # 6 px disparity
    (kl, dl), (kr, dr) = tservices.get_stereo_features(
        det_id, desc_id, left, right, cell_capacity=48, device="cpu")
    (jkl, jdl), (jkr, jdr) = jservices.get_stereo_features(
        det_id, desc_id, left, right, cell_capacity=48)
    for a, b in ((kl, jkl), (kr, jkr)):
        for f in ("xy", "score", "valid"):
            np.testing.assert_array_equal(n(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    assert int(kl.valid.sum()) > 100
    flipped = (n(dl.bits) != np.asarray(jdl.bits)).mean()
    assert flipped <= (1e-3 if desc_fam == "ORB" else 0.0)
    # matching on identical inputs (the JAX features) is exact
    from front_end_tpu_torch.types import Descriptors
    from torch_parity import kps_to_torch, t
    m = tservices.stereo_matching(kps_to_torch(jkl), Descriptors(t(jdl.bits)),
                                  kps_to_torch(jkr), Descriptors(t(jdr.bits)))
    jm = jservices.stereo_matching(jkl, jdl, jkr, jdr)
    assert_matches_equal(m, jm, min_valid=30)
    if flipped == 0:
        assert_matches_equal(tservices.stereo_matching(kl, dl, kr, dr), jm,
                             min_valid=30)


def test_unsupported_descriptor_raises():
    """Every descriptor ID of the table is answered now; a family the
    factory does not know still raises."""
    dt = tfeatures.detector_table()
    with pytest.raises(ValueError, match="unsupported"):
        tservices.get_stereo_features(
            tfeatures.ids_for("FAST", dt)[0],
            {"Name": "SIFT", "Param": {}}, LEFT, RIGHT, device="cpu")


def test_control_detection_and_reset_vo():
    rig = StereoRig.create(fx=300.0, baseline=0.3, width=160, height=120)
    cfg = tvo.VOConfig(grid=tgrid.GridConfig(cell_capacity=16))
    state = tcontrol.reset_vo(rig, cfg, seed=2, device="cpu")
    assert state.frame_idx == 0 and torch.equal(state.pose, torch.eye(4))
    s2, c2, applied = tcontrol.control_detection(state, cfg, threshold=22.0,
                                                 set_point=1500)
    assert applied == 1500 and c2.grid.set_point == 1500
    assert c2.grid.init_threshold == 22.0 and cfg.grid.set_point == 1000
    assert torch.equal(s2.thresholds_l, torch.full((2, 3), 22.0))
    assert torch.equal(s2.thresholds_r, torch.full((2, 3), 22.0))
    assert s2.prev is state.prev and s2.frame_idx == 0
    # the same request through the JAX package
    from front_end_tpu.geometry.camera import StereoRig as JRig
    from front_end_tpu.ops import grid as jgrid
    from front_end_tpu.pipeline import vo as jvo
    jcfg = jvo.VOConfig(grid=jgrid.GridConfig(cell_capacity=16))
    jstate = jcontrol.reset_vo(JRig.create(fx=300.0, baseline=0.3, width=160,
                                           height=120), jcfg)
    j2, jc2, japplied = jcontrol.control_detection(
        jstate, jcfg, threshold=22.0, set_point=1500)
    assert japplied == applied
    np.testing.assert_array_equal(n(s2.thresholds_l),
                                  np.asarray(j2.thresholds_l))
    assert jc2.grid.set_point == c2.grid.set_point
    assert jc2.grid.init_threshold == c2.grid.init_threshold


def _surf_reference(det_ids, left, right):
    """The JAX package's SURF records.  Its service builds one map per
    layout with `surf.detect_dense`, whose `lax.top_k` refuses the layouts
    of 3 and 5 layers an octave (6 × 170 = 1020 candidates for 1024); for
    those the map is the JAX detection at 1020 keypoints, scattered as
    `detect_dense` scatters it, and the record the JAX statistics of that
    map."""
    from front_end_tpu.ops import surf as jsurf
    dt = tfeatures.detector_table()
    maps = {}

    def smap(img, no, nl):
        key = (id(img), no, nl)
        if key not in maps:
            k = jsurf.detect(jnp.asarray(img), hessian_threshold=1e-6,
                             n_octaves=no, n_octave_layers=nl,
                             max_keypoints=1020, subpix=False).keypoints
            m = np.zeros(img.shape, np.float32)
            np.maximum.at(m, (np.asarray(k.xy[:, 1]).astype(int),
                              np.asarray(k.xy[:, 0]).astype(int)),
                          np.where(np.asarray(k.valid), np.asarray(k.score),
                                   0.0))
            maps[key] = m
        return maps[key]

    out = []
    direct = [i for i in det_ids if dt[i]["Param"]["n_octave_layers"]
              in (2, 4)]
    recs = dict(zip(direct, jservices.single_image_detection(direct, left,
                                                             right)))
    for det_id in det_ids:
        if det_id in recs:
            out.append(recs[det_id])
            continue
        p = dt[det_id]["Param"]
        rec = {"detID": det_id, "supported": True}
        for side, img in (("leftFeatures", left), ("rightFeatures", right)):
            m = smap(img, p["n_octaves"], p["n_octave_layers"])
            rec[side] = jservices.keypoint_stats(
                np.where(m > p["hessian_threshold"], m, 0.0))
        out.append(rec)
    return out


def test_single_image_detection_surf_ids():
    """SURF IDs of all 8 layouts (2 or 4 octaves x 2-5 layers) at the
    lowest and highest thresholds: counts exact, statistics within 1e-4,
    against the JAX package."""
    dt = tfeatures.detector_table()
    ids = tfeatures.ids_for("SURF", dt)
    assert len(ids) == 432
    picks = ids[:8] + ids[-8:]
    layouts = {(dt[i]["Param"]["n_octaves"], dt[i]["Param"]["n_octave_layers"])
               for i in picks}
    assert len(layouts) == 8
    got = tservices.single_image_detection(picks, LEFT, RIGHT, device="cpu")
    ref = _surf_reference(picks, LEFT, RIGHT)
    for g, r in zip(got, ref):
        assert g["detID"] == r["detID"] and g["supported"]
        for side in ("leftFeatures", "rightFeatures"):
            a, b = g[side], r[side]
            assert a["nPoints"] == b["nPoints"], (g["detID"], side)
            assert _close(a["X"], b["X"]) and _close(a["Y"], b["Y"])
    assert sum(g["leftFeatures"]["nPoints"] > 10 for g in got) >= 8
    counts = [g["leftFeatures"]["nPoints"] for g in got]
    assert counts[:8] != counts[-8:]          # the threshold gates


def _uncapped_count(img, no, nl, t):
    """Maxima above t of a SURF detection that keeps every candidate."""
    from front_end_tpu_torch.ops import surf as tsurf
    d = tsurf.detect(torch.as_tensor(img), hessian_threshold=1e-6,
                     n_octaves=no, n_octave_layers=nl, max_keypoints=1 << 20,
                     subpix=False)
    assert float(d.cut) == 0.0
    k = d.keypoints
    m = np.zeros(img.shape, np.float32)
    np.maximum.at(m, (n(k.xy[:, 1]).astype(int), n(k.xy[:, 0]).astype(int)),
                  np.where(n(k.valid), n(k.score), 0.0))
    return int((m > t).sum())


def test_surf_sweep_flags_a_filled_capacity_approximate():
    """A SURF group's map keeps max(1024 // layers, 16) maxima a layer;
    the records at thresholds below the largest response a layer left out
    come back `approximate`, and exactly those count fewer maxima than a
    detection that keeps them all.  On the parity pair no layer of the
    2-octave, 2-layer layout fills: flags and counts equal the JAX
    package's.  On a larger pair every layer fills, in the 2-layer layout
    (cut near 450: 10 and 20 flagged, 530 and 540 not) and in a 3-layer
    one (1020 maxima, all four flagged).  Its maps hold fewer than 1024
    distinct pixels, so the JAX package's pixel-count probe would flag
    none of them."""
    dt = tfeatures.detector_table()

    def layout(no, nl):
        ids = [i for i in tfeatures.ids_for("SURF", dt)
               if dt[i]["Param"]["n_octaves"] == no
               and dt[i]["Param"]["n_octave_layers"] == nl]
        return ids[:2] + ids[-2:]

    ids = layout(2, 2)
    got = tservices.single_image_detection(ids, LEFT, RIGHT, device="cpu")
    ref = jservices.single_image_detection(ids, LEFT, RIGHT)
    assert [g["approximate"] for g in got] == \
        [r["approximate"] for r in ref] == [False] * 4
    assert [g["leftFeatures"]["nPoints"] for g in got] == \
        [r["leftFeatures"]["nPoints"] for r in ref]
    big_l, big_r = (image(300, 400, seed=s, block=3) for s in (5, 6))
    ids += layout(2, 3)
    got = tservices.single_image_detection(ids, big_l, big_r, device="cpu")
    assert [g["approximate"] for g in got] == [True, True, False, False] \
        + [True] * 4
    for det_id, g in zip(ids, got):
        p = dt[det_id]["Param"]
        cut = [g[f"{side}Features"]["nPoints"]
               < _uncapped_count(img, p["n_octaves"], p["n_octave_layers"],
                                 p["hessian_threshold"])
               for side, img in (("left", big_l), ("right", big_r))]
        assert g["approximate"] == any(cut), (det_id, cut)

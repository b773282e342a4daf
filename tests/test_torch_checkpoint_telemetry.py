"""The port's checkpoint (`utils/checkpoint.py`) and telemetry
(`pipeline/telemetry.py`).

Round trips are exact.  A resume from a checkpoint written after frame 4
reproduces the uninterrupted run on frames 5-9 bit for bit, into a
template made with another seed: the thresholds, features, pose, frame
indices and the RANSAC generator ride in the file (the final generator
states are compared too, so a checkpoint that dropped the generator
fails).  Recordings are the JAX package's `.npz` layout: each package's
`load_log` reads the other's.
"""
import numpy as np
import pytest
import torch

from front_end_tpu.geometry.camera import StereoRig as JRig
from front_end_tpu.ops import grid as jgrid
from front_end_tpu.pipeline import telemetry as jtel
from front_end_tpu.pipeline import vo as jvo
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import telemetry, vo, window_vo
from front_end_tpu_torch.utils import checkpoint
from torch_parity import image


def _rig():
    return StereoRig.create(fx=120.0, cx=79.5, cy=59.5, baseline=0.4,
                            width=160, height=120)


def _cfg(**kw):
    return vo.VOConfig(
        grid=grid.GridConfig(cell_capacity=64, set_point=120,
                             init_threshold=10.0),
        ransac_hyps=64, ransac_threshold=0.3,
        max_disparity=48.0, **{"desc_bytes": 16, **kw})


def _frames(k, seed=0):
    """`tests/test_checkpoint.py`'s sequence: a blocky texture panned 2 px
    a frame at a 6 px disparity, with noise."""
    r = np.random.RandomState(seed)
    base = np.kron(r.uniform(30, 220, (15, 20)),
                   np.ones((8, 8))).astype(np.float32)
    L, R = [], []
    for i in range(k):
        l = np.roll(base, 2 * i, axis=1)
        L.append(l + r.uniform(0, 2, l.shape).astype(np.float32))
        R.append(np.roll(l, -6, axis=1)
                 + r.uniform(0, 2, l.shape).astype(np.float32))
    return np.stack(L), np.stack(R)


def _leaves_equal(a, b):
    la, lb = dict(checkpoint._leaves(a)), dict(checkpoint._leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), k
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, k
            xv = x.view(torch.int32) if x.dtype == torch.uint32 else x
            yv = y.view(torch.int32) if y.dtype == torch.uint32 else y
            assert torch.equal(xv, yv), k
        else:
            assert x == y and type(x) is type(y), k


def _vo_state(descriptor, steps=2):
    rig, cfg = _rig(), _cfg(descriptor=descriptor)
    L, R = _frames(steps)
    s = vo.init_state(rig, cfg, seed=3, device="cpu")
    for i in range(steps):
        s, _ = vo.vo_step(s, L[i], R[i], rig, cfg)
    return rig, cfg, s


@pytest.mark.parametrize("descriptor", ["brief", "surf"])
def test_vo_state_round_trip(descriptor, tmp_path):
    rig, cfg, s = _vo_state(descriptor)
    path = str(tmp_path / "vo_state")          # no extension: .npz added
    n_leaves = checkpoint.save_state(path, s)
    assert n_leaves == len(list(checkpoint._leaves(s)))
    assert (tmp_path / "vo_state.npz").exists()
    s2 = checkpoint.load_state(path, vo.init_state(rig, cfg, seed=999,
                                                   device="cpu"))
    _leaves_equal(s, s2)
    assert s2.frame_idx == 2
    assert (s2.prev.packed is None) == (descriptor == "surf")


def test_window_state_round_trip(tmp_path):
    rig, cfg = _rig(), _cfg()
    wcfg = window_vo.WindowVOConfig.create(cfg, window=3)
    L, R = _frames(3)
    s = window_vo.init_state(rig, wcfg, seed=1, device="cpu")
    for i in range(3):
        s, _ = window_vo.window_vo_step(s, L[i], R[i], rig, wcfg)
    path = str(tmp_path / "win.npz")
    checkpoint.save_state(path, s)
    s2 = checkpoint.load_state(path, window_vo.init_state(
        rig, wcfg, seed=999, device="cpu"))
    _leaves_equal(s, s2)
    assert s2.win.frame_idx == 3 and s2.vo.frame_idx == 3


@pytest.mark.parametrize("other", ["capacity", "float_descriptor",
                                   "windowed"])
def test_config_mismatch_raises(other, tmp_path):
    """A template of another configuration is refused: another capacity
    (shapes), SURF's None packed words against BRIEF's tensor at equal
    widths (8-byte BRIEF, 64-value SURF), or another state type."""
    rig = _rig()
    brief = _cfg(desc_bytes=8) if other == "float_descriptor" else _cfg()
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, vo.init_state(rig, brief, device="cpu"))
    if other == "capacity":
        tmpl = vo.init_state(rig, vo.VOConfig(grid=grid.GridConfig(
            cell_capacity=32, set_point=120, init_threshold=10.0),
            desc_bytes=16), device="cpu")
    elif other == "float_descriptor":
        tmpl = vo.init_state(rig, _cfg(descriptor="surf"), device="cpu")
        assert tmpl.prev.bits.shape == (384, 64)
    else:
        tmpl = window_vo.init_state(
            rig, window_vo.WindowVOConfig.create(brief), device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.load_state(path, tmpl)


def test_float_checkpoint_refuses_a_binary_template(tmp_path):
    rig = _rig()
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, vo.init_state(rig, _cfg(descriptor="surf"),
                                              device="cpu"))
    with pytest.raises(ValueError, match="none.*tensor.*mismatch"):
        checkpoint.load_state(path, vo.init_state(rig, _cfg(desc_bytes=8),
                                                  device="cpu"))


@pytest.mark.parametrize("windowed", [False, True])
def test_resume_after_frame_4_is_exact(windowed, tmp_path):
    rig, cfg = _rig(), _cfg()
    L, R = _frames(10)
    if windowed:
        wcfg = window_vo.WindowVOConfig.create(cfg, window=3, ba_every=2)

        def init(seed):
            return window_vo.init_state(rig, wcfg, seed=seed, device="cpu")

        def step(s, i):
            s, o = window_vo.window_vo_step(s, L[i], R[i], rig, wcfg)
            return s, o.frame
    else:
        def init(seed):
            return vo.init_state(rig, cfg, seed=seed, device="cpu")

        def step(s, i):
            return vo.vo_step(s, L[i], R[i], rig, cfg)

    s = init(1)
    full = []
    for i in range(10):
        s, o = step(s, i)
        full.append(o)
        if i == 4:
            path = str(tmp_path / "ckpt.npz")
            checkpoint.save_state(path, s)
    assert sum(int(o.n_inliers) for o in full[5:]) > 0

    s2 = checkpoint.load_state(path, init(999))
    for i in range(5, 10):
        s2, o2 = step(s2, i)
        for f in ("pose", "motion", "n_stereo", "n_tracks", "n_inliers",
                  "track_inliers"):
            assert torch.equal(getattr(o2, f), getattr(full[i], f)), (i, f)
    _leaves_equal(s2, s)


def test_save_load_log_round_trip_and_jax_interchange(tmp_path):
    log = telemetry.TelemetryLog()
    for k in range(4):
        log.add_frame([telemetry.ProcTime("frame", 0.01 * (k + 1))]
                      + ([telemetry.ProcTime("ba", 0.5)] if k % 2 else []))
        log.count("n_stereo", 100 + k)
    meta = {"platform": "cpu", "window": True}
    path = telemetry.save_log(str(tmp_path / "rec"), log, meta)
    assert path.endswith(".npz")
    for load in (telemetry.load_log, jtel.load_log):
        stages, counters, m = load(path)
        np.testing.assert_array_equal(stages["frame"],
                                      [0.01, 0.02, 0.03, 0.04])
        np.testing.assert_array_equal(stages["ba"],
                                      [np.nan, 0.5, np.nan, 0.5])
        np.testing.assert_array_equal(counters["n_stereo"],
                                      [100, 101, 102, 103])
        assert m == meta
    # and a JAX recording through the port's reader
    jlog = jtel.TelemetryLog()
    jlog.add_frame([jtel.ProcTime("frame", 0.25)])
    jlog.count("n_inliers", 7)
    jpath = jtel.save_log(str(tmp_path / "jrec.npz"), jlog, {"p": 1})
    stages, counters, m = telemetry.load_log(jpath)
    assert stages["frame"].tolist() == [0.25]
    assert counters["n_inliers"].tolist() == [7.0] and m == {"p": 1}
    assert log.to_dict()["stage_means_s"]["ba"] == 0.5


def test_frame_clock_and_timed_record_positive_times():
    log = telemetry.TelemetryLog()
    with telemetry.FrameClock(log, device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    out, rec = telemetry.timed("mm", torch.matmul, torch.ones(8, 8),
                               torch.ones(8, 8), device="cpu")
    assert log.frames[0][0].label == "frame" and log.frames[0][0].seconds > 0
    assert rec.label == "mm" and rec.seconds > 0 and float(out[0, 0]) == 8


def test_staged_timings_labels_equal_jax():
    img = image(96, 128, seed=4)
    jrig = JRig.create(fx=100.0, width=128, height=96)
    jcfg = jvo.VOConfig(grid=jgrid.GridConfig(cell_capacity=32,
                                              set_point=120),
                        desc_bytes=16, ransac_hyps=32, min_track_inliers=4)
    jrec, _ = jtel.staged_timings(jvo.init_state(jrig, jcfg), img, img,
                                  jrig, jcfg)
    rig = StereoRig.create(fx=100.0, width=128, height=96)
    cfg = vo.VOConfig(grid=grid.GridConfig(cell_capacity=32, set_point=120),
                      desc_bytes=16, ransac_hyps=32, min_track_inliers=4)
    rec, out = telemetry.staged_timings(
        vo.init_state(rig, cfg, device="cpu"), img, img, rig, cfg)
    assert [r.label for r in rec] == [r.label for r in jrec] == [
        "Detection", "Description+Stereo", "KNN_Match", "MotionExtraction"]
    assert all(r.seconds > 0 for r in rec)
    assert out["motion"].shape == (4, 4)

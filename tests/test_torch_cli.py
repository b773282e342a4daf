"""The port's command line (`python -m front_end_tpu_torch.cli`), driven
in-process with `--device cpu` on fixture datasets written under a
temporary directory.

`vo --kitti` gives the trajectory of `vo.run_sequence` on the same frames
in memory exactly (the files hold the frames' integer values); a resume
after frame 4 gives the uninterrupted run's trajectory exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from front_end_tpu import features as jfeatures
from front_end_tpu.pipeline import telemetry as jtelemetry
from front_end_tpu_torch import cli, services
from front_end_tpu_torch.geometry.camera import StereoRig
from front_end_tpu_torch.ops import grid
from front_end_tpu_torch.pipeline import telemetry, vo
from front_end_tpu_torch.sim.sequence import make_sequence
from front_end_tpu_torch.utils import png
from torch_parity import pan_poses, write_euroc, write_kitti

H, W, T = 96, 160, 8
FX, BASELINE = 200.0, 0.3


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    L, R = make_sequence(T, H, W)
    write_kitti(root, L, R, fx=FX, baseline=BASELINE,
                poses=pan_poses(T, BASELINE))
    return root, L, R


@pytest.fixture(scope="module")
def full_run(kitti_root, tmp_path_factory):
    """One `vo` run with every output: trajectory, recording, state, debug
    images."""
    root, _, _ = kitti_root
    out = tmp_path_factory.mktemp("run")
    paths = {k: str(out / k) for k in ("traj.txt", "rec", "state", "dbg")}
    cli.main(["vo", "--kitti", root, "--frames", str(T), "--device", "cpu",
              "--out", paths["traj.txt"], "--record", paths["rec"],
              "--save-state", paths["state"], "--debug-images",
              paths["dbg"], "--debug-every", "4"])
    return paths


def _run_sequence(L, R):
    rig = StereoRig.create(fx=FX, cx=(W - 1) / 2, cy=(H - 1) / 2,
                           baseline=BASELINE, width=W, height=H)
    cfg = vo.VOConfig(
        grid=grid.GridConfig(cell_capacity=384, set_point=2000,
                             init_threshold=15.0),
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0)
    _, outs = vo.run_sequence(vo.init_state(rig, cfg, device="cpu"), L, R,
                              rig, cfg)
    return outs.pose.numpy()


def test_gen_table_equals_jax(tmp_path, capsys):
    ours, theirs = str(tmp_path / "t.yaml"), str(tmp_path / "j.yaml")
    cli.main(["gen-table", "--out", ours])
    assert "wrote 1225 entries" in capsys.readouterr().out
    jfeatures.export_table_yaml(theirs)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()


def test_vo_kitti_equals_run_sequence(kitti_root, full_run):
    _, L, R = kitti_root
    traj = np.loadtxt(full_run["traj.txt"])
    assert traj.shape == (T, 12)                 # KITTI's 12 columns
    poses = _run_sequence(L, R)
    np.testing.assert_array_equal(traj, poses[:, :3, :].reshape(T, 12))
    t_true = pan_poses(T, BASELINE)[-1, 0, 3]
    assert abs(traj[-1, 3] - t_true) < 0.05 * t_true


def test_vo_record_is_readable(full_run):
    stages, counters, meta = telemetry.load_log(full_run["rec"])
    assert stages["frame"].shape == (T,) and (stages["frame"] > 0).all()
    assert set(counters) == {"n_detect_l", "n_stereo", "n_tracks",
                             "n_inliers", "lm.accepted"}
    assert (counters["n_stereo"] > 50).all()
    assert meta == {"descriptor": "brief", "window": False,
                    "platform": "cpu", "resolution": f"{H}x{W}"}


SPANS = ("feed.wait", "feed.source", "feed.put", "io.decode", "vo.step",
         "vo.extract", "vo.motion", "vo.ransac", "vo.lm")


def test_vo_record_keeps_the_programs_spans_and_counters(full_run):
    """`--record` adds each span's host seconds a frame as `stage_<span>`
    and the program's counters as `counter_<name>`; `report`'s reader and
    the JAX package's read them."""
    for load in (telemetry.load_log, jtelemetry.load_log):
        stages, counters, _ = load(full_run["rec"])
        assert set(stages) == {"frame", *SPANS}
        for name in SPANS:
            assert stages[name].shape == (T,) and (stages[name] > 0).all()
        assert (stages["vo.lm"] < stages["vo.motion"]).all()
        assert (stages["vo.motion"] < stages["vo.step"]).all()
        lm = counters["lm.accepted"]
        assert lm.shape == (T,) and ((lm >= 0) & (lm <= 6)).all()
        assert lm[1:].sum() > 0


def test_vo_record_after_a_resume_keeps_its_frames(kitti_root, tmp_path):
    """A resumed run's recording holds its own frames: the step's spans
    (frame ids from the checkpoint on) and the feed's (numbered from the
    first frame it reads) share each row."""
    root, _, _ = kitti_root
    ck, rec = str(tmp_path / "ck"), str(tmp_path / "rec")
    cli.main(["vo", "--kitti", root, "--frames", "3", "--device", "cpu",
              "--save-state", ck])
    cli.main(["vo", "--kitti", root, "--frames", "5", "--device", "cpu",
              "--resume", ck, "--record", rec])
    stages, counters, _ = telemetry.load_log(rec)
    for name in ("frame", *SPANS):
        assert stages[name].shape == (2,), name
        assert np.isfinite(stages[name]).all(), name
    assert counters["lm.accepted"].shape == (2,)


def test_vo_debug_images(full_run):
    files = sorted(os.listdir(full_run["dbg"]))
    assert files == ["match_00000.png", "match_00004.png",
                     "tracks_00000.png", "tracks_00004.png"]
    m = png.read(os.path.join(full_run["dbg"], "match_00004.png"))
    tr = png.read(os.path.join(full_run["dbg"], "tracks_00004.png"))
    assert m.shape == (H, 2 * W) and tr.shape == (H, W)
    from PIL import Image
    rgb = np.asarray(Image.open(os.path.join(full_run["dbg"],
                                             "tracks_00004.png")))
    green = (rgb[..., 1] == 255) & (rgb[..., 0] == 0) & (rgb[..., 2] == 0)
    assert green.sum() > 20                      # inlier tracks drawn


def test_vo_resume_equals_the_uninterrupted_run(kitti_root, full_run,
                                                tmp_path):
    root, _, _ = kitti_root
    ck, traj = str(tmp_path / "ck"), str(tmp_path / "traj.txt")
    cli.main(["vo", "--kitti", root, "--frames", "4", "--device", "cpu",
              "--save-state", ck])
    assert os.path.exists(ck + ".npz") and os.path.exists(ck + ".traj.npy")
    cli.main(["vo", "--kitti", root, "--frames", str(T), "--device", "cpu",
              "--resume", ck, "--out", traj])
    np.testing.assert_array_equal(np.loadtxt(traj),
                                  np.loadtxt(full_run["traj.txt"]))


def test_vo_resume_refuses_another_descriptor(kitti_root, full_run):
    root, _, _ = kitti_root
    with pytest.raises(SystemExit, match="resume config mismatch"):
        cli.main(["vo", "--kitti", root, "--device", "cpu", "--descriptor",
                  "orb", "--resume", full_run["state"]])


def test_vo_window_runs(kitti_root, tmp_path, capsys):
    root, _, _ = kitti_root
    rec, traj = str(tmp_path / "wrec"), str(tmp_path / "w.txt")
    cli.main(["vo", "--kitti", root, "--frames", "5", "--device", "cpu",
              "--window", "--max-age", "2", "--record", rec, "--out", traj])
    assert "(windowed BA mode)" in capsys.readouterr().out
    stages, counters, meta = telemetry.load_log(rec)
    assert meta["window"] is True and (counters["n_tracked"][1:] > 50).all()
    assert {"window.step", "window.tracker", "window.ba"} <= set(stages)
    # W = 3: the BA runs from the third frame on
    assert np.isnan(stages["window.ba"][:2]).all()
    assert np.isfinite(stages["window.ba"][2:]).all()
    assert (counters["ba.landmarks"][2:] > 0).all()
    assert ((counters["ba.accepted"] >= 0)
            & (counters["ba.accepted"] <= 6)).all()
    poses = np.loadtxt(traj)
    assert poses.shape == (5, 12) and np.isfinite(poses).all()
    t_true = pan_poses(5, BASELINE)[-1, 0, 3]
    assert abs(poses[-1, 3] - t_true) < 0.05 * t_true


@pytest.mark.parametrize("flags,every,iters,ran", [
    ([], 1, 6, [0, 0, 1, 1]),
    (["--ba-every", "2", "--ba-iters", "2"], 2, 2, [0, 0, 0, 1])],
    ids=["default", "production"])
def test_vo_window_ba_flags_reach_the_config(kitti_root, tmp_path,
                                             monkeypatch, flags, every,
                                             iters, ran):
    """`--ba-every` and `--ba-iters` reach `WindowVOConfig`; without them
    the BA solves 6 iterations on every frame from the third."""
    from front_end_tpu_torch.pipeline import window_vo
    root, _, _ = kitti_root
    seen = []
    step = window_vo.window_vo_step

    def spy(state, left, right, rig, cfg, *a):
        seen.append(cfg)
        return step(state, left, right, rig, cfg, *a)

    monkeypatch.setattr(window_vo, "window_vo_step", spy)
    rec = str(tmp_path / "rec")
    cli.main(["vo", "--kitti", root, "--frames", "4", "--device", "cpu",
              "--window", "--record", rec, *flags])
    assert len(seen) == 4
    assert {(c.ba_every, c.ba_iters, c.tracker.window) for c in seen} == {
        (every, iters, 3)}
    _, counters, _ = telemetry.load_log(rec)
    assert counters["window.ba_ran"].tolist() == ran
    accepted = counters["ba.accepted"]
    assert ((accepted >= 0) & (accepted <= iters)).all()


def test_vo_euroc_rectified(tmp_path):
    root = str(tmp_path / "euroc")
    write_euroc(root, 3)
    rec = str(tmp_path / "erec")
    cli.main(["vo", "--euroc", root, "--seq", "V9_99_synth", "--device",
              "cpu", "--record", rec])
    _, counters, meta = telemetry.load_log(rec)
    assert meta["resolution"] == "192x256"
    assert (counters["n_stereo"] > 50).all(), counters["n_stereo"]


def test_ransac_smoke_recovers_the_motion(capsys):
    cli.main(["ransac-smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()

    def nums(line):
        return np.array([float(x) for x in line.replace("[", " ").replace(
            "]", " ").split("=")[1].split("t")[0].split()]
            + [float(x) for x in line.split("t=")[1].strip(" []").split()])

    ideal, rec = nums(lines[0]), nums(lines[1])
    np.testing.assert_allclose(rec[:3], ideal[:3], atol=0.05)   # degrees
    np.testing.assert_allclose(rec[3:], ideal[3:], atol=1e-3)   # metres
    assert int(lines[2].split(":")[1]) >= 190


@pytest.mark.parametrize("family,count", [("FAST", 6), ("ORB", 3)])
def test_detect_sweep_equals_the_service(family, count, kitti_root, capsys):
    root, L, _ = kitti_root
    path = os.path.join(root, "sequences", "00", "image_0", "000000.png")
    cli.main(["detect-sweep", "--family", family, "--n", str(count),
              "--image", path, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    from front_end_tpu_torch import features
    ids = [k for k, v in features.detector_table().items()
           if v["Name"] == family][:count]
    recs = services.single_image_detection(ids, L[0], L[0], device="cpu")
    want = [f"{r['detID']}: L={r['leftFeatures']['nPoints']} "
            f"R={r['rightFeatures']['nPoints']}" for r in recs]
    assert [ln.rsplit(" t=", 1)[0] for ln in lines] == want


def test_entry_points_default_to_the_card(kitti_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    root, _, _ = kitti_root
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli.main(["vo", "--kitti", root, "--frames", "1"])


def test_extract_motion_writes_the_study(tmp_path, capsys):
    out = str(tmp_path / "study")
    argv = ["extract-motion", "--out", out, "--methods", "PCL,Nister,BA",
            "--speeds", "medium", "--curves", "100", "--batch", "4",
            "--ideal", "--device", "cpu"]
    cli.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "ran": 3, "skipped": 0}
    assert sorted(os.listdir(out)) == [
        f"{m}_medium_00100_n0_o0.npz" for m in ("BA", "Nister", "PCL")]
    with np.load(os.path.join(out, "PCL_medium_00100_n0_o0.npz")) as z:
        assert sorted(z.files) == ["n_inliers", "rot_err_deg",
                                   "trans_err_m"]
        assert z["rot_err_deg"].shape == (4,)
        assert (z["trans_err_m"] < 1e-4).all()
    cli.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "ran": 0, "skipped": 3}


@pytest.fixture
def spawn_timeout(monkeypatch):
    """The CLI's rank spawns, each given a timeout of its own."""
    import functools

    from front_end_tpu_torch.ba import distributed
    monkeypatch.setattr(distributed, "launch", functools.partial(
        distributed.launch, timeout=240.0))


def test_ba_scaling_reports_each_size(capfd, spawn_timeout):
    """Rank 0 prints a line per size and the JAX command's JSON keys (from
    its own process: read at the file descriptor)."""
    cli.main(["ba-scaling", "--landmarks", "512", "--iters", "4",
              "--repeats", "1", "--ranks", "2", "--device", "cpu"])
    out = capfd.readouterr().out.splitlines()
    assert out[0].startswith("ba-scaling over 2 rank(s): backend gloo")
    assert [ln.split(":")[0] for ln in out if ln.startswith("n=")] == [
        "n=1", "n=2"]
    rep = json.loads(out[-1])
    assert rep["n_devices"] == 2 and rep["virtual_mesh"] is True
    assert rep["landmarks"] == 512 and rep["window"] == 3
    for k in ("wall_ms", "cpu_ms", "efficiency"):
        assert rep[k].keys() == {"1", "2"} and all(
            v > 0 for v in rep[k].values())
    assert rep["efficiency"]["1"] == 1.0


@pytest.mark.parametrize("ranks,landmarks", [(2, 33), (6, 30), (7, 21)])
def test_ba_scaling_splits_one_problem_at_every_size(ranks, landmarks):
    """The landmarks are padded so that every group size measured splits
    all of them: no size solves a smaller problem."""
    import argparse

    from front_end_tpu_torch.ba import distributed
    args = argparse.Namespace(landmarks=landmarks, window=3, noise_px=0.5,
                              seed=0)
    _, _, *problem = cli._ba_scaling_problem(args, ranks)
    for s in cli._scaling_sizes(ranks):
        for a in problem:
            assert torch.equal(torch.cat([distributed.local_block(a, r, s)
                                          for r in range(s)]), a)
    with pytest.raises(ValueError, match="equal blocks"):
        distributed.local_block(torch.zeros(7, 3), 0, 2)


def test_ba_scaling_multihost_joins_torchruns_rendezvous(tmp_path):
    """`--multihost`: the process is one rank of a `torchrun` launch and
    reads the rendezvous from its environment (here a launch of one rank
    on this host, in a process of its own)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-m", "front_end_tpu_torch.cli", "ba-scaling",
         "--multihost", "--landmarks", "256", "--iters", "2", "--repeats",
         "1", "--device", "cpu"], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["n_hosts"] == 1 and rep["n_devices"] == 1
    assert rep["virtual_mesh"] is True and rep["wall_ms"].keys() == {"1"}


def test_vo_window_shard_ba_follows_the_unsharded_run(kitti_root, tmp_path,
                                                      capsys, spawn_timeout):
    """`--shard-ba 2`: two ranks step the frames, the windowed BA sharded
    over them; rank 0 writes the trajectory and the recording.  Positions
    within 2e-3 m of the unsharded run (the bound of the JAX package's
    sharded windowed test)."""
    root, _, _ = kitti_root
    one, two = str(tmp_path / "one.txt"), str(tmp_path / "two.txt")
    rec = str(tmp_path / "rec")
    common = ["vo", "--kitti", root, "--frames", "5", "--device", "cpu",
              "--window"]
    cli.main(common + ["--out", one])
    cli.main(common + ["--shard-ba", "2", "--out", two, "--record", rec])
    assert "sharded over 2 rank(s)" in capsys.readouterr().out
    a, b = np.loadtxt(one), np.loadtxt(two)
    assert b.shape == (5, 12)
    np.testing.assert_allclose(b[:, 3::4], a[:, 3::4], atol=2e-3)
    _, counters, meta = telemetry.load_log(rec)
    assert meta["window"] is True and len(counters["ba_rms_px"]) == 5
    assert not os.path.exists(rec + ".1.npz")


def test_explore_cli_writes_the_index(kitti_root, tmp_path):
    root, _, _ = kitti_root
    image = os.path.join(root, "sequences", "00", "image_0", "000000.png")
    out = tmp_path / "explore"
    cli.main(["explore", "--family", "FAST", "--image", image, "--top", "2",
              "--out", str(out), "--device", "cpu"])
    rows = [ln for ln in (out / "INDEX.md").read_text().splitlines()
            if ln.startswith("| ") and ln.split("|")[1].strip().isdigit()]
    assert len(rows) == 354
    assert (out / "summary_FAST.svg").exists()
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 2


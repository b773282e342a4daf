"""The port's benchmark (`front_end_tpu_torch/bench.py`, `cli bench`) on
the CPU at a cut depth: the configurations and frames equal the JAX
benchmark's, the printed line has the JAX line's keys (plus
`feed_source`), and without a card the command fails and prints no
line."""
import argparse
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench as jbench
from front_end_tpu.ops import grid as jgrid
from front_end_tpu.pipeline import vo as jvo
from front_end_tpu.pipeline import window_vo as jwindow_vo
from front_end_tpu_torch import bench, cli, interop
from front_end_tpu_torch.io import native_feed
from front_end_tpu_torch.sim.sequence import make_sequence
from torch_parity import run_main

ROOT = Path(__file__).resolve().parents[1]
# a cut depth: every part of the benchmark runs, on 2 small frames
CUT = ["--frames", "2", "--passes", "1", "--stage-calls", "1",
       "--rendered-frames", "4", "--size", "64x96"]


def _jax_configs() -> dict:
    """The JAX benchmark's configurations, built as `bench.py:128-132, 184,
    201, 308-312, 324-325, 336-337` build them."""
    cfg = jvo.VOConfig(
        grid=jgrid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=384,
                              set_point=2000, init_threshold=15.0),
        desc_bytes=32, ransac_hyps=256, ransac_threshold=0.5,
        max_disparity=192.0, min_track_inliers=12)
    rcfg = jvo.VOConfig(
        grid=jgrid.GridConfig(grid_rows=2, grid_cols=3, cell_capacity=128,
                              set_point=700, init_threshold=12.0),
        desc_bytes=32, ransac_hyps=192, ransac_threshold=0.12,
        max_disparity=60.0, min_track_inliers=10)
    return {"vo": cfg, "brief16": cfg.replace(desc_bytes=16),
            "subpix": cfg.replace(subpix=True),
            "windowed": jwindow_vo.WindowVOConfig.create(
                cfg, window=3, ba_every=2, ba_iters=2),
            "rendered": rcfg,
            "rendered_windowed": jwindow_vo.WindowVOConfig.create(
                rcfg, window=3, ba_every=2, ba_iters=2)}


def _parse(argv):
    p = argparse.ArgumentParser()
    bench.add_arguments(p)
    return p.parse_args(argv)


def _key_paths(d: dict, prefix="") -> set:
    keys = set()
    for k, v in d.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= _key_paths(v, prefix + k + ".")
    return keys


def _ast_key_paths(node: ast.Dict, prefix="") -> set:
    keys = set()
    for k, v in zip(node.keys, node.values):
        keys.add(prefix + k.value)
        if isinstance(v, ast.Dict):
            keys |= _ast_key_paths(v, prefix + k.value + ".")
    return keys


@pytest.fixture(scope="module")
def line():
    """`cli bench --device cpu` at the cut depth -> (stdout, last line)."""
    text = run_main(cli.main, ["bench", "--device", "cpu", *CUT])
    return text, json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(_jax_configs()))
def test_configurations_equal_jax(name):
    j = _jax_configs()[name]
    if "windowed" in name:
        want = interop.window_from_jax(dataclasses.asdict(j))[0]
    else:
        want = interop.from_jax(cfg=dataclasses.asdict(j))[1]
    assert bench.configs()[name] == want


def test_frames_equal_jax_bench():
    args = _parse([])
    assert (args.frames, args.passes, args.stage_calls,
            args.rendered_frames, args.size) == (40, 5, 50, 40, "376x1241")
    L, R = make_sequence(args.frames, *bench.parse_size(args.size),
                         seed=args.seed)
    JL, JR = jbench.make_sequence(40)
    np.testing.assert_array_equal(L, JL)
    np.testing.assert_array_equal(R, JR)


def test_line_keys_equal_jax(line):
    tree = ast.parse((ROOT / "bench.py").read_text())
    result = next(node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Assign)
                  and [getattr(t_, "id", None) for t_ in node.targets]
                  == ["result"] and isinstance(node.value, ast.Dict))
    want = _ast_key_paths(result) | {"detail.feed_source"}
    assert _key_paths(line[1]) == want


def test_line_values(line):
    text, res = line
    d = res["detail"]
    assert res["metric"] == "kitti_stereo_vo_frames_per_s_per_chip"
    assert res["unit"] == "frames/s" and res["value"] > 0
    assert res["vs_baseline"] == round(res["value"] / 200, 3)
    assert d["device"].startswith("cpu")
    assert d["resolution"] == "64x96" and d["n_frames"] == 2
    assert d["keypoint_capacity"] == 2304
    assert d["h2d_link_mb_per_s"] is None       # no link on the CPU
    assert d["feed_source"] == ("native" if native_feed.available()
                                else "python")
    for k in ("fps_feed_inclusive", "fps_subpix_on", "fps_brief16",
              "fps_device_scan", "fps_windowed"):
        assert d[k] > 0, k
    for k in ("ate_rendered_world_m", "ate_rendered_world_windowed_m"):
        assert np.isfinite(d[k]) and d[k] < 1.0, k
    assert "1 calls each" in d["stage_ms"]["note"]
    assert text.strip().splitlines()[-2].startswith("bench: 2 frames")


def test_bench_without_a_card_fails_and_prints_no_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "front_end_tpu_torch.cli",
                          "bench", *CUT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA was requested" in out.stderr
    assert "{" not in out.stdout


@pytest.mark.parametrize("source", ["native", "python"])
def test_feed_source(source, monkeypatch):
    """Both decode routes hand the step the PGM files' frames, in order."""
    if source == "native" and not native_feed.available():
        pytest.skip("the native feed needs g++ and libpng")
    if source == "python":
        monkeypatch.setattr(native_feed, "available", lambda: False)
    L, R = make_sequence(3, 24, 40)
    rig = bench.bench_rig(24, 40)
    seen = []

    def step(state, left, right):
        seen.append((left.numpy(), right.numpy()))
        return state, None

    fps, got = bench.feed_inclusive(step, None, L, R, rig,
                                    bench.resolve_device("cpu"), runs=1)
    assert got == source and fps > 0
    assert len(seen) == 2 * len(L)               # the warm run and one more
    for (a, b), l, r in zip(seen, np.concatenate([L, L]),
                            np.concatenate([R, R])):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, l)
        np.testing.assert_array_equal(b, r)

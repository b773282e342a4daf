"""Extraction (`pipeline/vo.py::_extract_frame`, stages 1-5) through its
CUDA-graph replay helper (`pipeline/cuda_graphs.py`).

On the CPU: every descriptor's static key `(rig, cfg)` hashes; CPU
tensors run the eager body `_extract_body` and count no `extract.graph`;
the body equals the frozen plain reference (`vobench/reference/vo.py`)
bit for bit; the kernel modules the replay counts launches for are all of
`ops/kernels`.

On the card (marked `cuda`; skipped without a device; no conftest needed:
`python -m pytest tests/test_torch_extract_graph.py -q --noconftest`):
for every descriptor, sub-pixel refinement off and on, consecutive frames
with their thresholds carried replay one graph and equal the eager body
by `torch.equal`; `extract.graph` counts 1 a call; the kernel counters
advance by what the body launches, the capturing call's too; the match
kernel's programmatic dependent launch is captured.
"""
import json
from collections import OrderedDict
from pathlib import Path

import pytest
import torch

from front_end_tpu_torch.ops import kernels
from front_end_tpu_torch.ops.kernels import (brief_keypoints, fast_grid,
                                             match_reduce)
from front_end_tpu_torch.pipeline import telemetry, vo
from front_end_tpu_torch.sim.sequence import make_sequence
from vobench.program import make_rig, vo_config

CONFIGS = Path(__file__).resolve().parents[1] / "vobench" / "configs"
SUBPIX = [False, True]


def _bench(config):
    """(rig, VOConfig) of a benchmark configuration."""
    spec = json.loads((CONFIGS / f"{config}.json").read_text())
    return make_rig(spec["rig"]), vo_config(spec["vo"])


def _cell(descriptor):
    """The cell whose frame size a descriptor is held at: euroc's 752 x
    480 for the float (SURF) descriptors, kitti's 1241 x 376 else."""
    l2 = vo.DESCRIPTORS[descriptor]["norm"] == "l2"
    return "euroc-mh01-window-surfext" if l2 else "kitti00-vo-brief"


def _leaves(res):
    """(features, tl, tr, stats) -> its tensors, by name."""
    feats, tl, tr, stats = res
    out = {f"kps.{k}": getattr(feats.kps, k)
           for k in ("xy", "score", "angle", "valid")}
    out.update({k: getattr(feats, k) for k in
                ("bits", "packed", "X", "stereo_valid", "uv4")})
    return dict(out, tl=tl, tr=tr, **stats)


def _equal(got, ref):
    a, b = _leaves(got), _leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _same_as_body(got, body):
    """The entry point's tensors are the body's dict, by `torch.equal`."""
    leaves = {k.removeprefix("kps."): v for k, v in _leaves(got).items()}
    assert {k for k, v in leaves.items() if v is not None} == set(body)
    for k, v in body.items():
        assert leaves[k].dtype == v.dtype and torch.equal(leaves[k], v), k


@pytest.fixture
def no_recording():
    assert telemetry._active is None
    yield
    assert telemetry._active is None, "a test left a recording open"


@pytest.fixture
def fresh_graphs(monkeypatch):
    graphs = OrderedDict()
    monkeypatch.setattr(vo._extract_graphs, "graphs", graphs)
    return graphs


# ---- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("subpix", SUBPIX, ids=["pixel", "subpix"])
@pytest.mark.parametrize("descriptor", list(vo.DESCRIPTORS))
def test_static_key_hashes_for_every_descriptor(descriptor, subpix):
    """The graph key's static part, `(rig, cfg)`, hashes, equal settings
    give one key and the sub-pixel setting another."""
    rig, cfg = _bench(_cell(descriptor))
    cfg = cfg.replace(descriptor=descriptor, subpix=subpix)
    key = (rig, cfg)
    again = (make_rig(json.loads((CONFIGS / f"{_cell(descriptor)}.json")
                                 .read_text())["rig"]),
             vo.VOConfig(**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__}))
    assert hash(key) == hash(again) and key == again
    assert {key: 1}[again] == 1
    other = (rig, cfg.replace(subpix=not subpix))
    assert other != key


def _small(descriptor, subpix):
    """A 128 x 192 rig and a configuration of 3 x 64 keypoints a cell."""
    from front_end_tpu_torch.geometry.camera import StereoRig
    from front_end_tpu_torch.ops.grid import GridConfig
    rig = StereoRig.create(fx=200.0, baseline=0.3, width=192, height=128)
    cfg = vo.VOConfig(grid=GridConfig(cell_capacity=64, set_point=300,
                                      init_threshold=12.0),
                      descriptor=descriptor, subpix=subpix,
                      max_disparity=64.0)
    lefts, rights = make_sequence(3, 128, 192)
    return rig, cfg, torch.as_tensor(lefts), torch.as_tensor(rights)


@pytest.mark.parametrize("subpix", SUBPIX, ids=["pixel", "subpix"])
@pytest.mark.parametrize("descriptor", list(vo.DESCRIPTORS))
def test_cpu_calls_run_the_body_eagerly(descriptor, subpix, monkeypatch,
                                        fresh_graphs, no_recording):
    """CPU tensors never reach the replay and count no `extract.graph`;
    the entry point hands back the eager body's tensors, `packed` None
    for the float descriptors, over frames with the thresholds carried."""
    rig, cfg, L, R = _small(descriptor, subpix)

    def refuse(*a):
        raise AssertionError("no graph serves CPU tensors")

    monkeypatch.setattr(vo._extract_graphs, "_replay", refuse)
    tl = tr = cfg.grid.init_thresholds()
    with telemetry.recording() as rec:
        for k in range(2):
            got = vo._extract_frame(L[k], R[k], tl, tr, rig, cfg)
            _same_as_body(got, vo._extract_body(L[k], R[k], tl, tr, rig,
                                                cfg))
            feats, tl, tr, _ = got
            assert (feats.packed is None) == (cfg.desc_norm == "l2")
            assert int(feats.stereo_valid.sum()) > 0
    assert not fresh_graphs
    assert "extract.graph" not in rec.counters()


@pytest.mark.parametrize("descriptor", ["brief", "surf", "surf_ext"])
def test_extract_body_equals_the_frozen_reference(descriptor):
    """The eager body is extraction as it stood: the plain reference gives
    the same bits on the CPU over 3 frames, thresholds carried."""
    from vobench.reference import grid as ref_grid
    from vobench.reference import vo as ref_vo
    from vobench.reference.camera import StereoRig as RefRig
    rig, cfg, L, R = _small(descriptor, False)
    ref_rig = RefRig(**{f: getattr(rig, f) for f in
                        ("fx", "fy", "cx", "cy", "baseline", "width",
                         "height")})
    ref_cfg = ref_vo.VOConfig(
        grid=ref_grid.GridConfig(cell_capacity=64, set_point=300,
                                 init_threshold=12.0),
        descriptor=descriptor, max_disparity=64.0)
    tl = tr = cfg.grid.init_thresholds()
    for k in range(3):
        got = vo._extract_frame(L[k], R[k], tl, tr, rig, cfg)
        ref = ref_vo.f32_precision(ref_vo._extract_frame)(
            L[k], R[k], tl, tr, ref_rig, ref_cfg)
        _equal(got, ref)
        tl, tr = got[1], got[2]


def test_kernel_modules_name_every_kernel():
    """The launch counters a replay adds to are every kernel module's."""
    pkg = Path(kernels.__file__).parent
    assert set(kernels.NAMES) == {p.stem for p in pkg.glob("*.py")
                                  if not p.stem.startswith("_")}
    assert [m.__name__.rsplit(".", 1)[1] for m in kernels.modules()] == \
        list(kernels.NAMES)
    assert all(isinstance(m.launches, int) for m in kernels.modules())


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _card_frames(config, n, dev):
    rig, _ = _bench(config)
    lefts, rights = make_sequence(n, rig.height, rig.width)
    return (torch.as_tensor(lefts).to(dev), torch.as_tensor(rights).to(dev))


def _launched():
    return (fast_grid.launches, brief_keypoints.launches,
            match_reduce.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("subpix", SUBPIX, ids=["pixel", "subpix"])
@pytest.mark.parametrize("descriptor", list(vo.DESCRIPTORS))
def test_extract_graph_replays_equal_the_eager_body(dev, descriptor, subpix,
                                                    fresh_graphs,
                                                    no_recording):
    """4 consecutive frames, thresholds carried, replay one graph; each
    replay's features, thresholds and counts equal `_extract_body` run
    eagerly on the same inputs by `torch.equal`; what a call returned
    stays as it was after later replays; `extract.graph` counts 1 a
    call."""
    config = _cell(descriptor)
    rig, cfg = _bench(config)
    cfg = cfg.replace(descriptor=descriptor, subpix=subpix)
    L, R = _card_frames(config, 4, dev)
    tl = tr = cfg.grid.init_thresholds(dev)
    kept = []
    with telemetry.recording() as rec:
        for k in range(4):
            got = vo._extract_frame(L[k], R[k], tl, tr, rig, cfg)
            _same_as_body(got, vo._extract_body(L[k], R[k], tl, tr, rig,
                                                cfg))
            assert int(got[3]["n_stereo"]) > 100
            kept.append((got, {k2: None if v is None else v.clone()
                               for k2, v in _leaves(got).items()}))
            tl, tr = got[1], got[2]
    assert len(fresh_graphs) == 1
    for got, copy in kept:
        for k2, v in _leaves(got).items():
            assert (v is None) == (copy[k2] is None)
            assert v is None or torch.equal(v, copy[k2]), k2
    assert [v for _, v in rec.counters()["extract.graph"]] == [1.0] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("descriptor", ["brief", "surf_ext"])
def test_extract_graph_counts_the_launches_it_replays(dev, descriptor,
                                                      fresh_graphs):
    """Each call, the first (which captures) too, advances the kernel
    counters by what the body launches: 1 grid, 1 keypoint BRIEF and 1
    match launch a BRIEF frame; 1 grid launch a SURF frame."""
    config = _cell(descriptor)
    rig, cfg = _bench(config)
    cfg = cfg.replace(descriptor=descriptor)
    L, R = _card_frames(config, 3, dev)
    tl = tr = cfg.grid.init_thresholds(dev)
    want = (1, 1, 1) if descriptor == "brief" else (1, 0, 0)
    for k in range(3):
        before = _launched()
        _, tl, tr, _ = vo._extract_frame(L[k], R[k], tl, tr, rig, cfg)
        assert tuple(a - b for a, b in zip(_launched(), before)) == want
    assert len(fresh_graphs) == 1


@pytest.mark.cuda
def test_match_reduce_is_captured_with_its_dependent_launch(dev):
    """The match kernel and its programmatically dependent `finalize`,
    captured in a CUDA graph, give the eager launch's five outputs."""
    g = torch.Generator().manual_seed(3)
    n = 2304
    words = [torch.randint(-2**31, 2**31, (n, 8), generator=g,
                           dtype=torch.int64).to(torch.int32)
             .view(torch.uint32).to(dev) for _ in range(2)]
    xy = [(torch.rand(n, 2, generator=g) * torch.tensor([1241.0, 376.0]))
          .to(dev) for _ in range(2)]
    valid = (torch.rand(n, generator=g) < 0.9).to(dev)
    args = (*words, *xy, valid, valid)
    kw = dict(mode="epi", p1=40.0)
    ref = match_reduce.match_reduce(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = match_reduce.match_reduce(*args, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref))

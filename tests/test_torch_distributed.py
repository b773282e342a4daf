"""The landmark-sharded BA over `torch.distributed` (`ba/distributed.py`)
and the live sharded windowed BA, against the port's single-process BA
and the JAX package's `ba_solve_sharded` on its 8-device virtual mesh.

Ranks run as spawned processes (`ba.distributed.launch`: gloo on the CPU,
one torch thread each, a `file://` store under the test's directory, a
timeout per spawn); their functions live in `tests/_torch_dist_worker.py`,
which imports no JAX.  Two spawns: 2 ranks (the solve and the windowed
pipeline) and 4 ranks (the solve and the mesh checks).

Tolerances (those of `tests/test_ba.py` and `tests/test_sharded_window.py`
for the JAX package's sharded paths): cost within rtol 1e-3 and poses
within 1e-4 of the single-process solve; positions within 2e-3 m and BA
rms within 5e-2 px of the unsharded windowed run.  The ranks' replicated
poses are equal bit for bit.  Landmarks within 4e-3 m of the single
solve: the far ones (up to 16 m deep) move with the order of the sums,
and the JAX package's own single and 8-way sharded solves of this window
put one 2.2e-3 m apart (measured).
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from front_end_tpu.ba import distributed as jdist
from front_end_tpu.pipeline import window_vo as jwvo
from front_end_tpu_torch import interop
from front_end_tpu_torch.ba import distributed
from front_end_tpu_torch.ba import schur
from front_end_tpu_torch.pipeline import window_vo
from test_ba import make_window
from test_pipeline import _cfg, _rig, make_planar_sequence
from torch_parity import n, rig_fields, t

import _torch_dist_worker

ITERS = 10
FRAMES = 6
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def window():
    jrig, T, X, T0, X0, meas, vis = make_window(L=256, noise_px=0.3, seed=2)
    rig = interop.from_jax(rig_fields(jrig))[0]
    problem = {k: np.asarray(v) for k, v in
               (("T0", T0), ("X0", X0), ("meas", meas), ("vis", vis))}
    return jrig, rig, problem


@pytest.fixture(scope="module")
def window_cfg():
    jcfg = jwvo.WindowVOConfig.create(_cfg(), window=3, ba_every=1,
                                      ba_max_landmarks=1024)
    return (interop.from_jax(rig_fields(_rig()))[0],
            interop.window_from_jax(dataclasses.asdict(jcfg))[0])


def _spawn(tmp, world, tasks):
    distributed.launch(
        _torch_dist_worker.run, world, (tasks,),
        init_method=f"file://{tmp}/store", device="cpu",
        timeout=SPAWN_TIMEOUT)

    def load(name, rank):
        with np.load(f"{tmp}/{name}.{rank}.npz") as z:
            return {k: z[k] for k in z.files}
    return load


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, window, window_cfg):
    tmp = tmp_path_factory.mktemp("dist2")
    rig, cfg = window_cfg
    lefts, rights = make_planar_sequence(n_frames=FRAMES)
    return _spawn(tmp, 2, [
        ("sharded_solve", (window[1], window[2], ITERS, f"{tmp}/solve")),
        ("live_window", (rig, cfg, lefts, rights, f"{tmp}/live"))])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, window, window_cfg):
    tmp = tmp_path_factory.mktemp("dist4")
    return _spawn(tmp, 4, [
        ("sharded_solve", (window[1], window[2], ITERS, f"{tmp}/solve")),
        ("window_errors", (*window_cfg, f"{tmp}/errors"))])


@pytest.mark.parametrize("W,iters", [(2, 1), (3, 6), (4, 10), (8, 12)])
def test_comm_audit_equals_jax(W, iters):
    assert distributed.comm_audit(W, iters) == jdist.comm_audit(W, iters)


@pytest.mark.parametrize("L,ranks", [(10, 8), (16, 8), (256, 3), (5, 1)])
def test_pad_landmarks_equals_jax(L, ranks):
    rs = np.random.RandomState(L)
    X = rs.randn(L, 3).astype(np.float32)
    meas = rs.randn(L, 3, 4).astype(np.float32)
    vis = rs.rand(L, 3) > 0.3
    ref = jdist.pad_landmarks(jnp.asarray(X), jnp.asarray(meas),
                              jnp.asarray(vis), ranks)
    got = distributed.pad_landmarks(t(X), t(meas), t(vis), ranks)
    for a, b in zip(got, ref):
        assert a.dtype == t(np.asarray(b)).dtype
        np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.fixture(scope="module")
def references(window, devices):
    jrig, rig, p = window
    single = schur.ba_solve(t(p["T0"]), t(p["X0"]), t(p["meas"]),
                            t(p["vis"]), rig, iters=ITERS)
    jax8 = jdist.ba_solve_sharded(jdist.make_mesh(8), p["T0"], p["X0"],
                                  p["meas"], p["vis"], jrig, iters=ITERS)
    return single, jax8


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_equals_single_and_jax_sharded(world, two_ranks,
                                                     four_ranks, references):
    load = {2: two_ranks, 4: four_ranks}[world]
    single, jax8 = references
    got = [load("solve", r) for r in range(world)]
    for ref_cost, ref_poses in ((n(single.cost), n(single.poses)),
                                (np.asarray(jax8.cost),
                                 np.asarray(jax8.poses))):
        np.testing.assert_allclose(got[0]["cost"], ref_cost, rtol=1e-3)
        np.testing.assert_allclose(got[0]["poses"], ref_poses, atol=1e-4)
    np.testing.assert_allclose(got[0]["rms"], n(single.rms_px), rtol=1e-3)
    np.testing.assert_allclose(got[0]["X"][:256], n(single.landmarks),
                               atol=4e-3)
    for g in got[1:]:                   # replicated outputs: bit for bit
        for k in ("poses", "cost", "cost0", "rms", "X"):
            np.testing.assert_array_equal(g[k], got[0][k])


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_counted_equal_the_audit(world, two_ranks, four_ranks):
    """1 + 2·iters packed all-reduces (the audit) + 2 for the rms, and no
    gather inside the solve, on every rank."""
    load = {2: two_ranks, 4: four_ranks}[world]
    want = jdist.comm_audit(3, ITERS)["psums_per_solve"] + 2
    assert want == 1 + 2 * ITERS + 2
    for r in range(world):
        assert tuple(load("solve", r)["counts"]) == (want, 0)


def test_mesh_requires_divisible_compaction(four_ranks):
    for r in range(4):
        said = list(four_ranks("errors", r)["said"])
        assert len(said) == 2, said
        assert "not divisible by the group's size 4" in said[0]
        assert "store capacity 1152" in said[1]


@pytest.fixture(scope="module")
def unsharded_window(window_cfg):
    rig, cfg = window_cfg
    lefts, rights = make_planar_sequence(n_frames=FRAMES)
    _, outs = window_vo.run_sequence(
        window_vo.init_state(rig, cfg, device="cpu"), t(lefts), t(rights),
        rig, cfg)
    return outs


def test_live_sharded_window_matches_unsharded(two_ranks, unsharded_window):
    got = two_ranks("live", 0)
    ref = unsharded_window
    assert got["ba_ran"][2:].all() and not got["ba_ran"][:2].any()
    np.testing.assert_array_equal(got["ba_ran"], n(ref.ba_ran))
    np.testing.assert_allclose(got["pose"][:, :3, 3],
                               n(ref.frame.pose)[:, :3, 3], atol=2e-3)
    ran = got["ba_ran"]
    np.testing.assert_allclose(got["ba_rms"][ran], n(ref.ba_rms_px)[ran],
                               atol=5e-2)
    assert (got["ba_rms"][ran] < 1.0).all()


def test_live_sharded_window_ranks_in_lockstep(two_ranks):
    """Both ranks step the same frames with the same seed: their
    replicated outputs are equal bit for bit; each BA'd frame made the
    solve's collectives (6 iterations) and one gather of the landmarks."""
    a, b = two_ranks("live", 0), two_ranks("live", 1)
    for k in ("pose", "ba_ran", "ba_rms", "ba_cost"):
        np.testing.assert_array_equal(a[k], b[k])
    n_ba = int(a["ba_ran"].sum())
    cfg = window_vo.WindowVOConfig()
    audit = distributed.window_ba_audit(3, cfg.ba_iters,
                                        cfg.ba_max_landmarks)
    assert audit == {"all_reduces": 1 + 2 * cfg.ba_iters + 2,
                     "all_gathers": 1, "gather_floats": 3 * 1024}
    for g in (a, b):
        assert tuple(g["counts"]) == (n_ba * audit["all_reduces"],
                                      n_ba * audit["all_gathers"])

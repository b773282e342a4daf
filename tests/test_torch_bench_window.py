"""The port's window sweep (`front_end_tpu_torch/bench_window.py`) on the
CPU at a cut depth prints the JAX script's tables: the same headers, the
same (ba_every, iters) grid and window lengths, the sharded solver's
bytes per iteration as the JAX package counts them."""
from pathlib import Path

import numpy as np

from front_end_tpu.ba import distributed as jdist
from front_end_tpu_torch import bench_window
from torch_parity import run_main

ROOT = Path(__file__).resolve().parents[1]


def test_bench_window_prints_jax_tables():
    text = run_main(bench_window.main, [
        "--device", "cpu", "--frames", "1", "--passes", "1",
        "--rendered-frames", "3", "--size", "64x96"])
    lines = text.splitlines()
    jax_src = (ROOT / "bench_window.py").read_text()
    for header in ("| mode | ba_every | iters | fps/chip | ATE (m) |",
                   "| window W | fps/chip | ATE (m) | comm/iter (B) |"):
        assert f'"{header}"' in jax_src and header in lines
    grid = [ln.split("|")[2:4] for ln in lines
            if ln.startswith("| windowed |")]
    assert [(int(a), int(b)) for a, b in grid] == [
        (1, 2), (1, 4), (2, 2), (2, 4), (4, 2), (4, 4)]
    i = lines.index("| window W | fps/chip | ATE (m) | comm/iter (B) |")
    rows = [ln.split("|")[1:-1] for ln in lines[i + 2:i + 6]]
    assert [int(r[0]) for r in rows] == [3, 4, 6, 8]
    assert [int(r[3]) for r in rows] == [
        jdist.comm_audit(w, 1)["bytes_per_iter"] for w in (3, 4, 6, 8)]
    assert all(float(r[1]) > 0 and np.isfinite(float(r[2])) for r in rows)

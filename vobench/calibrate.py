"""The readings the limits of `correct` are set from (not run by the
benchmark's runs).

    python -m vobench.calibrate --workload <name> --frames <m> \\
        [--control] --seeds <n> [<n> ...]

For each seed: the cell's frames, the program over the first m frames of
the replay through the cell's own source and feed (untimed), the plain
reference over the same frames, and with `--control` the reference again
with its products in TF32 (`check.control`).  Prints one JSON line per
seed: the numbers compared for the program and for the control, each
against the float32 reference.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from vobench import check, frames as frames_mod, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vobench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    from vobench.program import Program
    cell = spec.load_cell(args.workload)
    dev = "cuda:0"
    prog = Program(cell.config, dev)
    for seed in args.seeds:
        t0 = time.perf_counter()
        frames = frames_mod.prepare(cell.config, cell.traffic, seed, dev)
        traffic = cell.traffic
        w = run.run_window(prog, frames, traffic, seed, 1e9,
                           max_frames=args.frames, check_frames=args.frames)
        gc.collect()
        ref = run.reference_run(frames, traffic, seed, cell.config, dev,
                                len(w.poses))
        fields = {k: w.scalars[:, j] for j, k in enumerate(prog.fields)}
        line = {"seed": seed, "frames": len(w.poses), "failed": w.failed,
                "program": check.gaps(w.poses, fields, *ref)}
        if args.control:
            ctrl = check.control(lambda: run.reference_run(
                frames, traffic, seed, cell.config, dev, len(w.poses)))
            line["control"] = check.gaps(ctrl[0], ctrl[1], *ref)
        line["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

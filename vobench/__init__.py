"""The benchmark of the PyTorch and CUDA port (`front_end_tpu_torch`).

    python -m vobench --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` on one CUDA card and prints one JSON
line.  Everything that belongs to one deployment, one traffic mix or one
per-layer metric is a file of its own, found by name:
`vobench/configs/<config>.json`, `vobench/traffic/<mix>.json`,
`vobench/layers/<metric>.py`, and the step a configuration's `entry`
names, `vobench/entries/<entry>.py` (the port's) beside
`vobench/reference/entries/<entry>.py` (the plain one).  The plain
reference that decides `correct` lives in `vobench/reference/` and
imports nothing of the port.
"""

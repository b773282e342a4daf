"""`python -m vobench`: the clock of `setup_s` starts here, before the
harness, PyTorch or the port is imported."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402

from vobench.run import main  # noqa: E402

sys.exit(main(T_START))

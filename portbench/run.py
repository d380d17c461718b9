"""The port's benchmark, one run:

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices. The
last line of standard output is the result (JSON); the last lines of
standard error are the numbers the output check compared, each beside its
limit. See ``harness.py`` for what a run does and ``spec.py`` for how a
cell finds its files.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, in place of this directory (whose module names would
# shadow the standard library's)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

"""The benchmark of medicalsemseg_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process on the machine's GPUs
and prints one JSON object as the last line of standard output (see
``portbench/harness.py``). Exits with 2, printing no result, where CUDA is
not available or the machine has fewer GPUs than the cell asks for.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, the first entry of the path is this folder: put the
# checkout's root there instead, so that the benchmark is the package
# ``portbench`` and none of its files shadows a module of the same name
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))

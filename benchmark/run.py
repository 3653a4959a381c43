"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output, and every
number compared with the reference, beside its limit, as the last lines of
standard error. Exits non-zero, printing no result, without enough cards,
when the program is missing, or when jax or the JAX package was loaded.
"""

import os
import sys

# The checkout's root, not this directory, heads the import path: the
# benchmark is the package `benchmark`, and its subpackage names must not
# shadow anything.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = _ROOT

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(core.main(t_process=core.process_start_epoch()))

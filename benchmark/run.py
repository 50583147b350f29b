"""The benchmark of guassianhand_tpu_torch: one run of one cell.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints one JSON object as its last line of standard output. See
``benchmark/README.md``.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.core import execute, fixed_caches  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    return execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_process=T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())

"""The readings the output check's limits are set from, in one process.

  python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
      [--control-seeds 7,8,9] [--faults half_batch] [--seconds 3]

For each seed of ``--seeds`` it runs the cell as a run does (set-up, a
window of ``--seconds``, the check) and prints the numbers compared: the
program's readings. For each seed of ``--control-seeds`` it prints the
same numbers with the reference computed one precision step down in the
program's place (the control), and with each of ``--faults`` planted
there (the traffic kind's ``FAULTS``). Every reading is judged against
the cell's limits by the rule of a run (``core.judge``): one JSON line a
reading, with each number beside its limit and ``correct``; the program's
should read true, the control's and each fault's false. The program's
kernels build once for all seeds. Runs on the card only.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.core import (Run, Spec, fixed_caches,  # noqa: E402
                                    judge)


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    fixed_caches()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec.load(args.workload)
    kind = spec.kind()

    def emit(numbers, **row):
        judged, missing, correct = judge(numbers, spec.limits)
        row.update(correct=correct, missing=missing,
                   numbers={k: {"value": v, "limit": lim}
                            for k, (v, lim) in judged.items()})
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        run = Run(spec, seed, args.seconds, False, "cuda")
        t0 = time.perf_counter()
        state = kind.setup(run)
        run.start()
        win = kind.window(state, run)
        t1 = time.perf_counter()
        numbers = kind.check(state, run)
        emit(numbers, reading="program", seed=seed,
             attempted=win["attempted"], setup_and_window_s=t1 - t0,
             check_s=time.perf_counter() - t1)
        del state
    faults = [f for f in args.faults.split(",") if f]
    for seed in args.control_seeds:
        for fault in [None] + faults:
            run = Run(spec, seed, args.seconds, False, "cuda")
            t0 = time.perf_counter()
            numbers = kind.control(run, fault)
            emit(numbers, reading=fault or "control", seed=seed,
                 seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

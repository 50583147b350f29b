"""How far chip_smoke.py's small card-vs-CPU fit parts, run after run (not a
test). Needs a CUDA card.

    python3 tests/torch_fit_reference_repeat.py [runs]

For each route (default, and with both kernel switches on) it runs the
2-step fit of ``phase_fit_reference`` from one seeded batch and seeded
weights twice on the CPU and ``runs`` times (default 4) on the card, and
prints one JSON line a comparison (``compare_fits`` of each step): CPU
against CPU, each card run against the first CPU run (what
``phase_fit_reference`` checks), and each card run against the first card
run.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def two_steps(device: str, kernels: bool, batch) -> tuple:
    fit = cs.FitReference(device, kernels, batch)
    return [fit.step(), fit.step()], fit.initial


def main(runs: int) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    batch = cs.fit_reference_batch()
    for kernels in (False, True):
        cpu = [two_steps("cpu", kernels, batch) for _ in range(2)]
        card = [two_steps("cuda", kernels, batch) for _ in range(runs)]
        pairs = [("cpu1_vs_cpu0", cpu[1], cpu[0])]
        pairs += [(f"card{i}_vs_cpu0", c, cpu[0]) for i, c in enumerate(card)]
        pairs += [(f"card{i}_vs_card0", c, card[0])
                  for i, c in enumerate(card[1:], 1)]
        for name, (run, _), (ref, initial) in pairs:
            steps = [cs.compare_fits(a, b, initial) for a, b in zip(run, ref)]
            print(json.dumps({"kernels": kernels, "pair": name,
                              "steps": steps}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

"""Run logging (counterpart of ``utils/logging.py``): a JSONL stream of
scalars per step in ``metrics.jsonl``, echoed to stdout."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class RunLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        parts = " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                         if k not in ("step", "t"))
        print(f"[step {step}] {parts}")

    def close(self):
        self._f.close()

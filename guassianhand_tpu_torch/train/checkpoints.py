"""Checkpoint save and resume (counterpart of ``train/checkpoints.py``):
the model's parameters, the optimiser and schedule state and the step, with
``torch.save``, and a ``last.ckpt`` link for auto-resume. Reading the JAX
package's flax msgpack checkpoints is not ported yet.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None, step: int = 0) -> None:
    """Write the checkpoint atomically and point ``last.ckpt`` at it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"params": model.state_dict(),
             "opt_state": None if optimizer is None
             else optimizer.state_dict(),
             "schedule": None if scheduler is None
             else scheduler.state_dict(),
             "step": step}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    link = os.path.join(os.path.dirname(path) or ".", "last.ckpt")
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.basename(path), link)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None) -> int:
    """Restore what ``save_checkpoint`` wrote into ``model`` (and the
    optimiser and schedule, when given and saved). Returns the step."""
    dev = next(model.parameters()).device
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state["params"])
    if optimizer is not None and state["opt_state"] is not None:
        optimizer.load_state_dict(state["opt_state"])
    if scheduler is not None and state["schedule"] is not None:
        scheduler.load_state_dict(state["schedule"])
    return int(state["step"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    link = os.path.join(ckpt_dir, "last.ckpt")
    if os.path.exists(link):
        return os.path.realpath(link)
    if not os.path.isdir(ckpt_dir):
        return None
    cks = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt"))
    return os.path.join(ckpt_dir, cks[-1]) if cks else None

"""Checkpoint save and resume (counterpart of ``train/checkpoints.py``):
the model's parameters, the optimiser and schedule state and the step, with
``torch.save``, and a ``last.ckpt`` link for auto-resume. ``load_checkpoint``
restores strictly (a run's resume); ``load_params_partial`` restores what a
checkpoint carries and keeps the rest (``pretrained:``). Reading the JAX
package's flax msgpack checkpoints is not ported.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def write_checkpoint(path: str, params: Dict[str, torch.Tensor],
                     opt_state=None, schedule=None, step: int = 0,
                     keep_last_link: bool = True) -> None:
    """Write a checkpoint of the state dict ``params`` atomically and,
    with ``keep_last_link``, point ``last.ckpt`` beside it at it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"params": params, "opt_state": opt_state,
                "schedule": schedule, "step": step}, tmp)
    os.replace(tmp, path)
    if keep_last_link:
        link = os.path.join(os.path.dirname(path) or ".", "last.ckpt")
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.basename(path), link)


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    scheduler=None, step: int = 0) -> None:
    """Write the model's checkpoint and point ``last.ckpt`` at it."""
    write_checkpoint(
        path, model.state_dict(),
        None if optimizer is None else optimizer.state_dict(),
        None if scheduler is None else scheduler.state_dict(), step)


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


def _adapt_color_b_layout(name: str, val: torch.Tensor,
                          cur: torch.Tensor) -> Optional[torch.Tensor]:
    """``color_b`` between the reference's 48 channels and the narrow rgb
    triple (``OneShotConfig.narrow_color_b``): the renderer reads channels
    0-2 only, so narrowing slices them and widening fills the other 45 with
    zeros. None where ``val`` is no such counterpart of ``cur``."""
    if not name.endswith("color_b") or val.ndim != 3:
        return None
    if val.shape[0] == 48 and cur.shape == (3,) + val.shape[1:]:
        return val[:3]
    if val.shape[0] == 3 and cur.shape == (48,) + val.shape[1:]:
        wide = torch.zeros(cur.shape, dtype=val.dtype)
        wide[:3] = val
        return wide
    return None


def load_params_partial(path: str, model: torch.nn.Module,
                        prefix: str = "") -> Dict[str, list]:
    """strict=False restore (the JAX package's ``load_params_partial``): a
    tensor of the checkpoint (``save_checkpoint``'s or
    ``cli/port_checkpoint.py``'s file, or a bare state dict) replaces the
    model's parameter or buffer of its name where the shapes agree, after
    ``color_b``'s 48 / 3 channel reconciliation; everything else keeps its
    value. With a ``prefix`` only the checkpoint's tensors under it are
    read, the prefix stripped: ``prefix="pointcloud_generator."`` loads a
    ported reference checkpoint's point-cloud generator into a
    ``models/point_generator.SimplePointGenerator``. Prints ``restored
    N/M``, and the top-level modules of the checkpoint that the model does
    not have, as the JAX package's ``merge_ported`` reports them absent.
    Returns the names restored, missing (the model's, kept) and unexpected
    (the checkpoint's, unused). The JAX package also reconciles flax's
    scanned and unrolled transformer trees; the port has one layout, so it
    needs no such step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    ck = {k.removeprefix(prefix): v
          for k, v in state.get("params", state).items()
          if k.startswith(prefix)}
    own = model.state_dict()
    restored = {}
    for name, cur in own.items():
        val = ck.get(name)
        if val is not None and val.shape != cur.shape:
            val = _adapt_color_b_layout(name, val, cur)
        if val is not None and val.shape == cur.shape:
            restored[name] = val
    model.load_state_dict(restored, strict=False)
    print(f"load_params_partial: restored {len(restored)}/{len(own)} "
          f"tensors from {path}")
    unexpected = sorted(n for n in ck if n not in own)
    own_modules = {n.split(".")[0] for n in own}
    absent: Dict[str, int] = {}
    for n in unexpected:
        top = n.split(".")[0]
        if top not in own_modules:
            absent[top] = absent.get(top, 0) + 1
    if absent:
        print("  skipped: " + ", ".join(f"{k} (absent, {v} tensors)"
                                        for k, v in sorted(absent.items())))
    return {"restored": sorted(restored),
            "missing": sorted(n for n in own if n not in restored),
            "unexpected": unexpected}


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    link = os.path.join(ckpt_dir, "last.ckpt")
    if os.path.exists(link):
        return os.path.realpath(link)
    if not os.path.isdir(ckpt_dir):
        return None
    cks = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt"))
    return os.path.join(ckpt_dir, cks[-1]) if cks else None

"""NaN and anomaly tripwires (counterpart of ``utils/debug.py``).

- ``tree_finite_report`` / ``assert_tree_finite``: a host-side audit of a
  nested dict / list / tuple of tensors (or a ``state_dict``) after a step,
  with the JAX package's leaf paths (``"a/b"``, ``"l/[0]"``);
- ``checked``: the counterpart of ``checkify.float_checks``. Every op run
  inside the wrapped function is checked as it runs: an op whose floating
  output holds a NaN, or a division whose divisor holds a 0, raises
  ``FloatingPointError`` naming the op. An overflow to inf passes, as
  checkify lets it;
- ``debug_assert_finite``: prints when a tensor holds non-finite values
  and does not abort.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) of every leaf: dict keys by name, sequence items as
    ``[i]``, None as an empty subtree (jax.tree_util's naming)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def tree_finite_report(tree: Any) -> dict:
    """Host-side: leaf path -> (all finite?, max |value|) for every floating
    leaf. For post-step audits."""
    out = {}
    for name, leaf in _leaves(tree):
        t = torch.as_tensor(leaf).detach()
        if t.is_floating_point():
            out[name] = (bool(torch.isfinite(t).all()),
                         float(t.abs().max()) if t.numel() else 0.0)
    return out


def assert_tree_finite(tree: Any, where: str = "") -> None:
    bad = {k: v for k, v in tree_finite_report(tree).items() if not v[0]}
    if bad:
        raise FloatingPointError(f"non-finite values {where}: {sorted(bad)}")


# ops whose second operand (the first for reciprocal) is a divisor
_DIVISIONS = {torch.ops.aten.div: 1, torch.ops.aten.div_: 1,
              torch.ops.aten.floor_divide: 1, torch.ops.aten.floor_divide_: 1,
              torch.ops.aten.reciprocal: 0, torch.ops.aten.reciprocal_: 0}


class _FloatChecks(TorchDispatchMode):
    """Raises FloatingPointError on a NaN output or a zero divisor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        arg = _DIVISIONS.get(func.overloadpacket)
        if arg is not None and arg < len(args):
            divisor = torch.as_tensor(args[arg])
            if bool((divisor == 0).any()):
                raise FloatingPointError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"nan generated by {func}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` with every op it runs checked (``_FloatChecks``); the wrapper
    raises where a check fires (the counterpart of detect_anomaly)."""

    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def debug_assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Prints ``[anomaly] {name} has {k} non-finite values`` when ``x``
    holds any, and returns ``x`` (does not abort).

    Usage: x = debug_assert_finite(x, "scene_codes")."""
    bad = int((~torch.isfinite(x)).sum())
    if bad > 0:
        print(f"[anomaly] {name} has {bad} non-finite values")
    return x

"""The reference's one precision switch.

The program computes the one-shot model's feature pipeline in bf16 (the
layers built with a compute dtype) and everything else in float32 with TF32
off. The reference computes all of it in float32 with TF32 off. The
control of the output check is the reference one step below what the
configuration states (``set_mode("control")``):

- where the program computes in bf16, the reference rounds the inputs and
  the outputs of each such layer to float8 e4m3 with one scale a tensor
  (the largest magnitude maps to 448, e4m3's largest finite value), the
  way fp8 training scales a tensor, and multiplies in float32;
- where the program computes in float32, matmuls and convolutions run in
  TF32 (``allow_tf32``).
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
_MODE = {"mode": "reference"}


def set_mode(mode: str) -> None:
    """"reference" (float32, TF32 off) or "control" (fp8 where the program
    runs bf16, TF32 where it runs float32)."""
    if mode not in ("reference", "control"):
        raise ValueError(f"mode {mode!r}")
    _MODE["mode"] = mode
    tf32 = mode == "control"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def mode() -> str:
    return _MODE["mode"]


def lowp(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a bf16 layer of the program sees it: unchanged in the
    reference, rounded to scaled e4m3 in the control. Differentiable
    straight through the rounding."""
    x = x.float()
    if _MODE["mode"] != "control":
        return x
    with torch.no_grad():
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())

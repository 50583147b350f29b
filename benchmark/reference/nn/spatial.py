"""Sin/cos positional encoding (a frozen copy of the program's
``nn/spatial.py``): frequencies pi * 2^l for l in [0, L); output [x, sin(x
f), cos(x f)] of dimension C * (1 + 2L)."""
from __future__ import annotations

import numpy as np
import torch


def pe_dim(channels: int, levels: int) -> int:
    return channels * (1 + 2 * levels)


def positional_encoding(x: torch.Tensor, levels: int) -> torch.Tensor:
    """x (..., C) -> (..., C * (1 + 2 * levels))."""
    if levels <= 0:
        return x
    freqs = torch.as_tensor(np.pi * (2.0 ** np.arange(levels)),
                            dtype=x.dtype, device=x.device)
    y = x[..., None, :] * freqs[:, None]                  # (..., L, C)
    z = torch.cat([torch.sin(y), torch.cos(y)], dim=-1)
    return torch.cat([x, z.reshape(*x.shape[:-1], -1)], dim=-1)

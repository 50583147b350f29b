"""Gaussian primitive container (counterpart of ``core/gaussians.py``).

A static-capacity buffer plus an optional ``valid`` mask: padding slots keep
their place and get opacity 0 through ``effective_opacity``. ``to_ply`` and
``from_ply`` write and read the standard 3DGS binary PLY (numpy on the
host); ``concatenate`` joins two buffers and their validity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """xyz (N, 3); opacity (N, 1) in [0, 1]; rotation (N, 4) wxyz;
    scaling (N, 3) > 0; shs (N, K, 3) SH coefficients or (N, 1, 3) RGB;
    valid optional (N,) mask."""

    xyz: torch.Tensor
    opacity: torch.Tensor
    rotation: torch.Tensor
    scaling: torch.Tensor
    shs: torch.Tensor
    valid: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.xyz.shape[0]

    def effective_opacity(self) -> torch.Tensor:
        """Opacity with padding slots zeroed."""
        if self.valid is None:
            return self.opacity
        return self.opacity * self.valid.to(self.opacity.dtype)[..., None]

    def to_ply(self, path: str) -> None:
        """Write the standard 3DGS binary PLY: invalid slots dropped,
        opacity as its logit (clipped to [1e-3, 1 - 1e-3]) and scales as
        their logs, the reference exporter's attribute layout."""
        xyz, opa, rot, scl, shs = (t.detach().cpu().numpy() for t in (
            self.xyz, self.opacity, self.rotation, self.scaling, self.shs))
        if self.valid is not None:
            keep = self.valid.detach().cpu().numpy() > 0.5
            xyz, opa, rot, scl, shs = (a[keep] for a in (xyz, opa, rot, scl,
                                                         shs))
        n = xyz.shape[0]
        f_dc = shs[:, :1].reshape(n, -1)
        f_rest = shs[:, 1:].reshape(n, -1)
        opa = np.clip(opa, 1e-3, 1 - 1e-3)
        opa = np.log(opa / (1 - opa))
        scl = np.log(np.maximum(scl, 1e-12))
        names = ["x", "y", "z", "nx", "ny", "nz"]
        names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        names += ["opacity"]
        names += [f"scale_{i}" for i in range(scl.shape[1])]
        names += [f"rot_{i}" for i in range(rot.shape[1])]
        cols = np.concatenate(
            [xyz, np.zeros_like(xyz), f_dc, f_rest, opa, scl, rot],
            axis=1).astype("<f4")
        header = "\n".join(
            ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
            + [f"property float {p}" for p in names] + ["end_header", ""])
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(cols.tobytes())


def from_ply(path: str, device=None) -> Gaussians:
    """Read a standard 3DGS binary PLY (``Gaussians.to_ply``'s, or the
    reference exporter's): float properties x/y/z, f_dc_*, f_rest_*,
    opacity (a logit), scale_* (logs), rot_*; others are ignored. The
    quaternions come back normalised. Tensors on ``device`` (default
    ``cuda``)."""
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.index(b"\n", blob.index(b"end_header")) + 1
    n, names, binary = None, [], False
    for line in blob[:end].decode("ascii").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            binary = parts[1] == "binary_little_endian"
        elif parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts[0] == "property":
            if parts[1] != "float":
                raise ValueError(f"unsupported property type: {line!r}")
            names.append(parts[2])
    if not binary or n is None:
        raise ValueError("expected a binary_little_endian ply with a vertex "
                         "element")
    cols = np.frombuffer(blob[end:], dtype="<f4",
                         count=n * len(names)).reshape(n, len(names))
    col = {name: cols[:, i] for i, name in enumerate(names)}

    def group(prefix):
        keys = sorted((k for k in names if k.startswith(prefix)),
                      key=lambda k: int(k[len(prefix):]))
        return np.stack([col[k] for k in keys], axis=1) if keys else None

    shs = group("f_dc_").reshape(n, 1, 3)
    f_rest = group("f_rest_")
    if f_rest is not None:
        shs = np.concatenate([shs, f_rest.reshape(n, -1, 3)], axis=1)
    rotation = group("rot_")
    rotation = rotation / np.maximum(
        np.linalg.norm(rotation, axis=1, keepdims=True), 1e-9)
    device = torch.device(device or "cuda")

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return Gaussians(
        xyz=tensor(np.stack([col["x"], col["y"], col["z"]], axis=1)),
        opacity=tensor(1.0 / (1.0 + np.exp(-col["opacity"][:, None]))),
        rotation=tensor(rotation), scaling=tensor(np.exp(group("scale_"))),
        shs=tensor(shs))


def concatenate(a: Gaussians, b: Gaussians) -> Gaussians:
    """``a``'s slots then ``b``'s, with their validity (all valid where a
    buffer has none)."""
    def valid(g: Gaussians) -> torch.Tensor:
        if g.valid is not None:
            return g.valid
        return torch.ones(g.n, dtype=torch.float32, device=g.xyz.device)

    return Gaussians(
        *(torch.cat([getattr(a, k), getattr(b, k)], 0)
          for k in ("xyz", "opacity", "rotation", "scaling", "shs")),
        valid=torch.cat([valid(a), valid(b)], 0))

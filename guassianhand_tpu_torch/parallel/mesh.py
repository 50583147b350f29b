"""Process groups of the (data, model) mesh (counterpart of
``parallel/mesh.py``).

The ranks of a ``torch.distributed`` job form an ``n_data x n_model`` grid,
rank = d * n_model + m, the JAX package's device layout:

- ``data``: the batch is split over it; each data group (the ranks of one
  ``m``) averages its gradients;
- ``model``: the Gaussian axis of the render is split over it; each model
  group (the ranks of one ``d``) exchanges pairs, gathers tiles and sums
  its partial gradients.

The groups are plain ``dist.new_group`` groups, one for each row and column
of the grid, each with a timeout, so that a rank that hangs fails the job
instead of blocking it. The backend is the caller's choice: gloo runs on
the CPU and, with every rank on one card, on CUDA tensors (NCCL refuses two
ranks on one GPU); NCCL needs one GPU a rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, backend: str,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> None:
    """One ``dist.init_process_group`` call. Without ``coordinator`` the
    rank, world size and address come from the environment (``env://``:
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); ``coordinator`` is a
    ``tcp://host:port`` or ``file://path`` rendezvous (``host:port`` alone
    means tcp) and then ``num_processes`` and ``process_id`` are required."""
    if coordinator is None:
        dist.init_process_group(backend=backend, init_method="env://",
                                timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def rank_layout(n_data: int, n_model: int) -> np.ndarray:
    """(n_data, n_model) ranks: rank = d * n_model + m."""
    return np.arange(n_data * n_model).reshape(n_data, n_model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its groups: ``world`` (every
    rank), ``data_group`` (the ranks of its model index, over which the
    batch is split) and ``model_group`` (the ranks of its data index, over
    which the Gaussians are split)."""

    n_data: int
    n_model: int
    rank: int
    world: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The mesh of the initialised job: n_data=1, n_model=world when
    neither is given, the other one from the world size when one is. Every
    rank calls it, in the same order as any other group it makes."""
    n = dist.get_world_size()
    if n_data is None and n_model is None:
        n_data, n_model = 1, n
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data} x {n_model} != world {n}")
    layout = rank_layout(n_data, n_model)
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    # new_group must be called by every rank for every group, in one order
    data_groups = [dist.new_group(layout[:, j].tolist(), timeout=timeout)
                   for j in range(n_model)]
    model_groups = [dist.new_group(layout[i, :].tolist(), timeout=timeout)
                    for i in range(n_data)]
    return Mesh(n_data=n_data, n_model=n_model, rank=rank,
                world=dist.group.WORLD, data_group=data_groups[m],
                model_group=model_groups[d])


# --- explicit-exchange context -------------------------------------------
# The renderer sits deep inside the model and takes no mesh argument; the
# sharded fit step publishes its mesh here and a model whose
# RendererConfig.sharded_exchange is set renders through the exchange while
# it is active. The stack is thread-local: another thread's forward sees
# (and changes) nothing of this thread's.
_EXCHANGE_TLS = threading.local()


def _stack() -> list:
    if not hasattr(_EXCHANGE_TLS, "stack"):
        _EXCHANGE_TLS.stack = [None]
    return _EXCHANGE_TLS.stack


def exchange_mesh() -> Optional[Mesh]:
    return _stack()[-1]


class use_exchange_mesh:
    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        _stack().append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _stack().pop()
        return False


# --- placement rules ---------------------------------------------------------
# JAX places arrays with NamedShardings; here each rank keeps its own part,
# and these rules say which (parallel/step.py::shard_batch applies them).

def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """Parameters and scalars: every rank holds the whole tensor."""
    return lambda t: t


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batch arrays: axis 0 in n_data equal parts, part d on the ranks of
    data index d; every other axis whole (the points axis too: each model
    rank computes the features of its data shard whole, parallel/step.py)."""

    def place(t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0]
        if b % mesh.n_data:
            raise ValueError(f"batch {b} does not split over data="
                             f"{mesh.n_data}")
        bl = b // mesh.n_data
        return t[mesh.data_index * bl:(mesh.data_index + 1) * bl]

    return place

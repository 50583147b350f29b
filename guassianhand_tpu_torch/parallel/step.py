"""The sharded fit step (counterpart of ``parallel/step.py``).

Over the (data, model) mesh of ``parallel/mesh.py``:

- the batch is split over ``data`` (``shard_batch``); every rank holds
  whole, identical parameters (broadcast from rank 0 when the step is
  made, and checked by checksum);
- with ``RendererConfig.sharded_exchange`` and a model axis wider than 1
  the step publishes its mesh (``use_exchange_mesh``) and the model
  renders through the Gaussian->tile exchange (``parallel/raster_shard``);
- after the backward the trainable gradients are summed over the mesh, so
  that the update equals the unsharded step's on the whole batch.

Counting each gradient once. The loss is the mean over the global batch
plus the identity regularisers. A rank's backward runs on
``total_d / n_data + reg / (n_data * k)`` where ``total_d`` is its data
shard's loss:

- through the exchange (k = n_model) a rank renders only its Gaussian
  shard. The loss on the gathered image, computed whole on every model
  rank, reaches each rank's tiles once (the gather's backward takes this
  rank's slice), so the gradients of the appearance parameters are
  partial and sum to the whole over the model group. The features'
  gradient is averaged over the model group at their boundary
  (``comm.average_gradient`` in the model's sharded route), so each rank
  backpropagates the whole gradient / n_model through the feature
  pipeline: the same bits on every model rank, rounded in a bf16 pipeline
  as the unsharded backward rounds them, and again the whole after the
  sum. The regulariser, whole on every rank, is divided by n_model. The
  gradients are summed over every rank;
- without it (k = 1) every model rank renders everything, its gradients
  are whole, and they are summed over the data group only.

The features are computed whole on each model rank. JAX splits the batch's
points axis over ``model`` and lets XLA partition the feature pipeline; the
port has no partitioner, so each model rank runs the whole feature
pipeline of its data shard (the interaction attention's kernels included)
and only the render is split, by the explicit exchange. That computes the
same function; it costs each model rank the whole feature pipeline and
saves a collective in every layer. ``ops/blockwise_attention.py::
ring_blockwise_attention`` is ported and tested but not wired in, as in
JAX.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from guassianhand_tpu_torch.models.one_shot import OneShotAvatarModel, no_tf32
from guassianhand_tpu_torch.parallel import comm
from guassianhand_tpu_torch.parallel.mesh import (Mesh, batch_sharding,
                                                  replicated,
                                                  use_exchange_mesh)
from guassianhand_tpu_torch.train.fit import FitConfig
from guassianhand_tpu_torch.train.losses import (compute_error,
                                                 identity_regularizers)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's data shard of every array of ``batch``, nested dicts
    (``static_feats``) included: axis 0 split over ``data``
    (``batch_sharding``), every other axis whole; scalars and anything that
    is not a tensor whole (``replicated``)."""
    split, whole = batch_sharding(mesh), replicated(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = shard_batch(v, mesh)
        elif isinstance(v, torch.Tensor) and v.dim() > 0:
            out[k] = split(v)
        else:
            out[k] = whole(v)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as int64 (one per element for 4-byte dtypes)."""
    t = t.detach().contiguous()
    if t.element_size() == 4:
        return t.view(torch.int32).to(torch.int64).reshape(-1)
    return t.reshape(-1).view(torch.uint8).to(torch.int64)


def checksum(module: torch.nn.Module) -> torch.Tensor:
    """(1,) int64 that changes with any bit of any parameter or buffer:
    each tensor's bits weighted by their position, summed (wrapping)."""
    total = None
    for t in list(module.parameters()) + list(module.buffers()):
        b = _bits(t)
        w = torch.arange(b.shape[0], device=b.device) % 65_521 + 1
        s = (b * w).sum()
        total = s if total is None else total + s
    return total.reshape(1)


def replica_spread(module: torch.nn.Module, mesh: Mesh) -> int:
    """max - min over every rank of ``checksum(module)``: 0 when every rank
    holds the same bits."""
    every = comm.all_gather(checksum(module), mesh.world)
    return int(every.max() - every.min())


def replicate_parameters(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer from rank 0 to every rank, then checked
    by checksum (the JAX step replicates one params tree)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            comm.broadcast(t.data, 0, mesh.world)
    spread = replica_spread(module, mesh)
    if spread:
        raise RuntimeError(f"parameters differ across ranks after the "
                           f"broadcast (checksum spread {spread})")


def make_sharded_fit_step(model: OneShotAvatarModel,
                          vgg_loss_fn: Optional[Callable],
                          optimizer: torch.optim.Optimizer, mesh: Mesh,
                          cfg: FitConfig = FitConfig(), *, height: int,
                          width: int,
                          scheduler: Optional[
                              torch.optim.lr_scheduler.LRScheduler] = None):
    """``step(batch) -> (loss, err)`` on this rank's shard (``shard_batch``)
    of the batch: ``train/fit.py::make_fit_step``'s contract over the mesh.
    ``loss`` is the global batch's, the same on every rank; ``err`` holds
    its error terms (averaged over the data group), reg, overflow and
    interaction_overflow (summed over the mesh's data shards), and, when
    the model rendered through the exchange, exchange_pairs (world,): the
    live pairs each rank received. Every call updates (no accumulation).
    Makes the model's parameters equal on every rank first."""
    replicate_parameters(model, mesh)
    xmesh = mesh if mesh.n_model > 1 else None
    trainable = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        with no_tf32(), use_exchange_mesh(xmesh):
            out = model(batch, height, width)
            total, err = compute_error(
                out["comp_rgb"][:, 0], batch["target_rgb"],
                out["comp_mask"][:, 0], batch["target_mask"], vgg_loss_fn,
                cfg.weights)
            reg = identity_regularizers(
                {"color_b": model.color_b, "opacity_b": model.opacity_b,
                 "map_bias": model.map_bias}, cfg.weights)
            exchanged = "exchange_pairs" in out
            k = mesh.n_model if exchanged else 1
            (total / mesh.n_data + reg / (mesh.n_data * k)).backward()
        grads = [p for p in trainable if p.grad is not None]
        if grads:
            flat = torch.cat([p.grad.reshape(-1) for p in grads])
            comm.all_reduce(flat, mesh.world if exchanged
                            else mesh.data_group)
            for p, g in zip(grads, flat.split([p.numel() for p in grads])):
                p.grad.copy_(g.view_as(p))
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if scheduler is not None:
            scheduler.step()
        # the global batch's means and counts: one reduction over the data
        # group (the exchange's overflow is the mesh's total already)
        names = sorted(err)
        device = total.device
        overflow = torch.as_tensor(out["overflow"], device=device,
                                   dtype=torch.float32).sum()
        terms = torch.stack(
            [total.detach()] + [err[n].detach() for n in names]
            + [torch.zeros_like(overflow) if exchanged else overflow,
               torch.as_tensor(out["interaction_overflow"], device=device,
                               dtype=torch.float32).sum()])
        comm.all_reduce(terms, mesh.data_group)
        means = terms[:-2] / mesh.n_data
        reg = reg.detach()
        result = {n: means[1 + i] for i, n in enumerate(names)}
        result["reg"] = reg
        result["overflow"] = overflow if exchanged else terms[-2]
        result["interaction_overflow"] = terms[-1]
        if exchanged:
            result["exchange_pairs"] = out["exchange_pairs"]
        return means[0] + reg, result

    return step

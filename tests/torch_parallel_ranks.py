"""The rank side of tests/test_torch_parallel.py: every case of the port's
sharded path, run once in one spawn of 4 gloo CPU ranks.

``spawn_cases(tmp)`` starts the ranks without waiting (the test computes
the JAX references meanwhile) and returns the context to join. Each rank
reads ``tmp/inputs.npz`` (numpy arrays written by the test), runs every
case of ``CASES`` and writes ``tmp/rank{r}.npz``. This module imports torch
and the port only, so that the spawned ranks start without JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
# the multiview case's arrays, batched over B (tests/test_parallel.py)
MULTIVIEW_KEYS = ("xyz", "opacity", "rotation", "scaling", "shs", "w2cs", "Ks",
                  "bg", "tgt")


def _gaussians(inputs, i: int, grad: dict):
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    return Gaussians(xyz=grad["xyz"][i], opacity=inputs["opacity"][i],
                     rotation=inputs["rotation"][i],
                     scaling=inputs["scaling"][i], shs=grad["shs"][i])


def render_multiview(inputs, n_data: int) -> dict:
    """tests/test_parallel.py's multiview SH case through
    ``sharded_rasterize_batch`` on a data n_data x model 4/n_data mesh: this
    rank's samples' render and, for the global batch's mean |rgb - tgt|,
    their xyz and shs gradients summed over the model group."""
    from guassianhand_tpu_torch.parallel import comm
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    from guassianhand_tpu_torch.parallel.raster_shard import (
        sharded_rasterize_batch)
    from guassianhand_tpu_torch.parallel.step import shard_batch
    mesh = make_mesh(n_data=n_data)
    local = shard_batch({k: inputs[k] for k in MULTIVIEW_KEYS}, mesh)
    grad = {k: local[k].clone().requires_grad_() for k in ("xyz", "shs")}
    gs = [_gaussians(local, i, grad) for i in range(local["xyz"].shape[0])]
    hw = int(inputs["hw"])
    out = sharded_rasterize_batch(
        gs, local["w2cs"], local["Ks"], height=hw, width=hw, mesh=mesh,
        background=local["bg"], sh_degree=1, use_rgb=False)
    loss = (out["comp_rgb"] - local["tgt"]).abs().mean() / n_data
    loss.backward()
    res = {"rgb": out["comp_rgb"], "mask": out["comp_mask"],
           "overflow": out["overflow"],
           "exchange_pairs": out["exchange_pairs"],
           "data_index": torch.tensor(mesh.data_index)}
    for k, t in grad.items():
        res[f"grad_{k}"] = comm.all_reduce(t.grad, mesh.model_group)
    return res


def render_multiview_2x2(inputs) -> dict:
    return render_multiview(inputs, 2)


def render_multiview_1x4(inputs) -> dict:
    return render_multiview(inputs, 1)


def render_single_view(inputs) -> dict:
    """tests/test_parallel.py's single-view row-band case (64^2, 4 tile
    rows over model = 4): render and the xyz, shs, opacity gradients of
    mean |rgb - tgt| + 0.3 mean(mask^2)."""
    from guassianhand_tpu_torch.core.camera import Camera
    from guassianhand_tpu_torch.core.gaussians import Gaussians
    from guassianhand_tpu_torch.parallel import comm
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    from guassianhand_tpu_torch.parallel.raster_shard import sharded_rasterize
    mesh = make_mesh()
    p = {k[3:]: v for k, v in inputs.items() if k.startswith("sv_")}
    grad = {k: p[k].clone().requires_grad_()
            for k in ("xyz", "shs", "opacity")}
    g = Gaussians(xyz=grad["xyz"], opacity=grad["opacity"],
                  rotation=p["rotation"], scaling=p["scaling"],
                  shs=grad["shs"])
    hw = int(p["hw"])
    cam = Camera.from_w2c(p["w2c"], p["K"], hw, hw)
    out = sharded_rasterize(g, cam, height=hw, width=hw, mesh=mesh,
                            background=p["bg"])
    loss = ((out["comp_rgb"] - p["tgt"]).abs().mean()
            + 0.3 * (out["comp_mask"] ** 2).mean())
    loss.backward()
    res = {"rgb": out["comp_rgb"], "mask": out["comp_mask"],
           "overflow": out["overflow"]}
    for k, t in grad.items():
        res[f"grad_{k}"] = comm.all_reduce(t.grad, mesh.model_group)
    return res


def capacity_overflow(inputs) -> dict:
    """The multiview case's sample 0 on model = 4 with a capacity of half
    the busiest (src, dst) bucket: the pairs dropped, the pairs received and
    the live pairs of ``exchange_balance_stats``."""
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    from guassianhand_tpu_torch.parallel.raster_shard import (
        exchange_balance_stats, sharded_rasterize_batch)
    mesh = make_mesh()
    gs = [_gaussians(inputs, 0, inputs)]
    hw = int(inputs["hw"])
    kw = dict(height=hw, width=hw, sh_degree=1, use_rgb=False)
    stats = exchange_balance_stats(gs, inputs["w2cs"][:1], inputs["Ks"][:1],
                                   n_model=WORLD, **kw)
    cap = stats["diagonal"]["max_bucket"] // 2
    with torch.no_grad():
        out = sharded_rasterize_batch(
            gs, inputs["w2cs"][:1], inputs["Ks"][:1], mesh=mesh,
            background=inputs["bg"][:1], exchange_capacity=cap, **kw)
    return {"overflow": out["overflow"],
            "exchange_pairs": out["exchange_pairs"],
            "live_pairs": torch.tensor(stats["live_pairs"]),
            "capacity": torch.tensor(cap)}


def ring_attention(inputs) -> dict:
    """``ring_blockwise_attention`` over the 4 ranks: this rank's rows."""
    from guassianhand_tpu_torch.ops.blockwise_attention import (
        ring_blockwise_attention)
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    n = inputs["ring_q"].shape[0] // WORLD
    rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    out = ring_blockwise_attention(
        inputs["ring_q"][rows], inputs["ring_k"][rows],
        inputs["ring_v"][rows], inputs["ring_mask"][rows], mesh.model_group,
        WORLD)
    return {"out": out}


TRAINABLES = ("color_w", "opacity_b", "map_bias", "color_b",
              "identity_code_one_shot")


def perturb_trainables(model) -> None:
    """Seeded noise on TRAINABLES: the maps start at 0, where the
    regularisers' gradients vanish and would hide a miscount of them."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name in TRAINABLES:
            p = getattr(model, name)
            p.add_(0.05 * torch.randn(p.shape, generator=gen))


def capture_grads(model, optimizer) -> dict:
    """A dict that the optimizer's next step fills with the gradients it
    is given (``grad_<name>`` for TRAINABLES)."""
    out = {}

    def hook(opt, args, kwargs):
        for name in TRAINABLES:
            out[f"grad_{name}"] = getattr(model, name).grad.detach().clone()

    optimizer.register_step_pre_hook(hook)
    return out


def fit_step(exchange: bool, static: bool) -> dict:
    """One sharded fit step of the tiny model (vgg 0) on data 2 x model 2,
    B = 2 (poses from seeds 0 and 1, one a data shard): loss, the updated color_w, opacity_b and map_bias, the
    exchange figures."""
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.parallel.dryrun import (HW, tiny_batch,
                                                        tiny_config)
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    from guassianhand_tpu_torch.parallel.step import (make_sharded_fit_step,
                                                      shard_batch)
    from guassianhand_tpu_torch.train.fit import (FitConfig,
                                                  attach_static_features,
                                                  make_optimizer)
    from guassianhand_tpu_torch.train.losses import LossWeights
    mesh = make_mesh(n_data=2)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, renderer=dataclasses.replace(
        cfg.renderer, sharded_exchange=exchange,
        sharded_exchange_required=exchange))
    model = build_model(cfg, seed=0, device="cpu")
    perturb_trainables(model)
    fit_cfg = FitConfig(weights=LossWeights(vgg=0.0))
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    batch = tiny_batch(2, "cpu")
    if static:
        batch = attach_static_features(model, batch)
    step = make_sharded_fit_step(model, None, optimizer, mesh, fit_cfg,
                                 height=HW, width=HW, scheduler=scheduler)
    grads = capture_grads(model, optimizer)
    loss, err = step(shard_batch(batch, mesh))
    res = {"loss": loss, "overflow": err["overflow"], **grads}
    if exchange:
        res["exchange_pairs"] = err["exchange_pairs"]
    for name in ("color_w", "opacity_b", "map_bias"):
        res[name] = getattr(model, name).detach()
    return res


def fit_step_plain_static(inputs) -> dict:
    return fit_step(exchange=False, static=True)


def fit_step_exchange(inputs) -> dict:
    return fit_step(exchange=True, static=False)


def dryrun(inputs) -> dict:
    """``parallel/dryrun.py``'s step, in this spawn."""
    from guassianhand_tpu_torch.parallel.dryrun import dryrun_step
    return {"json": np.frombuffer(json.dumps(dryrun_step("cpu")).encode(),
                                  np.uint8)}


CASES = (render_multiview_2x2, render_multiview_1x4, render_single_view,
         capacity_overflow, ring_attention, fit_step_plain_static,
         fit_step_exchange, dryrun)


def run_rank(rank: int, tmp: str) -> None:
    from guassianhand_tpu_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    initialize_distributed("file://" + os.path.join(tmp, "rendezvous"),
                           WORLD, rank, backend="gloo")
    try:
        inputs = {k: torch.from_numpy(v) for k, v in
                  np.load(os.path.join(tmp, "inputs.npz")).items()}
        out = {}
        for case in CASES:
            for k, v in case(inputs).items():
                out[f"{case.__name__}/{k}"] = np.asarray(
                    v.detach() if isinstance(v, torch.Tensor) else v)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_cases(tmp: str):
    """Starts the WORLD ranks; ``.join()`` the returned context."""
    import torch.multiprocessing as mp
    return mp.start_processes(run_rank, args=(tmp,), nprocs=WORLD,
                              join=False, start_method="spawn")


def load_results(tmp: str) -> list:
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(WORLD)]

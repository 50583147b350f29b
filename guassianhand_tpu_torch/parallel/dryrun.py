"""One full sharded fit step over n ranks on tiny shapes (the port's twin of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

  python -c "from guassianhand_tpu_torch.parallel.dryrun import \\
      dryrun_multichip; dryrun_multichip(4, device='cpu')"

spawns ``n_devices`` gloo ranks (``file://`` rendezvous in a temporary
directory), builds the JAX dryrun's tiny model on each from one seed, and
runs one step of ``make_sharded_fit_step`` on a mesh of data 2 x model
n/2 with ``sharded_exchange_required``: a fallback to the unsharded render
raises. It asserts what the JAX dryrun asserts (the exchange collective
ran, the ranks received live pairs, the loss is finite) and prints its two
lines.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

HW = 32
# seconds the ranks of dryrun_multichip may take before they are killed
DRYRUN_TIMEOUT_S = 600


def tiny_config():
    """The JAX dryrun's and tests/test_parallel.py's model config, with the
    exchange required (no parameter depends on the renderer flags)."""
    from guassianhand_tpu_torch.models.one_shot import OneShotConfig
    from guassianhand_tpu_torch.render.renderer import RendererConfig
    return OneShotConfig(
        camera_embed_dim=32, pose_embed_dim=32, plane_size=8,
        token_channels=32, backbone_layers=1, backbone_heads=2,
        backbone_head_dim=16, residual_map_hw=(32, 64), interaction_k=8,
        renderer=RendererConfig(sharded_exchange=True,
                                sharded_exchange_required=True))


def tiny_batch(n_samples: int, device: str):
    """``n_samples`` batches of the 64-vertex synthetic scene at HW^2, posed
    from seeds 0 .. n_samples - 1, along the batch axis: each data shard
    gets a sample of its own, so a data-parallel fault cannot hide behind
    equal shards."""
    from guassianhand_tpu_torch.data.synthetic import (SyntheticHandScene,
                                                       synthetic_batch)
    scene = SyntheticHandScene.build(n_vertices=64, subdivide=1, height=HW,
                                     width=HW, device=device)
    samples = [synthetic_batch(scene, seed=s, with_target=True)
               for s in range(n_samples)]
    return {k: torch.cat([b[k] for b in samples]) for k in samples[0]}


def dryrun_step(device: str) -> dict:
    """One sharded fit step on the initialised job (every rank calls it).
    Returns the loss, the err dict's exchange figures, the mesh and the
    collectives counted during the step."""
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.parallel import comm
    from guassianhand_tpu_torch.parallel.mesh import make_mesh
    from guassianhand_tpu_torch.parallel.step import (make_sharded_fit_step,
                                                      shard_batch)
    from guassianhand_tpu_torch.train.fit import FitConfig, make_optimizer
    from guassianhand_tpu_torch.train.losses import LossWeights
    n = dist.get_world_size()
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n_data=n_data)
    model = build_model(tiny_config(), seed=0, device=device)
    fit_cfg = FitConfig(weights=LossWeights(vgg=0.0))
    optimizer, scheduler = make_optimizer(model, fit_cfg)
    step = make_sharded_fit_step(model, None, optimizer, mesh, fit_cfg,
                                 height=HW, width=HW, scheduler=scheduler)
    batch = shard_batch(tiny_batch(n_data, device), mesh)
    comm.stats.reset()
    loss, err = step(batch)
    return {"mesh": mesh.shape, "loss": float(loss),
            "exchange_pairs": [int(x) for x in err["exchange_pairs"]],
            "overflow": int(err["overflow"]), "comm": comm.stats.snapshot()}


def dryrun_rank(rank: int, n_devices: int, device: str, init: str,
                out_dir: str) -> None:
    """The spawned rank: joins the job, runs ``dryrun_step``, writes its
    result to ``out_dir/rank{rank}.json``."""
    from guassianhand_tpu_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    initialize_distributed(init, n_devices, rank, backend="gloo")
    try:
        result = dryrun_step(device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def check_dryrun(result: dict) -> None:
    """The JAX dryrun's assertions on rank 0's result."""
    calls = result["comm"].get("all_to_all", {}).get("calls", 0)
    if calls < 1:
        raise AssertionError("the sharded step ran no all_to_all: the "
                             "Gaussian<->tile exchange did not run")
    xp = result["exchange_pairs"]
    if sum(xp) <= 0:
        raise AssertionError(f"exchange ran but moved zero live pairs: {xp}")
    if not torch.isfinite(torch.tensor(result["loss"])):
        raise AssertionError(f"non-finite loss {result['loss']}")


def join(ctx, seconds: float) -> None:
    """Waits for every process of the spawn context ``ctx``
    (``torch.multiprocessing.start_processes(..., join=False)``): a rank
    that fails raises here and the others are killed; after ``seconds``
    the ranks still running are killed and TimeoutError raised."""
    deadline = time.monotonic() + seconds
    # join returns False while any rank still runs
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the ranks did not finish in {seconds} s")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Spawn ``n_devices`` gloo ranks (all on ``cuda:0`` with
    device="cuda"), run one sharded fit step, check it and print JAX's two
    lines. Returns rank 0's result."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            dryrun_rank, args=(n_devices, device,
                               "file://" + os.path.join(tmp, "rendezvous"),
                               tmp),
            nprocs=n_devices, join=False, start_method="spawn")
        join(ctx, DRYRUN_TIMEOUT_S)
        with open(os.path.join(tmp, "rank0.json")) as f:
            result = json.load(f)
    check_dryrun(result)
    xp = result["exchange_pairs"]
    a2a = result["comm"]["all_to_all"]
    print(f"dryrun_multichip({n_devices}) ok: mesh={result['mesh']} "
          f"loss={result['loss']:.5f}")
    print(f"exchange evidence: {a2a['calls']} all_to_all calls "
          f"({a2a['bytes']} bytes sent by rank 0); live pairs received per "
          f"device = {xp} (total {sum(xp)}), overflow={result['overflow']}")
    return result


"""fit_loop: one one-shot fit of one reference image, steps back to back.

Set-up builds the fit the way ``train/fit.py::fit`` builds it (the
program's model, VGG loss, Adam and step, the fit-constant prefix computed
once) from weights and a target the benchmark draws from the seed, and
drives that same step object through its first ``checked_steps`` steps,
recording what the check compares: each step's loss terms, the first
step's render (read by a forward hook), the first gradient as Adam holds
it (its first moment over 1 - beta1) and the parameters' change after the
checked steps. The window then runs the same step on the same batch until
the time is up. The check runs the reference fit from the same weights
and batch after the program's state is freed.

Traffic keys: height, width, pose_scale, checked_steps, warmup_steps,
trace_seconds.
"""
from __future__ import annotations

import gc
import sys
from typing import Dict

import torch

from benchmark.harness import oneshot

# the interaction attention's heads (nn/heads.py::SelfAttn)
SELF_ATTN_HEADS = 4
TERMS = ("loss", "e_pix_l1", "mask_loss", "e_vgg", "reg")


def make_batch(run) -> Dict[str, torch.Tensor]:
    """The fit's batch (B = 1, V = 1): the synthetic two-hand scene in the
    pose drawn from the seed, its target image and mask rendered by the
    reference rasterizer from the scene's fixed Gaussian decoration."""
    from benchmark.reference.data.synthetic import (SyntheticHandScene,
                                                    synthetic_batch)
    sc, t = run.config["scene"], run.traffic
    scene = SyntheticHandScene.build(
        sc["mesh"], subdivide=sc["subdivide"], height=t["height"],
        width=t["width"], seed=sc["scene_seed"], device=run.device)
    with torch.no_grad():
        return synthetic_batch(scene, seed=oneshot.np_seed(run.seed),
                               pose_scale=t["pose_scale"], with_target=True,
                               separation=sc["separation"])


class State:
    pass


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def setup(run) -> State:
    from guassianhand_tpu_torch.train.fit import (attach_static_features,
                                                  make_fit_step,
                                                  make_optimizer)
    cfg, t, dev = run.config, run.traffic, run.device
    oneshot.set_env(cfg)
    exp = oneshot.program_config(cfg)
    s = State()
    run.mark("imports")
    s.batch = make_batch(run)
    run.mark("scene and target")
    s.model = oneshot.program_model(cfg, run.seed, dev)
    s.vgg = oneshot.program_vgg(run.seed, dev)
    run.mark("model and vgg")
    s.batch_static = attach_static_features(s.model, s.batch)
    s.optimizer, scheduler = make_optimizer(s.model, exp.fit)
    s.step = make_fit_step(s.model, s.vgg, s.optimizer, scheduler, exp.fit,
                           height=t["height"], width=t["width"])
    s.n_live = int(s.batch["inter_mask"].sum())
    s.n_points = int(s.batch["points"].shape[1])
    names = {p: n for n, p in s.model.named_parameters() if p.requires_grad}
    p0 = {n: p.detach().clone() for p, n in names.items()}
    first = {}

    def keep_render(mod, inp, out):
        first["out"] = (out["comp_rgb"][0, 0].detach().clone(),
                        out["comp_mask"][0, 0].detach().clone())

    hook = s.model.register_forward_hook(keep_render)
    s.losses, s.grad1 = [], {}
    beta1 = s.optimizer.param_groups[0]["betas"][0]
    for i in range(t["checked_steps"]):
        loss, err = s.step(s.batch_static)
        s.losses.append({"loss": float(loss),
                         **{k: float(err[k]) for k in TERMS[1:] if k in err}})
        if i == 0:
            hook.remove()
            s.grad1 = _leaf_norms({
                names[p]: st["exp_avg"] / (1.0 - beta1)
                for p, st in s.optimizer.state.items()})
    run.mark("checked steps")
    s.render1 = first["out"]
    s.change = _leaf_norms({n: p.detach() - p0[n]
                            for p, n in names.items()})
    del p0
    for _ in range(t["warmup_steps"]):
        s.step(s.batch_static)
    run.mark("warm-up steps")
    return s


def window(s: State, run) -> dict:
    n = failed = 0
    while not run.expired():
        s.step(s.batch_static)
        n += 1
    seconds = run.stop()
    return {"e2e": {"fit_steps_per_s": n / seconds}, "attempted": n,
            "failed": failed, "layer": {"steps": n}}


def free_program(s: State) -> None:
    for k in ("model", "vgg", "batch_static", "optimizer", "step"):
        if hasattr(s, k):
            delattr(s, k)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_fit(run, s: State, loss_patch=None) -> dict:
    from benchmark.reference.train.fit import fit_steps
    _, fit_cfg = oneshot.reference_configs(run.config)
    model = oneshot.reference_model(run.config, run.seed, run.device)
    vgg = oneshot.reference_vgg(run.seed, run.device)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    r = fit_steps(model, vgg, s.batch, run.traffic["checked_steps"], fit_cfg,
                  height=run.traffic["height"], width=run.traffic["width"],
                  loss_patch=loss_patch)
    r["change"] = _leaf_norms({k: v - p0[k] for k, v in r["params"].items()})
    r["grad1"] = _leaf_norms(r["grads"])
    del model, vgg, p0
    return r


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check holds to their limits.

    loss_rel: the largest relative gap of a loss term over the checked
    steps. render_gap: the largest gap of the first step's image or mask.
    grad_gap, change_gap: the worst leaf's gap between the norms of the
    first gradient and of the change after the checked steps, against
    the larger of that leaf's reference norm and the median leaf's, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by rounding alone). The
    change is compared for every other trainable leaf too: one the
    reference leaves unmoved must not move."""
    loss_rel = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]) for k in r
                   if k in p)
    render_gap = max(float((prog["render1"][0] - ref["comp_rgb"]).abs().max()),
                     float((prog["render1"][1] - ref["comp_mask"]).abs().max()))
    g = ref["grad1"]
    vals = sorted(g.values())
    med = vals[len(vals) // 2]
    small = {k for k, v in g.items() if v < 1e-3 * med}
    print(f"[check] first-gradient norms {g!r}; left out {sorted(small)}",
          file=sys.stderr)
    grad_gap = oneshot.worst_leaf_gap(
        {k: prog["grad1"].get(k, 0.0) for k in g if k not in small},
        {k: v for k, v in g.items() if k not in small})
    change_ref = {k: v for k, v in ref["change"].items() if k not in small}
    change_gap = oneshot.worst_leaf_gap(
        {k: prog["change"].get(k, 0.0) for k in change_ref}, change_ref)
    return {"loss_rel": loss_rel, "render_gap": render_gap,
            "grad_gap": grad_gap, "change_gap": change_gap}


def program_record(s: State) -> dict:
    return {"losses": s.losses, "render1": s.render1, "grad1": s.grad1,
            "change": s.change}


def check(s: State, run) -> Dict[str, float]:
    from benchmark.reference import precision
    free_program(s)
    precision.set_mode("reference")
    ref = reference_fit(run, s)
    s.work = ref["work"]
    return compare(program_record(s), ref)


def counts(s: State, run, win: dict) -> dict:
    from benchmark.counts import flops
    t = run.traffic
    per_step = flops.fit_step(run.config, s.n_points, s.n_live, t["height"],
                              t["width"], s.work["forward_ops"],
                              s.work["backward_ops"])
    width = flops.model_shapes(run.config)[
        "renderer.self_attn_layer.w_qs.weight"][0]
    return {"flops_per_step": per_step, "k5_rows": s.n_live,
            "k5_heads": SELF_ATTN_HEADS,
            "k5_head_dim": width // SELF_ATTN_HEADS}


def _half_rows(pred_rgb, target_rgb, pred_mask, target_mask):
    """The losses over the first half of the image's rows alone."""
    h = pred_rgb.shape[1] // 2
    return (pred_rgb[:, :h], target_rgb[:, :h], pred_mask[:, :h],
            target_mask[:, :h])


FAULTS = {"half_batch": _half_rows}


def control(run, fault=None) -> Dict[str, float]:
    """The check's numbers with the reference in the program's place:
    computed one precision step down (``reference/precision.py``), or in
    float32 with a planted ``fault`` of ``FAULTS``."""
    from benchmark.reference import precision
    s = State()
    s.batch = make_batch(run)
    precision.set_mode("reference" if fault else "control")
    c = reference_fit(run, s, loss_patch=FAULTS[fault] if fault else None)
    prog = {"losses": c["losses"], "render1": (c["comp_rgb"], c["comp_mask"]),
            "grad1": c["grad1"], "change": c["change"]}
    del c
    precision.set_mode("reference")
    return compare(prog, reference_fit(run, s))

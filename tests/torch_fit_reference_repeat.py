"""How far chip_smoke.py's small card-vs-CPU fit parts, run after run, and
which operation of the step parts it (not a test). Needs a CUDA card.

    python3 tests/torch_fit_reference_repeat.py [runs] [--trace]
        [--cpu-threads N,M,...] [--probe]

For each route (default, and with both kernel switches on) it runs the
2-step fit of ``phase_fit_reference`` from one seeded batch and seeded
weights (initialised on the card, as ``phase_fit_reference`` does) on the
CPU, twice at torch's default thread count or once at each thread count of
``--cpu-threads``, and ``runs`` times (default 4) on the card, and prints
one JSON line a comparison (``compare_fits`` of each step): each CPU run
against the first, each card run against the first CPU run (what
``phase_fit_reference`` checks), and each card run against the first card
run. The ``at_element`` line gives the second step's gradient of the
element that takes one of two values (``WATCH``) in every run.

With ``--trace`` every run also records each operation of its two steps
(forward, backward and the update, through a TorchDispatchMode): the name,
and of each tensor it returns a digest of its bits, and for the operations
that decide inside (ReLU, clamp, maximum and minimum, scatter_reduce amax
and amin) the decision as a mask. Runs on one device run the same
operations in the same order, so the first operation whose digest differs
between two of them is where they part (``first_apart``), and the
comparisons, selections and roundings among them (``DECIDING``) and the
hidden decisions are the decisions that went another way
(``decisions_apart``), each with the port's line and module that made it;
for a hidden decision, the elements it took apart and their inputs in both
runs (``gates``). ``--probe`` first counts how many distinct results the
card gives in repeated calls of the point encoder's scatter reductions and
of the fit's static features.
"""
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

# the element of the small fit's second step that takes one of two values
WATCH = ("identity_code_one_shot", 15613)


# operations that decide: comparisons, selections and roundings to an index
DECIDING = ("aten.eq.", "aten.ne.", "aten.lt.", "aten.le.", "aten.gt.",
            "aten.ge.", "aten.argmax", "aten.argmin", "aten.max.dim",
            "aten.min.dim", "aten.sort", "aten.topk", "aten.searchsorted",
            "aten.nonzero", "aten.floor", "aten.ceil", "aten.round",
            "aten.sign")


SELECTING = ("aten.sort", "aten.topk", "aten.max.dim", "aten.min.dim")


class OpTrace(TorchDispatchMode):
    """Each operation's name and a digest of every tensor it returns: the
    sum of the tensor's bits as integers, position-weighted, so that a
    change of any value or of its place shows. A hidden decision keeps its
    mask and input too, and every decision the module of ``model`` that
    made it."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.ops = []
        self.kept = {}
        self._weights = {}
        names = {id(m): n for n, m in model.named_modules()}
        self._modules = []

        def enter(module, args):
            self._modules.append(names.get(id(module), "?"))

        def leave(module, args, out):
            self._modules.pop()
        self._hooks = [
            torch.nn.modules.module.register_module_forward_pre_hook(enter),
            torch.nn.modules.module.register_module_forward_hook(leave)]

    def remove_hooks(self):
        for h in self._hooks:
            h.remove()

    def _where(self) -> str:
        module = self._modules[-1] if self._modules else "backward"
        return f"{module} ({caller()})"

    def _digest(self, t: torch.Tensor):
        if t.numel() == 0 or t.is_sparse:
            return None
        flat = t.detach().reshape(-1)
        if flat.dtype.is_floating_point:
            flat = flat.float().view(torch.int32)
        key = (flat.numel(), flat.device)
        if key not in self._weights:
            self._weights[key] = (torch.arange(flat.numel(), device=flat.device)
                                  % 8191 + 1)
        return (flat.long() * self._weights[key]).sum()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        name = str(func)
        # an empty* op's output holds whatever the memory held
        fresh = "empty" in name
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.ops.append((name, str(t.dtype), tuple(t.shape),
                                 None if fresh else self._digest(t),
                                 self._where() if name.startswith(DECIDING)
                                 else None))
        mask = hidden_decision(name, args, kwargs, out)
        if mask is not None:
            self.kept[len(self.ops)] = (mask.detach().cpu(),
                                        args[0].detach().cpu())
            self.ops.append((f"{name}#decision", str(mask.dtype),
                             tuple(mask.shape), self._digest(mask),
                             self._where()))
        return out

    def records(self):
        return [(name, dtype, shape, None if d is None else int(d), where)
                for name, dtype, shape, d, where in self.ops]


def hidden_decision(name: str, args, kwargs, out):
    """The decision an operation with a float output takes inside, as a
    bool tensor: which inputs a ReLU passes, which a clamp leaves as they
    are, which side a maximum or minimum takes, and which inputs a
    scatter_reduce amax or amin takes as the maximum (the one its backward
    routes the gradient to). None for any other operation."""
    if name.startswith("aten.relu"):
        return out > 0
    if name.startswith("aten.clamp"):
        return out == args[0]
    if name.startswith(("aten.maximum", "aten.minimum")):
        return args[0] == out
    if name.startswith("aten.scatter_reduce") and len(args) > 4 \
            and args[4] in ("amax", "amin"):
        _, dim, index, src = args[:4]
        return src == out.gather(dim, index)
    return None


def caller() -> str:
    """The innermost frame of the port's package that called the current
    operation ("autograd" in the backward, which has no Python frame)."""
    for frame in reversed(traceback.extract_stack()):
        if "guassianhand_tpu_torch" in frame.filename:
            return f"{Path(frame.filename).name}:{frame.lineno}"
    return "autograd"


def two_steps(device: str, kernels: bool, batch, trace: bool,
              threads=None) -> tuple:
    """The two fit steps on ``device`` (the CPU at ``threads`` threads when
    given), traced when ``trace``: (steps, initial parameters, trace)."""
    saved = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        fit = cs.FitReference(device, kernels, batch)
        if not trace:
            return [fit.step(), fit.step()], fit.initial, None
        tracer = OpTrace(fit.model)
        try:
            with tracer:
                first = fit.step()
                second_from = len(tracer.ops)
                steps = [first, fit.step()]
        finally:
            tracer.remove_hooks()
        return steps, fit.initial, (tracer.records(), second_from,
                                    tracer.kept)
    finally:
        torch.set_num_threads(saved)


def first_apart(trace_a, trace_b, decisions: int = 12) -> dict:
    """Where two traces of one device part: the first operation whose
    digests differ, and the first ``decisions`` deciding operations
    (``DECIDING``) that differ, each with its step (1 or 2), its caller
    and the operations just before it."""
    (a, second_from, kept_a), (b, _, kept_b) = trace_a, trace_b
    out = {"ops": [len(a), len(b)], "second_step_from": second_from,
           "decisions_apart": [], "gates": []}

    def where(i):
        return {"index": i, "step": 1 if i < second_from else 2,
                "op": a[i][0], "dtype": a[i][1], "shape": a[i][2],
                "caller": a[i][4],
                "before": [r[0] for r in a[max(0, i - 4):i]]}
    for i, (x, y) in enumerate(zip(a, b)):
        if x[:3] != y[:3]:
            out["sequence_apart"] = {"index": i, "a": x[:3], "b": y[:3]}
            break
        if x[3] != y[3]:
            out.setdefault("first_apart", where(i))
            # a sort's or a max's values move with its inputs: only its
            # indices decide
            if (x[0].startswith(DECIDING) and not (
                    x[0].startswith(SELECTING) and "float" in x[1])) \
                    or i in kept_a:
                out["decisions_apart"].append(where(i))
                if i in kept_a:
                    out["gates"].append(gates(i, kept_a[i], kept_b[i]))
                if len(out["decisions_apart"]) == decisions:
                    break
    return out


def gates(index: int, kept_a, kept_b, most: int = 5) -> dict:
    """The elements where a hidden decision went apart, with its input in
    both runs and the input's largest magnitude."""
    (mask_a, in_a), (mask_b, in_b) = kept_a, kept_b
    apart = (mask_a != mask_b).nonzero()
    return {"index": index, "elements": apart.shape[0],
            "input_abs_max": float(in_a.abs().max()),
            "first": [{"element": e.tolist(),
                       "input": [float(in_a[tuple(e)]), float(in_b[tuple(e)])]}
                      for e in apart[:most]]}


def at_element(steps) -> float:
    name, index = WATCH
    return float(steps[1][2][name].flatten()[index])


def probe(batch, calls: int = 10) -> dict:
    """How many distinct results the card gives in ``calls`` calls of the
    point encoder's scatter reductions (a (570, 128) input into 64 cells,
    as the small model's) and of the fit's static features (the shade
    branch, computed once a fit before its first step)."""
    from guassianhand_tpu_torch.models.one_shot import build_model
    from guassianhand_tpu_torch.nn import pointnet
    from guassianhand_tpu_torch.train.fit import attach_static_features
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.normal(size=(1, 570, 128)).astype(np.float32),
                        device="cuda")
    cell = torch.as_tensor(rng.randint(0, 64, (1, 570)), device="cuda")

    def distinct(results):
        return len({r.cpu().numpy().tobytes() for r in results})
    out = {f"scatter_{reduce}": distinct(
        [pointnet._scatter(x, cell, 64, reduce) for _ in range(calls)])
        for reduce in ("mean", "sum", "amax")}
    model = build_model(cs.reference_config(), seed=0, device="cuda")
    on_card = {k: v.to("cuda") for k, v in batch.items()}
    static = [attach_static_features(model, on_card)["static_feats"]
              for _ in range(calls)]
    out["static_features"] = {k: distinct([s[k] for s in static])
                              for k in static[0]}
    return {"calls": calls, "distinct": out}


def main(runs: int, trace: bool, cpu_threads, with_probe: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    batch = cs.fit_reference_batch()
    if with_probe:
        print(json.dumps({"probe": probe(batch)}), flush=True)
    for kernels in (False, True):
        cpu = [two_steps("cpu", kernels, batch, trace, t)
               for t in cpu_threads]
        card = [two_steps("cuda", kernels, batch, trace)
                for _ in range(runs)]
        print(json.dumps({"kernels": kernels, "at_element": {
            "element": list(WATCH), "cpu_threads": cpu_threads,
            "cpu": [at_element(c[0]) for c in cpu],
            "card": [at_element(c[0]) for c in card]}}), flush=True)
        pairs = [(f"cpu{i}_vs_cpu0", c, cpu[0])
                 for i, c in enumerate(cpu[1:], 1)]
        pairs += [(f"card{i}_vs_cpu0", c, cpu[0]) for i, c in enumerate(card)]
        pairs += [(f"card{i}_vs_card0", c, card[0])
                  for i, c in enumerate(card[1:], 1)]
        for name, (run, _, tr_a), (ref, initial, tr_b) in pairs:
            steps = [cs.compare_fits(a, b, initial) for a, b in zip(run, ref)]
            line = {"kernels": kernels, "pair": name, "steps": steps}
            if trace and not name.endswith("vs_cpu0") \
                    or trace and name.startswith("cpu"):
                line["trace"] = first_apart(tr_a, tr_b)   # one device
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("runs", nargs="?", type=int, default=4)
    parser.add_argument("--trace", action="store_true")
    parser.add_argument("--probe", action="store_true",
                        help="first count the distinct results of repeated "
                             "calls of the card's scatter reductions")
    parser.add_argument("--cpu-threads", default=None,
                        help="comma-separated thread counts, one CPU run each "
                             "(default: two runs at torch's default)")
    args = parser.parse_args()
    main(args.runs, args.trace,
         [int(t) for t in args.cpu_threads.split(",")]
         if args.cpu_threads else [None, None], args.probe)

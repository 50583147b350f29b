"""K1's training mode against its plain twin at the stop threshold, on the
card (needs a CUDA card; no JAX):

  PYTHONPATH=. python3 tests/torch_stop_flips.py [--reps 12]

The flagship model (configs/one_shot.yaml, seed 0, both switches) renders
each of the 15 frames of tests/torch_interhand_layout.py's full-width
layout (the one-shot frame and oneshot_reg_i's 14); each frame's composite
inputs go through ``composite_forward(..., store_contrib=True)`` and
``composite_plain`` as they are and ``reps - 1`` times with every
attribute scaled by 1 + 1e-5 noise (seeded), which moves the stops that sit
within rounding of T_EPS. Both sides take T's product one fp32 multiply a
pair in order, so n_contrib must agree at every pixel. Prints one JSON
line: the comparisons, the pixels whose n_contrib differs ([frame, rep, y,
x], both n_contrib and both final T) and the pixels whose final T ends
within 0.1 % above T_EPS on both sides (the stops the noise reached).
Exits 1 if any pixel differs.
"""
import argparse
import json
import sys
import tempfile

import torch

import chip_smoke
from guassianhand_tpu_torch.cli.fit_one_shot import interhand_dataset
from guassianhand_tpu_torch.config import load_config
from guassianhand_tpu_torch.models.one_shot import build_model
from guassianhand_tpu_torch.ops import rasterize_cuda as rc
from guassianhand_tpu_torch.ops.common import T_EPS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=12)
    args = parser.parse_args(argv)
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    hw = chip_smoke.HW
    with tempfile.TemporaryDirectory() as root:
        layout = chip_smoke.interhand_layout().write_interhand_layout(
            root, hw=hw)
        cfg = load_config(str(chip_smoke.REPO / "configs" / "one_shot.yaml"), [
            f"data.data_root={layout['data_root']}",
            f"data.annot_path={layout['annot_path']}",
            f"data.mano_models_path={layout['mano']}",
            "data.pose_sequence=oneshot_reg_i",
            "model.renderer.raster.projection_impl=pallas"])
        model = build_model(cfg.model, seed=0, device="cuda")
        dataset = interhand_dataset(cfg, "test", "cuda", hw, hw)
        frames = [interhand_dataset(cfg, "train", "cuda", hw,
                                    hw).load_sample(0)]
        frames += [dataset.load_sample(i) for i in range(len(dataset))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = {"height": hw, "width": hw}
    rows, comparisons, near = [], 0, 0
    with chip_smoke.flash_switch(True):
        for f, batch in enumerate(frames):
            inputs = chip_smoke.kernel_inputs(model, batch)["inputs"]
            attrs = inputs.attrs.contiguous()
            for rep in range(args.reps):
                a = attrs if rep == 0 else (attrs * (1 + 1e-5 * torch.randn(
                    attrs.shape, device="cuda", generator=gen))).contiguous()
                _, t_k, nc_k, _, _ = rc.composite_forward(
                    inputs.tile_range, inputs.pair_gid, a, **kw,
                    store_contrib=True)
                _, t_p, nc_p, _, _ = rc.composite_plain(
                    inputs.tile_range, inputs.pair_gid, a, **kw,
                    store_contrib=True)
                comparisons += 1
                near += int(((t_k <= T_EPS * (1 + 1e-3))
                             & (t_p <= T_EPS * (1 + 1e-3))).sum())
                for y, x in (nc_k != nc_p).nonzero().tolist():
                    rows.append({"at": [f, rep, y, x],
                                 "n_contrib": [int(nc_k[y, x]),
                                               int(nc_p[y, x])],
                                 "final_t": [float(t_k[y, x]),
                                             float(t_p[y, x])]})
    print(json.dumps({"comparisons": comparisons, "mismatched": len(rows),
                      "final_t_within_0.1pct_of_t_eps": near,
                      "pixels": rows}))
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())

"""Port the reference's torch checkpoint into the port's checkpoint format
(counterpart of ``cli/port_checkpoint.py``): run once on the reference's
``pretrain_model.ckpt``, then point ``pretrained:`` at the output, which
``cli/fit_one_shot.py`` loads with strict=False semantics
(``train/checkpoints.load_params_partial``).

    python -m guassianhand_tpu_torch.cli.port_checkpoint \\
        --torch_ckpt ./EXPERIMENTS/pretrain_model.ckpt \\
        --out ./EXPERIMENTS/pretrain_model.port.ckpt [--backbone_layers 10]

Prints the unmapped source keys (``compat/torch_port.py`` says which are
expected). ``--dinov2`` (a DINOv2 backbone for the image tokenizer) is
refused: ``nn/image_tokenizer.py`` is not ported.
"""
from __future__ import annotations

import argparse
import sys

import torch

from guassianhand_tpu_torch.compat.torch_port import port_reference_checkpoint
from guassianhand_tpu_torch.train.checkpoints import write_checkpoint

DINOV2_REFUSAL = ("--dinov2 maps a DINOv2 backbone into nn/image_tokenizer.py, "
                  "which the port does not have yet (ROADMAP Queue A item 12)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "guassianhand-tpu-torch port_checkpoint",
        description="port the reference's pretrain_model.ckpt")
    parser.add_argument("--torch_ckpt", required=True,
                        help="the reference's pretrain_model.ckpt")
    parser.add_argument("--out", required=True,
                        help="the port's checkpoint to write")
    parser.add_argument("--dinov2", default=None, help="refused: " +
                        DINOV2_REFUSAL)
    parser.add_argument("--backbone_layers", type=int, default=10)
    args = parser.parse_args(argv)
    if args.dinov2:
        parser.error(DINOV2_REFUSAL)

    # a Lightning checkpoint pickles more than tensors (its hyper-parameters
    # and loop state), so it is read in full, as the reference reads it
    raw = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    params, unmapped = port_reference_checkpoint(
        raw.get("state_dict", raw), backbone_layers=args.backbone_layers)
    write_checkpoint(args.out, params, keep_last_link=False)
    print(f"ported {len(params)} tensors -> {args.out}")
    if unmapped:
        generator = sum(k.startswith("pointcloud_generator.")
                        for k in unmapped)
        print(f"unmapped source keys ({len(unmapped)}; {generator} of the "
              f"point-cloud generator, which waits for "
              f"models/point_generator.py):")
        for k in unmapped:
            print(f"  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

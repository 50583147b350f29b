"""Port the reference's torch checkpoint into the port's checkpoint format
(counterpart of ``cli/port_checkpoint.py``): run once on the reference's
``pretrain_model.ckpt``, then point ``pretrained:`` at the output, which
``cli/fit_one_shot.py`` loads with strict=False semantics
(``train/checkpoints.load_params_partial``).

    python -m guassianhand_tpu_torch.cli.port_checkpoint \\
        --torch_ckpt ./EXPERIMENTS/pretrain_model.ckpt \\
        --out ./EXPERIMENTS/pretrain_model.port.ckpt [--backbone_layers 10] \\
        [--dinov2 dinov2-base.bin]

``--dinov2`` takes a Hugging Face ``facebook/dinov2-base`` state dict and
ports it into the point-cloud generator's image tokenizer
(``pointcloud_generator.image_tokenizer.model.*``). Prints the unmapped
source keys, the DINOv2 ones prefixed ``dinov2:``. The generator in the
output loads with ``compat/torch_port.load_point_generator(path)``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from guassianhand_tpu_torch.compat.torch_port import (GENERATOR,
                                                      port_dinov2_backbone,
                                                      port_reference_checkpoint)
from guassianhand_tpu_torch.train.checkpoints import write_checkpoint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "guassianhand-tpu-torch port_checkpoint",
        description="port the reference's pretrain_model.ckpt")
    parser.add_argument("--torch_ckpt", required=True,
                        help="the reference's pretrain_model.ckpt")
    parser.add_argument("--out", required=True,
                        help="the port's checkpoint to write")
    parser.add_argument("--dinov2", default=None,
                        help="a Hugging Face dinov2-base state dict to port "
                             "into the image tokenizer")
    parser.add_argument("--backbone_layers", type=int, default=10)
    args = parser.parse_args(argv)

    # a Lightning checkpoint pickles more than tensors (its hyper-parameters
    # and loop state), so it is read in full, as the reference reads it
    raw = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    params, unmapped = port_reference_checkpoint(
        raw.get("state_dict", raw), backbone_layers=args.backbone_layers)
    if args.dinov2:
        dino = torch.load(args.dinov2, map_location="cpu", weights_only=False)
        vit, dino_unmapped = port_dinov2_backbone(dino.get("state_dict", dino))
        params.update({f"{GENERATOR}image_tokenizer.{k}": v
                       for k, v in vit.items()})
        unmapped += [f"dinov2:{k}" for k in dino_unmapped]
    write_checkpoint(args.out, params, keep_last_link=False)
    print(f"ported {len(params)} tensors -> {args.out}")
    if unmapped:
        print(f"unmapped source keys ({len(unmapped)}):")
        for k in unmapped:
            print(f"  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

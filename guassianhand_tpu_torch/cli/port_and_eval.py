"""One command from the reference's artifacts to metrics (counterpart of
``cli/port_and_eval.py``): port the reference checkpoint, fit the one-shot
avatar on InterHand2.6M, and evaluate it.

    python -m guassianhand_tpu_torch.cli.port_and_eval \\
        --torch_ckpt ./EXPERIMENTS/pretrain_model.ckpt \\
        --data_root ./processed_dataset \\
        --annot_path ./InterHand2.6M/annotations \\
        [--mano ./assets/mano] [--uv ./assets/mano_uv] [--vgg19 vgg19.pth] \\
        [--lpips lpips.pth] [--dinov2 dinov2-base.bin] [--dry_run] \\
        [--steps N] [--device cpu] [key.sub=value ...]

``--dry_run`` checks every file the three stages read (that the
checkpoint's keys map, through the port's converter on the real state
dict; the annotation JSONs; the processed layout and the one-shot frame's
files; the MANO pickles; the UV atlas; the metric weights), prints the
checklist with the expected path of each, and exits 0 when every required
one is there, else 2. Without it, the stages run, each idempotent:

  1. port: ``cli/port_checkpoint.py`` (with ``--dinov2`` where given) ->
     ``<torch_ckpt>.port.ckpt`` (skipped when that file is newer than the
     source);
  2. fit: ``cli/fit_one_shot.py`` on the one-shot frame with
     ``pretrained:`` the ported checkpoint (resumes from the run's
     ``last.ckpt``);
  3. eval: ``cli/fit_one_shot.py --run_val`` over the config's
     ``data.pose_sequence`` -> ``test_metrics.yml``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys

OK, MISS, WARN = "ok", "MISSING", "warn"


class Check:
    def __init__(self, name, path, status, detail="", required=True):
        self.name, self.path = name, path
        self.status, self.detail, self.required = status, detail, required

    def row(self) -> str:
        flag = {OK: " ok ", MISS: "MISS", WARN: "warn"}[self.status]
        det = f"  ({self.detail})" if self.detail else ""
        return f"[{flag}] {self.name:34s} {self.path}{det}"


def _file(name, path, required=True, detail_missing="") -> Check:
    if path and os.path.exists(path):
        return Check(name, path, OK)
    return Check(name, path or "<not given>", MISS if required else WARN,
                 detail_missing, required)


def _checkpoint_check(args) -> Check:
    """The checkpoint's row: present, and its keys go through the port's
    converter."""
    c = _file("pretrain_model.ckpt (torch)", args.torch_ckpt,
              detail_missing="the reference's pretrained checkpoint")
    if c.status != OK:
        return c
    import torch

    from guassianhand_tpu_torch.compat.torch_port import (
        port_reference_checkpoint)
    try:
        raw = torch.load(args.torch_ckpt, map_location="cpu",
                         weights_only=False)
        sd = raw.get("state_dict", raw)
        _, unmapped = port_reference_checkpoint(
            sd, backbone_layers=args.backbone_layers)
    except Exception as e:  # a corrupt or foreign file: reported as missing
        c.status, c.detail = MISS, f"loads but does not map: {e!r}"
        return c
    c.detail = f"{len(sd)} source keys, {len(unmapped)} unmapped"
    return c


def validate(args):
    """The artifact checklist: reads files only, and runs the port's
    converter on the checkpoint when it is there."""
    from guassianhand_tpu_torch.mano.model import load_mano_model
    from guassianhand_tpu_torch.mano.uv import load_uv_atlas
    checks = [_checkpoint_check(args)]

    # the fit and the evaluation read mode "test"; "train" only the edit
    for mode, required in (("test", True), ("train", False)):
        ann = os.path.join(args.annot_path, mode)
        for stem in (f"InterHand2.6M_{mode}_joint_3d.json",
                     f"InterHand2.6M_{mode}_MANO_NeuralAnnot.json"):
            checks.append(_file(
                f"annotation ({mode})", os.path.join(ann, stem),
                required=required,
                detail_missing="" if required else "needed only for cli.edit"))

    test_base = os.path.join(args.data_root, "test")
    index_dir = os.path.join(test_base, "index_identity_test_i_one_shot")
    checks.append(_file("one-shot fit frame index",
                        os.path.join(index_dir, "2.pkl")))
    checks.append(_file("test split index (stride 10)",
                        os.path.join(index_dir, "10.pkl")))
    checks.append(_file(
        "novel-view index", os.path.join(
            test_base, "index_identity_os_i_test_nv", "0.pkl"),
        required=False,
        detail_missing="needed only for pose_sequence=oneshot_nv"))
    checks.append(_file(
        "edit fit frame index", os.path.join(
            args.data_root, "train", "index_identity0_train_i", "11388.pkl"),
        required=False, detail_missing="needed only for cli.edit"))
    for kind in ("annotation", "image", "mask"):
        checks.append(_file(f"{kind}/ tree (test)",
                            os.path.join(test_base, kind)))
    for kind in ("mask_sa", "bbox_mask"):
        checks.append(_file(f"{kind}/ tree (test)",
                            os.path.join(test_base, kind), required=False,
                            detail_missing="optional mask flavour"))

    # one frame's files, through its index record
    idx_path = os.path.join(index_dir, "2.pkl")
    if os.path.exists(idx_path):
        try:
            with open(idx_path, "rb") as f:
                rec = pickle.load(f)
            cap = rec.get("capture_id", rec.get("capture"))
            frame = rec.get("frame_idx", rec.get("frame"))
            stem = f"capture{cap}/cam{rec.get('cam')}/frame{frame}"
            checks.append(_file("fit frame annotation pkl", os.path.join(
                test_base, "annotation", f"{stem}.pkl")))
            checks.append(_file("fit frame image", os.path.join(
                test_base, "image", f"{stem}.jpg")))
        except Exception as e:  # an unreadable record: reported as missing
            checks.append(Check("fit frame record", idx_path, MISS,
                                f"unreadable: {e!r}"))

    for hand in ("right", "left"):
        found = load_mano_model(hand, args.mano) is not None
        checks.append(Check(
            f"MANO_{hand.upper()}.pkl",
            args.mano or os.environ.get("MANO_MODELS_PATH", "./assets/mano"),
            OK if found else MISS,
            "" if found else "licensed asset; set --mano or "
                             "$MANO_MODELS_PATH"))
    atlas = load_uv_atlas(args.uv) is not None
    checks.append(Check(
        "UV atlas (hand.obj + change_*.npy)",
        args.uv or os.environ.get("GH_MANO_UV_PATH", "./assets/mano_uv"),
        OK if atlas else WARN,
        "" if atlas else "falls back to the synthetic per-vertex UV "
        "(geometry as the reference's, texture layout not)",
        required=False))

    checks.append(_file("VGG19 weights (the fit's loss)", args.vgg19,
                        required=False,
                        detail_missing="the perceptual term is off without "
                                       "them"))
    checks.append(_file("LPIPS (alex) weights",
                        args.lpips or os.environ.get("GH_LPIPS_WEIGHTS"),
                        required=False,
                        detail_missing="LPIPS is not scored without them"))
    checks.append(_file("DINOv2 state dict", args.dinov2, required=False,
                        detail_missing="the point-cloud generator's image "
                                       "tokenizer is not ported without it"))
    return checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("guassianhand-tpu-torch port-and-eval")
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--data_root", default="./processed_dataset")
    parser.add_argument("--annot_path", default="./InterHand2.6M/annotations")
    parser.add_argument("--mano", default=None,
                        help="the directory of MANO_RIGHT.pkl / MANO_LEFT.pkl")
    parser.add_argument("--uv", default=None, help="the mano_uv asset dir")
    parser.add_argument("--dinov2", default=None,
                        help="a Hugging Face dinov2-base state dict for the "
                             "point-cloud generator's image tokenizer")
    parser.add_argument("--vgg19", default=None)
    parser.add_argument("--lpips", default=None)
    parser.add_argument("--backbone_layers", type=int, default=10)
    parser.add_argument("--out", default=None,
                        help="the ported checkpoint (default "
                             "<torch_ckpt>.port.ckpt)")
    parser.add_argument("--expname", default="port_and_eval")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dry_run", action="store_true")
    args, extras = parser.parse_known_args(argv)
    from guassianhand_tpu_torch.cli import port_checkpoint

    checks = validate(args)
    print("== port-and-eval artifact checklist ==")
    for c in checks:
        print(c.row())
    missing = [c for c in checks if c.status == MISS and c.required]
    degraded = [c for c in checks if c.status != OK and not c.required]
    print(f"== {len(checks) - len(missing) - len(degraded)} ok, "
          f"{len(missing)} missing (required), {len(degraded)} degraded ==")
    if missing:
        print("Cannot run: supply the required artifacts above.")
        return 2
    if args.dry_run:
        print("Dry run: all required artifacts present, ready to execute.")
        return 0

    out_ckpt = args.out or args.torch_ckpt + ".port.ckpt"
    if (os.path.exists(out_ckpt) and os.path.getmtime(out_ckpt)
            >= os.path.getmtime(args.torch_ckpt)):
        print(f"[1/3] port: {out_ckpt} is up to date, skipping")
    else:
        print(f"[1/3] port: {args.torch_ckpt} -> {out_ckpt}")
        port_argv = ["--torch_ckpt", args.torch_ckpt, "--out", out_ckpt,
                     "--backbone_layers", str(args.backbone_layers)]
        if args.dinov2:
            port_argv += ["--dinov2", args.dinov2]
        port_checkpoint.main(port_argv)

    from guassianhand_tpu_torch.cli import fit_one_shot
    overrides = [f"pretrained={out_ckpt}", f"data.data_root={args.data_root}",
                 f"data.annot_path={args.annot_path}",
                 f"expname={args.expname}"]
    for key, value in (("data.mano_models_path", args.mano),
                       ("data.mano_uv_path", args.uv),
                       ("vgg_weights", args.vgg19),
                       ("lpips_weights", args.lpips)):
        if value:
            overrides.append(f"{key}={value}")
    overrides += extras
    fit_argv = ["--device", args.device] + overrides
    if args.steps is not None:
        fit_argv = ["--steps", str(args.steps)] + fit_argv
    print("[2/3] fit: cli.fit_one_shot", " ".join(fit_argv))
    rc = fit_one_shot.main(fit_argv)
    if rc:
        return rc
    print("[3/3] eval: cli.fit_one_shot --run_val")
    rc = fit_one_shot.main(["--run_val", "--device", args.device] + overrides)
    print(f"done: test_metrics.yml in the run directory of expname "
          f"{args.expname}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

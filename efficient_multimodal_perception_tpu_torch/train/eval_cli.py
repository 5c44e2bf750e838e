"""Evaluate a config on the nuScenes validation split or on synthetic
batches (counterpart of ``tools/test.py``).

    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        triplane_occ --checkpoint DIR/checkpoints/step_3.pt \\
        --data-root data/nuscenes --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        triplane_occ --checkpoint DIR/checkpoints/step_3.pt --synthetic \\
        --val-batches 2 --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        tiny_occ --checkpoint DIR/checkpoints/step_2.pt --synthetic \\
        --val-batches 2 --device cpu
    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        triplane_elev --checkpoint DIR3/checkpoints/step_3.pt --synthetic \\
        --batch-size 2 --bf16

Without ``--synthetic`` it reads the config's ``data`` block (its
``data_root``, or ``--data-root``) through ``data/nuscenes.py``: the
first ``--num-samples`` validation samples (default: all) in batches of
``--batch-size`` in infos order, each built on the host and moved to the
device; a missing infos file raises.  With ``--synthetic`` it draws
``--val-batches`` batches from their own seeds (``evaluator.VAL_SEED``).
``--cfg-options key.sub=value`` overrides the config.
Runs on CUDA unless ``--device cpu`` is given (and raises without CUDA).
``--checkpoint`` is partial-loaded as ``tools/test.py`` loads it (every
tensor whose name and shape match; the count is printed).  Occupancy
configs print ``CE:``, ``IoU (geometry):``, one line per class and
``mIoU:``, with the reference's metric (``train/metrics.py``); elevation
configs print ``elevation MSE:`` (the masked MSE, ``tools/test.py``'s
line); pretrain configs print ``mean loss:``.
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", help="config name (e.g. triplane_occ)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data-root", default=None,
                   help="nuScenes root (default: the config's data_root)")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on generated nuScenes-shaped batches")
    p.add_argument("--num-samples", type=int, default=None,
                   help="validation samples to read (default: all)")
    p.add_argument("--val-batches", type=int, default=2,
                   help="synthetic batches (with --synthetic)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="samples per batch (default: 1)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (parameters stay float32)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="key.sub=value config overrides")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .. import resolve_device
    from ..configs import apply_overrides, get_config
    from ..models.builder import build_model
    from . import checkpoint as ckpt
    from .evaluator import (ELEV_MODELS, OCC_MODELS, evaluate,
                            make_dataset_val_batches, make_val_batches)

    dev = resolve_device(args.device)
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.data_root:
        cfg["data"]["data_root"] = args.data_root
    model_type = cfg["model"]["type"]
    is_occ = model_type in OCC_MODELS
    bs = args.batch_size or 1
    if args.synthetic:
        batches = make_val_batches(cfg["data"], bs, args.val_batches,
                                   with_occ=is_occ, device=dev,
                                   with_elev=model_type in ELEV_MODELS)
    else:
        from ..data.nuscenes import NuScenesDataset

        dataset = NuScenesDataset(cfg["data"], split="val")
        batches = make_dataset_val_batches(
            dataset, bs, limit=args.num_samples or len(dataset), device=dev)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg["model"], device=dev, dtype=dtype)
    if args.checkpoint:
        merged, n_ok, n_all = ckpt.partial_load(
            model.state_dict(), ckpt.restore_params_only(args.checkpoint))
        model.load_state_dict(merged)
        print(f"loaded checkpoint: {n_ok}/{n_all} tensors")
    class_names = cfg["model"].get("class_names") or ()
    num_classes = cfg["model"]["decoder"]["num_classes"] if is_occ else 0
    metrics = evaluate(model, batches(), model_type, num_classes,
                       class_names)
    if is_occ:
        print(f"CE: {metrics['ce']:.4f}")
        print(f"IoU (geometry): {metrics['iou']:.4f}")
        for name in class_names:
            print(f"  {name}: {metrics[f'iou_{name}']:.4f}")
        print(f"mIoU: {metrics['miou']:.4f}")
    elif "mse" in metrics:
        print(f"elevation MSE: {metrics['mse']:.4f}")
    else:
        print(f"mean loss: {metrics['val_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

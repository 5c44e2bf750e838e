"""Evaluate a config on synthetic validation batches (counterpart of
``tools/test.py``).

    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        triplane_occ --checkpoint DIR/checkpoints/step_3.pt --synthetic \\
        --val-batches 2 --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.eval_cli \\
        tiny_occ --checkpoint DIR/checkpoints/step_2.pt --synthetic \\
        --val-batches 2 --device cpu

Runs on CUDA unless ``--device cpu`` is given (and raises without CUDA).
``--checkpoint`` is partial-loaded as ``tools/test.py`` loads it (every
tensor whose name and shape match; the count is printed).  Occupancy
configs print ``CE:``, ``IoU (geometry):``, one line per class and
``mIoU:``, with the reference's metric (``train/metrics.py``); pretrain
configs print ``mean loss:``.  Only ``--synthetic`` data is ported; the
batches come from their own seeds (``evaluator.VAL_SEED``).
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", help="config name (e.g. triplane_occ)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on generated nuScenes-shaped batches "
                        "(the only data source ported)")
    p.add_argument("--val-batches", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (parameters stay float32)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported")
    from .. import resolve_device
    from ..configs import get_config
    from ..models.builder import build_model
    from . import checkpoint as ckpt
    from .evaluator import OCC_MODELS, evaluate, make_val_batches

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg["model"], device=dev, dtype=dtype)
    if args.checkpoint:
        merged, n_ok, n_all = ckpt.partial_load(
            model.state_dict(), ckpt.restore_params_only(args.checkpoint))
        model.load_state_dict(merged)
        print(f"loaded checkpoint: {n_ok}/{n_all} tensors")
    model_type = cfg["model"]["type"]
    is_occ = model_type in OCC_MODELS
    class_names = cfg["model"].get("class_names") or ()
    batches = make_val_batches(cfg["data"], args.batch_size,
                               args.val_batches, with_occ=is_occ,
                               device=dev)
    num_classes = cfg["model"]["decoder"]["num_classes"] if is_occ else 0
    metrics = evaluate(model, batches(), model_type, num_classes,
                       class_names)
    if is_occ:
        print(f"CE: {metrics['ce']:.4f}")
        print(f"IoU (geometry): {metrics['iou']:.4f}")
        for name in class_names:
            print(f"  {name}: {metrics[f'iou_{name}']:.4f}")
        print(f"mIoU: {metrics['miou']:.4f}")
    else:
        print(f"mean loss: {metrics['val_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

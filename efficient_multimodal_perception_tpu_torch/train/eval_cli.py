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

``--show-dir DIR`` then dumps one sample at a time (JAX
``tools/test.py``'s ``_dump_visualizations``), at most 100 for the
occupancy models and 20 for the others: the i-th validation sample, or
with ``--synthetic`` the one-sample batch drawn from seed i (of
``--num-samples``, default 8).  Occupancy models write ``DIR/<i>.npz``
(predicted and true class maps, the range points), ``TriplaneOcc`` also
the PCA of its triplane (``DIR/triplane/<i>.png``); ``TriplaneMAE`` writes
the camera grid (``DIR/cam/<i>.png``, ``DIR/raw/``), the range grid
(``DIR/range/<i>.png``), the reprojected points (``DIR/points/``) and the
triplane's PCA from ``TriplaneMAE.reconstructions``.  The figures need
matplotlib; where it is not installed (the card's machine) the dump
writes the numpy artifacts only and says so.
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
    p.add_argument("--show-dir", default=None,
                   help="write per-sample visualisations here")
    return p.parse_args(argv)


def dump_visualizations(model, single, n: int, model_type: str,
                        show_dir: str) -> int:
    """Per-sample dumps of ``single(i)`` for ``i < min(n, 100 or 20)``
    (see the module docstring); returns the number of samples dumped."""
    import importlib.util

    import numpy as np

    from ..utils import visualization as viz
    from .evaluator import OCC_MODELS

    def host(t):
        return t.detach().float().cpu().numpy()

    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("show-dir: matplotlib is not installed; writing the numpy "
              "artifacts only (no PNG figures)")
    is_occ = model_type in OCC_MODELS
    limit = min(n, 100 if is_occ else 20)
    with torch.no_grad():
        for i in range(limit):
            b = single(i)
            if is_occ:
                logits, occ, _ = model(b)
                viz.save_occupancy_npz(
                    logits[0].argmax(-1).to(torch.int32).cpu().numpy(),
                    occ[0].cpu().numpy(),
                    np.zeros((0, 3)) if b.range_points is None
                    else host(b.range_points[0]), show_dir, i)
                if model_type == "TriplaneOcc" and figures:
                    viz.save_triplane_pca(host(model.triplane(b)[0]),
                                          show_dir, i)
            elif model_type == "TriplaneMAE":
                rec = model.reconstructions(b)
                if "cam_recon" in rec and figures:
                    N, H, W = b.img.shape[1:4]
                    viz.save_image_grid(host(b.img[0]),
                                        host(rec["cam_recon"][:N]),
                                        np.ones((N, H, W, 1)), show_dir, i)
                if "range_recon" in rec:
                    ri = host(b.range_image[0])
                    recon = host(rec["range_recon"][0])
                    if figures:
                        viz.save_range_grid(ri, recon, np.ones_like(ri),
                                            show_dir, i)
                    viz.save_reprojected_points(host(b.range_points[0]),
                                                recon, np.ones_like(ri),
                                                show_dir, i)
                if figures:
                    viz.save_triplane_pca(host(rec["triplane"][0]), show_dir,
                                          i)
    return limit


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

        def single(i):
            from ..data.synthetic import synthetic_batch

            return synthetic_batch(
                1, num_cams=cfg["data"]["num_cams"],
                image_hw=tuple(cfg["data"]["image_size"]),
                point_budget=cfg["data"]["point_budget"], with_occ=is_occ,
                with_elev=model_type in ELEV_MODELS, seed=i, device=dev)

        n_show = args.num_samples or 8
    else:
        from ..data.nuscenes import NuScenesDataset

        dataset = NuScenesDataset(cfg["data"], split="val")
        n_show = args.num_samples or len(dataset)
        batches = make_dataset_val_batches(dataset, bs, limit=n_show,
                                           device=dev)

        def single(i):
            return dataset.batch([i]).to(dev)
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
    if args.show_dir:
        done = dump_visualizations(model, single, n_show, model_type,
                                   args.show_dir)
        print(f"show-dir: {done} samples in {args.show_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

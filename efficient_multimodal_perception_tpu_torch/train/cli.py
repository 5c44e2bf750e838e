"""Train a config on synthetic batches (counterpart of ``tools/train.py``).

    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_range_cam --work-dir DIR --synthetic --max-steps 3 \\
        --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_occ --work-dir DIR2 --synthetic --max-steps 3 --bf16 \\
        --ckpt-path DIR/checkpoints/step_3.pt
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        tiny_range_cam --work-dir DIR --synthetic --max-steps 2 --device cpu

Runs on CUDA unless ``--device cpu`` is given (and raises without CUDA).
Prints one JSON line per step: the step, every loss, ``loss``,
``grad_norm``, ``lr`` and the step's wall time in ms (synchronised on
CUDA).  ``--work-dir`` receives the resolved config, the same lines in
``metrics.jsonl`` and the checkpoints (``checkpoints/step_<N>.pt``, every
``checkpoint.interval`` epochs of the config, which ``--cfg-options`` can
set, and after the last).  ``--ckpt-path`` partial-loads a checkpoint (every tensor whose name and shape match, the
pretrain encoder and neck of a fine-tune) and prints how many tensors it
took; ``--resume-from`` restores a whole training state.  Only
``--synthetic`` data is ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

STEPS_PER_EPOCH = 16  # synthetic data, as tools/train.py


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", help="config name (e.g. triplane_range_cam)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated nuScenes-shaped batches "
                        "(the only data source ported)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="samples per step (default: the config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (parameters stay float32)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--ckpt-path", default=None,
                   help="checkpoint to partial-load (model_init.ckpt_path)")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint of this run's state to resume from")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="key.sub=value config overrides")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported")
    from .. import resolve_device
    from ..configs import apply_overrides, get_config
    from ..data.synthetic import synthetic_batch
    from ..models.builder import build_model
    from . import checkpoint as ckpt
    from .trainer import build_trainer

    dev = resolve_device(args.device)
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.ckpt_path:
        cfg["model_init"]["ckpt_path"] = args.ckpt_path
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg["model"], device=dev, dtype=dtype,
                        seed=args.seed)
    init_path = cfg.get("model_init", {}).get("ckpt_path")
    if init_path:
        merged, n_ok, n_all = ckpt.partial_load(
            model.state_dict(), ckpt.restore_params_only(init_path))
        model.load_state_dict(merged)
        print(f"partial restore: adopted {n_ok}/{n_all} tensors", flush=True)
    total = STEPS_PER_EPOCH * cfg["epochs"]
    if args.max_steps:
        total = min(total, args.max_steps)
    trainer = build_trainer(cfg, model, total, args.seed)
    if args.resume_from:
        ckpt.restore_checkpoint(args.resume_from, trainer)
        print(f"resumed from {args.resume_from} @ step {trainer.step}",
              flush=True)
    every = cfg["checkpoint"]["interval"] * STEPS_PER_EPOCH
    data = cfg["data"]
    bs = args.batch_size or data.get("samples_per_device", 1)

    log_path = os.path.join(args.work_dir, "metrics.jsonl")
    with open(log_path, "a" if args.resume_from else "w") as log:
        while trainer.step < total:
            i = trainer.step
            batch = synthetic_batch(bs, num_cams=data["num_cams"],
                                    image_hw=tuple(data["image_size"]),
                                    point_budget=data["point_budget"],
                                    with_occ=data.get("load_occ", False),
                                    seed=args.seed + i, device=dev)
            t0 = time.perf_counter()
            logs = trainer.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            line = json.dumps({"step": i + 1, **{k: float(v) for k, v in
                                                 logs.items()}, "ms": ms})
            print(line, flush=True)
            log.write(line + "\n")
            if trainer.step % every == 0 or trainer.step == total:
                path = ckpt.save_checkpoint(args.work_dir, trainer.step,
                                            trainer.state_dict())
                print(f"saved {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

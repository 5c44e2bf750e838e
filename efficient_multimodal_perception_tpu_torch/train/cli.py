"""Train a config on synthetic batches (counterpart of ``tools/train.py``).

    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_range_cam --work-dir DIR --synthetic --max-steps 3 \\
        --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        tiny_range_cam --work-dir DIR --synthetic --max-steps 2 --device cpu

Runs on CUDA unless ``--device cpu`` is given (and raises without CUDA).
Prints one JSON line per step: the step, every loss, ``loss``,
``grad_norm``, ``lr`` and the step's wall time in ms (synchronised on
CUDA).  ``--work-dir`` receives the resolved config and the same lines
in ``metrics.jsonl``.  Only ``--synthetic`` data is ported; checkpoints
and the real data layer are not.
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
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported")
    from .. import resolve_device
    from ..configs import get_config
    from ..data.synthetic import synthetic_batch
    from ..models.builder import build_model
    from .trainer import build_trainer

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg["model"], device=dev, dtype=dtype,
                        seed=args.seed)
    total = STEPS_PER_EPOCH * cfg["epochs"]
    if args.max_steps:
        total = min(total, args.max_steps)
    trainer = build_trainer(cfg, model, total, args.seed)
    data = cfg["data"]
    bs = args.batch_size or data.get("samples_per_device", 1)

    log_path = os.path.join(args.work_dir, "metrics.jsonl")
    with open(log_path, "w") as log:
        for i in range(total):
            batch = synthetic_batch(bs, num_cams=data["num_cams"],
                                    image_hw=tuple(data["image_size"]),
                                    point_budget=data["point_budget"],
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

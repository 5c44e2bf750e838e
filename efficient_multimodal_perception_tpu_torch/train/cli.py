"""Train a config on nuScenes files or on synthetic batches (counterpart
of ``tools/train.py``).

    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_occ --work-dir DIR2 --data-root data/nuscenes \\
        --batch-size 2 --ckpt-path DIR/checkpoints/step_3.pt
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_range_cam --work-dir DIR --synthetic --max-steps 3 \\
        --batch-size 2 --bf16
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_occ --work-dir DIR2 --synthetic --max-steps 3 --bf16 \\
        --ckpt-path DIR/checkpoints/step_3.pt
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_elev --work-dir DIR3 --synthetic --max-steps 3 \\
        --batch-size 2 --ckpt-path DIR/checkpoints/step_3.pt
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        triplane_surf_sam --work-dir DIR4 --synthetic --max-steps 3 \\
        --batch-size 2
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        point_triplane --work-dir DIR5 --synthetic --max-steps 3 \\
        --batch-size 2
    python -m efficient_multimodal_perception_tpu_torch.train.cli \\
        tiny_range_cam --work-dir DIR --synthetic --max-steps 2 --device cpu

Without ``--synthetic`` it reads the config's ``data`` block (its
``data_root``, or ``--data-root``) through ``data/nuscenes.py``: the
train split, an epoch of ``len(dataset) // batch_size`` steps whose
order and augmentation come from ``epoch_batches(dataset, batch_size,
seed=seed + epoch)`` (host batches, made ahead by the loader's threads,
moved to the device); a missing infos file raises.  With
``--synthetic`` the i-th step's batch is drawn from ``seed + i`` and an
epoch is 16 steps.
Runs on CUDA unless ``--device cpu`` is given (and raises without CUDA).
Computes in bf16 (parameters stay float32) when the config's
``compute_dtype`` is ``"bfloat16"``, as every shipped config's is, or when
``--bf16`` is given; else in float32.
Prints one JSON line per step: the step, every loss, ``loss``,
``grad_norm``, ``lr``, the step's wall time in ms (synchronised on CUDA)
and ``wait_ms``, the time spent before it getting its batch onto the
device (the loader's wait).  ``--work-dir`` receives the resolved
config, the same lines in ``metrics.jsonl`` and the checkpoints (``checkpoints/step_<N>.pt``, every
``checkpoint.interval`` epochs of the config, which ``--cfg-options`` can
set, and after the last).  ``--ckpt-path`` partial-loads a checkpoint (every tensor whose name and shape match, the
pretrain encoder and neck of a fine-tune) and prints how many tensors it
took; ``--resume-from`` restores a whole training state.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

SYNTHETIC_STEPS_PER_EPOCH = 16  # as tools/train.py


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", help="config name (e.g. triplane_range_cam)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--data-root", default=None,
                   help="nuScenes root (default: the config's data_root)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated nuScenes-shaped batches")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="samples per step (default: the config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (parameters stay float32) even where "
                        "the config's compute_dtype does not ask for it")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--ckpt-path", default=None,
                   help="checkpoint to partial-load (model_init.ckpt_path)")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint of this run's state to resume from")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="key.sub=value config overrides")
    return p.parse_args(argv)


def compute_dtype(cfg: dict, bf16: bool = False) -> torch.dtype:
    """The training compute dtype, chosen as ``tools/train.py`` does:
    bf16 when the config's ``compute_dtype`` is ``"bfloat16"`` or
    ``bf16`` (``--bf16``) is set, else float32."""
    if bf16 or cfg.get("compute_dtype") == "bfloat16":
        return torch.bfloat16
    return torch.float32


def main(argv=None) -> int:
    args = parse_args(argv)
    from .. import resolve_device
    from ..configs import apply_overrides, get_config
    from ..data.synthetic import synthetic_batch
    from ..models.builder import build_model
    from . import checkpoint as ckpt
    from .trainer import build_trainer

    dev = resolve_device(args.device)
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.data_root:
        cfg["data"]["data_root"] = args.data_root
    if args.ckpt_path:
        cfg["model_init"]["ckpt_path"] = args.ckpt_path
    data = cfg["data"]
    bs = args.batch_size or data.get("samples_per_device", 1)
    if args.synthetic:
        steps_per_epoch = SYNTHETIC_STEPS_PER_EPOCH
    else:
        from ..data.nuscenes import NuScenesDataset, epoch_batches

        dataset = NuScenesDataset(data, split="train", seed=args.seed)
        steps_per_epoch = len(dataset) // bs
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)

    model = build_model(cfg["model"], device=dev,
                        dtype=compute_dtype(cfg, args.bf16),
                        seed=args.seed)
    init_path = cfg.get("model_init", {}).get("ckpt_path")
    if init_path:
        merged, n_ok, n_all = ckpt.partial_load(
            model.state_dict(), ckpt.restore_params_only(init_path))
        model.load_state_dict(merged)
        print(f"partial restore: adopted {n_ok}/{n_all} tensors", flush=True)
    total = steps_per_epoch * cfg["epochs"]
    if args.max_steps:
        total = min(total, args.max_steps)
    trainer = build_trainer(cfg, model, total, args.seed)
    if args.resume_from:
        ckpt.restore_checkpoint(args.resume_from, trainer)
        print(f"resumed from {args.resume_from} @ step {trainer.step}",
              flush=True)
    every = max(cfg["checkpoint"]["interval"] * steps_per_epoch, 1)

    def batches():
        """Step batches from ``trainer.step`` on (host batches moved to
        ``dev``); a file-backed run restarts the epoch it resumes in."""
        if args.synthetic:
            i = trainer.step
            while True:
                yield synthetic_batch(bs, num_cams=data["num_cams"],
                                      image_hw=tuple(data["image_size"]),
                                      point_budget=data["point_budget"],
                                      with_occ=data.get("load_occ", False),
                                      with_elev=data.get("load_elev", False),
                                      seed=args.seed + i, device=dev)
                i += 1
        epoch = trainer.step // max(steps_per_epoch, 1)
        while True:
            with contextlib.closing(epoch_batches(
                    dataset, bs, seed=args.seed + epoch)) as it:
                for b in it:
                    yield b.to(dev)
            epoch += 1

    log_path = os.path.join(args.work_dir, "metrics.jsonl")
    with open(log_path, "a" if args.resume_from else "w") as log, \
            contextlib.closing(batches()) as source:
        while trainer.step < total:
            i = trainer.step
            t0 = time.perf_counter()
            batch = next(source)
            t1 = time.perf_counter()
            logs = trainer.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            line = json.dumps({"step": i + 1, **{k: float(v) for k, v in
                                                 logs.items()},
                               "ms": (t2 - t1) * 1e3,
                               "wait_ms": (t1 - t0) * 1e3})
            print(line, flush=True)
            log.write(line + "\n")
            if trainer.step % every == 0 or trainer.step == total:
                path = ckpt.save_checkpoint(args.work_dir, trainer.step,
                                            trainer.state_dict())
                print(f"saved {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

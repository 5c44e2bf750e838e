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
took; ``--resume-from`` restores a whole training state, ``--auto-resume``
the newest checkpoint under ``--work-dir`` (if any).

The single-card flags of ``tools/train.py``:

* ``--remat`` recomputes the forward in the backward
  (``torch.utils.checkpoint``; the step is the one without it);
* ``--accum-steps k`` averages the gradients of k micro-batches before
  one update (the batch size must divide);
* ``--async-ckpt`` writes checkpoints from a background thread (joined
  before exit); the config's ``checkpoint.max_keep`` prunes old saves and
  each save gets a ``.meta.json`` (config, CLASSES, epoch, step);
* ``--eval-interval N`` evaluates (``train/evaluator.py``) after every N
  epochs and the last step: with ``--synthetic`` on ``min(eval_samples,
  8)`` batches of one sample seeded ``10_000 + i``, else on the first
  ``--eval-samples`` of the val split; it prints ``[eval @ epoch E]`` and
  logs ``val/<metric>``;
* ``--profile`` writes a ``torch.profiler`` chrome trace of steps 6-10
  under ``<work_dir>/profile/``;
* ``--debug-nans`` raises ``FloatingPointError`` naming the first module
  whose forward output is not finite, and runs the backward under
  ``torch.autograd.detect_anomaly(check_nan=True)``.

At start it prints the environment (``utils/env.env_string``) to
standard error, which leaves standard output to the step lines; besides
the JSON lines it logs every step through ``utils/logging.MetricLogger``
(``train.log``, ``metrics.csv``, and TensorBoard events under
``<work_dir>/tb`` where ``torch.utils.tensorboard`` imports).
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
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest checkpoint in --work-dir")
    p.add_argument("--cfg-options", nargs="*", default=None,
                   help="key.sub=value config overrides")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="micro-batches a step, their gradients averaged "
                        "(the batch size must divide)")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints from a background thread")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="evaluate every N epochs (0: never)")
    p.add_argument("--eval-samples", type=int, default=64)
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of steps 6-10 into "
                        "<work_dir>/profile")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first module with a non-finite "
                        "output; anomaly detection in the backward")
    return p.parse_args(argv)


def compute_dtype(cfg: dict, bf16: bool = False) -> torch.dtype:
    """The training compute dtype, chosen as ``tools/train.py`` does:
    bf16 when the config's ``compute_dtype`` is ``"bfloat16"`` or
    ``bf16`` (``--bf16``) is set, else float32."""
    if bf16 or cfg.get("compute_dtype") == "bfloat16":
        return torch.bfloat16
    return torch.float32


PROFILE_STEPS = (6, 10)  # the steps --profile traces (1-based, inclusive)


def eval_batches(args, cfg: dict, dev):
    """The batches of an in-training evaluation (``tools/train.py``'s):
    synthetic, ``min(eval_samples, 8)`` of one sample seeded ``10_000 +
    i``; from files, the first ``eval_samples`` of the val split, one a
    batch."""
    from .evaluator import ELEV_MODELS, OCC_MODELS, make_dataset_val_batches

    data = cfg["data"]
    if args.synthetic:
        from ..data.synthetic import synthetic_batch

        mtype = cfg["model"]["type"]
        return [synthetic_batch(1, num_cams=data["num_cams"],
                                image_hw=tuple(data["image_size"]),
                                point_budget=data["point_budget"],
                                with_occ=mtype in OCC_MODELS,
                                with_elev=mtype in ELEV_MODELS,
                                seed=10_000 + i, device=dev)
                for i in range(min(args.eval_samples, 8))]
    from ..data.nuscenes import NuScenesDataset

    return make_dataset_val_batches(NuScenesDataset(data, split="val"), 1,
                                    args.eval_samples, dev)()


def run_eval(args, cfg, model, dev, logger, step: int, epoch: int) -> dict:
    from .evaluator import OCC_MODELS, evaluate

    mtype = cfg["model"]["type"]
    metrics = evaluate(
        model, eval_batches(args, cfg, dev), mtype,
        cfg["model"]["decoder"]["num_classes"] if mtype in OCC_MODELS else 0,
        cfg["model"].get("class_names") or ())
    logger.log(step, {f"val/{k}": v for k, v in metrics.items()})
    print(f"[eval @ epoch {epoch}] {metrics}", flush=True)
    return metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    from .. import resolve_device
    from ..configs import apply_overrides, get_config
    from ..data.synthetic import synthetic_batch
    from ..models.builder import build_model
    from ..utils.env import env_string
    from ..utils.logging import MetricLogger
    from . import checkpoint as ckpt
    from .trainer import build_trainer, raise_on_nonfinite

    dev = resolve_device(args.device)
    print(env_string(), file=sys.stderr, flush=True)
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
    trainer = build_trainer(cfg, model, total, args.seed, args.accum_steps,
                            args.remat)
    resume = args.resume_from
    if not resume and args.auto_resume:
        resume = ckpt.latest_checkpoint(args.work_dir)
    if resume:
        ckpt.restore_checkpoint(resume, trainer)
        print(f"resumed from {resume} @ step {trainer.step}", flush=True)
    every = max(cfg["checkpoint"]["interval"] * steps_per_epoch, 1)
    if args.debug_nans:
        raise_on_nonfinite(model)
    anomaly = (torch.autograd.detect_anomaly(check_nan=True)
               if args.debug_nans else contextlib.nullcontext())
    logger = MetricLogger(args.work_dir)
    profiler = None

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
    with open(log_path, "a" if resume else "w") as log, \
            contextlib.closing(batches()) as source:
        while trainer.step < total:
            i = trainer.step
            if args.profile and i + 1 == PROFILE_STEPS[0]:
                profiler = start_profile(dev)
            t0 = time.perf_counter()
            batch = next(source)
            t1 = time.perf_counter()
            with anomaly:
                logs = trainer.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            vals = {k: float(v) for k, v in logs.items()}
            line = json.dumps({"step": i + 1, **vals,
                               "ms": (t2 - t1) * 1e3,
                               "wait_ms": (t1 - t0) * 1e3})
            print(line, flush=True)
            log.write(line + "\n")
            logger.log(trainer.step, vals)
            if profiler is not None and (trainer.step == PROFILE_STEPS[1]
                                         or trainer.step == total):
                stop_profile(profiler, args.work_dir)
                profiler = None
            end_of_epoch = (trainer.step % steps_per_epoch == 0
                            or trainer.step == total)
            if trainer.step % every == 0 or trainer.step == total:
                epoch = -(-trainer.step // steps_per_epoch)
                path = ckpt.save_checkpoint(
                    args.work_dir, trainer.step, trainer.state_dict(),
                    max_keep=cfg["checkpoint"].get("max_keep"),
                    meta=dict(config=json.dumps(cfg, default=str),
                              CLASSES=list(cfg["model"].get("class_names")
                                           or ()),
                              epoch=epoch, step=trainer.step),
                    async_save=args.async_ckpt)
                print(f"saved {path}", flush=True)
            if args.eval_interval and end_of_epoch:
                epoch = -(-trainer.step // steps_per_epoch)
                if epoch % args.eval_interval == 0:
                    run_eval(args, cfg, model, dev, logger, trainer.step,
                             epoch)
    ckpt.wait_for_saves()
    logger.close()
    return 0


def start_profile(dev):
    """A started ``torch.profiler`` over the host and, on CUDA, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, work_dir: str) -> str:
    """Stop ``prof`` and write its chrome trace under
    ``<work_dir>/profile/``; returns the trace's path."""
    prof.stop()
    d = os.path.join(work_dir, "profile")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace -> {path}", flush=True)
    return path


if __name__ == "__main__":
    sys.exit(main())

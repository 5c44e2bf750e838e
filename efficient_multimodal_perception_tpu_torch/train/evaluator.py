"""Validation: occupancy CE / IoU / mIoU, the elevation masked MSE and
the pretrain mean loss (counterpart of the JAX package's
``train/evaluator.py``).

Per-sample scores, cross-entropies and MSEs are computed for each batch and
concatenated, so any batch size gives the numbers of the reference's
one-sample-at-a-time evaluation (``apis/test.py:44-74``).  Every model
is called with its deterministic default (no drop-path).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import aggregate_iou, evaluation_semantic
from .trainer import normalize_output, total_loss

OCC_MODELS = ("TriplaneOcc", "PointTriplaneOcc")
ELEV_MODELS = ("TriplaneElev",)
VAL_SEED = 1_000_000  # synthetic validation batches draw from their own seeds


def per_sample_ce(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """``(B,)`` mean cross-entropy over each sample's non-ignored voxels
    (what ``F.cross_entropy`` gives for one sample)."""
    B = logits.shape[0]
    lg = logits.reshape(B, -1, logits.shape[-1]).float()
    tg = targets.reshape(B, -1)
    valid = tg != ignore_index
    tgt = torch.where(valid, tg, torch.zeros_like(tg)).long()
    logp = F.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    v = valid.to(nll.dtype)
    return (nll * v).sum(1) / v.sum(1).clamp(min=1.0)


def per_sample_masked_mse(pred: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """``(B,)`` masked MSE of each sample in float32 (what
    ``masked_mse_loss`` gives for one sample)."""
    B = pred.shape[0]
    m = mask.reshape(B, -1).float()
    d = (pred.reshape(B, -1) * m - target.reshape(B, -1) * m).float()
    return (d * d).sum(1) / (m.sum(1) + 1e-8)


@torch.inference_mode()
def evaluate(model, batches: Iterable, model_type: str,
             num_classes: int = 5, class_names=(), eval_seed: int = 1) -> dict:
    """Run ``model`` over ``batches``.

    Returns ``ce``, ``iou``, ``miou`` and ``iou_<class>`` for the
    occupancy models, ``mse`` (the mean per-sample masked MSE) for the
    elevation model, else ``val_loss`` (the mean total loss).  A model
    whose losses draw (``draw``) takes the i-th batch's draws from a
    generator seeded ``eval_seed + i``, as the JAX evaluator folds the
    batch index into its ``eval_seed``.
    """
    is_occ = model_type in OCC_MODELS
    is_elev = model_type in ELEV_MODELS
    scores, ces, mses, losses = [], [], [], []
    for i, batch in enumerate(batches):
        kw = {}
        if hasattr(model, "draw"):
            kw["sample_generator"] = torch.Generator(
                batch.img.device).manual_seed(eval_seed + i)
        out = model(batch, **kw)
        if is_occ:
            logits, occ, _ = out
            scores.append(evaluation_semantic(logits.argmax(-1), occ,
                                              num_classes).cpu().numpy())
            ces.append(per_sample_ce(logits, occ).cpu().numpy())
        elif is_elev:
            mses.append(per_sample_masked_mse(
                out[0], batch.elevation, batch.elevation_mask).cpu().numpy())
        else:
            losses.append(float(total_loss(normalize_output(out))))
    if is_elev:
        return {"mse": float(np.concatenate(mses).mean())}
    if not is_occ:
        return {"val_loss": float(np.mean(losses))}
    agg = aggregate_iou(np.concatenate(scores, axis=0))
    res = {"ce": float(np.concatenate(ces).mean()), "iou": agg["iou"],
           "miou": agg["miou"]}
    for name, v in zip(class_names, agg["per_class"][1:]):
        res[f"iou_{name}"] = v
    return res


def make_dataset_val_batches(dataset, batch_size: int,
                             limit: Optional[int] = None,
                             device="cpu") -> Callable[[], Iterable]:
    """A factory of single-pass iterators over a dataset's validation
    batches (the JAX package's ``make_val_batches``): samples ``[i, i +
    batch_size)`` over the first ``min(limit, len(dataset))``, built on
    the host by ``dataset.batch`` and moved to ``device``."""

    def gen():
        n = len(dataset) if limit is None else min(limit, len(dataset))
        for i in range(0, n - batch_size + 1, batch_size):
            yield dataset.batch(list(range(i, i + batch_size))).to(device)

    return gen


def make_val_batches(data_cfg: dict, batch_size: int, n_batches: int,
                     with_occ: bool = True, device="cpu",
                     seed: int = VAL_SEED,
                     with_elev: bool = False) -> Callable[[], Iterable]:
    """A factory of single-pass iterators over ``n_batches`` synthetic
    batches of ``batch_size``, the i-th drawn from ``seed + i``."""
    from ..data.synthetic import synthetic_batch

    def gen():
        for i in range(n_batches):
            yield synthetic_batch(
                batch_size, num_cams=data_cfg["num_cams"],
                image_hw=tuple(data_cfg["image_size"]),
                point_budget=data_cfg["point_budget"], with_occ=with_occ,
                with_elev=with_elev, seed=seed + i, device=device)

    return gen

"""Validation: occupancy CE / IoU / mIoU and the pretrain mean loss
(counterpart of the JAX package's ``train/evaluator.py``).

Per-sample scores and cross-entropies are computed for each batch and
concatenated, so any batch size gives the numbers of the reference's
one-sample-at-a-time evaluation (``apis/test.py:44-74``).  Every model
is called with its deterministic default (no drop-path).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import aggregate_iou, evaluation_semantic
from .trainer import normalize_output, total_loss

OCC_MODELS = ("TriplaneOcc", "PointTriplaneOcc")
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


@torch.inference_mode()
def evaluate(model, batches: Iterable, model_type: str,
             num_classes: int = 5, class_names=()) -> dict:
    """Run ``model`` over ``batches``.

    Returns ``ce``, ``iou``, ``miou`` and ``iou_<class>`` for the
    occupancy models, else ``val_loss`` (the mean total loss).
    """
    is_occ = model_type in OCC_MODELS
    scores, ces, losses = [], [], []
    for batch in batches:
        out = model(batch)
        if is_occ:
            logits, occ, _ = out
            scores.append(evaluation_semantic(logits.argmax(-1), occ,
                                              num_classes).cpu().numpy())
            ces.append(per_sample_ce(logits, occ).cpu().numpy())
        else:
            losses.append(float(total_loss(normalize_output(out))))
    if not is_occ:
        return {"val_loss": float(np.mean(losses))}
    agg = aggregate_iou(np.concatenate(scores, axis=0))
    res = {"ce": float(np.concatenate(ces).mean()), "iou": agg["iou"],
           "miou": agg["miou"]}
    for name, v in zip(class_names, agg["per_class"][1:]):
        res[f"iou_{name}"] = v
    return res


def make_val_batches(data_cfg: dict, batch_size: int, n_batches: int,
                     with_occ: bool = True, device="cpu",
                     seed: int = VAL_SEED) -> Callable[[], Iterable]:
    """A factory of single-pass iterators over ``n_batches`` synthetic
    batches of ``batch_size``, the i-th drawn from ``seed + i``."""
    from ..data.synthetic import synthetic_batch

    def gen():
        for i in range(n_batches):
            yield synthetic_batch(
                batch_size, num_cams=data_cfg["num_cams"],
                image_hw=tuple(data_cfg["image_size"]),
                point_budget=data_cfg["point_budget"], with_occ=with_occ,
                seed=seed + i, device=device)

    return gen

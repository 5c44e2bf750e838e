"""Occupancy IoU metrics (counterpart of the JAX package's
``train/metrics.py``).

``evaluation_semantic`` counts per sample and class (tp, gt, pred) with
gt == 255 ignored; class 0 is the geometry pseudo-class (any non-zero
class against any non-zero class), recovered from the class histograms
by inclusion-exclusion.  ``aggregate_iou`` means the per-sample counts
over samples, then takes the ratio; mIoU is the nanmean over classes
1..K-1.
"""

from __future__ import annotations

import numpy as np
import torch


def evaluation_semantic(pred: torch.Tensor, gt: torch.Tensor,
                        class_num: int) -> torch.Tensor:
    """Per-sample per-class counts.

    Args:
        pred: ``(B, ...)`` integer predicted classes.
        gt: ``(B, ...)`` integer labels, 255 = ignore.
        class_num: number of classes including the geometry class 0.

    Returns ``(B, class_num, 3)`` float32 counts (tp, gt, pred).
    """
    B = pred.shape[0]
    p = pred.reshape(B, -1).long()
    g = gt.reshape(B, -1).long()
    mask = g != 255
    ignore = class_num  # an overflow bucket, sliced away

    def hist(x):
        off = torch.arange(B, device=x.device)[:, None] * (class_num + 1)
        return torch.bincount((x + off).reshape(-1),
                              minlength=B * (class_num + 1)).reshape(
                                  B, class_num + 1)[:, :class_num]

    # labels outside [0, class_num) count in no class, as JAX's bincount
    # drops them
    gm = torch.where(mask & (g >= 0) & (g < class_num), g, ignore)
    pm = torch.where(mask & (p >= 0) & (p < class_num), p, ignore)
    gcount, pcount = hist(gm), hist(pm)
    tpcount = hist(torch.where(gm == pm, gm, ignore))
    nz = mask.sum(1)
    both_zero = (mask & (g == 0) & (p == 0)).sum(1)
    geo = torch.stack([nz - gcount[:, 0] - pcount[:, 0] + both_zero,
                       nz - gcount[:, 0], nz - pcount[:, 0]], -1)
    scores = torch.stack([tpcount, gcount, pcount], -1)
    scores[:, 0] = geo
    return scores.float()


def aggregate_iou(scores) -> dict:
    """IoU / mIoU from stacked per-sample scores ``(n, class_num, 3)``:
    ``iou`` (class 0, geometry), ``miou`` (nanmean of classes 1..) and
    ``per_class``."""
    mean = np.asarray(scores, np.float64).mean(axis=0)
    tp, g, p = mean[:, 0], mean[:, 1], mean[:, 2]
    denom = g + p - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    return {
        "iou": float(iou[0]),
        "miou": float(np.nanmean(iou[1:])) if len(iou) > 1 else float("nan"),
        "per_class": [float(v) for v in iou],
    }

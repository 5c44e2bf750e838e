"""Multi-positive supervised contrastive loss over SAM clusters.

Counterpart of the JAX package's ``losses/sup_con.py``.  The reference
picks one random member of every cluster with at least
``MIN_CLUSTER_SIZE`` members as an anchor; here that pick is a segment
computation over a fixed ``max_clusters`` anchor slots a channel:

* cluster ids are small ints below ``max_clusters`` (SAM mask indices);
  per-cluster counts come from a ``scatter_add_`` (``bincount`` would
  read its input's maximum back to the host), eligibility is
  ``count >= MIN_CLUSTER_SIZE``;
* the member picked is the segment argmax of uniform ``scores``
  (``scatter_reduce`` ``amax``, then ``amin`` over the indices attaining
  it), the same distribution as the reference's random pick.

The draw is kept apart from the math: the caller hands in the scores
(U[0, 1) from a ``torch.Generator``, or the draws JAX made).  Every
channel of every sample is computed at once; the ``N`` label channels of
a sample (the 6 cameras' SAM ids) share its features.
"""

from __future__ import annotations

import torch

MIN_CLUSTER_SIZE = 10


def sup_con_loss(features, labels, valid, scores, max_clusters: int = 256,
                 temperature: float = 0.07, base_temperature: float = 0.07):
    """SupCon loss of each (sample, label channel).

    Args:
        features: ``(B, P, C)`` per-point features (L2-normalized here);
            the math runs in their dtype.
        labels: ``(B, N, P)`` integer cluster ids of N label channels;
            only ``valid`` rows count.
        valid: ``(B, N, P)`` bool (label > 0, in range, real point).
        scores: ``(B, N, P)`` float: the anchor draw, U[0, 1).
        max_clusters: the number of anchor slots (ids at or above it are
            never anchors).

    Returns:
        ``(loss, has_anchor)``, each ``(B, N)``: the loss (0 where no
        cluster is eligible) and whether any anchor was eligible (the
        reference's "loss is not None").
    """
    B, N, P = labels.shape
    lab, val, sc = labels.long(), valid.bool(), scores.float()
    M, dev = max_clusters, features.device

    feats = features * torch.rsqrt(torch.clamp(
        (features * features).sum(-1, keepdim=True), min=1e-24))
    # one segment a cluster, one slot per channel at M for the rest
    seg = torch.where(val & (lab < M), lab, torch.full_like(lab, M))
    flat = (seg + torch.arange(B * N, device=dev).view(B, N, 1)
            * (M + 1)).reshape(-1)
    n_seg = B * N * (M + 1)
    counts = torch.zeros(n_seg, dtype=torch.long, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat)).view(B, N, M + 1)
    eligible = counts[..., :M] >= MIN_CLUSTER_SIZE

    # the anchor: the first member attaining its cluster's best score
    masked = torch.where(val, sc, torch.full_like(sc, -1.0))
    best = torch.full((n_seg,), float("-inf"), device=dev).scatter_reduce(
        0, flat, masked.reshape(-1), "amax", include_self=False)
    is_best = val & (seg < M) & (masked == best.view(B, N, M + 1).gather(
        -1, seg))
    idx = torch.arange(P, device=dev).expand(B, N, P)
    first = torch.full((n_seg,), P, dtype=torch.long, device=dev)
    first = first.scatter_reduce(
        0, flat, torch.where(is_best, idx, P).reshape(-1), "amin",
        include_self=True).view(B, N, M + 1)[..., :M]
    anchor_ok = eligible & (first < P)
    anchor = first.clamp(max=P - 1)  # (B, N, M)

    anchor_feat = feats.gather(1, anchor.reshape(B, N * M, 1).expand(
        -1, -1, feats.shape[-1]))
    logits = (torch.matmul(anchor_feat, feats.transpose(1, 2))
              / temperature).view(B, N, M, P)
    col = val[:, :, None, :]
    logits = torch.where(col, logits, torch.full((), float("-inf"),
                                                 dtype=logits.dtype,
                                                 device=dev))
    logits = logits - logits.amax(-1, keepdim=True).detach()

    anchor_lab = seg.gather(-1, anchor)
    not_self = anchor[..., None] != torch.arange(P, device=dev)
    pos_mask = (anchor_lab[..., None] == seg[:, :, None, :]) & col & not_self
    zero = torch.zeros((), dtype=logits.dtype, device=dev)
    exp_logits = torch.where(col & not_self, torch.exp(logits), zero)
    log_prob = logits - torch.log(torch.clamp(
        exp_logits.sum(-1, keepdim=True), min=1e-24))
    pos = pos_mask.to(log_prob.dtype)
    mean_log_prob_pos = ((pos * torch.where(pos_mask, log_prob, zero))
                         .sum(-1) / torch.clamp(pos.sum(-1), min=1.0))
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    ok = anchor_ok.to(per_anchor.dtype)
    loss = (per_anchor * ok).sum(-1) / torch.clamp(ok.sum(-1), min=1.0)
    return loss, anchor_ok.any(-1)


def sam_contrastive_loss(feats, points, base_valid, scores,
                         max_clusters: int = 256):
    """The pretraining models' contrastive loss: SupCon over the 6 SAM
    label channels ``points[..., 5:11]`` (truncated to int) of every
    sample, a point valid where ``base_valid`` and its label is positive;
    the mean of the losses of the (sample, channel)s with an anchor, in
    float32.

    Args:
        feats: ``(B, P, C)`` per-point features.
        points: ``(B, P, >= 11)``; base_valid ``(B, P)`` bool.
        scores: ``(B, 6, P)`` anchor draws, U[0, 1).
    """
    labels = points[..., 5:11].to(torch.int32).transpose(1, 2)
    valid = base_valid[:, None, :] & (labels > 0)
    loss, ok = sup_con_loss(feats, labels, valid, scores, max_clusters)
    ok = ok.float()
    return (loss.float() * ok).sum() / torch.clamp(ok.sum(), min=1.0)

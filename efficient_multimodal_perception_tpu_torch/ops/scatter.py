"""Last-write scatters and the point projector's masked segment-max
pools (counterpart of the JAX package's ``ops/scatter.py``)."""

from __future__ import annotations

import torch


class _SegmentMaxFn(torch.autograd.Function):
    """``out[s] = max(feats[ids == s])`` over ``n`` segments (``-inf``
    where no row lands), with the JAX package's scatter-max VJP: a
    segment's gradient goes to every row that attains its max, times
    ``1 / count`` computed in ``feats``' dtype (the count of tied rows
    summed in that dtype, its reciprocal rounded to it, then one rounded
    product), as ``_scatter_extremal_jvp`` transposes it.  PyTorch's own
    ``scatter_reduce`` backward divides by the count instead, which
    differs from ``g * (1 / count)`` in bf16 at three or more ties."""

    @staticmethod
    def forward(ctx, feats, ids, n: int):
        index = ids[:, None].expand_as(feats)
        out = torch.full((n, feats.shape[1]), float("-inf"),
                         dtype=feats.dtype, device=feats.device)
        out.scatter_reduce_(0, index, feats, "amax", include_self=False)
        ctx.save_for_backward(feats, ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, ids, out = ctx.saved_tensors
        index = ids[:, None].expand_as(feats)
        won = feats == out.gather(0, index)
        count = torch.zeros_like(out).scatter_add_(0, index,
                                                   won.to(out.dtype))
        coef = 1.0 / count.gather(0, index)
        grad = torch.where(won, g.gather(0, index) * coef,
                           torch.zeros((), dtype=g.dtype, device=g.device))
        return grad, None, None


def masked_segment_max(feats, seg_ids, valid, num_segments: int,
                       empty_value=0.0):
    """Per-segment max over the valid rows of ``feats``.

    One ``scatter_reduce_(..., "amax")`` into a ``-inf`` buffer with one
    slop segment at the end: invalid rows, and ids outside
    ``[0, num_segments)`` (which the JAX package's ``segment_max``
    drops), go there and are cut off, so they take no gradient.  The
    gradient is the JAX package's segment-max VJP (``_SegmentMaxFn``:
    split among tied maxima as JAX rounds the split), and 0 for cells
    cleaned to ``empty_value``.  The JAX package also keeps
    ``masked_segment_max_sorted``, an argsort form that only works round
    a slow XLA:TPU scatter and gives bit-identical values; the port has
    this one pool.

    Args:
        feats: ``(P, C)``.
        seg_ids: ``(P,)`` integer segment ids.
        valid: ``(P,)`` bool.
        num_segments: number of real segments.
        empty_value: fill for segments no valid row reaches; ``None``
            leaves ``-inf`` there (for ``ops.kernels.finite_mlp_fused``,
            which zeroes it in its prologue).

    Returns:
        ``(num_segments, C)`` in ``feats``' dtype.
    """
    seg_ids = seg_ids.long()
    keep = valid & (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(keep, seg_ids, torch.full_like(seg_ids, num_segments))
    out = _SegmentMaxFn.apply(feats, ids, num_segments + 1)[:num_segments]
    if empty_value is None:
        return out
    return torch.where(torch.isfinite(out), out,
                       torch.full((), empty_value, dtype=out.dtype,
                                  device=out.device))


def point_plane_pools_batch(feats, grid_idx, valid, grid_size, split,
                            raw: bool = False):
    """The point projector's three axis pools, written directly in the
    plane-flatten layouts (one flat segment max per pool over
    batch-offset ids).

    With grid ``(X, Y, Z)`` and split ``(sx, sy, sz)`` the pooling
    kernels are ``(1, 1, Z/sz)``, ``(X/sx, 1, 1)`` and ``(1, Y/sy, 1)``.
    The segment ids are the JAX package's exactly (``kx = X // sx`` may
    leave ``gx // kx == sx`` for the last voxels; those rows spill into
    the neighbouring cell, as there).

    Args:
        feats: ``(B, P, C)``; grid_idx ``(B, P, 3)`` integer voxel
            indices; valid ``(B, P)`` bool.
        raw: leave ``-inf`` in empty cells instead of 0.

    Returns:
        xy ``(B, X, Y, sz, C)``, yz ``(B, Y, Z, sx, C)``,
        xz ``(B, X, Z, sy, C)``.
    """
    B, P, C = feats.shape
    X, Y, Z = grid_size
    sx, sy, sz = split
    kx, ky, kz = X // sx, Y // sy, Z // sz
    gx, gy, gz = grid_idx.long().unbind(-1)
    off = torch.arange(B, device=feats.device)[:, None]
    flat_feats = feats.reshape(B * P, C)
    flat_valid = valid.reshape(B * P)
    empty = None if raw else 0.0

    def pool(seg_id, nseg, shape):
        ids = (seg_id + off * nseg).reshape(B * P)
        out = masked_segment_max(flat_feats, ids, flat_valid, B * nseg,
                                 empty_value=empty)
        return out.reshape(B, *shape, C)

    xy = pool((gx * Y + gy) * sz + gz // kz, X * Y * sz, (X, Y, sz))
    yz = pool((gy * Z + gz) * sx + gx // kx, Y * Z * sx, (Y, Z, sx))
    xz = pool((gx * Z + gz) * sy + gy // ky, X * Z * sy, (X, Z, sy))
    return xy, yz, xz


def last_write_winner_batch(rows, cols, valid, H: int, W: int):
    """Per pixel, the index of the LAST point written there.

    One flat int64 scatter-max over all groups (group offset folded into
    the target index); invalid points go to a dropped slot at the end.

    Args:
        rows/cols: ``(G, P)`` integer pixel coords.
        valid: ``(G, P)`` bool.

    Returns:
        ``(G, H*W)`` int64 winner point index within its group, -1 where
        no point writes.
    """
    G, P = rows.shape
    T = H * W
    base = torch.arange(G, device=rows.device)[:, None] * T
    flat = torch.where(valid, rows.long() * W + cols.long() + base,
                       torch.full_like(base, G * T)).reshape(-1)
    order = torch.arange(P, device=rows.device).expand(G, P).reshape(-1)
    winner = torch.full((G * T + 1,), -1, dtype=torch.long,
                        device=rows.device)
    winner = winner.scatter_reduce(0, flat, order, "amax", include_self=True)
    return winner[: G * T].reshape(G, T)


def scatter_set_2d_batch(rows, cols, valid, values, H: int, W: int):
    """Last-write scatter of ``values`` rows into fresh zero canvases.

    Args:
        rows/cols: ``(G, P)`` integer pixel coords.
        valid: ``(G, P)`` bool; writes outside ``[0, H*W)`` are dropped.
        values: ``(G, P, C)``, or ``(B, P, C)`` shared by the ``G // B``
            consecutive canvases of each batch row (the cameras of a
            sample) without being copied per canvas.

    Returns:
        ``(G, H, W, C)``: at each pixel the row of the last valid point
        written there, zero where none is.

    The values are gathered by winner index, so autograd's gradient is a
    scatter-add of the canvas gradient into the winning rows.  Each point
    writes one pixel per canvas and wins it or not, so that is exactly the
    JAX package's masked-gather VJP (``won ? d_out[t_p] : 0``).
    """
    G, P = rows.shape
    B, _, C = values.shape
    T = H * W
    idx = rows.long() * W + cols.long()
    keep = valid & (idx >= 0) & (idx < T)
    winner = last_write_winner_batch(rows, cols, keep, H, W)  # (G, T)
    per = G // B
    gathered = torch.gather(
        values, 1,
        winner.clamp(min=0).reshape(B, per * T, 1).expand(B, per * T, C),
    ).reshape(G, T, C)
    out = torch.where(winner[..., None] >= 0, gathered,
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return out.reshape(G, H, W, C)

"""Last-write scatters (counterpart of the JAX package's
``ops/scatter.py``)."""

from __future__ import annotations

import torch


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

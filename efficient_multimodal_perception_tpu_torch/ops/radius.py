"""Fixed-K radius neighbour search (counterpart of the JAX package's
``ops/radius.py``).

``torch_geometric.nn.radius`` semantics, which the reference's implicit
surface decoder uses: for each query, the FIRST ``k`` supports within
``radius`` in support-index order (not the nearest ``k``).  The squared
distance is the JAX package's expanded ``|q|^2 + |s|^2 - 2 q.s``, in its
order, with ``q.s`` summed over x, y, z as float32 elementwise products:
no TF32 or bf16 product, whatever the matmul settings, since with
coordinates in tens of metres such a product errs by about ``r^2 = 1``.
The j-th neighbour is where the running int32 count of supports within
the radius first reaches j (``torch.searchsorted``), chunked over
queries so the distance matrix stays ``chunk x S``.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def radius_neighbors(queries, supports, support_valid, radius: float,
                     k: int = 32, chunk: int = 512):
    """For each query, the first ``k`` valid supports within ``radius``.

    Args:
        queries: ``(B, Q, 3)``.
        supports: ``(B, S, 3)`` padded support sets.
        support_valid: ``(B, S)`` bool.
        radius: search radius.
        k: neighbours per query.
        chunk: queries per distance matrix.

    Returns:
        ``idx (B, Q, k)`` int64 support indices, clipped to ``S - 1``
        where there is no j-th neighbour, and ``mask (B, Q, k)`` bool,
        true for a real neighbour.
    """
    q, s, valid = queries.float(), supports.float(), support_valid.bool()
    B, Q, _ = q.shape
    S = s.shape[1]
    s2 = (s * s).sum(-1)[:, None, :]
    sx, sy, sz = (s[:, None, :, i] for i in range(3))
    r2 = radius * radius
    ranks = torch.arange(1, k + 1, dtype=torch.int32, device=q.device)
    idx, mask = [], []
    for c0 in range(0, Q, chunk):
        qc = q[:, c0:c0 + chunk]
        q2 = (qc * qc).sum(-1)[..., None]
        qs = qc[..., 0:1] * sx + qc[..., 1:2] * sy + qc[..., 2:3] * sz
        d2 = q2 + s2 - 2.0 * qs  # (B, chunk, S)
        within = (d2 <= r2) & valid[:, None, :]
        count = within.to(torch.int32).cumsum(-1, dtype=torch.int32)
        want = ranks.expand(B, qc.shape[1], k).contiguous()
        idx.append(torch.searchsorted(count, want).clamp(max=S - 1))
        mask.append(want <= count[..., -1:])
    return torch.cat(idx, 1), torch.cat(mask, 1)

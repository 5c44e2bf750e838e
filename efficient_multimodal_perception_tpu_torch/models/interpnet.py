"""Implicit surface decoder (counterpart of the JAX package's
``models/interpnet.py``).

Per sample, ``n_non_manifold_pts`` queries are made around the support
cloud in three thirds (``create_targets``): in (+d r along the ray,
label 1), out (-d r, label 0) and far (the point scaled toward the
origin by r, label 0).  Each query's first ``k_neighbors`` supports
within ``radius`` (``ops.radius``) are decoded from ``[latent ||
query - support]`` by a small MLP, and the loss is the BCE of every
(query, neighbour) pair against the query's label, a masked mean over
the pairs of the whole batch.

The draws (the pick scores of each third and the radii) come from
:meth:`InterpNet.draw` and are handed to the loss, so a test can give
it the draws JAX made.  Module names follow the reference ``state_dict``:
``fc_in``, ``mlp_layers.{0,1}``, ``fc_out``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.radius import radius_neighbors
from .point_projector import linear


def bce_with_logits(logits, targets):
    """Per-element BCE with logits, the JAX package's stable form
    ``max(l, 0) - l t + log1p(exp(-|l|))`` (``torch.maximum`` splits the
    gradient at ``l = 0`` as ``jnp.maximum`` does)."""
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-logits.abs())))


class InterpNet(nn.Module):
    """MLP decoder over ``[latent || relative position]`` with the BCE
    occupancy loss; ``forward(points, latents, valid, draws)``."""

    def __init__(self, latent_size: int = 32, out_channels: int = 1,
                 radius: float = 1.0, n_non_manifold_pts: int = 2048,
                 non_manifold_dist: float = 0.1, k_neighbors: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.radius = radius
        self.n_non_manifold_pts = n_non_manifold_pts
        self.non_manifold_dist = non_manifold_dist
        self.k_neighbors = k_neighbors
        self.dtype = dtype
        self.fc_in = nn.Linear(latent_size + 3, latent_size)
        self.mlp_layers = nn.ModuleList(
            nn.Linear(latent_size, latent_size) for _ in range(2))
        self.fc_out = nn.Linear(latent_size, out_channels)

    def draw(self, B: int, P: int, generator, device) -> dict:
        """The loss's draws for ``B`` samples of ``P`` supports: ``pick``
        ``(B, 3, P)`` scores (a third's queries start from its top-scored
        valid supports) and ``radii`` ``(B, n, 1)``, all U[0, 1)."""
        return dict(
            pick=torch.rand((B, 3, P), generator=generator, device=device),
            radii=torch.rand((B, self.n_non_manifold_pts, 1),
                             generator=generator, device=device))

    def decode(self, x):
        """fc_in -> 2 x (ReLU, mlp_layers.i) -> fc_out, in ``dtype``."""
        x = linear(x, self.fc_in, self.dtype)
        for lin in self.mlp_layers:
            x = linear(torch.relu(x), lin, self.dtype)
        return linear(x, self.fc_out, self.dtype)

    def create_targets(self, pts, valid, draws):
        """Queries ``(B, n, 3)``, labels ``(B, n)`` int32 and query
        validity ``(B, n)`` from the supports ``pts (B, P, 3)``,
        ``valid (B, P)`` and ``draws``.  A third picks the valid supports
        of highest score; picks beyond a sample's valid count are flagged
        invalid."""
        n = self.n_non_manifold_pts
        n_in, n_out, n_far = n - 2 * (n // 3), n // 3, n // 3
        pick, radii = draws["pick"], draws["radii"]
        d = self.non_manifold_dist

        def take(i, count):
            s = torch.where(valid, pick[:, i], torch.full_like(pick[:, i],
                                                               -1.0))
            top, idx = torch.topk(s, count, dim=-1)
            p = pts.gather(1, idx[..., None].expand(-1, -1, 3))
            return p, top >= 0.0

        def unit(v):
            return v / torch.clamp(torch.linalg.vector_norm(
                v, dim=-1, keepdim=True), min=1e-12)

        r_in, r_out, r_far = radii.split((n_in, n_out, n_far), dim=1)
        p_in, v_in = take(0, n_in)
        p_out, v_out = take(1, n_out)
        p_far, v_far = take(2, n_far)
        q = torch.cat([p_in + d * unit(p_in) * r_in,
                       p_out - d * unit(p_out) * r_out,
                       p_far * r_far], dim=1)
        B = pts.shape[0]
        occ = torch.cat([torch.ones((B, n_in), dtype=torch.int32,
                                    device=pts.device),
                         torch.zeros((B, n_out + n_far), dtype=torch.int32,
                                     device=pts.device)], dim=1)
        return q, occ, torch.cat([v_in, v_out, v_far], dim=1)

    def forward(self, points, latents, valid, draws):
        """Surface BCE loss.

        Args:
            points: ``(B, P, 3)`` padded supports (LiDAR frame).
            latents: ``(B, P, C)`` per-support features.
            valid: ``(B, P)`` support validity.
            draws: :meth:`draw`'s dict.

        Returns the loss (0-d, ``latents``' dtype in ``dtype``'s
        arithmetic): the pairs' BCE summed per sample, the sums added over
        the batch and divided by ``max(pair count, 1)``.
        """
        pts = points.float()
        q, occ, q_valid = self.create_targets(pts, valid.bool(), draws)
        idx, mask = radius_neighbors(q, pts, valid, self.radius,
                                     self.k_neighbors)
        B, Q, Kn = idx.shape
        flat = idx.reshape(B, Q * Kn, 1)
        near = pts.gather(1, flat.expand(-1, -1, 3)).view(B, Q, Kn, 3)
        lat = latents.gather(1, flat.expand(-1, -1, latents.shape[-1]))
        lat = lat.view(B, Q, Kn, -1)
        rel = (q[:, :, None, :] - near).to(lat.dtype)
        logits = self.decode(torch.cat([lat, rel], dim=-1))[..., 0]
        bce = bce_with_logits(logits, occ[..., None].expand_as(logits)
                              .to(logits.dtype))
        m = (mask & q_valid[..., None]).to(logits.dtype)
        num = (bce * m).sum((1, 2))
        den = m.sum((1, 2))
        return num.sum() / torch.clamp(den.sum(), min=1.0)

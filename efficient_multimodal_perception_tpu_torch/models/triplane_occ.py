"""TriplaneOcc: 3-D semantic occupancy over the triplane encoder."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.geometry import occupancy_roi
from ..ops.sampling import sample_triplane_grid_mm
from .range_family import encode_triplane


class TriplaneOcc(nn.Module):
    """Encoder + neck -> triplane -> separable voxel readout -> Mlp head.

    ``forward(batch, deterministic, generator, mask_generator)`` returns
    ``(logits (B, X, Y, Z, K), occ_target (B, X, Y, Z) or None,
    losses)``; the trainer reads the losses through
    ``train.trainer.normalize_output``.  ``mask_generator`` draws the
    encoder's MAE masks where its config masks.
    """

    def __init__(
        self,
        encoder: nn.Module,
        neck: nn.Module,
        decoder: nn.Module,
        voxel_size=(0.5, 0.5, 0.5),
        occ_range=(-25, -25, -5, 25, 25, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        triplane_voxel_size=(0.4, 0.4, 0.1),
        volume=(100, 100, 80),  # carried but unused, as in the reference
        class_names=None,
        freeze_encoder: bool = True,
        embed_dim: int = 768,
        dtype=torch.float32,
    ):
        super().__init__()
        self.encoder = encoder
        self.neck = neck
        self.decoder = decoder
        self.triplane_range = tuple(triplane_range)
        self.triplane_voxel_size = tuple(triplane_voxel_size)
        self.class_names = class_names
        self.freeze_encoder = freeze_encoder
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.occ_bounds, self.ref_3d = occupancy_roi(occ_range, voxel_size)

    def triplane(self, batch, deterministic: bool = True, generator=None,
                 mask_generator=None):
        """The ``(B, 3, S, S, C)`` triplane.  A frozen encoder runs
        deterministic (no drop-path), as JAX's ``deterministic or
        self.freeze_encoder`` (``triplane_occ.py:62-70``), and builds no
        autograd graph: ``torch.no_grad`` is this port's
        ``stop_gradient``."""
        if self.freeze_encoder:
            with torch.no_grad():
                tri, _ = encode_triplane(
                    self.encoder, self.neck, batch, self.triplane_range,
                    self.embed_dim, mask_generator=mask_generator)
            return tri
        tri, _ = encode_triplane(self.encoder, self.neck, batch,
                                 self.triplane_range, self.embed_dim,
                                 deterministic, generator,
                                 mask_generator=mask_generator)
        return tri

    def voxel_logits(self, triplane):
        ref = self.ref_3d
        feats = sample_triplane_grid_mm(
            triplane, ref[:, 0, 0, 0], ref[0, :, 0, 1], ref[0, 0, :, 2],
            self.triplane_range, self.triplane_voxel_size,
        )
        return self.decoder(feats)

    def forward(self, batch, deterministic: bool = True, generator=None,
                mask_generator=None):
        logits = self.voxel_logits(self.triplane(batch, deterministic,
                                                 generator, mask_generator))
        losses, occ = {}, None
        if batch.occupancy is not None:
            x0, y0, x1, y1 = self.occ_bounds
            occ = batch.occupancy[:, x0:x1 + 1, y0:y1 + 1]
            losses["loss"] = self.decoder.loss(logits, occ)
        return logits, occ, losses

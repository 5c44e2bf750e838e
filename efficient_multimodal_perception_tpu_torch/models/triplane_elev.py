"""TriplaneElev: BEV elevation regression over the frozen triplane
encoder (counterpart of the JAX package's ``models/triplane_elev.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.geometry import volume_reference_points
from ..ops.sampling import sample_triplane_grid_mm
from .range_family import encode_triplane


class TriplaneElev(nn.Module):
    """Encoder + neck -> triplane -> separable readout at the (100, 100,
    80) voxel centers -> elevation head (``Unet`` or ``ResnetBasicBlock``)
    -> ``(B, X, Y)`` heights and the masked MSE.

    The encoder and neck are always frozen (the reference's
    ``triplane_elev.py:67-83``): they run deterministic (no drop-path)
    under ``torch.no_grad``, this port's ``stop_gradient``, whatever the
    call asks, and the range points are not cropped (``crop=False``).
    The readout normalizes against ``triplane_range`` and ``voxel_size``;
    the head's BatchNorms train (batch statistics) when
    ``deterministic=False``.
    """

    def __init__(
        self,
        encoder: nn.Module,
        neck: nn.Module,
        decoder: nn.Module,
        volume=(100, 100, 80),
        voxel_size=(0.4, 0.4, 0.1),
        pc_range=(-20, -20, -5, 20, 20, 3),
        triplane_range=(-25, -25, -5, 25, 25, 3),
        embed_dim: int = 768,
        dtype=torch.float32,
    ):
        super().__init__()
        self.encoder = encoder
        self.neck = neck
        self.decoder = decoder
        self.voxel_size = tuple(voxel_size)
        self.triplane_range = tuple(triplane_range)
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.ref_3d = volume_reference_points(volume, voxel_size, pc_range)

    @torch.no_grad()
    def triplane(self, batch, mask_generator=None):
        """The ``(B, 3, S, S, C)`` triplane of the frozen encoder and
        neck, uncropped; ``mask_generator`` draws the encoder's MAE masks
        where its config masks."""
        tri, _ = encode_triplane(self.encoder, self.neck, batch,
                                 self.triplane_range, self.embed_dim,
                                 crop=False, mask_generator=mask_generator)
        return tri

    def heights(self, triplane, train: bool = False):
        """``(B, X, Y)`` heights of the head over the triplane's readout."""
        ref = self.ref_3d
        feats = sample_triplane_grid_mm(
            triplane, ref[:, 0, 0, 0], ref[0, :, 0, 1], ref[0, 0, :, 2],
            self.triplane_range, self.voxel_size,
        )
        return self.decoder(feats, train)

    def forward(self, batch, deterministic: bool = True, generator=None,
                mask_generator=None):
        """Returns ``(pred (B, X, Y), losses)``; ``generator`` is accepted
        for the trainer's call and unused (no drop-path runs here)."""
        pred = self.heights(self.triplane(batch, mask_generator),
                            train=not deterministic)
        losses = {}
        if batch.elevation is not None:
            losses["loss"] = self.decoder.loss(pred, batch.elevation,
                                               batch.elevation_mask)
        return pred, losses

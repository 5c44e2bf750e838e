"""Model construction from config dicts (``{'type': ..., **kwargs}``)."""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn as nn

from .. import resolve_device
from .convnext import ARCH_SETTINGS, ConvNeXtBlock, MaskConvNeXt
from .fpn import GeneralizedLSSFPN
from .heads import (
    ElevUNetHead,
    OccMlpHead,
    PointMlpHead,
    ResnetBasicBlockHead,
)
from .interpnet import InterpNet
from .joint_encoder import JointEncoder
from .mit import (
    EfficientAttention,
    MiTBlock,
    MixVisionTransformer,
    MixVisionTransformerHead,
)
from .point_projector import PointTriplaneProjector
from .point_triplane import PointTriplane
from .point_triplane_occ import PointTriplaneOcc
from .triplane_elev import TriplaneElev
from .triplane_mae import TriplaneMAE
from .triplane_occ import TriplaneOcc

REGISTRY = {
    "JointEncoder": JointEncoder,
    "MaskConvNeXt": MaskConvNeXt,
    "MaskConvNeXtV2": MaskConvNeXt,  # the forward1 / forward2 split is built in
    "GeneralizedLSSFPN": GeneralizedLSSFPN,
    "PointTriplaneProjector": PointTriplaneProjector,
    "MixVisionTransformer": MixVisionTransformer,
    "MixVisionTransformerHigh": functools.partial(MixVisionTransformer,
                                                  high=True),
    "MixVisionTransformerHead": MixVisionTransformerHead,
    "Mlp": OccMlpHead,
    "PointMlp": PointMlpHead,
    "Unet": ElevUNetHead,
    "ResnetBasicBlock": ResnetBasicBlockHead,
    "InterpNet": InterpNet,
}
MODELS = {"TriplaneOcc": TriplaneOcc, "TriplaneMAE": TriplaneMAE,
          "PointTriplaneOcc": PointTriplaneOcc, "TriplaneElev": TriplaneElev,
          "PointTriplane": PointTriplane}
# sub-module configs each model builds with ``build``
_PARTS = {"TriplaneOcc": ("encoder", "neck", "decoder"),
          "TriplaneElev": ("encoder", "neck", "decoder"),
          "TriplaneMAE": ("encoder", "neck", "camera_decoder",
                          "lidar_decoder", "surface_decoder",
                          "color_decoder"),
          "PointTriplaneOcc": ("point_triplane_projector", "camera_encoder",
                               "triplane_encoder", "fpn", "decoder"),
          "PointTriplane": ("point_triplane_projector", "camera_encoder",
                            "triplane_encoder", "fpn", "camera_decoder",
                            "surface_decoder")}


def build(cfg: dict, **extra):
    """Instantiate a registered component."""
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("type")
    if name not in REGISTRY:
        raise KeyError(f"unknown component {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](**cfg, **extra)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: LeCun-normal weights, zero biases, unit LayerNorm
    and BatchNorm scales, BatchNorm running statistics at mean 0 and
    variance 1, layer-scale ``gamma`` at its init constant."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d,
                          nn.ConvTranspose2d)):
            # a transposed conv's weight is (in, out, k, k)
            fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0]).numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * fan_in**-0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()  # weight 1, bias 0, mean 0, var 1
        if isinstance(m, ConvNeXtBlock) and m.gamma is not None:
            m.gamma.fill_(m.layer_scale_init)
        if isinstance(m, MaskConvNeXt):
            for p in m.parameters(recurse=False):
                # the dead mtoken: normal, std 0.02, clamped to +-0.02
                p.copy_((torch.randn(p.shape, generator=generator) * 0.02)
                        .clamp(-0.02, 0.02))


def set_kernels(model: nn.Module, enabled: bool) -> None:
    """Let the kernel gates decide (``enabled``) or send every kernel
    site, forward and backward, to its plain twin (``not enabled``)."""
    for m in model.modules():
        if isinstance(m, MaskConvNeXt):
            m.fuse_inference = enabled
        elif isinstance(m, MiTBlock):
            m.fuse_prologue = None if enabled else False
        elif isinstance(m, EfficientAttention):
            m.fuse_attention = None if enabled else False
        elif isinstance(m, TriplaneMAE):
            m.fuse_sampler = enabled
        elif isinstance(m, PointTriplaneProjector):
            m.fuse_mlp = enabled
        elif isinstance(m, JointEncoder):
            m.fuse_gather = enabled


def build_model(cfg: dict, device=None, dtype=torch.float32, seed: int = 0):
    """Build a ``TriplaneOcc``, ``TriplaneMAE``, ``PointTriplaneOcc``,
    ``PointTriplane`` or ``TriplaneElev`` from its config, seeded, in eval
    mode (no module of the port changes with train/eval; a training
    forward passes ``deterministic=False`` instead).

    ``device`` defaults to CUDA and raises without it unless the caller
    passes ``device="cpu"``.  Parameters are float32; ``dtype`` is the
    compute dtype (bfloat16 opens the kernel gates on CUDA).
    """
    dev = resolve_device(device)
    cfg = copy.deepcopy(dict(cfg))
    typ = cfg.pop("type")
    if typ not in MODELS:
        raise ValueError(f"this port builds {sorted(MODELS)}, not {typ!r}")
    if typ in ("PointTriplaneOcc", "PointTriplane"):
        # the projector's camera-feature width
        arch = cfg["camera_encoder"]["arch"]
        cfg["point_triplane_projector"]["cam_channels"] = (
            ARCH_SETTINGS[arch] if isinstance(arch, str) else arch
        )["channels"][-1]
    parts = {k: build(cfg.pop(k), dtype=dtype)
             for k in _PARTS[typ] if cfg.get(k) is not None}
    model = MODELS[typ](**parts, dtype=dtype, **cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

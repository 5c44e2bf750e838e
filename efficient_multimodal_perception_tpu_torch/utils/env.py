"""The run's environment (counterpart of the JAX package's
``utils/env.py``: the reference's ``collect_env`` and the dump its train
CLI prints at start), with PyTorch and CUDA in place of jax."""

from __future__ import annotations

import platform
import sys

import torch


def collect_env() -> dict:
    """Python, the platform, torch, the CUDA runtime torch was built with
    (None for a CPU build), the card's name and count where CUDA is
    available, and the package's version."""
    from .. import __version__

    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    info["efficient_multimodal_perception_tpu_torch"] = __version__
    return info


def env_string() -> str:
    return "\n".join(f"{k}: {v}" for k, v in collect_env().items())

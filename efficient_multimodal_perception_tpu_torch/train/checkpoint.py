"""Checkpoints: save and restore a trainer's state, and the name- and
shape-filtered partial load of a pretrain checkpoint into a fine-tune
model (counterpart of the JAX package's ``train/checkpoint.py``).

The port's own format: one ``torch.save`` file
``<work_dir>/checkpoints/step_<N>.pt`` holding ``step``, ``params`` (the
model's ``state_dict``) and ``opt`` (the optimizer's update count and its
moments by parameter name); it loads onto the CPU.  Saves are synchronous
(the JAX package's asynchronous orbax commit, its pruning of old saves and
its meta file are not carried over).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "checkpoints")


def _list_checkpoints(work_dir: str):
    """``(step, path)`` pairs sorted by step, oldest first."""
    d = _ckpt_dir(work_dir)
    if not os.path.isdir(d):
        return []
    return sorted(
        (int(m.group(1)), os.path.join(d, f))
        for f in os.listdir(d)
        if (m := re.fullmatch(r"step_(\d+)\.pt", f))
    )


def save_checkpoint(work_dir: str, step: int, state: dict) -> str:
    """Save ``state`` (``Trainer.state_dict()``) as
    ``<work_dir>/checkpoints/step_<step>.pt``; returns the path."""
    d = _ckpt_dir(work_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"step_{step}.pt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest checkpoint under ``work_dir``, or None."""
    steps = _list_checkpoints(work_dir)
    return steps[-1][1] if steps else None


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, trainer) -> int:
    """Restore a full trainer state saved by :func:`save_checkpoint`
    (same model and trainable parameters); returns its step."""
    trainer.load_state_dict(_load(path))
    return trainer.step


def restore_params_only(path: str) -> dict:
    """The saved model ``state_dict`` alone."""
    return _load(path)["params"]


def partial_load(params: dict, source: dict) -> Tuple[dict, int, int]:
    """Adopt every ``source`` entry whose name and shape match an entry
    of ``params`` (a target ``state_dict``), cast to the target's dtype
    and device; keep the target's value elsewhere.

    Returns ``(merged, n_adopted, n_target_entries)``.
    """
    merged, adopted = {}, 0
    for k, v in params.items():
        s = source.get(k)
        if s is not None and tuple(s.shape) == tuple(v.shape):
            merged[k] = s.to(dtype=v.dtype, device=v.device)
            adopted += 1
        else:
            merged[k] = v
    return merged, adopted, len(merged)

"""Checkpoints: save and restore a trainer's state, and the name- and
shape-filtered partial load of a pretrain checkpoint into a fine-tune
model (counterpart of the JAX package's ``train/checkpoint.py``).

The port's own format: one ``torch.save`` file
``<work_dir>/checkpoints/step_<N>.pt`` holding ``step``, ``params`` (the
model's ``state_dict``) and ``opt`` (the optimizer's update count and its
moments by parameter name); it loads onto the CPU.  Beside it
``step_<N>.pt.meta.json`` holds the run's meta (the config, CLASSES,
epoch and step; JAX ``step_<N>.meta.json``).  ``max_keep`` prunes all but
the newest saves (mmcv's ``max_keep_ckpts``).  An asynchronous save
(``async_save=True``, the JAX package's orbax ``AsyncCheckpointer``)
copies the state to host memory at once and writes it from a background
thread; :func:`wait_for_saves` joins the writes, and a write's failure is
raised there or at the next save.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Optional, Tuple

import torch

# the background write in flight (one at a time) and a failure not yet
# raised
_pending: list = []
_failed: list = []


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


def _to_host(obj):
    """A copy of ``obj`` whose tensors are detached host copies, so that
    the live state can change while the copy is written."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(work_dir, path, state, meta, max_keep):
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)
    if max_keep is not None and max_keep > 0:
        for _, old in _list_checkpoints(work_dir)[:-max_keep]:
            for f in (old, old + ".meta.json"):
                if os.path.exists(f):
                    os.remove(f)


def _write_in_background(*args):
    try:
        _write(*args)
    except BaseException as e:  # raised by wait_for_saves
        _failed.append(e)


def wait_for_saves() -> None:
    """Block until the asynchronous save in flight is on disk; raise the
    failure of one that did not get there."""
    while _pending:
        _pending.pop().join()
    if _failed:
        raise RuntimeError("an asynchronous checkpoint write failed") \
            from _failed.pop()


def save_checkpoint(work_dir: str, step: int, state: dict,
                    max_keep: Optional[int] = None,
                    meta: Optional[dict] = None,
                    async_save: bool = False) -> str:
    """Save ``state`` (``Trainer.state_dict()``) as
    ``<work_dir>/checkpoints/step_<step>.pt``, ``meta`` beside it as
    ``step_<step>.pt.meta.json``, then delete all but the newest
    ``max_keep`` saves; returns the path.

    With ``async_save`` the state is copied to host memory before the call
    returns and written by a background thread (the previous save's write
    is joined first, so saves land in order and pruning only ever removes
    saves that are on disk).
    """
    wait_for_saves()
    d = _ckpt_dir(work_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"step_{step}.pt")
    if not async_save:
        _write(work_dir, path, state, meta, max_keep)
        return path
    t = threading.Thread(target=_write_in_background,
                         args=(work_dir, path, _to_host(state), meta,
                               max_keep), daemon=True)
    t.start()
    _pending.append(t)
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

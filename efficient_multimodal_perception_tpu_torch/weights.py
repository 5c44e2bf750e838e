"""JAX parameter tree -> this port's ``state_dict``.

The port names its modules after the reference PyTorch ``state_dict``,
so this bridge is the inverse of the JAX package's torch-checkpoint
importer (flax path -> reference key).  Layouts: conv HWIO -> OIHW
(depthwise ``(k, k, 1, C)`` -> ``(C, 1, k, k)``), Dense ``(in, out)`` ->
``nn.Linear`` ``(out, in)``, LayerNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _leaf(leaf: str, arr: np.ndarray):
    """flax leaf name + value -> (torch leaf name, torch-layout array)."""
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim}")
    if leaf == "scale":
        return "weight", arr
    if leaf in ("bias", "gamma"):
        return leaf, arr
    raise KeyError(leaf)


def port_key(path: str, arr: np.ndarray):
    """One flax param path (``a/b/c``) -> ``(port key, array)``.

    Raises ``KeyError`` for a path this port has no parameter for.
    """
    p = path[len("params/"):] if path.startswith("params/") else path
    p = "/" + p  # a leading "/" lets every rule match a top-level module
    m = re.fullmatch(r"(.*)/downsample_layers_(\d)/(conv|norm)/(\w+)", p)
    if m:
        head, i, sub, leaf = m.group(1), int(m.group(2)), m.group(3), m.group(4)
        idx = (0 if sub == "conv" else 1) if i == 0 else (1 if sub == "conv" else 0)
        name, val = _leaf(leaf, arr)
        return f"{head}/downsample_layers/{i}/{idx}/{name}"[1:], val
    m = re.fullmatch(r"(.*)/stage(\d+)_block(\d+)/(\w+)", p)
    if m:
        head, i, j, leaf = m.groups()
        blk = f"{head}/stages/{i}/{j}"
        if leaf == "gamma":
            return f"{blk}/gamma"[1:], arr
        mod, _, leaf = leaf.rpartition("_")
        if mod not in ("dwconv", "norm", "pwconv1", "pwconv2"):
            raise KeyError(path)
        name, val = _leaf(leaf, arr)
        return f"{blk}/{mod}/{name}"[1:], val
    p = re.sub(r"position_encoder/fc1/", "position_encoder/0/", p)
    p = re.sub(r"position_encoder/fc2/", "position_encoder/2/", p)
    p = re.sub(r"^/(neck|camera_decoder|lidar_decoder)/block(\d+)/",
               r"/\1/transformer_block/\2/", p)
    p = p.replace("/attn/sr_norm/", "/attn/norm/")
    p = p.replace("/mlp/dwconv/", "/mlp/dwconv/dwconv/")
    p = re.sub(r"^/decoder/(conv\d)/", r"/decoder/\1/0/", p)
    head, _, leaf = p.rpartition("/")
    name, val = _leaf(leaf, arr)
    return f"{head}/{name}"[1:], val


def load_jax_params(flat: dict, model: torch.nn.Module | None = None) -> dict:
    """Map a flat ``{flax path: array}`` dict onto a port ``state_dict``.

    Fails on any JAX leaf it cannot place.  With ``model`` it also fails
    on any port parameter left unfilled, and on a shape mismatch.
    """
    sd, unplaced = {}, []
    for path, arr in flat.items():
        try:
            key, val = port_key(path, np.asarray(arr, np.float32))
        except KeyError:
            unplaced.append(path)
            continue
        key = key.replace("/", ".")
        if key in sd:
            raise ValueError(f"two JAX leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    if unplaced:
        raise KeyError(f"JAX leaves with no port parameter: {unplaced}")
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise KeyError(f"unfilled port params {missing}; "
                           f"unknown keys {extra}")
        bad = [k for k in want if tuple(want[k].shape) != tuple(sd[k].shape)]
        if bad:
            raise ValueError(
                "shape mismatch: " + ", ".join(
                    f"{k} {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
                    for k in bad)
            )
    return sd

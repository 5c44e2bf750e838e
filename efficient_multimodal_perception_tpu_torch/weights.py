"""JAX parameter tree -> this port's ``state_dict``.

The port names its modules after the reference PyTorch ``state_dict``,
so this bridge is the inverse of the JAX package's torch-checkpoint
importer (flax path -> reference key).  Layouts: conv HWIO -> OIHW
(depthwise ``(k, k, 1, C)`` -> ``(C, 1, k, k)``), 3-D conv DHWIO ->
OIDHW (the elevation heads' collapse), Dense ``(in, out)`` ->
``nn.Linear`` ``(out, in)``, LayerNorm and BatchNorm ``scale`` ->
``weight``; a transposed conv's kernel ``(kh, kw, I, O)``, which flax
applies unflipped, -> ``(I, O, kh, kw)`` flipped in space (the inverse
of ``tools/import_torch_ckpt._conv_transpose``); the dead ``mtoken{i}``
``(1, 1, 1, C)`` -> ``(1, C, 1, 1)``.  The ``batch_stats`` collection (paths prefixed
``batch_stats/``) gives BatchNorm's ``mean`` / ``var`` ->
``running_mean`` / ``running_var``; PyTorch's ``num_batches_tracked``,
which JAX has no counterpart of, is set to 0 beside every placed
``running_mean``.  The ``quant`` collection (paths prefixed ``quant/``,
a static int8 model's calibrated amaxes) gives the float32 scalar
buffers of the same leaf names (``ops.quant.add_site``): a ConvNeXt
block's ``fc1`` / ``fc2``, a MiT Linear's ``amax_in``, the occupancy
head's ``mm1``-``mm3``.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _leaf(leaf: str, arr: np.ndarray):
    """flax leaf name + value -> (torch leaf name, torch-layout array)."""
    if leaf == "kernel":
        if arr.ndim == 5:
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim}")
    if leaf == "scale":
        return "weight", arr
    if leaf in ("bias", "gamma"):
        return leaf, arr
    if leaf in ("mean", "var"):
        return f"running_{leaf}", arr
    raise KeyError(leaf)


# the point projector's flax modules -> the reference ``point_mlp`` index
_POINT_MLP = {"bn_in": 0, "fc0": 1, "bn0": 2, "fc1": 4, "bn1": 5, "fc2": 7,
              "bn2": 8, "fc_out": 10}


# the elevation heads' flax modules (``ElevUNetHead``; the automatic names
# of ``ResnetBasicBlockHead``) -> the port's, under ``decoder/``
_ELEV_HEAD = {"proj": "proj/0", "stem": "decoder/encoder/conv1",
              "stem_bn": "decoder/encoder/bn1",
              "head": "decoder/segmentation_head/0",
              "Conv_0": "proj/0", "_ResBlock_0": "block", "Conv_1": "head"}
# ``_ResBlock``'s shortcut -> torchvision's ``downsample`` indices
_DOWN = {"down_conv": "downsample/0", "down_bn": "downsample/1"}


def _elev_head(p: str) -> str:
    """An elevation head's flax path (``/decoder/...``) -> the port's;
    other paths unchanged."""
    m = re.fullmatch(r"/decoder/enc(\d)_(\d+)/(\w+)/(\w+)", p)
    if m:
        i, j, sub, leaf = m.groups()
        return (f"/decoder/decoder/encoder/layer{int(i) + 1}/{j}/"
                f"{_DOWN.get(sub, sub)}/{leaf}")
    m = re.fullmatch(r"/decoder/dec(\d)_(\d)(_bn)?/(\w+)", p)
    if m:
        i, j, bn, leaf = m.groups()
        return (f"/decoder/decoder/decoder/blocks/{i}/conv{int(j) + 1}/"
                f"{1 if bn else 0}/{leaf}")
    m = re.fullmatch(r"/decoder/_ResBlock_0/(\w+)/(\w+)", p)
    if m:
        sub, leaf = m.groups()
        return f"/decoder/block/{_DOWN.get(sub, sub)}/{leaf}"
    m = re.fullmatch(r"/decoder/(\w+)/(\w+)", p)
    if m and m.group(1) in _ELEV_HEAD:
        return f"/decoder/{_ELEV_HEAD[m.group(1)]}/{m.group(2)}"
    return p


def port_key(path: str, arr: np.ndarray):
    """One flax path (``a/b/c``, optionally prefixed ``params/``,
    ``batch_stats/`` or ``quant/``) -> ``(port key, array)``.

    Raises ``KeyError`` for a path this port has no parameter for.
    """
    if path.startswith("quant/"):
        head, _, leaf = ("/" + path.split("/", 1)[1]).rpartition("/")
        head = re.sub(r"/stage(\d+)_block(\d+)$", r"/stages/\1/\2", head)
        head = re.sub(r"^/neck/block(\d+)/", r"/neck/transformer_block/\1/",
                      head)
        return f"{head}/{leaf}"[1:], arr
    stats = path.startswith("batch_stats/")
    p = path.split("/", 1)[1] if stats or path.startswith("params/") else path
    if stats != (p.rpartition("/")[2] in ("mean", "var")):
        raise KeyError(path)
    p = "/" + p  # a leading "/" lets every rule match a top-level module
    m = re.fullmatch(r"(.*)/(mtoken\d)", p)
    if m:
        return f"{m.group(1)}/{m.group(2)}"[1:], np.transpose(arr, (0, 3, 1, 2))
    m = re.fullmatch(r"(.*)/reduce_dim_(\d)_(kernel|bias)", p)
    if m:
        name, val = _leaf(m.group(3), arr)
        return f"{m.group(1)}/reduce_dim/{m.group(2)}/{name}"[1:], val
    m = re.fullmatch(r"(.*)/conv_transpose/kernel", p)
    if m:
        return (f"{m.group(1)}/conv_transpose/weight"[1:],
                np.transpose(arr[::-1, ::-1], (2, 3, 0, 1)))
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
    p = _elev_head(p)
    m = re.fullmatch(r"/point_triplane_projector/(\w+)/(\w+)", p)
    if m and m.group(1) in _POINT_MLP:
        p = (f"/point_triplane_projector/point_mlp/{_POINT_MLP[m.group(1)]}"
             f"/{m.group(2)}")
    p = re.sub(r"/(mlp_xy|mlp_yz|mlp_xz)_fc1/", r"/\1/0/", p)
    p = re.sub(r"/(mlp_xy|mlp_yz|mlp_xz)_fc2/", r"/\1/2/", p)
    p = re.sub(r"^/fpn/lateral(\d+)/", r"/fpn/lateral_convs/\1/", p)
    p = re.sub(r"^/fpn/fpn(\d+)/", r"/fpn/fpn_convs/\1/", p)
    # InterpNet's and PointMlp's hidden layers (fc_in and fc_out keep
    # their names)
    p = re.sub(r"^/(surface_decoder|color_decoder)/mlp_(\d)/",
               r"/\1/mlp_layers/\2/", p)
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
        # ascontiguousarray makes a 0-d amax 1-d: keep the shape
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(val).reshape(np.shape(val)))
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
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

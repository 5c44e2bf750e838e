"""Import a reference (PyTorch, mmcv) checkpoint into the port.

The reference fine-tunes from its own ``.pth`` files (``{"state_dict":
..., "meta": ...}``).  The port's modules carry the reference's
``state_dict`` names, so no key mapping is needed; three things differ:

* the encoders' out-norms ``(lidar|camera|triplane)_encoder.norm<i>.*``,
  registered in the reference but never applied, and ``TriplaneMAE``'s
  unused ``proj_cam_downsample.*`` / ``proj_range_downsample.*``: the
  port has none of them, so they are dropped (the names the JAX package's
  ``tools/import_torch_ckpt.map_torch_key`` drops, save
  ``num_batches_tracked``, which the port's BatchNorms keep);
* the occupancy head's 1x1x1 ``Conv3d`` weights
  ``decoder.conv{1,2,3}.0.weight`` are ``(O, I, 1, 1, 1)`` in the
  reference and ``(O, I)`` in the port.

Every other tensor keeps its name and shape.  The output is a ``.pt``
holding ``{"params": state_dict}``, which the port's checkpoint readers
take (``train.checkpoint.restore_params_only``): the train CLI's
``--ckpt-path``, ``eval_cli --checkpoint``, ``serve --checkpoint`` and
``tools/export.py --checkpoint``::

    python -m efficient_multimodal_perception_tpu_torch.tools.import_torch_ckpt \\
        epoch_40.pth out_dir/      # writes out_dir/imported.pt
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import sys

import torch

DEAD = re.compile(r"(^|\.)((lidar|camera|triplane)_encoder\.norm\d+|"
                  r"proj_(cam|range)_downsample)\.")
HEAD_1X1 = re.compile(r"decoder\.conv[123]\.0\.weight")


def reference_key(key: str):
    """A reference ``state_dict`` key -> the port's key (the same name),
    or None for a tensor the port does not have."""
    return None if DEAD.search(key) else key


def convert_state_dict(sd: dict):
    """A reference ``state_dict`` -> ``(port state_dict, converted keys,
    skipped keys)``; the head's 1x1x1 ``Conv3d`` weights become the
    port's ``(O, I)``."""
    port, converted, skipped = {}, [], []
    for key, val in sd.items():
        name = reference_key(key)
        if name is None:
            skipped.append(key)
            continue
        if HEAD_1X1.fullmatch(name) and val.dim() == 5:
            val = val.reshape(val.shape[:2])
        port[name] = val
        converted.append(key)
    return port, converted, skipped


def load_reference(path: str) -> dict:
    """The ``state_dict`` of a reference ``.pth`` (unwrapped from mmcv's
    ``{"state_dict": ..., "meta": ...}`` when it is wrapped).  Only
    tensors and plain containers load (``weights_only``): a file that
    pickles another object fails with that object's name."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        m = re.search(r"GLOBAL ([\w.]+)", str(e))
        name = m.group(1) if m else "an object"
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refuses {name}") from e
    sd = blob.get("state_dict", blob)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("torch_ckpt", help=".pth file (mmcv format or raw)")
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    sd, converted, skipped = convert_state_dict(load_reference(
        args.torch_ckpt))
    print(f"converted {len(converted)} tensors, skipped {len(skipped)}")
    for k in skipped:
        print(f"  skipped: {k}")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(args.out_dir), "imported.pt")
    torch.save({"params": sd}, path)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

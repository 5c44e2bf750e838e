"""Export a model of the port as a ``torch.export`` serving artifact
(counterpart of the JAX package's ``tools/export.py``).

    python -m efficient_multimodal_perception_tpu_torch.tools.export \\
        triplane_occ --checkpoint WORK_DIR/checkpoints/step_N.pt \\
        --out build/occ.pt2 --bf16 [--batch-size 4] [--int8] [--validate]
    python -m efficient_multimodal_perception_tpu_torch.tools.export \\
        tiny_occ --out build/tiny_occ.pt2 --device cpu --validate

The artifact is one ``torch.export.save`` file: the traced inference
function and its calling convention, loadable in another process without
the model code through :func:`load_artifact`, which imports only the
port's ops module (it registers the ``emp::`` operators the kernels run
as) before ``torch.export.load``.  Exported on CUDA in bf16, the graph
calls the Hopper kernels as ``torch.ops.emp.*`` nodes, and a run of the
loaded program launches them as the live model does; exported on the CPU
(or in float32) it holds the plain twins' PyTorch operators.  Unlike the
JAX artifact, which takes the variables as arguments, this one carries
its weights (PyTorch's idiom): it is called with the batch alone.

The artifact's inputs are the serve protocol's tensors by name
(``serve.BATCH_KEYS``; the point family and the pretraining models also
``POINT_KEYS``), at the exported batch size; it returns what
``tools/export.py``'s inference functions return:

* occupancy (``TriplaneOcc`` / ``PointTriplaneOcc``): the int8 argmax
  class map ``(B, 99, 99, 16)``;
* elevation (``TriplaneElev``): float32 heights ``(B, 100, 100)``;
* pretraining (``TriplaneMAE`` / ``PointTriplane``): a dict of float32
  losses, whose draws (``model.draw`` from a generator seeded 1, as the
  JAX artifact holds ``jax.random.key(1)``) are constants of the
  artifact.

``--validate`` loads the file back and compares it with the live model
on the synthetic batch it was traced on: class maps and heights equal,
losses within 1e-5 relative.  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.nn as nn

LOSS_RTOL = 1e-5  # --validate: artifact against live losses, relative


def load_artifact(path: str):
    """The ``torch.export`` program saved at ``path``, loaded after the
    port's ops module has registered the ``emp::`` operators (and nothing
    of the model code).  ``torch.export.load`` raises on a program whose
    ops are not registered: no twin stands in.  Call ``.module()`` on the
    result, under ``torch.inference_mode()``, with the batch's tensors by
    name."""
    from ..ops import kernels  # noqa: F401  (registers emp::)

    return torch.export.load(path)


def artifact_keys(model) -> tuple:
    """The artifact's input names: the serve protocol's keys, plus the
    raw point cloud for the point family and the pretraining models
    (whose losses may read it)."""
    from ..serve import BATCH_KEYS, POINT_KEYS

    points = getattr(model, "uses_points", False) or hasattr(model, "draw")
    return BATCH_KEYS + (POINT_KEYS if points else ())


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}__"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("__")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@contextlib.contextmanager
def fixed_draws(model, draws: dict):
    """``model.draw`` returns ``draws`` inside the block (the pretraining
    models' loss draws held fixed)."""
    model.draw = lambda batch, generator: draws
    try:
        yield
    finally:
        del model.draw


def batch_of(t: dict):
    """The ``Batch`` of the artifact's input tensors by name."""
    from ..core.geometry import CameraAug
    from ..data.batch import Batch

    return Batch(img=t["img"], range_image=t["range_image"],
                 range_points=t["range_points"], lidar2img=t["lidar2img"],
                 cam_aug=CameraAug(resize=t["cam_resize"], crop=t["cam_crop"],
                                   flip=t["cam_flip"].bool()),
                 points=t.get("points"), points_valid=t.get("points_valid"))


def loss_draws(model, inputs: dict):
    """The pretraining models' loss draws on ``inputs``: ``model.draw``
    from a generator seeded 1 on their device (None for a model that does
    not draw)."""
    if not hasattr(model, "draw"):
        return None
    dev = next(iter(inputs.values())).device
    return model.draw(batch_of(inputs), torch.Generator(dev).manual_seed(1))


class InferModule(nn.Module):
    """The inference function of ``model`` over the batch's tensors by
    name (``build_infer_fn``'s counterpart in ``tools/export.py``):
    ``forward(**tensors)`` returns the int8 class map, the float32
    heights or the dict of float32 losses.  ``draws`` are the pretraining
    models' loss draws, held as buffers."""

    def __init__(self, model: nn.Module, draws: dict | None = None):
        super().__init__()
        from ..models.triplane_elev import TriplaneElev

        self.model = model
        self.keys = artifact_keys(model)
        self.kind = ("losses" if hasattr(model, "draw") else
                     "heights" if isinstance(model, TriplaneElev) else
                     "classes")
        self.draw_names = []
        for k, v in _flat(draws or {}).items():
            self.register_buffer(f"draw_{k}", v)
            self.draw_names.append(k)

    def forward(self, img, range_image, range_points, lidar2img, cam_resize,
                cam_crop, cam_flip, points=None, points_valid=None):
        batch = batch_of(dict(
            img=img, range_image=range_image, range_points=range_points,
            lidar2img=lidar2img, cam_resize=cam_resize, cam_crop=cam_crop,
            cam_flip=cam_flip, points=points, points_valid=points_valid))
        if self.kind == "classes":
            logits = self.model(batch)[0]
            return torch.argmax(logits, dim=-1).to(torch.int8)
        if self.kind == "heights":
            return self.model(batch)[0].float()
        draws = _nest({k: getattr(self, f"draw_{k}")
                       for k in self.draw_names})
        with fixed_draws(self.model, draws):
            out = self.model(batch)
        losses = out[-1] if isinstance(out, tuple) else out
        return {k: v.float() for k, v in losses.items()}


def example_inputs(cfg: dict, keys, batch_size: int, device) -> dict:
    """The synthetic batch (seed 0, the config's cameras, image size and
    point budget) the artifact is traced on, by input name."""
    from ..data.synthetic import synthetic_arrays

    data = cfg["data"]
    arrs = synthetic_arrays(batch_size, num_cams=data["num_cams"],
                            image_hw=tuple(data["image_size"]),
                            point_budget=data["point_budget"], seed=0)
    return {k: torch.from_numpy(arrs[k]).to(device) for k in keys}


def build(cfg_name: str, checkpoint=None, bf16: bool = False,
          int8: bool = False, batch_size: int = 4, seed: int = 0,
          device=None):
    """``(InferModule, example inputs)`` of a config: the model from
    ``seed`` (or a ``train/cli.py`` checkpoint, loaded strictly), in bf16
    compute with ``bf16``, with the dynamic int8 products with ``int8``."""
    from .. import resolve_device
    from ..configs import get_config
    from ..models.builder import build_model
    from ..ops.quant import enable_int8
    from ..train.checkpoint import restore_params_only

    dev = resolve_device(device)
    cfg = get_config(cfg_name)
    if int8:
        enable_int8(cfg["model"])
    model = build_model(cfg["model"], device=dev,
                        dtype=torch.bfloat16 if bf16 else torch.float32,
                        seed=seed)
    if checkpoint:
        model.load_state_dict(restore_params_only(checkpoint), strict=True)
    model.requires_grad_(False)
    inputs = example_inputs(cfg, artifact_keys(model), batch_size, dev)
    return InferModule(model, loss_draws(model, inputs)), inputs


def export(module: InferModule, inputs: dict):
    """``torch.export.export`` of ``module`` on ``inputs`` (no
    gradients, static shapes)."""
    with torch.no_grad():
        return torch.export.export(module, (), kwargs=inputs, strict=False)


def run(program_or_module, inputs: dict):
    """One call of a live :class:`InferModule` or of an exported
    program's module, under ``torch.inference_mode``."""
    with torch.inference_mode():
        return program_or_module(**inputs)


def outputs_match(got, want) -> list:
    """The mismatches between two artifact outputs (empty when they
    agree): class maps and heights bit for bit, losses within
    ``LOSS_RTOL`` relative."""
    if isinstance(want, dict):
        bad = [] if set(got) == set(want) else [f"keys {sorted(got)}"]
        for k in want:
            g, w = float(got[k]), float(want[k])
            if not abs(g - w) <= LOSS_RTOL * max(abs(w), 1e-30):
                bad.append(f"{k}: {g} vs {w}")
        return bad
    if got.shape != want.shape or got.dtype != want.dtype:
        return [f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                f"{want.dtype}"]
    return [] if torch.equal(got, want) else [
        f"{int((got != want).sum())} of {want.numel()} values differ"]


def emp_op_counts(program) -> dict:
    """``{kernel: calls}`` of the ``emp::`` ops in an exported program's
    graph (an op is named as its ``ops.kernels.LAUNCHES`` key)."""
    counts: dict = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if name.startswith("emp::"):
            key = name[len("emp::"):]
            counts[key] = counts.get(key, 0) + 1
    return counts


def describe(out) -> list:
    """``[(name, shape, dtype)]`` of an artifact's outputs."""
    items = out.items() if isinstance(out, dict) else [("out", out)]
    return [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in items]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None,
                   help="a train/cli.py checkpoint (step_<N>.pt)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (the kernels' dtype on CUDA)")
    p.add_argument("--int8", action="store_true",
                   help="export the dynamic-int8 graph (ops/quant.py)")
    p.add_argument("--validate", action="store_true",
                   help="load the artifact back and compare it with the "
                        "live model on the traced batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    module, inputs = build(args.config, args.checkpoint, args.bf16,
                           args.int8, args.batch_size, args.seed,
                           args.device)
    t0 = time.perf_counter()
    program = export(module, inputs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    dev = next(iter(inputs.values())).device
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.1f} s, device={dev}, "
          f"outputs={describe(run(program.module(), inputs))}", flush=True)
    if args.validate:
        got = run(load_artifact(args.out).module(), inputs)
        bad = outputs_match(got, run(module, inputs))
        if bad:
            raise AssertionError(f"validate: the artifact differs from the "
                                 f"live model: {bad}")
        print("validate: loaded artifact matches the live model", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

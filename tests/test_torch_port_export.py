"""``tools/export.py`` of the port (``torch.export`` artifacts), on the CPU.

- tiny ``triplane_occ`` and ``triplane_elev`` artifacts on weights drawn
  with numpy for the JAX variables' shapes (bridged through
  ``weights.load_jax_params``): saved, loaded back equal to the live
  port bit for bit, and against the JAX package's ``tools/export.py``
  artifact (``build_infer_fn`` + ``jax.export``, as
  ``tests/test_misc.py::test_export_roundtrip`` builds it, under full
  matmul precision) on the same batch: class maps equal on at least
  99.9% of the voxels (an argmax can flip where two logits sit within
  the packages' float32 rounding), heights within 1e-4;
- the elevation artifact through the export CLI, ``main([...,
  "--device", "cpu", "--validate"])`` from a checkpoint of those weights
  (the CLI holds the loaded artifact to the live model bit for bit, the
  test holds the live model to JAX's artifact);
- tiny ``point_triplane_occ`` and ``triplane_surf_sam`` (a
  ``TriplaneMAE``: a dict of losses whose SupCon and surface draws the
  artifact holds) artifacts from seeded weights, loaded back equal to
  the live port bit for bit;
- the occupancy artifact loaded in a fresh process through
  ``load_artifact``, which imports no model module: the same class map;
  in that process ``torch.export.load`` alone, before the ops are
  registered, raises on an artifact that holds an ``emp::`` op (a
  module calling ``ops.kernels.attention_op`` on CPU tensors).

On the CPU (and in float32) the gates keep the kernels off, so these
graphs hold the twins' PyTorch operators; the card's tests and
``chip_smoke.py`` export on CUDA in bf16, where they hold ``emp::`` ops.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax import export as jexport

from efficient_multimodal_perception_tpu.configs.tiny import (
    tiny_elev as jax_tiny_elev,
    tiny_occ as jax_tiny_occ,
)
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.tools import export as X
from efficient_multimodal_perception_tpu_torch.weights import load_jax_params
from test_torch_port_elev import _draw, _jax_batch as jax_elev_batch, _tree
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_occ import jax_batch as jax_occ_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASS_AGREE = 0.999
HEIGHT_TOL = 1e-4


def _jax_artifact(cfg, model_type, arrs, to_batch, seed):
    """The JAX ``tools/export.py`` artifact of ``cfg`` on drawn variables,
    serialized, deserialized and called on ``arrs``; returns the drawn
    flat variables and the artifact's output."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from export import build_infer_fn
    finally:
        sys.path.pop(0)
    model = jax_build_model(cfg)
    batch = to_batch(arrs)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True), batch)
    flat = _draw(shapes, seed)
    variables = {c: _tree(flat, c) for c in shapes}
    with jax.default_matmul_precision("highest"):
        exported = jexport.export(jax.jit(build_infer_fn(model, model_type)))(
            variables, batch)
    back = jexport.deserialize(exported.serialize())
    return flat, np.asarray(back.call(variables, batch))


def _inputs(name):
    """The example inputs the export tool traces ``name`` on at batch 1,
    and the same synthetic arrays for JAX."""
    data = get_config(name)["data"]
    arrs = synthetic_arrays(1, num_cams=data["num_cams"],
                            image_hw=tuple(data["image_size"]),
                            point_budget=data["point_budget"], seed=0,
                            with_occ=True, with_elev=True)
    return arrs


@pytest.fixture(scope="module")
def occ_artifact(tmp_path_factory):
    """tiny_occ on drawn weights: the artifact's path, its inputs, the
    loaded artifact's and the live port's class maps, JAX's."""
    arrs = _inputs("tiny_occ")
    flat, want_jax = _jax_artifact(jax_tiny_occ(), "TriplaneOcc", arrs,
                                   jax_occ_batch, 3)
    model = build_model(get_config("tiny_occ")["model"], device="cpu")
    model.load_state_dict(load_jax_params(flat, model), strict=True)
    module = X.InferModule(model.requires_grad_(False))
    inputs = {k: torch.from_numpy(arrs[k]) for k in module.keys}
    path = str(tmp_path_factory.mktemp("occ") / "occ.pt2")
    torch.export.save(X.export(module, inputs), path)
    return dict(path=path, inputs=inputs, jax=want_jax,
                live=X.run(module, inputs),
                loaded=X.run(X.load_artifact(path).module(), inputs))


def test_occ_artifact_equals_live_and_jax(occ_artifact):
    got = occ_artifact["loaded"]
    assert got.dtype == torch.int8 and got.shape == (1, 99, 99, 16)
    assert torch.equal(got, occ_artifact["live"])
    want = occ_artifact["jax"]
    assert want.dtype == np.int8 and want.shape == got.shape
    assert (got.numpy() == want).mean() >= CLASS_AGREE


def test_export_cli_validates_elev_and_matches_jax(tmp_path, capsys):
    """The CLI's ``--validate`` holds the loaded artifact to the live
    model bit for bit; the live heights are then held to JAX's
    artifact."""
    arrs = _inputs("tiny_elev")
    flat, want = _jax_artifact(jax_tiny_elev(), "TriplaneElev", arrs,
                               jax_elev_batch, 7)
    model = build_model(get_config("tiny_elev")["model"], device="cpu")
    sd = load_jax_params(flat, model)
    ckpt = str(tmp_path / "step_1.pt")
    torch.save({"params": sd}, ckpt)
    out = str(tmp_path / "elev.pt2")
    assert X.main(["tiny_elev", "--checkpoint", ckpt, "--out", out,
                   "--batch-size", "1", "--device", "cpu",
                   "--validate"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"wrote {out}: ")
    assert "outputs=[('out', (1, 100, 100), 'float32')]" in lines[0]
    assert lines[-1] == "validate: loaded artifact matches the live model"
    model.load_state_dict(sd, strict=True)
    module = X.InferModule(model)
    got = X.run(module, {k: torch.from_numpy(arrs[k]) for k in module.keys})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=HEIGHT_TOL,
                               rtol=HEIGHT_TOL)


@pytest.mark.parametrize("name", ["tiny_point_occ", "tiny_surf_sam"])
def test_artifact_equals_live(name, tmp_path):
    module, inputs = X.build(name, batch_size=1, seed=1, device="cpu")
    path = str(tmp_path / f"{name}.pt2")
    torch.export.save(X.export(module, inputs), path)
    got = X.run(X.load_artifact(path).module(), inputs)
    want = X.run(module, inputs)
    if isinstance(want, dict):
        assert module.draw_names  # the losses' draws are constants
        assert set(got) == set(want) and len(want) >= 2
        for k in want:
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], want[k]), k
    else:
        assert got.shape == (1, 99, 99, 16)
        assert torch.equal(got, want)


FRESH = """
import sys, torch
path, inputs, out, with_op = sys.argv[1:5]
try:
    torch.export.load(with_op)
except Exception as e:
    print("unregistered load raised", type(e).__name__)
from efficient_multimodal_perception_tpu_torch.tools.export import (
    load_artifact)
load_artifact(with_op)
program = load_artifact(path).module()
with torch.inference_mode():
    torch.save(program(**torch.load(inputs)), out)
models = sorted(m for m in sys.modules
                if m.startswith("efficient_multimodal_perception_tpu_torch.")
                and not m.split(".")[1] in ("ops", "tools"))
print("imported", models)
"""


class _Attention(torch.nn.Module):
    def forward(self, q):
        from efficient_multimodal_perception_tpu_torch.ops import kernels

        return kernels.attention_op(q, q, q, 0.5)


def test_artifact_loads_in_a_fresh_process(occ_artifact, tmp_path):
    inputs, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt")
    torch.save(occ_artifact["inputs"], inputs)
    with_op = str(tmp_path / "attention.pt2")
    program = torch.export.export(_Attention(), (torch.ones(1, 64, 8),))
    assert "emp.attention.default" in str(program.graph)
    torch.export.save(program, with_op)
    res = subprocess.run(
        [sys.executable, "-c", FRESH, occ_artifact["path"], inputs, out,
         with_op],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert "unregistered load raised RuntimeError" in lines
    assert lines[-1] == "imported []"
    assert torch.equal(torch.load(out), occ_artifact["loaded"])

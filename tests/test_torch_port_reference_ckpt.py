"""The reference's torch checkpoints in the port
(``tools/import_torch_ckpt.py``) against the JAX package's importer
(root ``tools/import_torch_ckpt.py``).

* At full width, with no forward (the meta device): each of
  ``tests/torch_ref.py``'s five models' ``state_dict`` goes through the
  port's ``convert_state_dict`` beside the port's model of the matching
  config.  The skipped names are exactly the dead ones (ROADMAP A18), the
  names the JAX importer drops save ``num_batches_tracked``; occ, elev,
  point-occ and the MAE load strictly; ``point_triplane``'s only leftovers
  are ``surface_decoder.*``, which ``torch_ref.PointTriplane`` lacks.  The
  chip phase's writer (``chip_smoke.reference_state_dict``) gives the
  reference's names and shapes.
* At tiny width, with numbers: a seeded, perturbed port model written in
  the reference's form as an mmcv ``.pth`` goes into the port through the
  tool and into the JAX package through root ``convert_state_dict`` +
  ``split_collections`` + ``partial_load`` (every leaf adopted); both
  f32 forwards agree within 1e-4 max abs on one synthetic batch.
  ``tiny_elev`` takes the shipped ``Unet`` head in both packages: the JAX
  importer maps the U-Net head's keys only.
* The readers: ``eval_cli --checkpoint``, ``serve.make_model`` and
  ``tools/export.build`` take an imported occ file; the train CLI's
  ``--ckpt-path`` takes an imported MAE and adopts every encoder and neck
  tensor, only the decoder's left.
"""

import importlib.util
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.configs import tiny as jax_tiny
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.train.checkpoint import (
    partial_load as jax_partial_load,
)
from efficient_multimodal_perception_tpu_torch import serve
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.tools import export
from efficient_multimodal_perception_tpu_torch.tools.import_torch_ckpt import (
    convert_state_dict,
    load_reference,
    main as import_main,
)
from efficient_multimodal_perception_tpu_torch.train import cli, eval_cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    restore_params_only,
)
import torch_ref as R
from test_full_parity import CAMERA_CFG, LIDAR_CFG
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_train_cli import _run

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from import_torch_ckpt import (  # noqa: E402
    convert_state_dict as jax_convert_state_dict,
    map_torch_key,
    split_collections,
)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-4  # max abs (tests/test_full_parity.py's occ-logit tolerance)

# tests/test_full_parity.py's point-family encoders
POINT_CAMERA = dict(CAMERA_CFG, out_indices=3)
TRIPLANE = dict(depths=(3, 3, 9, 3), channels=(96, 192, 384, 768),
                in_channels=128, stem_patch_size=(1, 1), norm_out=True,
                out_indices=3)
RANGE_DEAD = ("encoder.camera_encoder.norm1", "encoder.lidar_encoder.norm3")
POINT_DEAD = ("camera_encoder.norm3", "triplane_encoder.norm3")
FULL = {  # port config -> (reference model, its dead modules: ROADMAP A18)
    "triplane_occ": (lambda: R.TriplaneOcc(LIDAR_CFG, CAMERA_CFG),
                     RANGE_DEAD),
    "triplane_range_cam": (lambda: R.TriplaneMAE(LIDAR_CFG, CAMERA_CFG),
                           RANGE_DEAD + ("proj_cam_downsample",
                                         "proj_range_downsample")),
    "triplane_elev": (lambda: R.TriplaneElev(LIDAR_CFG, CAMERA_CFG),
                      RANGE_DEAD),
    "point_triplane_occ": (lambda: R.PointTriplaneOcc(POINT_CAMERA,
                                                      TRIPLANE), POINT_DEAD),
    "point_triplane": (lambda: R.PointTriplane(POINT_CAMERA, TRIPLANE),
                       POINT_DEAD),
}


@pytest.mark.parametrize("cfg_name", sorted(FULL))
def test_full_width_names_and_shapes(cfg_name):
    make, dead = FULL[cfg_name]
    with torch.device("meta"):
        ref = make()
        port = build_model(get_config(cfg_name)["model"], device="meta")
    sd = ref.state_dict()
    got, converted, skipped = convert_state_dict(sd)
    assert sorted(skipped) == sorted(f"{m}.{leaf}" for m in dead
                                     for leaf in ("weight", "bias"))
    assert skipped == [k for k in sd if map_torch_key(k)[0] is None
                       and not k.endswith("num_batches_tracked")]
    assert converted == [k for k in sd if k not in skipped]
    want = port.state_dict()
    assert not set(got) - set(want)
    bad = [k for k in got if got[k].shape != want[k].shape]
    assert not bad, bad
    left = sorted(set(want) - set(got))
    if cfg_name == "point_triplane":
        assert left and all(k.startswith("surface_decoder.") for k in left)
        assert left == sorted(k for k in want
                              if k.startswith("surface_decoder."))
    else:
        assert not left
        port.load_state_dict(got, strict=True, assign=True)
    written = chip_smoke.reference_state_dict(torch, port)
    assert {k: tuple(v.shape) for k, v in written.items()
            if k not in left} == {k: tuple(v.shape) for k, v in sd.items()}


def test_importer_refuses_pickled_objects(tmp_path):
    """Only tensors and plain containers load: a file that pickles another
    object fails with its name, and nothing is written."""
    path = tmp_path / "blocked.pth"
    torch.save({"state_dict": {"w": torch.zeros(2)},
                "meta": {"hook": Blocked()}}, path)
    with pytest.raises(ValueError, match=r"refuses [\w.]*Blocked"):
        import_main([str(path), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    # a raw state_dict (no mmcv wrapper) loads as it is
    torch.save({"w": torch.ones(3)}, tmp_path / "raw.pth")
    assert torch.equal(load_reference(str(tmp_path / "raw.pth"))["w"],
                       torch.ones(3))


class Blocked:
    """An object a ``weights_only`` load refuses."""


# ---------------------------------------------------------------------------
# tiny width: numbers against the JAX package
# ---------------------------------------------------------------------------

UNET = dict(type="Unet", input_dim=32, height_dim=80, pad=14)
TINY = {  # port config -> (its JAX model config, with_occ, with_elev)
    "tiny_occ": (jax_tiny.tiny_occ(), True, False),
    "tiny_point_occ": (jax_tiny.tiny_point(occ=True), True, False),
    "tiny_elev": (dict(jax_tiny.tiny_elev(), decoder=UNET), False, True),
}


def port_config(cfg_name):
    model = get_config(cfg_name)["model"]
    return dict(model, decoder=UNET) if cfg_name == "tiny_elev" else model


def perturbed_port_model(cfg_name, seed=0):
    """The seeded port model with every parameter perturbed from ``seed``
    (weights scaled by 1 + N(0, 0.1) each, so that deep heads keep their
    scale; biases and norm scales moved by N(0, 0.1)) and chip_smoke's
    drawn layer-scale gamma and BatchNorm statistics."""
    model = build_model(port_config(cfg_name), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            noise = 0.1 * torch.randn(p.shape, generator=g)
            p.add_(p * noise if p.dim() > 1 else noise)
    return chip_smoke.draw_gamma_and_stats(torch, model)


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """``cfg_name -> (reference .pth, imported .pt, importer's output)``,
    made on first use."""
    made = {}

    def get(cfg_name):
        if cfg_name not in made:
            d = tmp_path_factory.mktemp(cfg_name)
            model = (build_model(get_config(cfg_name)["model"], device="cpu")
                     if cfg_name == "tiny_range_cam"
                     else perturbed_port_model(cfg_name))
            pth = str(d / "epoch_40.pth")
            dead = chip_smoke.write_reference(torch, model, cfg_name, pth)
            out = _run(import_main, [pth, str(d)]).splitlines()
            assert out[0] == (f"converted {len(model.state_dict())} "
                              f"tensors, skipped {len(dead)}")
            assert sorted(out[1:len(dead) + 1]) == [f"  skipped: {k}"
                                                    for k in dead]
            made[cfg_name] = (pth, str(d / "imported.pt"), out)
        return made[cfg_name]

    return get


def jax_batch(arrs):
    extra = {k: jnp.asarray(arrs[k]) for k in (
        "points", "points_valid", "occupancy", "elevation",
        "elevation_mask") if k in arrs}
    return JBatch(img=jnp.asarray(arrs["img"]),
                  range_image=jnp.asarray(arrs["range_image"]),
                  range_points=jnp.asarray(arrs["range_points"]),
                  lidar2img=jnp.asarray(arrs["lidar2img"]),
                  cam_aug=JAug(jnp.asarray(arrs["cam_resize"]),
                               jnp.asarray(arrs["cam_crop"]),
                               jnp.asarray(arrs["cam_flip"])),
                  **extra)


def jax_forward(cfg_name, pth, arrs):
    """The JAX package's f32 output on ``arrs`` with the weights of
    ``pth`` taken through its own importer (every leaf adopted)."""
    jcfg = TINY[cfg_name][0]
    sd = {k: v.numpy() for k, v in load_reference(pth).items()}
    tree, _, skipped = jax_convert_state_dict(sd)
    assert all(re.search(r"norm\d\.|num_batches_tracked", k)
               for k in skipped)
    imported = split_collections(tree)
    model = jax_build_model(jcfg)
    jb = jax_batch(arrs)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True), jb)
    variables = {}
    for col, target in shapes.items():
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), target)
        variables[col], n_ok, n_all = jax_partial_load(zeros, imported[col])
        assert n_ok == n_all, f"{col}: adopted {n_ok}/{n_all}"
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, b: model.apply(v, b, deterministic=True))(
            variables, jb)
    return np.asarray(out[0])


@pytest.mark.parametrize("cfg_name", sorted(TINY))
def test_tiny_reference_checkpoint_matches_jax(reference_files, cfg_name):
    """One reference-form ``.pth``: the port (through its importer; the
    occupancy models through ``serve.make_model``'s strict load) and the
    JAX package (through its importer) give the same f32 output."""
    pth, imported, _ = reference_files(cfg_name)
    _, with_occ, with_elev = TINY[cfg_name]
    arrs = synthetic_arrays(1, point_budget=4096, with_occ=with_occ,
                            with_elev=with_elev, seed=3)
    if cfg_name == "tiny_elev":
        model = build_model(port_config(cfg_name), device="cpu")
        model.load_state_dict(restore_params_only(imported), strict=True)
    else:
        model, _ = serve.make_model(cfg_name, device="cpu",
                                    checkpoint=imported)
    with torch.no_grad():
        got = model(arrays_to_batch(arrs))[0].numpy()
    want = jax_forward(cfg_name, pth, arrs)
    assert got.shape == want.shape
    assert got.shape == ((1, 100, 100) if with_elev else (1, 99, 99, 16, 5))
    err = float(np.abs(got - want).max())
    print(f"{cfg_name}: max abs {err:.3g} over max abs "
          f"{float(np.abs(want).max()):.3g}")
    assert err <= TOL


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def test_eval_and_export_take_an_imported_checkpoint(reference_files):
    _, imported, _ = reference_files("tiny_occ")
    src = restore_params_only(imported)
    out = _run(eval_cli.main, ["tiny_occ", "--checkpoint", imported,
                               "--synthetic", "--num-samples", "1",
                               "--device", "cpu"])
    assert f"loaded checkpoint: {len(src)}/{len(src)} tensors" in out
    module, _ = export.build("tiny_occ", checkpoint=imported, device="cpu")
    sd = module.model.state_dict()
    assert sd.keys() == src.keys()
    assert all(torch.equal(sd[k], src[k]) for k in sd)


def test_train_cli_finetunes_from_an_imported_mae(reference_files,
                                                  tmp_path):
    """The reference's pretrain -> fine-tune flow: an imported
    ``tiny_range_cam`` file partial-loads into ``tiny_occ``; every encoder
    and neck tensor is adopted (and stays frozen), only the decoder's are
    left."""
    _, imported, printed = reference_files("tiny_range_cam")
    assert "  skipped: proj_cam_downsample.weight" in printed
    src = restore_params_only(imported)
    out = _run(cli.main, ["tiny_occ", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "1", "--device",
                          "cpu", "--ckpt-path", imported])
    trained = restore_params_only(
        os.path.join(tmp_path, "checkpoints", "step_1.pt"))
    left = sorted(k for k, v in trained.items()
                  if k not in src or src[k].shape != v.shape)
    assert left == sorted(k for k in trained if k.startswith("decoder."))
    n = len(trained)
    assert f"partial restore: adopted {n - len(left)}/{n} tensors" in out
    kept = [k for k in trained if k.split(".")[0] in ("encoder", "neck")]
    assert len(kept) == n - len(left)
    assert all(torch.equal(trained[k], src[k]) for k in kept)

"""The PyTorch port stands alone: no JAX, no JAX-package imports, and its
entry points refuse to fall back to the CPU silently."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "efficient_multimodal_perception_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "efficient_multimodal_perception_tpu", "tools", "tests"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"train/trainer.py", "train/cli.py", "models/triplane_mae.py",
            "configs/triplane_range_cam.py", "models/point_triplane_occ.py",
            "models/point_projector.py", "models/point_family.py",
            "models/fpn.py", "configs/point_triplane_occ.py",
            "ops/quant.py", "models/triplane_elev.py",
            "configs/triplane_elev.py", "models/batch_norm.py",
            "losses/sup_con.py", "ops/radius.py", "models/interpnet.py",
            "models/point_triplane.py", "configs/triplane_surf_sam.py",
            "configs/nuscenes_range.py", "data/nuscenes.py",
            "data/transforms.py", "data/wrappers.py", "data/prep.py",
            "data/native.py", "data/utils.py", "data/sam_masks.py",
            "configs/tiny_occ_run.py", "tools/fixture_world.py",
            "tools/export.py", "utils/env.py", "utils/logging.py"} <= names
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_build_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("tiny_occ")["model"])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA (and, alone, no port beside it): non-zero exit, no result."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_visualisation_modules_import_no_plotting_library():
    """The visualisations and the box geometry they draw are in the port;
    matplotlib and cv2, which the card's machine does not have, are
    imported inside the writers only, so the eval CLI imports there."""
    for rel in ("utils/visualization.py", "core/boxes.py"):
        path = PORT / rel
        assert path.exists(), rel
        tree = ast.parse(path.read_text(), filename=str(path))
        top = {a.name.split(".")[0] for node in tree.body
               if isinstance(node, ast.Import) for a in node.names}
        top |= {node.module.split(".")[0] for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.module}
        assert not top & {"matplotlib", "cv2", "PIL"}, (rel, top)

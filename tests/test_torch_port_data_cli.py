"""The port's train and eval CLIs on nuScenes files, on the CPU, in
process (``train.cli.main``, ``train.eval_cli.main``), over the
converter's world (``tests/test_converter.py``: ``fake_devkit``,
``prepare_fixture_dataset``):

- the golden evaluation: JAX's untrained ``tiny_occ_run`` (initialised as
  ``tools/test.py`` initialises it: f32 on the CPU, ``params`` key 0)
  carried into the port with ``weights.load_jax_params`` and saved as a
  port checkpoint; ``eval_cli`` on the world's val split prints the
  ``CE / IoU / mIoU`` that ``tests/test_cli_e2e.py`` pins for
  ``tools/test.py``;
- two ``tiny_occ_run`` steps with ``--data-root`` save ``step_2.pt``, and
  ``eval_cli`` on it prints ``mIoU:``;
- without ``--synthetic``, a missing infos file raises.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny_occ_run import (
    get_config as jax_tiny_occ_run,
)
from efficient_multimodal_perception_tpu.data.nuscenes import (
    NuScenesDataset as JNuScenesDataset,
)
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.train import cli, eval_cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from efficient_multimodal_perception_tpu_torch.weights import load_jax_params
from test_converter import fake_devkit, prepare_fixture_dataset  # noqa: F401
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

# tools/test.py's lines for the untrained tiny_occ_run on this world
# (tests/test_cli_e2e.py::test_golden_eval_metrics_on_fixture)
GOLDEN = {"ce": "1.0091", "iou": "0.0005", "miou": "0.0002"}


def _run(main, argv):
    """``main(argv)``'s standard output; it must return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def _metrics(out):
    got = {}
    for line in out.splitlines():
        if line.startswith("CE:"):
            got["ce"] = line.split()[-1]
        elif line.startswith("IoU (geometry):"):
            got["iou"] = line.split()[-1]
        elif line.startswith("mIoU:"):
            got["miou"] = line.split()[-1]
    return got


def jax_init_params(root):
    """``tools/test.py``'s variables for ``tiny_occ_run`` with no
    checkpoint: ``model.init`` (f32) on the first val batch with the
    keys ``params`` 0, ``sample`` 1, ``droppath`` 2; flat ``{path:
    array}``."""
    cfg = jax_tiny_occ_run()
    cfg["data"]["data_root"] = root
    model = jax_build_model(cfg["model"])
    example = jax.tree.map(jax.numpy.asarray,
                           JNuScenesDataset(cfg["data"], "val").batch([0]))
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1),
            "droppath": jax.random.key(2)}
    variables = jax.jit(lambda b: model.init(rngs, b, deterministic=True))(
        example)
    flat = traverse_util.flatten_dict(jax.device_get(variables["params"]),
                                      sep="/")
    return {k: np.array(v) for k, v in flat.items()}


def test_eval_cli_prints_the_golden_metrics(fake_devkit, tmp_path):  # noqa: F811
    root = fake_devkit
    prepare_fixture_dataset(root)
    model = build_model(get_config("tiny_occ_run")["model"], device="cpu")
    model.load_state_dict(load_jax_params(jax_init_params(root), model))
    path = save_checkpoint(str(tmp_path), 0,
                           {"step": 0, "params": model.state_dict()})
    out = _run(eval_cli.main, [
        "tiny_occ_run", "--checkpoint", path, "--data-root", root,
        "--num-samples", "1", "--batch-size", "1", "--device", "cpu",
        "--cfg-options", "data.point_budget=512"])
    n = len(model.state_dict())
    assert f"loaded checkpoint: {n}/{n} tensors" in out
    assert _metrics(out) == GOLDEN, out


def test_train_then_eval_from_files(fake_devkit, tmp_path):  # noqa: F811
    root = fake_devkit
    prepare_fixture_dataset(root)
    work = str(tmp_path / "work")
    out = _run(cli.main, [
        "tiny_occ_run", "--work-dir", work, "--data-root", root,
        "--max-steps", "2", "--device", "cpu"])
    steps = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    assert [s["step"] for s in steps] == [1, 2]
    for s in steps:
        for k in ("loss", "grad_norm", "lr", "ms", "wait_ms"):
            assert np.isfinite(s[k]), (k, s)
    ckpt = os.path.join(work, "checkpoints", "step_2.pt")
    assert os.path.isfile(ckpt), out
    assert torch.load(ckpt, weights_only=True)["step"] == 2
    with open(os.path.join(work, "config.json")) as f:
        assert json.load(f)["data"]["data_root"] == root

    out = _run(eval_cli.main, [
        "tiny_occ_run", "--checkpoint", ckpt, "--data-root", root,
        "--device", "cpu"])
    got = _metrics(out)
    assert set(got) == {"ce", "iou", "miou"}, out
    assert all(np.isfinite(float(v)) for v in got.values())


@pytest.mark.parametrize("which", ["train", "eval"])
def test_cli_without_synthetic_needs_infos(tmp_path, which):
    """No ``--synthetic`` and no infos under the root: the CLI raises
    (it generates no data)."""
    main, argv = (
        (cli.main, ["tiny_occ_run", "--work-dir", str(tmp_path / "w")])
        if which == "train" else (eval_cli.main, ["tiny_occ_run"]))
    with pytest.raises(FileNotFoundError, match="nuscenes_infos_"):
        main(argv + ["--data-root", str(tmp_path), "--device", "cpu"])

"""The port's train and eval CLIs (``train/cli.py``, ``train/eval_cli.py``)
on the CPU, pretrain -> fine-tune -> evaluate:

- two pretrain steps of the tiny range-cam config print finite losses
  and save a checkpoint;
- two ``tiny_occ`` fine-tune steps from that checkpoint (``--ckpt-path``)
  adopt its encoder and neck whole, train only the head and save their
  own checkpoint, from which ``--resume-from`` runs a third step;
- ``eval_cli`` on the fine-tuned checkpoint prints the CE / IoU / mIoU
  that ``evaluator.evaluate`` gives on the same batches;
- without ``--device cpu`` the CLIs and the trainer's entry points need
  CUDA.

The pretrain run decodes 8 x 8 camera and 1 x 8 range patches
(``--cfg-options``) where the config has 4 x 4 and 1 x 4, a quarter of the
decoders' tokens; the config itself is held to JAX in
``tests/test_torch_port_mae.py``.
"""

import contextlib
import io
import json

import pytest
import torch

from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.train import cli, eval_cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    partial_load,
    restore_params_only,
)
from efficient_multimodal_perception_tpu_torch.train.evaluator import (
    evaluate,
    make_val_batches,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

COARSE = ["model.camera_decoder.stride=(8,8)",
          "model.camera_decoder.actual_patch_size=(8,8)",
          "model.lidar_decoder.stride=(1,8)",
          "model.lidar_decoder.actual_patch_size=(1,8)"]


def _run(main, argv):
    """``main(argv)``'s standard output; it must return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def _steps(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


@pytest.fixture(scope="module")
def pretrain(tmp_path_factory):
    work = tmp_path_factory.mktemp("pretrain")
    out = _run(cli.main, ["tiny_range_cam", "--work-dir", str(work),
                          "--synthetic", "--max-steps", "2", "--batch-size",
                          "1", "--seed", "1", "--device", "cpu",
                          "--cfg-options", *COARSE])
    return work, out


def test_cli_trains_two_steps_on_cpu(pretrain):
    work, out = pretrain
    lines = _steps(out)
    assert [r["step"] for r in lines] == [1, 2]
    for r in lines:
        for k in ("camera_loss", "range_loss", "loss", "grad_norm", "lr",
                  "ms"):
            assert torch.isfinite(torch.tensor(r[k])), (k, r)
        assert r["loss"] == pytest.approx(r["camera_loss"] + r["range_loss"],
                                          rel=1e-6)
    assert lines[0]["lr"] < lines[1]["lr"]  # warmup
    saved = (work / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in saved] == [1, 2]
    cfg = json.loads((work / "config.json").read_text())
    assert cfg["name"] == "tiny_range_cam"
    assert cfg["model"]["camera_decoder"]["stride"] == [8, 8]
    path = work / "checkpoints" / "step_2.pt"
    assert out.splitlines()[-1] == f"saved {path}"
    state = torch.load(path, weights_only=True)
    assert state["step"] == 2 and state["opt"]["count"] == 2
    # the tiny config freezes nothing: a moment for every tensor
    assert set(state["opt"]["mu"]) == set(state["params"])


def test_cli_finetunes_from_its_pretrain_checkpoint_then_evaluates(
        pretrain, tmp_path):
    src = restore_params_only(pretrain[0] / "checkpoints" / "step_2.pt")
    cfg = get_config("tiny_occ")
    fresh = build_model(cfg["model"], device="cpu", seed=2).state_dict()
    enc_neck = {k for k in fresh if k.split(".")[0] in ("encoder", "neck")}
    out = _run(cli.main, ["tiny_occ", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "2", "--seed", "2",
                          "--device", "cpu", "--ckpt-path",
                          str(pretrain[0] / "checkpoints" / "step_2.pt")])
    assert out.splitlines()[0] == (f"partial restore: adopted "
                                   f"{len(enc_neck)}/{len(fresh)} tensors")
    assert len(fresh) - len(enc_neck) == 3  # the head
    lines = _steps(out)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(torch.isfinite(torch.tensor(r["loss"])) for r in lines)
    ckpt = tmp_path / "checkpoints" / "step_2.pt"
    tuned = restore_params_only(ckpt)
    for k, v in tuned.items():  # encoder and neck loaded whole, frozen
        if k in enc_neck:
            assert torch.equal(v, src[k]), k
        else:
            assert not torch.equal(v, fresh[k]), k

    out = _run(cli.main, ["tiny_occ", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "3", "--seed", "2",
                          "--device", "cpu", "--resume-from", str(ckpt)])
    assert out.splitlines()[0] == f"resumed from {ckpt} @ step 2"
    assert [r["step"] for r in _steps(out)] == [3]
    last = latest_checkpoint(tmp_path)
    assert last == str(tmp_path / "checkpoints" / "step_3.pt")
    state = torch.load(last, weights_only=True)
    assert state["step"] == state["opt"]["count"] == 3
    assert all(torch.equal(state["params"][k], src[k]) for k in enc_neck)

    shown = _run(eval_cli.main, ["tiny_occ", "--checkpoint", str(ckpt),
                                 "--synthetic", "--val-batches", "2",
                                 "--device", "cpu"]).splitlines()
    assert shown[0] == f"loaded checkpoint: {len(fresh)}/{len(fresh)} tensors"
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(partial_load(model.state_dict(), tuned)[0])
    m = evaluate(model, make_val_batches(cfg["data"], 1, 2)(), "TriplaneOcc",
                 cfg["model"]["decoder"]["num_classes"])
    assert shown[1:] == [f"CE: {m['ce']:.4f}",
                         f"IoU (geometry): {m['iou']:.4f}",
                         f"mIoU: {m['miou']:.4f}"]
    assert 0 < m["ce"] and 0 <= m["iou"] <= 1


def test_cli_and_build_model_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["tiny_range_cam", "--work-dir", str(tmp_path),
                  "--synthetic", "--max-steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.main(["tiny_occ", "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("tiny_range_cam")["model"])


def test_cli_refuses_real_data(tmp_path):
    with pytest.raises(SystemExit, match="synthetic"):
        cli.main(["tiny_range_cam", "--work-dir", str(tmp_path),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="synthetic"):
        eval_cli.main(["tiny_occ", "--device", "cpu"])

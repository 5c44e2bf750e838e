"""The port's train CLI (``train/cli.py``): two steps of the tiny
range-cam config on the CPU print finite losses, and without
``--device cpu`` the CLI and the trainer's entry points need CUDA."""

import json

import pytest
import torch

from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.train import cli


def test_cli_trains_two_steps_on_cpu(tmp_path, capsys):
    rc = cli.main(["tiny_range_cam", "--work-dir", str(tmp_path),
                   "--synthetic", "--max-steps", "2", "--batch-size", "1",
                   "--seed", "1", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["step"] for r in lines] == [1, 2]
    for r in lines:
        for k in ("camera_loss", "range_loss", "loss", "grad_norm", "lr",
                  "ms"):
            assert torch.isfinite(torch.tensor(r[k])), (k, r)
        assert r["loss"] == pytest.approx(r["camera_loss"] + r["range_loss"],
                                          rel=1e-6)
    assert lines[0]["lr"] < lines[1]["lr"]  # warmup
    saved = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in saved] == [1, 2]
    assert json.loads((tmp_path / "config.json").read_text())["name"] == \
        "tiny_range_cam"


def test_cli_and_build_model_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["tiny_range_cam", "--work-dir", str(tmp_path),
                  "--synthetic", "--max-steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("tiny_range_cam")["model"])


def test_cli_refuses_real_data(tmp_path):
    with pytest.raises(SystemExit, match="synthetic"):
        cli.main(["tiny_range_cam", "--work-dir", str(tmp_path),
                  "--device", "cpu"])

"""The train CLI's single-card flags and what they rest on, on the CPU.

- ``accum_steps = 2`` on a ``tiny_occ`` fine-tune step at batch 2 against
  JAX's ``make_train_step(accum_steps=2)`` (``tests/test_trainer.py``'s
  oracle) from the same drawn weights and batch (drop-path sits in the
  frozen encoder, so no draw enters the loss): the loss within 1e-4
  relative, the updated head within 1e-3;
- one ``remat`` step bit for bit equal to one without, for
  ``tiny_range_cam`` (drop-path on: the recompute must replay the
  step's generator) and ``tiny_point_occ`` (training BatchNorm: the
  running statistics must move once, ``tests/test_trainer.py``'s remat
  oracle);
- checkpoints: ``max_keep`` pruning and the meta file
  (``tests/test_checkpoint.py``'s), an asynchronous save's round trip and
  its failure raised by ``wait_for_saves``, ``latest_checkpoint``;
- the CLI on ``tiny_point_occ``: ``--async-ckpt --profile --eval-interval
  1`` writes a checkpoint with its meta, a chrome trace of step 6 and
  ``val/`` lines; ``--auto-resume`` continues at the saved step;
  ``--accum-steps`` that does not divide the batch raises;
  ``--debug-nans`` raises ``FloatingPointError`` naming a module on a
  batch with a NaN;
- ``utils/env.env_string`` and ``utils/logging.MetricLogger``
  (``tests/test_misc.py``'s).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import (
    tiny_occ as jax_tiny_occ,
)
from efficient_multimodal_perception_tpu.train.trainer import (
    TrainState,
    frozen_stage_tokens as jax_frozen_stage_tokens,
    make_optimizer as jax_make_optimizer,
    make_train_step,
)
from efficient_multimodal_perception_tpu_torch.configs import (
    apply_overrides,
    get_config,
)
from efficient_multimodal_perception_tpu_torch.data import synthetic
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
    synthetic_batch,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.train import checkpoint as C
from efficient_multimodal_perception_tpu_torch.train import cli
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    build_trainer,
    split_batch,
)
from efficient_multimodal_perception_tpu_torch.utils.env import (
    collect_env,
    env_string,
)
from efficient_multimodal_perception_tpu_torch.utils.logging import (
    MetricLogger,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_finetune import FREEZE, _draw, _shapes
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_occ import jax_batch, unflatten
from test_torch_port_train_cli import COARSE

LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-3


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def _steps(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def test_accum_steps_match_jax():
    model, shapes = _shapes(jax_tiny_occ())
    flat = _draw(shapes, 5)
    cfg = get_config("tiny_occ")
    arrs = synthetic_arrays(2, point_budget=2048, with_occ=True, seed=6)
    freeze = FREEZE + jax_frozen_stage_tokens(jax_tiny_occ())
    params = unflatten(flat)
    opt = jax_make_optimizer(cfg, 4, params, freeze)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=opt.init(params), batch_stats={})
    step = make_train_step(model, opt, donate=False, freeze_prefixes=freeze,
                           accum_steps=2)
    with jax.default_matmul_precision("highest"):
        new, logs = step(state, jax_batch(arrs), jax.random.key(0))
    new_flat = traverse_util.flatten_dict(jax.device_get(new.params),
                                          sep="/")

    port = build_model(cfg["model"], device="cpu")
    port.load_state_dict(load_jax_params(flat, port))
    batch = arrays_to_batch(arrs)
    trainer = build_trainer(cfg, port, 4, accum_steps=2)
    got = trainer.train_step(batch)
    want = float(logs["loss"])
    assert abs(float(got["loss"]) - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(logs["grad_norm"]), rtol=PARAM_RTOL)
    by_port = {port_key(k, v)[0].replace("/", "."): (k, v)
               for k, v in new_flat.items()}
    for n, p in trainer.named:
        k, v = by_port[n]
        want_p = port_key(k, v)[1]
        err = (np.linalg.norm(p.detach().numpy() - want_p)
               / np.linalg.norm(want_p))
        assert err <= PARAM_RTOL, (n, err)


def test_split_batch():
    batch = synthetic_batch(4, point_budget=256, with_occ=True, seed=1)
    parts = split_batch(batch, 2)
    assert [p.batch_size for p in parts] == [2, 2]
    assert torch.equal(parts[1].img, batch.img[2:])
    assert torch.equal(parts[1].cam_aug.crop, batch.cam_aug.crop[2:])
    assert torch.equal(parts[0].occupancy, batch.occupancy[:2])
    assert parts[0].elevation is None
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        split_batch(batch, 3)


@pytest.mark.parametrize("name,overrides", [
    ("tiny_range_cam", COARSE), ("tiny_point_occ", [])])
def test_remat_step_is_the_step(name, overrides):
    cfg = apply_overrides(get_config(name), overrides)
    data = cfg["data"]
    batch = synthetic_batch(1, num_cams=data["num_cams"],
                            image_hw=tuple(data["image_size"]),
                            point_budget=data["point_budget"],
                            with_occ=data.get("load_occ", False), seed=3)
    runs = []
    for remat in (False, True):
        model = build_model(cfg["model"], device="cpu", seed=0)
        logs = build_trainer(cfg, model, 4, remat=remat).train_step(batch)
        runs.append((logs, model.state_dict()))
    (logs, want), (got_logs, got) = runs
    for k in logs:
        assert float(got_logs[k]) == float(logs[k]), k
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == (name == "tiny_point_occ")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _state(v):
    return {"step": v, "params": {"w": torch.full((3,), float(v))}}


def test_max_keep_and_meta(tmp_path):
    for s in (1, 2, 3, 4):
        C.save_checkpoint(str(tmp_path), s, _state(s), max_keep=2,
                          meta={"step": s, "CLASSES": ["a"]})
    d = tmp_path / "checkpoints"
    assert sorted(os.listdir(d)) == [
        "step_3.pt", "step_3.pt.meta.json", "step_4.pt",
        "step_4.pt.meta.json"]
    assert json.loads((d / "step_4.pt.meta.json").read_text()) == {
        "step": 4, "CLASSES": ["a"]}
    assert C.latest_checkpoint(str(tmp_path)) == str(d / "step_4.pt")


def test_async_save_round_trip_and_failure(tmp_path, monkeypatch):
    live = _state(5)
    path = C.save_checkpoint(str(tmp_path), 5, live, async_save=True)
    live["params"]["w"].add_(1.0)  # the save holds the state of the call
    C.wait_for_saves()
    assert torch.equal(C.restore_params_only(path)["w"],
                       torch.full((3,), 5.0))
    monkeypatch.setattr(C.torch, "save", lambda *a: 1 / 0)
    C.save_checkpoint(str(tmp_path), 6, _state(6), async_save=True)
    with pytest.raises(RuntimeError, match="asynchronous") as err:
        C.wait_for_saves()
    assert isinstance(err.value.__cause__, ZeroDivisionError)
    C.wait_for_saves()  # raised once


@pytest.fixture(scope="module")
def flags_run(tmp_path_factory):
    """``tiny_point_occ`` for 6 steps with ``--async-ckpt --profile
    --eval-interval 1``, then ``--auto-resume`` to step 7."""
    work = tmp_path_factory.mktemp("flags")
    base = ["tiny_point_occ", "--work-dir", str(work), "--synthetic",
            "--device", "cpu", "--batch-size", "2"]
    first = _run(base + ["--max-steps", "6", "--async-ckpt", "--profile",
                         "--eval-interval", "1", "--eval-samples", "2"])
    second = _run(base + ["--max-steps", "7", "--auto-resume"])
    return work, first, second


def test_cli_async_checkpoint_and_meta(flags_run):
    work, first, _ = flags_run
    path = work / "checkpoints" / "step_6.pt"
    assert f"saved {path}" in first.splitlines()
    meta = json.loads((work / "checkpoints" / "step_6.pt.meta.json")
                      .read_text())
    assert (meta["step"], meta["epoch"]) == (6, 1)
    assert json.loads(meta["config"])["name"] == "tiny_point_occ"
    assert meta["CLASSES"] == list(get_config("tiny_point_occ")["model"]
                                   .get("class_names") or ())


def test_cli_profile_and_eval(flags_run):
    work, first, _ = flags_run
    trace = work / "profile" / "trace.json"
    assert f"profile trace -> {trace}" in first.splitlines()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "optimizer" for e in events)
    evals = [s for s in first.splitlines() if s.startswith("[eval @ epoch")]
    assert len(evals) == 1 and evals[0].startswith("[eval @ epoch 1] {'ce'")
    log = (work / "train.log").read_text().splitlines()
    assert "step 6 val/ce=" in log[6]
    assert [s.split("] ")[1].split()[1] for s in log[:6]] == [
        "1", "2", "3", "4", "5", "6"]
    assert (work / "metrics.csv").read_text().splitlines()[0].startswith(
        "step,grad_norm,loss,lr")


def test_cli_auto_resume(flags_run):
    work, first, second = flags_run
    assert second.splitlines()[0] == (
        f"resumed from {work / 'checkpoints' / 'step_6.pt'} @ step 6")
    assert [r["step"] for r in _steps(second)] == [7]
    assert [json.loads(s)["step"] for s in
            (work / "metrics.jsonl").read_text().splitlines()] == list(
                range(1, 8))


def test_cli_accum_steps_must_divide(tmp_path):
    with pytest.raises(ValueError, match="not divisible by accum_steps 2"):
        _run(["tiny_point_occ", "--work-dir", str(tmp_path), "--synthetic",
              "--device", "cpu", "--batch-size", "1", "--max-steps", "1",
              "--accum-steps", "2"])


def test_cli_debug_nans_names_the_module(tmp_path, monkeypatch):
    real = synthetic.synthetic_batch

    def with_nan(*a, **kw):
        b = real(*a, **kw)
        b.img[0, 0, 3, 5, 1] = float("nan")
        return b

    monkeypatch.setattr(synthetic, "synthetic_batch", with_nan)
    argv = ["tiny_point_occ", "--work-dir", str(tmp_path), "--synthetic",
            "--device", "cpu", "--batch-size", "1", "--max-steps", "1"]
    with pytest.raises(FloatingPointError,
                       match="module 'camera_encoder.downsample_layers.0' "
                             r"\(_Stem, \(6, 128, 256, 8\)\)"):
        _run(argv + ["--debug-nans"])


def test_env_string_and_metric_logger(tmp_path):
    info = collect_env()
    assert info["torch"] == torch.__version__
    assert info["cuda_available"] == torch.cuda.is_available()
    assert env_string().splitlines()[0].startswith("python: ")
    lg = MetricLogger(str(tmp_path), use_tensorboard=False)
    lg.log(1, {"loss": 1.0, "acc": 0.5})
    lg.log(2, {"loss": 0.9, "acc": 0.6, "val/ce": 2.0})
    lg.close()
    assert "step 2 loss=0.9 acc=0.6 val/ce=2" in (
        tmp_path / "train.log").read_text()
    csv = (tmp_path / "metrics.csv").read_text().splitlines()
    assert csv == ["step,acc,loss", "1,0.5,1.0", "2,0.6,0.9"]

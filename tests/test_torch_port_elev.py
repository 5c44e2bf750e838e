"""The port's ``triplane_elev`` path against the JAX package, on the CPU.

- The U-Net head alone (``models/heads.ElevUNetHead``) against JAX's at
  input ``(2, 36, 36, 8, 4)`` (pad 14 -> 64 x 64), on running BatchNorm
  statistics and on batch statistics, and the running statistics after
  the training call (flax's default decay 0.99: with the point family's
  0.9 every statistic tensor misses by 0.1 or more);
- ``tests/torch_ref.UnetElevHead``'s ``state_dict`` loads strictly into
  the port's head and gives the same heights;
- ``tiny_elev`` (the one-block head) through both packages on the same
  weights: the heights and the loss, on a batch whose range points reach
  outside ``triplane_range`` (the elevation model does not crop them);
- one training forward and backward: the loss, every head gradient and
  the running statistics against ``jax.value_and_grad`` of JAX's
  training apply (its model built in float64); the encoder and neck get
  no gradient;
- the CLIs: ``train/cli.py tiny_elev`` saves a checkpoint,
  ``eval_cli`` prints its ``elevation MSE``, and ``serve.py`` answers
  with float32 ``(n, 100, 100)`` heights, with and without ``--int8``.

Weights and statistics are drawn with numpy for the JAX variables'
shapes (``eval_shape``); JAX runs jitted under full matmul precision.
"""

import contextlib
import io
import threading
import urllib.request

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import (
    tiny_elev as jax_tiny_elev,
)
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.heads import (
    ElevUNetHead as JElevUNetHead,
)
from efficient_multimodal_perception_tpu_torch import serve
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.core.geometry import (
    crop_to_range,
)
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.heads import ElevUNetHead
from efficient_multimodal_perception_tpu_torch.models.range_family import (
    encode_triplane,
)
from efficient_multimodal_perception_tpu_torch.train import cli, eval_cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    restore_params_only,
)
from efficient_multimodal_perception_tpu_torch.train.evaluator import (
    evaluate,
    make_val_batches,
)
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    loss_and_grads,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from torch_ref import UnetElevHead

HEIGHT_TOL = 1e-4   # heights, max abs (tests/test_full_parity.py's 1e-4)
STATS_TOL = 1e-6    # running statistics after a training call, max abs
LOSS_RTOL = 1e-5    # masked MSE, relative
GRAD_RTOL = 2e-4    # head gradients, relative Frobenius error per tensor
HEAD_IN = (2, 36, 36, 8, 4)  # (B, X, Y, Z, C): pad 14 -> 64 x 64


def _draw(shapes, seed):
    """Flat ``{collection/path: float32 array}`` for the variable shapes:
    LeCun-normal kernels, biases from N(0, 0.1), scales from
    1 + N(0, 0.1), layer-scale gamma from U(0.1, 1), BatchNorm means from
    N(0, 0.5) and variances from U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, sd in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf, shape = k.rsplit("/", 1)[-1], sd.shape
        if k.startswith("batch_stats/"):
            v = (rng.normal(0.0, 0.5, shape) if leaf == "mean"
                 else rng.uniform(0.5, 2.0, shape))
        elif leaf == "kernel":
            v = rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif leaf == "gamma":
            v = rng.uniform(0.1, 1.0, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[k] = v.astype(np.float32)
    return out


def _tree(flat, collection):
    return traverse_util.unflatten_dict(
        {k.split("/", 1)[1]: jnp.asarray(v) for k, v in flat.items()
         if k.startswith(collection + "/")}, sep="/")


def _stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_stats(stats, prefix=""):
    """Flat JAX ``batch_stats`` -> ``{port key: array}``."""
    out = {}
    for k, v in traverse_util.flatten_dict(jax.device_get(stats),
                                           sep="/").items():
        key, val = port_key(f"batch_stats/{prefix}{k}", np.asarray(v))
        out[key.replace("/", ".")] = val
    return out


# ---------------------------------------------------------------------------
# the U-Net head alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def head_case():
    """JAX ``ElevUNetHead`` on drawn variables: eval heights, training
    heights and the training call's running statistics."""
    x = np.random.default_rng(0).standard_normal(HEAD_IN).astype(np.float32)
    B, X, Y, Z, C = HEAD_IN
    head = JElevUNetHead(input_dim=C, height_dim=Z, pad=14)
    shapes = jax.eval_shape(lambda a: head.init(jax.random.key(0), a), x)
    flat = _draw(shapes, 1)
    variables = {"params": _tree(flat, "params"),
                 "batch_stats": _tree(flat, "batch_stats")}

    @jax.jit
    def run(v, a):
        ev = head.apply(v, a, train=False)
        tr, new = head.apply(v, a, train=True, mutable=["batch_stats"])
        return ev, tr, new["batch_stats"]

    with jax.default_matmul_precision("highest"):
        ev, tr, stats = run(variables, x)
    return dict(x=x, flat=flat, eval=np.asarray(ev), train=np.asarray(tr),
                stats=_jax_stats(stats, "decoder/"))


def _port_head(flat):
    """The port's head holding ``flat`` (bridged under ``decoder/``)."""
    B, X, Y, Z, C = HEAD_IN
    holder = nn.Module()
    holder.decoder = ElevUNetHead(C, Z, pad=14)
    prefixed = {k.replace("/", "/decoder/", 1): v for k, v in flat.items()}
    holder.load_state_dict(load_jax_params(prefixed, holder), strict=True)
    return holder


@pytest.mark.parametrize("train", [False, True])
def test_unet_head_matches_jax(head_case, train):
    holder = _port_head(head_case["flat"])
    head = holder.decoder
    stats0 = _stats(holder)
    with torch.no_grad():
        got = head(torch.from_numpy(head_case["x"]), train=train)
    want = head_case["train" if train else "eval"]
    assert got.shape == want.shape == HEAD_IN[:3]
    np.testing.assert_allclose(got.numpy(), want, atol=HEIGHT_TOL, rtol=0)
    stats = _stats(holder)
    if not train:
        assert all(torch.equal(stats[k], stats0[k]) for k in stats)
        return
    assert stats.keys() == head_case["stats"].keys()
    # the stem, 16 blocks, 3 shortcuts, 5 decoder blocks: 46 BatchNorms
    assert len(stats) == 2 * (1 + 2 * 16 + 3 + 2 * 5)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), head_case["stats"][k],
                                   atol=STATS_TOL, rtol=0, err_msg=k)
    # the decay is flax's default 0.99: 0.9 would move them ten times as far
    k = "decoder.decoder.encoder.bn1.running_mean"
    assert np.abs(stats[k].numpy() - stats0[k].numpy()).max() > 1e-3


def test_reference_unet_state_dict_loads_into_the_port():
    B, X, Y, Z, C = HEAD_IN
    torch.manual_seed(2)
    ref = UnetElevHead(input_dim=C, height_dim=Z, pad=14).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    port = ElevUNetHead(C, Z, pad=14)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        HEAD_IN).astype(np.float32))
    with torch.no_grad():
        want = ref(x.permute(0, 4, 1, 2, 3))[:, 0]
        got = port(x)
    assert got.shape == want.shape == (B, X, Y)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=HEIGHT_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the tiny model
# ---------------------------------------------------------------------------

def _jax_batch(arrs):
    return JBatch(
        img=jnp.asarray(arrs["img"]),
        range_image=jnp.asarray(arrs["range_image"]),
        range_points=jnp.asarray(arrs["range_points"]),
        lidar2img=jnp.asarray(arrs["lidar2img"]),
        cam_aug=JAug(jnp.asarray(arrs["cam_resize"]),
                     jnp.asarray(arrs["cam_crop"]),
                     jnp.asarray(arrs["cam_flip"])),
        elevation=jnp.asarray(arrs["elevation"]),
        elevation_mask=jnp.asarray(arrs["elevation_mask"]),
    )


@pytest.fixture(scope="module")
def tiny_case():
    """``tiny_elev`` at B=1 on drawn variables: JAX's float32 eval heights
    and loss, and (see ``test_tiny_elev_train_grads_match_jax``) its
    training loss, head gradients and statistics computed in float64."""
    arrs = synthetic_arrays(1, point_budget=4096, with_elev=True, seed=6)
    jb = _jax_batch(arrs)
    model = jax_build_model(jax_tiny_elev())
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True), jb)
    flat = _draw(shapes, 7)
    params, stats = _tree(flat, "params"), _tree(flat, "batch_stats")
    with jax.default_matmul_precision("highest"):
        pred, losses = jax.jit(lambda v, b: model.apply(
            v, b, deterministic=True))(
                {"params": params, "batch_stats": stats}, jb)

    rest = {k: v for k, v in params.items() if k != "decoder"}
    with jax.enable_x64(True):
        model64 = jax_build_model(jax_tiny_elev(), dtype=jnp.float64)

        @jax.jit
        def train(head, r, s, b):
            def loss(h):
                (_, ls), new = model64.apply(
                    {"params": {**r, "decoder": h}, "batch_stats": s}, b,
                    deterministic=False, mutable=["batch_stats"])
                return ls["loss"], new["batch_stats"]

            return jax.value_and_grad(loss, has_aux=True)(head)

        (loss_t, new), grads = train(params["decoder"], rest, stats, jb)
        grads = traverse_util.flatten_dict(jax.device_get(grads), sep="/")
        new = _jax_stats(new)
    grads = dict(port_key(f"params/decoder/{k}", np.asarray(v, np.float32))
                 for k, v in grads.items())
    return dict(arrs=arrs, flat=flat, pred=np.asarray(pred),
                loss=float(losses["loss"]), loss_train=float(loss_t),
                grads={k.replace("/", "."): v for k, v in grads.items()},
                stats=new)


def _port_tiny(flat):
    model = build_model(get_config("tiny_elev")["model"], device="cpu")
    model.load_state_dict(load_jax_params(flat, model), strict=True)
    return model


def test_tiny_elev_heights_match_jax(tiny_case):
    model = _port_tiny(tiny_case["flat"])
    batch = arrays_to_batch(tiny_case["arrs"])
    # range points outside triplane_range, which the model must not crop
    outside = (~crop_to_range(batch.range_points, model.triplane_range)
               & (batch.range_image[..., 0] > 0))
    assert int(outside.sum()) > 500
    with torch.no_grad():
        pred, losses = model(batch)
        cropped, _ = encode_triplane(model.encoder, model.neck, batch,
                                     model.triplane_range, model.embed_dim)
        pred_cropped = model.heights(cropped)
    assert pred.shape == (1, 100, 100) and pred.dtype == torch.float32
    np.testing.assert_allclose(pred.numpy(), tiny_case["pred"],
                               atol=HEIGHT_TOL, rtol=0)
    np.testing.assert_allclose(float(losses["loss"]), tiny_case["loss"],
                               rtol=LOSS_RTOL)
    # a crop would show: it moves the heights far beyond the tolerance
    assert np.abs(pred_cropped.numpy() - tiny_case["pred"]).max() > 100 * \
        HEIGHT_TOL


def test_tiny_elev_train_grads_match_jax(tiny_case):
    """The oracle is ``jax.value_and_grad`` of JAX's model built in
    float64: its float32 gradient of the 3-D collapse's kernel (a sum over
    the 800,000 voxels of terms that mostly cancel, below the training
    BatchNorm) is 4.6e-4 from the exact one in XLA:CPU's summation order,
    where the port's float32 gradient is 4.8e-6 from it; every other head
    gradient of the two float32 runs agrees within 7e-6."""
    model = _port_tiny(tiny_case["flat"])
    named = list(model.named_parameters())
    stats0 = _stats(model)
    losses, loss, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(tiny_case["arrs"]),
        generator=None)
    np.testing.assert_allclose(float(loss.detach()), tiny_case["loss_train"],
                               rtol=LOSS_RTOL)
    head = {n: g for (n, _), g in zip(named, grads)
            if n.startswith("decoder.")}
    rest = {n: g for (n, _), g in zip(named, grads)
            if not n.startswith("decoder.")}
    # the encoder and neck run under no_grad whatever the caller asks
    assert rest and all(g is None for g in rest.values())
    assert head.keys() == tiny_case["grads"].keys()
    for n, g in head.items():
        want = tiny_case["grads"][n]
        err = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert err <= GRAD_RTOL, (n, err)
    stats = _stats(model)
    assert stats.keys() == tiny_case["stats"].keys() and len(stats) == 4
    for k, v in stats.items():
        assert not torch.equal(v, stats0[k]), k
        np.testing.assert_allclose(v.numpy(), tiny_case["stats"][k],
                                   atol=STATS_TOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _post(url, arrs):
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    r = urllib.request.urlopen(urllib.request.Request(
        url, data=buf.getvalue(), method="POST"), timeout=120)
    with np.load(io.BytesIO(r.read())) as z:
        return z["pred"]


def test_elev_cli_trains_evaluates_and_serves(tmp_path):
    out = _run(cli.main, ["tiny_elev", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "2", "--device",
                          "cpu"])
    steps = [s for s in out.splitlines() if s.startswith("{")]
    assert len(steps) == 2 and "nan" not in out
    ckpt = tmp_path / "checkpoints" / "step_2.pt"
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and sorted(state["opt"]["mu"]) == sorted(
        n for n in state["params"] if n.startswith("decoder.")
        and not n.endswith(("running_mean", "running_var",
                            "num_batches_tracked")))

    cfg = get_config("tiny_elev")
    shown = _run(eval_cli.main, ["tiny_elev", "--checkpoint", str(ckpt),
                                 "--synthetic", "--device", "cpu"])
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(restore_params_only(ckpt))
    want = evaluate(model, make_val_batches(cfg["data"], 1, 2, with_occ=False,
                                            with_elev=True)(), "TriplaneElev")
    assert np.isfinite(want["mse"])
    assert f"elevation MSE: {want['mse']:.4f}" in shown

    arrs = synthetic_arrays(1, point_budget=cfg["data"]["point_budget"],
                            seed=9)
    req = {k: arrs[k] for k in serve.BATCH_KEYS}
    with torch.no_grad():
        heights = model(arrays_to_batch(req))[0].numpy()
    for int8 in (False, True):
        server, worker = serve.make_server(
            "tiny_elev", checkpoint=str(ckpt), port=0, batch_size=1,
            device="cpu", int8=int8)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            pred = _post(f"http://127.0.0.1:{server.server_address[1]}"
                         "/predict", req)
        finally:
            server.shutdown()
            server.server_close()
            worker.stop()
        assert pred.shape == (1, 100, 100) and pred.dtype == np.float32
        assert np.isfinite(pred).all()
        if not int8:  # the served heights are the forward's
            np.testing.assert_array_equal(pred, heights)


def test_elev_trainer_trains_the_whole_unet():
    """``triplane_elev``'s freeze tokens (``encoder``, ``neck`` and the
    encoders' stage 0) freeze those modules only: the U-Net's reference
    names hold an ``encoder`` of their own (``decoder.decoder.encoder``),
    which trains."""
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer,
    )

    cfg = get_config("tiny_elev")
    cfg["model"]["decoder"] = get_config("triplane_elev")["model"]["decoder"]
    model = build_model(cfg["model"], device="cpu")
    trainer = build_trainer(cfg, model, total_steps=2)
    trainable = {n for n, _ in trainer.named}
    assert trainable == {n for n, _ in model.named_parameters()
                         if n.startswith("decoder.")}
    assert "decoder.decoder.encoder.layer1.0.conv1.weight" in trainable
    assert all(n.split(".")[0] in ("encoder", "neck")
               for n, p in model.named_parameters() if not p.requires_grad)

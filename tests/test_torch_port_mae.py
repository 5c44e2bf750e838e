"""The port's ``triplane_range_cam`` training path against the JAX
package, on the CPU.

- tiny range-cam MAE in float32, deterministic: both packages get the
  same perturbed weights (through ``weights.load_jax_params``) and the
  same batch; losses agree at 1e-4 relative, every trainable parameter's
  gradient at 1e-3 relative Frobenius error under the same freeze
  tokens (stage 0 and the stem, as ``frozen_stages=1``), and frozen
  parameters get no gradient;
- the optimizer alone: one fixed gradient tree through the port's AdamW
  and through the JAX package's optax chain for three steps (two of
  warmup, one of cosine, one over the clip), parameters at 1e-6;
- drop-path semantics and the per-block rates;
- the last-write camera scatter and its gradient on colliding writes.

JAX runs under full matmul precision (its default here is bf16 even on
the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import tiny_mae
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.ops.scatter import (
    scatter_set_2d_batch as jax_scatter,
)
from efficient_multimodal_perception_tpu.train.trainer import (
    cosine_schedule as jax_cosine,
    freeze_mask,
    make_optimizer as jax_make_optimizer,
    total_loss as jax_total_loss,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.configs._base import (
    schedule_cosine,
)
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.convnext import (
    ConvNeXtBlock,
    MaskConvNeXt,
    drop_path,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops.scatter import (
    scatter_set_2d_batch,
)
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    cosine_schedule,
    freeze,
    loss_and_grads,
    make_optimizer,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
JAX_FREEZE = ("downsample_layers_0/", "stage0_")
PORT_FREEZE = ("downsample_layers.0.", "stages.0.")


def _perturbed(params, seed):
    """Flat ``{path: array}`` of every leaf, perturbed from ``seed`` so
    layer-scale gamma is far from its 1e-6 init."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    return {k: (np.asarray(v) * (1 + 0.1 * rng.standard_normal(v.shape))
                + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _jax_batch(a):
    return JBatch(
        img=jnp.asarray(a["img"]), range_image=jnp.asarray(a["range_image"]),
        range_points=jnp.asarray(a["range_points"]),
        lidar2img=jnp.asarray(a["lidar2img"]),
        cam_aug=JAug(jnp.asarray(a["cam_resize"]), jnp.asarray(a["cam_crop"]),
                     jnp.asarray(a["cam_flip"])))


@pytest.fixture(scope="module")
def mae_case():
    """JAX losses and gradients of tiny range-cam MAE at B=1 (f32,
    deterministic, stage 0 frozen by stop_gradient)."""
    arrs = synthetic_arrays(1, point_budget=2048, seed=3)
    jb = _jax_batch(arrs)
    model = jax_build_model(tiny_mae(contrastive=False, surface=False))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True))(jb)
    flat = _perturbed(variables["params"], seed=0)

    def loss_fn(params, b):
        keep = freeze_mask(params, JAX_FREEZE)
        params = jax.tree.map(
            lambda p, t: p if t else jax.lax.stop_gradient(p), params, keep)
        losses = model.apply({"params": params}, b, deterministic=True)
        return jax_total_loss(losses), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(flat):
        tree = traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
        with jax.default_matmul_precision("highest"):
            (_, losses), grads = grad_fn(tree, jb)
        gflat = traverse_util.flatten_dict(jax.device_get(grads), sep="/")
        return ({k: float(v) for k, v in losses.items()},
                {port_key(k, np.asarray(v))[0].replace("/", "."):
                 port_key(k, np.asarray(v))[1] for k, v in gflat.items()})

    losses, grads = run(flat)
    init = {k: np.array(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(variables["params"]), sep="/").items()}
    frozen = set(p for p, t in traverse_util.flatten_dict(
        freeze_mask(variables["params"], JAX_FREEZE), sep="/").items()
        if not t)
    return dict(arrs=arrs, flat=flat, losses=losses, grads=grads,
                init=init, init_grads=run(init)[1],
                frozen={port_key(k, flat[k])[0].replace("/", ".")
                        for k in frozen})


@pytest.fixture(scope="module")
def port_grads(mae_case):
    model = build_model(get_config("tiny_range_cam")["model"], device="cpu")
    model.load_state_dict(load_jax_params(mae_case["flat"], model))
    named = freeze(model, PORT_FREEZE)
    losses, _, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(mae_case["arrs"]),
        None, deterministic=True)
    return dict(model=model,
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads={n: g for (n, _), g in zip(named, grads)})


def test_tiny_mae_losses_match_jax(mae_case, port_grads):
    want = mae_case["losses"]
    assert set(port_grads["losses"]) == set(want) == {"camera_loss",
                                                      "range_loss"}
    for k, v in want.items():
        assert abs(port_grads["losses"][k] - v) <= LOSS_RTOL * abs(v), k


def test_tiny_mae_grads_match_jax(mae_case, port_grads):
    got, want = port_grads["grads"], mae_case["grads"]
    assert got and set(got) | mae_case["frozen"] == set(want)
    errs = {}
    for n, g in got.items():
        w = want[n]
        errs[n] = float(np.linalg.norm(g.numpy() - w)
                        / max(np.linalg.norm(w), 1e-30))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_tiny_mae_init_grads_match_jax(mae_case):
    """At the unperturbed init both packages put the same ~1e9 gradient
    on the camera decoder's patch-embed bias: empty canvas pixels give
    all-zero rows, LayerNorm (eps 1e-6) scales their gradient by
    1/sqrt(eps) = 1e3, and the chain of such norms after the
    zero-initialised patch-embed multiplies it."""
    model = build_model(get_config("tiny_range_cam")["model"], device="cpu")
    model.load_state_dict(load_jax_params(mae_case["init"], model))
    named = freeze(model, PORT_FREEZE)
    _, _, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(mae_case["arrs"]),
        None, deterministic=True)
    want = mae_case["init_grads"]
    errs, norms = {}, {}
    for (n, _), g in zip(named, grads):
        norms[n] = float(np.linalg.norm(want[n]))
        errs[n] = float(np.linalg.norm(g.numpy() - want[n])
                        / max(norms[n], 1e-30))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    top = "camera_decoder.patch_embed."
    assert max(norms, key=norms.get) == top + "proj.bias"
    assert norms[top + "proj.bias"] > 1e8
    # one LayerNorm over zero rows between the two biases: a 1/sqrt(eps)
    ratio = norms[top + "proj.bias"] / norms[top + "norm.bias"]
    assert 0.5e3 < ratio < 2e3, ratio


def test_frozen_params_get_no_gradient(mae_case, port_grads):
    model = port_grads["model"]
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == mae_case["frozen"]
    assert any(".stages.0." in n for n in frozen)
    assert all(p.grad is None for p in model.parameters())
    assert all(not np.any(mae_case["grads"][n]) for n in frozen)


def test_optimizer_matches_optax():
    cfg = schedule_cosine(lr=1e-3, warmup_iters=2)
    total = 4
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 5), "b": (5,), "c": (3, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * scale
              for k, s in shapes.items()} for scale in (1.0, 30.0, 0.5)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[1].values())) > 35

    opt = jax_make_optimizer(cfg, total, params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    port = make_optimizer(cfg, total, tp)
    lrs = [port.step([torch.from_numpy(g[k]) for k in shapes])[1]
           for g in grads]
    for k, t in zip(shapes, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=1e-6)
    sched = jax_cosine(1e-3, total, warmup_iters=2)
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(3)],
                               rtol=1e-7)
    assert lrs[0] < lrs[1] and lrs[2] < 1e-3


def test_cosine_schedule_matches_jax():
    want = jax_cosine(2.5e-4, 100, 20, 0.1, 0.1)
    got = cosine_schedule(2.5e-4, 100, 20, 0.1, 0.1)
    steps = [0, 1, 19, 20, 21, 50, 99, 100, 150]
    np.testing.assert_array_equal(np.float32([got(s) for s in steps]),
                                  np.float32([want(s) for s in steps]))


def test_drop_path_semantics():
    x = torch.randn(4000, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    assert drop_path(x, 0.3, True) is x and drop_path(x, 0.0, False) is x
    y = drop_path(x, 0.3, False, torch.Generator().manual_seed(0))
    kept = torch.tensor([torch.equal(y[i], x[i] / 0.7)
                         for i in range(len(x))])
    dropped = (y.flatten(1) == 0).all(1)
    assert bool((kept ^ dropped).all())  # per sample: all kept or all zero
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    again = drop_path(x, 0.3, False, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_drop_path_rates_and_block_dispatch():
    """Rates are linspace(0, rate, sum(depths)), zero in frozen stages;
    a block with a rate draws through epilogue -> drop-path -> residual,
    a deterministic one is the K1 twin."""
    arch = {"depths": (1, 2, 1, 1), "channels": (8, 16, 32, 64)}
    net = MaskConvNeXt(arch=arch, drop_path_rate=0.2, frozen_stages=1)
    rates = [b.drop_path_rate for s in net.stages for b in s]
    want = list(np.linspace(0, 0.2, 5))
    assert rates == [0.0] + [float(r) for r in want[1:]]
    blk = ConvNeXtBlock(16, drop_path_rate=0.5)
    with torch.no_grad():
        blk.gamma.fill_(0.5)
    x = torch.randn(6, 4, 4, 16)
    mlp = (blk.norm.weight, blk.norm.bias, blk.pwconv1.weight,
           blk.pwconv1.bias, blk.pwconv2.weight, blk.pwconv2.bias, blk.gamma)
    with torch.no_grad():
        got = blk(x, False, False, torch.Generator().manual_seed(3))
        f = K.epilogue_plain(K.dwconv7(x, blk.dwconv.weight, blk.dwconv.bias),
                             *mlp)
        want = x + drop_path(f, 0.5, False, torch.Generator().manual_seed(3))
        assert torch.equal(got, want)
        assert torch.equal(blk(x), K.convnext_block_plain(
            x, blk.dwconv.weight, blk.dwconv.bias, *mlp))


@pytest.mark.parametrize("shared", [False, True])
def test_scatter_set_2d_batch_matches_jax(shared):
    """Forward and gradient on colliding writes, with writes out of
    range and invalid points; ``shared`` gives each batch row's values
    to three canvases (the cameras of a sample)."""
    rng = np.random.default_rng(7)
    B, per, P, H, W, C = 2, 3 if shared else 1, 200, 4, 6, 5
    G = B * per
    rows = rng.integers(-1, H + 1, (G, P)).astype(np.int32)
    cols = rng.integers(-1, W + 1, (G, P)).astype(np.int32)
    valid = rng.random((G, P)) < 0.8
    vals = rng.standard_normal((B, P, C)).astype(np.float32)
    cot = rng.standard_normal((G, H, W, C)).astype(np.float32)
    full = np.repeat(vals, per, axis=0)

    out, vjp = jax.vjp(lambda v: jax_scatter(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(valid), v, H, W),
        jnp.asarray(full))
    (ref_grad,) = vjp(jnp.asarray(cot))
    ref_grad = np.asarray(ref_grad).reshape(B, per, P, C).sum(1)

    t = torch.from_numpy(vals).requires_grad_()
    got = scatter_set_2d_batch(torch.from_numpy(rows), torch.from_numpy(cols),
                               torch.from_numpy(valid), t, H, W)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-6, rtol=1e-6)
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), ref_grad, atol=1e-5, rtol=1e-5)
    # collisions: more valid in-range writes than pixels they land on
    flat = rows * W + cols
    inb = valid & (flat >= 0) & (flat < H * W)
    assert inb.sum() > len(np.unique((flat + np.arange(G)[:, None] * H * W)
                                     [inb])) + 50

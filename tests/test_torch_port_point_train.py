"""The port's ``point_triplane_occ`` training path against the JAX
package, on the CPU.

- ``MaskedBatchNorm`` and the FPN's BatchNorm in training: outputs,
  running statistics after the update and gradients against flax (with
  invalid rows, and a batch whose valid count is 1);
- B9's backward (``ops.kernels.finite_mlp_bwd``, the op ``emp::finite_mlp_fused``'s
  backward math, run on the CPU) against ``jax.vjp`` of the Pallas op in
  interpret mode, with -inf rows and zero biases (ReLU ties, where the
  port takes ``nn.relu``'s rule and the Pallas op's VJP ``jnp.maximum``'s):
  no NaN, dx exactly 0 at -inf;
- the point pools' gradient against JAX's segment-max VJP with forced
  bf16 ties, bit for bit;
- one ``tiny_point_occ`` step (both encoders' stage 0 frozen, as the
  full config freezes them) against JAX's ``make_train_step`` at f32,
  with and without JAX's ``optimizer.fused``: loss, every gradient, the
  BatchNorm running statistics after the step and every parameter after
  the update.  JAX's gradients are read from its Adam first moment after
  the step (``mu = (1 - b1) * scale * g`` from zero, ``scale`` the clip's);
- the CLIs: two ``tiny_point_occ`` steps of ``train/cli.py`` (running
  statistics saved moved), ``train/eval_cli.py`` on that checkpoint
  (the numbers ``evaluator.evaluate`` gives) and
  ``serve.make_server(checkpoint=...)`` serving it (the reply equals the
  eval forward's argmax).

Inputs, weights and BatchNorm statistics are made with numpy seeds and
handed to both packages (the step's weights drawn for the shapes
``jax.eval_shape`` gives, so no JAX initialisation is compiled); JAX runs
jitted under full matmul precision.
"""

import contextlib
import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import tiny_point
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.fpn import (
    GeneralizedLSSFPN as JFPN,
)
from efficient_multimodal_perception_tpu.models.point_projector import (
    MaskedBatchNorm as JMaskedBatchNorm,
)
from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    finite_mlp_fused as j_finite_mlp_fused,
)
from efficient_multimodal_perception_tpu.ops.scatter import (
    point_plane_pools_batch as j_pools,
)
from efficient_multimodal_perception_tpu.train.trainer import (
    TrainState,
    freeze_mask,
    frozen_stage_tokens as jax_frozen_stage_tokens,
    make_optimizer as jax_make_optimizer,
    make_train_step,
)
from efficient_multimodal_perception_tpu_torch import serve
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.fpn import (
    GeneralizedLSSFPN,
)
from efficient_multimodal_perception_tpu_torch.models.point_projector import (
    MaskedBatchNorm,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops.scatter import (
    point_plane_pools_batch,
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
    build_trainer,
    loss_and_grads,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_point import (
    _cloud,
    jax_batch,
    load_as,
    randomized,
    unflatten,
)

TOL = 1e-5       # modules, loss, statistics, updated parameters
# Whole-model gradients, relative Frobenius per tensor.  The tiny model's
# f32 gradients are ill-conditioned (training BatchNorm): rounding-level
# changes of the weights move them by about 1e-4, so JAX and the port,
# which round in different orders, differ by more than 2e-4.
GRAD_TOL = 1e-3
# A bias whose every path meets a training BatchNorm (the Linear biases of
# the point MLP, the input BatchNorm's bias, the last stage's pwconv2 bias
# before the FPN) has an exact gradient of 0; both packages give rounding
# noise below this share of the largest gradient norm, which Adam's first
# step turns into +-lr.
ZERO_GRAD = 1e-6
NOISE = 1e-2  # a gradient entry this far below its tensor's rms is "near 0"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bn_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("n_valid", [None, 1])
def test_masked_batch_norm_train_matches_flax(n_valid):
    """Batch statistics over the valid rows of two samples, the running
    statistics' update and the gradients of x, scale and bias."""
    rng = np.random.default_rng(11)
    B, P, C = 2, 40, 6
    x = (rng.standard_normal((B, P, C)) * 2 + 0.5).astype(np.float32)
    valid = rng.random((B, P)) < 0.7
    if n_valid is not None:
        valid[:] = False
        valid[1, 7] = True
    cot = rng.standard_normal((B, P, C)).astype(np.float32)
    jm = JMaskedBatchNorm()
    init = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(valid),
                   False)
    flat = randomized(init, 12)
    variables = unflatten(flat)

    def f(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xx,
                            jnp.asarray(valid), True,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (want, stats)), (dp, dx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))

    pm = MaskedBatchNorm(C)
    with torch.no_grad():
        for name, key in (("weight", "params/scale"), ("bias", "params/bias"),
                          ("running_mean", "batch_stats/mean"),
                          ("running_var", "batch_stats/var")):
            getattr(pm, name).copy_(_t(flat[key]))
    xt = _t(x).requires_grad_(True)
    got = pm(xt, _t(valid), train=True)
    (got * _t(cot)).sum().backward()
    _close(got.detach(), want)
    _close(pm.running_mean, stats["mean"])
    _close(pm.running_var, stats["var"])
    _close(xt.grad, dx)
    _close(pm.weight.grad, dp["scale"])
    _close(pm.bias.grad, dp["bias"])


def test_fpn_train_matches_flax():
    """The FPN with every BatchNorm on batch statistics: output, the six
    BatchNorms' updated statistics, and the gradients of the inputs and
    of every parameter."""
    rng = np.random.default_rng(13)
    chans = (8, 16, 32, 64)
    xs = [rng.standard_normal((2, 16 >> i, 10 >> i, c)).astype(np.float32)
          for i, c in enumerate(chans)]
    cot = rng.standard_normal((2, 16, 10, 24)).astype(np.float32)
    jm = JFPN(in_channels=chans, out_channels=24)
    jx = [jnp.asarray(x) for x in xs]
    flat = randomized(jax.jit(lambda a: jm.init(jax.random.key(0), a))(jx),
                      14)
    variables = unflatten(flat)

    def f(params, a):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, a,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (want, stats)), (dp, dxs) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(variables["params"], jx)
    pm = GeneralizedLSSFPN(in_channels=chans, out_channels=24)
    load_as(pm, "fpn", flat)
    xt = [_t(x).requires_grad_(True) for x in xs]
    got = pm(xt, train=True)
    (got * _t(cot)).sum().backward()
    _close(got.detach(), want)
    stats = traverse_util.flatten_dict(jax.device_get(stats), sep="/")
    want_sd = load_jax_params(
        {**{f"batch_stats/fpn/{k}": v for k, v in stats.items()},
         **{f"params/fpn/{k}": v for k, v in traverse_util.flatten_dict(
             jax.device_get(variables["params"]), sep="/").items()}},
        _holder("fpn", pm))
    for k, v in _bn_stats(_holder("fpn", pm)).items():
        _close(v, want_sd[k])
    for x, d in zip(xt, dxs):
        assert _rel(x.grad, d) <= TOL
    dflat = traverse_util.flatten_dict(jax.device_get(dp), sep="/")
    holder = _holder("fpn", pm)
    for k, d in dflat.items():
        name, d = port_key(f"params/fpn/{k}", np.asarray(d))
        p = holder.get_parameter(name.replace("/", "."))
        assert _rel(p.grad, d) <= TOL, name


def _holder(name, module):
    h = torch.nn.Module()
    h.add_module(name, module)
    return h


def _relu_finite_mlp(x, w1, b1, w2, b2):
    """``_xla_finite_mlp`` with ``jax.nn.relu`` for its ``jnp.maximum``:
    the JAX package's unfused plane MLP (Dense, ``nn.relu``, Dense) at
    the fused path's rounding points."""
    xf = x.astype(jnp.float32)
    z = jnp.where(xf == -jnp.inf, 0.0, xf)
    h = jnp.dot(z.astype(w1.dtype), w1.astype(x.dtype),
                preferred_element_type=jnp.float32)
    h = jax.nn.relu(h + b1.astype(jnp.float32))
    o = jnp.dot(h.astype(x.dtype), w2.astype(x.dtype),
                preferred_element_type=jnp.float32)
    return (o + b2.astype(jnp.float32)).astype(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finite_mlp_bwd_matches_jax(dtype):
    """``finite_mlp_bwd`` against ``jax.vjp`` of the Pallas op
    (interpret mode), with whole -inf rows and zero entries in ``b1``, so
    the empty rows' pre-activations are exact ReLU ties there.  dx, dw1,
    dw2 and db2 match the Pallas op's VJP; db1 matches ReLU's tie rule
    (``_relu_finite_mlp``), where the Pallas op's ``jnp.maximum`` gives
    1/2 and a different db1 at the tied channels.  f32 within 1e-5; bf16
    within one rounding of the working type (1e-2 relative)."""
    rng = np.random.default_rng(15)
    M, Kd, N = 128, 64, 32
    x = rng.standard_normal((M, Kd)).astype(np.float32)
    x[rng.random(M) < 0.3] = -np.inf
    x[rng.random((M, Kd)) < 0.1] = -np.inf
    w1 = (rng.standard_normal((Kd, N)) / 8).astype(np.float32)
    w2 = (rng.standard_normal((N, N)) / 6).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    b1[::3] = 0.0
    b2 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    jw = tuple(jnp.asarray(a) for a in (w1, b1, w2, b2))
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(
            lambda *a: jax.vjp(j_finite_mlp_fused, *a)[1](jg))(jx, *jw))
        relu = jax.device_get(jax.jit(
            lambda *a: jax.vjp(_relu_finite_mlp, *a)[1](jg))(jx, *jw))
    tdt = getattr(torch, dtype)
    xt = _t(np.asarray(jax.device_get(jx).astype(np.float32))).to(tdt)
    gt = _t(np.asarray(jax.device_get(jg).astype(np.float32))).to(tdt)
    got = K.finite_mlp_bwd(xt, _t(w1.T).to(tdt), _t(b1), _t(w2.T).to(tdt),
                           _t(b2), gt)
    dx = got[0].float().numpy()
    assert np.isfinite(dx).all()
    assert (dx[np.isneginf(x)] == 0).all()
    tol = TOL if dtype == "float32" else 1e-2
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                          (want[0], want[1].T, relu[2], want[3].T, want[4])):
        w = np.asarray(w, np.float32)
        assert a.shape == w.shape, name
        assert _rel(a.float().numpy(), w) <= tol, (name, _rel(a.float(), w))
    # the Pallas op's tie rule differs exactly on the tied channels
    tied = b1 == 0
    fused_db1 = np.asarray(want[2], np.float32)
    assert _rel(got[2].numpy()[~tied], fused_db1[~tied]) <= tol
    assert not np.allclose(got[2].numpy()[tied], fused_db1[tied], rtol=0.1)
    # emp::finite_mlp_fused's backward is this function
    args = [t.clone().requires_grad_(t.is_floating_point()) for t in
            (xt, _t(w1.T).to(tdt), _t(b1), _t(w2.T).to(tdt), _t(b2))]
    K.finite_mlp_fused(*args).backward(gt)
    for a, t in zip(got, args):
        assert torch.equal(t.grad, a)


@pytest.mark.parametrize("raw", [False, True])
def test_pool_grads_match_jax_with_bf16_ties(raw):
    """The three plane pools' VJP in bf16 with features drawn from four
    values, so most pooled cells hold tied maxima (up to dozens of rows),
    invalid rows and empty cells: bit for bit with JAX's segment-max
    VJP, whose split of a tie is ``g * bf16(1 / count)``."""
    rng = np.random.default_rng(16)
    grid, split = (16, 16, 8), (4, 4, 2)
    _, idx, valid = _cloud(rng, 2, 700, grid, 1)
    feats = rng.integers(0, 4, (2, 700, 8)).astype(np.float32) / 4
    jf = jnp.asarray(feats, jnp.bfloat16)
    outs, vjp = jax.vjp(lambda f: j_pools(f, jnp.asarray(idx),
                                          jnp.asarray(valid), grid, split,
                                          raw=raw), jf)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    (want,) = jax.jit(vjp)(tuple(jnp.asarray(c, jnp.bfloat16) for c in cots))
    ft = _t(feats).to(torch.bfloat16).requires_grad_(True)
    got = point_plane_pools_batch(ft, _t(idx), _t(valid), grid, split,
                                  raw=raw)
    for g, o in zip(got, outs):
        np.testing.assert_array_equal(g.detach().float().numpy(),
                                      np.asarray(o, np.float32))
    torch.autograd.backward(got, [_t(c).to(torch.bfloat16) for c in cots])
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(ft.grad.float().numpy(), want)
    assert (want[~valid] == 0).all()
    # ties of three or more rows, where a division would round otherwise
    assert (want != 0).sum() > 0


def _frozen_cfg(model_cfg):
    """``model_cfg`` with ``frozen_stages=1`` in both encoders (the full
    config's freezing at the tiny width)."""
    for k in ("camera_encoder", "triplane_encoder"):
        model_cfg[k]["frozen_stages"] = 1
    return model_cfg


def _path(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def _draw(shapes, seed):
    """Flat ``{collection/path: float32 array}`` drawn with numpy for the
    variable shapes (``jax.eval_shape``: no JAX initialisation to
    compile): LeCun-normal kernels, biases from N(0, 0.1), norm scales
    from 1 + N(0, 0.1), layer-scale gamma from U(0.1, 1), BatchNorm means
    from N(0, 0.5) and variances from U(0.5, 2)."""
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


@pytest.fixture(scope="module")
def step_case():
    """The batch, the drawn variables and the JAX model."""
    arrs = synthetic_arrays(2, point_budget=1024, with_occ=True, seed=5)
    jcfg = _frozen_cfg(tiny_point(occ=True))
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True),
        jax_batch(arrs))
    return dict(arrs=arrs, jcfg=jcfg, model=model, flat=_draw(shapes, 17))


def test_tiny_point_occ_train_step_matches_jax(step_case):
    """The step against JAX's optax chain (its ``flat_adamw`` case is in
    ``tests/test_torch_port_flat_opt.py``)."""
    check_train_step(step_case, fused=False)


def check_train_step(step_case, fused: bool):
    """One ``tiny_point_occ`` train step of the port (its flat AdamW)
    against JAX's, whose optimizer is ``flat_adamw`` with ``fused`` and
    optax's chain without."""
    cfg = get_config("tiny_point_occ")
    _frozen_cfg(cfg["model"])
    cfg["optimizer"]["fused"] = fused
    b1 = cfg["optimizer"]["betas"][0]
    flat, arrs = step_case["flat"], step_case["arrs"]
    freeze = jax_frozen_stage_tokens(step_case["jcfg"])
    assert freeze  # stage 0 and the stems of both encoders

    variables = unflatten(flat)
    params = variables["params"]
    opt = jax_make_optimizer(cfg, 4, params, freeze)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=opt.init(params),
                       batch_stats=variables["batch_stats"])
    step = make_train_step(step_case["model"], opt, rng_names=("droppath",),
                           donate=False, freeze_prefixes=freeze)
    with jax.default_matmul_precision("highest"):
        new, logs = step(state, jax_batch(arrs), jax.random.key(0))
    new = jax.device_get(new)
    norm = float(logs["grad_norm"])
    scale = min(1.0, cfg["grad_clip"] / norm)
    # JAX's gradients, by path, from its first moment
    mask = freeze_mask(params, freeze)
    paths = [_path(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    trainable = jax.tree_util.tree_leaves(mask)
    if fused:
        mu_flat, off, mu = np.asarray(new.opt_state.mu), 0, {}
        for p, t in zip(paths, trainable):
            if t:
                n = int(np.prod(flat[f"params/{p}"].shape))
                mu[p] = mu_flat[off:off + n].reshape(
                    flat[f"params/{p}"].shape)
                off += n
        assert off == mu_flat.size
    else:
        import optax

        mu_tree = optax.tree_utils.tree_get(new.opt_state, "mu")
        mu = {_path(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(mu_tree)[0]}
    want_grads = {p: mu[p] / (1 - b1) / scale
                  for p, t in zip(paths, trainable) if t}

    port = build_model(cfg["model"], device="cpu")
    port.load_state_dict(load_jax_params(flat, port))
    trainer = build_trainer(cfg, port, 4, seed=0)
    frozen = {n: p.detach().clone() for n, p in port.named_parameters()
              if not p.requires_grad}
    assert frozen and len(trainer.named) == len(want_grads)
    batch = arrays_to_batch(arrs)
    stats0 = _bn_stats(port)
    _, loss, grads = loss_and_grads(port, trainer.params, batch,
                                    trainer.generator(0))
    port.load_state_dict(stats0, strict=False)  # one update per step
    got = trainer.train_step(batch)

    want_loss = float(logs["loss"])
    assert abs(float(loss.detach()) - want_loss) <= TOL * abs(want_loss)
    assert abs(float(got["loss"]) - want_loss) <= TOL * abs(want_loss)
    np.testing.assert_allclose(float(got["grad_norm"]), norm, rtol=GRAD_TOL)
    by_port = {}
    for p in paths:
        name, _ = port_key(f"params/{p}", flat[f"params/{p}"])
        by_port[name.replace("/", ".")] = p
    want_g = {n: port_key(f"params/{by_port[n]}", want_grads[by_port[n]])[1]
              for n, _ in trainer.named}
    floor = ZERO_GRAD * max(np.linalg.norm(w) for w in want_g.values())
    zero = set()
    for (n, _), g in zip(trainer.named, grads):
        if np.linalg.norm(want_g[n]) <= floor:
            zero.add(n)
            assert np.linalg.norm(g.numpy()) <= floor, n
        else:
            assert _rel(g.numpy(), want_g[n]) <= GRAD_TOL, (
                n, _rel(g.numpy(), want_g[n]))
    assert 0 < len(zero) <= 6, sorted(zero)

    new_flat = {**{f"params/{k}": np.asarray(v) for k, v in
                   traverse_util.flatten_dict(new.params, sep="/").items()},
                **{f"batch_stats/{k}": np.asarray(v) for k, v in
                   traverse_util.flatten_dict(new.batch_stats,
                                              sep="/").items()}}
    want_sd = load_jax_params(new_flat, port)
    lr = float(got["lr"])
    moved = 0
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            _close(v, want_sd[k])
            moved += not torch.equal(v, stats0[k])
        elif k in frozen:
            assert torch.equal(v, frozen[k]), k
            assert torch.equal(want_sd[k], frozen[k]), k
        else:
            # Adam's first step moves an entry by about lr * sign(g): an
            # entry whose gradient is within the noise of 0 may step
            # either way (+-lr); every other entry is held to TOL
            v, w, gw = v.numpy(), want_sd[k].numpy(), np.abs(want_g[k])
            noisy = (np.ones_like(gw, bool) if k in zero
                     else gw <= NOISE * np.sqrt(np.mean(gw * gw)))
            assert np.abs(v - w)[noisy].max(initial=0) <= 2 * lr * 1.001, k
            assert _rel(v[~noisy], w[~noisy]) <= TOL, (
                k, _rel(v[~noisy], w[~noisy]))
    assert moved == len(stats0)  # every running statistic moved


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_point_cli_trains_evaluates_and_serves(tmp_path):
    out = _run(cli.main, ["tiny_point_occ", "--work-dir", str(tmp_path),
                          "--synthetic", "--max-steps", "2", "--device",
                          "cpu"])
    steps = [s for s in out.splitlines() if s.startswith("{")]
    assert len(steps) == 2 and "nan" not in out
    ckpt = tmp_path / "checkpoints" / "step_2.pt"
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and state["opt"]["count"] == 2
    stats = {k: v for k, v in state["params"].items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 20  # 4 BatchNorms in the point MLP, 6 in the FPN
    assert all(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                               else torch.ones_like(v))
               for k, v in stats.items())

    shown = _run(eval_cli.main, ["tiny_point_occ", "--checkpoint", str(ckpt),
                                 "--synthetic", "--device", "cpu"])
    cfg = get_config("tiny_point_occ")
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(restore_params_only(ckpt))
    want = evaluate(model, make_val_batches(cfg["data"], 1, 2)(),
                    "PointTriplaneOcc", 5)
    assert f"CE: {want['ce']:.4f}" in shown
    assert f"mIoU: {want['miou']:.4f}" in shown

    server, worker = serve.make_server("tiny_point_occ", checkpoint=str(ckpt),
                                       port=0, batch_size=1, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    arrs = synthetic_arrays(1, point_budget=cfg["data"]["point_budget"],
                            seed=9)
    req = {k: arrs[k] for k in serve.batch_keys(model)}
    try:
        buf = io.BytesIO()
        np.savez(buf, **req)
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), method="POST"), timeout=120)
        with np.load(io.BytesIO(r.read())) as z:
            pred = z["pred"]
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
    with torch.no_grad():
        logits = model(arrays_to_batch(req))[0]
    np.testing.assert_array_equal(
        pred, torch.argmax(logits, -1).to(torch.int8).numpy())

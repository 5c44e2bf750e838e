"""SparK-masked pretraining, the colour head, MiT high and
``norm_pix_loss`` of the port against the JAX package, on the CPU.

JAX's masks are injected: JAX draws them inside the model from
``make_rng("mask")``, and :func:`jax_mask_key` recovers that key (the
first ``make_rng("mask")`` of the top module's scope), from which the
JointEncoder's ``fold_in(key, 1)`` / ``fold_in(key, 0)`` camera and range
masks follow; the port's ``JointEncoder.draw`` is replaced to return them.
Float32 throughout, JAX at full matmul precision.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import (
    TINY_ARCH,
    tiny_encoder,
    tiny_mae,
    tiny_neck,
    tiny_occ,
)
from efficient_multimodal_perception_tpu.models import builder as jax_builder
from efficient_multimodal_perception_tpu.models.convnext import (
    MaskConvNeXt as JMaskConvNeXt,
    SparseBatchNorm2d as JSparseBatchNorm2d,
    random_active_mask as j_random_active_mask,
    upsample_mask as j_upsample_mask,
)
from efficient_multimodal_perception_tpu.models.heads import (
    PointMlpHead as JPointMlpHead,
)
from efficient_multimodal_perception_tpu.models.mit import (
    MixVisionTransformer as JMiT,
)
from efficient_multimodal_perception_tpu.models.triplane_mae import (
    TriplaneMAE as JTriplaneMAE,
)
from efficient_multimodal_perception_tpu.train.trainer import (
    freeze_mask,
    total_loss as jax_total_loss,
)
from efficient_multimodal_perception_tpu_torch.configs import (
    apply_overrides,
    get_config,
)
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import (
    MODELS,
    REGISTRY,
    build,
    build_model,
)
from efficient_multimodal_perception_tpu_torch.models.convnext import (
    MaskConvNeXt,
    SparseBatchNorm2d,
    random_active_mask,
    upsample_mask,
)
from efficient_multimodal_perception_tpu_torch.models.heads import (
    PointMlpHead,
)
from efficient_multimodal_perception_tpu_torch.models.mit import (
    MixVisionTransformerHead,
)
from efficient_multimodal_perception_tpu_torch.models.triplane_mae import (
    TriplaneMAE,
)
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    Trainer,
    build_trainer,
    freeze,
    loss_and_grads,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_mae import JAX_FREEZE, PORT_FREEZE, _jax_batch
from test_torch_port_point_train import _draw

RATIO = 0.75  # tests/test_masked_mae.py's ratios
COLOR = dict(type="PointMlp", input_dim=32, num_classes=3)
PORT_MASKED = [f"model.encoder.lidar_mask_ratio={RATIO}",
               f"model.encoder.camera_mask_ratio={RATIO}"]
PORT_COLOR = [f"model.color_decoder.{k}={v}" for k, v in COLOR.items()]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(shapes, seed):
    """Numpy weights for a JAX variable tree's shapes: ``(flat params,
    flat with collections, nested JAX variables)``."""
    flat = _draw(shapes, seed)
    nested = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return flat, nested


def _port(module, flat, part=None):
    """``module`` with the JAX weights ``flat`` (collection-prefixed)
    loaded strictly; ``part`` names the model part the bridge reads the
    paths as (the MiT rules hold under ``neck`` and the decoders)."""
    if part is None:
        module.load_state_dict(load_jax_params(flat, module))
        return module
    holder = torch.nn.Module()
    holder.add_module(part, module)
    flat = {k.replace("/", f"/{part}/", 1): v for k, v in flat.items()}
    holder.load_state_dict(load_jax_params(flat, holder))
    return module


def _masked(cfg, lidar=True, camera=True):
    cfg["encoder"]["lidar_mask_ratio"] = RATIO if lidar else 0.0
    cfg["encoder"]["camera_mask_ratio"] = RATIO if camera else 0.0
    return cfg


def jax_mask_key(model, variables, jb, key):
    """The key the top module's first ``make_rng("mask")`` gives in a
    forward with ``rngs={"mask": key}``."""
    return jax.jit(lambda k: model.apply(
        variables, jb, rngs={"mask": k},
        method=lambda m, b: m.make_rng("mask")))(key)


def jax_masks(enc_cfg, mask_key, B, N, image_hw, range_hw):
    """The JointEncoder's masks of one forward, in ``JointEncoder.draw``'s
    layout (``joint_encoder.py:105-131``)."""
    def draw(key):
        out = {}
        if enc_cfg["camera_mask_ratio"] > 0:
            out["camera"] = j_random_active_mask(
                jax.random.fold_in(key, 1), B * N, image_hw[0] // 16,
                image_hw[1] // 16, enc_cfg["camera_mask_ratio"])
        if enc_cfg["lidar_mask_ratio"] > 0:
            out["lidar"] = j_random_active_mask(
                jax.random.fold_in(key, 0), B, range_hw[0],
                range_hw[1] // 32, enc_cfg["lidar_mask_ratio"])
        return out

    return {k: torch.from_numpy(np.array(v))
            for k, v in jax.jit(draw)(mask_key).items()}


def inject(model, masks):
    model.encoder.draw = lambda *a, **k: masks


# --------------------------------------------------------------------------
# masks, the masked ConvNeXt, SparseBatchNorm2d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,hw", [((2, 16, 32, 1), (128, 256)),
                                      ((1, 32, 32, 1), (32, 128))])
def test_upsample_mask_matches_jax(shape, hw):
    m = np.random.default_rng(0).random(shape) < 0.5
    want = np.asarray(j_upsample_mask(jnp.asarray(m), hw))
    assert np.array_equal(upsample_mask(torch.from_numpy(m), hw).numpy(),
                          want)


def test_random_active_mask_draws():
    def draw(seed, B=3, h=16, w=32, r=RATIO):
        return random_active_mask(torch.Generator().manual_seed(seed), B, h,
                                  w, r)

    a = draw(0)
    assert a.shape == (3, 16, 32, 1) and a.dtype == torch.bool
    assert a.reshape(3, -1).sum(1).tolist() == [round(16 * 32 * 0.25)] * 3
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    assert not torch.equal(a[0], a[1])  # every sample draws its own


@pytest.fixture(scope="module")
def convnext_case():
    """A masked tiny ConvNeXt (with the dead ``reduce_dim`` convs and
    ``mtoken3``) in JAX, its weights and output."""
    kw = dict(arch=TINY_ARCH, in_channels=5, stem_patch_size=(1, 4),
              downsample_height=False, out_indices=3, multiscale=True,
              mae_cfg=dict(learnable=True, downsample_dim=64),
              layer_scale_init=0.5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 256, 5)).astype(np.float32)
    active = rng.random((2, 8, 8, 1)) < 0.5
    net = JMaskConvNeXt(**kw)
    shapes = jax.eval_shape(lambda a, m: net.init(
        jax.random.key(0), a, m), jnp.asarray(x), jnp.asarray(active))
    flat, variables = _params(shapes, 3)
    with jax.default_matmul_precision("highest"):
        y = jax.jit(lambda a, m: net.apply(variables, a, m))(
            jnp.asarray(x), jnp.asarray(active))
    return dict(kw=kw, x=x, active=active, flat=flat, y=np.asarray(y))


def test_masked_convnext_matches_jax(convnext_case):
    c = convnext_case
    net = _port(MaskConvNeXt(**c["kw"]), c["flat"])
    assert net.mtoken3.shape == (1, 64, 1, 1)
    assert net.reduce_dim[3].weight.shape == (768, 64, 1, 1)
    x, m = _t(c["x"]), torch.from_numpy(c["active"])
    with torch.no_grad():
        got = net(x, active_mask=m).numpy()
        split = net.forward2(net.forward1(x, active_mask=m),
                             active_mask=m).numpy()
    assert _rel(got, c["y"]) <= 1e-5
    assert np.array_equal(got, split)
    assert _rel(got, net(x).detach().numpy()) > 1e-2  # the mask acts


@pytest.mark.parametrize("train", [False, True])
def test_sparse_batch_norm_matches_jax(train):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 16, 6)).astype(np.float32) * 2 + 1
    active = rng.random((2, 4, 4, 1)) < 0.5
    net = JSparseBatchNorm2d()
    shapes = jax.eval_shape(lambda a: net.init(
        jax.random.key(0), a, jnp.asarray(active)), jnp.asarray(x))
    flat, variables = _params(shapes, 4)
    y, upd = net.apply(variables, jnp.asarray(x), jnp.asarray(active), train,
                       mutable=["batch_stats"])
    port = _port(SparseBatchNorm2d(6), flat)
    got = port(_t(x), torch.from_numpy(active), train)
    assert _rel(got.detach(), y) <= 1e-6
    m = upsample_mask(torch.from_numpy(active), (8, 16))
    assert not got[~m.expand_as(got)].any()  # masked pixels are zero
    want = traverse_util.flatten_dict(jax.device_get(upd), sep="/")
    for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
        assert _rel(getattr(port.bn, buf), want[f"batch_stats/bn/{leaf}"]) \
            <= 1e-6


# --------------------------------------------------------------------------
# masked tiny triplane_range_cam with the colour head; TriplaneOcc
# --------------------------------------------------------------------------

def _groups(names):
    out = {}
    for n in names:
        p = n.split(".")
        k = (".".join(p[:4]) if p[0] == "encoder" and p[2] == "stages"
             else ".".join(p[:2]))
        out.setdefault(k, []).append(n)
    return out


@pytest.fixture(scope="module")
def masked_mae_case():
    """JAX losses and gradients of the masked tiny range-cam MAE with the
    colour head at B=1 (f32, deterministic, stage 0 frozen by
    stop_gradient) and its masks (``reconstructions`` are held to JAX in
    ``test_torch_port_viz.py``, through the eval CLI)."""
    arrs = synthetic_arrays(1, point_budget=2048, seed=5)
    jb = _jax_batch(arrs)
    cfg = _masked(tiny_mae(contrastive=False, surface=False))
    cfg["color_decoder"] = dict(COLOR)
    model = jax_builder.build_model(cfg)
    key = jax.random.key(11)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "mask": key}, b, deterministic=True),
        jb)
    flat, variables = _params(shapes, 6)

    def loss_fn(params):
        keep = freeze_mask(params, JAX_FREEZE)
        params = jax.tree.map(
            lambda p, t: p if t else jax.lax.stop_gradient(p), params, keep)
        losses = model.apply({"params": params}, jb, deterministic=True,
                             rngs={"mask": key})
        return jax_total_loss(losses), losses

    with jax.default_matmul_precision("highest"):
        (_, losses), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    gflat = traverse_util.flatten_dict(jax.device_get(grads), sep="/")
    mk = jax_mask_key(model, variables, jb, key)
    return dict(
        arrs=arrs, flat=flat, losses={k: float(v) for k, v in losses.items()},
        grads={port_key(k, np.asarray(v))[0].replace("/", "."):
               port_key(k, np.asarray(v))[1] for k, v in gflat.items()},
        masks=jax_masks(cfg["encoder"], mk, 1, 6, (256, 512), (32, 1024)))


def _port_mae(case):
    cfg = apply_overrides(get_config("tiny_range_cam"),
                          PORT_MASKED + PORT_COLOR)
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(load_jax_params(case["flat"], model))
    return model


def test_masked_mae_matches_jax(masked_mae_case):
    c = masked_mae_case
    model = _port_mae(c)
    inject(model, c["masks"])
    named = freeze(model, PORT_FREEZE)
    losses, _, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(c["arrs"]), None,
        deterministic=True)
    assert set(losses) == set(c["losses"]) == {"camera_loss", "range_loss",
                                               "color"}
    for k, v in c["losses"].items():
        assert abs(float(losses[k]) - v) <= 1e-4 * abs(v), k
    got = {n: (np.zeros_like(c["grads"][n]) if g is None else g.numpy())
           for (n, _), g in zip(named, grads)}
    # the colour head takes no gradient: "color" is no "loss" key
    assert all(g is None for (n, _), g in zip(named, grads)
               if n.startswith("color_decoder."))
    assert not any(np.any(c["grads"][n]) for n in got
                   if n.startswith("color_decoder."))
    errs = {}
    for grp, names in _groups(got).items():
        a = np.concatenate([got[n].ravel() for n in names])
        b = np.concatenate([c["grads"][n].ravel() for n in names])
        if np.any(b):
            errs[grp] = _rel(a, b)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_masked_occ_forward_matches_jax():
    arrs = synthetic_arrays(1, point_budget=2048, seed=6)
    jb = _jax_batch(arrs)
    cfg = _masked(tiny_occ(), camera=False)
    model = jax_builder.build_model(cfg)
    key = jax.random.key(12)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "mask": key}, b, deterministic=True),
        jb)
    flat, variables = _params(shapes, 7)
    with jax.default_matmul_precision("highest"):
        logits = jax.jit(lambda v, b: model.apply(
            v, b, deterministic=True, rngs={"mask": key})[0])(variables, jb)
    masks = jax_masks(cfg["encoder"], jax_mask_key(model, variables, jb, key),
                      1, 6, (256, 512), (32, 1024))
    port_cfg = apply_overrides(get_config("tiny_occ"),
                               [f"model.encoder.lidar_mask_ratio={RATIO}"])
    port = build_model(port_cfg["model"], device="cpu")
    port.load_state_dict(load_jax_params(flat, port))
    inject(port, masks)
    with torch.no_grad():
        got = port(arrays_to_batch(arrs))[0]
    assert _rel(got, logits) <= 1e-4


def test_trainer_draws_masks_per_step():
    """The trainer's third stream: masks differ from step to step and
    micro-batch to micro-batch, and a model that masks nothing gets
    none.  Every stream, micro-batch and run seed draws its own numbers
    on the CPU too, whose generator keeps a seed's low 32 bits only."""
    cfg = apply_overrides(get_config("tiny_range_cam"), PORT_MASKED)
    model = build_model(cfg["model"], device="cpu")
    tr = build_trainer(cfg, model, total_steps=1)
    other = build_trainer(cfg, model, total_steps=1, seed=1)
    gens = [tr.generator(0), tr.sample_generator(0), tr.mask_generator(0),
            tr.generator(0, 1), other.generator(0)]
    draws = [torch.rand(4, generator=g) for g in gens]
    assert all(not torch.equal(a, b) for i, a in enumerate(draws)
               for b in draws[i + 1:])
    enc = model.encoder

    def masks(g):
        return enc.draw(1, 6, (256, 512), (32, 1024), g)

    a, b = masks(tr.mask_generator(0)), masks(tr.mask_generator(1))
    assert set(a) == {"camera", "lidar"}
    assert not torch.equal(a["camera"], b["camera"])
    assert torch.equal(a["lidar"], masks(tr.mask_generator(0))["lidar"])
    assert not torch.equal(a["lidar"], masks(tr.mask_generator(0, 1))["lidar"])
    plain = build_model(get_config("tiny_range_cam")["model"], device="cpu")
    assert Trainer(plain, cfg, 1).mask_generator(0) is None
    with pytest.raises(ValueError, match="mask_generator"):
        masks(None)


# --------------------------------------------------------------------------
# the colour head, MiT high, norm_pix_loss, the registry
# --------------------------------------------------------------------------

def test_point_mlp_and_color_loss_match_jax():
    rng = np.random.default_rng(8)
    B, N, H, W, P, C = 1, 2, 16, 24, 40, 8
    img = rng.standard_normal((B, N, H, W, 3)).astype(np.float32)
    rc = np.stack([rng.uniform(-1, H + 3, (B, N, 4, P // 4)),
                   rng.uniform(-1, W + 3, (B, N, 4, P // 4))], -1)
    rc[:, :, 0, :3] = -1.0  # invalid projections
    rc = rc.astype(np.float32)
    feats = rng.standard_normal((B, 4, P // 4, C)).astype(np.float32)
    jm = jax_builder.build_model(dict(
        type="TriplaneMAE", encoder=tiny_encoder(), neck=tiny_neck(),
        color_decoder=dict(COLOR, input_dim=C)))
    jbatch = types.SimpleNamespace(img=jnp.asarray(img))
    aux = {"rc_coors": jnp.asarray(rc)}
    shapes = jax.eval_shape(lambda f: jm.init(
        jax.random.key(0), jbatch, aux, f, method=JTriplaneMAE._color_loss),
        jnp.asarray(feats))
    flat, variables = _params(shapes, 9)
    want = jax.jit(lambda v, f: jm.apply(
        v, jbatch, aux, f, method=JTriplaneMAE._color_loss))(
            variables, jnp.asarray(feats))
    head = _port(PointMlpHead(C, 3), {
        k.replace("params/color_decoder/", "params/"): v
        for k, v in flat.items()}, "color_decoder")
    pm = TriplaneMAE(None, None, color_decoder=head)
    got = pm._color_loss(types.SimpleNamespace(img=_t(img)),
                         {"rc_coors": _t(rc)}, _t(feats))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    x = rng.standard_normal((5, C)).astype(np.float32)
    jh = JPointMlpHead(C, 3)
    hv = {"params": variables["params"]["color_decoder"]}
    with torch.no_grad():
        assert _rel(head(_t(x)), jh.apply(hv, jnp.asarray(x))) <= 1e-5


def test_mit_high_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 32, 32, 64)).astype(np.float32)
    net = JMiT(in_chans=64, embed_dim=64, high=True)
    shapes = jax.eval_shape(lambda a: net.init(jax.random.key(0), a),
                            jnp.asarray(x))
    flat, variables = _params(shapes, 11)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda a: net.apply(variables, a))(jnp.asarray(x))
    port = _port(build(dict(type="MixVisionTransformerHigh", in_chans=64,
                            embed_dim=64)), flat, "neck")
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == want.shape == (1, 128, 128, 96)  # 1024 tokens
    assert _rel(got, want) <= 1e-4


def test_norm_pix_loss_is_the_plain_loss():
    """C6: JAX declares ``norm_pix_loss`` and reads it nowhere; the port's
    loss is the plain patch MSE with the flag on as off."""
    rng = np.random.default_rng(12)
    canvas = _t(rng.standard_normal((1, 32, 64, 8)))
    img = _t(rng.standard_normal((1, 32, 64, 3)))
    losses = []
    for flag in (True, False):
        torch.manual_seed(0)
        head = MixVisionTransformerHead(in_chans=8, embed_dim=32,
                                        norm_pix_loss=flag)
        with torch.no_grad():
            pred = head(canvas)
            losses.append(float(head.forward_loss(img, pred,
                                                  torch.ones_like(img))))
    want = float(((pred - head.patchify(img)) ** 2).mean())
    assert losses[0] == losses[1]
    assert abs(losses[0] - want) <= 1e-6 * want


def test_registry_names_equal_jax():
    jax_builder._register_all()
    assert set(REGISTRY) | set(MODELS) == set(jax_builder._REGISTRY)

"""The port's ``triplane_occ`` fine-tune path against the JAX package, on
the CPU: occupancy metrics, the pretrain -> fine-tune partial load, and
one fine-tune step.

- ``evaluation_semantic`` / ``aggregate_iou`` equal JAX's exactly on
  random predictions and labels with 255s (one case with a class absent
  from both, so its IoU is NaN);
- ``partial_load`` of a ``tiny_range_cam`` state into ``tiny_occ`` takes
  the same entries as JAX's ``partial_load`` on the same trees bridged
  through ``weights.load_jax_params`` (encoder and neck whole, the MAE
  decoders skipped) and gives the same merged values;
- one ``tiny_occ`` fine-tune step (encoder and neck frozen) from the
  same weights and batch as JAX's ``make_train_step``: the loss, the head
  gradients and the head after the update within 1e-4 relative, the
  frozen tensors unchanged.  JAX's gradients are read from its Adam first
  moment after the step (``mu = (1 - b1) g`` from zero, no clip below a
  norm of 35).

Weights are drawn with numpy for the JAX tree's shapes (``eval_shape``,
no JAX initialisation): LeCun-normal kernels, biases from N(0, 0.1),
norm scales from 1 + N(0, 0.1), layer-scale gamma from U(0.1, 1).  JAX
runs under full matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import (
    tiny_mae as jax_tiny_mae,
    tiny_occ as jax_tiny_occ,
)
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.train import checkpoint as JC
from efficient_multimodal_perception_tpu.train import metrics as JM
from efficient_multimodal_perception_tpu.train.trainer import (
    TrainState,
    frozen_stage_tokens as jax_frozen_stage_tokens,
    make_optimizer as jax_make_optimizer,
    make_train_step,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.train import metrics
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    partial_load,
)
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    build_trainer,
    loss_and_grads,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_occ import jax_batch, unflatten
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

RTOL = 1e-4
FREEZE = ("encoder", "neck")


def _shapes(jax_cfg):
    """The JAX model and its parameter shapes (traced, not compiled)."""
    arrs = synthetic_arrays(1, point_budget=512, with_occ=True, seed=0)
    model = jax_build_model(jax_cfg)
    tree = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True),
        jax_batch(arrs))["params"]
    return model, traverse_util.flatten_dict(tree, sep="/")


def _draw(shapes, seed):
    """Flat ``{path: float32 array}`` drawn for ``shapes``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        leaf, shape = k.rsplit("/", 1)[-1], s.shape
        if leaf == "kernel":
            v = rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif leaf == "gamma":
            v = rng.uniform(0.1, 1.0, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("absent", [None, 3])
def test_metrics_match_jax(absent):
    rng = np.random.default_rng(0 if absent is None else 1)
    shape, n_cls = (3, 24, 20, 8), 5
    pred = rng.integers(0, n_cls, shape)
    gt = rng.integers(0, n_cls, shape)
    if absent is not None:
        pred[pred == absent] = 0
        gt[gt == absent] = 1
    gt[rng.random(shape) < 0.3] = 255
    want = np.asarray(JM.evaluation_semantic(jnp.asarray(pred),
                                             jnp.asarray(gt), n_cls))
    got = metrics.evaluation_semantic(torch.from_numpy(pred),
                                      torch.from_numpy(gt), n_cls)
    assert got.dtype == torch.float32 and got.shape == (3, n_cls, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    agg, jagg = metrics.aggregate_iou(got.numpy()), JM.aggregate_iou(want)
    assert agg.keys() == jagg.keys()
    for k in agg:
        np.testing.assert_array_equal(agg[k], jagg[k])
    assert np.isnan(agg["per_class"][absent or 0]) == (absent is not None)


def test_partial_load_matches_jax():
    _, occ_shapes = _shapes(jax_tiny_occ())
    _, mae_shapes = _shapes(jax_tiny_mae(contrastive=False, surface=False))
    target, source = _draw(occ_shapes, 1), _draw(mae_shapes, 2)
    merged, n_ok, n_all = JC.partial_load(unflatten(target),
                                          unflatten(source))
    occ = build_model(get_config("tiny_occ")["model"], device="cpu")
    mae = build_model(get_config("tiny_range_cam")["model"], device="cpu")
    got, p_ok, p_all = partial_load(load_jax_params(target, occ),
                                    load_jax_params(source, mae))
    assert (p_ok, p_all) == (n_ok, n_all)
    enc_neck = [k for k in got if k.split(".")[0] in FREEZE]
    assert n_ok == len(enc_neck) and n_all - n_ok == 3  # the head's three
    want = load_jax_params({k: np.array(v) for k, v in traverse_util.
                            flatten_dict(merged, sep="/").items()}, occ)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_tiny_occ_finetune_step_matches_jax():
    model, shapes = _shapes(jax_tiny_occ())
    flat = _draw(shapes, 3)
    cfg = get_config("tiny_occ")
    arrs = synthetic_arrays(1, point_budget=2048, with_occ=True, seed=4)

    freeze = FREEZE + jax_frozen_stage_tokens(jax_tiny_occ())
    params = unflatten(flat)
    opt = jax_make_optimizer(cfg, 4, params, freeze)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=opt.init(params), batch_stats={})
    step = make_train_step(model, opt, donate=False, freeze_prefixes=freeze)
    with jax.default_matmul_precision("highest"):
        new, logs = step(state, jax_batch(arrs), jax.random.key(0))
    new_flat = traverse_util.flatten_dict(jax.device_get(new.params),
                                          sep="/")
    mu = traverse_util.flatten_dict(jax.device_get(
        optax.tree_utils.tree_get(new.opt_state, "mu")), sep="/")
    b1 = cfg["optimizer"]["betas"][0]
    assert float(logs["grad_norm"]) < cfg["grad_clip"]

    port = build_model(cfg["model"], device="cpu")
    port.load_state_dict(load_jax_params(flat, port))
    trainer = build_trainer(cfg, port, 4, seed=0)
    frozen = {n: p.detach().clone() for n, p in port.named_parameters()
              if not p.requires_grad}
    batch = arrays_to_batch(arrs)
    _, loss, grads = loss_and_grads(port, trainer.params, batch,
                                    trainer.generator(0))
    got = trainer.train_step(batch)

    head = {n for n, _ in trainer.named}
    assert head == {"decoder.conv1.0.weight", "decoder.conv2.0.weight",
                    "decoder.conv3.0.weight"}
    assert frozen.keys() | head == set(port.state_dict())
    want_loss = float(logs["loss"])
    assert abs(float(loss.detach()) - want_loss) <= RTOL * abs(want_loss)
    assert abs(float(got["loss"]) - want_loss) <= RTOL * abs(want_loss)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(logs["grad_norm"]), rtol=RTOL)
    by_port = {port_key(k, v)[0].replace("/", "."): (k, v)
               for k, v in new_flat.items()}
    for (n, p), g in zip(trainer.named, grads):
        k, _ = by_port[n]
        want_g = port_key(k, np.asarray(mu[k]) / (1 - b1))[1]
        err = np.linalg.norm(g.numpy() - want_g) / np.linalg.norm(want_g)
        assert err <= RTOL, (n, err)
        want_p = port_key(k, by_port[n][1])[1]
        err = (np.linalg.norm(p.detach().numpy() - want_p)
               / np.linalg.norm(want_p))
        assert err <= RTOL, (n, err)
        assert not np.array_equal(want_p, port_key(k, flat[k])[1])
    for n, p in port.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
            k, v = by_port[n]
            np.testing.assert_array_equal(v, flat[k])

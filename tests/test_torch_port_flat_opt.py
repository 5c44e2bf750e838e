"""The port's flat AdamW (``train/flat_opt.py``, the optimizer of every
config) on the CPU:

- against the port's per-parameter ``AdamW`` over 3 steps (one with the
  gradient norm above the clip) at 1e-6, frozen tensors bit-identical,
  every parameter updated in its own storage (the optimizer holds no
  alias of it);
- against the JAX package's ``flat_adamw`` on the same numpy gradients;
- a checkpoint of ``Trainer.state_dict`` written under one optimizer and
  resumed under the other, both ways;
- one ``tiny_point_occ`` train step against JAX's ``make_train_step``
  with ``optimizer.fused`` (its ``flat_adamw``; the check of
  ``tests/test_torch_port_point_train.py``).
"""

import io

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from efficient_multimodal_perception_tpu.train.flat_opt import flat_adamw
from efficient_multimodal_perception_tpu.train.trainer import (
    cosine_schedule as jax_cosine_schedule,
)
from efficient_multimodal_perception_tpu_torch.train.flat_opt import FlatAdamW
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    AdamW,
    Trainer,
    cosine_schedule,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_point_train import check_train_step, step_case  # noqa: F401

TOL = 1e-6
STEPS = 3
SCHEDULE = dict(base_lr=2.5e-4, total_steps=8, warmup_iters=2,
                warmup_ratio=0.5, min_lr_ratio=0.1)
CFG = dict(optimizer=dict(type="AdamW", lr=2.5e-4, betas=(0.95, 0.99),
                          weight_decay=1e-3),
           grad_clip=35.0,
           lr_config=dict(warmup_iters=2, warmup_ratio=0.5,
                          min_lr_ratio=0.1))


class Toy(nn.Module):
    """Tensors of several shapes; ``frozen`` takes no update."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(7, 5)
        self.conv = nn.Conv2d(3, 4, 3)
        self.norm = nn.LayerNorm(6)
        self.frozen = nn.Linear(4, 4)


def _toy(seed=0):
    torch.manual_seed(seed)
    m = Toy()
    m.frozen.requires_grad_(False)
    return m


def _grads(params, step):
    """Gradients from a numpy seed; step 1's norm is above the clip."""
    rng = np.random.default_rng(100 + step)
    scale = 40.0 if step == 1 else 0.3
    return [torch.from_numpy((rng.standard_normal(tuple(p.shape)) * scale)
                             .astype(np.float32)) for p in params]


def _trainable(m):
    return [p for p in m.parameters() if p.requires_grad]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a.detach(), np.float64),
                               np.asarray(b.detach(), np.float64),
                               rtol=tol, atol=tol * 1e-2)


def test_flat_adamw_matches_adamw():
    ma, mb = _toy(), _toy()
    frozen = [p.clone() for p in mb.frozen.parameters()]
    sched = cosine_schedule(**SCHEDULE)
    ref = AdamW(_trainable(ma), sched)
    flat = FlatAdamW(_trainable(mb), sched)
    ptrs = [p.data_ptr() for p in _trainable(mb)]
    for step in range(STEPS):
        g = _grads(ref.params, step)
        n_ref, lr_ref = ref.step(g)
        n_flat, lr_flat = flat.step([x.clone() for x in g])
        assert lr_flat == lr_ref
        _close(n_flat, n_ref)
        if step == 1:
            assert float(n_flat) > 35.0
    assert flat.count == ref.count == STEPS
    for a, b in zip(ref.params, flat.params):
        _close(b, a)
    for a, b in zip(ref.mu + ref.nu, flat.mu + flat.nu):
        _close(b, a)
    for p, f in zip(mb.frozen.parameters(), frozen):
        assert torch.equal(p, f)
    assert [p.data_ptr() for p in _trainable(mb)] == ptrs


def test_flat_adamw_matches_jax_flat_adamw():
    m = _toy()
    named = [(n, p) for n, p in m.named_parameters()]
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in named}
    mask = {n: p.requires_grad for n, p in named}
    jopt = flat_adamw(jax_cosine_schedule(**SCHEDULE), mask=mask)
    state = jopt.init(params)
    flat = FlatAdamW(_trainable(m), cosine_schedule(**SCHEDULE))
    for step in range(STEPS):
        g = _grads([p for _, p in named], step)
        upd, state = jopt.update({n: jnp.asarray(x.numpy()) for (n, _), x in
                                  zip(named, g)}, state, params)
        params = {n: params[n] + upd[n] for n in params}
        flat.step([x for (_, p), x in zip(named, g) if p.requires_grad])
    for n, p in named:
        want = np.asarray(params[n])
        if p.requires_grad:
            _close(p, torch.from_numpy(want))
        else:
            np.testing.assert_array_equal(p.detach().numpy(), want)


@pytest.mark.parametrize("first", ["fused", "per_parameter"])
def test_checkpoint_resumes_under_the_other_optimizer(first):
    """Two steps under one optimizer, ``Trainer.state_dict`` through
    ``torch.save``, then one step under the other: equal to three steps
    under one optimizer."""
    def trainer(fused):
        t = Trainer(_toy(), CFG, 8, freeze_tokens=("frozen",))
        assert isinstance(t.optimizer, FlatAdamW)
        if not fused:
            t.optimizer = AdamW(t.params, t.optimizer.schedule)
        return t

    src, ref = trainer(first == "fused"), trainer(first == "fused")
    for step in range(STEPS):
        g = _grads(ref.params, step)
        ref.optimizer.step(g)
        if step < 2:
            src.optimizer.step([x.clone() for x in g])
            src.step += 1
    buf = io.BytesIO()
    torch.save(src.state_dict(), buf)
    buf.seek(0)
    dst = trainer(first != "fused")
    assert type(dst.optimizer) is not type(src.optimizer)
    dst.load_state_dict(torch.load(buf, weights_only=True))
    assert dst.step == 2 and dst.optimizer.count == 2
    dst.optimizer.step(_grads(dst.params, 2))
    for a, b in zip(ref.params, dst.params):
        _close(b, a)
    for a, b in zip(ref.optimizer.mu + ref.optimizer.nu,
                    dst.optimizer.mu + dst.optimizer.nu):
        _close(b, a)


def test_tiny_point_occ_fused_train_step_matches_jax(step_case):  # noqa: F811
    check_train_step(step_case, fused=True)

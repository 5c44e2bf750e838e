"""Channels-last BatchNorm helpers shared by the point family's modules
(the projector's ``MaskedBatchNorm`` and the FPN's ConvModules) and the
elevation heads (``models/heads.py``).

Statistics are float32; eps is the module's.  In training the running
statistics move as flax's ``batch_stats`` do, ``m * old + (1 - m) * new``
with the biased batch variance: ``nn.BatchNorm``'s own training mode
(and ``F.batch_norm(training=True)``) would use the unbiased one.  The
decay ``m`` is the module's, stored the PyTorch way,
``bn.momentum = 1 - m``: the point family's modules keep PyTorch's
default 0.1 (flax 0.9, which the JAX package sets there), the elevation
heads take 0.01 (flax ``nn.BatchNorm``'s default 0.99, which the JAX
package leaves in place there).
"""

from __future__ import annotations

import contextlib

import torch

FLAX_DEFAULT = 0.01  # bn.momentum of flax nn.BatchNorm's default decay 0.99

_held = [0]  # > 0 while hold_running_stats is active


@contextlib.contextmanager
def hold_running_stats():
    """Inside the block training forwards leave the running statistics as
    they are: the trainer holds them while a rematerialized forward is
    recomputed for its backward, so a step moves them once, as
    ``jax.checkpoint`` does."""
    _held[0] += 1
    try:
        yield
    finally:
        _held[0] -= 1


@torch.no_grad()
def update_running_stats(bn, mean, var) -> None:
    """``bn``'s running statistics moved toward the batch's ``mean`` and
    biased ``var`` by ``bn.momentum`` (not inside
    :func:`hold_running_stats`)."""
    if _held[0]:
        return
    m = bn.momentum
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean.detach())
    bn.running_var.copy_((1 - m) * bn.running_var + m * var.detach())


def batch_norm_eval(x, bn, dtype):
    """Channels-last ``x`` normalized with ``bn``'s running statistics
    in float32 (flax ``BatchNorm``'s order of operations), returned in
    ``dtype``."""
    mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    y = (x.float() - bn.running_mean.float()) * mul + bn.bias.float()
    return y.to(dtype)


def batch_norm_train(x, bn, dtype):
    """Channels-last ``x`` normalized with its own batch statistics over
    every axis but the last (flax ``BatchNorm`` with its fast variance,
    ``max(E[x^2] - E[x]^2, 0)``), ``bn``'s running statistics updated;
    returned in ``dtype``."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
    update_running_stats(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return ((xf - mean) * mul + bn.bias.float()).to(dtype)


"""Channels-last BatchNorm helpers shared by the point family's modules
(the projector's ``MaskedBatchNorm`` and the FPN's ConvModules).

Statistics are float32; eps is the module's.  In training the running
statistics move as flax's ``batch_stats`` do, ``0.9 * old + 0.1 * new``
with the biased batch variance: ``nn.BatchNorm``'s own training mode
(and ``F.batch_norm(training=True)``) would use the unbiased one.
"""

from __future__ import annotations

import torch

MOMENTUM = 0.9  # running statistics: 0.9 * old + 0.1 * batch (flax's)


@torch.no_grad()
def update_running_stats(bn, mean, var) -> None:
    """``bn``'s running statistics moved toward the batch's ``mean`` and
    biased ``var``."""
    bn.running_mean.copy_(MOMENTUM * bn.running_mean
                          + (1 - MOMENTUM) * mean.detach())
    bn.running_var.copy_(MOMENTUM * bn.running_var
                         + (1 - MOMENTUM) * var.detach())


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

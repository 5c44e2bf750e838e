"""Flat AdamW: the whole optimizer as a handful of vector ops
(counterpart of the JAX package's ``train/flat_opt.py``); the optimizer
of every config (``train.trainer.make_optimizer``).

A per-parameter loop (``train.trainer.AdamW``, kept as the reference)
updates each tensor with its own dozen elementwise launches, so a step
of a model with a few hundred tensors issues thousands of small
launches.  Here the gradients and the trainable parameters are gathered
into flat float32 vectors with one ``torch.cat`` each (batched copies),
clip -> Adam -> weight decay run on those vectors, and the update is
added back to the parameters with one multi-tensor ``_foreach_add_``: a
fixed handful of launches, whatever the number of tensors.  The
parameters keep their own storage, so moving or reloading the model
never detaches it from the optimizer.

The math is ``flat_adamw``'s: the clip norm over the trainable
parameters only (scale by ``clip / norm`` unless the norm is below the
clip, optax's law), Adam with bias correction and eps outside the square
root, weight decay added to the update, the update scaled by
``lr = schedule(count)`` at the 0-based update count.  Frozen parameters
are not in the list and are never written.

``mu`` and ``nu`` are exposed per parameter as views of the flat moments,
in the order of ``params``, so ``Trainer.state_dict`` saves the same
layout as under ``AdamW`` and a checkpoint resumes under either.
"""

from __future__ import annotations

import torch


class FlatAdamW:
    """Same constructor, ``step``, ``count``, ``mu`` and ``nu`` as
    ``train.trainer.AdamW``."""

    def __init__(self, params, schedule, betas=(0.95, 0.99),
                 weight_decay: float = 1e-3, eps: float = 1e-8,
                 grad_clip: float = 35.0):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.wd, self.eps, self.clip = weight_decay, eps, grad_clip
        self.count = 0
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"FlatAdamW takes float32 parameters, not "
                                 f"{p.dtype}")
        sizes = [p.numel() for p in self.params]
        device = self.params[0].device if self.params else None
        self.flat_mu, self.flat_nu, self.flat_g, self.flat_w = (
            torch.zeros(sum(sizes), device=device) for _ in range(4))

        def views(buf):
            return [v.view_as(p) for v, p in
                    zip(buf.split(sizes), self.params)]

        self.mu, self.nu = views(self.flat_mu), views(self.flat_nu)
        self.updates = views(self.flat_g)  # the update overwrites g

    @torch.no_grad()
    def step(self, grads) -> tuple:
        """Apply one update from ``grads`` (one per parameter, None as
        zero); return ``(global norm before the clip, lr used)``."""
        g = torch.cat([(torch.zeros_like(p) if gr is None else gr)
                       .reshape(-1) for p, gr in zip(self.params, grads)],
                      out=self.flat_g)
        w = torch.cat([p.reshape(-1) for p in self.params], out=self.flat_w)
        norm = torch.linalg.vector_norm(g)
        g = g * torch.where(norm < self.clip, 1.0, self.clip / norm)
        lr = self.schedule(self.count)
        self.count += 1
        self.flat_mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        self.flat_nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        torch.add((self.flat_mu / c1)
                  / ((self.flat_nu / c2).sqrt_() + self.eps),
                  w, alpha=self.wd, out=self.flat_g)
        torch._foreach_add_(self.params, self.updates, alpha=-lr)
        return norm, lr

"""The train step (counterpart of the JAX package's ``train/trainer.py``).

- Loss: the sum of the entries whose key contains "loss" (the
  reference's ``_parse_losses``); every entry is logged.
- Optimizer: optax's ``chain(clip_by_global_norm(35), adamw(schedule,
  b1=0.95, b2=0.99, weight_decay=1e-3))`` written out: the clip scales
  the gradients by ``35 / norm`` when their global norm reaches 35, Adam
  uses bias-corrected moments with eps 1e-8 outside the square root,
  weight decay is added to the update, and the update is scaled by the
  schedule at the 0-based update count.  Every config runs it on flat
  vectors (``train/flat_opt.FlatAdamW``); :class:`AdamW` is the same
  math tensor by tensor, the reference it is tested and timed against.
- BatchNorm: a training forward (``deterministic=False``) normalizes
  with batch statistics and updates the running statistics in place,
  once per step, as the JAX step's mutable ``batch_stats`` does; they
  are buffers, so ``state_dict`` carries them.
- Schedule: linear warmup from ``lr * warmup_ratio`` over
  ``warmup_iters`` updates, then a cosine to ``lr * min_lr_ratio`` at
  ``total_steps`` (mmcv's CosineAnnealing), in float32 as JAX computes it.
- Freezing: parameters whose name matches a freeze token (a top-level
  module, or a stage at any depth) get ``requires_grad=False``.  They
  take no gradient, no weight decay and no part in the clipped norm, as
  the JAX package's ``stop_gradient`` plus ``optax.set_to_zero``
  arrange.
- Randomness comes from two explicit ``torch.Generator`` objects per step on
  the model's device, both seeded from the run's seed and the step: one
  for drop-path, one for the losses' draws (the pretraining models'
  anchor scores, query picks and radii, passed as ``sample_generator`` to
  models with a ``draw`` method), as the JAX step keeps its ``sample``
  stream apart from ``droppath``.  The two never interleave, so a run
  with the kernels and one with the twins draw the same; no global RNG
  is read.
- Models: every task model; ``normalize_output`` takes the loss dict of
  those that return ``(pred..., losses)`` (``TriplaneOcc``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .flat_opt import FlatAdamW

def cosine_schedule(base_lr: float, total_steps: int, warmup_iters: int = 20,
                    warmup_ratio: float = 0.1, min_lr_ratio: float = 0.1):
    """``step -> lr`` (float32 arithmetic, as the JAX schedule)."""
    f = np.float32

    def schedule(step: int) -> float:
        s = f(step)
        warm = f(base_lr) * (f(warmup_ratio) + f(1 - warmup_ratio) * s
                             / f(max(warmup_iters, 1)))
        t = np.clip(s / f(max(total_steps, 1)), f(0), f(1))
        cos = f(base_lr) * (f(min_lr_ratio) + f(1 - min_lr_ratio) * f(0.5)
                            * (f(1) + np.cos(f(np.pi) * t)))
        return float(warm if s < warmup_iters else cos)

    return schedule


def frozen_stage_tokens(model_cfg: dict) -> tuple:
    """Freeze tokens for every ``frozen_stages = k`` in the config: the
    first k ``stages.i.`` and ``downsample_layers.i.`` of that encoder
    (all shipped configs use one k for every encoder, so stage-name
    tokens are exact)."""
    tokens = set()

    def walk(node):
        if isinstance(node, dict):
            k = node.get("frozen_stages", 0)
            if isinstance(k, int):
                for i in range(k):
                    tokens.add(f"stages.{i}.")
                    tokens.add(f"downsample_layers.{i}.")
            for v in node.values():
                walk(v)

    walk(model_cfg)
    return tuple(sorted(tokens))


def is_frozen(name: str, tokens: Sequence[str]) -> bool:
    """A parameter is frozen when a module token names its top-level
    module (``encoder`` freezes ``encoder.*``, not the elevation U-Net's
    ``decoder.decoder.encoder.*``) or its dotted name holds a stage token,
    one ending in a dot, at a component boundary (``stages.0.``)."""
    dotted = "." + name
    return any(("." + t) in dotted if t.endswith(".")
               else name.startswith(t + ".") for t in tokens)


def freeze(model: nn.Module, tokens: Sequence[str]) -> list:
    """Set ``requires_grad`` from the tokens; return the trainable
    ``(name, parameter)`` pairs."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name, tokens))
        if p.requires_grad:
            out.append((name, p))
    return out


def normalize_output(out) -> dict:
    """The loss dict of a model's output: task models return either the
    dict or ``(pred..., losses)``."""
    return out[-1] if isinstance(out, tuple) else out


def total_loss(losses: dict) -> torch.Tensor:
    """Sum of the entries whose key contains "loss", in float32."""
    terms = [v.float() for k, v in losses.items() if "loss" in k]
    return torch.stack(terms).sum()


class AdamW:
    """optax's clipped AdamW over a list of parameters (see the module
    docstring), one tensor at a time; moments are float32 and updated in
    place.  No config selects it: it is the reference that
    ``FlatAdamW`` is held to."""

    def __init__(self, params, schedule, betas=(0.95, 0.99),
                 weight_decay: float = 1e-3, eps: float = 1e-8,
                 grad_clip: float = 35.0):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.wd, self.eps, self.clip = weight_decay, eps, grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> tuple:
        """Apply one update from ``grads`` (one per parameter, None as
        zero); return ``(global norm before the clip, lr used)``."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(norm < self.clip, g, g / norm * self.clip)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * p
            p.sub_(lr * u)
        return norm, lr


def make_optimizer(cfg: dict, total_steps: int, params):
    """``train.flat_opt.FlatAdamW`` over ``params`` with the config's
    betas, weight decay, schedule and clip."""
    opt, lr_cfg = cfg["optimizer"], cfg["lr_config"]
    sched = cosine_schedule(opt["lr"], total_steps,
                            lr_cfg.get("warmup_iters", 20),
                            lr_cfg.get("warmup_ratio", 0.1),
                            lr_cfg.get("min_lr_ratio", 0.1))
    return FlatAdamW(params, sched, tuple(opt["betas"]),
                     opt.get("weight_decay", 1e-3),
                     grad_clip=cfg.get("grad_clip", 35.0))


OPTIMIZER_RANGE = "optimizer"  # profiler range around each update


# the losses' draws: a seed stream apart from drop-path's
SAMPLE_STREAM = 1 << 62


def loss_and_grads(model: nn.Module, params, batch, generator,
                   deterministic: bool = False, sample_generator=None):
    """One forward and backward: ``(losses, total loss, grads)`` with one
    gradient (or None) per parameter in ``params``; ``sample_generator``
    goes to models whose losses draw."""
    kw = {} if sample_generator is None else dict(
        sample_generator=sample_generator)
    losses = normalize_output(
        model(batch, deterministic=deterministic, generator=generator, **kw))
    loss = total_loss(losses)
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return losses, loss, grads


class Trainer:
    """Holds the model, its trainable parameters and the optimizer.

    ``train_step(batch)`` runs one forward, backward and update and
    returns the logs: every loss entry, ``loss``, ``grad_norm`` (before
    the clip) and ``lr``, as 0-d float32 tensors (``lr`` a float).
    """

    def __init__(self, model: nn.Module, cfg: dict, total_steps: int,
                 freeze_tokens: Sequence[str] = (), seed: int = 0):
        self.model = model
        self.named = freeze(model, freeze_tokens)
        self.params = [p for _, p in self.named]
        self.optimizer = make_optimizer(cfg, total_steps, self.params)
        self.seed = seed
        self.step = 0
        self.device = next(model.parameters()).device

    def state_dict(self) -> dict:
        """The model's ``state_dict``, the optimizer's moments by
        parameter name and its update count, and the step."""
        names = [n for n, _ in self.named]
        opt = self.optimizer
        return dict(step=self.step, params=self.model.state_dict(),
                    opt=dict(count=opt.count, mu=dict(zip(names, opt.mu)),
                             nu=dict(zip(names, opt.nu))))

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output exactly (same parameter
        names and shapes)."""
        self.model.load_state_dict(state["params"])
        opt = self.optimizer
        for i, (n, _) in enumerate(self.named):
            opt.mu[i].copy_(state["opt"]["mu"][n])
            opt.nu[i].copy_(state["opt"]["nu"][n])
        opt.count = int(state["opt"]["count"])
        self.step = int(state["step"])

    def generator(self, step: int) -> torch.Generator:
        """The drop-path generator of a step."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed << 32) + step)

    def sample_generator(self, step: int):
        """The losses' generator of a step, or None for a model whose
        losses draw nothing (no ``draw`` method)."""
        if not hasattr(self.model, "draw"):
            return None
        return torch.Generator(device=self.device).manual_seed(
            SAMPLE_STREAM + (self.seed << 32) + step)

    def train_step(self, batch) -> dict:
        losses, loss, grads = loss_and_grads(
            self.model, self.params, batch, self.generator(self.step),
            sample_generator=self.sample_generator(self.step))
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            norm, lr = self.optimizer.step(grads)
        self.step += 1
        logs = {k: v.detach().float() for k, v in losses.items()}
        logs.update(loss=loss.detach(), grad_norm=norm, lr=lr)
        return logs


def build_trainer(cfg: dict, model: nn.Module, total_steps: int,
                  seed: int = 0) -> Trainer:
    """A :class:`Trainer` freezing the config's ``model_init.freeze``
    tokens plus its ``frozen_stages``."""
    tokens = tuple(cfg.get("model_init", {}).get("freeze", ())) + \
        frozen_stage_tokens(cfg["model"])
    return Trainer(model, cfg, total_steps, tokens, seed)


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
- Randomness comes from explicit ``torch.Generator`` objects per step on
  the model's device, each seeded from the run's seed and the step: one
  for drop-path, one for the losses' draws (the pretraining models'
  anchor scores, query picks and radii, passed as ``sample_generator`` to
  models with a ``draw`` method) and, where an encoder masks (a MAE mask
  ratio > 0), a third for the masks (``mask_generator``), as the JAX step
  keeps its ``sample`` and ``mask`` streams apart from ``droppath``.
  They never interleave, so a run with the kernels and one with the twins
  draw the same; no global RNG is read.
- Models: every task model; ``normalize_output`` takes the loss dict of
  those that return ``(pred..., losses)`` (``TriplaneOcc``).
- ``accum_steps = k`` (JAX ``make_train_step(accum_steps=k)``): the batch
  is split into k micro-batches along its leading axis (k must divide
  it), each runs forward and backward with its own generators (seeded
  from the step and the micro-batch's index; index 0 is the step's
  usual pair), BatchNorm statistics move micro-batch after micro-batch,
  and the gradients and losses are averaged before the one update.
- ``remat`` (JAX ``jax.checkpoint`` over the forward):
  ``torch.utils.checkpoint`` (non-reentrant) over the model's forward,
  recomputed in the backward.  The recompute replays the drop-path, loss
  and mask generators from their states at the forward's start (the
  checkpoint's own RNG replay covers only the default generators) and
  runs under ``models.batch_norm.hold_running_stats``, so the step's
  draws, gradients and running statistics are those without remat.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..models.batch_norm import hold_running_stats
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


# the MAE masks' draws: a seed stream apart from the other two
MASK_STREAM = 1 << 61


# a micro-batch's seeds: the step's plus its index in this bit
MICRO_STREAM = 1 << 48


def seeded_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` for the 64-bit stream seed ``seed``,
    hashed to 32 bits (``numpy.random.SeedSequence``): the CPU generator's
    Mersenne Twister keeps only a seed's low 32 bits, which would give
    every stream, micro-batch and run seed of a step the same draws."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence(seed).generate_state(1)[0]))


def rematerialized(fn, generators=()):
    """``fn()`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward.  The recompute first
    restores each of ``generators`` to its state at this call, so it
    draws what the forward drew."""
    gens = [g for g in generators if g is not None]
    states = [g.get_state() for g in gens]

    def replay():
        for g, st in zip(gens, states):
            g.set_state(st)
        return fn()

    return torch.utils.checkpoint.checkpoint(replay, use_reentrant=False)


def loss_and_grads(model: nn.Module, params, batch, generator,
                   deterministic: bool = False, sample_generator=None,
                   remat: bool = False, mask_generator=None):
    """One forward and backward: ``(losses, total loss, grads)`` with one
    gradient (or None) per parameter in ``params``; ``sample_generator``
    goes to models whose losses draw, ``mask_generator`` to models whose
    encoder masks; ``remat`` recomputes the forward in the backward
    (:func:`rematerialized`)."""
    kw = {k: g for k, g in (("sample_generator", sample_generator),
                            ("mask_generator", mask_generator))
          if g is not None}

    def forward():
        return normalize_output(model(batch, deterministic=deterministic,
                                      generator=generator, **kw))

    losses = (rematerialized(forward, (generator, sample_generator,
                                       mask_generator))
              if remat else forward())
    loss = total_loss(losses)
    with hold_running_stats() if remat else contextlib.nullcontext():
        grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return losses, loss, grads


def split_batch(batch, k: int) -> list:
    """``batch`` cut into ``k`` equal micro-batches along its leading
    (sample) axis, in order; raises when ``k`` does not divide it."""
    n = batch.batch_size
    if k < 1 or n % k:
        raise ValueError(f"batch {n} not divisible by accum_steps {k}")
    m = n // k

    def part(v, i):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v[i * m:(i + 1) * m]
        return type(v)(*(part(getattr(v, f.name), i)
                         for f in dataclasses.fields(v)))

    return [type(batch)(**{f.name: part(getattr(batch, f.name), i)
                           for f in dataclasses.fields(batch)})
            for i in range(k)]


class Trainer:
    """Holds the model, its trainable parameters and the optimizer.

    ``train_step(batch)`` runs one forward, backward and update and
    returns the logs: every loss entry, ``loss``, ``grad_norm`` (before
    the clip) and ``lr``, as 0-d float32 tensors (``lr`` a float).
    """

    def __init__(self, model: nn.Module, cfg: dict, total_steps: int,
                 freeze_tokens: Sequence[str] = (), seed: int = 0,
                 accum_steps: int = 1, remat: bool = False):
        self.model = model
        self.named = freeze(model, freeze_tokens)
        self.params = [p for _, p in self.named]
        self.optimizer = make_optimizer(cfg, total_steps, self.params)
        self.seed = seed
        self.step = 0
        self.device = next(model.parameters()).device
        self.accum_steps = accum_steps
        self.remat = remat
        # whether an encoder draws MAE masks, fixed once the model is built
        self.masks = any(getattr(m, "masked", False) for m in model.modules())

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

    def generator(self, step: int, micro: int = 0) -> torch.Generator:
        """The drop-path generator of a step's ``micro``-th micro-batch."""
        return seeded_generator(
            self.device, (self.seed << 32) + step + micro * MICRO_STREAM)

    def sample_generator(self, step: int, micro: int = 0):
        """The losses' generator of a step's ``micro``-th micro-batch, or
        None for a model whose losses draw nothing (no ``draw``
        method)."""
        if not hasattr(self.model, "draw"):
            return None
        return seeded_generator(
            self.device,
            SAMPLE_STREAM + (self.seed << 32) + step + micro * MICRO_STREAM)

    def mask_generator(self, step: int, micro: int = 0):
        """The MAE masks' generator of a step's ``micro``-th micro-batch,
        or None for a model whose encoders draw no mask."""
        if not self.masks:
            return None
        return seeded_generator(
            self.device,
            MASK_STREAM + (self.seed << 32) + step + micro * MICRO_STREAM)

    def losses_and_grads(self, batch):
        """The step's losses, total loss and gradients: one forward and
        backward, or the mean over ``accum_steps`` micro-batches."""
        k = self.accum_steps
        micro = [batch] if k == 1 else split_batch(batch, k)
        runs = [loss_and_grads(self.model, self.params, mb,
                               self.generator(self.step, i),
                               sample_generator=self.sample_generator(
                                   self.step, i), remat=self.remat,
                               mask_generator=self.mask_generator(
                                   self.step, i))
                for i, mb in enumerate(micro)]
        if k == 1:
            return runs[0]
        inv = 1.0 / k

        def mean(xs):
            xs = [x for x in xs if x is not None]
            return sum(xs[1:], xs[0]) * inv if xs else None

        losses = {n: mean([r[0][n].float() for r in runs]) for n in runs[0][0]}
        grads = [mean(gs) for gs in zip(*(r[2] for r in runs))]
        return losses, mean([r[1] for r in runs]), grads

    def train_step(self, batch) -> dict:
        losses, loss, grads = self.losses_and_grads(batch)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            norm, lr = self.optimizer.step(grads)
        self.step += 1
        logs = {k: v.detach().float() for k, v in losses.items()}
        logs.update(loss=loss.detach(), grad_norm=norm, lr=lr)
        return logs


def build_trainer(cfg: dict, model: nn.Module, total_steps: int,
                  seed: int = 0, accum_steps: int = 1,
                  remat: bool = False) -> Trainer:
    """A :class:`Trainer` freezing the config's ``model_init.freeze``
    tokens plus its ``frozen_stages``."""
    tokens = tuple(cfg.get("model_init", {}).get("freeze", ())) + \
        frozen_stage_tokens(cfg["model"])
    return Trainer(model, cfg, total_steps, tokens, seed, accum_steps, remat)


def raise_on_nonfinite(model: nn.Module) -> list:
    """Forward hooks on every submodule of ``model`` that raise
    ``FloatingPointError`` naming the first module (in the order they
    finish) whose floating output holds a NaN or an infinity: the train
    CLI's ``--debug-nans`` (JAX ``jax_debug_nans``), with
    ``torch.autograd.detect_anomaly(check_nan=True)`` over the backward.
    Each check waits on the device.  Returns the hooks' handles."""

    def tensors(out):
        if isinstance(out, torch.Tensor):
            yield out
        elif isinstance(out, dict):
            for v in out.values():
                yield from tensors(v)
        elif isinstance(out, (list, tuple)):
            for v in out:
                yield from tensors(v)

    def hook(name):
        def check(module, args, out):
            for t in tensors(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite output of module {name!r} "
                        f"({type(module).__name__}, {tuple(t.shape)})")
        return check

    return [m.register_forward_hook(hook(n or type(model).__name__))
            for n, m in model.named_modules()]


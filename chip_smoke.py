#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device and build: requires CUDA, prints the card's name and power
   limit, builds the hand-written kernels from ``csrc/`` and prints the
   build time and the compiler's register / shared-memory report;
2. kernels: checks that the card runs the point pools' bf16 ``amax``
   scatter, then runs each kernel at its main-path shapes beside its
   plain PyTorch twin on the same inputs (relative Frobenius error <= 1e-2
   for every output; attention's logsumexp max-abs <= 1e-2) and times
   kernel, twin and one PyTorch library call with CUDA events.  Serve
   shapes are at batch 4 (B9 over the raw pools of the full-width
   synthetic cloud, whose share of -inf cells it prints), training shapes
   (the backward kernels, the residual-free epilogue, the decoders'
   head-dim-24 attention, the sampler, the fine-tune's frozen encoders
   and neck) at batch 2; B8 (``cam_gather_sum``)
   forward at batch 4 and 2 and backward at batch 2, on the indices and
   validity the interact makes of synthetic batches (it prints their
   valid share and the most points that land on one feature row), and
   once more at batch 4 with half the valid pixels also seen by a second
   camera, so that its sums have two terms;
3. serve: builds full-width ``triplane_occ`` in bf16 (seeded weights,
   layer-scale gamma drawn from U(0.1, 1) so every ConvNeXt MLP branch
   reaches the output), starts the HTTP server with batch 4, posts three
   requests of 1, 2 and 1 samples, checks each reply is an
   ``(n, 99, 99, 16)`` int8 volume equal to the argmax of the logits and
   that the kernels launched exactly 36 / 2 / 4 / 2 / 1 times per forward
   (K1 / K2 / K3 / K4 / B8), then re-runs the same batch with the plain
   twins and holds the logits to stated bounds; last it times the forward
   (ms per batch, samples/s, peak memory) and profiles one forward with
   ``torch.profiler`` (device busy share, the kernels that take most);
4. point serve: the same for full-width ``point_triplane_occ`` (BatchNorm
   running statistics drawn as well) with requests of 36864 points:
   72 K1 and 3 B9 launches per forward;
5. train: builds full-width ``triplane_range_cam`` (bf16 compute, f32
   parameters, seeded weights, gamma from U(0.1, 1)) and its trainer at
   batch 2 on synthetic batches.  One forward and backward with the
   kernels and one with ``set_kernels(model, False)``, same batch and
   drop-path generator: losses within 1e-2 relative, every parameter
   group's gradient within 5e-2 relative Frobenius error.  Then three
   optimizer steps through ``Trainer.train_step`` (the CLI's step): the
   first counts each kernel's launches and must equal ``PER_TRAIN_STEP``
   (B8 forward and backward among them); losses finite, every trainable
   parameter moved, every frozen one bit-identical.  It times steps (ms
   per step, samples/s, peak memory), profiles one, and saves the trainer
   state through ``train/checkpoint.py`` (under ``build/``);
6. fine-tune: builds full-width ``triplane_occ`` (bf16) and partial-loads
   that checkpoint (the encoder and neck must load whole, the MAE decoders
   are skipped), then at batch 2 with the encoder and neck frozen: the
   loss and the head's gradients with kernels and with twins (1e-2 /
   5e-2), three steps whose first launches the kernels as many times as
   ``finetune_launches`` derives from the model (forward only: K1-K4 and
   B8), the head moved and the frozen tensors bit-identical, CE / IoU /
   mIoU over two synthetic batches through ``train/evaluator.py``, and
   timing (ms per step, samples/s, peak memory) with a profile;
7. int8 serve: phases 3 and 4 again with ``int8=True``
   (``ops.quant.enable_int8``: B10 in every ConvNeXt block, dynamic int8
   products in the neck and the head): 36 B10 + 2 attention + 1 B8
   launches per ``triplane_occ`` forward, 72 B10 + 3 B9 per
   ``point_triplane_occ`` forward, every other kernel 0; kernels against
   twins under the same bounds; and, unbounded, the int8 logits against
   the same model's bf16 logits (the quantization's own error).

The int8 dot probe runs before phase 2 as a phase of its own: the
operands of ``tools/measure_int8.py`` through ``int8_dot`` once, held to
the integer product computed on the host (exact), then timed.  Phase 2
holds B10 to its twin at the ConvNeXt shapes of both int8 serve paths,
bit for bit (B10 rounds where its twin does).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "efficient_multimodal_perception_tpu_torch"
JAX_KERNELS = "efficient_multimodal_perception_tpu/ops/pallas_kernels.py"
B = 4                   # serve batch
B_TRAIN = 2             # train batch
REL_TOL = 1e-2          # kernel vs twin, relative Frobenius error
B10_TOL = 0.0           # B10 rounds where its twin does: bit for bit
LSE_TOL = 1e-2          # attention logsumexp, max abs
ARGMAX_AGREE_MIN = 0.97  # served logits: kernels vs plain twins
LOGIT_REL_TOL = 3e-2     # served logits: relative Frobenius error
TRAIN_LOSS_TOL = 1e-2    # train losses: kernels vs twins, relative
TRAIN_GRAD_TOL = 5e-2    # per parameter group, relative Frobenius error
PEAK_FLOPS = 989e12     # H100 SXM dense bf16
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
PER_FORWARD = {"convnext_block_fused": 36, "attention": 2,
               "ln_dense_fused": 4, "gelu_dense_fused": 2,
               "cam_gather_sum": 1}
# per point_triplane_occ forward: 18 camera blocks + 3 planes x 18
# triplane blocks, and one plane MLP per plane
PER_POINT_FORWARD = {"convnext_block_fused": 72, "finite_mlp_fused": 3}
# the same forwards with int8 on: B10 replaces K1, and the neck's int8
# products replace K3 / K4
PER_INT8_FORWARD = {"convnext_block_int8_fused": 36, "attention": 2,
                    "cam_gather_sum": 1}
PER_INT8_POINT_FORWARD = {"convnext_block_int8_fused": 72,
                          "finite_mlp_fused": 3}
# per training step of triplane_range_cam (frozen stage 0 runs K1, whose
# backward reaches lidar stage 0 only; stages 1-3 run the epilogue; the
# neck and the two decoders each run attention twice; the camera stage-1
# features that B8 gathers are trainable, so its backward runs)
PER_TRAIN_STEP = {"convnext_block_fused": 6, "epilogue_fused": 30,
                  "post_epilogue_bwd": 27, "post_epilogue_bwd_wide": 6,
                  "attention": 6, "attention_bwd": 6, "ln_dense_fused": 4,
                  "gelu_dense_fused": 2, "triplane_sample": 1,
                  "triplane_sample_bwd": 1, "cam_gather_sum": 1,
                  "cam_gather_sum_bwd": 1}
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke")  # git-ignored
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "convnext_block_fused": ("convnext_block.cu", f"{JAX_KERNELS}:519"),
    "epilogue_fused": ("convnext_block.cu", f"{JAX_KERNELS}:1423"),
    "post_epilogue_bwd": ("epilogue_bwd.cu", f"{JAX_KERNELS}:1293"),
    "post_epilogue_bwd_wide": ("epilogue_bwd.cu", f"{JAX_KERNELS}:1183"),
    "attention": ("attention.cu", f"{JAX_KERNELS}:730"),
    "attention_bwd": ("attention.cu", f"{JAX_KERNELS}:749"),
    "ln_dense_fused": ("prologue_dense.cu", f"{JAX_KERNELS}:1833"),
    "gelu_dense_fused": ("prologue_dense.cu", f"{JAX_KERNELS}:1862"),
    "triplane_sample": ("triplane_sample.cu", f"{JAX_KERNELS}:371"),
    "triplane_sample_bwd": ("triplane_sample.cu", f"{JAX_KERNELS}:152"),
    "finite_mlp_fused": ("finite_mlp.cu", f"{JAX_KERNELS}:1975"),
    "convnext_block_int8_fused": ("convnext_block_int8.cu",
                                  f"{JAX_KERNELS}:1605"),
    "int8_dot": ("convnext_block_int8.cu", "tools/measure_int8.py:46"),
    "cam_gather_sum": ("cam_gather.cu", f"{JAX_KERNELS}:269"),
    "cam_gather_sum_bwd": ("cam_gather.cu", f"{JAX_KERNELS}:291"),
}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def profile_call(torch, fn, top=15):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time summed over all kernels and copies (``busy_ms``; the idle
    share is 1 - busy / wall, and the profiler's own overhead lengthens
    wall), and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                kernels=[dict(name=name[:100], ms=t, count=n)
                         for t, n, name in kern[:top]])


def check_bf16_amax_scatter(torch):
    """The point pools scatter bf16 rows with ``scatter_reduce_("amax")``:
    on the card it must run and equal the CPU's (a max is exact)."""
    g = torch.Generator().manual_seed(3)
    src = torch.randn(5000, 128, generator=g).to(torch.bfloat16)
    ids = torch.randint(0, 300, (5000,), generator=g)[:, None].expand(-1, 128)

    def pool(dev):
        out = torch.full((300, 128), float("-inf"), dtype=torch.bfloat16,
                         device=dev)
        return out.scatter_reduce_(0, ids.to(dev), src.to(dev), "amax",
                                   include_self=False).cpu()

    if not torch.equal(pool("cuda"), pool("cpu")):
        raise AssertionError("bf16 amax scatter differs on the card")
    log("bf16 amax scatter: runs on the card, equal to the CPU's")


def bound_ms(flops, nbytes, int8_ops=0):
    """The least time for ``flops`` bf16 operations, ``int8_ops`` int8
    operations and ``nbytes`` bytes, and which of the two bounds it."""
    t_ops = flops / PEAK_FLOPS + int8_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels at main-path shapes
# ---------------------------------------------------------------------------

def kernel_cases(torch, K):
    """Every main-path shape of every kernel, one dict at a time (inputs
    are made when the case is reached): name, label, calls (per path:
    one forward of a serve path, one pretrain or fine-tune step), kernel /
    plain / library functions, flops, bytes, and how to compare the
    outputs."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def case(name, label, calls, fk, fp, fl, flops, nbytes, check=None,
             extra=None, int8_ops=0, tol=REL_TOL):
        return dict(name=name, label=label, calls=calls, fk=fk, fp=fp,
                    fl=fl, flops=flops, nbytes=nbytes, check=check,
                    extra=extra or {}, int8_ops=int8_ops, tol=tol)

    def mlp_params(C):
        """ln_s, ln_b, w1, b1, w2, b2, gamma at width C."""
        return (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
                rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
                rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
                torch.rand(C, generator=g, device=dev) * 0.9 + 0.1)

    def mlp_chain(y, s, b, w1, b1, w2, b2, gm):
        C = y.shape[-1]
        y = F.layer_norm(y, (C,), s.to(bf), b.to(bf), 1e-6)
        return F.linear(F.gelu(F.linear(y, w1, b1.to(bf))), w2,
                        b2.to(bf)) * gm.to(bf)

    depths = (3, 3, 9, 3)
    widths = (96, 192, 384, 768)
    cam_hw = [(128, 256), (64, 128), (32, 64), (16, 32)]
    lid_hw = [(32, 256), (32, 128), (32, 64), (32, 32)]
    xy_hw = [(128 >> i, 128 >> i) for i in range(4)]
    yz_hw = [(128 >> i, 80 >> i) for i in range(4)]

    # K1: every stage at serve batch 4 (the camera encoder's shapes are
    # the same on both serve paths; the point family's triplane encoder
    # runs on the xy plane and, at one shape, on yz and xz); at train
    # batch 2 stage 0 (frozen in pretraining) and, for the fine-tune's
    # frozen encoders, every stage
    k1_sites = [
        (("camera", B * 6, cam_hw), range(4), ("serve", "point_serve"), 1),
        (("lidar", B, lid_hw), range(4), ("serve",), 1),
        (("triplane xy", B, xy_hw), range(4), ("point_serve",), 1),
        (("triplane yz|xz", B, yz_hw), range(4), ("point_serve",), 2),
        (("camera", B_TRAIN * 6, cam_hw), (0,), ("train", "finetune"), 1),
        (("lidar", B_TRAIN, lid_hw), (0,), ("train", "finetune"), 1),
        (("camera", B_TRAIN * 6, cam_hw), (1, 2, 3), ("finetune",), 1),
        (("lidar", B_TRAIN, lid_hw), (1, 2, 3), ("finetune",), 1),
    ]
    for (enc, n_img, hws), stages, paths, mult in k1_sites:
        for i in stages:
            (h, w), C = hws[i], widths[i]
            args = (rn(n_img, h, w, C), rn(C, 1, 7, 7, scale=7**-1, dtype=f32),
                    rn(C, scale=0.1, dtype=f32)) + mlp_params(C)

            def library(a=args):
                x, k, kb = a[:3]
                return x + mlp_chain(K.dwconv7(x, k, kb), *a[3:])

            M = n_img * h * w
            yield case(
                "convnext_block_fused",
                f"{enc} stage{i} ({n_img},{h},{w},{C})",
                {p: mult * depths[i] for p in paths},
                lambda a=args: K.convnext_block_fused(*a),
                lambda a=args: K.convnext_block_plain(*a), library,
                16 * M * C * C + 2 * 49 * M * C,
                2 * M * C * 2 + 2 * 4 * C * C * 2 + (49 + 8 * C) * 4)

    # B10: the int8 blocks of both int8 serve paths at batch 4 (the K1
    # sites' serve shapes); the library chain is dwconv, F.layer_norm and
    # the int8 products through torch._int_mm with the row quantization
    # and dequantization in PyTorch
    from efficient_multimodal_perception_tpu_torch.ops.quant import (
        quantize_weight, sym_quant)

    def int8_chain(x, k, kb, s, b, w1, b1, w2, b2, gm):
        C = x.shape[-1]
        y = K.dwconv7(x, k, kb).reshape(-1, C)
        z = F.layer_norm(y.float(), (C,), s, b, 1e-6)
        (w1q, w1s), (w2q, w2s) = quantize_weight(w1), quantize_weight(w2)
        zq, zs = sym_quant(z, -1)
        h = F.gelu(torch._int_mm(zq, w1q.t()).float() * zs * w1s + b1)
        hq, hs = sym_quant(h, -1)
        o = torch._int_mm(hq, w2q.t()).float() * hs * w2s + b2
        return (x.float() + (o * gm).reshape(x.shape)).to(x.dtype)

    b10_sites = [
        (("camera", B * 6, cam_hw), ("int8_serve", "int8_point_serve"), 1),
        (("lidar", B, lid_hw), ("int8_serve",), 1),
        (("triplane xy", B, xy_hw), ("int8_point_serve",), 1),
        (("triplane yz|xz", B, yz_hw), ("int8_point_serve",), 2),
    ]
    for (enc, n_img, hws), paths, mult in b10_sites:
        for i in range(4):
            (h, w), C = hws[i], widths[i]
            args = (rn(n_img, h, w, C), rn(C, 1, 7, 7, scale=7**-1, dtype=f32),
                    rn(C, scale=0.1, dtype=f32)) + tuple(
                        t.float() for t in mlp_params(C))
            M = n_img * h * w
            yield case(
                "convnext_block_int8_fused",
                f"{enc} stage{i} ({n_img},{h},{w},{C})",
                {p: mult * depths[i] for p in paths},
                lambda a=args: K.convnext_block_int8_fused(*a),
                lambda a=args: K.convnext_block_int8_plain(*a),
                lambda a=args: int8_chain(*a),
                2 * 49 * M * C,
                2 * M * C * 2 + 2 * 4 * C * C * 4 + 58 * C * 4,
                int8_ops=16 * M * C * C, tol=B10_TOL)

    # B5: epilogue forward and backward, stages 1-3 at train batch 2
    # (backward also at lidar stage 0, through K1's backward)
    for enc, n_img, hws in (("camera", B_TRAIN * 6, cam_hw),
                            ("lidar", B_TRAIN, lid_hw)):
        for i in range(4):
            (h, w), C = hws[i], widths[i]
            if i == 0 and enc == "camera":
                continue  # frozen and no gradient reaches it
            M = n_img * h * w
            y = rn(M, C)
            prm = mlp_params(C)
            shape = f"{enc} stage{i} ({M},{C})"
            if i > 0:
                yield case(
                    "epilogue_fused", shape, {"train": depths[i]},
                    lambda y=y, p=prm: K.epilogue_fused(y, *p),
                    lambda y=y, p=prm: K.epilogue_plain(y, *p),
                    lambda y=y, p=prm: mlp_chain(y, *p),
                    16 * M * C * C, 2 * M * C * 2 + 8 * C * C * 2 + 8 * C * 4)
            gy = rn(M, C, scale=0.05)
            name = "post_epilogue_bwd" if C <= 384 else "post_epilogue_bwd_wide"
            fk = K.post_epilogue_bwd if C <= 384 else K.post_epilogue_bwd_wide
            lib_in = leaves(y, *prm)

            def lib_bwd(li=lib_in, gy=gy):
                return torch.autograd.grad(mlp_chain(*li), li, gy)

            yield case(
                name, shape, {"train": depths[i]},
                lambda y=y, gy=gy, p=prm, fk=fk: fk(y, gy, *p),
                lambda y=y, gy=gy, p=prm: K.post_epilogue_bwd_plain(y, gy, *p),
                lib_bwd, 48 * M * C * C,
                3 * M * C * 2 + 8 * C * C * 2 + 8 * C * C * 4 + 16 * C * 4,
                "tuple")

    # K2 / B6: the neck (hd 256; the int8 neck runs K2 at the same shape,
    # the fine-tune's frozen neck at train batch 2, forward only) and the
    # decoders' sr=4 attention (hd 24)
    att = [(("serve", "int8_serve"), "neck", 4 * B, 4096, 4096, 256),
           (("train", "finetune"), "neck", 4 * B_TRAIN, 4096, 4096, 256)] + [
        (("train",), label, G, nq, nk, hd) for label, G, nq, nk, hd in (
            ("camera decoder", 4 * 6 * B_TRAIN, 8192, 512, 24),
            ("lidar decoder", 4 * B_TRAIN, 8192, 512, 24))]
    for paths, label, G, nq, nk, hd in att:
        q, k, v = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd)
        sc = hd**-0.5
        shape = f"{label} ({G},{nq},{nk},{hd})"
        yield case(
            "attention", shape, {p: 2 for p in paths},
            lambda q=q, k=k, v=v, sc=sc: K.attention(q, k, v, sc),
            lambda q=q, k=k, v=v, sc=sc: K.attention_plain(q, k, v, sc),
            lambda q=q, k=k, v=v, sc=sc: F.scaled_dot_product_attention(
                q, k, v, scale=sc),
            4 * G * nq * nk * hd, (2 * G * nq * hd + 2 * G * nk * hd) * 2
            + G * nq * 4, "lse")
        if "train" not in paths:
            continue
        out, lse = K.attention(q, k, v, sc)
        do = rn(G, nq, hd)
        lq = leaves(q, k, v)

        def lib_att(lq=lq, do=do, sc=sc):
            return torch.autograd.grad(
                F.scaled_dot_product_attention(*lq, scale=sc), lq, do)

        yield case(
            "attention_bwd", shape, {"train": 2},
            lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd(*a),
            lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd_plain(*a),
            lib_att, 10 * G * nq * nk * hd,
            (3 * G * nq * hd + 3 * G * nk * hd + 2 * G * nq * hd) * 2
            + G * nq * 4, "tuple")

    # K3 / K4: the neck's prologues, serve batch 4 and train batch 2
    C = 1024
    for paths, bsz in ((("serve",), B), (("train", "finetune"), B_TRAIN)):
        M = bsz * 4096
        x = rn(M, C)
        s_, b_ = 1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32)
        for label, N_out, has_bias in (("norm1->q|kv", 3 * C, False),
                                       ("norm2->fc1", 2 * C, True)):
            w = rn(N_out, C, scale=C**-0.5)
            bias = rn(N_out, scale=0.1, dtype=f32) if has_bias else None
            a = (x, s_, b_, w, bias)

            def library(a=a):
                x, s_, b_, w, bias = a
                y = F.layer_norm(x, (C,), s_.to(bf), b_.to(bf), 1e-6)
                return F.linear(y, w, None if bias is None else bias.to(bf))

            yield case(
                "ln_dense_fused", f"{label} ({M},{C})->({M},{N_out})",
                {p: 2 for p in paths}, lambda a=a: K.ln_dense_fused(*a),
                lambda a=a: K.ln_dense_plain(*a), library,
                2 * M * C * N_out,
                M * C * 2 + N_out * C * 2 + M * N_out * 2 + 2 * C * 4
                + (N_out * 4 if has_bias else 0))
        xh = rn(M, 2 * C)
        w2 = rn(C, 2 * C, scale=(2 * C)**-0.5)
        b2 = rn(C, scale=0.1, dtype=f32)
        a = (xh, w2, b2)
        yield case(
            "gelu_dense_fused", f"({M},{2 * C})->({M},{C})",
            {p: 2 for p in paths},
            lambda a=a: K.gelu_dense_fused(*a),
            lambda a=a: K.gelu_dense_plain(*a),
            lambda a=a: F.linear(F.gelu(a[0]), a[1], a[2].to(bf)),
            2 * M * 2 * C * C,
            M * 2 * C * 2 + 2 * C * C * 2 + M * C * 2 + C * 4)

    # B7: the triplane sampled at the 32 x 1024 range points, batch 2
    S, Cp, P = 128, 32, 32 * 1024
    tri = rn(B_TRAIN, 3, S, S, Cp)
    coords = (torch.rand(B_TRAIN, P, 3, generator=g, device=dev) * 2.2
              - 1.1).contiguous()
    grids = [coords[:, None, :, list(ax)].to(bf).contiguous()
             for ax in ((0, 1), (1, 2), (0, 2))]

    def grid_chain(t):
        return sum(F.grid_sample(t[:, i].permute(0, 3, 1, 2), grids[i],
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=False) for i in range(3))

    plane_bytes = B_TRAIN * 3 * S * S * Cp
    yield case(
        "triplane_sample", f"({B_TRAIN},3,{S},{S},{Cp}) at {P} points",
        {"train": 1}, lambda: K.triplane_sample(tri, coords),
        lambda: K.triplane_sample_plain(tri, coords),
        lambda: grid_chain(tri), 2 * 12 * B_TRAIN * P * Cp,
        B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes * 2)
    gs = rn(B_TRAIN, P, Cp)
    (lt,) = leaves(tri)
    gs_nchw = gs.permute(0, 2, 1)[:, :, None]
    yield case(
        "triplane_sample_bwd", f"({B_TRAIN},3,{S},{S},{Cp}) at {P} points",
        {"train": 1}, lambda: K.triplane_sample_bwd(coords, gs, S),
        lambda: K.triplane_sample_bwd_plain(coords, gs, S),
        lambda: torch.autograd.grad(grid_chain(lt), lt, gs_nchw),
        2 * 12 * B_TRAIN * P * Cp,
        B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes * 4)

    # B8: the interact's gather-sum at serve batch 4 (bf16 and int8 serve)
    # and train batch 2 (pretrain forward and backward, fine-tune forward),
    # on the indices and validity that the interact makes of a synthetic
    # batch, so the valid share and the collisions are the path's own.
    # The library chains are the plain path's bf16 gather, mask and sum,
    # and index_add_ into float32 then a cast.
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.core.geometry import (
        crop_to_range)
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_arrays, synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.joint_encoder import (
        project_to_features)

    ocfg = get_config("triplane_occ")
    (h1, w1), C8 = cam_hw[1], widths[1]
    Kf = h1 * w1
    for bsz, fwd_calls, bwd_calls in (
            (B, {"serve": 1, "int8_serve": 1}, None),
            (B_TRAIN, {"train": 1, "finetune": 1}, {"train": 1})):
        batch = synthetic_batch(bsz, point_budget=ocfg["data"]["point_budget"],
                                seed=0, device=dev)
        m = crop_to_range(batch.range_points,
                          ocfg["model"]["triplane_range"])[..., None]
        _, _, active, idx = project_to_features(
            batch.range_image * m, batch.range_points * m, batch.lidar2img,
            batch.cam_aug, ocfg["data"]["image_size"], (h1, w1))
        Ng, P = idx.shape[1:]
        valid = active.to(torch.uint8)
        rows = (torch.arange(bsz * Ng, device=dev).reshape(bsz, Ng, 1) * Kf
                + idx.long())[active]
        hits = torch.bincount(rows, minlength=bsz * Ng * Kf)
        n_valid, n_rows = int(active.sum()), int((hits > 0).sum())
        extra = dict(valid_share=n_valid / active.numel(),
                     pixels_seen_by_a_camera=float(
                         active.any(1).float().mean()),
                     max_points_per_feature_row=int(hits.max()),
                     feature_rows_hit=n_rows)
        log(f"B8 inputs at batch {bsz}: " + json.dumps(extra))
        feats = rn(bsz, Ng, Kf, C8)
        gidx = idx.long()[..., None].expand(bsz, Ng, P, C8)
        shape = f"({bsz},{Ng},{Kf},{C8}) at {P} pixels"
        meta = bsz * Ng * P * 5  # int32 idx + uint8 valid
        yield case(
            "cam_gather_sum", shape, fwd_calls,
            lambda f=feats, i=idx, v=valid: K.cam_gather_sum(f, i, v),
            lambda f=feats, i=idx, v=valid: K.cam_gather_sum_plain(f, i, v),
            lambda f=feats, gi=gidx, v=valid: (torch.gather(f, 2, gi)
                                               * v[..., None].to(bf)).sum(1),
            n_valid * C8, meta + n_rows * C8 * 2 + bsz * P * C8 * 4,
            extra=extra)
        if bwd_calls is None:
            # The rig's cameras do not overlap, so every sum above has one
            # term.  Here half the valid pixels (drawn from a seed) are
            # also seen by the next camera at the same feature index:
            # same K, C and P, sums of two terms.  Not on a path.
            gd = torch.Generator(device=dev).manual_seed(1)
            half = active & (torch.rand(active.shape, generator=gd,
                                        device=dev) < 0.5)
            dup = half.roll(1, dims=1) & ~active
            act2 = active | dup
            idx2 = torch.where(dup, idx.roll(1, dims=1), idx)
            rows2 = (torch.arange(bsz * Ng, device=dev).reshape(bsz, Ng, 1)
                     * Kf + idx2.long())[act2]
            n_rows2 = int(torch.unique(rows2).numel())
            seen2 = act2.any(1)
            extra2 = dict(duplicated_share=int(dup.sum()) / n_valid,
                          two_camera_share_of_seen=float(
                              (act2.sum(1) >= 2).sum() / seen2.sum()),
                          feature_rows_hit=n_rows2)
            log(f"B8 overlap inputs at batch {bsz}: " + json.dumps(extra2))
            v2 = act2.to(torch.uint8)
            gidx2 = idx2.long()[..., None].expand(bsz, Ng, P, C8)
            yield case(
                "cam_gather_sum", shape + ", half the valid pixels seen by "
                "two cameras", {},
                lambda f=feats, i=idx2, v=v2: K.cam_gather_sum(f, i, v),
                lambda f=feats, i=idx2, v=v2: K.cam_gather_sum_plain(f, i, v),
                lambda f=feats, gi=gidx2, v=v2: (
                    torch.gather(f, 2, gi) * v[..., None].to(bf)).sum(1),
                int(act2.sum()) * C8,
                meta + n_rows2 * C8 * 2 + bsz * P * C8 * 4, extra=extra2)
            del batch, hits
            continue
        gr = rn(bsz, P, C8, dtype=f32)
        src = gr.to(bf).float()[:, None].expand(bsz, Ng, P, C8)[active]

        def lib_bwd(rows=rows, src=src, n=bsz * Ng * Kf):
            out = torch.zeros((n, C8), dtype=f32, device=dev)
            return out.index_add_(0, rows, src).to(bf)

        yield case(
            "cam_gather_sum_bwd", shape, bwd_calls,
            lambda g_=gr, i=idx, v=valid: K.cam_gather_sum_bwd(g_, i, v, Kf),
            lambda g_=gr, i=idx, v=valid: K.cam_gather_sum_bwd_plain(
                g_, i, v, Kf),
            lib_bwd, n_valid * C8,
            # g: only the rows of pixels that some camera sees are read
            meta + int(active.any(1).sum()) * C8 * 4
            + bsz * Ng * Kf * C8 * 2, extra=extra)
        del batch, hits

    # B9: the three plane MLPs at serve batch 4 over raw pools of the
    # full-width synthetic cloud (random point features pooled at the
    # cloud's own voxel indices, so the share of -inf cells is the path's)
    from efficient_multimodal_perception_tpu_torch.models.point_family import (
        voxelize_points)
    from efficient_multimodal_perception_tpu_torch.ops.scatter import (
        point_plane_pools_batch)

    mcfg = get_config("point_triplane_occ")["model"]
    pcfg = mcfg["point_triplane_projector"]
    cloud = synthetic_arrays(B, point_budget=36864, seed=1)
    idx, valid = voxelize_points(
        torch.from_numpy(cloud["points"]).to(dev),
        torch.from_numpy(cloud["points_valid"]).to(dev),
        mcfg["triplane_range"], mcfg["triplane_voxel_size"])
    N9 = pcfg["out_channels"]
    pools = point_plane_pools_batch(rn(*valid.shape, N9), idx, valid,
                                    pcfg["grid_size"], pcfg["split"], raw=True)
    X, Y, Z = pcfg["grid_size"]
    for label, t, (h, w) in zip(("xy", "yz", "xz"), pools,
                                ((X, Y), (Y, Z), (X, Z))):
        x = t.reshape(B * h * w, -1)
        M, K9 = x.shape
        neg = x == float("-inf")
        extra = dict(neg_inf_share=float(neg.float().mean()),
                     empty_row_share=float(neg.all(-1).float().mean()))
        del neg
        a9 = (x, rn(N9, K9, scale=K9**-0.5), rn(N9, scale=0.1, dtype=f32),
              rn(N9, N9, scale=N9**-0.5), rn(N9, scale=0.1, dtype=f32))

        def library(a=a9):
            x, w1, b1, w2, b2 = a
            z = torch.where(x == float("-inf"), torch.zeros((), dtype=bf,
                                                            device=dev), x)
            return F.linear(torch.relu(F.linear(z, w1, b1.to(bf))), w2,
                            b2.to(bf))

        yield case(
            "finite_mlp_fused", f"{label} ({M},{K9})", {"point_serve": 1},
            lambda a=a9: K.finite_mlp_fused(*a),
            lambda a=a9: K.finite_mlp_plain(*a), library,
            2 * M * K9 * N9 + 2 * M * N9 * N9,
            M * K9 * 2 + N9 * K9 * 2 + N9 * N9 * 2 + M * N9 * 2 + 2 * N9 * 4,
            extra=extra)
    del pools


def compare(torch, got, want, check):
    """(worst relative error, worst max-abs error, lse max-abs or None,
    all finite) over the outputs."""
    lse_err = None
    if check == "lse":
        (got, lse_g), (want, lse_w) = got, want
        lse_err = float((lse_g - lse_w).abs().max())
    pairs = list(zip(got, want)) if check == "tuple" else [(got, want)]
    rel = max(rel_err(torch, a, b) for a, b in pairs)
    mab = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    finite = all(bool(torch.isfinite(a.float()).all()) for a, _ in pairs)
    return rel, mab, lse_err, finite


def run_kernels(torch, K):
    per = {}
    for c in kernel_cases(torch, K):
        name, label = c["name"], c["label"]
        got, want = c["fk"](), c["fp"]()
        torch.cuda.synchronize()
        err, max_abs, lse_err, finite = compare(torch, got, want, c["check"])
        del got, want
        ms = time_ms(torch, c["fk"], 10)
        plain_ms = time_ms(torch, c["fp"], 3, warmup=1)
        lib_ms = time_ms(torch, c["fl"], 10)
        b_ms, b_by = bound_ms(c["flops"], c["nbytes"], c["int8_ops"])
        row = dict(shape=label, calls=c["calls"], ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, rel_err=err, max_abs_err=max_abs,
                   tol=c["tol"], **c["extra"])
        if lse_err is not None:
            row["lse_max_abs_err"] = lse_err
        log(f"kernel {name} {label}: " + json.dumps(row))
        if not finite:
            raise AssertionError(f"{name} {label}: non-finite output")
        if err > c["tol"]:
            raise AssertionError(f"{name} {label}: rel err {err} > {c['tol']}")
        if lse_err is not None and lse_err > LSE_TOL:
            raise AssertionError(f"{name} {label}: lse err {lse_err}")
        per.setdefault(name, []).append(row)
        del c
        torch.cuda.empty_cache()
    return per


def run_probe(torch, K):
    """The int8 dot probe: ``tools/measure_int8.py``'s operands through
    ``int8_dot`` once (the phase's launches), held to the integer product
    computed on the host, exactly; then timed beside its twin and
    ``torch._int_mm``.  Returns ``(launches, kernel row)``."""
    x = (np.arange(256 * 128).reshape(256, 128) % 13 - 6).astype(np.int8)
    w = (np.arange(128 * 256).reshape(128, 256) % 7 - 3).astype(np.int8)
    want = x.astype(np.int64) @ w.astype(np.int64)
    x8 = torch.from_numpy(x).cuda()
    wt8 = torch.from_numpy(np.ascontiguousarray(w.T)).cuda()  # (N, K)
    torch.cuda.synchronize()
    K.reset_launches()
    got = K.int8_dot(x8, wt8)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    res = got.cpu().numpy()
    exact = res.dtype == np.int32 and np.array_equal(res, want)
    twin_exact = np.array_equal(K.int8_dot_plain(x8, wt8).cpu().numpy(),
                                want)
    log("int8 probe: " + json.dumps(dict(
        int8_dot="ok" if exact else "WRONG RESULT", twin_exact=twin_exact,
        shape=list(res.shape), dtype=str(res.dtype), checksum=int(res.sum()),
        first_row=res[0, :8].tolist(), max_abs_diff=int(
            np.abs(res.astype(np.int64) - want).max()))))
    if not exact or not twin_exact:
        raise AssertionError("int8 probe: the product is not exact")
    ops, nbytes = 2 * 256 * 128 * 256, 2 * 256 * 128 + 256 * 256 * 4
    b_ms, b_by = bound_ms(0, nbytes, ops)
    row = dict(shape="(256,128) x (128,256)", calls={"int8_probe": 1},
               ms=time_ms(torch, lambda: K.int8_dot(x8, wt8), 20),
               plain_ms=time_ms(torch, lambda: K.int8_dot_plain(x8, wt8), 20),
               library_ms=time_ms(torch, lambda: torch._int_mm(x8, wt8.t()),
                                  20),
               bound_ms=b_ms, bound_by=b_by, rel_err=0.0, max_abs_err=0.0,
               tol=0.0)
    log("kernel int8_dot: " + json.dumps(row))
    return launches, row


def kernel_record(per, launches):
    out = []
    for name, rows in per.items():
        n = lambda r: sum(r["calls"].values())  # noqa: E731
        tot = lambda k: sum(r[k] * n(r) for r in rows)  # noqa: E731
        by_ops = sum(n(r) * r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        src, replaces = SOURCES[name]
        out.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{src}",
            replaces=replaces,
            launches=sum(n.get(name, 0) for n in launches.values()),
            launches_by_path={p: n.get(name, 0) for p, n in launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by="operations" if by_ops >= tot("bound_ms") / 2
            else "bytes",
            library_ms=tot("library_ms"),
            max_err=max(r["rel_err"] for r in rows),
            tol=max(r["tol"] for r in rows),
            per=f"one forward of each serve path (bf16 and int8) at batch "
                f"{B}, one pretrain and one fine-tune step at batch "
                f"{B_TRAIN} and the probe, summed over the kernel's calls",
            shapes=rows,
        ))
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: serve
# ---------------------------------------------------------------------------

def post(url, arrs):
    """POST ``arrs`` as npz; the reply's ``pred``."""
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return z["pred"]


def seeded_serving_model(torch, cfg_name, int8=False):
    """Full-width ``cfg_name`` in bf16 (with ``int8``, its int8 serving
    form) from seed 0, layer-scale gamma drawn
    from U(0.1, 1) so every ConvNeXt MLP branch reaches the output, and
    BatchNorm running statistics (the point family's) drawn as
    ``tests/test_full_parity.py`` draws them: means from N(0, 0.5),
    variances from U(0.5, 2)."""
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock)
    from efficient_multimodal_perception_tpu_torch.serve import make_model

    model, _ = make_model(cfg_name, dtype=torch.bfloat16, device="cuda",
                          seed=0, int8=int8)
    g = torch.Generator().manual_seed(1)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=g) * 0.9
                              + 0.1)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.randn(
                    m.running_mean.shape, generator=gen) * 0.5)
                m.running_var.copy_(torch.rand(
                    m.running_var.shape, generator=gen) * 1.5 + 0.5)
    return model


def set_int8(model, on: bool) -> None:
    """Switch every int8-capable module of ``model`` to int8 or back."""
    for m in model.modules():
        if hasattr(m, "int8"):
            m.int8 = on


def run_serve(torch, K, cfg_name, per_forward, point_budget, int8=False):
    """Serve full-width ``cfg_name`` (``int8``: its int8 serving form)
    over HTTP at batch ``B``: three requests of 1, 2 and 1 samples
    (``point_budget`` points each), replies checked against the logits,
    launches per forward against ``per_forward``, kernels against their
    twins (with ``int8``, also the int8 logits against the bf16 logits of
    the same weights, unbounded), then timing and a profile of one
    forward.  Returns the launches of the requests' forwards."""
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch, synthetic_arrays)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        set_kernels)
    from efficient_multimodal_perception_tpu_torch.serve import (
        batch_keys, build_infer_fn, make_server)

    t0 = time.perf_counter()
    model = seeded_serving_model(torch, cfg_name, int8)
    server, worker = make_server(cfg_name, model=model, port=0,
                                 batch_size=B, coalesce_ms=2000.0,
                                 device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    name = f"{cfg_name} int8" if int8 else cfg_name
    log(f"{name}: model + server up in {time.perf_counter() - t0:.1f} s")
    try:
        keys = batch_keys(model)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        health = json.loads(urllib.request.urlopen(url + "/healthz",
                                                   timeout=60).read())
        if health["model"] != type(model).__name__:
            raise AssertionError(f"healthz reports {health}")
        reqs = []
        for seed, n in ((1, 1), (2, 2), (3, 1)):
            a = synthetic_arrays(n, point_budget=point_budget, seed=seed)
            reqs.append({k: a[k] for k in keys})
        results = [None] * len(reqs)
        errors = []

        def client(i):
            try:
                results[i] = post(url + "/predict", reqs[i])
            except Exception as e:  # reported below; the run fails
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        b0 = worker.n_batches
        torch.cuda.synchronize()
        K.reset_launches()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        t1 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        forwards = worker.n_batches - b0
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"{name}: requests failed: {errors}")
        for r, req in zip(results, reqs):
            n = len(req["img"])
            if r.shape != (n, 99, 99, 16) or r.dtype != np.int8:
                raise AssertionError(f"reply {r.shape} {r.dtype}, "
                                     f"expected ({n}, 99, 99, 16) int8")
        want = {k: per_forward.get(k, 0) * forwards for k in K.LAUNCHES}
        log(f"{name}: 3 requests in {forwards} forward(s), {wall:.3f} s; "
            f"launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")

        # the same samples once more: kernels vs plain twins on the card
        packed = {k: np.concatenate([r[k] for r in reqs]) for k in keys}
        batch = arrays_to_batch(packed, "cuda")
        with torch.inference_mode():
            lk = model(batch)[0].float()
            set_kernels(model, False)
            lp = model(batch)[0].float()
            set_kernels(model, True)
        served = np.concatenate(results)
        same = float((lk.argmax(-1).to(torch.int8).cpu().numpy()
                      == served).mean())
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        err = rel_err(torch, lk, lp)
        max_abs = float((lk - lp).abs().max())
        finite = bool(torch.isfinite(lk).all())
        log(f"{name} check: " + json.dumps(dict(
            served_equals_argmax=same, argmax_agreement=agree,
            logit_rel_err=err, logit_max_abs_err=max_abs,
            logit_max_abs=float(lp.abs().max()), finite=finite,
            bounds=dict(argmax_agreement_min=ARGMAX_AGREE_MIN,
                        logit_rel_err_max=LOGIT_REL_TOL))))
        if not finite or same != 1.0:
            raise AssertionError(f"{name}: served volumes do not match the "
                                 "logits")
        if agree < ARGMAX_AGREE_MIN or err > LOGIT_REL_TOL:
            raise AssertionError(f"{name}: kernels vs twins: agreement "
                                 f"{agree}, rel err {err}")
        if int8:
            with torch.inference_mode():
                set_int8(model, False)
                lb = model(batch)[0].float()
                set_int8(model, True)
            log(f"{name} vs bf16 (quantization error, unbounded): "
                + json.dumps(dict(
                    argmax_agreement=float((lk.argmax(-1) == lb.argmax(-1))
                                           .float().mean()),
                    logit_rel_err=rel_err(torch, lk, lb))))
            del lb
        del lk, lp

        # steady state through the worker's function: full batches of 4
        infer = build_infer_fn(model)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: infer(batch), 5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        log(f"{name} timing: " + json.dumps(dict(
            ms_per_batch=ms, batch=B, samples_per_s=B / ms * 1e3,
            peak_memory_gb=peak / 1e9)))
        log(f"{name} profile: " + json.dumps(
            profile_call(torch, lambda: infer(batch))))
        return launches
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()


# ---------------------------------------------------------------------------
# phase 5: train
# ---------------------------------------------------------------------------

def grad_groups(named):
    """Parameter group of a parameter name: its top-level module and, in
    the encoders, its stage (or the position encoder)."""
    def group(n):
        parts = n.split(".")
        if parts[0] == "encoder" and parts[2] in ("stages",
                                                  "downsample_layers"):
            return f"{parts[1]}.stage{parts[3]}"
        return ".".join(parts[:2]) if parts[0] == "encoder" else parts[0]
    out = {}
    for i, (n, _) in enumerate(named):
        out.setdefault(group(n), []).append(i)
    return out


def run_train(torch, K):
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model, set_kernels)
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer, loss_and_grads)

    t0 = time.perf_counter()
    cfg = get_config("triplane_range_cam")
    model = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16,
                        seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=g) * 0.9
                              + 0.1)
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    batch = synthetic_batch(B_TRAIN, point_budget=cfg["data"]["point_budget"],
                            seed=0, device="cuda")
    log(f"train: model, trainer and batch up in "
        f"{time.perf_counter() - t0:.1f} s; {len(named)} trainable and "
        f"{len(frozen)} frozen parameter tensors")

    # kernels vs twins: same batch, same drop-path generator
    losses_k, loss_k, grads_k = loss_and_grads(
        model, trainer.params, batch, trainer.generator(0))
    set_kernels(model, False)
    losses_p, loss_p, grads_p = loss_and_grads(
        model, trainer.params, batch, trainer.generator(0))
    set_kernels(model, True)
    torch.cuda.synchronize()
    loss_err = {k: abs(float(losses_k[k]) - float(losses_p[k]))
                / abs(float(losses_p[k])) for k in losses_p}
    group_err, group_norm = {}, {}
    for grp, idx in grad_groups(named).items():
        a = torch.cat([grads_k[i].float().flatten() for i in idx])
        b = torch.cat([grads_p[i].float().flatten() for i in idx])
        group_err[grp] = rel_err(torch, a, b)
        group_norm[grp] = float(a.norm())
    norms = sorted(((float(gr.float().norm()), n) for (n, _), gr
                    in zip(named, grads_k)), reverse=True)
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads_k)
    log("train check: " + json.dumps(dict(
        losses_kernels={k: float(v) for k, v in losses_k.items()},
        losses_twins={k: float(v) for k, v in losses_p.items()},
        loss_rel_err=loss_err, grad_rel_err=group_err, grads_finite=finite,
        bounds=dict(loss_rel_err_max=TRAIN_LOSS_TOL,
                    grad_rel_err_max=TRAIN_GRAD_TOL))))
    log("train grad norms at init: " + json.dumps(dict(
        by_group=group_norm, largest_params=dict(
            (n, v) for v, n in norms[:6]))))
    if not finite or not all(math.isfinite(float(v))
                             for v in losses_k.values()):
        raise AssertionError("train: non-finite losses or gradients")
    if max(loss_err.values()) > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: loss error {loss_err}")
    bad = {k: v for k, v in group_err.items() if v > TRAIN_GRAD_TOL}
    if bad:
        raise AssertionError(f"train: gradient error over bound: {bad}")
    del grads_k, grads_p

    # three optimizer steps through the CLI's step function
    before = {n: p.detach().clone() for n, p in named}
    steps = []
    torch.cuda.synchronize()
    K.reset_launches()
    steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {k: PER_TRAIN_STEP.get(k, 0) for k in K.LAUNCHES}
    log(f"train: launches in one step {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    for _ in range(2):
        steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    logs = [{k: float(v) for k, v in s.items()} for s in steps]
    log("train steps: " + json.dumps(logs))
    if not all(math.isfinite(v) for s in logs for v in s.values()):
        raise AssertionError("train: non-finite step logs")
    still = [n for n, p in named if torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    log(f"train: {len(named) - len(still)}/{len(named)} trainable tensors "
        f"moved; {len(changed)} of {len(frozen)} frozen tensors changed")
    if still or changed:
        raise AssertionError(f"train: unmoved {still[:5]}, changed frozen "
                             f"{changed[:5]}")

    # timing, peak memory, profile
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: trainer.train_step(batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log("train timing: " + json.dumps(dict(
        ms_per_step=ms, batch=B_TRAIN, samples_per_s=B_TRAIN / ms * 1e3,
        peak_memory_gb=peak / 1e9)))
    log("train profile: " + json.dumps(
        profile_call(torch, lambda: trainer.train_step(batch))))

    # the pretrain checkpoint the fine-tune phase starts from
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        save_checkpoint)

    t0 = time.perf_counter()
    path = save_checkpoint(CKPT_DIR, trainer.step, trainer.state_dict())
    log(f"train: saved {path} ({os.path.getsize(path) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, path


# ---------------------------------------------------------------------------
# phase 6: fine-tune
# ---------------------------------------------------------------------------

def finetune_launches(model):
    """Kernel launches of one ``triplane_occ`` fine-tune step, derived from
    the model: the frozen encoder and neck run forward only (deterministic
    under ``no_grad``), so every ConvNeXt block is one K1, every MiT block
    of the neck one attention, two LN prologues (norm1 -> q|kv, norm2 ->
    fc1) and one GELU prologue (-> fc2), the interact one B8 forward; the
    head's backward launches no kernel."""
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock)
    from efficient_multimodal_perception_tpu_torch.models.joint_encoder import (
        JointEncoder)
    from efficient_multimodal_perception_tpu_torch.models.mit import MiTBlock

    def count(part, cls):
        return sum(isinstance(m, cls) for m in part.modules())

    blocks = count(model.neck, MiTBlock)
    return {"convnext_block_fused": count(model.encoder, ConvNeXtBlock),
            "attention": blocks, "ln_dense_fused": 2 * blocks,
            "gelu_dense_fused": blocks,
            "cam_gather_sum": count(model.encoder, JointEncoder)}


def run_finetune(torch, K, pretrain_path):
    """Full-width ``triplane_occ`` partial-loaded from the train phase's
    checkpoint, fine-tuned at batch ``B_TRAIN`` with the encoder and neck
    frozen: kernels vs twins on the loss and the head's gradients, launch
    counts of one step, three steps (head moved, frozen tensors
    bit-identical), evaluation of two synthetic batches, timing."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model, set_kernels)
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        partial_load, restore_params_only)
    from efficient_multimodal_perception_tpu_torch.train.evaluator import (
        evaluate, make_val_batches)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer, loss_and_grads)

    t0 = time.perf_counter()
    cfg = get_config("triplane_occ")
    model = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16,
                        seed=0)
    src = restore_params_only(pretrain_path)
    merged, n_ok, n_all = partial_load(model.state_dict(), src)
    model.load_state_dict(merged)
    os.remove(pretrain_path)
    frozen_names = [k for k in merged if k.split(".")[0] in ("encoder",
                                                             "neck")]
    skipped = sorted({k.split(".")[0] for k in src} - set(
        k.split(".")[0] for k in merged))
    log(f"finetune: partial restore adopted {n_ok}/{n_all} tensors "
        f"(encoder + neck {len(frozen_names)}; not in the occ model: "
        f"{skipped})")
    whole = all(torch.equal(merged[k].cpu(), src[k]) for k in frozen_names)
    if n_ok != len(frozen_names) or not whole or skipped != [
            "camera_decoder", "lidar_decoder"]:
        raise AssertionError("finetune: the encoder and neck did not load "
                             "whole, or the MAE decoders were not skipped")
    del src, merged
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    if sorted(frozen) != sorted(frozen_names) or len(named) != n_all - n_ok:
        raise AssertionError("finetune: trainable tensors are not the head")
    batch = synthetic_batch(B_TRAIN, point_budget=cfg["data"]["point_budget"],
                            with_occ=True, seed=0, device="cuda")
    log(f"finetune: model, trainer and batch up in "
        f"{time.perf_counter() - t0:.1f} s; {len(named)} trainable and "
        f"{len(frozen)} frozen parameter tensors")

    # kernels vs twins: same batch
    _, loss_k, grads_k = loss_and_grads(model, trainer.params, batch,
                                        trainer.generator(0))
    set_kernels(model, False)
    _, loss_p, grads_p = loss_and_grads(model, trainer.params, batch,
                                        trainer.generator(0))
    set_kernels(model, True)
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_err = {n: rel_err(torch, a, b)
                for (n, _), a, b in zip(named, grads_k, grads_p)}
    finite = math.isfinite(float(loss_k)) and all(
        bool(torch.isfinite(g).all()) for g in grads_k)
    log("finetune check: " + json.dumps(dict(
        loss_kernels=float(loss_k), loss_twins=float(loss_p),
        loss_rel_err=loss_err, grad_rel_err=grad_err, finite=finite,
        bounds=dict(loss_rel_err_max=TRAIN_LOSS_TOL,
                    grad_rel_err_max=TRAIN_GRAD_TOL))))
    if not finite:
        raise AssertionError("finetune: non-finite loss or gradients")
    if loss_err > TRAIN_LOSS_TOL or max(grad_err.values()) > TRAIN_GRAD_TOL:
        raise AssertionError(f"finetune: kernels vs twins {loss_err}, "
                             f"{grad_err}")
    del grads_k, grads_p

    # three optimizer steps; the first counts launches
    per_step = finetune_launches(model)
    before = {n: p.detach().clone() for n, p in named}
    steps = []
    torch.cuda.synchronize()
    K.reset_launches()
    steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {k: per_step.get(k, 0) for k in K.LAUNCHES}
    log(f"finetune: launches in one step {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"finetune launch counts {launches} != {want}")
    for _ in range(2):
        steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    logs = [{k: float(v) for k, v in st.items()} for st in steps]
    log("finetune steps: " + json.dumps(logs))
    if not all(math.isfinite(v) for st in logs for v in st.values()):
        raise AssertionError("finetune: non-finite step logs")
    still = [n for n, p in named if torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    log(f"finetune: {len(named) - len(still)}/{len(named)} head tensors "
        f"moved; {len(changed)} of {len(frozen)} frozen tensors changed")
    if still or changed:
        raise AssertionError(f"finetune: unmoved {still}, changed frozen "
                             f"{changed[:5]}")

    # evaluation of two synthetic validation batches
    t1 = time.perf_counter()
    metrics = evaluate(model, make_val_batches(cfg["data"], B_TRAIN, 2,
                                               device="cuda")(),
                       cfg["model"]["type"],
                       cfg["model"]["decoder"]["num_classes"],
                       cfg["model"].get("class_names") or ())
    log(f"finetune eval ({2 * B_TRAIN} samples, "
        f"{time.perf_counter() - t1:.1f} s): CE {metrics['ce']:.4f}, "
        f"IoU {metrics['iou']:.4f}, mIoU {metrics['miou']:.4f}; "
        + json.dumps(metrics))
    if not all(math.isfinite(metrics[k]) for k in ("ce", "iou", "miou")):
        raise AssertionError(f"finetune eval: {metrics}")

    # timing, peak memory, profile
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: trainer.train_step(batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log("finetune timing: " + json.dumps(dict(
        ms_per_step=ms, batch=B_TRAIN, samples_per_s=B_TRAIN / ms * 1e3,
        peak_memory_gb=peak / 1e9)))
    log("finetune profile: " + json.dumps(
        profile_call(torch, lambda: trainer.train_step(batch))))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from efficient_multimodal_perception_tpu_torch.ops import (
            _build, kernels as K)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc ran: "
        f"{_build.build_seconds is not None})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"ptxas: {line.strip()}")

    check_bf16_amax_scatter(torch)
    probe_launches, probe_row = run_probe(torch, K)
    per = run_kernels(torch, K)
    per["int8_dot"] = [probe_row]
    launches = {
        "int8_probe": probe_launches,
        "serve_forward": run_serve(torch, K, "triplane_occ", PER_FORWARD,
                                   4096),
        "point_serve_forward": run_serve(torch, K, "point_triplane_occ",
                                         PER_POINT_FORWARD, 36864),
    }
    launches["train_step"], ckpt_path = run_train(torch, K)
    launches.update({
        "finetune_step": run_finetune(torch, K, ckpt_path),
        "int8_serve_forward": run_serve(torch, K, "triplane_occ",
                                        PER_INT8_FORWARD, 4096, int8=True),
        "int8_point_serve_forward": run_serve(
            torch, K, "point_triplane_occ", PER_INT8_POINT_FORWARD, 36864,
            int8=True),
    })
    missing = [n for n in K.LAUNCHES
               if not any(c.get(n, 0) for c in launches.values())]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    print(json.dumps({"kernels": kernel_record(per, launches)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

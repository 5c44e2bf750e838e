#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device and build: requires CUDA, prints the card's name and power
   limit, builds the hand-written kernels from ``csrc/`` and prints the
   build time and the compiler's register / shared-memory report;
2. kernels: runs each kernel at its main-path shapes beside its plain
   PyTorch twin on the same inputs (relative Frobenius error <= 1e-2 for
   every output; attention's logsumexp max-abs <= 1e-2) and times kernel,
   twin and one PyTorch library call with CUDA events.  Serve shapes are
   at batch 4, training shapes (the backward kernels, the residual-free
   epilogue, the decoders' head-dim-24 attention, the sampler) at
   batch 2;
3. serve: builds full-width ``triplane_occ`` in bf16 (seeded weights,
   layer-scale gamma drawn from U(0.1, 1) so every ConvNeXt MLP branch
   reaches the output), starts the HTTP server with batch 4, posts three
   requests of 1, 2 and 1 samples, checks each reply is an
   ``(n, 99, 99, 16)`` int8 volume and that the kernels launched exactly
   36 / 2 / 4 / 2 times per forward, then re-runs the same batch with the
   plain twins and holds the logits to stated bounds; last it times the
   forward (ms per batch, samples/s) and profiles one forward with
   ``torch.profiler`` (device busy share, the kernels that take most);
4. train: builds full-width ``triplane_range_cam`` (bf16 compute, f32
   parameters, seeded weights, gamma from U(0.1, 1)) and its trainer at
   batch 2 on synthetic batches.  One forward and backward with the
   kernels and one with ``set_kernels(model, False)``, same batch and
   drop-path generator: losses within 1e-2 relative, every parameter
   group's gradient within 5e-2 relative Frobenius error.  Then three
   optimizer steps through ``Trainer.train_step`` (the CLI's step): the
   first counts each kernel's launches and must equal ``PER_TRAIN_STEP``;
   losses finite, every trainable parameter moved, every frozen one
   bit-identical.  Last it times steps (ms per step, samples/s, peak
   memory) and profiles one.

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
LSE_TOL = 1e-2          # attention logsumexp, max abs
ARGMAX_AGREE_MIN = 0.97  # served logits: kernels vs plain twins
LOGIT_REL_TOL = 3e-2     # served logits: relative Frobenius error
TRAIN_LOSS_TOL = 1e-2    # train losses: kernels vs twins, relative
TRAIN_GRAD_TOL = 5e-2    # per parameter group, relative Frobenius error
PEAK_FLOPS = 989e12     # H100 SXM dense bf16
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
PER_FORWARD = {"convnext_block_fused": 36, "attention": 2,
               "ln_dense_fused": 4, "gelu_dense_fused": 2}
# per training step of triplane_range_cam (frozen stage 0 runs K1, whose
# backward reaches lidar stage 0 only; stages 1-3 run the epilogue; the
# neck and the two decoders each run attention twice)
PER_TRAIN_STEP = {"convnext_block_fused": 6, "epilogue_fused": 30,
                  "post_epilogue_bwd": 27, "post_epilogue_bwd_wide": 6,
                  "attention": 6, "attention_bwd": 6, "ln_dense_fused": 4,
                  "gelu_dense_fused": 2, "triplane_sample": 1,
                  "triplane_sample_bwd": 1}
SOURCES = {
    "convnext_block_fused": ("convnext_block.cu", 519),
    "epilogue_fused": ("convnext_block.cu", 1423),
    "post_epilogue_bwd": ("epilogue_bwd.cu", 1293),
    "post_epilogue_bwd_wide": ("epilogue_bwd.cu", 1183),
    "attention": ("attention.cu", 730),
    "attention_bwd": ("attention.cu", 749),
    "ln_dense_fused": ("prologue_dense.cu", 1833),
    "gelu_dense_fused": ("prologue_dense.cu", 1862),
    "triplane_sample": ("triplane_sample.cu", 371),
    "triplane_sample_bwd": ("triplane_sample.cu", 152),
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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels at main-path shapes
# ---------------------------------------------------------------------------

def kernel_cases(torch, K):
    """Every main-path shape of every kernel, one dict at a time (inputs
    are made when the case is reached): name, label, path (serve / train),
    calls per serve forward or train step, kernel / plain / library
    functions, flops, bytes, and how to compare the outputs."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def case(name, label, path, calls, fk, fp, fl, flops, nbytes,
             check=None):
        return dict(name=name, label=label, path=path, calls=calls, fk=fk,
                    fp=fp, fl=fl, flops=flops, nbytes=nbytes, check=check)

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

    # K1: every stage at serve batch 4; stage 0 (frozen) at train batch 2
    for path, bsz, stages in (("serve", B, range(4)), ("train", B_TRAIN, (0,))):
        for enc, n_img, hws in (("camera", bsz * 6, cam_hw),
                                ("lidar", bsz, lid_hw)):
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
                    f"{enc} stage{i} ({n_img},{h},{w},{C})", path, depths[i],
                    lambda a=args: K.convnext_block_fused(*a),
                    lambda a=args: K.convnext_block_plain(*a), library,
                    16 * M * C * C + 2 * 49 * M * C,
                    2 * M * C * 2 + 2 * 4 * C * C * 2 + (49 + 8 * C) * 4)

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
                    "epilogue_fused", shape, "train", depths[i],
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
                name, shape, "train", depths[i],
                lambda y=y, gy=gy, p=prm, fk=fk: fk(y, gy, *p),
                lambda y=y, gy=gy, p=prm: K.post_epilogue_bwd_plain(y, gy, *p),
                lib_bwd, 48 * M * C * C,
                3 * M * C * 2 + 8 * C * C * 2 + 8 * C * C * 4 + 16 * C * 4,
                "tuple")

    # K2 / B6: the neck (hd 256) and the decoders' sr=4 attention (hd 24)
    att = [("serve", "neck", 4 * B, 4096, 4096, 256)] + [
        ("train", label, G, nq, nk, hd) for label, G, nq, nk, hd in (
            ("neck", 4 * B_TRAIN, 4096, 4096, 256),
            ("camera decoder", 4 * 6 * B_TRAIN, 8192, 512, 24),
            ("lidar decoder", 4 * B_TRAIN, 8192, 512, 24))]
    for path, label, G, nq, nk, hd in att:
        q, k, v = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd)
        sc = hd**-0.5
        shape = f"{label} ({G},{nq},{nk},{hd})"
        yield case(
            "attention", shape, path, 2,
            lambda q=q, k=k, v=v, sc=sc: K.attention(q, k, v, sc),
            lambda q=q, k=k, v=v, sc=sc: K.attention_plain(q, k, v, sc),
            lambda q=q, k=k, v=v, sc=sc: F.scaled_dot_product_attention(
                q, k, v, scale=sc),
            4 * G * nq * nk * hd, (2 * G * nq * hd + 2 * G * nk * hd) * 2
            + G * nq * 4, "lse")
        if path != "train":
            continue
        out, lse = K.attention(q, k, v, sc)
        do = rn(G, nq, hd)
        lq = leaves(q, k, v)

        def lib_att(lq=lq, do=do, sc=sc):
            return torch.autograd.grad(
                F.scaled_dot_product_attention(*lq, scale=sc), lq, do)

        yield case(
            "attention_bwd", shape, path, 2,
            lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd(*a),
            lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd_plain(*a),
            lib_att, 10 * G * nq * nk * hd,
            (3 * G * nq * hd + 3 * G * nk * hd + 2 * G * nq * hd) * 2
            + G * nq * 4, "tuple")

    # K3 / K4: the neck's prologues, serve batch 4 and train batch 2
    C = 1024
    for path, bsz in (("serve", B), ("train", B_TRAIN)):
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
                "ln_dense_fused", f"{label} ({M},{C})->({M},{N_out})", path,
                2, lambda a=a: K.ln_dense_fused(*a),
                lambda a=a: K.ln_dense_plain(*a), library,
                2 * M * C * N_out,
                M * C * 2 + N_out * C * 2 + M * N_out * 2 + 2 * C * 4
                + (N_out * 4 if has_bias else 0))
        xh = rn(M, 2 * C)
        w2 = rn(C, 2 * C, scale=(2 * C)**-0.5)
        b2 = rn(C, scale=0.1, dtype=f32)
        a = (xh, w2, b2)
        yield case(
            "gelu_dense_fused", f"({M},{2 * C})->({M},{C})", path, 2,
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
        "train", 1, lambda: K.triplane_sample(tri, coords),
        lambda: K.triplane_sample_plain(tri, coords),
        lambda: grid_chain(tri), 2 * 12 * B_TRAIN * P * Cp,
        B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes * 2)
    gs = rn(B_TRAIN, P, Cp)
    (lt,) = leaves(tri)
    gs_nchw = gs.permute(0, 2, 1)[:, :, None]
    yield case(
        "triplane_sample_bwd", f"({B_TRAIN},3,{S},{S},{Cp}) at {P} points",
        "train", 1, lambda: K.triplane_sample_bwd(coords, gs, S),
        lambda: K.triplane_sample_bwd_plain(coords, gs, S),
        lambda: torch.autograd.grad(grid_chain(lt), lt, gs_nchw),
        2 * 12 * B_TRAIN * P * Cp,
        B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes * 4)


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
        b_ms, b_by = bound_ms(c["flops"], c["nbytes"])
        row = dict(shape=label, path=c["path"], calls=c["calls"], ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, rel_err=err, max_abs_err=max_abs)
        if lse_err is not None:
            row["lse_max_abs_err"] = lse_err
        log(f"kernel {name} {label}: " + json.dumps(row))
        if not finite:
            raise AssertionError(f"{name} {label}: non-finite output")
        if err > REL_TOL:
            raise AssertionError(f"{name} {label}: rel err {err} > {REL_TOL}")
        if lse_err is not None and lse_err > LSE_TOL:
            raise AssertionError(f"{name} {label}: lse err {lse_err}")
        per.setdefault(name, []).append(row)
        del c
        torch.cuda.empty_cache()
    return per


def kernel_record(per, launches):
    out = []
    for name, rows in per.items():
        tot = lambda k: sum(r[k] * r["calls"] for r in rows)  # noqa: E731
        by_ops = sum(r["calls"] * r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        src, line = SOURCES[name]
        out.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{src}",
            replaces=f"{JAX_KERNELS}:{line}",
            launches=sum(n.get(name, 0) for n in launches.values()),
            launches_by_path={p: n.get(name, 0) for p, n in launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by="operations" if by_ops >= tot("bound_ms") / 2
            else "bytes",
            library_ms=tot("library_ms"),
            max_err=max(r["rel_err"] for r in rows), tol=REL_TOL,
            per=f"one serve forward at batch {B} plus one train step at "
                f"batch {B_TRAIN}, summed over the kernel's calls",
            shapes=rows,
        ))
    return out


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

def post(url, arrs):
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return z["pred"]


def run_serve(torch, K):
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch, synthetic_arrays)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        set_kernels)
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock)
    from efficient_multimodal_perception_tpu_torch.serve import (
        BATCH_KEYS, build_infer_fn, make_model, make_server)

    t0 = time.perf_counter()
    model, _ = make_model("triplane_occ", dtype=torch.bfloat16,
                          device="cuda", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=g) * 0.9
                              + 0.1)
    server, worker = make_server(model=model, port=0, batch_size=B,
                                 coalesce_ms=2000.0, device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    log(f"serve: model + server up in {time.perf_counter() - t0:.1f} s")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"
        reqs = []
        for seed, n in ((1, 1), (2, 2), (3, 1)):
            a = synthetic_arrays(n, point_budget=4096, seed=seed)
            reqs.append({k: a[k] for k in BATCH_KEYS})
        results = [None] * len(reqs)
        errors = []

        def client(i):
            try:
                results[i] = post(url, reqs[i])
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
            raise AssertionError(f"serve requests failed: {errors}")
        for r, req in zip(results, reqs):
            n = len(req["img"])
            if r.shape != (n, 99, 99, 16) or r.dtype != np.int8:
                raise AssertionError(f"reply {r.shape} {r.dtype}, "
                                     f"expected ({n}, 99, 99, 16) int8")
        want = {k: PER_FORWARD.get(k, 0) * forwards for k in K.LAUNCHES}
        log(f"serve: 3 requests in {forwards} forward(s), {wall:.3f} s; "
            f"launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")

        # the same samples once more: kernels vs plain twins on the card
        packed = {k: np.concatenate([r[k] for r in reqs]) for k in BATCH_KEYS}
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
        log("serve check: " + json.dumps(dict(
            served_equals_argmax=same, argmax_agreement=agree,
            logit_rel_err=err, logit_max_abs_err=max_abs,
            logit_max_abs=float(lp.abs().max()), finite=finite,
            bounds=dict(argmax_agreement_min=ARGMAX_AGREE_MIN,
                        logit_rel_err_max=LOGIT_REL_TOL))))
        if not finite or same != 1.0:
            raise AssertionError("served volumes do not match the logits")
        if agree < ARGMAX_AGREE_MIN or err > LOGIT_REL_TOL:
            raise AssertionError(f"kernels vs twins: agreement {agree}, "
                                 f"rel err {err}")

        # steady state through the worker: full batches of 4
        infer = build_infer_fn(model)
        full = arrays_to_batch(packed, "cuda")
        ms = time_ms(torch, lambda: infer(full), 5, warmup=1)
        log("serve timing: " + json.dumps(dict(
            ms_per_batch=ms, batch=B, samples_per_s=B / ms * 1e3)))
        log("serve profile: " + json.dumps(
            profile_call(torch, lambda: infer(full))))
        return launches
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()


# ---------------------------------------------------------------------------
# phase 4: train
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

    per = run_kernels(torch, K)
    launches = {"serve_forward": run_serve(torch, K),
                "train_step": run_train(torch, K)}
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

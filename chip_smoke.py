#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device and build: requires CUDA, prints the card's name and power
   limit, builds the hand-written kernels from ``csrc/`` and prints the
   build time, the compiler's register / shared-memory report and the
   K3/K4 GEMM's launch configuration (ring stages, dynamic shared memory
   bytes, CTA tile, threads);
2. kernels: checks that the card runs the point pools' bf16 ``amax``
   scatter, then runs each kernel at its main-path shapes beside its
   plain PyTorch twin on the same inputs (relative Frobenius error <= 1e-2
   for every output; attention's logsumexp max-abs <= 1e-2) and times
   kernel, twin and one PyTorch library call with CUDA events (attention:
   PyTorch's attention on 4-D views pinned to each SDPA backend, the
   faster fused one as the yardstick, with each kernel's device split).
   Serve
   shapes are at batch 4 (B9 over the raw pools of the full-width
   synthetic cloud, whose share of -inf cells it prints), training shapes
   (the backward kernels, the residual-free epilogue, the decoders'
   head-dim-24 attention, the sampler, the fine-tune's frozen encoders
   and neck; the point train's K1 at both encoders' stage 0, K1's
   backward and B5 both ways at the triplane encoder's plane shapes, B9
   with its torch backward, held to autograd of its twin and timed beside
   autograd of the ``F.linear`` chain) at batch 2; K3 / K4 also, on no
   path, at C = 384 (M = 1024,
   N = C, 2C, 3C, with and without bias: a half-empty last column
   tile), and on the paths with their row pass's and GEMM's device ms
   (``torch.profiler``) beside the library's product alone; K1, the B5
   forward chain and the B5 backward chain (both widths) likewise with
   their device ms per launch (K1's depthwise conv, row passes, GEMMs)
   beside ``F.linear`` alone at each GEMM's shape, and, off the paths,
   at ragged row counts (K1 160 x 768 without gamma and 12345 x 96;
   forward 12345 x 192, 777 x 384, 1000 x 768; backward 1000 x 96,
   777 x 384, 1000 and 6181 x 768); the backward must give the same
   bits on a second call at every shape; B7 (``triplane_sample``) both
   ways at batch 2 on the coordinates the pretraining forward hands it
   (``tools/ab_trees.b7_path_coords``: it prints the share of points in
   the busiest footprint cell, the longest cell list, the share with
   no corner on a plane and the heavy cells of each plane) and, on no
   path, on uniform and on ground-like coordinates
   (``tools/ab_trees.b7_ground_coords``: a row of heavy cells side by
   side on the yz and xz planes); the
   backward must equal ``ops.kernels.triplane_sample_bwd_reference`` (its
   order in float32 on the host, rounded to bf16) bit for bit and give
   the same bits on a second call, and both directions are profiled
   beside ``F.grid_sample`` and its autograd; B8 (``cam_gather_sum``)
   forward at batch 4 and 2 and
   backward at batch 2, on the indices and validity the interact makes
   of synthetic batches (it prints their valid share and the most
   points that land on one feature row), and
   once more at batch 4 with half the valid pixels also seen by a second
   camera, so that its sums have two terms; the forward is profiled
   beside its ``index_select`` chain and a fill of its output's bytes;
   the backward must equal a
   float32 ``np.add.at`` on the host (rounded to bf16) bit for bit and
   give the same bits on a second call, and it is profiled beside its
   ``index_add_`` chain (device ms of each);
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
   the same model's bf16 logits (the quantization's own error);
8. point train: builds full-width ``point_triplane_occ`` (bf16 compute,
   f32 parameters, seeded weights, gamma from U(0.1, 1), BatchNorm
   running statistics drawn) with the flat AdamW of ``train/flat_opt.py``
   (every config's optimizer) at batch 2 of 36864 points a sample.  One
   training forward and backward with the kernels, one with the bf16
   twins and one with float32 twins (the same weights), the BatchNorm
   statistics restored between them and the same drop-path draws: the
   kernels' losses and running statistics within 1e-2 of the bf16
   twins', and for every parameter group the kernels' gradient error
   against the float32 run within ``TWIN_FACTOR`` (1.25) times the bf16
   twins' own.  The same three runs with the BatchNorms on their running
   statistics (drop-path still on) are held to the same rule.  Beside
   them it prints what makes the bf16 gradients this far from float32:
   the share of the gradient at each FPN BatchNorm's output that its
   batch-statistics backward keeps, and at the FPN's inputs the twins'
   error against float32 and the per-channel mean share of the float32
   gradient (near 0 with batch statistics: a weight gradient then sums
   terms of varying sign, and bf16's error does not average out).
   Three steps through ``Trainer.train_step``:
   the first's launches equal ``point_train_launches(model)``
   (PER_POINT_TRAIN_STEP: K1 at both encoders' frozen stage 0 with its
   backward in the triplane encoder, whose input trains; B5 both ways in
   stages 1-3; 3 B9); losses finite, every trainable tensor moved, every
   frozen one bit-identical, every running statistic moved.  The
   optimizer's launches and device ms for one step, flat against the
   per-parameter reference ``AdamW`` on the same model and gradients
   (the pretraining phase prints the same for its model); timing (ms per
   step, samples/s, peak memory) and a profile (the ``optimizer``
   range's device ms); the trainer state saved under ``build/``,
   evaluated (CE / IoU / mIoU over two synthetic batches) and served by
   ``serve.make_server(checkpoint=...)``: the reply equals the logits'
   argmax;
9. elevation: full-width ``triplane_elev`` (ConvNeXt-tiny encoders, the
   MiT neck, the resnet34 U-Net head over the (100, 100, 80) readout;
   bf16 compute, f32 parameters, seeded weights, gamma from U(0.1, 1),
   the U-Net's BatchNorm running statistics drawn) served over HTTP at
   batch 4: three requests of 1, 2 and 1 samples, each reply float32
   ``(n, 100, 100)`` heights equal bit for bit to the forward of the
   packed batch, the launches those of ``triplane_occ``'s forward
   (36 / 2 / 4 / 2 / 1), the heights with the kernels against the plain
   twins within relative Frobenius error 3e-2; then the same with
   ``int8=True`` (36 B10 + 2 attention + 1 B8; the int8 heights against
   the same weights' bf16 heights, unbounded); then the fine-tune at
   batch 2: the encoder and neck partial-loaded whole from phase 5's
   checkpoint and frozen, three steps through ``Trainer.train_step`` (the
   first launches ``finetune_launches(model)``: the forward kernels only),
   every head tensor and running statistic moved, every frozen tensor
   bit-identical; the checkpoint saved, evaluated (masked MSE over two
   synthetic batches) and served by ``serve.make_server(checkpoint=...)``
   (its reply equal bit for bit to the trained model's heights).  Each
   of the three prints ms per batch or step, samples/s, peak memory and a
   profile whose device ms it splits into the encoder and neck (profiled
   alone), the head's forward (the 3-D collapse and the U-Net) and the
   rest (the readout; in the fine-tune also the loss, the head's backward
   and the optimizer);
10. pretraining: full-width ``triplane_surf_sam`` (ConvNeXt-small
   encoders, the MiT neck, the InterpNet surface loss over the range
   points and SupCon over the 6 SAM channels of every raw point) and
   ``point_triplane`` (the point family with the MiT camera decoder over
   ``cam_rec_feat``'s canvases and the surface loss over the raw points;
   BatchNorm running statistics drawn), each in bf16 compute with float32
   parameters, seeded weights and gamma from U(0.1, 1), at batch 2 of
   36864 raw points (and 32768 range points) a sample.  Kernels against
   twins on the same batch, the same drop-path draws and the same loss
   draws (the trainer's two generators of step 0): ``triplane_surf_sam``
   as phase 5 (losses within 1e-2, every gradient group within 5e-2),
   ``point_triplane``, which trains on batch statistics, as phase 8
   (losses and statistics within 1e-2 of the bf16 twins', each group's
   gradient error against a float32 twin run within ``TWIN_FACTOR`` of
   the twins' own); three steps through ``Trainer.train_step``, the first
   launching ``surf_sam_launches(model)`` (B7 twice each way: the range
   points and the raw cloud) or ``point_pretrain_launches(model)``, every
   trainable tensor and running statistic moved and every frozen tensor
   bit-identical; ms a step, samples/s, device ms and idle share of one
   profiled step, peak memory, launches a step, and the host
   synchronisations of one step with the lines that make them
   (``torch.cuda.set_sync_debug_mode("warn")``).  The kernel phase
   runs B7 both ways on the raw cloud's coordinates too
   (``tools/ab_trees.b7_raw_coords``: a third of the points off the
   planes, the padding rows in one cell);
11. data: writes a world of files under ``build/chip_smoke/world``
   (``tools/fixture_world.py``: 24 train and 2 val samples, six 1600 x
   900 JPEGs, a 34000-point keyframe, its range and elevation files and
   30000 occupancy rows a sample; 12 batches of 2 an epoch, three times
   the loader's prefetch of 4) and reads it through ``data/nuscenes.py``:
   the loader alone (ms a batch of 2 and samples/s with 1 and 4 threads
   over ``triplane_occ``'s data block, the share of a sample's time in its
   ``_load_image`` calls (JPEG decode, resize, crop, normalise), in
   ``load_occupancy`` and in the rest (JPEG headers, npz files); two
   passes over epoch 0 identical; which implementation of
   ``data/native.py`` ran); the ``triplane_occ`` fine-tune (phase 5's
   checkpoint partial-loaded, frozen as in phase 6) on the loader's first
   batch, kernels against twins within phase 6's bounds and one step's
   launches ``finetune_launches(model)`` (with the batch's resize, crop
   and flip ranges and B8's valid share on it); then, in process,
   ``train.cli triplane_occ --data-root`` (12 steps at batch 2, an epoch,
   from phase 5's checkpoint), ``train.cli point_triplane_occ
   --data-root`` (3 steps,
   36864-point budgets) and ``eval_cli triplane_occ --bf16`` on the first
   run's checkpoint: each run's launches equal its steps times the path's
   launches a step (the eval: one forward's), every step line finite, the
   losses, ms a step, the loader's wait and the wall a step printed (and
   their means over the steps after the prefetch has run out), and CE /
   IoU / mIoU.  If Pillow is missing the phase prints so and does not
   run.
12. export and flags: five ``torch.export`` artifacts through
   ``tools/export.py`` (``triplane_occ`` bf16 and ``--int8``,
   ``point_triplane_occ``, ``triplane_elev`` at batch 4, the
   ``triplane_range_cam`` loss dict at batch 2; seeded weights, gamma and
   statistics drawn as the serve phases): the live forward's launches,
   the export's seconds, the file's MB, the count of each ``emp::`` op in
   the graph and the launches of the loaded artifact's run (both must
   equal the live forward's), its output against the live one (class
   maps and heights bit for bit, losses within 1e-5 relative), the
   artifact's ms a batch beside the live forward's (CUDA events, 10
   after 3 warm-ups) and a profile of one call of each (with the host
   operators that take the most host time).  After the timings the
   ``triplane_occ`` artifact is loaded in a fresh ``python3`` through
   ``load_artifact`` (no model module imported) and must give the same
   class map.  Then ``train.cli`` in process: ``triplane_range_cam`` 2
   steps at batch 2 twice without and once with ``--remat`` (step 1's
   loss bit for bit, ``grad_norm`` and step 2's loss within 1e-3
   relative, printed beside the gap of the two plain runs; peak memory
   and ms of each; the plain runs' launches ``PER_TRAIN_STEP`` a step),
   ``point_triplane_occ`` one step without and with ``--remat`` (every
   BatchNorm running statistic bit-identical: they moved once), and the
   ``triplane_occ`` fine-tune 3 steps at batch 2 plain and with
   ``--accum-steps 2 --async-ckpt --eval-interval 1`` (losses and ms a
   step of both; launches twice ``finetune_launches`` a step and once an
   evaluation batch; the asynchronous checkpoint loads, its meta file
   exists, one ``[eval @ epoch 1]`` line and ``val/`` lines in
   ``train.log``).
13. masked pretraining (``run_masked``): (a) full-width
   ``triplane_range_cam`` with SparK masking (both mask ratios 0.75) and
   the colour head (``PointMlp`` over the triplane's 32 channels), config
   overrides, through phase 10's ``run_pretrain``: kernels against twins
   on the same batch and the same drop-path, loss and mask draws (phase
   5's bounds); three steps, the first launching
   ``masked_pretrain_launches(model)`` (no K1: every block, frozen or
   not, one B5 forward; the B5 backward as unmasked), every trainable
   tensor with a gradient moved and no frozen one (the colour head takes
   no gradient: its ``color`` entry is logged, not summed into the loss,
   as in JAX; it is listed with what weight decay moved); the masks of
   three steps pairwise different; the step's ms, device ms, idle share
   and peak memory beside the same model unmasked (``PER_TRAIN_STEP``'s
   launches) and masked again; (b) at batch 1, unmasked,
   ``TriplaneMAE.reconstructions`` and ``triplane_occ``'s ``triplane``
   with the kernels against the twins (relative error <= 3e-2, launches
   ``recon_launches``), then the eval CLI's ``--show-dir`` dump
   (``eval_cli.dump_visualizations``) of one sample of each and
   ``save_points_obj``, the files by kind (the PNG figures only where
   matplotlib is installed, which the card's machine is not); (c)
   ``MixVisionTransformerHigh`` on a ``(2, 128, 32, 768)`` strip: the
   ``(2, 256, 256, 96)`` output with K2-K4 (2 / 4 / 2 launches) within
   3e-2 of the twins', ms with and without the kernels.
14. int8's static scales and straight-through backward
   (``run_int8_train``): (a) full-width ``triplane_occ`` with static
   int8 (``enable_int8(..., mode="static")``) at batch 4, calibrated by
   ``ops.quant.calibrate`` on two synthetic batches (seeds 1 and 2, as
   the JAX bench's ``--int8-static``): the number of sites, every amax
   above 0; one forward launching ``PER_STATIC_FORWARD`` (B10 0, K2 2,
   B8 1: a static block never runs B10); the logits with the kernels
   against the twins within ``LOGIT_REL_TOL``, against the same weights
   in bf16 (argmax agreement >= 0.97) and in float32 (relative error <=
   0.15: JAX's own bounds, ``tests/test_quant.py:297-301``); ms, device
   ms and peak GB of the static, dynamic and bf16 forwards of the same
   model; (b) the int8 fine-tune of ``triplane_occ`` at batch 2 (encoder
   and neck int8 and frozen, the head bf16: the JAX bench's
   ``bench_occ_train(int8=True)``): kernels against twins as phase 6,
   the first loss within 5e-2 of the same step without int8, three
   steps launching ``int8_finetune_launches`` (the frozen encoder runs
   deterministic, so every block is one B10), only the head moved, ms
   and device ms a step with int8 and without; (c) a quantization-aware
   ``triplane_range_cam`` run at batch 2 (``QAT_OPTIONS``: int8 encoder
   and neck at the shipped drop-path rates) through phase 10's
   ``run_pretrain``: kernels against twins (every gradient group within
   5e-2, none without a gradient), three steps launching
   ``qat_launches`` (B10's forward at the 6 frozen blocks where phase 5
   runs K1, its VJP at the 3 whose input trains, where K1's backward
   runs; the other blocks the unfused straight-through route), every
   trainable tensor moved; B10's VJP against autograd of the plain STE
   chain (``ops.kernels.block_int8_xla``, within 1e-2) on the lidar
   stage-0 block's
   input, both timed; B10 on a trainable block's weights cached before
   a step and called after it equal to its twin bit for bit (the cache
   saw the flat AdamW's update), the frozen blocks' B10 equal to the
   twin; the step's ms and device ms beside the same model's bf16 step.
   Phase 2 also holds B10 to its twin at the stage-0 shapes of (c).

The int8 dot probe runs before phase 2 as a phase of its own: the
operands of ``tools/measure_int8.py`` through ``int8_dot`` (the int8
``wgmma`` GEMM of ``csrc/int8_gemm.cu``) once, held to the integer
product computed on the host (exact), then timed beside
``torch._int_mm`` (event ms, and device ms from the profiler); then the
same GEMM at the tool's section-1 shapes (big, epi1, neck) and B10's two
products at camera stage 0 of the serve path, each equal to
``torch._int_mm``'s output, with device ms and TOP/s beside
``torch._int_mm`` and a bf16 ``torch.matmul`` of the same shape (lines
``int8 GEMM <shape>: {...}``; the yardsticks are timed only).  Phase 2
holds B10 to its twin at the ConvNeXt shapes of both int8 serve paths,
bit for bit (B10 rounds where its twin does), with its device split
(depthwise conv, row pass, fc1's amax and quantize passes, fc2) beside
the library chain's device ms; that chain (``torch._int_mm`` and the
quantization in PyTorch) takes weight codes computed outside the timing,
as B10 caches them, and ``library_requant_ms`` times it quantizing both
weights on every call, as the uncached wrapper did.  B9 prints its device ms
beside the ``F.linear`` chain's, kernel by kernel.  Phase 5 also traces
the float32 cuBLAS GEMMs of one training step to the operators and the
modules that launch them (``train f32 GEMMs: [...]``; empty while the
prologues' backward and the unfused MixFFN compute in bf16), and
the int8 serve profiles give the device ms of the neck's and head's
int8 products (``ranges``) and the launches of one forward.

The last lines are the whole run's seconds, the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import types
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
# point train: with batch statistics the FPN's BatchNorms leave the
# gradient below them without a per-channel mean, so bf16's rounding no
# longer averages out of the weight gradients (phase 8 prints the mean
# share); the bf16 kernels and the bf16 twins are each held to a float32
# twin run on the same batch and draws: per group, the kernels' error
# within TWIN_FACTOR of the twins' own
TWIN_FACTOR = 1.25
PROFILE_TRIES = 3       # traces taken before a profile counts as blind
EVENT_FALLBACK = "cuda events: the profiler saw no device time"
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
# ConvNeXt-small's depths (triplane_surf_sam's encoders)
SMALL_DEPTHS = (3, 3, 27, 3)
# the kernel phase's paths whose rows also run backward
TRAIN_PATHS = ("train", "surf_sam", "point_pretrain", "masked")
CKPT_DIR = os.path.join(REPO, "build", "chip_smoke")  # git-ignored
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "convnext_block_fused": ("convnext_block.cu", f"{JAX_KERNELS}:519"),
    "epilogue_fused": ("epilogue_fwd.cu", f"{JAX_KERNELS}:1423"),
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
    "int8_dot": ("int8_gemm.cu", "tools/measure_int8.py:46"),
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


def profile_call(torch, fn, top=15, ranges=(), host_top=0):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device time summed over all kernels and copies (``busy_ms``; the idle
    share is 1 - busy / wall, and the profiler's own overhead lengthens
    wall), the number of kernels and copies it launched, the kernels that
    take the most device time, and the device ms and calls of each
    ``record_function`` range named in ``ranges`` and of the trainer's
    optimizer range; with ``host_top``, the host operators that take the
    most host time of their own (``self_cpu``) and how many ran.  After
    ``PROFILE_TRIES`` traces without device events the profile is blind:
    ``busy_ms`` is then one call's CUDA-event ms, and no kernel, launch
    count or range is given (``blind`` says so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        OPTIMIZER_RANGE)

    ranges = tuple(ranges) + (OPTIMIZER_RANGE,)

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        # a range also shows as a device-side annotation spanning its
        # kernels: not a kernel of its own
        kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in avg if e.device_type == DeviceType.CUDA
                       and e.key not in ranges), reverse=True)
        busy = sum(k[0] for k in kern)
        if busy > 0:
            break
        log(f"profiler: no device time in a trace (attempt {attempt + 1} "
            f"of {PROFILE_TRIES})")
    else:  # a blind profiler: the call's CUDA-event ms stands for busy
        busy = time_ms(torch, fn, 1, warmup=0)
        return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                    device_launches=None, kernels=[], ranges={},
                    blind=EVENT_FALLBACK)
    out = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               device_launches=sum(k[1] for k in kern),
               kernels=[dict(name=name[:100], ms=t, count=n)
                        for t, n, name in kern[:top]])
    out["ranges"] = {e.key: dict(device_ms=e.device_time_total / 1e3,
                                 calls=e.count)
                     for e in avg if e.key in ranges
                     and e.device_type == DeviceType.CPU}
    if host_top:
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in avg if e.device_type == DeviceType.CPU),
                      reverse=True)
        out["host_ops"] = sum(h[1] for h in host)
        out["host_self_ms"] = [dict(name=name[:60], ms=t, count=n)
                               for t, n, name in host[:host_top]]
    return out


# cuBLAS's float32 GEMM kernels (SIMT: no tensor cores) by name
F32_GEMM_MARKS = ("f32f32_f32f32", "sgemm")


def trace_f32_gemms(torch, model, fn, top=8):
    """One call of ``fn`` under ``torch.profiler`` with shapes, each
    submodule of ``model`` run inside a ``record_function`` range named
    after it: each operator that launched a float32 cuBLAS GEMM
    (``F32_GEMM_MARKS``), by operator, input shapes and the innermost
    module it ran in (for a backward operator, the module of the forward
    operator its autograd node records, matched by sequence number), with
    the device ms and launches of those GEMMs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    open_ranges = []

    def enter(mod, args, name):
        r = record_function(f"module::{name}")
        r.__enter__()
        open_ranges.append(r)

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    hooks = []
    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: enter(m, a, name)))
            hooks.append(mod.register_forward_hook(leave))
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def module_of(e):
        while e is not None and not e.name.startswith("module::"):
            e = e.cpu_parent
        return None if e is None else e.name[len("module::"):]

    fwd = {}  # sequence number -> module of the forward op
    for e in events:
        if e.sequence_nr >= 0 and e.sequence_nr not in fwd:
            where = module_of(e)
            if where:
                fwd[e.sequence_nr] = where
    rows = {}
    for e in events:
        ks = [k for k in getattr(e, "kernels", [])
              if any(m in k.name for m in F32_GEMM_MARKS)]
        if not ks:
            continue
        where, node = module_of(e), e
        while where is None and node is not None:
            if "Backward" in node.name and node.sequence_nr in fwd:
                where = f"backward of {fwd[node.sequence_nr]}"
            node = node.cpu_parent
        key = (e.name, str(e.input_shapes), where)
        r = rows.setdefault(key, dict(op=e.name, shapes=e.input_shapes,
                                      module=where, device_ms=0.0,
                                      launches=0, kernels=set()))
        r["device_ms"] += sum(k.duration for k in ks) / 1e3
        r["launches"] += len(ks)
        r["kernels"].update(k.name[:60] for k in ks)
    out = sorted(rows.values(), key=lambda r: -r["device_ms"])[:top]
    for r in out:
        r["kernels"] = sorted(r["kernels"])
    return out


def _device_events(torch, fn, calls):
    """(name, device ms per call) of each kernel or copy ``fn`` launches,
    from ``torch.profiler`` over ``calls`` calls.  CUPTI now and then hands
    back a trace without device events: after ``PROFILE_TRIES`` such traces
    the calls are timed with CUDA events instead, as one entry named
    ``EVENT_FALLBACK``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = [(e.key, e.self_device_time_total / 1e3 / calls)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if sum(ms for _, ms in out) > 0:
            return out
        log(f"profiler: no device time in a trace (attempt {attempt + 1} "
            f"of {PROFILE_TRIES})")
    return [(EVENT_FALLBACK, time_ms(torch, fn, calls, warmup=0))]


def device_ms_by_kernel(torch, fn, calls=5):
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls."""
    return {k.split("(")[0][:60]: ms for k, ms in _device_events(torch, fn,
                                                                 calls)}


def device_ms(torch, fn, calls=5):
    """Device ms per call of ``fn``: its kernels' times summed."""
    return sum(ms for _, ms in _device_events(torch, fn, calls))


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


def log_attention_build(K, build):
    """K2 / B6's registers, spills and shared memory per instantiation
    (``-Xptxas -v``), and their tile plan as the library reports it,
    which must equal ``ops.kernels.attention_plan`` (what the CPU tests
    check) at every head dim."""
    from efficient_multimodal_perception_tpu_torch.tools.ptxas_compare import (  # noqa: E501
        parse)

    regs = {k: v for k, v in parse(build.build_log()).items()
            if "attention" in k}
    log("attention ptxas: " + json.dumps(regs))
    plans = {hd: K.attention_launch_config(hd) for hd in range(8, 257, 8)}
    wrong = [hd for hd, p in plans.items() if p != K.attention_plan(hd)]
    if wrong:
        raise AssertionError(f"attention plan differs at hd {wrong}")
    log("attention plan: " + json.dumps(
        {hd: plans[hd] for hd in (24, 64, 128, 256)}))


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

def b7_cell_stats(K, coords, S):
    """How B7's points fall on the footprint cells of each (b, plane): the
    largest share of a sample's points in one cell, the longest cell list,
    the share of points with no corner on the plane (NaN included), and
    for each plane (xy, yz, xz) the most heavy cells (more than
    ``TRI_BWD_LIGHT`` entries, summed in chunks) of a sample."""
    cells, _ = K.triplane_footprints(coords.cpu().numpy(), S)
    sizes = [[np.bincount(c[c >= 0]) for c in planes] for planes in cells]
    longest = max(int(n.max(initial=0)) for row in sizes for n in row)
    heavy = [max(int((row[pl] > K.TRI_BWD_LIGHT).sum()) for row in sizes)
             for pl in range(3)]
    return dict(busiest_cell_share=longest / cells.shape[-1],
                longest_cell_list=longest,
                no_corner_share=float((cells < 0).mean()),
                heavy_cells_by_plane=heavy)


def kernel_cases(torch, K):
    """Every main-path shape of every kernel, one dict at a time (inputs
    are made when the case is reached): name, label, calls (per path:
    one forward of a serve path, one pretrain or fine-tune step), kernel /
    plain / library functions, flops, bytes, and how to compare the
    outputs."""
    import torch.nn.functional as F

    from efficient_multimodal_perception_tpu_torch.tools.attention_bench import (  # noqa: E501
        fastest_fused, sdpa_yardsticks)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    def case(name, label, calls, fk, fp, fl, flops, nbytes, check=None,
             extra=None, int8_ops=0, tol=REL_TOL, split=None,
             deterministic=False, reference=None, yardstick=False):
        """``fl``: the library call, timed with CUDA events; with
        ``yardstick``, a function returning the row's ``library_ms`` and
        what else it measured."""
        return dict(name=name, label=label, calls=calls, fk=fk, fp=fp,
                    fl=fl, flops=flops, nbytes=nbytes, check=check,
                    extra=extra or {}, int8_ops=int8_ops, tol=tol,
                    split=split, deterministic=deterministic,
                    reference=reference, yardstick=yardstick)

    def dense_split(fk, M, K, w, bias):
        """K3/K4: device ms of the row pass and of the GEMM per call,
        beside the library's product alone (``F.linear`` on a bf16
        operand of z's shape)."""
        def run():
            z = rn(M, K)
            b = None if bias is None else bias.to(bf)
            return dict(device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                        library_gemm_ms=time_ms(
                            torch, lambda: F.linear(z, w, b), 10))
        return run

    def mlp_params(C):
        """ln_s, ln_b, w1, b1, w2, b2, gamma at width C."""
        return (1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32),
                rn(4 * C, C, scale=C**-0.5), rn(4 * C, scale=0.1, dtype=f32),
                rn(C, 4 * C, scale=(4 * C)**-0.5), rn(C, scale=0.1, dtype=f32),
                torch.rand(C, generator=g, device=dev) * 0.9 + 0.1)

    def mlp_chain(y, s, b, w1, b1, w2, b2, gm):
        C = y.shape[-1]
        y = F.layer_norm(y, (C,), s.to(bf), b.to(bf), 1e-6)
        o = F.linear(F.gelu(F.linear(y, w1, b1.to(bf))), w2, b2.to(bf))
        return o if gm is None else o * gm.to(bf)

    def lib_gemms(*pairs):
        """Event-timed ms of ``F.linear(a, w)`` for each named (a, w)."""
        return {k: time_ms(torch, lambda a=a, w=w: F.linear(a, w), 10)
                for k, (a, w) in pairs}

    def fwd_split(fk, M, C, w1, w2):
        """The MLP chain's (K1's, the B5 forward's) device ms per call of
        each kernel it launches (K1: the depthwise conv too), beside
        ``F.linear`` alone at fc1's and fc2's shapes."""
        def run():
            z, h = rn(M, C), rn(M, 4 * C)
            return dict(device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                        library_gemm_ms=lib_gemms(("fc1", (z, w1)),
                                                  ("fc2", (h, w2))))
        return run

    def k1_case(label, calls, x, gamma=True):
        C = x.shape[-1]
        prm = mlp_params(C)
        args = (x, rn(C, 1, 7, 7, scale=7**-1, dtype=f32),
                rn(C, scale=0.1, dtype=f32)) + prm[:-1] + (
                    prm[-1] if gamma else None,)

        def library(a=args):
            x, k, kb = a[:3]
            return x + mlp_chain(K.dwconv7(x, k, kb), *a[3:])

        M = x.numel() // C
        fk = lambda a=args: K.convnext_block_fused(*a)  # noqa: E731
        return case(
            "convnext_block_fused", label, calls, fk,
            lambda a=args: K.convnext_block_plain(*a), library,
            16 * M * C * C + 2 * 49 * M * C,
            2 * M * C * 2 + 2 * 4 * C * C * 2 + (49 + 8 * C) * 4,
            split=fwd_split(fk, M, C, prm[2], prm[4]))

    depths = (3, 3, 9, 3)
    widths = (96, 192, 384, 768)
    cam_hw = [(128, 256), (64, 128), (32, 64), (16, 32)]
    lid_hw = [(32, 256), (32, 128), (32, 64), (32, 32)]
    xy_hw = [(128 >> i, 128 >> i) for i in range(4)]
    yz_hw = [(128 >> i, 80 >> i) for i in range(4)]

    # K1: every stage at serve batch 4 (the camera encoder's shapes are
    # the same on both serve paths; the point family's triplane encoder
    # runs on the xy plane and, at one shape, on yz and xz); at train
    # batch 2 stage 0 (frozen in pretraining and in the point train, where
    # the triplane encoder's also takes K1's backward: its input trains)
    # and, for the fine-tune's frozen encoders, every stage
    k1_sites = [
        (("camera", B * 6, cam_hw), range(4),
         ("serve", "point_serve", "elev_serve"), 1),
        (("lidar", B, lid_hw), range(4), ("serve", "elev_serve"), 1),
        (("triplane xy", B, xy_hw), range(4), ("point_serve",), 1),
        (("triplane yz|xz", B, yz_hw), range(4), ("point_serve",), 2),
        (("camera", B_TRAIN * 6, cam_hw), (0,),
         ("train", "finetune", "point_train", "elev_finetune", "surf_sam",
          "point_pretrain"), 1),
        (("triplane xy", B_TRAIN, xy_hw), (0,),
         ("point_train", "point_pretrain"), 1),
        (("triplane yz|xz", B_TRAIN, yz_hw), (0,),
         ("point_train", "point_pretrain"), 2),
        (("lidar", B_TRAIN, lid_hw), (0,),
         ("train", "finetune", "elev_finetune", "surf_sam"), 1),
        (("camera", B_TRAIN * 6, cam_hw), (1, 2, 3),
         ("finetune", "elev_finetune"), 1),
        (("lidar", B_TRAIN, lid_hw), (1, 2, 3), ("finetune", "elev_finetune"),
         1),
    ]
    for (enc, n_img, hws), stages, paths, mult in k1_sites:
        for i in stages:
            (h, w), C = hws[i], widths[i]
            yield k1_case(f"{enc} stage{i} ({n_img},{h},{w},{C})",
                          {p: mult * depths[i] for p in paths},
                          rn(n_img, h, w, C))
    # off every path: ragged row counts (160: one sample's xz plane at
    # stage 3, without gamma; 12345 at C = 96)
    yield k1_case("ragged (1,16,10,768), gamma None", {},
                  rn(1, 16, 10, 768), gamma=False)
    yield k1_case("ragged (1,823,15,96)", {}, rn(1, 823, 15, 96))

    # B10: the int8 blocks of both int8 serve paths at batch 4 (the K1
    # sites' serve shapes); the library chain is dwconv, F.layer_norm and
    # the int8 products through torch._int_mm with the row quantization
    # and dequantization in PyTorch, on weight codes computed once outside
    # the timing, as B10 caches them (``library_requant_ms``: the same
    # chain quantizing both weights inside every call, as the uncached
    # wrapper did)
    from efficient_multimodal_perception_tpu_torch.ops.quant import (
        quantize_weight, sym_quant)

    def int8_chain(x, k, kb, s, b, w1c, b1, w2c, b2, gm):
        C = x.shape[-1]
        y = K.dwconv7(x, k, kb).reshape(-1, C)
        z = F.layer_norm(y.float(), (C,), s, b, 1e-6)
        (w1q, w1s), (w2q, w2s) = w1c, w2c
        zq, zs = sym_quant(z, -1)
        h = F.gelu(torch._int_mm(zq, w1q.t()).float() * zs * w1s + b1)
        hq, hs = sym_quant(h, -1)
        o = torch._int_mm(hq, w2q.t()).float() * hs * w2s + b2
        return (x.float() + (o * gm).reshape(x.shape)).to(x.dtype)

    def int8_chain_requant(x, k, kb, s, b, w1, b1, w2, b2, gm):
        return int8_chain(x, k, kb, s, b, quantize_weight(w1), b1,
                          quantize_weight(w2), b2, gm)

    def b10_split(fk, fl):
        """B10's device ms per call of each kernel it launches (the
        depthwise conv, the row pass, fc1's amax and quantize passes,
        fc2) and in all, beside the library chain's device ms."""
        def run():
            return dict(device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                        device_ms=device_ms(torch, fk),
                        library_device_ms=device_ms(torch, fl))
        return run

    # (and at stage 0 of the quantization-aware triplane_range_cam step
    # at batch 2, phase 14: the frozen blocks, where K1 runs in phase 5)
    b10_sites = [
        (("camera", B * 6, cam_hw),
         ("int8_serve", "int8_point_serve", "int8_elev_serve"), 1, 4),
        (("lidar", B, lid_hw), ("int8_serve", "int8_elev_serve"), 1, 4),
        (("triplane xy", B, xy_hw), ("int8_point_serve",), 1, 4),
        (("triplane yz|xz", B, yz_hw), ("int8_point_serve",), 2, 4),
        (("camera", B_TRAIN * 6, cam_hw), ("int8_qat",), 1, 1),
        (("lidar", B_TRAIN, lid_hw), ("int8_qat",), 1, 1),
    ]
    for (enc, n_img, hws), paths, mult, stages in b10_sites:
        for i in range(stages):
            (h, w), C = hws[i], widths[i]
            args = (rn(n_img, h, w, C), rn(C, 1, 7, 7, scale=7**-1, dtype=f32),
                    rn(C, scale=0.1, dtype=f32)) + tuple(
                        t.float() for t in mlp_params(C))
            codes = args[:5] + (quantize_weight(args[5]), args[6],
                                quantize_weight(args[7])) + args[8:]
            M = n_img * h * w
            fk = lambda a=args: K.convnext_block_int8_fused(*a)  # noqa: E731
            fl = lambda a=codes: int8_chain(*a)  # noqa: E731
            yield case(
                "convnext_block_int8_fused",
                f"{enc} stage{i} ({n_img},{h},{w},{C})",
                {p: mult * depths[i] for p in paths}, fk,
                lambda a=args: K.convnext_block_int8_plain(*a), fl,
                2 * 49 * M * C,
                2 * M * C * 2 + 2 * 4 * C * C * 4 + 58 * C * 4,
                int8_ops=16 * M * C * C, tol=B10_TOL,
                split=b10_split(fk, fl),
                extra=dict(library_requant_ms=time_ms(
                    torch, lambda a=args: int8_chain_requant(*a), 10)))

    # B5: epilogue forward and backward, stages 1-3 at train batch 2
    # (backward also at lidar stage 0, through K1's backward), with their
    # device split beside F.linear alone at each GEMM's shape
    def bwd_split(fk, M, C, w1, w2):
        def run():
            z, h = rn(M, C), rn(M, 4 * C)
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            return dict(
                device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                library_gemm_ms=lib_gemms(
                    ("dual1 hpre = z W1^T", (z, w1)),
                    ("dual1 dh = doc W2", (z, w2t)),
                    ("dual2 dz = dhpre W1", (h, w1t)),
                    ("dual2 opre = h W2^T", (h, w2)),
                    ("dW1 = dhpre^T z", (h.t(), z.t())),
                    ("dW2 = doc^T h", (z.t(), h.t()))))
        return run

    def epilogue_fwd_case(M, C, calls, shape, with_split):
        y = rn(M, C)
        prm = mlp_params(C)
        fk = lambda y=y, p=prm: K.epilogue_fused(y, *p)  # noqa: E731
        return case(
            "epilogue_fused", shape, calls, fk,
            lambda y=y, p=prm: K.epilogue_plain(y, *p),
            lambda y=y, p=prm: mlp_chain(y, *p),
            16 * M * C * C, 2 * M * C * 2 + 8 * C * C * 2 + 8 * C * 4,
            split=fwd_split(fk, M, C, prm[2], prm[4]) if with_split else None)

    def epilogue_bwd_case(M, C, calls, shape, with_split):
        y, prm = rn(M, C), mlp_params(C)
        gy = rn(M, C, scale=0.05)
        wide = C > 384
        name = "post_epilogue_bwd_wide" if wide else "post_epilogue_bwd"
        fk = K.post_epilogue_bwd_wide if wide else K.post_epilogue_bwd
        lib_in = leaves(y, *prm)

        def lib_bwd(li=lib_in, gy=gy):
            return torch.autograd.grad(mlp_chain(*li), li, gy)

        call = lambda y=y, gy=gy, p=prm, fk=fk: fk(y, gy, *p)  # noqa: E731
        return case(
            name, shape, calls, call,
            lambda y=y, gy=gy, p=prm: K.post_epilogue_bwd_plain(y, gy, *p),
            lib_bwd, 48 * M * C * C,
            3 * M * C * 2 + 8 * C * C * 2 + 8 * C * C * 4 + 16 * C * 4,
            "tuple", deterministic=True,
            split=bwd_split(call, M, C, prm[2], prm[4]) if with_split
            else None)

    # the camera encoder's stages 1-3 have the same shapes in the point
    # train; the triplane encoder's stage 0 takes K1's backward (through
    # B5's) in the point train, stages 1-3 B5 both ways; the
    # triplane_surf_sam step runs ConvNeXt-small (27 blocks in stage 2)
    # at triplane_range_cam's shapes, the point_triplane step the point
    # train's; the masked triplane_range_cam step runs B5's forward in
    # the frozen stage 0 too (a masked block never runs K1)
    for enc, n_img, hws, paths, mult in (
            ("camera", B_TRAIN * 6, cam_hw,
             ("train", "point_train", "surf_sam", "point_pretrain",
              "masked"), 1),
            ("lidar", B_TRAIN, lid_hw, ("train", "surf_sam", "masked"), 1),
            ("triplane xy", B_TRAIN, xy_hw, ("point_train",
                                             "point_pretrain"), 1),
            ("triplane yz|xz", B_TRAIN, yz_hw, ("point_train",
                                                "point_pretrain"), 2)):
        for i in range(4):
            (h, w), C = hws[i], widths[i]
            M = n_img * h * w
            shape = f"{enc} stage{i} ({M},{C})"
            calls = {p: mult * (SMALL_DEPTHS if p == "surf_sam" else
                                depths)[i] for p in paths}
            split = enc in ("camera", "lidar")
            if i > 0:
                yield epilogue_fwd_case(M, C, calls, shape, split)
            elif "masked" in paths:
                yield epilogue_fwd_case(M, C, {"masked": depths[0]}, shape,
                                        False)
            if i == 0 and enc == "camera":
                continue  # frozen and no gradient reaches it
            yield epilogue_bwd_case(M, C, calls, shape, split)
    # off every path: ragged row counts (not a multiple of the 128-row
    # tile) at each width of the redesigned chains
    for M, C in ((12345, 192), (777, 384), (1000, 768)):
        yield epilogue_fwd_case(M, C, {}, f"ragged ({M},{C})", False)
    for M, C in ((1000, 96), (777, 384), (1000, 768), (6144 + 37, 768)):
        yield epilogue_bwd_case(M, C, {}, f"ragged ({M},{C})", False)

    # K2 / B6: the neck (hd 256; the int8 neck runs K2 at the same shape,
    # the fine-tune's frozen neck at train batch 2, forward only) and the
    # decoders' sr=4 attention (hd 24)
    att = [(("serve", "int8_serve", "elev_serve", "int8_elev_serve"), "neck",
            4 * B, 4096, 4096, 256),
           (("train", "finetune", "elev_finetune", "surf_sam", "masked"),
            "neck", 4 * B_TRAIN, 4096, 4096, 256),
           (("train", "point_pretrain", "masked"), "camera decoder",
            4 * 6 * B_TRAIN, 8192, 512, 24),
           (("train", "masked"), "lidar decoder", 4 * B_TRAIN, 8192, 512,
            24),
           (("mit_high",), "MiT high neck", 4 * B_TRAIN, 4096, 4096, 192)]
    # Yardsticks: PyTorch's fused attention on 4-D (G, 1, N, hd) views,
    # pinned to each backend (tools/attention_bench.sdpa_yardsticks; a
    # 3-D call runs the math backend: no fused kernel takes 3-D inputs);
    # library_ms is the faster of FLASH_ATTENTION and EFFICIENT_ATTENTION.
    for paths, label, G, nq, nk, hd in att:
        q, k, v = rn(G, nq, hd), rn(G, nk, hd), rn(G, nk, hd)
        do = rn(G, nq, hd)
        sc = hd**-0.5
        shape = f"{label} ({G},{nq},{nk},{hd})"
        train = any(p in TRAIN_PATHS for p in paths)
        out, lse = K.attention(q, k, v, sc)
        yard = {}

        def yardstick(way, q=q, k=k, v=v, do=do, sc=sc, train=train,
                      want=(out, lse), yard=yard):
            if not yard:  # both ways measured once, at the forward's case
                yard.update(sdpa_yardsticks(torch, q, k, v, sc,
                                            do if train else None,
                                            want=want))
            ms, backend = fastest_fused(yard, way)
            return dict(library_ms=ms, library_backend=backend, sdpa={
                t: {key: r.get(key) for key in (
                    "call", "event_ms", "device_ms", "device_ms_by_kernel",
                    "error", "rel_err_vs_kernel", "lse_max_abs_vs_kernel")
                    if key in r}
                for t, r in yard.items() if t.startswith(way)})

        def split(fk):
            return lambda: dict(device_ms_by_kernel=device_ms_by_kernel(
                torch, fk))

        fk = lambda q=q, k=k, v=v, sc=sc: K.attention(q, k, v, sc)  # noqa: E731
        yield case(
            "attention", shape, {p: 2 for p in paths}, fk,
            lambda q=q, k=k, v=v, sc=sc: K.attention_plain(q, k, v, sc),
            lambda y=yardstick: y("fwd"),
            4 * G * nq * nk * hd, (2 * G * nq * hd + 2 * G * nk * hd) * 2
            + G * nq * 4, "lse", split=split(fk), yardstick=True)
        if not train:
            continue
        fk = lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd(*a)  # noqa: E731
        yield case(
            "attention_bwd", shape,
            {p: 2 for p in paths if p in TRAIN_PATHS}, fk,
            lambda a=(q, k, v, out, lse, do, sc): K.attention_bwd_plain(*a),
            lambda y=yardstick: y("bwd"), 10 * G * nq * nk * hd,
            (3 * G * nq * hd + 3 * G * nk * hd + 2 * G * nq * hd) * 2
            + G * nq * 4, "tuple", split=split(fk), deterministic=True,
            yardstick=True)

    # K3 / K4: the neck's prologues, serve batch 4 and train batch 2; then,
    # off every path, a width the neck's gate admits whose last 256-wide
    # column tile is half empty (C = 384: N = C, 2C, 3C)
    def prologue_cases(C, M, paths, sites):
        x = rn(M, C)
        s_, b_ = 1 + rn(C, scale=0.1, dtype=f32), rn(C, scale=0.1, dtype=f32)
        for label, N_out, has_bias in sites:
            w = rn(N_out, C, scale=C**-0.5)
            bias = rn(N_out, scale=0.1, dtype=f32) if has_bias else None
            a = (x, s_, b_, w, bias)

            def library(a=a):
                x, s_, b_, w, bias = a
                y = F.layer_norm(x, (C,), s_.to(bf), b_.to(bf), 1e-6)
                return F.linear(y, w, None if bias is None else bias.to(bf))

            fk = lambda a=a: K.ln_dense_fused(*a)  # noqa: E731
            yield case(
                "ln_dense_fused", f"{label} ({M},{C})->({M},{N_out})",
                {p: 2 for p in paths}, fk,
                lambda a=a: K.ln_dense_plain(*a), library,
                2 * M * C * N_out,
                M * C * 2 + N_out * C * 2 + M * N_out * 2 + 2 * C * 4
                + (N_out * 4 if has_bias else 0),
                split=dense_split(fk, M, C, w, bias) if paths else None)

    def gelu_case(C, M, N_out, paths, has_bias=True, label=""):
        xh = rn(M, 2 * C)
        w2 = rn(N_out, 2 * C, scale=(2 * C)**-0.5)
        b2 = rn(N_out, scale=0.1, dtype=f32) if has_bias else None
        a = (xh, w2, b2)
        fk = lambda a=a: K.gelu_dense_fused(*a)  # noqa: E731
        return case(
            "gelu_dense_fused", f"{label}({M},{2 * C})->({M},{N_out})",
            {p: 2 for p in paths}, fk,
            lambda a=a: K.gelu_dense_plain(*a),
            lambda a=a: F.linear(F.gelu(a[0]), a[1],
                                 None if a[2] is None else a[2].to(bf)),
            2 * M * 2 * C * N_out,
            M * 2 * C * 2 + N_out * 2 * C * 2 + M * N_out * 2
            + (N_out * 4 if has_bias else 0),
            split=dense_split(fk, M, 2 * C, w2, b2) if paths else None)

    for C, paths, bsz in ((1024, ("serve", "elev_serve"), B),
                          (1024, ("train", "finetune", "elev_finetune",
                                  "surf_sam", "masked"), B_TRAIN),
                          (768, ("mit_high",), B_TRAIN)):
        yield from prologue_cases(C, bsz * 4096, paths,
                                  (("norm1->q|kv", 3 * C, False),
                                   ("norm2->fc1", 2 * C, True)))
        yield gelu_case(C, bsz * 4096, C, paths)
    for has_bias in (False, True):
        tag = "ragged tile, " + ("bias" if has_bias else "no bias")
        yield from prologue_cases(
            384, 1024, (), ((f"{tag} N=C", 384, has_bias),
                            (f"{tag} N=2C", 768, has_bias),
                            (f"{tag} N=3C", 1152, has_bias)))
        for n_out in (384, 768, 1152):
            yield gelu_case(384, 1024, n_out, (), has_bias, f"{tag} ")

    # B7: the triplane sampled at the 32 x 1024 range points, batch 2, on
    # the coordinates TriplaneMAE.forward hands it (a synthetic batch's
    # range points, cropped and normalized; empty pixels at the origin),
    # at every raw point of the cloud (triplane_surf_sam's contrastive
    # loss: 36864 a sample, the padding rows at the origin, the points
    # beyond 25 m off the planes or on their edge cells), and, on no
    # path, on uniform coordinates in [-1.1, 1.1] and on ground-like ones
    # (a row of heavy cells on two planes).  The library chains are
    # F.grid_sample on the three planes and its autograd.
    from efficient_multimodal_perception_tpu_torch.tools.ab_trees import (
        b7_ground_coords, b7_path_coords, b7_raw_coords, b8_path_inputs)

    S, Cp = 128, 32
    tri = rn(B_TRAIN, 3, S, S, Cp)
    (lt,) = leaves(tri)
    plane_bytes = B_TRAIN * 3 * S * S * Cp * 2  # bf16, in and out
    P = 32 * 1024
    for label, coords, calls in (
            ("path", b7_path_coords(B_TRAIN, dev, S),
             {"train": 1, "surf_sam": 1, "masked": 1}),
            ("raw cloud", b7_raw_coords(B_TRAIN, dev, S), {"surf_sam": 1}),
            ("uniform", (torch.rand(B_TRAIN, P, 3, generator=g, device=dev)
                         * 2.2 - 1.1).contiguous(), {}),
            ("ground", b7_ground_coords(B_TRAIN, P, dev, S), {})):
        P = coords.shape[1]
        gs = rn(B_TRAIN, P, Cp)
        gs_nchw = gs.permute(0, 2, 1)[:, :, None]
        extra = b7_cell_stats(K, coords, S)
        if label == "raw cloud":
            extra["off_plane_share"] = float(
                (coords.abs() > 1).any(-1).float().mean())
        log(f"B7 {label} coordinates at batch {B_TRAIN}: " + json.dumps(extra))
        grids = [coords[:, None, :, list(ax)].to(bf).contiguous()
                 for ax in K.TRI_PLANE_AXES]

        def grid_chain(t, grids=grids):
            return sum(F.grid_sample(t[:, i].permute(0, 3, 1, 2), grids[i],
                                     mode="bilinear", padding_mode="zeros",
                                     align_corners=False) for i in range(3))

        shape = f"({B_TRAIN},3,{S},{S},{Cp}) at {P} {label} points"
        fk = lambda c=coords: K.triplane_sample(tri, c)  # noqa: E731
        fl = lambda gc=grid_chain: gc(tri)  # noqa: E731
        yield case(
            "triplane_sample", shape, calls, fk,
            lambda c=coords: K.triplane_sample_plain(tri, c), fl,
            2 * 12 * B_TRAIN * P * Cp,
            B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes,
            extra=extra, split=lambda fk=fk, fl=fl: dict(
                device_ms=device_ms(torch, fk),
                library_device_ms=device_ms(torch, fl)))

        def host_bwd(c=coords, gs=gs):
            """The kernel's order on the host, rounded to bf16 once."""
            return torch.from_numpy(K.triplane_sample_bwd_reference(
                c.cpu().numpy(), gs.float().cpu().numpy(), S)).to(bf)

        fk = lambda c=coords, gs=gs: K.triplane_sample_bwd(c, gs, S)  # noqa: E731,E501
        fl = lambda gc=grid_chain, gn=gs_nchw: torch.autograd.grad(  # noqa: E731,E501
            gc(lt), lt, gn)
        yield case(
            "triplane_sample_bwd", shape, calls, fk,
            lambda c=coords, gs=gs: K.triplane_sample_bwd_plain(c, gs, S),
            fl,
            2 * 12 * B_TRAIN * P * Cp,
            B_TRAIN * P * 3 * 4 + B_TRAIN * P * Cp * 2 + plane_bytes,
            extra=extra, deterministic=True, reference=host_bwd,
            split=lambda fk=fk, fl=fl: dict(
                device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                device_ms=device_ms(torch, fk),
                library_device_ms=device_ms(torch, fl)))

    # B8: the interact's gather-sum at serve batch 4 (bf16 and int8 serve)
    # and train batch 2 (pretrain forward and backward, fine-tune forward),
    # on the indices and validity that the interact makes of a synthetic
    # batch, so the valid share and the collisions are the path's own.
    # The library chains: the rows of the flattened (B N K, C) features
    # gathered with index_select (each index read once), masked and
    # summed in float32; index_add_ into float32 then a cast.
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_arrays)

    def lib_gather(f, i, v):
        bsz, n, k, c = f.shape
        keep = (v > 0) & (i >= 0) & (i < k)
        rows = i.clamp(0, k - 1) + k * torch.arange(
            bsz * n, device=dev, dtype=i.dtype).view(bsz, n, 1)
        sel = f.view(-1, c).index_select(0, rows.view(-1)).view(
            bsz, n, -1, c)
        return torch.where(keep[..., None], sel, 0).sum(1, dtype=f32)

    (h1, w1), C8 = cam_hw[1], widths[1]
    Kf = h1 * w1
    for bsz, fwd_calls, bwd_calls in (
            (B, {"serve": 1, "int8_serve": 1, "elev_serve": 1,
                 "int8_elev_serve": 1}, None),
            (B_TRAIN, {"train": 1, "finetune": 1, "elev_finetune": 1,
                       "surf_sam": 1, "masked": 1},
             {"train": 1, "surf_sam": 1, "masked": 1})):
        idx, active = b8_path_inputs(bsz, dev)
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
        shape = f"({bsz},{Ng},{Kf},{C8}) at {P} pixels"
        meta = bsz * Ng * P * 5  # int32 idx + uint8 valid
        fk = lambda f=feats, i=idx, v=valid: K.cam_gather_sum(f, i, v)  # noqa: E731
        fl = lambda f=feats, i=idx, v=valid: lib_gather(f, i, v)  # noqa: E731
        out_buf = torch.empty(bsz, P, C8, dtype=f32, device=dev)
        yield case(
            "cam_gather_sum", shape, fwd_calls, fk,
            lambda f=feats, i=idx, v=valid: K.cam_gather_sum_plain(f, i, v),
            fl, n_valid * C8, meta + n_rows * C8 * 2 + bsz * P * C8 * 4,
            extra=extra, split=lambda fk=fk, fl=fl, o=out_buf: dict(
                device_ms=device_ms(torch, fk),
                library_device_ms=device_ms(torch, fl),
                # PyTorch's fill of a tensor of the output's bytes: the
                # write rate the card gives a plain streaming store
                write_only_device_ms=device_ms(torch, o.zero_)))
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
            yield case(
                "cam_gather_sum", shape + ", half the valid pixels seen by "
                "two cameras", {},
                lambda f=feats, i=idx2, v=v2: K.cam_gather_sum(f, i, v),
                lambda f=feats, i=idx2, v=v2: K.cam_gather_sum_plain(f, i, v),
                lambda f=feats, i=idx2, v=v2: lib_gather(f, i, v),
                int(act2.sum()) * C8,
                meta + n_rows2 * C8 * 2 + bsz * P * C8 * 4, extra=extra2)
            del hits
            continue
        gr = rn(bsz, P, C8, dtype=f32)
        src = gr.to(bf).float()[:, None].expand(bsz, Ng, P, C8)[active]

        def lib_bwd(rows=rows, src=src, n=bsz * Ng * Kf):
            out = torch.zeros((n, C8), dtype=f32, device=dev)
            return out.index_add_(0, rows, src).to(bf)

        def host_sum(rows=rows, src=src, n=bsz * Ng * Kf):
            """The gradient on the host: float32 np.add.at in (b, n, p)
            order, rounded to bf16 once (the order the kernel sums in)."""
            out = np.zeros((n, C8), np.float32)
            np.add.at(out, rows.cpu().numpy(), src.cpu().numpy())
            return torch.from_numpy(out).to(bf).reshape(bsz, Ng, Kf, C8)

        fk = lambda g_=gr, i=idx, v=valid: K.cam_gather_sum_bwd(  # noqa: E731
            g_, i, v, Kf)
        yield case(
            "cam_gather_sum_bwd", shape, bwd_calls, fk,
            lambda g_=gr, i=idx, v=valid: K.cam_gather_sum_bwd_plain(
                g_, i, v, Kf),
            lib_bwd, n_valid * C8,
            # g: only the rows of pixels that some camera sees are read
            meta + int(active.any(1).sum()) * C8 * 4
            + bsz * Ng * Kf * C8 * 2, extra=extra, deterministic=True,
            reference=host_sum,
            split=lambda fk=fk, lib=lib_bwd: dict(
                device_ms_by_kernel=device_ms_by_kernel(torch, fk),
                device_ms=device_ms(torch, fk),
                library_device_ms_by_kernel=device_ms_by_kernel(torch, lib),
                library_device_ms=device_ms(torch, lib)))
        del hits

    # B9: the three plane MLPs at serve batch 4 over raw pools of the
    # full-width synthetic cloud (random point features pooled at the
    # cloud's own voxel indices, so the share of -inf cells is the path's)
    from efficient_multimodal_perception_tpu_torch.models.point_family import (
        voxelize_points)
    from efficient_multimodal_perception_tpu_torch.ops.scatter import (
        point_plane_pools_batch)

    mcfg = get_config("point_triplane_occ")["model"]
    pcfg = mcfg["point_triplane_projector"]
    N9 = pcfg["out_channels"]
    X, Y, Z = pcfg["grid_size"]

    def library_b9(x, w1, b1, w2, b2):
        z = torch.where(x == float("-inf"), torch.zeros((), dtype=bf,
                                                        device=dev), x)
        return F.linear(torch.relu(F.linear(z, w1, b1.to(bf))), w2,
                        b2.to(bf))

    def b9_backward(a, g9):
        """B9's backward at the train shapes: ``finite_mlp_bwd`` (torch
        products) held to autograd of the twin (relative Frobenius error
        of each gradient), timed beside autograd of the ``F.linear``
        chain, and its dx at the -inf entries."""
        got = K.finite_mlp_bwd(*a, g9)
        ins = [t.detach().clone().requires_grad_(True) for t in a]
        want = torch.autograd.grad(K.finite_mlp_plain(*ins), ins, g9)
        err = {n: rel_err(torch, x, y) for n, x, y in zip(
            ("dx", "dw1", "db1", "dw2", "db2"), got, want)}
        dx_at_neg_inf = float(got[0][a[0] == float("-inf")].float().abs()
                              .max())
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        del got, want
        lib_in = [t.detach().clone().requires_grad_(True) for t in a]
        lib_out = library_b9(*lib_in)

        def lib_bwd():
            return torch.autograd.grad(lib_out, lib_in, g9,
                                       retain_graph=True)

        def bwd():
            return K.finite_mlp_bwd(*a, g9)

        row = dict(bwd_rel_err_vs_twin_autograd=err,
                   bwd_dx_max_abs_at_neg_inf=dx_at_neg_inf,
                   bwd_finite=finite, bwd_ms=time_ms(torch, bwd, 10),
                   bwd_device_ms=device_ms(torch, bwd),
                   library_bwd_ms=time_ms(torch, lib_bwd, 10),
                   library_bwd_device_ms=device_ms(torch, lib_bwd))
        if not finite or dx_at_neg_inf != 0.0 or max(err.values()) > \
                TRAIN_GRAD_TOL:
            raise AssertionError(f"finite_mlp_bwd: {row}")
        return row

    # B9: the three plane MLPs at serve batch 4 and at train batch 2 over
    # raw pools of the full-width synthetic cloud (random point features
    # pooled at the cloud's own voxel indices, so the share of -inf cells
    # is the path's); at train batch 2 with its backward
    for bsz, paths in ((B, ("point_serve",)),
                       (B_TRAIN, ("point_train", "point_pretrain"))):
        cloud = synthetic_arrays(bsz, point_budget=36864, seed=1)
        idx, valid = voxelize_points(
            torch.from_numpy(cloud["points"]).to(dev),
            torch.from_numpy(cloud["points_valid"]).to(dev),
            mcfg["triplane_range"], mcfg["triplane_voxel_size"])
        pools = point_plane_pools_batch(rn(*valid.shape, N9), idx, valid,
                                        pcfg["grid_size"], pcfg["split"],
                                        raw=True)
        for label, t, (h, w) in zip(("xy", "yz", "xz"), pools,
                                    ((X, Y), (Y, Z), (X, Z))):
            x = t.reshape(bsz * h * w, -1)
            M, K9 = x.shape
            neg = x == float("-inf")
            extra = dict(neg_inf_share=float(neg.float().mean()),
                         empty_row_share=float(neg.all(-1).float().mean()))
            del neg
            a9 = (x, rn(N9, K9, scale=K9**-0.5), rn(N9, scale=0.1, dtype=f32),
                  rn(N9, N9, scale=N9**-0.5), rn(N9, scale=0.1, dtype=f32))
            if "point_train" in paths:
                extra.update(b9_backward(a9, rn(M, N9, scale=0.05)))
            fk = lambda a=a9: K.finite_mlp_fused(*a)  # noqa: E731
            fl = lambda a=a9: library_b9(*a)  # noqa: E731
            yield case(
                "finite_mlp_fused", f"{label} ({M},{K9})",
                {p: 1 for p in paths},
                fk, lambda a=a9: K.finite_mlp_plain(*a), fl,
                2 * M * K9 * N9 + 2 * M * N9 * N9,
                M * K9 * 2 + N9 * K9 * 2 + N9 * N9 * 2 + M * N9 * 2
                + 2 * N9 * 4,
                extra=extra, split=lambda fk=fk, fl=fl: dict(
                    device_ms=device_ms(torch, fk),
                    library_device_ms_by_kernel=device_ms_by_kernel(torch,
                                                                    fl),
                    library_device_ms=device_ms(torch, fl)))
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
        same = None
        if c["deterministic"]:  # a second call gives the same bits
            again = c["fk"]()
            pairs = zip(got, again) if c["check"] == "tuple" else [(got,
                                                                    again)]
            same = all(torch.equal(a, b) for a, b in pairs)
            del again
        exact = None
        if c["reference"] is not None:  # bit for bit to a host reference
            exact = torch.equal(got.cpu(), c["reference"]())
        del got, want
        ms = time_ms(torch, c["fk"], 10)
        plain_ms = time_ms(torch, c["fp"], 3, warmup=1)
        lib = (c["fl"]() if c["yardstick"]
               else dict(library_ms=time_ms(torch, c["fl"], 10)))
        b_ms, b_by = bound_ms(c["flops"], c["nbytes"], c["int8_ops"])
        row = dict(shape=label, calls=c["calls"], ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   rel_err=err, max_abs_err=max_abs, tol=c["tol"],
                   **lib, **c["extra"])
        if c["split"] is not None:
            row.update(c["split"]())
        if lse_err is not None:
            row["lse_max_abs_err"] = lse_err
        if same is not None:
            row["bit_identical_across_calls"] = same
        if exact is not None:
            row["bit_identical_to_host_reference"] = exact
        log(f"kernel {name} {label}: " + json.dumps(row))
        if same is False:
            raise AssertionError(f"{name} {label}: two calls differ")
        if exact is False:
            raise AssertionError(f"{name} {label}: differs from the host "
                                 "reference")
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


# The int8 GEMM's shapes (M, K, N): section 1 of tools/measure_int8.py
# (:73-76) and B10's two products at camera stage 0 of the serve path
# (786432 rows of C = 96, hidden 4C = 384)
INT8_GEMM_SHAPES = {
    "big": (4096, 4096, 4096),
    "epi1": (393216, 192, 768),
    "neck": (32768, 1024, 2048),
    "b10 stage0 fc1": (786432, 96, 384),
    "b10 stage0 fc2": (786432, 384, 96),
}


def int8_gemm_rates(torch, K):
    """``int8_dot`` (the int8 wgmma GEMM) at ``INT8_GEMM_SHAPES`` beside
    ``torch._int_mm`` and a bf16 ``torch.matmul`` of the same shape, both
    yardsticks only: device ms (profiler), event ms, TOP/s and TFLOP/s on
    device time; the int8 product's bound (int8 operands read and the
    int32 output written once, or its operations) and the kernel's share
    of it; the kernel's output equal to ``torch._int_mm``'s (both exact).
    One shape's operands at a time."""
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for name, (M, Kd, N) in INT8_GEMM_SHAPES.items():
        x = torch.randint(-127, 128, (M, Kd), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (N, Kd), generator=g, device="cuda",
                          dtype=torch.int8)
        equal = torch.equal(K.int8_dot(x, w), torch._int_mm(x, w.t()))
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ops = 2 * M * N * Kd
        b_ms, b_by = bound_ms(0, M * Kd + N * Kd + 4 * M * N, ops)
        row = dict(shape=[M, Kd, N], equal_to_int_mm=equal, bound_ms=b_ms,
                   bound_by=b_by)
        for tag, fn in (("int8_dot", lambda: K.int8_dot(x, w)),
                        ("int_mm", lambda: torch._int_mm(x, w.t())),
                        ("bf16_matmul", lambda: torch.matmul(xb, wb.t()))):
            dev = device_ms(torch, fn)
            row[tag] = dict(device_ms=dev, event_ms=time_ms(torch, fn, 10),
                            rate_t=ops / dev / 1e9)
        row["share_of_bound"] = b_ms / row["int8_dot"]["device_ms"]
        row["int8_over_bf16"] = (row["int8_dot"]["rate_t"]
                                 / row["bf16_matmul"]["rate_t"])
        row["int8_over_int_mm"] = (row["int8_dot"]["rate_t"]
                                   / row["int_mm"]["rate_t"])
        log(f"int8 GEMM {name}: " + json.dumps(row))
        if not equal:
            raise AssertionError(f"int8 GEMM {name}: differs from _int_mm")
        rows[name] = row
        del x, w, xb, wb
        torch.cuda.empty_cache()
    return rows


def run_probe(torch, K):
    """The int8 dot probe: ``tools/measure_int8.py``'s operands through
    ``int8_dot`` once (the phase's launches), held to the integer product
    computed on the host, exactly; then timed beside its twin and
    ``torch._int_mm`` (event ms, and device ms from the profiler for the
    kernel and ``torch._int_mm``), and the same GEMM at
    ``INT8_GEMM_SHAPES`` (:func:`int8_gemm_rates`).  Returns ``(launches,
    kernel row)``."""
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
    kern = lambda: K.int8_dot(x8, wt8)  # noqa: E731
    lib = lambda: torch._int_mm(x8, wt8.t())  # noqa: E731
    row = dict(shape="(256,128) x (128,256)", calls={"int8_probe": 1},
               ms=time_ms(torch, kern, 20),
               plain_ms=time_ms(torch, lambda: K.int8_dot_plain(x8, wt8), 20),
               library_ms=time_ms(torch, lib, 20),
               device_ms=device_ms(torch, kern),
               library_device_ms=device_ms(torch, lib),
               bound_ms=b_ms, bound_by=b_by, rel_err=0.0, max_abs_err=0.0,
               tol=0.0)
    log("kernel int8_dot: " + json.dumps(row))
    row["gemm"] = int8_gemm_rates(torch, K)
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
            library_ms=None if any(r["library_ms"] is None for r in rows)
            else tot("library_ms"),
            max_err=max(r["rel_err"] for r in rows),
            tol=max(r["tol"] for r in rows),
            per=f"one forward of each serve path (bf16 and int8, the "
                f"elevation model's too) at batch {B}, one pretrain, one "
                "fine-tune, one point train, one elevation fine-tune, one "
                "triplane_surf_sam and one point_triplane pretraining "
                "step, one file-backed fine-tune and one file-backed point "
                f"train step (phase 11) at batch {B_TRAIN}, one forward of "
                "each exported artifact (phase 12), one masked and one "
                "unmasked step with the colour head, one reconstructions, "
                "one triplane_occ triplane and one MiT high forward "
                "(phase 13), one static int8 forward, one int8 fine-tune "
                "and one quantization-aware step (phase 14) and the probe, "
                "summed over the kernel's calls",
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
    form) from seed 0, with :func:`draw_gamma_and_stats`."""
    from efficient_multimodal_perception_tpu_torch.serve import make_model

    model, _ = make_model(cfg_name, dtype=torch.bfloat16, device="cuda",
                          seed=0, int8=int8)
    return draw_gamma_and_stats(torch, model)


def draw_gamma_and_stats(torch, model):
    """``model`` with layer-scale gamma drawn from U(0.1, 1), so every
    ConvNeXt MLP branch reaches the output, and BatchNorm running
    statistics (the point family's) drawn as
    ``tests/test_full_parity.py`` draws them: means from N(0, 0.5),
    variances from U(0.5, 2)."""
    from efficient_multimodal_perception_tpu_torch.models.convnext import (
        ConvNeXtBlock)

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


# the profiler range around each ``ops.quant.int8_matmul`` call: the
# neck's and the head's dynamic int8 products (B10's are its own)
INT8_PRODUCTS = "int8_matmul (neck, head)"


def mark_int8_products(torch, fn):
    """``fn`` with every ``ops.quant.int8_matmul`` call inside it run in
    a ``record_function`` range named ``INT8_PRODUCTS``."""
    from efficient_multimodal_perception_tpu_torch.ops import quant

    def marked(*a, **kw):
        with torch.profiler.record_function(INT8_PRODUCTS):
            return plain(*a, **kw)

    def run(*a, **kw):
        quant.int8_matmul = marked
        try:
            return fn(*a, **kw)
        finally:
            quant.int8_matmul = plain

    plain = quant.int8_matmul
    return run


def set_int8(model, on) -> None:
    """Set every int8-capable module of ``model`` to ``on``: ``True``
    (dynamic), ``"static"`` (a static model's calibrated sites) or
    ``False``."""
    for m in model.modules():
        if hasattr(m, "int8"):
            m.int8 = on


def three_requests(keys, point_budget):
    """Requests of 1, 2 and 1 synthetic samples (seeds 1-3) with ``keys``."""
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_arrays)

    reqs = []
    for seed, n in ((1, 1), (2, 2), (3, 1)):
        a = synthetic_arrays(n, point_budget=point_budget, seed=seed)
        reqs.append({k: a[k] for k in keys})
    return reqs


def post_together(torch, K, url, worker, reqs, name):
    """POST every request of ``reqs`` to ``url``'s ``/predict`` at once,
    one thread each, the launch counts set to 0 just before: ``(replies,
    launches, forwards the worker ran, wall seconds)``; raises if any
    request failed."""
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
    return results, launches, forwards, wall


def run_serve(torch, K, cfg_name, per_forward, point_budget, int8=False):
    """Serve full-width ``cfg_name`` (``int8``: its int8 serving form)
    over HTTP at batch ``B``: three requests of 1, 2 and 1 samples
    (``point_budget`` points each), replies checked against the logits,
    launches per forward against ``per_forward``, kernels against their
    twins (with ``int8``, also the int8 logits against the bf16 logits of
    the same weights, unbounded), then timing and a profile of one
    forward.  Returns the launches of the requests' forwards."""
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch)
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
        reqs = three_requests(keys, point_budget)
        results, launches, forwards, wall = post_together(
            torch, K, url, worker, reqs, name)
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
        # the profile marks the neck's and head's int8 products
        marked = mark_int8_products(torch, infer) if int8 else infer
        prof = profile_call(torch, lambda: marked(batch),
                            ranges=(INT8_PRODUCTS,))
        log(f"{name} profile: " + json.dumps(prof))
        if int8:  # what B10's cached weight codes save a forward
            cached = K.cached_quantize_weight
            K.cached_quantize_weight = K.quantize_weight
            try:
                uncached = profile_call(torch, lambda: infer(batch))
            finally:
                K.cached_quantize_weight = cached
            log(f"{name} weight-code cache: " + json.dumps(dict(
                launches=prof["device_launches"], busy_ms=prof["busy_ms"],
                launches_quantizing_every_call=uncached["device_launches"],
                busy_ms_quantizing_every_call=uncached["busy_ms"])))
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
        if parts[0].endswith("_encoder") and parts[1] in (
                "stages", "downsample_layers"):
            return f"{parts[0]}.stage{parts[2]}"
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
    log("train optimizer step (the flat AdamW the trainer runs, and the "
        "per-parameter reference): " + json.dumps(compare_optimizers(
            torch, trainer.params, grads_k, trainer.optimizer.schedule)))
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
    log("train f32 GEMMs: " + json.dumps(
        trace_f32_gemms(torch, model, lambda: trainer.train_step(batch))))

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


def load_pretrained_encoder(torch, model, pretrain_path, name):
    """Partial-load the pretraining phase's checkpoint into ``model``:
    the encoder and neck must load whole and the MAE decoders be the
    only parts skipped.  Returns ``(encoder and neck tensor names, tensors
    adopted, tensors of the model)``."""
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        partial_load, restore_params_only)

    src = restore_params_only(pretrain_path)
    merged, n_ok, n_all = partial_load(model.state_dict(), src)
    model.load_state_dict(merged)
    frozen_names = [k for k in merged if k.split(".")[0] in ("encoder",
                                                             "neck")]
    skipped = sorted({k.split(".")[0] for k in src} - set(
        k.split(".")[0] for k in merged))
    log(f"{name}: partial restore adopted {n_ok}/{n_all} tensors "
        f"(encoder + neck {len(frozen_names)}; not in the model: "
        f"{skipped})")
    whole = all(torch.equal(merged[k].cpu(), src[k]) for k in frozen_names)
    if n_ok != len(frozen_names) or not whole or skipped != [
            "camera_decoder", "lidar_decoder"]:
        raise AssertionError(f"{name}: the encoder and neck did not load "
                             "whole, or the MAE decoders were not skipped")
    return frozen_names, n_ok, n_all


def finetune_check(torch, K, model, trainer, batch, name, per_step=None):
    """The fine-tune's kernels against their twins on ``batch`` (the loss
    within ``TRAIN_LOSS_TOL``, each head gradient within
    ``TRAIN_GRAD_TOL``), then one step through ``Trainer.train_step``,
    whose launches must be ``per_step`` (default
    ``finetune_launches(model)``).  Returns ``(launches, the step's
    logs)``."""
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        set_kernels)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        loss_and_grads)

    named = trainer.named
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
    log(f"{name} check: " + json.dumps(dict(
        loss_kernels=float(loss_k), loss_twins=float(loss_p),
        loss_rel_err=loss_err, grad_rel_err=grad_err, finite=finite,
        bounds=dict(loss_rel_err_max=TRAIN_LOSS_TOL,
                    grad_rel_err_max=TRAIN_GRAD_TOL))))
    if not finite:
        raise AssertionError(f"{name}: non-finite loss or gradients")
    if loss_err > TRAIN_LOSS_TOL or max(grad_err.values()) > TRAIN_GRAD_TOL:
        raise AssertionError(f"{name}: kernels vs twins {loss_err}, "
                             f"{grad_err}")
    del grads_k, grads_p

    per_step = finetune_launches(model) if per_step is None else per_step
    torch.cuda.synchronize()
    K.reset_launches()
    logs = trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {k: per_step.get(k, 0) for k in K.LAUNCHES}
    log(f"{name}: launches in one step {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != {want}")
    return launches, logs


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
        build_model)
    from efficient_multimodal_perception_tpu_torch.train.evaluator import (
        evaluate, make_val_batches)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer)

    t0 = time.perf_counter()
    cfg = get_config("triplane_occ")
    model = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16,
                        seed=0)
    frozen_names, n_ok, n_all = load_pretrained_encoder(
        torch, model, pretrain_path, "finetune")
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

    # kernels vs twins on the batch, then three optimizer steps; the
    # first counts launches
    before = {n: p.detach().clone() for n, p in named}
    launches, first = finetune_check(torch, K, model, trainer, batch,
                                     "finetune")
    steps = [first]
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


# ---------------------------------------------------------------------------
# phase 8: point train
# ---------------------------------------------------------------------------

def point_train_launches(model):
    """Kernel launches of one ``point_triplane_occ`` training step, derived
    from the model (PER_POINT_TRAIN_STEP): a ConvNeXt block with no
    drop-path (the frozen stage 0) is one K1, and in the triplane encoder,
    whose input trains, its backward one B5 backward; every other block is
    one B5 forward and one B5 backward (the wide variant at C = 768); the
    triplane encoder runs once per plane; each plane MLP is one B9 (its
    backward is torch products)."""
    out = {"finite_mlp_fused": 3}
    encoder_launches(out, model.camera_encoder, 1, False)
    encoder_launches(out, model.triplane_encoder, 3, True)
    return out


def encoder_launches(out, enc, runs, input_trains, masked=False):
    """Adds to ``out`` the launches of a training ConvNeXt ``enc`` run
    ``runs`` times: a block with no drop-path (a frozen stage) is one K1,
    or with SparK masking (``masked``) one B5 forward, and where the
    encoder's input trains (``input_trains``) its backward one B5
    backward; every other block is one B5 forward and one B5 backward (the
    wide variant at C = 768)."""
    from efficient_multimodal_perception_tpu_torch.ops.kernels import (
        NARROW_WIDTHS)

    def add(k, n):
        out[k] = out.get(k, 0) + n

    for stage in enc.stages:
        for blk in stage:
            bwd = ("post_epilogue_bwd"
                   if blk.dwconv.in_channels in NARROW_WIDTHS
                   else "post_epilogue_bwd_wide")
            if blk.drop_path_rate == 0.0:
                add("epilogue_fused" if masked else "convnext_block_fused",
                    runs)
                if input_trains:
                    add(bwd, runs)
            else:
                add("epilogue_fused", runs)
                add(bwd, runs)


def bn_stats(model):
    """Copies of every BatchNorm's running statistics."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@contextlib.contextmanager
def batch_norms_on_running_stats():
    """The point model's BatchNorms (the projector's and the FPN's) on
    their running statistics in a training forward, drop-path still
    drawn: its gradients without the batch statistics' backward."""
    from efficient_multimodal_perception_tpu_torch.models import (
        fpn, point_projector)

    conv, norm = fpn._ConvModule.forward, point_projector.MaskedBatchNorm.forward
    fpn._ConvModule.forward = lambda self, x, train=False: conv(self, x)
    point_projector.MaskedBatchNorm.forward = (
        lambda self, x, valid=None, train=False: norm(self, x, valid))
    try:
        yield
    finally:
        fpn._ConvModule.forward = conv
        point_projector.MaskedBatchNorm.forward = norm


@contextlib.contextmanager
def fpn_bn_kept_shares(torch, shares):
    """Appends to ``shares``, for each FPN BatchNorm on batch statistics
    in the backward run inside, ``|kept| / |g|``: ``g`` the gradient at
    its normalized input ``xhat`` and ``kept = g - mean(g) - xhat
    mean(g xhat)`` (means per channel over (B, H, W)), the part its
    backward passes on; the rest it subtracts."""
    from efficient_multimodal_perception_tpu_torch.models import fpn

    orig = fpn.batch_norm_train

    def recording(x, bn, dtype):
        y = orig(x, bn, dtype)
        if y.requires_grad:
            xf = x.detach().float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            xhat = (xf - mean) * torch.rsqrt(var + bn.eps)
            w = bn.weight.detach().float()

            def hook(gy):
                g = gy.float() * w
                kept = g - g.mean(dims) - xhat * (g * xhat).mean(dims)
                shares.append(float(torch.linalg.vector_norm(kept)
                                    / torch.linalg.vector_norm(g)))

            y.register_hook(hook)
        return y

    fpn.batch_norm_train = recording
    try:
        yield
    finally:
        fpn.batch_norm_train = orig


def fpn_input_grads(model, out):
    """A forward pre-hook on ``model.fpn`` that appends to ``out`` the
    float32 gradient of each input (the encoder's four stage outputs, a
    plane at a time) as the backward reaches it; returns its handle."""
    def pre(mod, args):
        for x in args[0]:
            if x.requires_grad:
                out.append(None)
                x.register_hook(lambda g, i=len(out) - 1: out.__setitem__(
                    i, g.detach().float()))
    return model.fpn.register_forward_pre_hook(pre)


def mean_share(torch, g):
    """``|mean| / |g|`` of a channels-last gradient, the mean per channel
    over every other axis: the part common to all positions."""
    dims = tuple(range(g.dim() - 1))
    m = g.mean(dims).expand_as(g)
    return float(torch.linalg.vector_norm(m) / torch.linalg.vector_norm(g))


def optimizer_launches(torch, opt, grads):
    """Kernels and copies one ``opt.step(grads)`` launches, and their
    device ms (``torch.profiler``; after one warm-up step; a trace without
    device events is taken again, up to ``PROFILE_TRIES`` times, then the
    step is timed with CUDA events and ``launches`` is None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt.step(grads)
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt.step(grads)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        if busy > 0:
            return dict(launches=sum(e.count for e in ev), device_ms=busy)
        log(f"profiler: no device time in a trace (attempt {attempt + 1} "
            f"of {PROFILE_TRIES})")
    return dict(launches=None, device_ms=time_ms(
        torch, lambda: opt.step(grads), 1, warmup=0), blind=EVENT_FALLBACK)


def compare_optimizers(torch, params, grads, schedule):
    """Launches and device ms of one step of the flat AdamW and of the
    per-parameter reference AdamW over copies of ``params`` and the same
    grads."""
    from efficient_multimodal_perception_tpu_torch.train.flat_opt import (
        FlatAdamW)
    from efficient_multimodal_perception_tpu_torch.train.trainer import AdamW

    out = {}
    for name, cls in (("flat", FlatAdamW), ("per_parameter", AdamW)):
        copies = [p.detach().clone() for p in params]
        out[name] = optimizer_launches(torch, cls(copies, schedule), grads)
        del copies
    out["tensors"] = len(params)
    return out


def run_point_train(torch, K):
    """Full-width ``point_triplane_occ`` trained at batch ``B_TRAIN`` with
    the flat AdamW: kernels vs twins (losses, gradients by group, the
    BatchNorm running statistics after each), launch counts of one step
    against PER_POINT_TRAIN_STEP, three steps (trainable tensors moved,
    frozen ones bit-identical, running statistics moved), the optimizer's
    launches flat vs per parameter, timing and a profile, then the
    checkpoint: evaluated (CE / IoU / mIoU) and served from
    ``serve.make_server(checkpoint=...)``."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch, synthetic_arrays, synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model, set_kernels)
    from efficient_multimodal_perception_tpu_torch.serve import (
        batch_keys, make_server)
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        save_checkpoint)
    from efficient_multimodal_perception_tpu_torch.train.evaluator import (
        evaluate, make_val_batches)
    from efficient_multimodal_perception_tpu_torch.train.flat_opt import (
        FlatAdamW)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer, loss_and_grads)

    name = "point train"
    t0 = time.perf_counter()
    cfg = get_config("point_triplane_occ")
    model = draw_gamma_and_stats(torch, build_model(
        cfg["model"], device="cuda", dtype=torch.bfloat16, seed=0))
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    if not isinstance(trainer.optimizer, FlatAdamW):
        raise AssertionError("the trainer's optimizer is not FlatAdamW")
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    budget = cfg["data"]["point_budget"]
    batch = synthetic_batch(B_TRAIN, point_budget=budget, with_occ=True,
                            seed=0, device="cuda")
    stats0 = bn_stats(model)
    # the float32 twins: the same weights and statistics, compute in f32
    m32 = build_model(cfg["model"], device="cuda", dtype=torch.float32,
                      seed=0)
    m32.load_state_dict(model.state_dict())
    trainable = {n for n, _ in named}
    for n, p in m32.named_parameters():
        p.requires_grad_(n in trainable)
    params32 = [dict(m32.named_parameters())[n] for n, _ in named]
    log(f"{name}: model, trainer and batch up in "
        f"{time.perf_counter() - t0:.1f} s; {len(named)} trainable and "
        f"{len(frozen)} frozen parameter tensors, {len(stats0)} BatchNorm "
        "statistics")

    # kernels, bf16 twins and f32 twins: same batch, drop-path draws and
    # statistics; with batch statistics, then on the running ones
    groups = grad_groups(named)

    def run(m, params, kernels):
        m.load_state_dict(stats0, strict=False)
        set_kernels(m, kernels)
        at_fpn = []  # the gradients at the FPN's inputs, per plane
        hook = None if kernels else fpn_input_grads(m, at_fpn)
        losses, _, grads = loss_and_grads(m, params, batch,
                                          trainer.generator(0))
        if hook is not None:
            hook.remove()
        flat = [gr.detach().float().flatten() for gr in grads]
        del grads
        return ({k: float(v) for k, v in losses.items()}, bn_stats(m),
                {k: torch.cat([flat[i] for i in idx])
                 for k, idx in groups.items()}, at_fpn)

    shares = []
    runs = {"kernels": run(model, trainer.params, True)}
    with fpn_bn_kept_shares(torch, shares):
        runs["twins"] = run(model, trainer.params, False)
    runs["float32"] = run(m32, params32, False)
    with batch_norms_on_running_stats():
        held = {"kernels": run(model, trainer.params, True),
                "twins": run(model, trainer.params, False),
                "float32": run(m32, params32, False)}
    set_kernels(model, True)
    model.load_state_dict(stats0, strict=False)
    del m32, params32
    torch.cuda.synchronize()
    (losses_k, stats_k, grads_k, _), (losses_p, stats_p, grads_p, _) = (
        runs["kernels"], runs["twins"])
    loss_err = {k: abs(losses_k[k] - losses_p[k]) / abs(losses_p[k])
                for k in losses_p}
    stats_err = {k: rel_err(torch, stats_k[k], stats_p[k]) for k in stats0}
    finite = all(bool(torch.isfinite(v).all()) for v in grads_k.values())

    def vs_f32(r):
        g32 = r["float32"][2]
        return {w: {k: rel_err(torch, r[w][2][k], g32[k]) for k in g32}
                for w in ("kernels", "twins")}

    def at_fpn(r):
        """Per FPN input: the bf16 twins' gradient error against the
        float32 run's, and the float32 gradient's per-channel mean
        share."""
        return dict(
            rel_err_twins_vs_float32=[
                round(rel_err(torch, a, b), 4)
                for a, b in zip(r["twins"][3], r["float32"][3])],
            mean_share_float32=[round(mean_share(torch, b), 4)
                                for b in r["float32"][3]])

    err, err_held = vs_f32(runs), vs_f32(held)
    log(f"{name} check: " + json.dumps(dict(
        losses={w: r[0] for w, r in runs.items()}, loss_rel_err=loss_err,
        stats_rel_err_max=max(stats_err.values()), grads_finite=finite,
        grad_rel_err_vs_float32=err,
        grad_rel_err_kernels_vs_twins={
            k: rel_err(torch, grads_k[k], grads_p[k]) for k in grads_p},
        running_stats_bn=dict(
            losses={w: r[0] for w, r in held.items()},
            grad_rel_err_vs_float32=err_held),
        grad_at_fpn_inputs=dict(batch_stats=at_fpn(runs),
                                running_stats=at_fpn(held)),
        grad_norm_float32=dict(
            batch_stats={k: float(v.norm())
                         for k, v in runs["float32"][2].items()},
            running_stats={k: float(v.norm())
                           for k, v in held["float32"][2].items()}),
        fpn_bn_backward_kept_share=shares,
        bounds=dict(loss_rel_err_max=TRAIN_LOSS_TOL,
                    stats_rel_err_max=TRAIN_LOSS_TOL,
                    grad_rel_err_vs_float32=f"kernels' <= {TWIN_FACTOR} x "
                                            "twins', by group"))))
    if not finite or not all(math.isfinite(v) for v in losses_k.values()):
        raise AssertionError(f"{name}: non-finite losses or gradients")
    if max(loss_err.values()) > TRAIN_LOSS_TOL:
        raise AssertionError(f"{name}: loss error {loss_err}")
    bad = {k: v for k, v in stats_err.items() if v > TRAIN_LOSS_TOL}
    for label, e in (("batch statistics", err), ("running statistics",
                                                 err_held)):
        bad.update({f"{k} ({label})": (v, e["twins"][k])
                    for k, v in e["kernels"].items()
                    if v > TWIN_FACTOR * e["twins"][k]})
    if bad:
        raise AssertionError(f"{name}: over bound: {bad}")
    del runs, held, grads_p, stats_k, stats_p
    # the optimizer's launches on real gradients
    _, _, grads_k = loss_and_grads(model, trainer.params, batch,
                                   trainer.generator(0))
    model.load_state_dict(stats0, strict=False)
    opt_cmp = compare_optimizers(torch, trainer.params, grads_k,
                                 trainer.optimizer.schedule)
    log(f"{name} optimizer step: " + json.dumps(opt_cmp))
    del grads_k

    # three optimizer steps through the CLI's step function
    per_step = point_train_launches(model)
    before = {n: p.detach().clone() for n, p in named}
    steps = []
    torch.cuda.synchronize()
    K.reset_launches()
    steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {k: per_step.get(k, 0) for k in K.LAUNCHES}
    log(f"{name}: launches in one step {launches} (expected "
        f"PER_POINT_TRAIN_STEP {want})")
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != {want}")
    for _ in range(2):
        steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    logs = [{k: float(v) for k, v in st.items()} for st in steps]
    log(f"{name} steps: " + json.dumps(logs))
    if not all(math.isfinite(v) for st in logs for v in st.values()):
        raise AssertionError(f"{name}: non-finite step logs")
    still = [n for n, p in named if torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    stats = bn_stats(model)
    unmoved = [k for k in stats0 if torch.equal(stats[k], stats0[k])]
    log(f"{name}: {len(named) - len(still)}/{len(named)} trainable tensors "
        f"moved; {len(changed)} of {len(frozen)} frozen tensors changed; "
        f"{len(stats0) - len(unmoved)}/{len(stats0)} BatchNorm statistics "
        "moved")
    if still or changed or unmoved:
        raise AssertionError(f"{name}: unmoved {still[:5]}, changed frozen "
                             f"{changed[:5]}, unmoved statistics {unmoved}")

    # timing, peak memory, profile
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: trainer.train_step(batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"{name} timing: " + json.dumps(dict(
        ms_per_step=ms, batch=B_TRAIN, samples_per_s=B_TRAIN / ms * 1e3,
        peak_memory_gb=peak / 1e9)))
    log(f"{name} profile: " + json.dumps(profile_call(
        torch, lambda: trainer.train_step(batch))))

    # the checkpoint: evaluated, then served through serve.py --checkpoint
    t1 = time.perf_counter()
    path = save_checkpoint(os.path.join(CKPT_DIR, "point"), trainer.step,
                           trainer.state_dict())
    log(f"{name}: saved {path} ({os.path.getsize(path) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    metrics = evaluate(model, make_val_batches(cfg["data"], B_TRAIN, 2,
                                               device="cuda")(),
                       cfg["model"]["type"],
                       cfg["model"]["decoder"]["num_classes"],
                       cfg["model"].get("class_names") or ())
    log(f"{name} eval ({2 * B_TRAIN} samples, "
        f"{time.perf_counter() - t1:.1f} s): CE {metrics['ce']:.4f}, "
        f"IoU {metrics['iou']:.4f}, mIoU {metrics['miou']:.4f}; "
        + json.dumps(metrics))
    if not all(math.isfinite(metrics[k]) for k in ("ce", "iou", "miou")):
        raise AssertionError(f"{name} eval: {metrics}")
    server, worker = make_server("point_triplane_occ", checkpoint=path,
                                 dtype=torch.bfloat16, port=0, batch_size=1,
                                 device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        a = synthetic_arrays(1, point_budget=budget, seed=11)
        req = {k: a[k] for k in batch_keys(model)}
        reply = post(f"http://127.0.0.1:{server.server_address[1]}/predict",
                     req)
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
    with torch.inference_mode():
        logits = model(arrays_to_batch(req, "cuda"))[0]
    same = float((logits.argmax(-1).to(torch.int8).cpu().numpy()
                  == reply).mean())
    log(f"{name}: served from {os.path.basename(path)}: reply "
        f"{reply.shape} {reply.dtype}, equal to the logits' argmax on "
        f"{same:.6f} of voxels")
    os.remove(path)
    if reply.shape != (1, 99, 99, 16) or same != 1.0:
        raise AssertionError(f"{name}: served reply differs from the "
                             "logits' argmax")
    return launches


# ---------------------------------------------------------------------------
# phase 9: elevation
# ---------------------------------------------------------------------------

# the profiler range of the elevation head's forward (the 3-D collapse and
# the U-Net: PyTorch operators only, so the profiler gives the range all
# their device time); the encoder and neck are profiled on their own
ELEV_HEAD = "elev head forward (collapse + U-Net)"


@contextlib.contextmanager
def elev_head_range(torch, model):
    """``model.decoder``'s forward runs inside the profiler range
    ``ELEV_HEAD`` while the block runs."""
    head = model.decoder.forward

    def marked(*a, **kw):
        with torch.profiler.record_function(ELEV_HEAD):
            return head(*a, **kw)

    model.decoder.forward = marked
    try:
        yield
    finally:
        del model.decoder.forward


def elev_report(torch, name, model, fn, batch, ms, peak, unit):
    """Print the timing line (ms per batch or step, samples/s, peak
    memory), the profile of one call of ``fn`` and its device ms by part:
    the frozen encoder and neck (a profile of ``model.triplane(batch)``
    alone), the head's forward (``ELEV_HEAD``), and the rest (the readout,
    the loss, the head's backward and the optimizer)."""
    n = batch.img.shape[0]
    log(f"{name} timing: " + json.dumps({
        f"ms_per_{unit}": ms, "batch": n, "samples_per_s": n / ms * 1e3,
        "peak_memory_gb": peak / 1e9}))
    with elev_head_range(torch, model):
        prof = profile_call(torch, fn, ranges=(ELEV_HEAD,))
    enc = profile_call(torch, lambda: model.triplane(batch))
    if "blind" in prof or "blind" in enc:
        split = None  # no device time by range: not measured
    elif ELEV_HEAD not in prof["ranges"]:
        raise AssertionError(f"{name}: the profile lacks the head's range")
    else:
        split = {"encoder_and_neck": enc["busy_ms"],
                 "head_forward": prof["ranges"][ELEV_HEAD]["device_ms"]}
        split["rest"] = prof["busy_ms"] - sum(split.values())
    log(f"{name} profile: " + json.dumps(prof))
    log(f"{name} device ms: " + json.dumps(dict(
        busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
        idle_share=prof["idle_share"], by_part=split)))


def run_elev_serve(torch, K, int8):
    """Serve full-width ``triplane_elev`` (``int8``: its int8 serving form)
    over HTTP at batch ``B``: three requests of 1, 2 and 1 samples whose
    replies must be float32 ``(n, 100, 100)`` heights equal bit for bit to
    the forward of the packed batch, launches per forward as
    ``triplane_occ``'s, kernels against their twins on the heights (with
    ``int8``, also the int8 heights against the bf16 heights of the same
    weights, unbounded), then timing and a profile.  Returns the
    launches of the requests' forwards."""
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        set_kernels)
    from efficient_multimodal_perception_tpu_torch.serve import (
        BATCH_KEYS, build_infer_fn, make_server)

    name = "elev int8 serve" if int8 else "elev serve"
    per_forward = PER_INT8_FORWARD if int8 else PER_FORWARD
    t0 = time.perf_counter()
    model = seeded_serving_model(torch, "triplane_elev", int8)
    server, worker = make_server("triplane_elev", model=model, port=0,
                                 batch_size=B, coalesce_ms=2000.0,
                                 device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    log(f"{name}: model + server up in {time.perf_counter() - t0:.1f} s")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        reqs = three_requests(BATCH_KEYS, 4096)
        results, launches, forwards, wall = post_together(
            torch, K, url, worker, reqs, name)
        want = {k: per_forward.get(k, 0) * forwards for k in K.LAUNCHES}
        log(f"{name}: 3 requests in {forwards} forward(s), {wall:.3f} s; "
            f"launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")
        for r, req in zip(results, reqs):
            n = len(req["img"])
            if r.shape != (n, 100, 100) or r.dtype != np.float32:
                raise AssertionError(f"{name}: reply {r.shape} {r.dtype}, "
                                     f"expected ({n}, 100, 100) float32")

        packed = {k: np.concatenate([r[k] for r in reqs]) for k in BATCH_KEYS}
        batch = arrays_to_batch(packed, "cuda")
        infer = build_infer_fn(model)
        hk = infer(batch)
        set_kernels(model, False)
        hp = infer(batch)
        set_kernels(model, True)
        served = np.concatenate(results)
        same = bool(np.array_equal(hk.cpu().numpy(), served))
        err = rel_err(torch, hk, hp)
        finite = bool(torch.isfinite(hk).all())
        log(f"{name} check: " + json.dumps(dict(
            served_equals_forward=same, height_rel_err=err,
            height_max_abs_err=float((hk - hp).abs().max()),
            height_max_abs=float(hp.abs().max()), finite=finite,
            bounds=dict(height_rel_err_max=LOGIT_REL_TOL))))
        if not finite or not same:
            raise AssertionError(f"{name}: served heights differ from the "
                                 "forward's")
        if err > LOGIT_REL_TOL:
            raise AssertionError(f"{name}: kernels vs twins: rel err {err}")
        if int8:
            set_int8(model, False)
            hb = infer(batch)
            set_int8(model, True)
            log(f"{name} vs bf16 (quantization error, unbounded): "
                + json.dumps(dict(height_rel_err=rel_err(torch, hk, hb),
                                  height_max_abs_err=float(
                                      (hk - hb).abs().max()))))
            del hb
        del hk, hp

        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: infer(batch), 5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        elev_report(torch, name, model, lambda: infer(batch), batch, ms,
                    peak, "batch")
        return launches
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()


def run_elev_finetune(torch, K, pretrain_path):
    """Full-width ``triplane_elev`` partial-loaded from the pretraining
    phase's checkpoint (encoder and neck whole, frozen) and fine-tuned at
    batch ``B_TRAIN``: launches of one step (forward kernels only), three
    steps through ``Trainer.train_step`` (every head tensor and running
    statistic moved, the encoder and neck bit-identical), timing and a
    profile; then the checkpoint saved, evaluated (masked MSE over two
    synthetic batches) and served by ``serve.make_server(checkpoint=...)``,
    whose reply must equal the trained model's heights bit for bit."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        arrays_to_batch, synthetic_arrays, synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model)
    from efficient_multimodal_perception_tpu_torch.serve import (
        BATCH_KEYS, build_infer_fn, make_server)
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        save_checkpoint)
    from efficient_multimodal_perception_tpu_torch.train.evaluator import (
        evaluate, make_val_batches)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer)

    name = "elev finetune"
    t0 = time.perf_counter()
    cfg = get_config("triplane_elev")
    model = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16,
                        seed=0)
    frozen_names, _, _ = load_pretrained_encoder(torch, model, pretrain_path,
                                                 name)
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    if (sorted(frozen) != sorted(k for k in frozen_names
                                 if k in dict(model.named_parameters()))
            or not named or not all(n.startswith("decoder.")
                                    for n, _ in named)):
        raise AssertionError(f"{name}: trainable tensors are not the head")
    batch = synthetic_batch(B_TRAIN, point_budget=cfg["data"]["point_budget"],
                            with_elev=True, seed=0, device="cuda")
    stats0 = bn_stats(model)
    log(f"{name}: model, trainer and batch up in "
        f"{time.perf_counter() - t0:.1f} s; {len(named)} trainable and "
        f"{len(frozen)} frozen parameter tensors, {len(stats0)} running "
        "statistics")

    per_step = finetune_launches(model)
    before = {n: p.detach().clone() for n, p in named}
    steps = []
    torch.cuda.synchronize()
    K.reset_launches()
    steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    launches.update({f"{k} VJP": v for k, v in K.VJP_CALLS.items()})
    want = {k: per_step.get(k, 0) for k in launches}
    log(f"{name}: launches in one step {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    for _ in range(2):
        steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    logs = [{k: float(v) for k, v in st.items()} for st in steps]
    log(f"{name} steps: " + json.dumps(logs))
    if not all(math.isfinite(v) for st in logs for v in st.values()):
        raise AssertionError(f"{name}: non-finite step logs")
    still = [n for n, p in named if torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    stats = bn_stats(model)
    unmoved = [k for k in stats0 if torch.equal(stats[k], stats0[k])]
    log(f"{name}: {len(named) - len(still)}/{len(named)} head tensors moved; "
        f"{len(changed)} of {len(frozen)} frozen tensors changed; "
        f"{len(stats0) - len(unmoved)}/{len(stats0)} running statistics "
        "moved")
    if still or changed or unmoved:
        raise AssertionError(f"{name}: unmoved {still[:5]}, changed frozen "
                             f"{changed[:5]}, unmoved statistics "
                             f"{unmoved[:5]}")

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: trainer.train_step(batch), 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    elev_report(torch, name, model, lambda: trainer.train_step(batch), batch,
                ms, peak, "step")

    # the checkpoint: evaluated, then served through serve.py --checkpoint
    t1 = time.perf_counter()
    path = save_checkpoint(os.path.join(CKPT_DIR, "elev"), trainer.step,
                           trainer.state_dict())
    log(f"{name}: saved {path} ({os.path.getsize(path) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    metrics = evaluate(model, make_val_batches(
        cfg["data"], B_TRAIN, 2, with_occ=False, with_elev=True,
        device="cuda")(), cfg["model"]["type"])
    log(f"{name} eval ({2 * B_TRAIN} samples, "
        f"{time.perf_counter() - t1:.1f} s): masked MSE {metrics['mse']:.4f}; "
        + json.dumps(metrics))
    if not math.isfinite(metrics["mse"]):
        raise AssertionError(f"{name} eval: {metrics}")
    server, worker = make_server("triplane_elev", checkpoint=path,
                                 dtype=torch.bfloat16, port=0, batch_size=1,
                                 device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        a = synthetic_arrays(1, point_budget=4096, seed=11)
        req = {k: a[k] for k in BATCH_KEYS}
        reply = post(f"http://127.0.0.1:{server.server_address[1]}/predict",
                     req)
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
    heights = build_infer_fn(model)(arrays_to_batch(req, "cuda")).cpu().numpy()
    same = bool(np.array_equal(reply, heights))
    log(f"{name}: served from {os.path.basename(path)}: reply {reply.shape} "
        f"{reply.dtype}, equal to the trained model's heights: {same}")
    os.remove(path)
    if reply.shape != (1, 100, 100) or reply.dtype != np.float32 or not same:
        raise AssertionError(f"{name}: served reply differs from the heights")
    return launches


# ---------------------------------------------------------------------------
# phase 10: pretraining triplane_surf_sam and point_triplane
# ---------------------------------------------------------------------------

def surf_sam_launches(model):
    """Kernel launches of one ``triplane_surf_sam`` training step, derived
    from the model: both ConvNeXt encoders as :func:`encoder_launches`
    counts them (the camera stage-1 features that B8 gathers train, so
    the lidar encoder's input does), each MiT block of the neck one
    attention both ways, two LN prologues and one GELU prologue, B7 both
    ways twice (the range points, then every raw point for the
    contrastive loss) and B8 both ways."""
    from efficient_multimodal_perception_tpu_torch.models.mit import MiTBlock

    blocks = sum(isinstance(m, MiTBlock) for m in model.neck.modules())
    out = {"attention": blocks, "attention_bwd": blocks,
           "ln_dense_fused": 2 * blocks, "gelu_dense_fused": blocks,
           "triplane_sample": 2, "triplane_sample_bwd": 2,
           "cam_gather_sum": 1, "cam_gather_sum_bwd": 1}
    encoder_launches(out, model.encoder.camera_encoder, 1, False)
    encoder_launches(out, model.encoder.lidar_encoder, 1, True)
    return out


def point_pretrain_launches(model):
    """Kernel launches of one ``point_triplane`` training step: the point
    train's (:func:`point_train_launches`) and the camera decoder's two
    MiT blocks, one attention each both ways (head dim 24)."""
    from efficient_multimodal_perception_tpu_torch.models.mit import MiTBlock

    blocks = sum(isinstance(m, MiTBlock)
                 for m in model.camera_decoder.modules())
    out = point_train_launches(model)
    out.update(attention=blocks, attention_bwd=blocks)
    return out


def host_syncs(torch, fn, top=6):
    """The host synchronisations one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: their count
    and the Python lines (file:line) that made the most."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    lines = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    return dict(count=sum(lines.values()),
                by_line=dict(lines.most_common(top)))


def run_pretrain(torch, K, cfg_name, launches_of, float32_groups=(),
                 cfg_options=(), label=None, no_grad=None):
    """Full-width ``cfg_name`` (``triplane_surf_sam``, ``point_triplane``
    or, with ``cfg_options``, masked ``triplane_range_cam``) in bf16
    compute with float32 parameters, seeded weights and gamma from U(0.1,
    1) (BatchNorm running statistics drawn), trained at batch ``B_TRAIN``
    on a synthetic batch (36864 raw points a sample, 32768 range points):
    kernels vs twins on the same batch and the same drop-path, loss and
    mask draws (the trainer's generators of step 0), the losses within
    ``TRAIN_LOSS_TOL`` and each gradient group within ``TRAIN_GRAD_TOL``
    (phase 5's bounds) except the groups named in ``float32_groups``
    (``"*"``: every group), which are held by phase 8's rule instead:
    each run's gradient against a float32 twin run, the kernels' error
    within ``TWIN_FACTOR`` of the bf16 twins'.  The trainable tensors
    that take no gradient must be exactly those whose names start with
    ``no_grad`` (None: there are none); a group of them is compared as
    None in every run.  Then three steps through ``Trainer.train_step``,
    the first launching ``launches_of(model)``, the masks each step drew
    (a masking model) pairwise different, every trainable tensor with a
    gradient moved, no frozen one, every running statistic moved; ms a
    step, samples/s, peak memory, a profiled step and the host
    synchronisations of a step.  Returns the launches, model, trainer
    and batch (a namespace)."""
    from efficient_multimodal_perception_tpu_torch.configs import (
        apply_overrides, get_config)
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model, set_kernels)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer, loss_and_grads)

    name = label or f"{cfg_name} train"
    t0 = time.perf_counter()
    cfg = apply_overrides(get_config(cfg_name), list(cfg_options))
    model = draw_gamma_and_stats(torch, build_model(
        cfg["model"], device="cuda", dtype=torch.bfloat16, seed=0))
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    batch = synthetic_batch(B_TRAIN, point_budget=cfg["data"]["point_budget"],
                            seed=0, device="cuda")
    stats0 = bn_stats(model)
    models = {"kernels": (model, trainer.params, True),
              "twins": (model, trainer.params, False)}
    groups = grad_groups(named)
    held32 = set(groups) if float32_groups == "*" else set(float32_groups)
    if held32 - set(groups):
        raise AssertionError(f"{name}: no gradient group "
                             f"{sorted(held32 - set(groups))}")
    if held32:
        m32 = build_model(cfg["model"], device="cuda", dtype=torch.float32,
                          seed=0)
        m32.load_state_dict(model.state_dict())
        trainable = {n for n, _ in named}
        for n, p in m32.named_parameters():
            p.requires_grad_(n in trainable)
        models["float32"] = (m32, [dict(m32.named_parameters())[n]
                                   for n, _ in named], False)
        del m32  # freed with ``models``: the peak below is the model's
    log(f"{name}: model, trainer and batch up in "
        f"{time.perf_counter() - t0:.1f} s; {len(named)} trainable and "
        f"{len(frozen)} frozen parameter tensors, {len(stats0)} BatchNorm "
        f"statistics; {batch.points.shape[1]} raw points and "
        f"{batch.range_points[0, ..., 0].numel()} range points a sample")

    nograd = {n for n, _ in named if no_grad is not None
              and n.startswith(no_grad)}

    def run(m, params, kernels):
        m.load_state_dict(stats0, strict=False)
        set_kernels(m, kernels)
        losses, _, grads = loss_and_grads(
            m, params, batch, trainer.generator(0),
            sample_generator=trainer.sample_generator(0),
            mask_generator=trainer.mask_generator(0))
        flat = [None if gr is None else gr.detach().float().flatten()
                for gr in grads]
        none = {named[i][0] for i, f in enumerate(flat) if f is None}
        if none != nograd:
            raise AssertionError(
                f"{name}: tensors without a gradient {sorted(none)[:8]} "
                f"differ from the expected {sorted(nograd)[:8]}")
        del grads
        out = {}
        for k, idx in groups.items():
            have = [flat[i] is not None for i in idx]
            if any(have) and not all(have):
                raise AssertionError(f"{name}: group {k} has gradients "
                                     "only in part")
            out[k] = torch.cat([flat[i] for i in idx]) if all(have) else None
        return ({k: float(v) for k, v in losses.items()}, bn_stats(m), out)

    runs = {w: run(*a) for w, a in models.items()}
    set_kernels(model, True)
    model.load_state_dict(stats0, strict=False)
    del models
    torch.cuda.synchronize()
    (losses_k, stats_k, grads_k), (losses_p, stats_p, grads_p) = (
        runs["kernels"], runs["twins"])
    loss_err = {k: abs(losses_k[k] - losses_p[k]) / abs(losses_p[k])
                for k in losses_p}
    stats_err = {k: rel_err(torch, stats_k[k], stats_p[k]) for k in stats0}
    none = sorted(k for k, v in grads_p.items() if v is None)
    grad_err = {k: rel_err(torch, grads_k[k], grads_p[k]) for k in grads_p
                if k not in none}
    finite = all(bool(torch.isfinite(v).all()) for v in grads_k.values()
                 if v is not None)
    check = dict(losses={w: r[0] for w, r in runs.items()},
                 loss_rel_err=loss_err, grads_finite=finite,
                 grad_rel_err_kernels_vs_twins=grad_err,
                 groups_without_gradient_in_every_run=none,
                 bounds=dict(loss_rel_err_max=TRAIN_LOSS_TOL,
                             grad_rel_err_max=TRAIN_GRAD_TOL))
    bad = {k: v for k, v in grad_err.items()
           if k not in held32 and v > TRAIN_GRAD_TOL}
    held32 -= set(none)
    if held32:
        g32 = runs["float32"][2]
        err = {w: {k: rel_err(torch, runs[w][2][k], g32[k]) for k in held32}
               for w in ("kernels", "twins")}
        check.update(stats_rel_err_max=max(stats_err.values(), default=0.0),
                     grad_rel_err_vs_float32=err)
        check["bounds"].update(
            stats_rel_err_max=TRAIN_LOSS_TOL,
            grad_rel_err_vs_float32=f"kernels' <= {TWIN_FACTOR} x twins' "
                                    f"for {sorted(held32)}")
        bad.update({k: v for k, v in stats_err.items()
                    if v > TRAIN_LOSS_TOL})
        bad.update({k: (v, err["twins"][k]) for k, v in
                    err["kernels"].items() if v > TWIN_FACTOR
                    * err["twins"][k]})
    log(f"{name} check: " + json.dumps(check))
    if not finite or not all(math.isfinite(v) for v in losses_k.values()):
        raise AssertionError(f"{name}: non-finite losses or gradients")
    if max(loss_err.values()) > TRAIN_LOSS_TOL:
        raise AssertionError(f"{name}: loss error {loss_err}")
    if bad:
        raise AssertionError(f"{name}: over bound: {bad}")
    del runs, grads_k, grads_p, stats_k, stats_p

    # three optimizer steps through the CLI's step function
    per_step = launches_of(model)
    before = {n: p.detach().clone() for n, p in named}
    steps, drawn = [], []
    if trainer.masks:  # keep the masks each step draws
        enc = model.encoder

        def draw(*a, _draw=enc.draw, **kw):
            drawn.append(_draw(*a, **kw))
            return drawn[-1]
        enc.draw = draw
    torch.cuda.synchronize()
    K.reset_launches()
    steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    launches.update({f"{k} VJP": v for k, v in K.VJP_CALLS.items()})
    want = {k: per_step.get(k, 0) for k in launches}
    log(f"{name}: launches in one step {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != {want}")
    for _ in range(2):
        steps.append(trainer.train_step(batch))
    torch.cuda.synchronize()
    if trainer.masks:
        del enc.draw  # the class's method again
        differ = len(drawn) == 3 and all(
            not torch.equal(a[k], b[k]) for i, a in enumerate(drawn)
            for b in drawn[i + 1:] for k in a)
        log(f"{name} masks drawn by the three steps: " + json.dumps(dict(
            draws=len(drawn),
            shapes={k: list(v.shape) for k, v in drawn[0].items()},
            kept_share={k: float(v.float().mean())
                        for k, v in drawn[0].items()},
            differ_step_to_step=differ)))
        if not differ:
            raise AssertionError(f"{name}: the steps' masks repeat")
    logs = [{k: float(v) for k, v in st.items()} for st in steps]
    log(f"{name} steps: " + json.dumps(logs))
    if not all(math.isfinite(v) for st in logs for v in st.values()):
        raise AssertionError(f"{name}: non-finite step logs")
    still = [n for n, p in named
             if n not in nograd and torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    stats = bn_stats(model)
    unmoved = [k for k in stats0 if torch.equal(stats[k], stats0[k])]
    log(f"{name}: {len(named) - len(nograd) - len(still)}/"
        f"{len(named) - len(nograd)} trainable tensors with a gradient "
        f"moved; {len(changed)} of {len(frozen)} frozen tensors changed; "
        f"{len(stats0) - len(unmoved)}/{len(stats0)} BatchNorm statistics "
        "moved")
    if nograd:
        decayed = sorted(n for n, p in named
                         if n in nograd and not torch.equal(p, before[n]))
        log(f"{name}: {len(nograd)} trainable tensors take no gradient, as "
            f"expected (a logged-only loss's head): {sorted(nograd)}; moved "
            f"by weight decay alone: {decayed}")
    if still or changed or unmoved or not frozen:
        raise AssertionError(f"{name}: unmoved {still[:5]}, changed frozen "
                             f"{changed[:5]}, unmoved statistics "
                             f"{unmoved[:5]}, {len(frozen)} frozen")

    # timing, peak memory, profile
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: trainer.train_step(batch), 5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(torch, lambda: trainer.train_step(batch))
    log(f"{name} timing: " + json.dumps(dict(
        ms_per_step=ms, batch=B_TRAIN, samples_per_s=B_TRAIN / ms * 1e3,
        device_ms=prof["busy_ms"], idle_share=prof["idle_share"],
        peak_memory_gb=peak / 1e9, launches_per_step=launches)))
    log(f"{name} profile: " + json.dumps(prof))
    log(f"{name} host syncs a step: " + json.dumps(
        host_syncs(torch, lambda: trainer.train_step(batch))))
    return types.SimpleNamespace(launches=launches, model=model,
                                 trainer=trainer, batch=batch)


# ---------------------------------------------------------------------------
# phase 11: data
# ---------------------------------------------------------------------------

DATA_WORLD = os.path.join(CKPT_DIR, "world")  # git-ignored


@contextlib.contextmanager
def built_models():
    """Collects the models ``models.builder.build_model`` makes inside
    the block (the CLIs build theirs)."""
    from efficient_multimodal_perception_tpu_torch.models import builder

    made, real = [], builder.build_model

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    builder.build_model = spy
    try:
        yield made
    finally:
        builder.build_model = real


def run_cli(main, argv):
    """``main(argv)`` in process: its standard output, logged line by
    line; it must return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"{argv[0]}: exit code {rc}")
    return out


def loader_parts(ds, indices):
    """Seconds of ``ds.sample`` over ``indices`` on one thread, and of
    the two functions it calls by name, timed inside those calls:
    ``_load_image`` (each camera's JPEG decode, bicubic resize, crop and
    normalisation) and ``load_occupancy``; ``rest`` is the remainder (the
    JPEG headers, the points and the range / elevation npz files)."""
    from efficient_multimodal_perception_tpu_torch.data import nuscenes

    spent = dict(_load_image=0.0, load_occupancy=0.0)
    real = {name: getattr(nuscenes, name) for name in spent}

    def timed(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for name in spent:
        setattr(nuscenes, name, timed(name))
    try:
        t0 = time.perf_counter()
        for i in indices:
            ds.sample(i)
        total = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(nuscenes, name, fn)
    return dict(images=spent["_load_image"],
                occupancy=spent["load_occupancy"],
                rest=total - sum(spent.values()), sample=total)


def batches_equal(torch, a, b):
    """Two lists of host ``Batch`` es hold the same tensors."""
    import dataclasses

    def leaves(batch):
        for f in dataclasses.fields(batch):
            v = getattr(batch, f.name)
            if f.name == "cam_aug":
                yield from (v.resize, v.crop, v.flip)
            else:
                yield v

    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for ba, bb in zip(a, b) for x, y in zip(leaves(ba), leaves(bb)))


def cli_pace(name, steps, prefetch):
    """The CLI's step lines: losses, ms a step, the loader's wait, the
    wall a step (their sum); their means over the steps after the first,
    and over the steps after the first ``prefetch`` (whose batches the
    loader started together before step 1), where the loader runs at its
    own pace (null when the run is shorter)."""
    def mean(key, rest):
        return sum(s[key] for s in rest) / len(rest) if rest else None

    row = dict(losses=[s["loss"] for s in steps],
               ms=[s["ms"] for s in steps],
               wait_ms=[s["wait_ms"] for s in steps],
               wall_ms=[s["ms"] + s["wait_ms"] for s in steps])
    for tag, rest in (("first", steps[1:]), ("prefetch", steps[prefetch:])):
        ms, wait = mean("ms", rest), mean("wait_ms", rest)
        row[f"mean_ms_after_{tag}"] = ms
        row[f"mean_wait_ms_after_{tag}"] = wait
        row[f"mean_wall_ms_after_{tag}"] = (
            None if ms is None else ms + wait)
    log(f"{name} pace: " + json.dumps(row))
    if not all(math.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"{name}: non-finite step line")
    return row


def run_data(torch, K, pretrain_path):
    """Phase 11: the nuScenes data layer on files written here: the
    loader alone, the fine-tune's kernels against their twins on the
    loader's first batch, and the train and eval CLIs from the files.
    Returns the launches of one step of each file-backed training path."""
    import importlib.util

    if importlib.util.find_spec("PIL") is None:
        log("data: Pillow is missing, so phase 11 did not run (the loader "
            "decodes its JPEGs with Pillow)")
        return {}
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data import native
    from efficient_multimodal_perception_tpu_torch.data.nuscenes import (
        NuScenesDataset, epoch_batches)
    from efficient_multimodal_perception_tpu_torch.data.prep import (
        make_elevation)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model)
    from efficient_multimodal_perception_tpu_torch.tools.ab_trees import (
        B8_FEATURE_HW, b8_path_inputs)
    from efficient_multimodal_perception_tpu_torch.tools.fixture_world import (
        write_world)
    from efficient_multimodal_perception_tpu_torch.train import cli, eval_cli
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer)

    # the world: 24 train and 2 val samples of full-size files, so that an
    # epoch (12 batches) outlasts the loader's prefetch and the fine-tune's
    # later steps wait on the loader at its own pace
    prefetch = inspect.signature(epoch_batches).parameters["prefetch"].default
    t_phase = t0 = time.perf_counter()
    world = write_world(DATA_WORLD, n_train=24, n_val=2, seed=0)
    log(f"data: wrote {len(world['train'])} train and {len(world['val'])} "
        f"val samples ({world['bytes'] / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s under {DATA_WORLD}")

    # which implementation of the native prep bindings ran, and whether it
    # agrees with the numpy prep on the world's first cloud
    pts = np.fromfile(os.path.join(DATA_WORLD, world["train"][0]["lidar_path"]),
                      np.float32).reshape(-1, 11)
    impl = ("native (native/libprep_kernels.so)"
            if native.load_library() is not None else "numpy fallback")
    elev, mask = native.elevation_raster_native(pts[:, :3])
    want = make_elevation(pts[:, :3])
    log("data: native prep ran as " + json.dumps(dict(
        implementation=impl,
        elevation_max_abs_vs_numpy=float(np.abs(elev - want["elevation"])
                                         .max()),
        mask_equal=bool(np.array_equal(mask, want["mask"])))))

    # the loader alone: the fine-tune's data block (images, range, occupancy)
    occ_cfg = get_config("triplane_occ")
    data = dict(occ_cfg["data"], data_root=DATA_WORLD)
    pace = {}
    for workers in (1, 4):
        ds = NuScenesDataset(dict(data, workers=workers), "train", seed=0)
        t0 = time.perf_counter()
        n = sum(1 for _ in epoch_batches(ds, B_TRAIN, seed=0))
        dt = time.perf_counter() - t0
        pace[f"workers_{workers}"] = dict(
            batches=n, ms_per_batch=dt / n * 1e3,
            samples_per_s=n * B_TRAIN / dt)
    full = NuScenesDataset(dict(data, load_points=True, load_elev=True),
                           "train", seed=0)
    parts = loader_parts(full, range(len(full)))
    shares = {k: v / parts["sample"] for k, v in parts.items()
              if k != "sample"}
    ds = NuScenesDataset(data, "train", seed=0)
    first = list(epoch_batches(ds, B_TRAIN, seed=0))
    again = list(epoch_batches(ds, B_TRAIN, seed=0))
    same = batches_equal(torch, first, again)
    log("data loader: " + json.dumps(dict(
        pace=pace, sample_ms=parts["sample"] / len(full) * 1e3,
        shares_of_a_sample=shares, two_passes_identical=same,
        cpu_count=os.cpu_count())))
    if not same:
        raise AssertionError("data: two passes over epoch 0 differ")

    # the fine-tune's kernels against their twins on the loader's first
    # batch; B8 alone on the indices the interact makes of it (camera
    # stage 1's feature rows, C = 192, random bf16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = first[0].to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    aug = batch.cam_aug
    idx, active = b8_path_inputs(B_TRAIN, "cuda", batch)
    feats = torch.randn(B_TRAIN, active.shape[1], math.prod(B8_FEATURE_HW),
                        192, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0)
                        ).bfloat16()
    valid = active.to(torch.uint8)
    got = K.cam_gather_sum(feats, idx, valid)
    want = K.cam_gather_sum_plain(feats, idx, valid)
    b8_err = rel_err(torch, got, want)
    del feats, got, want
    log("data batch: " + json.dumps(dict(
        host_to_device_ms=h2d_ms,
        bytes=sum(t.numel() * t.element_size() for t in (
            first[0].img, first[0].range_image, first[0].range_points,
            first[0].lidar2img, first[0].occupancy)),
        resize=[float(aug.resize.min()), float(aug.resize.max())],
        crop_w=[float(aug.crop[..., 0].min()), float(aug.crop[..., 0].max())],
        crop_h=[float(aug.crop[..., 1].min()), float(aug.crop[..., 1].max())],
        flipped=f"{int(aug.flip.sum())}/{aug.flip.numel()}",
        b8_valid_share=float(active.float().mean()),
        b8_pixels_seen_by_a_camera=float(active.any(1).float().mean()),
        b8_rel_err_vs_twin=b8_err, b8_tol=REL_TOL)))
    if not b8_err <= REL_TOL:
        raise AssertionError(f"data: B8 vs its twin on the loader's "
                             f"indices {b8_err}")
    model = build_model(occ_cfg["model"], device="cuda", dtype=torch.bfloat16,
                        seed=0)
    load_pretrained_encoder(torch, model, pretrain_path, "data finetune")
    trainer = build_trainer(occ_cfg, model, total_steps=3, seed=0)
    finetune_check(torch, K, model, trainer, batch, "data finetune")
    per_finetune = finetune_launches(model)
    del model, trainer, batch, idx, active

    # the CLIs from the files, in process
    launches = {}
    work = os.path.join(CKPT_DIR, "data_runs")
    paths = (
        ("data_finetune_step", "triplane_occ", 12, finetune_launches,
         ["--ckpt-path", pretrain_path]),
        ("data_point_train_step", "point_triplane_occ", 3,
         point_train_launches, []))
    for path, cfg_name, n_steps, launches_of, extra in paths:
        argv = [cfg_name, "--work-dir", os.path.join(work, cfg_name),
                "--data-root", DATA_WORLD, "--batch-size", str(B_TRAIN),
                "--max-steps", str(n_steps), *extra]
        log(f"data: train.cli {' '.join(argv)}")
        torch.cuda.synchronize()
        K.reset_launches()
        with built_models() as made:
            out = run_cli(cli.main, argv)
        torch.cuda.synchronize()
        total = dict(K.LAUNCHES)
        per_step = launches_of(made[0])
        want = {k: n_steps * per_step.get(k, 0) for k in K.LAUNCHES}
        log(f"data {cfg_name}: launches in {n_steps} CLI steps {total} "
            f"(expected {want})")
        if total != want:
            raise AssertionError(f"{path}: launches {total} != {want}")
        launches[path] = {k: per_step.get(k, 0) for k in K.LAUNCHES}
        steps = [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
        if [s["step"] for s in steps] != list(range(1, n_steps + 1)):
            raise AssertionError(f"{path}: steps {steps}")
        cli_pace(f"data {cfg_name}", steps, prefetch)
        del made

    ckpt = os.path.join(work, "triplane_occ", "checkpoints", "step_12.pt")
    argv = ["triplane_occ", "--data-root", DATA_WORLD, "--checkpoint", ckpt,
            "--batch-size", str(B_TRAIN), "--bf16"]
    log(f"data: eval_cli {' '.join(argv)}")
    K.reset_launches()
    t0 = time.perf_counter()
    out = run_cli(eval_cli.main, argv)
    torch.cuda.synchronize()
    evaluated = dict(K.LAUNCHES)
    metrics = {line.split(":")[0]: float(line.split()[-1])
               for line in out.splitlines()
               if line.startswith(("CE:", "IoU (geometry):", "mIoU:"))}
    log("data eval: " + json.dumps(dict(
        metrics=metrics, seconds=time.perf_counter() - t0,
        launches=evaluated)))
    if sorted(metrics) != ["CE", "IoU (geometry)", "mIoU"] or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"data eval: {out}")
    if evaluated != {k: per_finetune.get(k, 0) for k in K.LAUNCHES}:
        raise AssertionError(f"data eval launches {evaluated}")
    log(f"data: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: export and the train CLI's flags
# ---------------------------------------------------------------------------

EXPORT_DIR = os.path.join(CKPT_DIR, "export")  # git-ignored
FLAG_DIR = os.path.join(CKPT_DIR, "flags")
# (name, config, int8, batch) of the artifacts phase 12 exports
ARTIFACTS = (("triplane_occ", "triplane_occ", False, B),
             ("triplane_occ_int8", "triplane_occ", True, B),
             ("point_triplane_occ", "point_triplane_occ", False, B),
             ("triplane_elev", "triplane_elev", False, B),
             ("triplane_range_cam", "triplane_range_cam", False, B_TRAIN))
REMAT_REL_TOL = 1e-3  # grad_norm and step 2's loss, remat against without
# a fresh process loads the occupancy artifact with nothing of the model
# code imported, and writes the class map it computes
FRESH_LOAD = """
import sys, torch
path, inputs, out = sys.argv[1:4]
from efficient_multimodal_perception_tpu_torch.tools.export import (
    load_artifact)
program = load_artifact(path).module()
with torch.inference_mode():
    torch.save(program(**torch.load(inputs)).cpu(), out)
models = sorted(m for m in sys.modules
                if m.startswith("efficient_multimodal_perception_tpu_torch.")
                and m.split(".")[1] not in ("ops", "tools"))
print("imported", models)
"""


def export_artifact(torch, K, X, name, cfg_name, int8, batch):
    """One artifact of phase 12: the seeded model's live forward, its
    export, the saved file loaded back and run; ``emp::`` op counts,
    launches and outputs against the live forward's; times.  Returns
    ``(launches of one forward, inputs, live output, path)``."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config

    model = seeded_serving_model(torch, cfg_name, int8).requires_grad_(False)
    inputs = X.example_inputs(get_config(cfg_name), X.artifact_keys(model),
                              batch, next(model.parameters()).device)
    module = X.InferModule(model, X.loss_draws(model, inputs))
    torch.cuda.synchronize()
    K.reset_launches()
    want = X.run(module, inputs)
    torch.cuda.synchronize()
    live = {k: n for k, n in K.LAUNCHES.items() if n}
    t0 = time.perf_counter()
    program = X.export(module, inputs)
    export_s = time.perf_counter() - t0
    path = os.path.join(EXPORT_DIR, f"{name}.pt2")
    t0 = time.perf_counter()
    torch.export.save(program, path)
    save_s = time.perf_counter() - t0
    ops = X.emp_op_counts(program)
    del program
    t0 = time.perf_counter()
    loaded = X.load_artifact(path).module()
    load_s = time.perf_counter() - t0
    X.run(loaded, inputs)  # the loaded graph's first call
    torch.cuda.synchronize()
    K.reset_launches()
    got = X.run(loaded, inputs)
    torch.cuda.synchronize()
    ran = {k: n for k, n in K.LAUNCHES.items() if n}
    bad = X.outputs_match(got, want)

    def timed(fn):
        # a collection of the host's objects (an exported program holds
        # some 10^5 of them) inside the window would add its ~0.1-0.5 s
        # to one call: collect first
        gc.collect()
        return time_ms(torch, lambda: X.run(fn, inputs), 10, 3)

    row = dict(
        export_s=export_s, save_s=save_s, load_s=load_s,
        mb=os.path.getsize(path) / 1e6, emp_ops=ops,
        live_launches=live, artifact_launches=ran,
        outputs=X.describe(want), mismatches=bad,
        artifact_ms=timed(loaded), live_ms=timed(module), batch=batch)
    if isinstance(want, dict):
        row["losses"] = {k: float(v) for k, v in want.items()}
        row["loss_rel_err"] = {k: abs(float(got[k]) - float(v))
                               / max(abs(float(v)), 1e-30)
                               for k, v in want.items()}
    log(f"export {name}: " + json.dumps(row))
    # where an artifact's time differs from the live forward's: the
    # device work (kernels, copies) of one call of each
    profiles = {}
    for tag, fn in (("artifact", loaded), ("live", module)):
        gc.collect()
        profiles[tag] = profile_call(torch, lambda: X.run(fn, inputs), top=6,
                                     host_top=8)
    log(f"export {name} profile: " + json.dumps(profiles))
    if ops != live or ran != live:
        raise AssertionError(f"export {name}: emp ops {ops}, artifact "
                             f"launches {ran}, live launches {live}")
    if bad:
        raise AssertionError(f"export {name}: {bad}")
    return live, inputs, want, path


def cli_run(torch, K, cli, argv):
    """``train.cli`` in process: its step lines, launches, seconds, peak
    memory and the model it built."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    with built_models() as made:
        out = run_cli(cli.main, argv)
    torch.cuda.synchronize()
    steps = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    return dict(out=out, steps=steps, launches=dict(K.LAUNCHES),
                seconds=time.perf_counter() - t0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                model=made[0])


def run_export_flags(torch, K, pretrain_path):
    """Phase 12: five ``torch.export`` artifacts (their graphs' ``emp::``
    ops, launches and outputs against the live forward's, times), the
    ``triplane_occ`` artifact loaded in a fresh process, then the train
    CLI's ``--remat``, ``--accum-steps``, ``--async-ckpt`` and
    ``--eval-interval``.  Returns the launches of one forward of each
    artifact."""
    import shutil

    from efficient_multimodal_perception_tpu_torch.tools import export as X
    from efficient_multimodal_perception_tpu_torch.train import cli
    from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
        restore_params_only)

    t_phase = time.perf_counter()
    os.makedirs(EXPORT_DIR, exist_ok=True)
    launches = {}
    try:
        for name, cfg_name, int8, batch in ARTIFACTS:
            live, inputs, want, path = export_artifact(
                torch, K, X, name, cfg_name, int8, batch)
            launches[f"export_{name}"] = live
            if name == "triplane_occ":
                occ_path = path
                occ_in = os.path.join(EXPORT_DIR, "occ_inputs.pt")
                occ_out = os.path.join(EXPORT_DIR, "occ_fresh.pt")
                torch.save(inputs, occ_in)
                occ_want = want.cpu()
            del inputs, want
            torch.cuda.empty_cache()
        # after the timings: a second process on the host would slow them
        t0 = time.perf_counter()
        fresh = subprocess.run(
            [sys.executable, "-c", FRESH_LOAD, occ_path, occ_in, occ_out],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600)
        same = (fresh.returncode == 0
                and torch.equal(torch.load(occ_out), occ_want))
        log("export fresh process: " + json.dumps(dict(
            rc=fresh.returncode, seconds=time.perf_counter() - t0,
            stdout=fresh.stdout.strip().splitlines()[-1:],
            class_map_equal=same)))
        if not same or not fresh.stdout.strip().endswith("imported []"):
            raise AssertionError(f"fresh load: {fresh.stdout[-2000:]} "
                                 f"{fresh.stderr[-4000:]}")
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)

    # --remat on the pretraining step: twice without (the gap between two
    # identical runs), once with
    base = ["triplane_range_cam", "--synthetic", "--max-steps", "2",
            "--batch-size", str(B_TRAIN)]
    runs = {}
    for tag, extra in (("plain", []), ("plain_again", []),
                       ("remat", ["--remat"])):
        runs[tag] = cli_run(torch, K, cli, base + [
            "--work-dir", os.path.join(FLAG_DIR, f"range_cam_{tag}"),
            *extra])
        del runs[tag]["model"]
    want = {k: 2 * PER_TRAIN_STEP.get(k, 0) for k in K.LAUNCHES}
    for tag in ("plain", "plain_again"):
        if runs[tag]["launches"] != want:
            raise AssertionError(f"range_cam {tag}: launches "
                                 f"{runs[tag]['launches']} != {want}")

    def gap(a, b, key, i):
        x, y = runs[a]["steps"][i][key], runs[b]["steps"][i][key]
        return abs(x - y) / max(abs(y), 1e-30)

    row = dict(
        step1_loss=[runs[t]["steps"][0]["loss"] for t in runs],
        step1_loss_equal=runs["remat"]["steps"][0]["loss"]
        == runs["plain"]["steps"][0]["loss"],
        grad_norm_rel_gap=gap("remat", "plain", "grad_norm", 0),
        step2_loss_rel_gap=gap("remat", "plain", "loss", 1),
        plain_vs_plain_grad_norm_gap=gap("plain_again", "plain",
                                         "grad_norm", 0),
        plain_vs_plain_step2_loss_gap=gap("plain_again", "plain", "loss", 1),
        ms=[[s["ms"] for s in runs[t]["steps"]] for t in runs],
        peak_gb={t: runs[t]["peak_gb"] for t in runs},
        remat_launches=runs["remat"]["launches"], tol=REMAT_REL_TOL)
    log("flags remat triplane_range_cam: " + json.dumps(row))
    if not (row["step1_loss_equal"]
            and row["grad_norm_rel_gap"] <= REMAT_REL_TOL
            and row["step2_loss_rel_gap"] <= REMAT_REL_TOL):
        raise AssertionError(f"remat: {row}")

    # --remat on the point train: BatchNorm statistics moved once
    stats = {}
    for tag, extra in (("plain", []), ("remat", ["--remat"])):
        r = cli_run(torch, K, cli, [
            "point_triplane_occ", "--synthetic", "--max-steps", "1",
            "--batch-size", str(B_TRAIN), "--work-dir",
            os.path.join(FLAG_DIR, f"point_{tag}"), *extra])
        stats[tag] = {k: v.clone() for k, v in r["model"].state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}
        stats[f"{tag}_row"] = dict(loss=r["steps"][0]["loss"],
                                   ms=r["steps"][0]["ms"],
                                   peak_gb=r["peak_gb"])
        del r
    equal = bool(stats["plain"]) and all(
        torch.equal(stats["remat"][k], v) for k, v in stats["plain"].items())
    log("flags remat point_triplane_occ: " + json.dumps(dict(
        running_stats=len(stats["plain"]), bit_identical=equal,
        plain=stats["plain_row"], remat=stats["remat_row"])))
    if not equal:
        raise AssertionError("point remat: running statistics differ")

    # --accum-steps 2 on the fine-tune, with --async-ckpt and
    # --eval-interval 1 on the accumulating run
    base = ["triplane_occ", "--synthetic", "--max-steps", "3",
            "--batch-size", str(B_TRAIN), "--ckpt-path", pretrain_path]
    acc = {}
    for tag, extra in (("plain", []), ("accum", [
            "--accum-steps", "2", "--async-ckpt", "--eval-interval", "1",
            "--eval-samples", "2"])):
        work = os.path.join(FLAG_DIR, f"occ_{tag}")
        acc[tag] = cli_run(torch, K, cli, base + ["--work-dir", work, *extra])
        acc[tag]["work"] = work
    # 3 steps of 2 micro-batches, then the evaluation's 2 forwards
    per = finetune_launches(acc["accum"]["model"])
    want = {k: (3 * 2 + 2) * per.get(k, 0) for k in K.LAUNCHES}
    evals = [line for line in acc["accum"]["out"].splitlines()
             if line.startswith("[eval @ epoch")]
    ckpt = os.path.join(acc["accum"]["work"], "checkpoints", "step_3.pt")
    loaded = restore_params_only(ckpt)
    val = [line for line in open(os.path.join(acc["accum"]["work"],
                                              "train.log"))
           if " val/" in line]
    log("flags accum triplane_occ: " + json.dumps(dict(
        losses={t: [s["loss"] for s in acc[t]["steps"]] for t in acc},
        ms={t: [s["ms"] for s in acc[t]["steps"]] for t in acc},
        launches=acc["accum"]["launches"], expected=want,
        eval_lines=evals, val_log_lines=len(val),
        checkpoint_tensors=len(loaded),
        meta=os.path.exists(ckpt + ".meta.json"))))
    if acc["accum"]["launches"] != want:
        raise AssertionError(f"accum launches {acc['accum']['launches']}")
    if (len(evals) != 1 or not val or not os.path.exists(ckpt + ".meta.json")
            or set(loaded) != set(acc["accum"]["model"].state_dict())):
        raise AssertionError("async checkpoint / eval run")
    del acc, loaded
    shutil.rmtree(FLAG_DIR, ignore_errors=True)
    log(f"export and flags: phase 12 took {time.perf_counter() - t_phase:.1f}"
        " s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: SparK-masked pretraining with the colour head, reconstructions
# and the eval CLI's dumps, MiT high
# ---------------------------------------------------------------------------

MASK_RATIO = 0.75  # tests/test_masked_mae.py's ratios
# masked triplane_range_cam with the colour head over the triplane's 32
# channels (config overrides: no config of the repo masks)
MASKED_OPTIONS = (f"model.encoder.lidar_mask_ratio={MASK_RATIO}",
                  f"model.encoder.camera_mask_ratio={MASK_RATIO}",
                  "model.color_decoder.type=PointMlp",
                  "model.color_decoder.input_dim=32",
                  "model.color_decoder.num_classes=3")


def masked_pretrain_launches(model):
    """Kernel launches of one masked ``triplane_range_cam`` step: the
    unmasked step's (``PER_TRAIN_STEP``) outside the encoders, and every
    ConvNeXt block, frozen or not, one B5 forward (a masked block never
    runs K1) with the B5 backward where it needs a gradient, as
    :func:`encoder_launches` counts with ``masked``.  The colour head is
    plain products."""
    out = {k: v for k, v in PER_TRAIN_STEP.items()
           if k not in ("convnext_block_fused", "epilogue_fused",
                        "post_epilogue_bwd", "post_epilogue_bwd_wide")}
    encoder_launches(out, model.encoder.camera_encoder, 1, False, True)
    encoder_launches(out, model.encoder.lidar_encoder, 1, True, True)
    return out


def recon_launches(model):
    """Launches of one deterministic, unmasked ``reconstructions`` call of
    ``triplane_range_cam`` (or, for ``triplane_occ``, one ``triplane``):
    a K1 each ConvNeXt block, each MiT block (neck and decoders) one
    attention, the neck's two LN and one GELU prologue a block, one B7
    (the MAE's range features) and one B8."""
    from efficient_multimodal_perception_tpu_torch.models.mit import MiTBlock

    enc = model.encoder
    blocks = sum(len(st) for e in (enc.camera_encoder, enc.lidar_encoder)
                 for st in e.stages)
    neck = sum(isinstance(m, MiTBlock) for m in model.neck.modules())
    attn = sum(isinstance(m, MiTBlock) for m in model.modules())
    out = {"convnext_block_fused": blocks, "attention": attn,
           "ln_dense_fused": 2 * neck, "gelu_dense_fused": neck,
           "cam_gather_sum": 1}
    if hasattr(model, "reconstructions"):
        out["triplane_sample"] = 1
    return out


def float32_copy(torch, model, model_cfg):
    """A float32-compute model of ``model_cfg`` on the card holding
    ``model``'s weights (its kernel gates stay closed)."""
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model)

    m32 = build_model(model_cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    return m32


def twin_check(torch, K, name, model, m32, fn, want_launches, fallback=()):
    """``fn(model)`` (a dict of tensors) with the kernels, then with the
    bf16 twins, then ``fn(m32)`` in float32: the first call's launches
    must be ``want_launches`` and every output finite; each output must
    lie within ``LOGIT_REL_TOL`` of its twin, except the outputs named in
    ``fallback``, which are held by phase 8's rule instead (the kernels'
    error against float32 within ``TWIN_FACTOR`` of the twins').  Returns
    the kernels' outputs and the launches."""
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        set_kernels)

    torch.cuda.synchronize()
    K.reset_launches()
    got = fn(model)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    set_kernels(model, False)
    want = fn(model)
    set_kernels(model, True)
    ref = fn(m32)
    err = {k: rel_err(torch, got[k], want[k]) for k in want}
    err32 = {w: {k: rel_err(torch, o[k], ref[k]) for k in ref}
             for w, o in (("kernels", got), ("twins", want))}
    if set(fallback) - set(err):
        raise AssertionError(f"{name}: no output {sorted(fallback)}")
    ok = {k: err32["kernels"][k] <= TWIN_FACTOR * err32["twins"][k]
          if k in fallback else err[k] <= LOGIT_REL_TOL for k in err}
    finite = all(bool(torch.isfinite(v.float()).all()) for v in got.values())
    bounds = {k: f"vs float32: kernels' <= {TWIN_FACTOR} x twins'"
              if k in fallback else f"vs twins: <= {LOGIT_REL_TOL}"
              for k in err}
    log(f"{name}: " + json.dumps(dict(
        shapes={k: list(v.shape) for k, v in got.items()},
        rel_err_vs_twins=err, rel_err_vs_float32=err32, passed=ok,
        bounds=bounds, finite=finite, launches=launches,
        expected=want_launches)))
    if launches != want_launches:
        raise AssertionError(f"{name}: launches {launches} != "
                             f"{want_launches}")
    if not finite or not all(ok.values()):
        raise AssertionError(f"{name}: outputs over bound or not finite")
    return got, launches


def run_recon_dumps(torch, K, model):
    """Phase 13 (b): at batch 1, unmasked, ``reconstructions`` of
    ``model`` (full-width ``triplane_range_cam``) and the ``triplane`` of
    full-width ``triplane_occ``, kernels against twins; then the eval
    CLI's dump (``eval_cli.dump_visualizations``) of one sample of each,
    and ``save_points_obj`` of the reprojected points, into a temporary
    directory: the files it wrote, by kind.  Without matplotlib (the card's
    machine) the dump writes the numpy artifacts only."""
    import importlib.util
    import tempfile

    from efficient_multimodal_perception_tpu_torch.configs import (
        apply_overrides, get_config)
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.train.eval_cli import (
        dump_visualizations)
    from efficient_multimodal_perception_tpu_torch.utils import (
        visualization as viz)

    def single(i, with_occ=False):
        return synthetic_batch(1, point_budget=36864, seed=i,
                               with_occ=with_occ, device="cuda")

    batch = single(0)
    out = {}
    m32 = float32_copy(torch, model, apply_overrides(
        get_config("triplane_range_cam"), list(MASKED_OPTIONS))["model"])
    m32.encoder.lidar_mask_ratio = m32.encoder.camera_mask_ratio = 0.0
    # cam_recon is 3.4e-2 from its bf16 twin on an H100, and kernels and
    # twins 3.6e-2 alike from float32: it alone is held by phase 8's rule
    _, out["mae_reconstructions"] = twin_check(
        torch, K, "masked recon triplane_range_cam reconstructions", model,
        m32, lambda m: m.reconstructions(batch), recon_launches(model),
        fallback=("cam_recon",))
    del m32
    occ = seeded_serving_model(torch, "triplane_occ")
    occ_batch = single(0, True)
    with torch.no_grad():
        _, out["occ_triplane"] = twin_check(
            torch, K, "masked recon triplane_occ triplane", occ,
            float32_copy(torch, occ, get_config("triplane_occ")["model"]),
            lambda m: {"triplane": m.triplane(occ_batch)},
            recon_launches(occ))
    figures = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        dump_visualizations(occ, lambda i: single(i, True), 1, "TriplaneOcc",
                            d)
        dump_visualizations(model, single, 1, "TriplaneMAE", d)
        pred = np.load(os.path.join(d, "points", "pred_points_0.npy"))
        viz.save_points_obj(pred[:, :3], os.path.join(d, "points", "0.obj"))
        files = sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs)
        kinds = {}
        for f in files:
            kinds[os.path.splitext(f)[1]] = kinds.get(
                os.path.splitext(f)[1], 0) + 1
        log("masked recon dumps: " + json.dumps(dict(
            seconds=time.perf_counter() - t0, files=files, by_kind=kinds,
            reprojected_points=int(pred.shape[0]),
            figures="written" if figures else
            "not written: matplotlib is not installed on this machine (the "
            "PNG writers are held to JAX's in the CPU tests)")))
        want = {"0.npz", "points/pred_points_0.npy", "points/gt_points_0.npy",
                "points/0.obj"}
        if not want <= set(files):
            raise AssertionError(f"masked recon dumps: {files}")
    del occ
    torch.cuda.empty_cache()
    return out


def run_mit_high(torch, K):
    """Phase 13 (c): ``MixVisionTransformerHigh`` (seeded, bf16 compute)
    on a ``(2, 128, 32, 768)`` strip: the output ``(2, 256, 256, 96)``,
    K2-K4 launched (2 / 4 / 2) and the output within ``LOGIT_REL_TOL`` of
    the twins'; ms of a forward with and without the kernels."""
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build, init_params, set_kernels)

    nets = {}
    for dt in (torch.bfloat16, torch.float32):
        nets[dt] = build(dict(type="MixVisionTransformerHigh"), dtype=dt)
        init_params(nets[dt], torch.Generator().manual_seed(0))
        nets[dt] = nets[dt].cuda().eval()
    net = nets[torch.bfloat16]
    x = torch.randn((2, 128, 32, 768), generator=torch.Generator()
                    .manual_seed(1)).to("cuda", torch.bfloat16)
    with torch.no_grad():
        got, launches = twin_check(
            torch, K, "masked mit_high forward", net, nets[torch.float32],
            lambda m: {"out": m(x)},
            {"attention": 2, "ln_dense_fused": 4, "gelu_dense_fused": 2})
        if tuple(got["out"].shape) != (2, 256, 256, 96):
            raise AssertionError(f"MiT high output {got['out'].shape}")
        ms = time_ms(torch, lambda: net(x), 10)
        set_kernels(net, False)
        plain = time_ms(torch, lambda: net(x), 3, warmup=1)
        set_kernels(net, True)
    log("masked mit_high timing: " + json.dumps(dict(
        ms=ms, twins_ms=plain, shape=list(got["out"].shape))))
    return launches


def run_masked(torch, K):
    """Phase 13: (a) masked ``triplane_range_cam`` with the colour head
    trained through :func:`run_pretrain` (launches
    ``masked_pretrain_launches``; the colour head alone takes no
    gradient), then the step timed against the same model unmasked (its
    launches ``PER_TRAIN_STEP``) and masked again; (b)
    :func:`run_recon_dumps`; (c) :func:`run_mit_high`."""
    t0 = time.perf_counter()
    # phase 5's 5e-2 holds every gradient group but the position
    # encoder's: with 75% of the pixels masked its kernels' gradient lies
    # 6.2e-2 from the bf16 twins' on an H100, as far from a float32 run
    # as the twins' own, so that group is held by phase 8's rule
    run = run_pretrain(
        torch, K, "triplane_range_cam", masked_pretrain_launches,
        ("encoder.position_encoder",), MASKED_OPTIONS,
        "masked triplane_range_cam train", "color_decoder.")
    model, trainer, batch = run.model, run.trainer, run.batch
    enc = model.encoder

    def timed(label):
        torch.cuda.synchronize()
        K.reset_launches()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: trainer.train_step(batch), 5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_call(torch, lambda: trainer.train_step(batch))
        return dict(label=label, ms_per_step=ms, device_ms=prof["busy_ms"],
                    idle_share=prof["idle_share"], peak_memory_gb=peak / 1e9,
                    launches=launches)

    ratios = enc.lidar_mask_ratio, enc.camera_mask_ratio
    rows = [timed("masked")]
    enc.lidar_mask_ratio = enc.camera_mask_ratio = 0.0
    rows.append(timed("unmasked"))
    want = {k: v for k, v in PER_TRAIN_STEP.items() if v}
    if rows[-1]["launches"] != want:
        raise AssertionError(f"unmasked step launches "
                             f"{rows[-1]['launches']} != {want}")
    recon = run_recon_dumps(torch, K, model)
    enc.lidar_mask_ratio, enc.camera_mask_ratio = ratios
    rows.append(timed("masked"))
    log("masked train vs unmasked (same model, A B A): " + json.dumps(rows))
    launches, unmasked = run.launches, rows[1]["launches"]
    del run, model, trainer, batch, enc
    torch.cuda.empty_cache()
    k1 = {"masked": launches.get("convnext_block_fused", 0),
          "unmasked": unmasked.get("convnext_block_fused", 0)}
    b5 = {"masked": launches.get("epilogue_fused", 0),
          "unmasked": unmasked.get("epilogue_fused", 0)}
    log("masked train launches explained: " + json.dumps(dict(
        k1=k1, b5_forward=b5,
        note="every masked block runs B5's forward: K1's frozen-stage "
             "blocks move to B5 (K1 and B5 forward sum to the same 36)")))
    if k1["masked"] or b5["masked"] != b5["unmasked"] + k1["unmasked"]:
        raise AssertionError(f"masked launches: K1 {k1}, B5 {b5}")
    out = {"masked_train_step": launches,
           "unmasked_colour_train_step": unmasked,
           "mae_reconstructions": recon["mae_reconstructions"],
           "occ_triplane": recon["occ_triplane"],
           "mit_high_forward": run_mit_high(torch, K)}
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: int8's calibrated static scales and its straight-through
# backward
# ---------------------------------------------------------------------------

# static triplane_occ: no B10 (static has no fused kernel), no prologues
# (int8 keeps them off), attention in the neck and B8 in the interact
PER_STATIC_FORWARD = {"attention": 2, "cam_gather_sum": 1}
# JAX's own bounds for static serving (tests/test_quant.py:297-301)
STATIC_VS_FLOAT32_MAX = 0.15
STATIC_VS_BF16_AGREE_MIN = 0.97
# the int8 fine-tune's first loss against the same step without int8
INT8_FINETUNE_LOSS_TOL = 5e-2
# enable_int8 on the encoder and neck of triplane_range_cam (the decoders
# have no int8 path)
QAT_OPTIONS = ("model.encoder.int8=True", "model.neck.int8=True")
B10 = "convnext_block_int8_fused"
B10_VJP = f"{B10} VJP"


def set_int8_parts(model, parts, on) -> None:
    """:func:`set_int8` on the named top-level parts of ``model``."""
    for part in parts:
        set_int8(getattr(model, part), on)


def timed_forward(torch, fn):
    """ms a call (CUDA events), device ms and idle share (one profiled
    call) and peak GB of ``fn``."""
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, fn, 5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(torch, fn)
    return dict(ms=ms, device_ms=prof["busy_ms"],
                idle_share=prof["idle_share"], peak_memory_gb=peak / 1e9,
                device_launches=prof["device_launches"])


def run_static_serve(torch, K):
    """(a) Full-width ``triplane_occ`` with static int8 (``enable_int8(...,
    mode="static")``) at batch ``B``: ``ops.quant.calibrate`` on two
    synthetic batches (seeds 1 and 2, as the JAX bench's ``--int8-static``)
    fills every site's amax (all above 0); one forward launches
    ``PER_STATIC_FORWARD`` (no B10); the logits with the kernels against
    the twins within ``LOGIT_REL_TOL``; against the same weights in bf16
    (int8 off) the argmax agreement at least
    ``STATIC_VS_BF16_AGREE_MIN``, against a float32 copy the relative
    error at most ``STATIC_VS_FLOAT32_MAX``; ms, device ms and peak GB of
    the static, dynamic and bf16 forwards of the same model.  Returns the
    forward's launches."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model, set_kernels)
    from efficient_multimodal_perception_tpu_torch.ops.quant import (
        calibrate, enable_int8)
    from efficient_multimodal_perception_tpu_torch.serve import (
        build_infer_fn)

    t0 = time.perf_counter()
    name = "static int8 triplane_occ"
    cfg = get_config("triplane_occ")
    model = draw_gamma_and_stats(torch, build_model(
        enable_int8(cfg["model"], mode="static"), device="cuda",
        dtype=torch.bfloat16, seed=0))
    t1 = time.perf_counter()
    sites = calibrate(model, [synthetic_batch(B, point_budget=4096,
                                              seed=s, device="cuda")
                              for s in (1, 2)])
    amax = torch.stack(list(sites.values()))
    log(f"{name} calibration: " + json.dumps(dict(
        sites=len(sites), seconds=time.perf_counter() - t1,
        amax_min=float(amax.min()), amax_max=float(amax.max()),
        sites_at_zero=int((amax == 0).sum()), calibration_batches=2,
        seeds=[1, 2], batch=B)))
    if not bool((amax > 0).all()):
        raise AssertionError(f"{name}: a site's amax is 0")

    batch = synthetic_batch(B, point_budget=4096, seed=0, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        K.reset_launches()
        lk = model(batch)[0].float()
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        set_kernels(model, False)
        lp = model(batch)[0].float()
        set_kernels(model, True)
        set_int8(model, False)
        lb = model(batch)[0].float()
        set_int8(model, "static")
    plain = build_model(get_config("triplane_occ")["model"], device="cuda",
                        dtype=torch.float32)
    missing, extra = plain.load_state_dict(model.state_dict(), strict=False)
    if missing or set(extra) != set(sites):
        raise AssertionError(f"{name}: float32 copy missing {missing[:4]}, "
                             f"unexpected {sorted(set(extra) - set(sites))}")
    with torch.inference_mode():
        l32 = plain(batch)[0].float()
    del plain
    check = dict(
        launches=launches, expected_launches=PER_STATIC_FORWARD,
        kernels_vs_twins=dict(logit_rel_err=rel_err(torch, lk, lp),
                              argmax_agreement=float(
                                  (lk.argmax(-1) == lp.argmax(-1))
                                  .float().mean())),
        vs_bf16=dict(argmax_agreement=float((lk.argmax(-1) == lb.argmax(-1))
                                            .float().mean()),
                     logit_rel_err=rel_err(torch, lk, lb)),
        vs_float32=dict(logit_rel_err=rel_err(torch, lk, l32),
                        argmax_agreement=float(
                            (lk.argmax(-1) == l32.argmax(-1))
                            .float().mean())),
        twins_vs_float32=dict(logit_rel_err=rel_err(torch, lp, l32)),
        bf16_vs_float32=dict(logit_rel_err=rel_err(torch, lb, l32)),
        finite=bool(torch.isfinite(lk).all()),
        bounds=dict(kernels_vs_twins_logit_rel_err_max=LOGIT_REL_TOL,
                    vs_bf16_argmax_agreement_min=STATIC_VS_BF16_AGREE_MIN,
                    vs_float32_logit_rel_err_max=STATIC_VS_FLOAT32_MAX))
    # D4 (ROADMAP section C): the kernels-vs-twins bound is missed on the
    # card; the miss is reported here, and the kernels are held by phase
    # 8's rule instead (their error against float32 within TWIN_FACTOR of
    # the twins')
    k_err = check["kernels_vs_twins"]["logit_rel_err"]
    k32 = check["vs_float32"]["logit_rel_err"]
    t32 = check["twins_vs_float32"]["logit_rel_err"]
    check["kernels_vs_twins"]["within_bound"] = k_err <= LOGIT_REL_TOL
    check["kernels_vs_float32_over_twins"] = k32 / t32
    check["bounds"]["kernels_vs_float32_over_twins_max"] = TWIN_FACTOR
    log(f"{name} check: " + json.dumps(check))
    del lk, lp, lb, l32
    if k_err > LOGIT_REL_TOL:
        log(f"{name}: kernels vs twins {k_err:.4g} is over the bound "
            f"{LOGIT_REL_TOL} (deviation D4, ROADMAP section C); held by "
            f"phase 8's rule: {k32:.4g} vs the twins' {t32:.4g} from float32")
    if launches != PER_STATIC_FORWARD:
        raise AssertionError(f"{name}: launches {launches}")
    if not check["finite"] or (
            k32 > TWIN_FACTOR * t32
            or check["vs_bf16"]["argmax_agreement"]
            < STATIC_VS_BF16_AGREE_MIN
            or k32 > STATIC_VS_FLOAT32_MAX):
        raise AssertionError(f"{name}: over bound")

    infer = build_infer_fn(model)
    timing = {}
    for mode, flag in (("static", "static"), ("dynamic", True),
                       ("bf16", False), ("static again", "static")):
        set_int8(model, flag)
        timing[mode] = timed_forward(torch, lambda: infer(batch))
    log(f"{name} timing (batch {B}; the same model static, dynamic, bf16, "
        f"static): " + json.dumps(timing))
    log(f"{name}: phase 14 (a) took {time.perf_counter() - t0:.1f} s")
    return launches


def int8_finetune_launches(model):
    """Kernel launches of one int8 fine-tune step: the frozen encoder
    and neck run deterministic under ``no_grad``, so every ConvNeXt block
    is one B10 (where :func:`finetune_launches` counts a K1), the neck's
    int8 products keep the prologues off, and attention and B8 run as in
    the bf16 fine-tune."""
    out = finetune_launches(model)
    out[B10] = out.pop("convnext_block_fused")
    del out["ln_dense_fused"], out["gelu_dense_fused"]
    return out


def run_int8_finetune(torch, K):
    """(b) Full-width ``triplane_occ`` fine-tuned at batch ``B_TRAIN`` with
    the encoder and neck int8 and frozen and the head in bf16 (the JAX
    bench's ``bench_occ_train(int8=True)``; seeded weights): kernels vs
    twins as phase 6, the first loss within ``INT8_FINETUNE_LOSS_TOL`` of
    the same step without int8 on the same weights and batch, three steps
    (the first launching :func:`int8_finetune_launches`; finite losses,
    the head moved, every frozen tensor bit-identical), ms and device ms a
    step beside the same step without int8.  Returns the launches."""
    from efficient_multimodal_perception_tpu_torch.configs import get_config
    from efficient_multimodal_perception_tpu_torch.data.synthetic import (
        synthetic_batch)
    from efficient_multimodal_perception_tpu_torch.models.builder import (
        build_model)
    from efficient_multimodal_perception_tpu_torch.ops.quant import (
        enable_int8)
    from efficient_multimodal_perception_tpu_torch.train.trainer import (
        build_trainer, loss_and_grads)

    t0 = time.perf_counter()
    name = "int8 finetune"
    cfg = get_config("triplane_occ")
    enable_int8(cfg["model"], parts=("encoder", "neck"))
    model = draw_gamma_and_stats(torch, build_model(
        cfg["model"], device="cuda", dtype=torch.bfloat16, seed=0))
    trainer = build_trainer(cfg, model, total_steps=3, seed=0)
    named = trainer.named
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    if {n.split(".")[0] for n, _ in named} != {"decoder"}:
        raise AssertionError(f"{name}: trainable tensors are not the head")
    batch = synthetic_batch(B_TRAIN, point_budget=cfg["data"]["point_budget"],
                            with_occ=True, seed=0, device="cuda")
    _, loss8, _ = loss_and_grads(model, trainer.params, batch,
                                 trainer.generator(0))
    set_int8_parts(model, ("encoder", "neck"), False)
    _, loss16, _ = loss_and_grads(model, trainer.params, batch,
                                  trainer.generator(0))
    set_int8_parts(model, ("encoder", "neck"), True)
    loss_err = abs(float(loss8) - float(loss16)) / abs(float(loss16))
    log(f"{name} first loss: " + json.dumps(dict(
        int8=float(loss8), bf16=float(loss16), rel_err=loss_err,
        bound=INT8_FINETUNE_LOSS_TOL)))
    if not math.isfinite(float(loss8)) or loss_err > INT8_FINETUNE_LOSS_TOL:
        raise AssertionError(f"{name}: first loss {float(loss8)} vs "
                             f"{float(loss16)}")

    before = {n: p.detach().clone() for n, p in named}
    launches, first = finetune_check(torch, K, model, trainer, batch, name,
                                     int8_finetune_launches(model))
    steps = [first] + [trainer.train_step(batch) for _ in range(2)]
    torch.cuda.synchronize()
    logs = [{k: float(v) for k, v in st.items()} for st in steps]
    still = [n for n, p in named if torch.equal(p, before[n])]
    changed = [n for n, p in model.named_parameters()
               if n in frozen and not torch.equal(p, frozen[n])]
    log(f"{name} steps: " + json.dumps(logs) + f"; {len(named) - len(still)}"
        f"/{len(named)} head tensors moved, {len(changed)} of "
        f"{len(frozen)} frozen tensors changed")
    if not all(math.isfinite(v) for st in logs for v in st.values()):
        raise AssertionError(f"{name}: non-finite step logs")
    if still or changed:
        raise AssertionError(f"{name}: unmoved {still}, changed frozen "
                             f"{changed[:5]}")
    timing = {}
    for mode, on in (("int8", True), ("bf16", False)):
        set_int8_parts(model, ("encoder", "neck"), on)
        timing[mode] = timed_forward(torch, lambda: trainer.train_step(batch))
    log(f"{name} timing (batch {B_TRAIN}; the same model with int8, then "
        "without): " + json.dumps(timing))
    log(f"{name}: phase 14 (b) took {time.perf_counter() - t0:.1f} s")
    return launches


def qat_launches(model):
    """Kernel launches and B10 VJP calls of one quantization-aware
    ``triplane_range_cam`` step (``QAT_OPTIONS``): the unmasked step's
    (``PER_TRAIN_STEP``) outside the encoders, less the neck's prologues
    (its int8 products keep them off); a block with no drop-path (the
    frozen stage 0) one B10 forward where phase 5 runs K1, and where the
    encoder's input trains (the lidar encoder) one call of B10's VJP where
    K1's backward runs; every other block the unfused int8 route (torch
    products with the straight-through backward, no kernel)."""
    out = {k: v for k, v in PER_TRAIN_STEP.items()
           if k not in ("convnext_block_fused", "epilogue_fused",
                        "post_epilogue_bwd", "post_epilogue_bwd_wide",
                        "ln_dense_fused", "gelu_dense_fused")}
    for enc, input_trains in ((model.encoder.camera_encoder, False),
                              (model.encoder.lidar_encoder, True)):
        n = sum(blk.drop_path_rate == 0.0 for st in enc.stages for blk in st)
        out[B10] = out.get(B10, 0) + n
        if input_trains:
            out[B10_VJP] = out.get(B10_VJP, 0) + n
    return out


def block_args(blk, x):
    """``x`` and a ConvNeXt block's parameters, as B10 takes them."""
    return (x, blk.dwconv.weight, blk.dwconv.bias, blk.norm.weight,
            blk.norm.bias, blk.pwconv1.weight, blk.pwconv1.bias,
            blk.pwconv2.weight, blk.pwconv2.bias, blk.gamma)


def block_inputs(torch, model, batch, blocks):
    """The inputs that ``blocks`` take in one deterministic forward of
    ``model`` on ``batch``."""
    seen = {}
    hooks = [b.register_forward_pre_hook(
        lambda m, a, i=i: seen.setdefault(i, a[0].detach().clone()))
        for i, b in enumerate(blocks)]
    try:
        with torch.no_grad():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return [seen[i] for i in range(len(blocks))]


def b10_vjp_and_cache(torch, K, model, trainer, batch, vjp_calls):
    """B10's VJP on the lidar stage-0 block's input (the step's shape) for
    the gradient of the input only, as in the step (the block is frozen),
    against autograd of ``K.block_int8_xla`` on the same inputs (within
    ``REL_TOL``), both timed (event ms, device ms; a step calls the VJP
    ``vjp_calls`` times).  Then B10 after the flat AdamW's update: B10
    on a trainable camera stage-1 block (its weight codes cached), one
    ``Trainer.train_step``, B10 again, which must equal its twin bit for
    bit on the moved weights; and on the model's frozen lidar stage-0
    blocks, B10 against the twin."""
    from efficient_multimodal_perception_tpu_torch.ops.quant import (
        quantize_weight)

    enc = model.encoder
    lid, cam = enc.lidar_encoder.stages[0], enc.camera_encoder.stages[1][0]
    x, xc = block_inputs(torch, model, batch, (lid[0], cam))
    g = torch.Generator(device=x.device).manual_seed(14)
    gout = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    params = block_args(lid[0], x)[1:]
    needs = (True,) + (False,) * 9

    def vjp():
        return K.convnext_block_int8_bwd(x, *params, gout, needs=needs)[0]

    def chain():
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = K.block_int8_xla(xx, *params)
            return torch.autograd.grad(out, xx, gout)[0]

    err = rel_err(torch, vjp(), chain())
    row = dict(shape=f"lidar stage0 {tuple(x.shape)}", calls=vjp_calls,
               rel_err_vs_autograd=err, tol=REL_TOL,
               ms=time_ms(torch, vjp, 10), device_ms=device_ms(torch, vjp),
               autograd_ms=time_ms(torch, chain, 10),
               autograd_device_ms=device_ms(torch, chain))
    row.update(step_device_ms=vjp_calls * row["device_ms"],
               step_autograd_device_ms=vjp_calls * row["autograd_device_ms"])
    log("int8 QAT B10 VJP (torch ops; yardstick: autograd of the plain STE "
        "chain): " + json.dumps(row))
    if not err <= REL_TOL:
        raise AssertionError(f"B10 VJP vs autograd: {err}")

    with torch.no_grad():
        before = K.convnext_block_int8(*block_args(cam, xc))
        w_before = cam.pwconv1.weight.detach().clone()
    trainer.train_step(batch)
    with torch.no_grad():
        after = K.convnext_block_int8(*block_args(cam, xc))
        twin = K.convnext_block_int8_plain(*block_args(cam, xc))
        frozen = [torch.equal(K.convnext_block_int8(*block_args(b, x)),
                              K.convnext_block_int8_plain(*block_args(b, x)))
                  for b in lid]
    codes_moved = not torch.equal(quantize_weight(w_before)[0],
                                  quantize_weight(cam.pwconv1.weight)[0])
    out = dict(block_input=list(xc.shape),
               weights_moved=not torch.equal(w_before, cam.pwconv1.weight),
               codes_moved=codes_moved,
               output_moved=not torch.equal(before, after),
               b10_equals_twin_after_update=torch.equal(after, twin),
               frozen_stage0_b10_equals_twin=frozen)
    log("int8 QAT B10 after the flat AdamW's update (camera stage-1 block "
        "0, its codes cached before the step): " + json.dumps(out))
    if not (codes_moved and out["output_moved"]
            and out["b10_equals_twin_after_update"] and all(frozen)):
        raise AssertionError(f"B10 after the update: {out}")


def run_int8_qat(torch, K):
    """(c) One quantization-aware ``triplane_range_cam`` run at batch
    ``B_TRAIN`` (``enable_int8`` on the encoder and neck at the shipped
    drop-path rates) through phase 10's ``run_pretrain``: kernels vs twins
    (phase 5's bounds, every gradient group; no tensor without a
    gradient), three steps launching :func:`qat_launches` (B10's forward
    and VJP where K1 runs in phase 5), every trainable tensor moved,
    timing; then :func:`b10_vjp_and_cache`, and the step's ms and device
    ms beside the same model's bf16 step (int8 off).  Returns the
    launches."""
    t0 = time.perf_counter()
    name = "int8 QAT triplane_range_cam train"
    run = run_pretrain(torch, K, "triplane_range_cam", qat_launches,
                       cfg_options=QAT_OPTIONS, label=name)
    b10_vjp_and_cache(torch, K, run.model, run.trainer, run.batch,
                      run.launches[B10_VJP])
    timing = {}
    for mode, on in (("int8", True), ("bf16", False), ("int8 again", True)):
        set_int8_parts(run.model, ("encoder", "neck"), on)
        timing[mode] = timed_forward(
            torch, lambda: run.trainer.train_step(run.batch))
    log(f"{name} step beside bf16 (batch {B_TRAIN}; the same model, int8 "
        "on, off, on): " + json.dumps(timing))
    log(f"{name}: phase 14 (c) took {time.perf_counter() - t0:.1f} s")
    return run.launches


def run_int8_train(torch, K):
    """Phase 14: (a) static int8 serving, (b) the int8 fine-tune, (c) the
    quantization-aware step.  Returns their launches by path."""
    t0 = time.perf_counter()
    out = {"int8_static_serve_forward": run_static_serve(torch, K)}
    torch.cuda.empty_cache()
    out["int8_finetune_step"] = run_int8_finetune(torch, K)
    torch.cuda.empty_cache()
    out["int8_qat_step"] = run_int8_qat(torch, K)
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    log("K3/K4 GEMM launch: " + json.dumps(K.dense_launch_config()))
    log_attention_build(K, _build)

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
        "point_train_step": run_point_train(torch, K),
    })
    launches.update({
        "elev_serve_forward": run_elev_serve(torch, K, int8=False),
        "int8_elev_serve_forward": run_elev_serve(torch, K, int8=True),
        "elev_finetune_step": run_elev_finetune(torch, K, ckpt_path),
    })
    launches.update({
        "surf_sam_train_step": run_pretrain(
            torch, K, "triplane_surf_sam", surf_sam_launches).launches,
        "point_pretrain_step": run_pretrain(
            torch, K, "point_triplane", point_pretrain_launches,
            "*").launches,
    })
    torch.cuda.empty_cache()
    launches.update(run_data(torch, K, ckpt_path))
    launches.update(run_export_flags(torch, K, ckpt_path))
    os.remove(ckpt_path)
    launches.update(run_masked(torch, K))
    launches.update(run_int8_train(torch, K))
    missing = [n for n in K.LAUNCHES
               if not any(c.get(n, 0) for c in launches.values())]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all (the "
        "kernels' build included)")
    print(json.dumps({"kernels": kernel_record(per, launches)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

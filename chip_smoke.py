#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. device — the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN, so every fp32 comparison below is fp32.
2. build — every CUDA source of the port, with nvcc, one process each.
3. kernel K1 (`fc_relu`) against its plain PyTorch version on the card,
   at the VGG-16 classifier shapes for every serving bucket and M = 128
   (the training batch) and a ragged MLP shape, fp32, bf16 and fp16,
   through the library's route (printed) and each route that takes the
   shape (tensor_core, cuda_core); times of the library's route, of each
   route, the plain version and one library call beside the bound, with
   L2 flushed before every timed launch, and each route's device time
   (torch.profiler, its kernels only); then train_mnist's mlp layers,
   (64, 784 -> 128) and (64, 128 -> 64), in fp32 through both routes;
   then the host time per call of each route at fc7, M = 32, beside the
   library call's.
4. serve VGG-16 at full width (3x224x224, 1000 classes, fp32, random
   weights from a seed) through `serving.ModelServer`: partition with
   TPU_PALLAS, save a checkpoint pair, load it, answer a closed-loop load
   of mixed-size requests from concurrent clients, then one request at a
   time of sizes that reach every bucket; check each answer against the
   unpartitioned graph on the card, and check that K1 ran twice per
   dispatched batch; then print the device time by kernel of one
   bucket-32 dispatch and the device's busy share (torch.profiler).
3b. kernels K2 (`flash_fwd`, whole KV) and K3 (`flash_fwd_stream`,
   split KV) through `flash_attention_partial` against their plain
   version `_partial_ref` on the card, in fp32 (3xTF32), bf16 and fp16:
   the long-context shapes (2, 8192, 8, 64) and (1, 32768, 1, 64),
   ring-shard offsets at T = 2048, the fully-masked shard (held to the
   contract m = -1e30, l = 0, o = 0), a ragged T = 1000 at D = 64, 128
   and 136, the wide heads (2, 8192, 8, 128) and (2, 8192, 8, 256) (two
   column groups of O), heads past 256 (the CUDA-core route: (2, 2048, 8,
   512) causal in every dtype through K2 and in fp32 through K3, a ragged
   (2, 1000, 8, 264)) and q, k, v sliced from one packed (B, T, 3, H, D)
   tensor; each case checks that its route's launch counter moved; times
   of the kernel, the plain version and SDPA (a yardstick only, where it
   computes the same function) beside the bound, with the achieved
   TFLOP/s and the share of the bound, and the call's device time under
   torch.profiler (at T <= 2048 the CUDA-event time is mostly the
   host's); then the wrapper's host time per call at (2, 2048, 8, 64).
5. the attention path at full width, the counts of K2 and K3 set to 0
   before it and read after it: `flash_attention` forward and backward
   at (2, 8192, 8, 64) bf16 causal (one K2 launch), output and gradients
   against fp32 T x T attention through autograd; `ring_attention(...,
   use_pallas=True)` without a process group (one more K2 launch, equal
   to `flash_attention`); the same in fp32 (one more K2 launch); the
   long-context envelope (1, 32768, 1, 64) causal forward and backward in
   fp32 (one K3 launch by default) and in bf16 under
   MXNET_FLASH_VMEM_MB=4 (one more K3 launch), checked the same way; then
   forward and forward+backward times beside SDPA's.

6. training: train_mnist's ``mlp`` (under MXNET_SUBGRAPH_BACKEND=
   TPU_PALLAS, so K1 runs fc1+relu1 and fc2+relu2) and ``lenet`` through
   the port's `Module.fit` on the card with train_mnist's defaults
   (synthetic MNIST, 3584 training and 512 validation images, batch 64,
   SGD lr 0.05 momentum 0.9, Xavier, 10 epochs); first the first 8 steps
   of each on the card against the same 8 steps on the CPU (same initial
   parameters and batch order; lenet's max-pool windows that flip between
   the devices are counted, see `parity_case`); K1's launches exactly 2
   per mlp train and eval forward and 0 for lenet; validation accuracy
   above 0.95; the median step ms and samples/s, and K1's share of one
   profiled mlp step's device time; then the trained mlp's checkpoint
   served through `serving.ModelServer` in fp32 (held to
   `Module.predict`) and bf16.
7. ResNet-50 v1, the BASELINE lane (bench.py:165-211): gluon
   `resnet50_v1(classes=1000)` composed on a Symbol + SoftmaxOutput,
   trained by `Module.fit` through the fused train step (BatchNorm, the
   multi-tensor SGD, the metric on the card); no TPU kernel is on this
   path (its one FC has no ReLU).  a. 3 fused steps at batch 4, 3x224x224,
   on the card against the CPU from the same Xavier parameters and
   batches, in float64: every step's loss, and from the CPU's state each
   step's parameters, momenta and 106 aux arrays (max-pool windows that
   flip between the devices are counted and excuse only conv1 and its
   BatchNorm at that step); in float32, where rounding grows through
   the 53 BatchNorms at batch 4, each device's step from the float64
   state is held to the float64 step: the card as close as the CPU.
   b. the lane at batch 128 in bf16 with multi_precision on one
   resident random batch, 8 warm + 48 timed steps:
   the fused step every step, the loss falling, images/s, step ms, peak
   memory and `mfu` (989 TFLOP/s); then fp32 at batch 32 for 16 steps
   (`mfu` of the 67 TFLOP/s CUDA-core peak, TF32 off).  c. one warm bf16
   step under torch.profiler: busy share, device ms by kernel class,
   host ms.  d. 4 fp32 steps at batch 8, the checkpoint served by
   `serving.ModelServer` for requests of 1-8 images, held to
   `Module.predict`.
8. gluon's imperative training.  a. BASELINE #3's plain loop (record,
   backward, Trainer.step) on hybridized resnet50_v2 at batch 4 in
   float64, card against CPU from the same parameters and momenta
   (7a's gates), then one card step hybridized against not.  b. at
   batch 128 in bf16 on one resident batch: bench.py's gluon lane
   (resnet50_v1 through Estimator.fit, the fused gluon step every
   batch), the same lane with the fused step off (the eager loop),
   BASELINE #3 hybridized, and the same loop un-hybridized: images/s,
   step ms, `mfu`, peak memory, `gluon_vs_module`.  c. one warm
   profiled step of each lane but the eager Estimator's.
9. the transformer LM served at GPT-2 small's widths (12 layers, 12
   heads, 768, vocab 50257, max_len 1024; random weights, GPT-2's
   initialisation), the counts of K1, K2 and K3 set to 0 before it and
   required 0 after it.  a. the decode plane on the card against the
   CPU: prefills of 5, 50 and 200 tokens and 8 teacher-forced ticks
   (logits, caches, argmax at clear margins), a step against the prefill
   of what it had seen, a prefill against the hybridized gluon forward,
   bf16 against fp32.  b. `serving.DecodeEngine` (8 slots, buckets 8, 64,
   256) on a mixed trace from 8 client threads in fp32 and bf16, every
   continuation equal to a lockstep lane's; tokens/s, ticks, prefill
   ms.  c. one warm tick under torch.profiler.
10. the LM at the same widths trained through `Module.fit` (SGD lr 0.05,
   momentum 0.9, the gradient per token, Xavier, "acc"), K1/K2/K3 held
   at 0 launches as in 9.  a. 3 fused steps at batch 2 x T 128 in
   float64, card vs CPU: the losses, the embed_weight gradient (lookup
   plus tied head), each step's parameters and momenta from the CPU's
   state; in fp32 each device's step from the float64 state (the card
   as close as the CPU).  b. the lane at batch 8 x T 1024 (n_ctx) in
   fp32, TF32 off, one resident batch, 4 warm + 16 timed steps: tokens/s,
   step ms, peak memory, `mfu` (67 TFLOP/s); then the same with elastic
   checkpoints every 4 batches: the snapshot call's ms, the background
   write's seconds and bytes, the slowdown.  d. one warm step under
   torch.profiler by kernel class, and attention, the head with
   SoftmaxOutput and the one-hot timed alone.  e. the checkpoint served
   by `DecodeEngine`, prefills held to the trained Module's forward.
   c. child processes at 2 layers, batch 4 x 256, deterministic
   algorithms: an uninterrupted fit, one SIGKILLed after batch 8, one
   sent SIGTERM at batch 5 (exit 143, a final snapshot), and resumes
   from both, equal to the uninterrupted fit bit for bit.

The last two lines are a JSON object of per-kernel measurements and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the port's package beside it, the script exits non-zero and
prints no result.  It takes no arguments.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
VGG_FC_SHAPES = ((25088, 4096), (4096, 4096))   # (K, N) of fc6, fc7
BUCKETS = (1, 2, 4, 8, 16, 32)
# K1's rows in phase 3: the serving buckets, and the batch a training step
# of the classifier runs
K1_ROWS = BUCKETS + (128,)
# train_mnist's mlp at batch 64: fc1+relu1 and fc2+relu2, in fp32
MLP_K1 = ((64, 784, 128), (64, 128, 64))
# phase 6: train_mnist's defaults (examples/image_classification/
# train_mnist.py:69-100, :60-66)
TRAIN_IMAGES, TRAIN_SPLIT, TRAIN_BATCH, TRAIN_EPOCHS = 4096, 3584, 64, 10
TRAIN_LR, TRAIN_MOMENTUM = 0.05, 0.9
PARITY_STEPS = 8
# card vs CPU over 8 steps, TF32 off: fp32 sums in other orders (3xTF32
# in K1) through momentum SGD; the loss per step and every parameter
PARITY_TOL = (1e-3, 1e-4)
# served fp32 answers vs Module.predict: the served graph is the saved,
# unpartitioned one (cuBLAS FC+ReLU) and predict's runs K1, so fp32 sums
# in other orders
SERVE_TRAIN_TOL = (1e-4, 1e-5)
# bf16 serving vs the fp32 answers: each layer's output rounded to bf16
# (2**-8 relative), compounding over three layers and the softmax
SERVE_BF16_TOL = (2.0 ** -5, 2.0 ** -6)
# the kernels a K1 call launches (split_tf32 and splitk_epilogue where the
# plan needs them), for the profiler's device time
K1_KERNELS = ("fc_relu_kernel", "fc_relu_tc", "split_tf32", "splitk_epilogue")
IMAGE = (3, 224, 224)
CLASSES = 1000
# the load: CLIENTS threads, each sending REQUESTS_PER_CLIENT requests of
# 1-8 rows one after another (a closed loop); then one request at a time
# of SOLO_ROWS rows, each dispatched alone into its own bucket
CLIENTS = 32
REQUESTS_PER_CLIENT = 24
SOLO_ROWS = (1, 2, 3, 5, 12, 27)        # buckets 1, 2, 4, 8, 16, 32
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type.
# bf16 and fp16 on the tensor cores.  fp32: the least time for fp32-exact
# work is on the tensor cores too, in three TF32 passes (3xTF32): 495/3 =
# 165 TFLOP/s, above the CUDA cores' 67 (against which a 3xTF32 kernel
# could read over 100 % of its bound).  K1's fp32 bound is set by bytes at
# M <= 32 either way.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 165e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
# fp32: the kernel and the plain version add the same fp32 products in
# different orders (the tensor-core route's 3xTF32 products ~2**-21
# relative each); with unit-scale outputs over K <= 25088 terms the
# rounding difference is ~1e-5.  bf16: both round an fp32 sum to bf16,
# which may land one bf16 ulp (2**-8 relative) apart; fp16 the same with
# 3 more mantissa bits (2**-11).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-4),
       torch.float16: (2.0 ** -9, 1e-4)}
# serving vs the unpartitioned graph: the padded bucket and the exact
# request batch let cuDNN pick different fp32 conv algorithms, whose
# rounding compounds over 16 layers
SERVE_TOL = (1e-3, 1e-3)
BF16 = torch.bfloat16
F16 = torch.float16
F32 = torch.float32
# the JSON line's shapes: fc6 at bucket 32, the bucket of the served load,
# in fp32 (the served dtype) and, under keys of its own, bf16
REP = (32, 25088, 4096, F32)
REP_BF16 = (32, 25088, 4096, BF16)
# phase 3b: (label, (B, T, H, D), dtype, causal, (q_off, k_off),
# MXNET_FLASH_VMEM_MB or None for the default, the route it must take)
ATTN_CASES = [
    ("long-context", (2, 8192, 8, 64), BF16, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), BF16, False, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F32, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F32, False, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), "4", "stream"),
    ("long KV", (1, 32768, 1, 64), F32, True, (0, 0), None, "stream"),
    ("ring below", (2, 2048, 8, 64), BF16, True, (2048, 0), None, "whole"),
    ("ring diagonal", (2, 2048, 8, 64), BF16, True, (2048, 2048), None,
     "whole"),
    ("ring above", (2, 2048, 8, 64), BF16, True, (0, 2048), None, "whole"),
    ("ragged", (2, 1000, 8, 64), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 64), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 128), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 128), BF16, True, (0, 0), None, "whole"),
    ("wide head", (2, 8192, 8, 128), BF16, True, (0, 0), None, "whole"),
    ("packed qkv", (2, 2048, 8, 64), BF16, True, (0, 0), None, "whole"),
    # two column groups of O; fp32's 16.8 MB of K and V take K3
    ("widest head", (2, 8192, 8, 256), F32, True, (0, 0), None, "stream"),
    ("widest head", (2, 8192, 8, 256), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 136), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 136), F32, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F16, True, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), F16, True, (0, 0), "4", "stream"),
    # past D = 256: the CUDA-core route, 4 column groups of O at 512
    ("head 512", (2, 2048, 8, 512), F32, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), BF16, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), F16, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), F32, True, (0, 0), "0.001", "stream"),
    ("ragged", (2, 1000, 8, 264), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 264), BF16, True, (0, 0), None, "whole"),
]
# the JSON line's cases: the ones phase 5 runs through each kernel
REP_K2 = ("long-context", (2, 8192, 8, 64), BF16, True, (0, 0), None)
REP_K3 = ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), "4")
# and their fp32 cases (the 3xTF32 route), under keys of their own
REP_K2_F32 = ("long-context", (2, 8192, 8, 64), F32, True, (0, 0), None)
REP_K3_F32 = ("long KV", (1, 32768, 1, 64), F32, True, (0, 0), None)
# kernel vs plain version.  fp32: the same terms, up to 32768 of them,
# summed in other orders, each product 3xTF32 (~2**-21 relative; ~1e-5
# relative in all).  bf16: o is rounded to bf16 (2**-8 relative), and
# each p is rounded to bf16 against a running max that depends on the
# tiling (the kernel's 64-key tiles or split ranges vs the plain
# version's 256-key blocks), noise of 2**-9 of each p*v term that reached
# 0.0044*max|o| in a CPU emulation of the split.  fp16: the same with 3
# more mantissa bits.
ATTN_TOL = {F32: (1e-4, 1e-5), BF16: (2.0 ** -6, 2.0 ** -7),
            F16: (2.0 ** -8, 2.0 ** -9)}
# the port's normalised output vs SDPA: SDPA picks its own backend,
# whose fp32 path may round like TF32 (~1e-3); 16-bit: o rounded twice
# (o, then o / l) against SDPA's once
SDPA_TOL = {F32: (2e-3, 2e-3), BF16: (2.0 ** -6, 2.0 ** -7),
            F16: (2.0 ** -7, 2.0 ** -8)}
# phase 5, the bf16 kernel path against fp32 T x T attention: out is
# rounded to bf16 twice (o, then o / l) and its gradients are rounded
# to bf16 after an fp32 backward that starts from the bf16 out, so
# 2**-6 relative plus 2**-6 of the largest value; fp32: sums of 32768
# terms in other orders (1e-5), with the backward's rowsum(dO*O)
# shortcut against autograd's softmax backward, 1e-3
PATH_TOL = {BF16: (2.0 ** -6, 2.0 ** -6), F32: (1e-3, 1e-4)}
PATH_BLOCK = 512      # block_q, block_k of phase 5 (the repo's long-context
                      # configuration, tests_tpu/test_flash_perf.py)
# phase 7: the BASELINE lane (bench.py:165-211, defaults :683-687): gluon
# resnet50_v1(classes=1000) composed on Variable("data") + SoftmaxOutput,
# 3x224x224, batch 128, bf16 data, SGD lr 0.05 momentum 0.9 with
# multi_precision and rescale_grad 1/batch, Xavier(gaussian, in, 2), "acc";
# one device-resident random batch (bench.py:97-134)
RESNET_BATCH, RESNET_WARM, RESNET_TIMED = 128, 8, 48
RESNET_FP32 = (32, 16)        # (batch, steps) of the fp32 run of the lane
RESNET_PARITY = (4, 3)        # (batch, steps) of the card against the CPU
RESNET_SERVE = (8, 4)         # (batch, steps) of the checkpoint it serves
RESNET_SERVE_SIZES = (1, 3, 8, 2, 5, 7, 4)
RESNET_BUCKETS = (1, 2, 4, 8)
RESNET_OPT = {"learning_rate": 0.05, "momentum": 0.9}
# a bias that feeds a BatchNorm has a zero gradient in exact arithmetic
# (the normalisation removes a constant shift): in float64 it and its
# momentum stay rounding noise (~1e-14), held below this
RESNET_ZERO = 1e-9
# phase 7a float32: the card's distance from the float64 step at most
# this factor times the CPU's, plus this much
RESNET_ENVELOPE = (3.0, 1e-6)
# phase 8: gluon's imperative training.  BASELINE config #3 ("Gluon
# hybridize() ResNet-v2 from gluon.model_zoo.vision") through the plain
# record / backward / Trainer.step loop, and bench.py's gluon lane
# (`_run_gluon`, bench.py:214-290, defaults :683-687): resnet50_v1 in bf16
# through Estimator.fit and the fused gluon step, batch 128, SGD lr 0.05
# momentum 0.9 multi_precision, rescale_grad 1/batch (on top of step's
# 1/batch), Xavier(gaussian, in, 2), Accuracy, one resident random batch
GLUON_WARM, GLUON_TIMED = 8, 48       # the bench lane (Estimator.fit)
V2_WARM, V2_TIMED = 8, 24             # BASELINE #3 (hybridized, plain loop)
V2_EAGER = (4, 12)                    # the same loop, not hybridized
GLUON_PARITY = (4, 3)                 # (batch, steps) card vs CPU, float64
# one card step hybridized vs eager in float64: the same ops in the same
# order, so only a fault moves them apart
HYBRID_TOL = (1e-9, 1e-12)
V2_PREFIX = "resnetv2_"   # a fixed prefix: every instance, the same names
# fp32 outside the tensor cores (TF32 is off), the fp32 lane's peak
FP32_CUDA_CORE_FLOPS = 67e12
# device kernels by class in the profile of one bf16 step (first match)
KERNEL_CLASSES = (
    ("BatchNorm", ("batch_norm",)),
    ("optimizer update and aux copy (multi-tensor)", ("multi_tensor",)),
    ("metric (argmax, compare)", ("argmax", "ArgMax")),
    ("SoftmaxOutput", ("softmax", "Softmax")),
    ("pooling", ("pool",)),
    ("convolution and FC (cuDNN, cuBLAS, layout)",
     ("conv", "xmma", "implicit", "gemm", "cudnn", "cutlass", "nchw",
      "nhwc", "sm90", "wgrad", "dgrad", "fprop", "nvjet")),
    ("reductions (bias gradients, sums)", ("reduce_kernel",)),
    ("elementwise (add, relu, casts, fills)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy")),
)


# phase 9: the transformer LM (llm/) served at GPT-2 small's published
# widths (Radford et al. 2019; the Hugging Face `gpt2` config: n_layer 12,
# n_head 12, n_embd 768, n_ctx 1024, vocab_size 50257), ffn_mult 4; the
# repo's LM has no position embedding and exact gelu, so these are GPT-2
# small's widths, not GPT-2.  eos outside the vocabulary: every sequence
# spends its budget (tools/run_lm_bench.py:50-53)
LM_CFG = dict(vocab_size=50257, num_layers=12, num_heads=12, hidden=768,
              ffn_mult=4, max_len=1024, eos_id=-1)
LM_SLOTS = 8
LM_BUCKETS = (8, 64, 256)
LM_STD = 0.02                 # GPT-2's initializer range
LM_PROMPTS = (5, 50, 200)     # 9a: one prompt per bucket, into slots 0-2
LM_TICKS = 8                  # 9a: teacher-forced decode ticks
# 9a: card vs CPU in fp32 (TF32 off): sums in other orders through 12
# layers and a 50257-way head
LM_TOL = (1e-3, 1e-4)
# a near tie: a top-2 margin at most this share of max|logit|; argmax is
# held only where the margin is larger
LM_TIE = 1e-3
# 9a bf16 (parameters and cache) vs fp32 on the card: each op's output
# rounded to bf16 (2**-8) through 12 layers; the relative L2 of the
# logits, and the margin past which argmax must agree
LM_BF16 = 2.0 ** -5
# 9b: tools/run_lm_bench.py's trace (:82-96, seed 17): groups of 8, seven
# budgets of 3 new tokens and one of 40, prompts of 2-8 tokens; then
# LM_LONG sequences of 9-256 prompt tokens (buckets 64 and 256) with
# budgets of 16-64, submitted by LM_CLIENTS threads
LM_GROUPS, LM_SHORT_NEW, LM_LONG_NEW = 6, 3, 40
LM_LONG = 16
LM_CLIENTS = 8
# 9c: device time by class of one profiled tick, by the inclusive device
# time of the ops the decode plane calls (first match)
LM_OP_CLASSES = (
    ("GEMM (qkv, out_proj, fc1, fc2, head)", ("aten::linear",)),
    ("attention softmax/einsum", ("aten::einsum", "aten::softmax",
                                  "aten::masked_fill", "aten::amax",
                                  "aten::exp", "aten::sub", "aten::sum",
                                  "aten::maximum", "aten::mul",
                                  "aten::where", "aten::full",
                                  "aten::zeros")),
    ("LayerNorm", ("aten::layer_norm",)),
    ("gelu", ("aten::gelu",)),
    ("cache write", ("aten::index_put_", "aten::copy_")),
)
# phase 10: the LM at LM_CFG's widths trained through Module.fit as
# tests/test_llm.py `_fit_lm` trains it (SGD lr 0.05, momentum 0.9,
# Xavier, "acc"), with elastic checkpoints.  SoftmaxOutput sums the
# gradient over the B*T tokens (normalization "null"), so the gradient is
# rescaled by 1/(B*T), the per-token mean (`lm_opt`): the Module's
# default 1/B is T times larger, 85x _fit_lm's T = 12 at n_ctx, and
# diverged to NaN within 10 steps in a CPU rehearsal at T = 256
LM_TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9}
LM_TRAIN_PARITY = (2, 128, 3)       # 10a: batch, T, steps (float64)
LM_TRAIN_LANE = (8, 1024, 4, 16)    # 10b: batch, T (n_ctx), warm, timed
LM_CKPT_PERIOD = 4                  # 10b: processed batches per snapshot
# 10a float32: each device's step from the float64 CPU state, at most
# this factor times the CPU's distance from the float64 step, plus this
LM_TRAIN_ENVELOPE = (3.0, 1e-6)
# 10c: reduced depth (2 layers at width 768, the full vocabulary), batch
# 4 x 256, 2 epochs of 6 shuffled batches, a snapshot every 2 batches;
# SIGKILL after batch 8 (mid epoch 1), SIGTERM once batch 5 is done
LM_RESUME = dict(layers=2, batch=4, t=256, batches=6, epochs=2, period=2,
                 kill_after=8, term_after=5)
LM_RESUME_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# 10d: device kernels of one training step by class (first match)
LM_TRAIN_CLASSES = (
    ("GEMM (the FCs, the head, attention's einsum)",
     ("gemm", "sgemm", "xmma", "cutlass", "nvjet", "gemv", "splitK")),
    ("softmax (attention and the head)", ("softmax", "SoftMax")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("the update (multi-tensor SGD)", ("multi_tensor", "foreach")),
    ("reductions (bias gradients, sums, argmax)", ("reduce_kernel",)),
    ("elementwise (one-hot, masks, gelu, casts, copies)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy", "index",
      "gelu", "embedding", "Embedding", "where", "masked")),
)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def within(got, ref, rtol, atol_scale):
    """max |got - ref| and whether |got - ref| <= rtol*|ref| +
    atol_scale*max|ref| everywhere (compared in got's dtype)."""
    diff = (got.float() - ref.float()).abs()
    bound = rtol * ref.float().abs() + atol_scale * ref.float().abs().max()
    return diff.max().item(), bool((diff <= bound).all())


def time_ms(fn, flush, iters=20):
    """Median time of fn() over `iters` launches, each timed with its own
    CUDA events after the L2 cache is overwritten.  The median, not the
    mean: a launch the host delays (a host whose cores other work shares)
    leaves the card idle inside its events, and one such delay can double
    a mean."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, reps=10, flush=None, names=None, tries=3):
    """Mean device time per call of fn() under torch.profiler: the sum of
    the durations of the kernels it launches, without the host time
    between launches that CUDA events around a small call also count.
    flush: a buffer overwritten before each call (its kernel is not
    counted: give `names`, the substrings of the kernels that are).  A
    profiling session that records no kernel at all (seen once in ~270
    sessions on an H100, right after the same call ran and was checked)
    is run again, up to `tries` sessions; when all of them record none
    (seen once, in phase 3 on an H100), fn() is timed with CUDA events
    instead (`time_ms`: host gaps between its launches included)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        busy = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (names is None or any(n in e.name for n in names)))
        if busy > 0:
            return busy / reps / 1e3
    print(f"device_ms: the profiler saw no device activity in {tries} "
          "sessions; timed with CUDA events instead", flush=True)
    return time_ms(fn, flush if flush is not None else
                   torch.empty(1, device="cuda"))


def bound(m, k, n, dtype):
    """(least ms the card needs for relu(x @ w.T + b), "bytes" or
    "operations"): each input read once and the output written once at
    the HBM rate, against 2*M*N*K operations at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (m * k + n * k + n + m * n) * item / HBM_BYTES_S * 1e3
    t_ops = 2 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_case(x, w, b, card, flush):
    """One K1 shape: parity of the library's route and of each route that
    takes the shape; the event and device times of each route, the plain
    version's and the library call's.  Returns them, the library's route
    and its error."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, \
        fc_relu, fc_relu_ref, launch_plan
    (m, k), n, dtype = x.shape, w.shape[0], x.dtype
    rtol, atol = TOL[dtype]
    chosen = launch_plan(x, w)["route"]
    routes = [r for r in ROUTES if launch_plan(x, w, r) is not None]
    ref = fc_relu_ref(x, w, b)
    errs = {}
    for route in [None] + routes:
        before = fc_relu.launches
        got = fc_relu(x, w, b, route)
        torch.cuda.synchronize()
        check(fc_relu.launches == before + 1,
              f"fc_relu launch counter did not move at {(m, k, n)}")
        check(got.dtype == dtype and got.shape == (m, n),
              f"fc_relu output {got.dtype} {tuple(got.shape)}")
        err, ok = within(got, ref, rtol, atol)
        check(ok, f"fc_relu ({route or chosen}) disagrees with its plain "
                  f"version at {(m, k, n)} {dtype}: max abs err {err:.3e}")
        errs[route or "chosen"] = err
    name = f"{str(dtype)[6:]:8s} M={m:<3d} K={k:<6d} N={n:<5d}"
    print(f"K1 parity {name} route={chosen} max_abs_err={errs['chosen']:.3e}"
          f" ({', '.join(f'{r} {errs[r]:.3e}' for r in routes)}; rtol "
          f"{rtol:g}, atol {atol:g}*max|plain|) ok")
    t_bound, bound_by = bound(m, k, n, dtype)
    t = {"route": chosen, "max_abs_err": errs["chosen"],
         "plain_ms": time_ms(lambda: fc_relu_ref(x, w, b), flush),
         "library_ms": time_ms(
             lambda: torch.relu(torch.addmm(b, x, w.T)), flush),
         "bound_ms": t_bound, "bound_by": bound_by}
    for route in routes:
        call = lambda: fc_relu(x, w, b, route)
        t[f"{route}_ms"] = time_ms(call, flush)
        t[f"{route}_device_ms"] = device_ms(call, flush=flush,
                                            names=K1_KERNELS)
    t["ms"] = t[f"{chosen}_ms"]
    t["device_ms"] = t[f"{chosen}_device_ms"]
    print(f"K1 time   {name} route={chosen} kernel_ms={t['ms']:.4f} "
          f"device_ms={t['device_ms']:.4f} "
          + "".join(f"{r}_ms={t[f'{r}_ms']:.4f} "
                    f"{r}_device_ms={t[f'{r}_device_ms']:.4f} "
                    for r in routes)
          + f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
          f"bound_ms={t_bound:.4f} ({bound_by}) "
          f"{t_bound / t['device_ms']:.3f} of the bound by device time "
          f"[{card}]")
    return t


def note_slower(t, dtype, shape, slower):
    """Record a shape the library gives tensor_core whose device time
    exceeded cuda_core's."""
    if t["route"] == "tensor_core" and \
            t["tensor_core_device_ms"] > t["cuda_core_device_ms"]:
        slower.append(f"{str(dtype)[6:]} {shape} "
                      f"{t['tensor_core_device_ms']:.4f} > "
                      f"{t['cuda_core_device_ms']:.4f} ms")


def kernel_phase(card):
    """Phase 3; returns the JSON numbers of REP and REP_BF16 by dtype, and
    of the mlp shapes by (M, K, N, dtype)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, \
        launch_plan
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n) for k, n in VGG_FC_SHAPES for m in K1_ROWS]
    cases.append((5, 784, 128))
    reps, slower = {}, []
    t0 = time.perf_counter()
    for dtype in (F32, BF16, F16):
        for m, k, n in cases:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(n, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(dtype)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            t = k1_case(x, w, b, card, flush)
            note_slower(t, dtype, (m, k, n), slower)
            if (m, k, n, dtype) in (REP, REP_BF16):
                reps[dtype] = t
            del x, w, b
    for m, k, n in MLP_K1:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        b = 0.1 * torch.randn(n, generator=gen, device=dev)
        check(all(launch_plan(x, w, r) is not None for r in ROUTES),
              f"a K1 route does not take the mlp shape {(m, k, n)}")
        reps[(m, k, n, F32)] = k1_case(x, w, b, card, flush)
        note_slower(reps[(m, k, n, F32)], F32, (m, k, n), slower)
    print(f"K1 routes: shapes the library gives tensor_core whose device "
          f"time exceeded cuda_core's in this run: {slower or 'none'}")
    k1_host_us(card, gen)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    del flush
    return reps


def k1_host_us(card, gen):
    """Host time per call of fc_relu at fc7 (4096 -> 4096), M = 32, by
    route and dtype, beside the library call's: where it exceeds the
    kernels' device time, a lone call's time is the host's."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, fc_relu
    for dtype in (F32, BF16):
        x = torch.randn(32, 4096, generator=gen, device="cuda").to(dtype)
        w = torch.randn(4096, 4096, generator=gen, device="cuda").to(dtype)
        b = torch.randn(4096, generator=gen, device="cuda").to(dtype)
        us = {r: host_us(lambda: fc_relu(x, w, b, r)) for r in ROUTES}
        lib = host_us(lambda: torch.relu(torch.addmm(b, x, w.T)))
        print(f"host: fc_relu {str(dtype)[6:]} M=32 K=4096 N=4096 "
              + ", ".join(f"{r} {us[r]:.1f}" for r in ROUTES)
              + f" us per call on the host; torch.relu(torch.addmm) "
              f"{lib:.1f} [{card}]")


def vgg_params(sym, rng):
    """He-scaled random weights for every argument but ``data``."""
    shapes, _, _ = sym.infer_shape(data=(1,) + IMAGE)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_bias"):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            params[name] = (rng.standard_normal(shape)
                            * math.sqrt(2.0 / fan_in)).astype(np.float32)
    return params


def profile_dispatch(model, card, bucket=32, reps=3, tries=3):
    """Device time by kernel over `reps` warm dispatches of one full
    bucket (torch.profiler), and the device's busy share of that window;
    a session that records no kernel is run again (see device_ms)."""
    from torch.profiler import ProfilerActivity, profile
    arrs = [np.zeros((bucket,) + IMAGE, np.float32)]
    model.run_bucket(arrs, bucket)
    model.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model.run_bucket(arrs, bucket)
            model.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"the profiler saw no device activity in {tries} sessions")
    by_name = {}
    busy = 0.0
    edge = -math.inf
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_name.values())
    print(f"profile: bucket {bucket}, {reps} dispatches, "
          f"{wall_us / reps / 1e3:.2f} ms each on the host clock, device "
          f"busy {busy / wall_us:.3f} of the window [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile: {us / reps / 1e3:9.3f} ms/dispatch "
              f"{us / total:6.3f} {name[:100]}")
    k1 = sum(us for name, us in by_name.items()
             if any(k in name for k in K1_KERNELS))
    print(f"profile: K1 ({' + '.join(K1_KERNELS)}) "
          f"{k1 / reps / 1e3:.3f} ms/dispatch, {k1 / total:.3f} of device "
          "time")


def serve_phase(card, workdir):
    """Serve VGG-16 through ModelServer on gpu(0); returns the K1
    launches of the run (warm-up included)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu

    rng = np.random.RandomState(SEED)
    sym = mx.model_zoo.vgg_symbol(16, classes=CLASSES)
    part = mx.subgraph.partition_graph(sym, "TPU_PALLAS")
    fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
             ].count("_sg_pallas_fc_relu")
    check(fused == 2, f"TPU_PALLAS fused {fused} FC+ReLU chains, want 2")
    t0 = time.perf_counter()
    params = vgg_params(sym, rng)
    print(f"serve: VGG-16 {sum(p.size for p in params.values())} "
          f"parameters from RandomState({SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    load = [[rng.rand(rng.randint(1, 9), *IMAGE).astype(np.float32)
             for _ in range(REQUESTS_PER_CLIENT)] for _ in range(CLIENTS)]
    solo = [rng.rand(r, *IMAGE).astype(np.float32) for r in SOLO_ROWS]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "vgg")
        mx.save_checkpoint(prefix, 0, part, params, {})
        srv = mx.serving.ModelServer(max_queue_latency_ms=5.0, ctx=mx.gpu(0))
        fc_relu.launches = 0
        t0 = time.perf_counter()
        srv.load_model("vgg", prefix=prefix,
                       data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
        print(f"serve: load + warmup of {len(BUCKETS)} buckets "
              f"{time.perf_counter() - t0:.1f} s")

        def ask(x):
            return srv.predict("vgg", {"data": x},
                               timeout_ms=600_000)[0].asnumpy()

        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        errors = []
        gate = threading.Barrier(CLIENTS + 1)

        def client(c):
            gate.wait()
            try:
                for i, x in enumerate(load[c]):
                    answers[c][i] = ask(x)
            except Exception as exc:   # reported below, fails the run
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"chip-smoke-client-{c}")
                   for c in range(CLIENTS)]
        for th in threads:
            th.start()
        gate.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        check(not errors, f"requests failed: {errors[:3]}")
        check(not any(th.is_alive() for th in threads), "a client hung")
        stats = srv.stats()["vgg"]
        solo_answers = [ask(x) for x in solo]
        solo_batches = srv.stats()["vgg"]["batches"] - stats["batches"]
        launches = fc_relu.launches
        profile_dispatch(srv.model("vgg"), card)
        srv.shutdown(drain=True)
    check(solo_batches == len(solo),
          f"{len(solo)} lone requests ran as {solo_batches} batches")
    batches = stats["batches"] + solo_batches
    expect = 2 * (len(BUCKETS) + batches)
    print(f"serve: {stats['batches']} batches for {CLIENTS * REQUESTS_PER_CLIENT}"
          f" requests, then {solo_batches} lone requests of "
          f"{', '.join(map(str, SOLO_ROWS))} rows (buckets "
          f"{', '.join(str(min(b for b in BUCKETS if b >= r)) for r in SOLO_ROWS)}"
          f"); K1 launches {launches}, expected 2 x ({len(BUCKETS)} warmup "
          f"+ {batches}) = {expect}")
    check(launches == expect, "K1 did not run twice per dispatched batch")

    # every answer against the unpartitioned graph (plain FC path)
    device = torch.device("cuda", 0)
    gfn, arg_nodes, _ = mx.sym.graph_eval_fn(sym, False)
    weights = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    worst = 0.0
    rtol, atol = SERVE_TOL
    pairs = [(x, got) for xs, gots in zip(load, answers)
             for x, got in zip(xs, gots)] + list(zip(solo, solo_answers))
    with torch.inference_mode():
        for x, got in pairs:
            feed = dict(weights, data=torch.from_numpy(x).to(device))
            ref = gfn([feed[n.name] for n in arg_nodes], [])[0][0]
            check(got.shape == (x.shape[0], CLASSES)
                  and np.isfinite(got).all(),
                  f"answer shape {got.shape} or non-finite values")
            err, ok = within(torch.from_numpy(got), ref.cpu(), rtol, atol)
            worst = max(worst, err)
            check(ok, f"served answer disagrees with the unpartitioned "
                      f"graph (max abs err {err:.3e})")
    rows = sum(len(x) for xs in load for x in xs)
    print(f"serve: {len(pairs)} answers match the unpartitioned graph, "
          f"max_abs_err {worst:.3e} (rtol {rtol:g}, atol {atol:g}*max|ref|)")
    print(f"serve: load of {CLIENTS} closed-loop clients: {rows} images in "
          f"{stats['responses']} requests over {wall:.3f} s = "
          f"{rows / wall:.1f} images/s, p50 {stats['p50_ms']:.1f} ms, "
          f"p99 {stats['p99_ms']:.1f} ms, batch occupancy "
          f"{stats['batch_occupancy']:.3f} [{card}]")
    return launches


def attn_ops(b, h, tq, tk, d, causal, q_off, k_off):
    """4*D operations for every (query, key) pair the causal mask leaves
    (these offsets' pairs, counted exactly)."""
    if causal:
        seen = np.clip(q_off + np.arange(tq) - k_off + 1, 0, tk)
        pairs = int(seen.sum())
    else:
        pairs = tq * tk
    return 4 * b * h * pairs * d


def attn_bound(b, h, tq, tk, d, dtype, causal, q_off, k_off):
    """(least ms for one partial-attention call, "bytes" or "operations"):
    q, k, v read and o, m, l written once at the HBM rate, against
    `attn_ops` at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_ops = attn_ops(b, h, tq, tk, d, causal, q_off, k_off) / \
        PEAK_FLOPS[dtype] * 1e3
    t_bytes = ((2 * b * tq * h * d + 2 * b * tk * h * d) * item
               + 2 * b * h * tq * 4) / HBM_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_inputs(shape, dtype, seed, packed=False):
    """q, k, v of `shape` from a seed; packed: views of one (B, T, 3, H,
    D) tensor, as a fused QKV projection leaves them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        b, t, h, d = shape
        qkv = torch.randn(b, t, 3, h, d, generator=gen,
                          device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return tuple(torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def set_budget(budget):
    """Set MXNET_FLASH_VMEM_MB (None: unset); returns the value before."""
    old = os.environ.pop("MXNET_FLASH_VMEM_MB", None)
    if budget is not None:
        os.environ["MXNET_FLASH_VMEM_MB"] = budget
    return old


def sdpa_equivalent(causal, offs, t):
    """(is_causal of the SDPA call that computes the same normalised
    attention as this partial call, or None, and the reason when None)."""
    q_off, k_off = offs
    if not causal or q_off - k_off >= t - 1:
        return False, None          # every row sees every key
    if q_off == k_off:
        return True, None           # the diagonal where SDPA puts it
    if k_off >= q_off + t:
        return None, ("no row sees a key: SDPA computes no such call (its "
                      "softmax over no key is not the contract's m = -1e30, "
                      "l = 0, o = 0)")
    return None, "a shifted diagonal: SDPA's is_causal has no offset"


def host_us(fn, calls=200):
    """Host time per call of fn(), in microseconds: the enqueue, which is
    a small call's time when the device keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_us_per_call(card):
    """Host time per call of flash_attention_partial at (2, 2048, 8, 64)
    bf16 causal (the enqueue, which is the call's time at this size), and
    of the two fills its m and l took before they were torch.empty."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v = attn_inputs((2, 2048, 8, 64), BF16, 99)

    def fills():
        torch.full((2, 8, 2048), -1e30, dtype=torch.float32, device="cuda")
        torch.zeros((2, 8, 2048), dtype=torch.float32, device="cuda")

    call = host_us(lambda: fa.flash_attention_partial(q, k, v, 0, 0, True))
    before = host_us(fills)
    print(f"host: flash_attention_partial bf16 2x2048x8x64 causal "
          f"{call:.1f} us per call on the host (m, l by torch.empty); the "
          f"two fills m and l took before (torch.full + torch.zeros of "
          f"(B, H, Tq)) {before:.1f} us per call [{card}]")


def attn_kernel_phase(card, flush):
    """Phase 3b: K2 and K3 against `_partial_ref`; returns the JSON
    numbers of REP_K2, REP_K3, REP_K2_F32 and REP_K3_F32."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    reps = {}
    for seed, (label, shape, dtype, causal, offs, budget, route) in \
            enumerate(ATTN_CASES):
        b, t, h, d = shape
        q, k, v = attn_inputs(shape, dtype, seed, label == "packed qkv")
        old = set_budget(budget)
        try:
            check(fa._route(t, d, dtype) == route,
                  f"{label} {shape} takes route {fa._route(t, d, dtype)}")
            wrapper = fa.flash_fwd if route == "whole" else \
                fa.flash_fwd_stream
            other = fa.flash_fwd_stream if route == "whole" else fa.flash_fwd
            counts = (wrapper.launches, other.launches)
            o, m, l = fa.flash_attention_partial(q, k, v, *offs, causal)
            torch.cuda.synchronize()
            check((wrapper.launches, other.launches)
                  == (counts[0] + 1, counts[1]),
                  f"{label} {shape}: {wrapper.__name__} did not launch once")
            run = lambda: fa.flash_attention_partial(q, k, v, *offs, causal)
            ms = time_ms(run, flush)
            dev_ms = device_ms(run)
        finally:
            set_budget(old)
        name = (f"{route:6s} {label:13s} {str(dtype)[6:]:8s} "
                f"{'x'.join(map(str, shape)):14s} causal={causal!s:5s} "
                f"off={offs}")
        check(o.dtype == dtype and o.shape == shape
              and m.shape == l.shape == (b, h, t), f"{name}: output shapes")
        if offs[1] >= offs[0] + t and causal:
            # every key after every query: the kernel's contract
            ok = bool((o == 0).all() and (l == 0).all()
                      and (m == -1e30).all())
            print(f"K2/K3 parity {name} m=-1e30, l=0, o=0 (the contract "
                  f"for rows that see no key) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name}: rows with no visible key break the contract")
            err = 0.0
        else:
            rtol, atol = ATTN_TOL[dtype]
            plain = fa._ref_bthd(q, k, v, *offs, causal, 256)
            errs, oks = zip(*(within(g, w, rtol, atol)
                              for g, w in zip((o, m, l), plain)))
            err = errs[0]
            print(f"K2/K3 parity {name} max_abs_err o={errs[0]:.3e} "
                  f"m={errs[1]:.3e} l={errs[2]:.3e} (rtol {rtol:g}, atol "
                  f"{atol:g}*max|plain|) {'ok' if all(oks) else 'FAIL'}")
            check(all(oks), f"{name}: kernel disagrees with _partial_ref")
        t_bound, bound_by = attn_bound(b, h, t, t, d, dtype, causal, *offs)
        times = {"ms": ms, "bound_ms": t_bound, "bound_by": bound_by,
                 "max_abs_err": err, "library_ms": None,
                 "plain_ms": time_ms(lambda: fa._ref_bthd(
                     q, k, v, *offs, causal, 256), flush)}
        lib_causal, why = sdpa_equivalent(causal, offs, t)
        if lib_causal is None:
            print(f"K2/K3 vs SDPA {name} n/a: {why}")
        else:
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=lib_causal)
            times["library_ms"] = time_ms(lib, flush)
            out = o / l.transpose(1, 2)[..., None].to(o.dtype)
            rtol, atol = SDPA_TOL[dtype]
            serr, sok = within(out, lib().transpose(1, 2), rtol, atol)
            print(f"K2/K3 vs SDPA {name} (kernel + division, normalised; "
                  f"SDPA is_causal={lib_causal}) max_abs_err={serr:.3e} "
                  f"(rtol {rtol:g}, atol {atol:g}*max|SDPA|) "
                  f"{'ok' if sok else 'FAIL'}")
            check(sok, f"{name}: the port's attention disagrees with SDPA")
        lib_ms = ("n/a" if times["library_ms"] is None
                  else f"{times['library_ms']:.4f}")
        tflops = attn_ops(b, h, t, t, d, causal, *offs) / ms / 1e9
        print(f"K2/K3 time   {name} kernel_ms={ms:.4f} "
              f"plain_ms={times['plain_ms']:.4f} library_ms={lib_ms} "
              f"bound_ms={t_bound:.4f} ({bound_by}) {tflops:.1f} TFLOP/s, "
              f"{t_bound / ms:.3f} of the bound; device_ms={dev_ms:.4f} "
              f"(profiler) [{card}]")
        key = (label, shape, dtype, causal, offs, budget)
        if key in (REP_K2, REP_K3, REP_K2_F32, REP_K3_F32):
            reps[key] = dict(times, shape=f"{str(dtype)[6:]} "
                             f"B,T,H,D={b},{t},{h},{d} causal={causal}")
        del q, k, v, o, m, l
    host_us_per_call(card)
    return reps


def plain_attention(q, k, v, causal):
    """fp32 attention with the (T, T) scores, the autograd reference."""
    d = q.shape[-1]
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(d)
    if causal:
        t = s.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2)


def path_case(shape, dtype, seed):
    """flash_attention forward and backward against plain_attention in
    fp32 on the same inputs; returns (out, q, k, v) for the ring check."""
    from incubator_mxnet_tpu_torch.ops.flash_attention import flash_attention
    q, k, v = (x.requires_grad_() for x in attn_inputs(shape, dtype, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    tgt = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK)
    ((out.float() - tgt.float()) ** 2).sum().backward()
    torch.cuda.synchronize()
    refs = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = plain_attention(*refs, True)
    ((ref - tgt.float()) ** 2).sum().backward()
    rtol, atol = PATH_TOL[dtype]
    results = [(name, *within(g, w, rtol, atol), w.abs().max().item())
               for name, g, w in (("out", out, ref),
                                  ("dq", q.grad, refs[0].grad),
                                  ("dk", k.grad, refs[1].grad),
                                  ("dv", v.grad, refs[2].grad))]
    for name, err, ok, top in results:
        print(f"path  {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):14s} "
              f"{name:3s} max_abs_err={err:.3e} max|ref|={top:.3e} vs fp32 "
              f"T x T autograd (rtol {rtol:g}, atol {atol:g}*max|ref|) "
              f"{'ok' if ok else 'FAIL'}")
    check(all(ok for _, _, ok, _ in results),
          f"flash_attention {shape} {dtype} disagrees with plain attention")
    del ref, refs
    return out.detach(), q.detach(), k.detach(), v.detach()


def path_times(shape, dtype, card, flush, seed):
    """Forward and forward+backward ms of flash_attention and of SDPA."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.flash_attention import flash_attention
    q, k, v = (x.requires_grad_() for x in attn_inputs(shape, dtype, seed))
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    g = torch.ones(shape, dtype=dtype, device="cuda")
    gh = g.transpose(1, 2).contiguous()

    def port_fwd():
        with torch.no_grad():
            flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK)

    def port_both():
        flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK).backward(g)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_both():
        F.scaled_dot_product_attention(qh, kh, vh,
                                       is_causal=True).backward(gh)

    t = {name: time_ms(fn, flush, iters=5) for name, fn in
         (("fwd", port_fwd), ("fwd+bwd", port_both), ("sdpa fwd", sdpa_fwd),
          ("sdpa fwd+bwd", sdpa_both))}
    budget = os.environ.get("MXNET_FLASH_VMEM_MB", "default")
    print(f"path  {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):14s} "
          f"MXNET_FLASH_VMEM_MB={budget} "
          f"causal flash_attention forward {t['fwd']:.3f} ms, forward+"
          f"backward {t['fwd+bwd']:.3f} ms; SDPA forward "
          f"{t['sdpa fwd']:.3f} ms, forward+backward "
          f"{t['sdpa fwd+bwd']:.3f} ms [{card}]")


def attention_path_phase(card, flush):
    """Phase 5; returns the K2 and K3 launches of the path's run."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import ring_attention
    import torch.distributed as dist
    check(not (dist.is_available() and dist.is_initialized()),
          "a process group is initialised")
    old = set_budget(None)
    try:
        fa.flash_fwd.launches = 0
        fa.flash_fwd_stream.launches = 0
        out, q, k, v = path_case((2, 8192, 8, 64), BF16, 0)
        check((fa.flash_fwd.launches, fa.flash_fwd_stream.launches)
              == (1, 0), "flash_attention forward+backward launched "
              f"K2 {fa.flash_fwd.launches}, K3 {fa.flash_fwd_stream.launches}"
              " times, want 1, 0")
        ring = ring_attention(q, k, v, causal=True, use_pallas=True)
        torch.cuda.synchronize()
        check(fa.flash_fwd.launches == 2, "ring_attention(use_pallas=True) "
              "did not launch K2 once")
        rtol, atol = ATTN_TOL[BF16]
        err, ok = within(ring, out, rtol, atol)
        print(f"path  ring_attention(use_pallas=True), no process group: "
              f"max_abs_err={err:.3e} vs flash_attention (rtol {rtol:g}, "
              f"atol {atol:g}*max|flash|) {'ok' if ok else 'FAIL'}")
        check(ok, "ring_attention disagrees with flash_attention")
        del out, q, k, v, ring
        torch.cuda.empty_cache()
        path_case((2, 8192, 8, 64), F32, 6)
        check(fa.flash_fwd.launches == 3, "fp32 flash_attention did not "
              "launch K2 once")
        torch.cuda.empty_cache()
        path_case((1, 32768, 1, 64), F32, 1)
        torch.cuda.empty_cache()
        set_budget("4")
        path_case((1, 32768, 1, 64), BF16, 4)
        set_budget(None)
        launches = (fa.flash_fwd.launches, fa.flash_fwd_stream.launches)
        check(launches == (3, 2), f"the path launched K2, K3 {launches} "
              "times, want 3, 2")
        print(f"path  launches: K2 {launches[0]} (flash_attention bf16 + "
              f"ring + flash_attention fp32), K3 {launches[1]} (the 32768 "
              "envelope, fp32 and bf16 under MXNET_FLASH_VMEM_MB=4)")
        torch.cuda.empty_cache()
        path_times((2, 8192, 8, 64), BF16, card, flush, 2)
        path_times((2, 8192, 8, 64), F32, card, flush, 7)
        path_times((1, 32768, 1, 64), F32, card, flush, 3)
        set_budget("4")
        path_times((1, 32768, 1, 64), BF16, card, flush, 5)
    finally:
        set_budget(old)
    return launches


def mlp_symbol(mx):
    """train_mnist's ``mlp`` (examples/image_classification/
    train_mnist.py get_mlp)."""
    s = mx.sym
    data = s.Flatten(s.Variable("data"))
    fc1 = s.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = s.Activation(fc1, name="relu1", act_type="relu")
    fc2 = s.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = s.Activation(fc2, name="relu2", act_type="relu")
    fc3 = s.FullyConnected(act2, name="fc3", num_hidden=10)
    return s.SoftmaxOutput(fc3, name="softmax")


def lenet_symbol(mx):
    """train_mnist's ``lenet`` (get_lenet)."""
    s = mx.sym
    x = s.Variable("data")
    for nf in (20, 50):
        x = s.Convolution(x, kernel=(5, 5), num_filter=nf)
        x = s.Activation(x, act_type="tanh")
        x = s.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = s.Activation(s.FullyConnected(s.Flatten(x), num_hidden=500),
                     act_type="tanh")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=10),
                           name="softmax")


def mnist_iters(mx):
    """train_mnist's synthetic stand-in: 3584 training images (shuffled
    by np.random, seeded here) and 512 validation images."""
    x, y = mx.test_utils.get_mnist_like(TRAIN_IMAGES)
    np.random.seed(SEED)
    return (mx.io.NDArrayIter(x[:TRAIN_SPLIT], y[:TRAIN_SPLIT], TRAIN_BATCH,
                              shuffle=True),
            mx.io.NDArrayIter(x[TRAIN_SPLIT:], y[TRAIN_SPLIT:], TRAIN_BATCH))


def cross_entropy(probs, labels):
    """Mean -log p[label] of one batch's softmax outputs."""
    p = probs.asnumpy()
    return float(-np.log(p[np.arange(len(p)),
                           labels.asnumpy().astype(int)]).mean())


def first_steps(mx, sym, ctx, batches, teacher=None):
    """PARITY_STEPS Module steps (forward_backward, update) on `ctx` from
    Xavier parameters under mx.random.seed(SEED): the loss of each step
    and the states, ({name: parameter}, {name: momentum}), before the
    first step and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (TRAIN_BATCH, 1, 28, 28))],
             [("softmax_label", (TRAIN_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": TRAIN_LR,
                                         "momentum": TRAIN_MOMENTUM})
    names = mod._exec_group.param_names
    losses = []
    states = [({n: v.asnumpy() for n, v in mod.get_params()[0].items()}, {})]
    for k, batch in enumerate(batches):
        if teacher is not None and k:
            params, moms = teacher[k]
            mod.set_params(params, {})
            for i, n in enumerate(names):
                mod._updater.states[i]._set_data(moms[n])
        mod.forward_backward(batch)
        mod.update()
        losses.append(cross_entropy(mod.get_outputs()[0], batch.label[0]))
        states.append(({n: v.asnumpy()
                        for n, v in mod.get_params()[0].items()},
                       {names[i]: m.asnumpy()
                        for i, m in mod._updater.states.items()}))
    return losses, states


def param_ratio(got, ref, skip=()):
    """The largest |got - ref| / (rtol |ref| + atol max|ref|) over every
    array of `ref` whose name does not start with one of `skip`
    (PARITY_TOL; at most 1 passes), and that array's name."""
    rtol, atol = PARITY_TOL
    return max(((float((np.abs(got[n] - c) / (
        rtol * np.abs(c) + atol * np.abs(c).max())).max()), n)
        for n, c in ref.items() if not n.startswith(skip)),
        default=(0.0, "none"))


def pool_routes(params, x, ctx):
    """Which element wins each window of lenet's two max-pool layers at
    these parameters and images, computed on `ctx` by the torch calls
    the port's Convolution, tanh and Pooling make."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    p = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    h = torch.from_numpy(x).to(dev)
    routes = []
    for i in (0, 1):
        h = torch.tanh(F.conv2d(h, p[f"convolution_{i}_weight"],
                                p[f"convolution_{i}_bias"]))
        h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
        routes.append(idx.cpu())
    return routes


def flipped(mx, cpu_params, gpu_params, x):
    """Max-pool windows whose winner differs between the CPU at
    `cpu_params` and the card at `gpu_params` on images `x`."""
    return sum(int((a != b).sum()) for a, b in zip(
        pool_routes(cpu_params, x, mx.cpu()),
        pool_routes(gpu_params, x, mx.gpu(0))))


def parity_case(mx, name, sym):
    """The first PARITY_STEPS steps on the card against the CPU, from the
    same initial parameters and batches: free running (the loss of every
    step within rtol, the parameters after the last within PARITY_TOL),
    then each card step from the CPU's state before it (parameters and
    momentum after it within PARITY_TOL).

    A max-pool window whose two largest inputs lie within fp32 rounding
    of each other may be won by one element on the CPU and by the other
    on the card; its gradient then reaches the convolutions below through
    another pixel, a difference of a pixel's whole share of the gradient
    and not of rounding.  lenet's windows are recomputed on both devices:
    at a step where a window flipped, the convolutions' parameters and
    momentum are printed and not held, and the free-running parameters
    are held only when no window flipped along the way.  Every other
    array of every step is held."""
    train, _ = mnist_iters(mx)
    batches = [next(train) for _ in range(PARITY_STEPS)]
    xs = [b.data[0].asnumpy() for b in batches]
    pooled = name == "lenet"
    cpu_loss, cpu = first_steps(mx, sym, mx.cpu(), batches)
    gpu_loss, gpu = first_steps(mx, sym, mx.gpu(0), batches)
    _, forced = first_steps(mx, sym, mx.gpu(0), batches, teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free_flips = sum(flipped(mx, c[0], g[0], x) for c, g, x in
                     zip(cpu, gpu, xs)) if pooled else 0
    free, free_at = param_ratio(gpu[-1][0], cpu[-1][0])
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        n = flipped(mx, cpu[k][0], cpu[k][0], x) if pooled else 0
        skip = ("convolution",) if n else ()
        after, ref = forced[k + 1], cpu[k + 1]
        held = max(held, param_ratio(after[0], ref[0], skip),
                   param_ratio(after[1], ref[1], skip))
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max(excused, param_ratio(after[0], ref[0]),
                          param_ratio(after[1], ref[1]))
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1 and \
        (free <= 1 or free_flips > 0)
    free_note = f"; not held: {free_flips} max-pool windows flipped on " \
        "the way" if free_flips else ""
    print(f"train {name:5s} first {PARITY_STEPS} steps, card vs CPU: loss "
          f"{' '.join(f'{v:.4f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); parameters after "
          f"step {PARITY_STEPS} at {free:.3f} of the tolerance (worst "
          f"{free_at}{free_note}); each step from the CPU's state: "
          f"parameters and momentum at {held[0]:.3f} of it (worst "
          f"{held[1]}) (rtol {PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}"
          f"*max|array|) {'ok' if ok else 'FAIL'}")
    if pooled:
        note = f"; at those steps the convolutions at {excused[0]:.3f} " \
            f"of the tolerance (worst {excused[1]}), not held" \
            if flips else ""
        print(f"train {name:5s} max-pool windows flipped between the CPU "
              f"and the card from the CPU's state: "
              f"{', '.join(flips) or 'none'}{note}")
    check(ok, f"{name}: the card's first steps disagree with the CPU's")


def profile_step(mx, mod, batch, card):
    """Device time by kernel of one warm mlp step (fit_step: the fused
    step's forward, backward, update and metric); returns K1's share.
    A session that recorded no K1 kernel, though the step launches two
    (one session recorded only the last 17 of a step's ~50 kernels), is
    run again, up to 3 sessions."""
    from torch.profiler import ProfilerActivity, profile
    metric = mx.metric.create("acc")
    mod.fit_step(batch, metric)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mod.fit_step(batch, metric)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if any(k in name for _, _, name in spans for k in K1_KERNELS):
            break
    check(spans, "the profiler saw no device activity in a training step")
    by_name, busy, edge = {}, 0.0, -math.inf
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_name.values())
    k1 = sum(us for name, us in by_name.items()
             if any(k in name for k in K1_KERNELS))
    print(f"train mlp profile: one step {wall_us / 1e3:.3f} ms on the host "
          f"clock, {len(spans)} kernels, device time {total / 1e3:.3f} ms, "
          f"busy {busy / wall_us:.3f} of the window; K1 {k1 / 1e3:.4f} ms "
          f"= {k1 / total:.3f} of device time [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"train mlp profile: {us / 1e3:8.4f} ms {us / total:6.3f} "
              f"{name[:90]}")
    return k1 / total


def fit_case(mx, name, sym, card):
    """Module.fit on the card with train_mnist's defaults; returns the
    module, K1's launches and the step numbers."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    train, val = mnist_iters(mx)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    ticks = []
    mx.random.seed(SEED)
    fc_relu.launches = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            initializer=mx.initializer.Xavier(), num_epoch=TRAIN_EPOCHS,
            batch_end_callback=[
                lambda p: ticks.append((p.nbatch, time.perf_counter())),
                mx.callback.Speedometer(TRAIN_BATCH, 50)])
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    steps = TRAIN_EPOCHS * -(-TRAIN_SPLIT // TRAIN_BATCH)
    evals = TRAIN_EPOCHS * -(-(TRAIN_IMAGES - TRAIN_SPLIT) // TRAIN_BATCH)
    expect = 2 * (steps + evals) if name == "mlp" else 0
    print(f"train {name:5s} K1 launches {launches}, expected "
          f"{'2 x' if expect else '0 x'} ({steps} train + {evals} eval "
          f"forwards) = {expect}")
    check(len(ticks) == steps and launches == expect,
          f"{name}: {len(ticks)} steps, K1 launched {launches} times, want "
          f"{steps} steps and {expect} launches")
    acc = mod.score(val, "acc")[0][1]
    check(fc_relu.launches - launches == expect // TRAIN_EPOCHS
          - 2 * (steps // TRAIN_EPOCHS) * bool(expect),
          f"{name}: score's forwards did not run K1 twice each")
    step_ms = [(t1 - t0_) * 1e3 for (_, t0_), (n1, t1) in
               zip(ticks, ticks[1:]) if n1 > 0]
    med = statistics.median(step_ms)
    print(f"train {name:5s} {TRAIN_EPOCHS} epochs of {steps // TRAIN_EPOCHS} "
          f"steps in {wall:.2f} s (eval included); step median {med:.3f} ms "
          f"(p10 {np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}) = {TRAIN_BATCH / med * 1e3:.0f}"
          f" samples/s; validation accuracy {acc:.4f} (> 0.95) "
          f"{'ok' if acc > 0.95 else 'FAIL'} [{card}]")
    check(acc > 0.95, f"{name}: validation accuracy {acc:.4f} <= 0.95")
    return mod, launches, {"step_ms": med, "samples_s": TRAIN_BATCH / med
                           * 1e3, "accuracy": acc}


def serve_trained(mx, mod, card, workdir):
    """Serve the trained mlp's checkpoint (its SoftmaxOutput label slot
    unfilled) in fp32 and bf16 through ModelServer on the card."""
    _, val = mnist_iters(mx)
    images = val.data[0][1]
    want = mod.predict(val).asnumpy()
    sizes, cuts = (1, 5, 16, 64, 3, 27, 8, 2, 33), [0]
    while cuts[-1] < len(images):
        cuts.append(min(len(images), cuts[-1] + sizes[len(cuts) % 9]))
    buckets = (1, 2, 4, 8, 16, 32, 64)
    shapes = [("data", (1, 1, 28, 28))]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "mlp")
        mod.save_checkpoint(prefix, TRAIN_EPOCHS)
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        srv.load_model("mlp", prefix=prefix, epoch=TRAIN_EPOCHS,
                       data_shapes=shapes, buckets=buckets)
        srv.load_model("mlp_bf16", model=mx.serving.ServedModel.load(
            prefix, TRAIN_EPOCHS, data_shapes=shapes, buckets=buckets,
            ctx=mx.gpu(0), dtype="bfloat16", name="mlp_bf16"))
        futs = [(a, b, srv.submit("mlp", {"data": images[a:b]}),
                 srv.submit("mlp_bf16", {"data": images[a:b]}))
                for a, b in zip(cuts, cuts[1:])]
        got32 = np.concatenate([f.result(120)[0].asnumpy()
                                for _, _, f, _ in futs])
        outs16 = [g.result(120)[0] for _, _, _, g in futs]
        srv.shutdown(drain=True)
    check(all(o.data.dtype == torch.bfloat16 for o in outs16),
          "bf16 serving did not answer in bf16")
    got16 = np.concatenate([o.asnumpy() for o in outs16])
    for label, got, ref, (rtol, atol) in (
            ("fp32 vs Module.predict", got32, want, SERVE_TRAIN_TOL),
            ("bf16 vs fp32 served", got16, got32, SERVE_BF16_TOL)):
        err = np.abs(got - ref)
        ok = got.shape == ref.shape and np.isfinite(got).all() and bool(
            (err <= rtol * np.abs(ref) + atol * np.abs(ref).max()).all())
        agree = float((got.argmax(1) == ref.argmax(1)).mean())
        print(f"train serve mlp {label}: {len(cuts) - 1} requests of "
              f"{len(images)} images, max_abs_err {err.max():.3e} (rtol "
              f"{rtol:g}, atol {atol:g}*max|ref|), argmax agreement "
              f"{agree:.4f} {'ok' if ok else 'FAIL'}")
        check(ok, f"served mlp {label} disagrees")


def train_phase(card, workdir):
    """Phase 6; returns K1's launches in the training run and the JSON's
    training numbers."""
    import incubator_mxnet_tpu_torch as mx
    old = os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    out = {}
    try:
        for name, build in (("mlp", mlp_symbol), ("lenet", lenet_symbol)):
            if name == "mlp":
                os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
            else:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            sym = build(mx)
            parity_case(mx, name, sym)
            mod, launches, nums = fit_case(mx, name, sym, card)
            out[name] = dict(nums, k1_launches=launches)
            if name == "mlp":
                train, _ = mnist_iters(mx)
                out[name]["k1_share"] = profile_step(mx, mod, next(train),
                                                    card)
                serve_trained(mx, mod, card, workdir)
            del mod
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    return out["mlp"]["k1_launches"], out


def resnet_symbol(mx):
    """(net, symbol): gluon resnet50_v1(classes=1000) composed on
    Variable("data") + SoftmaxOutput, as bench.py's `_build_module`."""
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=CLASSES)
    return net, mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")),
                                     name="softmax")


def resnet_init(mx):
    return mx.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)


def train_flops(sym, batch):
    """Operations of one training step at `batch`: 2 x the multiply-adds
    of every Convolution and FullyConnected forward (output elements x
    weight elements per output channel), times 3 for the forward and the
    backward's two products of the same size."""
    internals = sym.get_internals()
    shape = (batch,) + IMAGE
    _, outs, _ = internals.infer_shape(data=shape)
    args = dict(zip(sym.list_arguments(), sym.infer_shape(data=shape)[0]))
    macs = 0
    for (node, _), out in zip(internals._entries, outs):
        if not node.is_variable and node.op.name in ("Convolution",
                                                     "FullyConnected"):
            macs += math.prod(out) * math.prod(args[node.inputs[1][0].name]
                                               [1:])
    return 3 * 2 * macs


def resident_iter(mx, batch, dtype, n, seed=SEED):
    """n batches that are all the same random batch on the card, in
    `dtype` (bench.py `_synthetic_iter`: compute, not data loading)."""
    rng = np.random.RandomState(seed)
    ctx = mx.gpu(0)
    data = mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"),
                       ctx=ctx).astype(dtype)
    label = mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                        ctx=ctx)
    return resident(mx, data, label, n)


def resident(mx, data, label, n):
    """A DataIter that yields the one batch (`data`, `label`, NDArrays on
    the card) n times per epoch."""
    provide = ([mx.io.DataDesc("data", data.shape, dtype=data.dtype)],
               [mx.io.DataDesc("softmax_label", label.shape)])
    one = mx.io.DataBatch([data], [label], pad=0)

    class Resident(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=data.shape[0])
            self._i = 0

        @property
        def provide_data(self):
            return provide[0]

        @property
        def provide_label(self):
            return provide[1]

        def reset(self):
            self._i = 0

        def next(self):
            if self._i >= n:
                raise StopIteration
            self._i += 1
            return one

    return Resident()


def resnet_state(mod):
    """({parameter}, {momentum by parameter}, {aux}) as numpy."""
    args, auxs = mod.get_params()
    names = mod._exec_group.param_names
    return ({n: v.asnumpy() for n, v in args.items()},
            {names[i]: m.asnumpy() for i, m in mod._updater.states.items()},
            {n: v.asnumpy() for n, v in auxs.items()})


def as_float64(mod):
    """Turn a bound float32 Module's arrays (all but the labels) into
    float64 ones before init_params, for a check held in float64; the
    Module binds float32, as the JAX package's does."""
    exe = mod._exec_group.execs[0]
    labels = set(mod._exec_group.label_names)
    arrays = [a for n, a in exe.arg_dict.items() if n not in labels]
    arrays += [g for g in exe.grad_dict.values() if g is not None]
    for a in arrays + list(exe.aux_dict.values()):
        a._data = a.data.double()


def resnet_steps(mx, sym, ctx, batches, dtype, teacher=None):
    """RESNET_PARITY fused steps in `dtype` on `ctx` (Module.fit_step)
    from Xavier parameters under mx.random.seed(SEED); the loss of each
    step and the state before the first and after each.  With `teacher`
    (another run's states), step k starts from the teacher's state
    before it, cast to `dtype`."""
    mod = mx.mod.Module(sym, context=ctx)
    batch = RESNET_PARITY[0]
    mod.bind([("data", (batch,) + IMAGE)], [("softmax_label", (batch,))])
    if dtype == "float64":
        as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(resnet_init(mx))
    mod.init_optimizer(optimizer_params=RESNET_OPT)
    losses, states = [], [resnet_state(mod)]
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms, auxs = teacher[k]
            mod.set_params(params, auxs)
            for i, n in enumerate(mod._exec_group.param_names):
                mod._updater.states[i]._set_data(moms[n])
        mod.fit_step(b, mx.metric.create("acc"))
        losses.append(cross_entropy(mod.get_outputs()[0], b.label[0]))
        states.append(resnet_state(mod))
    check(mod._fused_step is not None and mod._fused_step.steps ==
          len(batches), f"resnet parity on {ctx}: the fused step did not "
          "run every step")
    return losses, states


def bn_fed_biases(sym):
    """Biases of the convolutions whose output goes straight into a
    BatchNorm: the batch mean removes them, so their gradient is 0 in
    exact arithmetic and rounding noise in practice."""
    out = set()
    for node in sym._topo():
        if not node.is_variable and node.op.name == "BatchNorm":
            src = node.inputs[0][0]
            if not src.is_variable and src.op.name == "Convolution" and \
                    not src.attrs["no_bias"]:
                out.add(src.inputs[2][0].name)
    return out


def resnet_ratio(got, ref, zero, skip=()):
    """param_ratio over every array of `ref` not under `skip`; an array
    named in `zero` (a BatchNorm-fed bias: 0 plus float64 rounding) is
    held to |got| < RESNET_ZERO instead, its ratio max|got| /
    RESNET_ZERO."""
    worst = param_ratio(got, {n: c for n, c in ref.items()
                              if n not in zero}, skip)
    return max([worst] + [(float(np.abs(got[n]).max() / RESNET_ZERO), n)
                          for n in ref if n in zero
                          and not n.startswith(skip)])


def resnet_pool_routes(net, params, x, ctx):
    """Which element wins each window of ResNet-50's max-pool at these
    parameters and images, computed on `ctx` by the torch calls the port
    makes: conv1 (7x7/2), BatchNorm on the batch's statistics, relu, the
    3x3/2 max-pool over -inf padding."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    conv, bn = net.features[0], net.features[1]
    w, g, b = (torch.from_numpy(params[p.name]).to(dev)
               for p in (conv.weight, bn.gamma, bn.beta))
    h = F.conv2d(torch.from_numpy(x).to(dev, w.dtype), w, stride=2,
                 padding=3)
    h = torch.relu(torch.native_batch_norm(h, g, b, None, None, True, 0.0,
                                           1e-5)[0])
    h = F.pad(h, (1, 1, 1, 1), value=-math.inf)
    return F.max_pool2d(h, 3, 2, return_indices=True)[1].cpu()


def resnet_flipped(mx, net, cpu_params, gpu_params, x):
    return int((resnet_pool_routes(net, cpu_params, x, mx.cpu()) !=
                resnet_pool_routes(net, gpu_params, x, mx.gpu(0))).sum())


def rel_l2(got, ref, zero):
    """Relative L2 distance of `got` from `ref` over every array of `ref`
    together, the names in `zero` left out."""
    keys = [n for n in ref if n not in zero]
    a = np.concatenate([got[n].ravel().astype(np.float64) for n in keys])
    b = np.concatenate([ref[n].ravel().astype(np.float64) for n in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def resnet_parity(mx, net, sym):
    """Phase 7a: RESNET_PARITY fused steps of ResNet-50 at 224 on the card
    against the CPU from the same Xavier parameters and batches.

    float64, where the step is well conditioned: free running (the loss
    of every step within rtol), then each card step from the CPU's state
    before it (parameters, momenta and the 106 aux arrays after it within
    PARITY_TOL).  As for lenet (`parity_case`), a max-pool window whose
    two largest inputs tie within rounding may route its gradient to
    another pixel on the card: the windows are recomputed on both
    devices, and only conv1 and the BatchNorm under it are excused, and
    only at a step where a window flipped.

    float32: at batch 4 each of the 53 BatchNorms divides by a standard
    deviation taken over few values, so float32 rounding grows through
    the network to ~1e-4 of the output and ~2e-2 of every gradient (the
    JAX package's CPU step is as far from float64 as the port's).  No
    elementwise bound between two float32 devices holds there.  So each
    device runs each float32 step from the float64 CPU's state: its loss
    within rtol PARITY_TOL[0] of the float64 loss, and the card's
    parameters, momenta and aux arrays as close to the float64 step (in
    relative L2 norm) as the CPU's float32 step is, within a factor
    RESNET_ENVELOPE[0] plus RESNET_ENVELOPE[1]."""
    batch, steps = RESNET_PARITY
    rng = np.random.RandomState(SEED + 7)
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"), ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                     ctx=mx.cpu())]) for _ in range(steps)]
    xs = [b.data[0].asnumpy() for b in batches]
    zero = bn_fed_biases(sym)
    t0 = time.perf_counter()
    cpu_loss, cpu = resnet_steps(mx, sym, mx.cpu(), batches, "float64")
    t_cpu = time.perf_counter() - t0
    gpu_loss, gpu = resnet_steps(mx, sym, mx.gpu(0), batches, "float64")
    _, forced = resnet_steps(mx, sym, mx.gpu(0), batches, "float64",
                             teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free_flips = sum(resnet_flipped(mx, net, c[0], g[0], x)
                     for c, g, x in zip(cpu, gpu, xs))
    excusable = (net.features[0].prefix, net.features[1].prefix)
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        n = resnet_flipped(mx, net, cpu[k][0], cpu[k][0], x)
        skip = excusable if n else ()
        after, ref = forced[k + 1], cpu[k + 1]
        held = max([held] + [resnet_ratio(a, r, zero, skip)
                             for a, r in zip(after, ref)])
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max([excused] + [resnet_ratio(a, r, zero)
                                       for a, r in zip(after, ref)])
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1
    print(f"resnet parity float64: {steps} fused steps at batch {batch}, "
          f"card vs CPU (CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); each step from "
          f"the CPU's state: parameters, momenta and {len(cpu[0][2])} aux "
          f"arrays at {held[0]:.3f} of the tolerance (worst {held[1]}) "
          f"(rtol {PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|; "
          f"{len(zero)} BatchNorm-fed biases below {RESNET_ZERO:g}) "
          f"{'ok' if ok else 'FAIL'}")
    note = f"; at those steps conv1 and its BatchNorm at " \
        f"{excused[0]:.3f} of the tolerance (worst {excused[1]}), not " \
        "held" if flips else ""
    print(f"resnet parity float64: max-pool windows flipped between the "
          f"CPU and the card from the CPU's state: "
          f"{', '.join(flips) or 'none'}{note}; along the free-running "
          f"steps: {free_flips}")
    check(ok, "resnet: the card's float64 steps disagree with the CPU's")

    c32_loss, c32 = resnet_steps(mx, sym, mx.cpu(), batches, "float32",
                                 teacher=cpu)
    g32_loss, g32 = resnet_steps(mx, sym, mx.gpu(0), batches, "float32",
                                 teacher=cpu)
    factor, extra = RESNET_ENVELOPE
    worst, ok = [], True
    for k in range(steps):
        for what, i in (("parameters", 0), ("momenta", 1), ("aux", 2)):
            dc = rel_l2(c32[k + 1][i], cpu[k + 1][i], zero)
            dg = rel_l2(g32[k + 1][i], cpu[k + 1][i], zero)
            worst.append((dg / (factor * dc + extra), what, k + 1, dc, dg))
            ok = ok and dg <= factor * dc + extra
    loss32 = max(abs(v - c) / abs(c) for run in (c32_loss, g32_loss)
                 for v, c in zip(run, cpu_loss))
    ok = ok and loss32 <= PARITY_TOL[0]
    by_kind = {}
    for r in worst:
        by_kind[r[1]] = max(by_kind.get(r[1], r), r)
    print(f"resnet parity float32, each step from the float64 CPU's state:"
          f" loss within {loss32:.2e} of float64 on both (rtol "
          f"{PARITY_TOL[0]:g}); relative L2 distance from the float64 step,"
          f" card vs CPU: " + "; ".join(
              f"{what} {dg:.2e} vs {dc:.2e} (step {k})"
              for _, what, k, dc, dg in by_kind.values()) +
          f" (card <= {factor:g} x CPU + {extra:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "resnet: the card's float32 steps are farther from float64 "
          "than the CPU's")


def resnet_lane(mx, sym, dtype, batch, warm, timed, card, peak):
    """Phase 7b: the lane through the public Module.fit on one resident
    batch, `warm` + `timed` steps.  images/s over CUDA-synchronised
    window edges (bench.py `_Probe`), the median step ms between CUDA
    events recorded at each batch end, the loss of every step (computed
    on the card), peak memory; returns (module, numbers)."""
    it = resident_iter(mx, batch, dtype, warm + timed)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    events, losses, edges = [], [], {}
    ce = mx.metric.create("ce")       # -log(p + 1e-12), on the card

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        label = mod._exec_group.execs[0].arg_dict["softmax_label"]
        total, n = ce.device_update([label], mod.get_outputs())
        losses.append(total / n)
        if p.nbatch in (warm - 1, warm + timed - 1):
            torch.cuda.synchronize()
            edges[p.nbatch] = time.perf_counter()
            edges["acc"] = p.eval_metric.get()[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(RESNET_OPT, multi_precision=dtype !=
                                  "float32", rescale_grad=1.0 / batch),
            eval_metric="acc", initializer=resnet_init(mx),
            batch_end_callback=probe, kvstore=None)
    wall = time.perf_counter() - t0
    steps = warm + timed
    fused = mod._fused_step
    check(fused is not None and fused.steps == steps,
          f"resnet {dtype}: the fused step ran "
          f"{fused.steps if fused else 0} of {steps} steps")
    loss = torch.stack(losses).cpu().numpy()
    images_s = batch * timed / (edges[warm + timed - 1] - edges[warm - 1])
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warm - 1:],
                                                 events[warm:])]
    med = statistics.median(step_ms)
    flops = train_flops(sym, batch)
    mfu = images_s * flops / batch / peak
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    acc = edges["acc"]
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0] and \
        math.isfinite(acc)
    print(f"resnet lane {dtype} batch {batch}: {steps} steps through "
          f"Module.fit in {wall:.2f} s ({warm} warm), fused step every "
          f"step; {images_s:.1f} images/s over the {timed} timed steps; "
          f"step median {med:.3f} ms (p10 {np.percentile(step_ms, 10):.3f}"
          f", p90 {np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{flops / batch / 1e9:.2f} GFLOP per image; peak memory "
          f"{mem:.2f} GiB [{card}]")
    print(f"resnet lane {dtype} batch {batch}: loss (cross-entropy of "
          f"the outputs, metric.CrossEntropy) first "
          f"{loss[0]:.4f}, last {loss[-1]:.4f}, every "
          f"{' '.join(f'{v:.3f}' for v in loss[::8])}; train acc over the "
          f"fit {acc:.4f} {'ok' if ok else 'FAIL'}")
    print(f"mfu {dtype} {mfu:.4f} (of {peak / 1e12:.0f} TFLOP/s) [{card}]")
    check(ok, f"resnet {dtype}: loss not finite or not falling, or acc "
          "not finite")
    return mod, {"images_s": images_s, "step_ms": med, "mfu": mfu,
                 "peak_gib": mem}


def kernel_class(name, classes=KERNEL_CLASSES):
    for label, keys in classes:
        if any(k in name for k in keys):
            return label
    return "other"


def resnet_profile(mx, mod, card):
    """Phase 7c: one warm bf16 step (fit_step) under torch.profiler: the
    device's busy share of the step, device ms by kernel class, and the
    host ms the step took to enqueue."""
    batch = mod._exec_group.batch_size
    it = resident_iter(mx, batch, "bfloat16", 1)
    one = next(it)
    metric = mx.metric.create("acc")
    return profile_one_step(lambda: mod.fit_step(one, metric), card,
                            "resnet profile", batch)


def profile_one_step(step, card, label, batch, tries=3, dtype="bf16",
                     classes=KERNEL_CLASSES):
    """`step()` once to warm, then once under torch.profiler (retried if
    the profiler recorded no kernel): the host ms to enqueue it, the
    kernels, device ms by kernel class (`classes`), the device's busy
    share; printed on lines starting with `label`."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"{label}: the profiler saw no device activity in a step")
    by_class, other, busy, edge = {}, {}, 0.0, -math.inf
    for start, end, name in spans:
        cls = kernel_class(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start)
        if cls == "other":
            other[name] = other.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_class.values())
    print(f"{label}: one warm {dtype} step at batch {batch}: "
          f"{host_ms:.2f} ms of host time to enqueue, {wall_ms:.2f} ms to "
          f"finish, {len(spans)} kernels, device time {total / 1e3:.2f} ms, "
          f"device busy {busy / 1e3 / wall_ms:.3f} of the step [{card}]")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{label}: {us / 1e3:9.3f} ms {us / total:6.3f} {cls}")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:3]:
        print(f"{label}: other: {us / 1e3:8.3f} ms {name[:90]}")
    return {"busy": busy / 1e3 / wall_ms, "host_ms": host_ms,
            "device_ms": total / 1e3, "kernels": len(spans),
            "by_class": {cls: us / 1e3 for cls, us in by_class.items()}}


def resnet_serve(mx, sym, card, workdir):
    """Phase 7d: RESNET_SERVE fp32 steps through Module.fit, the
    checkpoint saved, loaded into serving.ModelServer, requests of 1-8
    images answered and held to Module.predict (BatchNorm in inference
    mode, on the moving statistics the steps left)."""
    batch, steps = RESNET_SERVE
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mx.random.seed(SEED)
    mod.fit(resident_iter(mx, batch, "float32", steps, seed=SEED + 1),
            num_epoch=1, optimizer="sgd",
            optimizer_params=dict(RESNET_OPT, rescale_grad=1.0 / batch),
            eval_metric="acc", initializer=resnet_init(mx), kvstore=None)
    check(mod._fused_step.steps == steps, "resnet serve: fused step")
    rng = np.random.RandomState(SEED + 2)
    reqs = [rng.rand(n, *IMAGE).astype("f4") for n in RESNET_SERVE_SIZES]
    want = [mod.predict(x).asnumpy() for x in reqs]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mod.save_checkpoint(prefix, steps)
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        srv.load_model("resnet50", prefix=prefix, epoch=steps,
                       data_shapes=[("data", (1,) + IMAGE)],
                       buckets=RESNET_BUCKETS)
        futs = [srv.submit("resnet50", {"data": x}) for x in reqs]
        got = [f.result(300)[0].asnumpy() for f in futs]
        srv.shutdown(drain=True)
    rtol, atol = SERVE_TRAIN_TOL
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    ok = all(g.shape == w.shape and np.isfinite(g).all() and bool(
        (np.abs(g - w) <= rtol * np.abs(w) + atol * np.abs(w).max()).all())
        for g, w in zip(got, want))
    agree = float(np.mean(np.concatenate([g.argmax(1) == w.argmax(1)
                                          for g, w in zip(got, want)])))
    print(f"resnet serve: {steps} fp32 steps at batch {batch}, checkpoint "
          f"served, {len(reqs)} requests of {sum(RESNET_SERVE_SIZES)} "
          f"images (buckets {RESNET_BUCKETS}) vs Module.predict: "
          f"max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}*max|ref|),"
          f" argmax agreement {agree:.4f} {'ok' if ok else 'FAIL'}")
    check(ok, "served ResNet-50 disagrees with Module.predict")


def resnet_phase(card, workdir):
    """Phase 7; returns the numbers the summary line prints."""
    import incubator_mxnet_tpu_torch as mx
    net, sym = resnet_symbol(mx)
    args, _, aux = sym.infer_shape(data=(RESNET_BATCH,) + IMAGE)
    learned = [a for n, a in zip(sym.list_arguments(), args)
               if n not in ("data", "softmax_label")]
    print(f"resnet: resnet50_v1 composed: {len(learned)} learned arguments "
          f"of {sum(math.prod(a) for a in learned)} values, {len(aux)} aux "
          f"of {sum(math.prod(a) for a in aux)}")
    out = {}
    t0 = time.perf_counter()
    resnet_parity(mx, net, sym)
    out["parity_s"] = time.perf_counter() - t0
    mod, out["bf16"] = resnet_lane(mx, sym, "bfloat16", RESNET_BATCH,
                                   RESNET_WARM, RESNET_TIMED, card,
                                   PEAK_FLOPS[BF16])
    out["profile"] = resnet_profile(mx, mod, card)
    del mod
    torch.cuda.empty_cache()
    batch, steps = RESNET_FP32
    mod, out["fp32"] = resnet_lane(mx, sym, "float32", batch, steps // 2,
                                   steps - steps // 2, card,
                                   FP32_CUDA_CORE_FLOPS)
    del mod
    torch.cuda.empty_cache()
    resnet_serve(mx, sym, card, workdir)
    return out


# -- phase 8: gluon's imperative training ------------------------------------

def gluon_state(mx, net, trainer):
    """{full parameter name: value, "name:momentum": momentum} as numpy
    (`compat.weights`: the parameters, BatchNorm's running statistics
    included, and the trainer's optimizer states)."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_to_numpy, trainer_states_to_numpy)
    state = block_params_to_numpy(net)
    names = [p.name for p in trainer._params]
    for i, mom in trainer_states_to_numpy(trainer).items():
        state[names[i] + ":momentum"] = mom
    return state


def gluon_load(mx, net, trainer, state):
    """Start `net` and `trainer` from `state` (`gluon_state`'s form)
    through `compat.weights`."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy, trainer_states_from_numpy)
    block_params_from_numpy(net, {n: v for n, v in state.items()
                                  if ":" not in n})
    index = {p.name: i for i, p in enumerate(trainer._params)}
    trainer_states_from_numpy(trainer, {
        index[n[:-len(":momentum")]]: v for n, v in state.items()
        if n.endswith(":momentum")})


def v2_net(mx, ctx, values, dtype):
    """resnet50_v2 on `ctx` with the parameter `values` (full names: the
    fixed prefix makes every instance's names the same), cast to
    `dtype`."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    net = mx.gluon.model_zoo.vision.resnet50_v2(classes=CLASSES,
                                                prefix=V2_PREFIX)
    net.initialize(ctx=ctx)
    block_params_from_numpy(net, values, ctx=ctx)
    net.cast(dtype)
    return net


def v2_initial_values(mx):
    """Xavier(gaussian, in, 2) parameters of resnet50_v2 under the seed,
    the deferred shapes finished by one predict-mode forward on the CPU,
    as numpy."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_to_numpy)
    net = mx.gluon.model_zoo.vision.resnet50_v2(classes=CLASSES,
                                                prefix=V2_PREFIX)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=mx.cpu())
    net(mx.nd.zeros((1,) + IMAGE, ctx=mx.cpu()))
    return block_params_to_numpy(net)


def v2_steps(mx, ctx, values, batches, teacher=None, hybrid=True):
    """GLUON_PARITY steps of BASELINE #3's plain loop (hybridized
    resnet50_v2, record / backward / Trainer.step, SGD lr 0.05 momentum
    0.9) in float64 on `ctx`: the loss of each step and the state before
    the first and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it."""
    net = v2_net(mx, ctx, values, "float64")
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", RESNET_OPT)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, states = [], [gluon_state(mx, net, trainer)]
    for k, (x, y) in enumerate(batches):
        if teacher is not None and k:
            gluon_load(mx, net, trainer, teacher[k])
        data = mx.nd.array(x, ctx=ctx, dtype="float64")
        label = mx.nd.array(y, ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(data.shape[0])
        losses.append(float(loss.asnumpy().mean()))
        states.append(gluon_state(mx, net, trainer))
    return losses, states


def held_ratio(got, ref, skip=()):
    """The largest |got - ref| / (rtol |ref| + atol max|ref|) (PARITY_TOL)
    over every array of `ref` whose name does not start with one of
    `skip`, and its name; an array that is all zeros must stay zero."""
    rtol, atol = PARITY_TOL
    worst = (0.0, "none")
    for n, c in ref.items():
        if n.startswith(skip):
            continue
        bound = rtol * np.abs(c) + atol * np.abs(c).max()
        diff = np.abs(got[n] - c)
        r = float((diff / np.where(bound > 0, bound, 1.0)).max()) \
            if bound.max() > 0 else (0.0 if not diff.any() else math.inf)
        worst = max(worst, (r, n))
    return worst


def v2_pool_routes(net, params, x, ctx):
    """Which element wins each window of resnet50_v2's max-pool, computed
    on `ctx` by the torch calls the port makes: the data's BatchNorm
    (gamma fixed at 1), conv0 (7x7/2), BatchNorm on the batch's
    statistics, relu, the 3x3/2 max-pool over -inf padding."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    f = net.features
    bn0, conv, bn1 = f[0], f[1], f[2]

    def t(p):
        return torch.from_numpy(params[p.name]).to(dev, torch.float64)
    h = torch.from_numpy(x).to(dev, torch.float64)
    beta0 = t(bn0.beta)
    h = torch.native_batch_norm(h, torch.ones_like(beta0), beta0, None,
                                None, True, 0.0, 1e-5)[0]
    h = F.conv2d(h, t(conv.weight), stride=2, padding=3)
    h = torch.relu(torch.native_batch_norm(h, t(bn1.gamma), t(bn1.beta),
                                           None, None, True, 0.0, 1e-5)[0])
    h = F.pad(h, (1, 1, 1, 1), value=-math.inf)
    return F.max_pool2d(h, 3, 2, return_indices=True)[1].cpu()


def v2_flipped(mx, net, cpu_params, gpu_params, x):
    return int((v2_pool_routes(net, cpu_params, x, mx.cpu()) !=
                v2_pool_routes(net, gpu_params, x, mx.gpu(0))).sum())


def v2_grads(mx, ctx, values, x, y, hybrid):
    """One recorded step's loss and gradients of resnet50_v2 in float64
    from `values`: {name: numpy}."""
    net = v2_net(mx, ctx, values, "float64")
    if hybrid:
        net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data = mx.nd.array(x, ctx=ctx, dtype="float64")
    with mx.autograd.record():
        loss = loss_fn(net(data), mx.nd.array(y, ctx=ctx))
    loss.backward()
    out = {p.name: p.grad().asnumpy() for p in net.collect_params().values()
           if p.grad_req != "null"}
    out["loss"] = loss.asnumpy()
    return out


def gluon_parity(mx):
    """Phase 8a: BASELINE #3's plain loop on hybridized resnet50_v2 at
    batch 4, 224, float64, the card against the CPU from the same
    parameters and momenta (`compat.weights`) and batches: free running,
    every step's loss within rtol; each card step from the CPU's state
    before it, parameters, momenta and moving statistics after it within
    PARITY_TOL (7a's gates; a max-pool window that flips between the
    devices excuses conv0 and the BatchNorm under it at that step, as
    in 7a).  Then one step on the card hybridized against not, cuDNN in
    its deterministic algorithms: the loss and every gradient within
    HYBRID_TOL."""
    batch, steps = GLUON_PARITY
    rng = np.random.RandomState(SEED + 8)
    batches = [(rng.rand(batch, *IMAGE), rng.randint(0, CLASSES, batch)
                .astype("f4")) for _ in range(steps)]
    values = v2_initial_values(mx)
    t0 = time.perf_counter()
    cpu_loss, cpu = v2_steps(mx, mx.cpu(), values, batches)
    t_cpu = time.perf_counter() - t0
    gpu_loss, gpu = v2_steps(mx, mx.gpu(0), values, batches)
    _, forced = v2_steps(mx, mx.gpu(0), values, batches, teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    probe = v2_net(mx, mx.cpu(), values, "float64")
    free_flips = sum(v2_flipped(mx, probe, c, g, x)
                     for c, g, (x, _) in zip(cpu, gpu, batches))
    excusable = (probe.features[1].prefix, probe.features[2].prefix)
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, (x, _) in enumerate(batches):
        n = v2_flipped(mx, probe, cpu[k], cpu[k], x)
        held = max(held, held_ratio(forced[k + 1], cpu[k + 1],
                                    excusable if n else ()))
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max(excused, held_ratio(forced[k + 1], cpu[k + 1]))
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1
    n_arrays = len(cpu[-1])
    print(f"gluon parity float64: hybridized resnet50_v2, {steps} steps of "
          f"record/backward/Trainer.step at batch {batch}, card vs CPU "
          f"(CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); each step from "
          f"the CPU's state (compat.weights): {n_arrays} parameter, moving "
          f"statistic and momentum arrays at {held[0]:.3f} of the "
          f"tolerance (worst {held[1]}) (rtol {PARITY_TOL[0]:g}, atol "
          f"{PARITY_TOL[1]:g}*max|array|) {'ok' if ok else 'FAIL'}")
    note = f"; at those steps conv0 and its BatchNorm at " \
        f"{excused[0]:.3f} of the tolerance (worst {excused[1]}), not " \
        "held" if flips else ""
    print(f"gluon parity float64: max-pool windows flipped between the CPU "
          f"and the card from the CPU's state: {', '.join(flips) or 'none'}"
          f"{note}; along the free-running steps: {free_flips}")
    check(ok, "gluon: the card's float64 steps disagree with the CPU's")

    x, y = batches[0]
    # cuDNN's default backward algorithms add with atomics, so two runs of
    # one graph differ in the last bits; its deterministic ones do not
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        hyb = v2_grads(mx, mx.gpu(0), values, x, y, True)
        eager = v2_grads(mx, mx.gpu(0), values, x, y, False)
    rtol, atol = HYBRID_TOL
    worst, ok = (0.0, "none"), True
    for n, ref in eager.items():
        diff = np.abs(hyb[n] - ref)
        bound = rtol * np.abs(ref) + atol * np.abs(ref).max()
        ok = ok and bool((diff <= bound).all())
        worst = max(worst, (float(diff.max()), n))
    print(f"gluon hybridize: one card step of resnet50_v2 hybridized vs "
          f"eager in float64: loss and {len(eager) - 1} gradients, max abs "
          f"diff {worst[0]:.3e} ({worst[1]}) (rtol {rtol:g}, atol "
          f"{atol:g}*max|g|) {'ok' if ok else 'FAIL'}")
    check(ok, "gluon: the hybridized step's gradients differ from eager")


def gluon_net_bf16(mx, ctor):
    """bench.py `_run_gluon`'s net: `ctor(classes=1000)`, Xavier(gaussian,
    in, 2) on the card under the seed, cast to bfloat16, the deferred
    shapes finished by one predict-mode forward."""
    ctx = mx.gpu(0)
    net = ctor(classes=CLASSES)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=ctx)
    net.cast("bfloat16")
    net(mx.nd.zeros((1,) + IMAGE, ctx=ctx, dtype="bfloat16"))
    return net


def resident_batch(mx, batch, seed=SEED):
    """One random batch on the card, the data in bfloat16 (bench.py's
    gluon lane: compute, not data loading)."""
    rng = np.random.RandomState(seed)
    ctx = mx.gpu(0)
    data = mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"),
                       ctx=ctx).astype("bfloat16")
    label = mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                        ctx=ctx)
    return data, label


class _LaneProbe:
    """Estimator handler (bench.py `_run_gluon`'s Probe): a CUDA event and
    the batch's mean loss (on the card) at every batch end, the window's
    edges CUDA-synchronised on the host clock.  At the first edge it
    keeps the peak memory so far (`warm_peak`, GiB) and resets the
    counter, so `peaks()` tells the warm steps' one-time allocations
    from a steady step's.  `base`: GiB allocated before the lane built
    anything, once the earlier phases' garbage is collected (a reference
    cycle of an earlier net would otherwise count in this lane's
    peak)."""

    def __init__(self, warm, timed):
        self.warm, self.timed = warm, timed
        self.events, self.losses, self.edges = [], [], {}
        self.warm_peak = 0.0
        gc.collect()
        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated() / 2 ** 30

    def peaks(self):
        """(peak memory over the whole run, over the timed steps), GiB."""
        timed = torch.cuda.max_memory_allocated() / 2 ** 30
        return max(self.warm_peak, timed), timed

    def train_begin(self, est):
        pass

    def epoch_begin(self, est):
        pass

    def batch_begin(self, est):
        pass

    def batch_end(self, est):
        self.mark(est._fused.last_loss.data if est._fused else None)

    def mark(self, losses):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        if losses is not None:      # the eager loop keeps no loss
            self.losses.append(losses.detach().float().mean())
        if len(self.events) in (self.warm, self.warm + self.timed):
            torch.cuda.synchronize()
            self.edges[len(self.events)] = time.perf_counter()
            if len(self.events) == self.warm:
                self.warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()

    def epoch_end(self, est):
        pass

    def train_end(self, est):
        pass


def lane_numbers(label, probe, batch, flops, steps_run, card, module_s,
                 acc, wall):
    """Print a lane's images/s, step median, mfu, peak memory and the
    ratio to the Module lane; check the loss is finite and falls and the
    accuracy finite."""
    warm, timed = probe.warm, probe.timed
    loss = torch.stack(probe.losses).cpu().numpy()
    images_s = batch * timed / (probe.edges[warm + timed] -
                                probe.edges[warm])
    step_ms = [a.elapsed_time(b) for a, b in
               zip(probe.events[warm - 1:], probe.events[warm:])]
    med = statistics.median(step_ms)
    mfu = images_s * flops / batch / PEAK_FLOPS[BF16]
    mem, steady = probe.peaks()
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0] and \
        math.isfinite(acc)
    print(f"{label} batch {batch}: {steps_run} steps in {wall:.2f} s "
          f"({warm} warm); {images_s:.1f} images/s over the {timed} timed "
          f"steps; step median {med:.3f} ms (p10 "
          f"{np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{flops / batch / 1e9:.2f} GFLOP per image; peak memory "
          f"{mem:.2f} GiB ({steady:.2f} over the timed steps, "
          f"{probe.base:.2f} allocated before the lane); "
          f"gluon_vs_module {images_s / module_s:.3f} [{card}]")
    print(f"{label} batch {batch}: loss (the loss block's mean) first "
          f"{loss[0]:.4f}, last {loss[-1]:.4f}, every "
          f"{' '.join(f'{v:.3f}' for v in loss[::8])}; train acc "
          f"{acc:.4f} {'ok' if ok else 'FAIL'}")
    print(f"{label} mfu bfloat16 {mfu:.4f} (of "
          f"{PEAK_FLOPS[BF16] / 1e12:.0f} TFLOP/s) [{card}]")
    check(ok, f"{label}: loss not finite or not falling, or acc not "
          "finite")
    return {"images_s": images_s, "step_ms": med, "mfu": mfu,
            "peak_gib": mem, "steady_gib": steady,
            "gluon_vs_module": images_s / module_s}


def bench_estimator(mx, batch, steps, probe):
    """bench.py `_run_gluon`'s Estimator.fit of resnet50_v1 in bfloat16
    on one resident batch, `steps` batches: (estimator, batch, wall s)."""
    net = gluon_net_bf16(mx, mx.gluon.model_zoo.vision.resnet50_v1)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(
        RESNET_OPT, multi_precision=True, rescale_grad=1.0 / batch))
    est = mx.gluon.contrib.estimator.Estimator(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=[mx.metric.Accuracy()], trainer=trainer)
    data, label = resident_batch(mx, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est.fit(iter([(data, label)] * steps), epochs=1,
            event_handlers=[probe])
    return est, (data, label), time.perf_counter() - t0


def bench_gluon_eager(mx, card, fused):
    """Phase 8b: bench.py's gluon lane as `bench_gluon_lane` runs it, with
    the fused step switched off (MXNET_FUSED_TRAIN_STEP=0), so Estimator
    runs its eager loop (record, backward, Trainer.step, metric.update):
    images/s, step median and peak memory beside the fused step's."""
    batch = RESNET_BATCH
    probe = _LaneProbe(GLUON_WARM, GLUON_TIMED)
    prev = os.environ.get("MXNET_FUSED_TRAIN_STEP")
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "0"
    try:
        est, _, wall = bench_estimator(mx, batch, GLUON_WARM + GLUON_TIMED,
                                       probe)
    finally:
        if prev is None:
            del os.environ["MXNET_FUSED_TRAIN_STEP"]
        else:
            os.environ["MXNET_FUSED_TRAIN_STEP"] = prev
    warm, timed = probe.warm, probe.timed
    images_s = batch * timed / (probe.edges[warm + timed] -
                                probe.edges[warm])
    med = statistics.median(a.elapsed_time(b) for a, b in
                            zip(probe.events[warm - 1:], probe.events[warm:]))
    mem, steady = probe.peaks()
    acc = est.train_metrics[0].get()[1]
    ok = est._fused is None and math.isfinite(acc)
    print(f"gluon lane Estimator.fit resnet50_v1 eager loop "
          f"(MXNET_FUSED_TRAIN_STEP=0) batch {batch}: "
          f"{GLUON_WARM + GLUON_TIMED} steps in {wall:.2f} s; "
          f"{images_s:.1f} images/s over the {timed} timed steps; step "
          f"median {med:.3f} ms (CUDA events); peak memory {mem:.2f} GiB "
          f"({steady:.2f} over the timed steps, {probe.base:.2f} allocated "
          f"before the lane); train acc {acc:.4f}; fused "
          f"step / eager loop images/s {fused['images_s'] / images_s:.3f}, "
          f"step median {fused['step_ms'] / med:.3f}, timed steps' peak "
          f"memory {fused['steady_gib'] / steady:.3f} [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "gluon lane: the eager loop took the fused step, or its "
          "accuracy is not finite")
    return {"images_s": images_s, "step_ms": med, "peak_gib": mem,
            "steady_gib": steady}


def bench_gluon_lane(mx, sym_v1, card, module_s):
    """Phase 8b, bench.py's gluon lane (`_run_gluon`, defaults :683-687):
    resnet50_v1 in bfloat16 through the public Estimator.fit on one
    resident batch of GLUON_BATCH, GLUON_WARM + GLUON_TIMED batches; the
    gluon fused step must take every one."""
    batch = RESNET_BATCH
    probe = _LaneProbe(GLUON_WARM, GLUON_TIMED)
    steps = GLUON_WARM + GLUON_TIMED
    est, (data, label), wall = bench_estimator(mx, batch, steps, probe)
    fused = est._fused
    check(fused is not None and fused.steps == steps,
          f"gluon lane: the fused step ran "
          f"{fused.steps if fused else 0} of {steps} batches")
    out = lane_numbers("gluon lane Estimator.fit resnet50_v1", probe, batch,
                       train_flops(sym_v1, batch), steps, card, module_s,
                       est.train_metrics[0].get()[1], wall)
    out["profile"] = profile_one_step(
        lambda: fused(data, label, batch), card,
        "gluon profile Estimator fused step", batch)
    return out


def baseline3_lane(mx, card, module_s, hybrid, warm, timed):
    """Phase 8b, BASELINE config #3: hybridized resnet50_v2 in bfloat16
    through the plain loop (record, backward, Trainer.step; SGD lr 0.05
    momentum 0.9, multi_precision) on one resident batch of RESNET_BATCH,
    `warm` + `timed` steps.  With ``hybrid=False`` the same loop on the
    net as built, op by op through `ndarray.invoke`: gluon's most common
    path, and the autograd tape's largest."""
    batch = RESNET_BATCH
    probe = _LaneProbe(warm, timed)
    net = gluon_net_bf16(mx, mx.gluon.model_zoo.vision.resnet50_v2)
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_OPT, multi_precision=True))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    data, label = resident_batch(mx, batch, seed=SEED + 1)

    def step():
        with mx.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(batch)
        metric.update([label], [out])
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(warm + timed):
        probe.mark(step().data)
    wall = time.perf_counter() - t0
    sym = mx.sym.SoftmaxOutput(mx.gluon.model_zoo.vision.resnet50_v2(
        classes=CLASSES)(mx.sym.Variable("data")), name="softmax")
    what = "hybridized" if hybrid else "un-hybridized"
    out = lane_numbers(f"gluon lane {what} resnet50_v2 plain loop", probe,
                       batch, train_flops(sym, batch), warm + timed,
                       card, module_s, metric.get()[1], wall)
    out["profile"] = profile_one_step(
        step, card, f"gluon profile {what} resnet50_v2 step", batch)
    return out


def gluon_phase(card, module_s):
    """Phase 8; returns the numbers the summary line prints."""
    import incubator_mxnet_tpu_torch as mx
    out = {}
    t0 = time.perf_counter()
    gluon_parity(mx)
    out["parity_s"] = time.perf_counter() - t0
    _, sym_v1 = resnet_symbol(mx)
    out["bench"] = bench_gluon_lane(mx, sym_v1, card, module_s)
    torch.cuda.empty_cache()
    out["bench_eager"] = bench_gluon_eager(mx, card, out["bench"])
    torch.cuda.empty_cache()
    out["baseline3"] = baseline3_lane(mx, card, module_s, True, V2_WARM,
                                      V2_TIMED)
    torch.cuda.empty_cache()
    out["eager_v2"] = baseline3_lane(mx, card, module_s, False, *V2_EAGER)
    torch.cuda.empty_cache()
    return out


# -- phase 9: the transformer LM served at GPT-2 small's widths -------------

def lm_values(cfg, seed=SEED):
    """{name: float32 numpy} under the llm.model names, GPT-2's
    initialisation: N(0, 0.02) for the embedding and the projections,
    out_proj and fc2 at 0.02 / sqrt(2 L) (GPT-2's residual scaling); so
    that every parameter takes part, gammas 1 + N(0, 0.02) and betas and
    biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    c, f = cfg.hidden, cfg.hidden * cfg.ffn_mult
    resid = LM_STD / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std=LM_STD, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= std
        a += mean
        return a

    out = {"lm_embed_weight": normal((cfg.vocab_size, c)),
           "lm_final_ln_gamma": normal((c,), mean=1.0),
           "lm_final_ln_beta": normal((c,))}
    for i in range(cfg.num_layers):
        pre = f"lm_block{i}_"
        for ln in ("ln1", "ln2"):
            out[f"{pre}{ln}_gamma"] = normal((c,), mean=1.0)
            out[f"{pre}{ln}_beta"] = normal((c,))
        for name, shape, std in (("qkv", (3 * c, c), LM_STD),
                                 ("out_proj", (c, c), resid),
                                 ("fc1", (f, c), LM_STD),
                                 ("fc2", (c, f), resid)):
            out[f"{pre}{name}_weight"] = normal(shape, std)
            out[f"{pre}{name}_bias"] = normal(shape[:1])
    return out


def lm_padded(tokens):
    """(1, bucket) int32 of `tokens` padded with zeros to its bucket of
    LM_BUCKETS."""
    n = len(tokens)
    out = np.zeros((1, next(b for b in LM_BUCKETS if n <= b)), np.int32)
    out[0, :n] = tokens
    return out


def lm_clear(logits, share):
    """Per row of `logits` (..., V): whether its top-2 margin exceeds
    share * max|logit| of the row (a near tie where it does not)."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > \
        share * logits.float().abs().amax(-1)


def held(got, ref, tol, what):
    """max |got - ref| / (rtol*|ref| + atol*max|ref|), compared on the
    CPU in float32; fails above 1."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    rtol, atol = tol
    bound = (rtol * ref.abs() + atol * ref.abs().max()).clamp_min(1e-30)
    ratio = ((got - ref).abs() / bound).max().item()
    check(ratio <= 1.0, f"{what}: {ratio:.3f} of the tolerance")
    return ratio


def lm_parity(mx, cfg, params, card):
    """Phase 9a: the decode plane on the card against the port on the
    CPU from the same parameters: prefills of LM_PROMPTS into slots 0-2
    (one per bucket), then LM_TICKS decode ticks fed the CPU's tokens;
    every call's logits, argmax where the CPU's margin is clear, and the
    caches' written rows.  On the card: the last step against a prefill
    of the prompt it had seen, and the 200-token prefill against the
    hybridized gluon TransformerLM's forward at its last position.  Then
    the same calls in bf16 (parameters and cache) against fp32 on the
    card."""
    from incubator_mxnet_tpu_torch.compat.weights import lm_params_from_numpy
    from incubator_mxnet_tpu_torch.llm import (DecodePrograms, LMConfig,
                                               TransformerLM, init_kv_cache,
                                               stack_lm_params)
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LM_PROMPTS]
    lanes = {}
    for name, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        progs = DecodePrograms(cfg, stack_lm_params(params, cfg, ctx),
                               label=name)
        lanes[name] = (progs,) + init_kv_cache(cfg, LM_SLOTS, ctx)
    out = {"worst": 0.0, "ties": 0, "rows": 0}
    calls = []   # (kind, args, the card's fp32 logits) for the bf16 replay

    def run(kind, *args):
        res = {n: getattr(p, kind)(p.params, ck, cv, *args)
               for n, (p, ck, cv) in lanes.items()}
        want, got = res["cpu"][3], res["card"][3]
        out["worst"] = max(out["worst"],
                           held(got, want, LM_TOL, f"9a {kind} logits"))
        clear = lm_clear(want, LM_TIE)
        out["ties"] += int((~clear).sum())
        out["rows"] += clear.numel()
        same = res["card"][2].cpu().long() == want.argmax(-1)
        check(bool(same[clear].all()),
              f"9a {kind}: the card's argmax differs at a clear margin")
        calls.append((kind, args, got.float().clone()))
        return res["cpu"][2].numpy()

    tokens = np.zeros(LM_SLOTS, np.int32)
    positions = np.zeros(LM_SLOTS, np.int32)
    seqs = []
    for slot, p in enumerate(prompts):
        tok = int(run("prefill", lm_padded(p), slot, len(p)))
        tokens[slot], positions[slot] = tok, len(p)
        seqs.append(list(p) + [tok])
    prefill_last = calls[-1][2]      # the longest prompt's, on the card
    for _ in range(LM_TICKS):
        nxt = run("step", tokens.copy(), positions.copy())
        for slot, seq in enumerate(seqs):
            tokens[slot] = nxt[slot]
            positions[slot] += 1
            seq.append(int(nxt[slot]))
    step_last = calls[-1][2]
    (_, ckc, cvc), (pg, ckg, cvg) = lanes["cpu"], lanes["card"]
    for slot, p in enumerate(prompts):
        rows = len(p) + LM_TICKS
        for got, want in ((ckg, ckc), (cvg, cvc)):
            out["worst"] = max(out["worst"], held(
                got[:, slot, :rows], want[:, slot, :rows], LM_TOL,
                f"9a cache rows of slot {slot}"))
    del lanes, ckc, cvc, ckg, cvg
    ck1, cv1 = init_kv_cache(cfg, 1, mx.gpu(0))
    out["extended"] = 0.0
    for slot, seq in enumerate(seqs):
        seen = np.asarray(seq[:-1])
        logits = pg.prefill(pg.params, ck1, cv1, lm_padded(seen), 0,
                            len(seen))[3]
        out["extended"] = max(out["extended"], held(
            step_last[slot], logits, LM_TOL,
            "9a a step against the prefill of the prompt it had seen"))
    del ck1, cv1, pg
    net = TransformerLM(cfg, prefix="lm_")
    lm_params_from_numpy(params, block=net, ctx=mx.gpu(0))
    net.hybridize()
    fwd = net(mx.nd.array(prompts[-1][None], ctx=mx.gpu(0),
                          dtype="int32")).data[0, -1]
    out["gluon"] = held(prefill_last, fwd, LM_TOL,
                        "9a prefill against the hybridized gluon forward")
    del net, fwd
    cfg16 = LMConfig(**dict(LM_CFG, param_dtype="bfloat16"))
    p16 = DecodePrograms(cfg16, stack_lm_params(
        {k: v.data.to(BF16) for k, v in params.items()}, cfg16, mx.gpu(0)))
    ck16, cv16 = init_kv_cache(cfg16, LM_SLOTS, mx.gpu(0))
    out["bf16_l2"], out["bf16_clear"] = 0.0, 0
    for kind, args, ref in calls:
        _, _, tok, logits = getattr(p16, kind)(p16.params, ck16, cv16, *args)
        l2 = ((logits.float() - ref).norm() / ref.norm()).item()
        out["bf16_l2"] = max(out["bf16_l2"], l2)
        check(l2 <= LM_BF16, f"9a bf16 {kind}: relative L2 {l2:.4f} of "
              f"the fp32 logits above {LM_BF16}")
        clear = lm_clear(ref, LM_BF16)
        out["bf16_clear"] += int(clear.sum())
        check(bool((tok.long() == ref.argmax(-1))[clear].all()),
              f"9a bf16 {kind}: argmax differs at a margin above "
              f"{LM_BF16} of max|logit|")
    del p16, ck16, cv16
    torch.cuda.empty_cache()
    print(f"lm parity: prefills of {'/'.join(map(str, LM_PROMPTS))} tokens "
          f"+ {LM_TICKS} teacher-forced ticks, card vs CPU (fp32): worst "
          f"{out['worst']:.3f} of rtol {LM_TOL[0]} + {LM_TOL[1]}*max|ref| "
          f"(logits and cache rows), argmax equal at every clear margin, "
          f"{out['ties']} near ties of {out['rows']} rows; on the card a "
          f"step vs the prefill of what it had seen {out['extended']:.3f}, "
          f"the prefill vs the hybridized gluon forward "
          f"{out['gluon']:.3f}; bf16 vs fp32 relative L2 at most "
          f"{out['bf16_l2']:.5f} (limit {LM_BF16}), argmax equal at "
          f"{out['bf16_clear']} rows of clear margin [{card}]")
    return out


def lm_trace(vocab):
    """Phase 9b's trace: tools/run_lm_bench.py's `_trace` (seed 17,
    LM_GROUPS groups), then LM_LONG long prompts."""
    rng = np.random.default_rng(17)
    trace = []
    for _ in range(LM_GROUPS):
        for new in [LM_SHORT_NEW] * (LM_SLOTS - 1) + [LM_LONG_NEW]:
            toks = [int(t) for t in rng.integers(1, 60,
                                                 int(rng.integers(2, 9)))]
            trace.append((toks, new))
    rng = np.random.default_rng(SEED + 92)
    for _ in range(LM_LONG):
        n = int(rng.integers(9, LM_BUCKETS[-1] + 1))
        trace.append(([int(t) for t in rng.integers(1, vocab, n)],
                      int(rng.integers(16, 65))))
    return trace


def lm_static(mx, programs, cfg, trace):
    """tools/run_lm_bench.py's static lane (`_static_lane`) through the
    same programs: batches of LM_SLOTS in trace order, each slot
    prefilled into a fresh cache, then every slot stepped until the
    batch's longest budget is spent.  Returns (continuations, whether
    each one's chain is clear of near ties, wall s, ticks)."""
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    conts, clear, ticks = [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for at in range(0, len(trace), LM_SLOTS):
        batch = trace[at:at + LM_SLOTS]
        ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
        tokens = np.zeros(LM_SLOTS, np.int32)
        positions = np.zeros(LM_SLOTS, np.int32)
        chains = [[] for _ in batch]
        margins = [[] for _ in batch]
        for s, (toks, _) in enumerate(batch):
            _, _, tok, logits = programs.prefill(
                programs.params, ck, cv, lm_padded(toks), s, len(toks))
            tokens[s], positions[s] = int(tok), len(toks)
            chains[s].append(int(tok))
            margins[s].append(lm_clear(logits, LM_TIE))
        for _ in range(max(new for _, new in batch) - 1):
            _, _, nxt, logits = programs.step(programs.params, ck, cv,
                                              tokens, positions)
            ok = lm_clear(logits, LM_TIE)
            tokens = nxt.cpu().numpy()
            positions += 1
            ticks += 1
            for s in range(len(batch)):
                chains[s].append(int(tokens[s]))
                margins[s].append(ok[s])
        for s, (_, new) in enumerate(batch):
            conts.append(chains[s][:new])
            clear.append(bool(torch.stack(margins[s][:new]).all()))
        del ck, cv
    torch.cuda.synchronize()
    return conts, clear, time.perf_counter() - t0, ticks


def lm_traffic(mx, cfg, params, card, trace):
    """Phase 9b in one dtype: `serving.DecodeEngine` on the card
    (LM_SLOTS slots, LM_BUCKETS), the trace submitted by LM_CLIENTS
    threads at priorities spread over the three classes; every future
    resolves, the continuations equal the static lane's through the same
    programs wherever its chain has no near tie, and no new signature
    appears.  Then the prefill per bucket and the step alone, timed."""
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    from incubator_mxnet_tpu_torch.serving.router import PRIORITIES
    dt = cfg.param_dtype
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = mx.serving.DecodeEngine(cfg, params, slots=LM_SLOTS,
                                  buckets=LM_BUCKETS, name=f"lm-{dt}",
                                  start=False, ctx=mx.gpu(0))
    tick_s = []
    step = eng.step

    def timed_step():
        t = time.perf_counter()
        n = step()
        if n:
            tick_s.append(time.perf_counter() - t)
        return n

    eng.step = timed_step
    programs = eng.warmup()
    check(programs == eng.programs.program_count() == len(LM_BUCKETS) + 1,
          f"9b {dt}: warmup prepared {programs} signatures, expected "
          f"{len(LM_BUCKETS) + 1}")
    eng.start()
    futs = [None] * len(trace)

    def client(k):
        for i in range(k, len(trace), LM_CLIENTS):
            toks, new = trace[i]
            futs[i] = eng.submit(toks, max_new_tokens=new, rid=f"lm-{i}",
                                 priority=PRIORITIES[i % len(PRIORITIES)])

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(k,))
               for k in range(LM_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(60)
        check(not t.is_alive(), f"9b {dt}: a client thread hung")
    results = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    classes = eng.metrics.snapshot()["classes"]
    eng.close(drain=False)
    got = [r["tokens"] for r in results]
    check([len(g) for g in got] == [new for _, new in trace],
          f"9b {dt}: a continuation is not its budget's length")
    static, clear, static_s, static_ticks = lm_static(mx, eng.programs, cfg,
                                                      trace)
    check(eng.programs.program_count() == programs and
          eng.programs.compile_count() == programs,
          f"9b {dt}: the traffic added a signature")
    bad = [i for i, c in enumerate(clear) if c and static[i] != got[i]]
    check(not bad, f"9b {dt}: sequences {bad} differ from the static lane")
    tied = [(i, static[i] == got[i]) for i, c in enumerate(clear) if not c]
    useful = sum(new for _, new in trace)
    rng = np.random.default_rng(SEED + 94)
    ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
    prefill_ms = {}
    for b in LM_BUCKETS:
        padded = rng.integers(1, cfg.vocab_size, (1, b)).astype(np.int32)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.programs.prefill(eng.programs.params, ck, cv, padded, 0, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prefill_ms[b] = statistics.median(times[1:])
    tokens = rng.integers(1, cfg.vocab_size, LM_SLOTS).astype(np.int32)
    positions = (np.arange(LM_SLOTS) * 37 + 64).astype(np.int32)
    times = []
    for _ in range(21):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.programs.step(eng.programs.params, ck, cv, tokens, positions)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    del ck, cv
    out = {
        "tokens_s": useful / wall, "static_tokens_s": useful / static_s,
        "ticks": stats["ticks"], "static_ticks": static_ticks,
        "tick_ms": statistics.median(tick_s) * 1e3,
        "tick_p99_ms": float(np.percentile(tick_s, 99)) * 1e3,
        "step_ms": statistics.median(times[1:]), "prefill_ms": prefill_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "classes": classes, "programs": eng.programs}
    out["ratio"] = out["tokens_s"] / out["static_tokens_s"]
    print(f"lm serve {dt}: {len(trace)} sequences from {LM_CLIENTS} "
          f"clients, {useful} tokens: continuous {out['tokens_s']:.1f} "
          f"tokens/s in {stats['ticks']} ticks ({wall:.2f} s), static "
          f"{out['static_tokens_s']:.1f} tokens/s in {static_ticks} ticks "
          f"({static_s:.2f} s), ratio {out['ratio']:.3f}; every future "
          f"resolved; {len(trace) - len(tied)} continuations equal the "
          f"static lane's, {len(tied)} with a near tie in the chain "
          f"(rid, equal): {tied}; signatures {programs} before and after "
          f"[{card}]")
    print(f"lm serve {dt}: tick median {out['tick_ms']:.3f} ms, p99 "
          f"{out['tick_p99_ms']:.3f} ms; the step alone (8 slots) "
          f"{out['step_ms']:.3f} ms; prefill "
          + ", ".join(f"bucket {b} {ms:.3f} ms"
                      for b, ms in prefill_ms.items())
          + f"; peak {out['peak_gib']:.2f} GiB [{card}]")
    for cls in PRIORITIES:
        c = classes.get(cls, {})
        print(f"lm serve {dt}: {cls}: {c.get('responses')} responses, "
              f"latency p50 {c.get('p50_ms') or 0:.1f} ms p99 "
              f"{c.get('p99_ms') or 0:.1f} ms [{card}]")
    return out


def _device_us(event):
    """Inclusive device time (us) of a profiler CPU event (the name
    changed across torch versions)."""
    if hasattr(event, "device_time_total"):
        return event.device_time_total
    return event.cuda_time_total


def lm_profile(mx, cfg, programs, card, tries=3):
    """Phase 9c, in cfg's dtype: one warm tick under torch.profiler, a
    bucket-256 prefill into slot 0 and a decode step of LM_SLOTS active
    slots: kernels, device ms by class (the inclusive device time of the ops the decode
    plane calls), host ms to enqueue, the device's busy share, and the
    step's bytes bound (parameters and the live cache read once)."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    rng = np.random.default_rng(SEED + 93)
    ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
    n = LM_BUCKETS[-1] - 16
    prompt = lm_padded(rng.integers(1, cfg.vocab_size, n))
    tokens = rng.integers(1, cfg.vocab_size, LM_SLOTS).astype(np.int32)
    positions = (np.arange(LM_SLOTS) * 37 + n).astype(np.int32)

    def tick():
        programs.prefill(programs.params, ck, cv, prompt, 0, n)
        programs.step(programs.params, ck, cv, tokens, positions)

    tick()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tick()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"lm profile {cfg.param_dtype}: the profiler saw no "
          "device activity")
    busy, edge, kernels = 0.0, -math.inf, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
        kernels[name] = kernels.get(name, 0.0) + (end - start)
    device_us = sum(kernels.values())
    by_class, other = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or \
                e.cpu_parent is not None:
            continue
        us = _device_us(e)
        cls = next((label for label, names in LM_OP_CLASSES
                    if e.name in names), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        if cls == "other":
            other[e.name] = other.get(e.name, 0.0) + us
    item = ck.element_size()
    p = programs.params
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [p["embed"], p["final_ln_gamma"], p["final_ln_beta"]]
                      + list(p["layers"].values()))
    live = 2 * cfg.num_layers * int((positions + 1).sum()) * cfg.hidden * item
    bound_ms = (param_bytes + live) / HBM_BYTES_S * 1e3
    label = f"lm profile {cfg.param_dtype}"
    print(f"{label}: one warm tick (prefill of {n} tokens in bucket "
          f"{LM_BUCKETS[-1]}, step of {LM_SLOTS} slots at rows "
          f"{positions.min()}-{positions.max()}): {host_ms:.2f} ms of host "
          f"time to enqueue, {wall_ms:.2f} ms to finish, {len(spans)} "
          f"kernels, device time {device_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3 / wall_ms:.3f}; the step's bytes bound "
          f"{bound_ms:.3f} ms ({param_bytes / 1e9:.3f} GB of parameters + "
          f"{live / 1e9:.3f} GB of live cache at {HBM_BYTES_S / 1e12:.2f} "
          f"TB/s) [{card}]")
    total = sum(by_class.values())
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{label}: {us / 1e3:9.3f} ms "
              f"{us / total if total else 0.0:6.3f} {cls}")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:4]:
        print(f"{label}: other: {us / 1e3:8.3f} ms {name[:80]}")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        print(f"{label}: kernel: {us / 1e3:8.3f} ms {name[:90]}")
    del ck, cv
    return {"busy": busy / 1e3 / wall_ms, "host_ms": host_ms,
            "device_ms": device_us / 1e3, "kernels": len(spans),
            "bound_ms": bound_ms}


def lm_phase(card, workdir):
    """Phase 9; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on the LM's serving path."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import LMConfig
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    cfg = LMConfig(**LM_CFG)
    t0 = time.perf_counter()
    path = os.path.join(workdir, "lm-gpt2-small-widths.params")
    values = lm_values(cfg)
    count = sum(v.size for v in values.values())
    mx.nd.save(path, {k: mx.nd.array(v, ctx=mx.cpu())
                      for k, v in values.items()})
    del values
    params = mx.nd.load(path)
    os.remove(path)
    print(f"lm: {count / 1e6:.2f} M parameters (seed {SEED}) through "
          f"nd.save / nd.load in {time.perf_counter() - t0:.1f} s")
    out = {"parity": lm_parity(mx, cfg, params, card)}
    trace = lm_trace(cfg.vocab_size)
    out["fp32"] = lm_traffic(mx, cfg, params, card, trace)
    out["profile"] = lm_profile(mx, cfg, out["fp32"].pop("programs"), card)
    cfg16 = LMConfig(**dict(LM_CFG, param_dtype="bfloat16"))
    out["bf16"] = lm_traffic(mx, cfg16, {k: v.data.to(BF16)
                                         for k, v in params.items()},
                             card, trace)
    out["profile_bf16"] = lm_profile(mx, cfg16, out["bf16"].pop("programs"),
                                     card)
    launches = [w.launches for w in counted]
    print(f"lm: K1/K2/K3 launches over phase 9: {launches} (no TPU kernel "
          f"is on the LM's serving path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on the LM path")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 10: training the LM at GPT-2 small's widths ------------------------

def lm_opt(batch, t):
    """LM_TRAIN_OPT with the gradient rescaled to the per-token mean."""
    return dict(LM_TRAIN_OPT, rescale_grad=1.0 / (batch * t))


def lm_train_cfg(**kw):
    from incubator_mxnet_tpu_torch.llm import LMConfig
    return LMConfig(**dict(LM_CFG, **kw))


def lm_tokens(mx, batch, t, vocab, ctx, seed):
    """A DataBatch of random next-token pairs: data (batch, t) tokens as
    float32, label the same stream shifted by one."""
    x = np.random.RandomState(seed).randint(1, vocab, (batch, t + 1))
    return mx.io.DataBatch(
        [mx.nd.array(x[:, :-1].astype("f4"), ctx=ctx)],
        [mx.nd.array(x[:, 1:].astype("f4"), ctx=ctx)])


def lm_train_flops(n_params, cfg, batch, t):
    """Operations of one training step: 6 per parameter per token (the
    forward's multiply-add and the backward's two), plus attention's
    Q.K^T and P.V (4 B T^2 C a layer forward, x3 with the backward)."""
    return 6 * n_params * batch * t + \
        3 * cfg.num_layers * 4 * batch * t * t * cfg.hidden


def lm_ce(probs, labels):
    """Mean -log p[label] of one batch's (B*T, V) softmax outputs."""
    p = probs.asnumpy()
    y = labels.asnumpy().reshape(-1).astype(int)
    return float(-np.log(p[np.arange(len(p)), y]).mean())


def lm_train_steps(mx, sym, ctx, batches, dtype, teacher=None, keep=False,
                   after=None):
    """The LM's fused steps (Module.fit_step) in `dtype` on `ctx` from
    Xavier parameters under mx.random.seed(SEED).  Returns the first
    batch's embed_weight gradient at the initial state
    (Module.forward_backward; None with `teacher`), the loss of each
    step, and with `keep` the states ({parameter}, {momentum}) before the
    first step and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it; `after(k, state)`
    sees the state after step k."""
    mod = mx.mod.Module(sym, context=ctx)
    batch, t = batches[0].data[0].shape
    mod.bind([("data", (batch, t))], [("softmax_label", (batch, t))])
    if dtype == "float64":
        as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params=lm_opt(batch, t))
    names = mod._exec_group.param_names

    def state():
        return ({n: v.asnumpy() for n, v in mod.get_params()[0].items()},
                {names[i]: m.asnumpy()
                 for i, m in mod._updater.states.items()})

    grad = None
    if teacher is None:
        mod.forward_backward(batches[0])
        exe = mod._exec_group.execs[0]
        grad = exe.grad_dict["lm_embed_weight"].asnumpy()
    losses, states = [], [state()] if keep else []
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms = teacher[k]
            mod.set_params(params, {})
            for i, n in enumerate(names):
                mod._updater.states[i]._set_data(moms[n])
        mod.fit_step(b, mx.metric.create("acc"))
        losses.append(lm_ce(mod.get_outputs()[0], b.label[0]))
        if keep or after is not None:
            st = state()
            if keep:
                states.append(st)
            if after is not None:
                after(k + 1, st)
    check(mod._fused_step is not None and mod._fused_step.steps ==
          len(batches), f"lm train parity on {ctx}: the fused step did "
          "not run every step")
    del mod
    gc.collect()
    return grad, losses, states


def lm_train_parity(mx, sym, card):
    """Phase 10a: LM_TRAIN_PARITY fused steps of the full-width LM on the
    card against the CPU from the same Xavier parameters and batches, in
    float64: every step's loss free running; the first batch's
    embed_weight gradient (the lookup's scatter plus the tied head's
    product); and each card step from the CPU's state before it, its
    parameters and momenta within PARITY_TOL.  Then float32 (TF32 off):
    each device's step from the float64 CPU state, the card's relative
    L2 distance from the float64 step at most LM_TRAIN_ENVELOPE times
    the CPU's."""
    batch, t, steps = LM_TRAIN_PARITY
    vocab = LM_CFG["vocab_size"]
    batches = [lm_tokens(mx, batch, t, vocab, mx.cpu(), SEED + 20 + k)
               for k in range(steps)]
    t0 = time.perf_counter()
    g_cpu, cpu_loss, cpu = lm_train_steps(mx, sym, mx.cpu(), batches,
                                          "float64", keep=True)
    t_cpu = time.perf_counter() - t0
    g_card, card_loss, _ = lm_train_steps(mx, sym, mx.gpu(0), batches,
                                          "float64")
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(card_loss, cpu_loss))
    grad = param_ratio({"embed": g_card}, {"embed": g_cpu})[0]
    worst = [(0.0, "none")]

    def hold(k, st):
        for got, ref in zip(st, cpu[k]):
            worst.append(param_ratio(got, ref))
    lm_train_steps(mx, sym, mx.gpu(0), batches, "float64", teacher=cpu,
                   after=hold)
    held_ = max(worst)
    ok = loss_err <= PARITY_TOL[0] and held_[0] <= 1 and grad <= 1
    print(f"lm train parity float64: {steps} fused steps at batch {batch} "
          f"x T {t}, full width, card vs CPU (CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in card_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); embed_weight "
          f"gradient (lookup + tied head) at {grad:.3f} of the tolerance; "
          f"each step from the CPU's state: parameters and momenta at "
          f"{held_[0]:.3f} of the tolerance (worst {held_[1]}) (rtol "
          f"{PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "lm train: the card's float64 steps disagree with the CPU's")

    factor, extra = LM_TRAIN_ENVELOPE
    dist = {}

    def l2(device):
        def f(k, st):
            for what, got, ref in zip(("parameters", "momenta"), st,
                                      cpu[k]):
                dist[(device, what, k)] = rel_l2(got, ref, ())
        return f
    losses32 = {}
    for device, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        _, losses32[device], _ = lm_train_steps(
            mx, sym, ctx, batches, "float32", teacher=cpu, after=l2(device))
    ok, lines = True, []
    for (device, what, k), dc in sorted(dist.items()):
        if device != "cpu":
            continue
        dg = dist[("card", what, k)]
        ok = ok and dg <= factor * dc + extra
        lines.append(f"{what} step {k} {dg:.2e} vs {dc:.2e}")
    loss32 = max(abs(v - c) / abs(c) for run in losses32.values()
                 for v, c in zip(run, cpu_loss))
    ok = ok and loss32 <= PARITY_TOL[0]
    print(f"lm train parity float32, each step from the float64 CPU's "
          f"state: loss within {loss32:.2e} of float64 on both (rtol "
          f"{PARITY_TOL[0]:g}); relative L2 distance from the float64 "
          f"step, card vs CPU: {'; '.join(lines)} (card <= {factor:g} x "
          f"CPU + {extra:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "lm train: the card's float32 steps are farther from float64"
          " than the CPU's")
    del cpu
    gc.collect()
    return {"loss_err": loss_err, "held": held_[0], "grad": grad}


class _SnapshotProbe:
    """Times CheckpointManager.snapshot (the synchronous phase, on the
    host) and each background write (seconds, bytes) while active."""

    def __init__(self):
        from incubator_mxnet_tpu_torch.checkpoint import manager, snapshot
        self._targets = ((manager.CheckpointManager, "snapshot", self.sync),
                         (snapshot.SnapshotJob, "write", self.write))
        self.sync_ms, self.writes = [], []

    def sync(self, orig):
        def f(mgr, *a, **k):
            t0 = time.perf_counter()
            out = orig(mgr, *a, **k)
            self.sync_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return f

    def write(self, orig):
        def f(job):
            t0 = time.perf_counter()
            orig(job)
            self.writes.append((time.perf_counter() - t0,
                                job.bytes_written, job.seconds))
        return f

    def __enter__(self):
        self._saved = [(cls, name, getattr(cls, name))
                       for cls, name, _ in self._targets]
        for cls, name, wrap in self._targets:
            setattr(cls, name, wrap(getattr(cls, name)))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)


def lm_train_lane(mx, sym, cfg, card, ckpt_dir=None):
    """Phase 10b: the LM at LM_TRAIN_LANE (8 x 1024 tokens a step, fp32,
    TF32 off) through the public Module.fit on one resident random
    batch, the fused step every step; tokens/s over CUDA-synchronised
    window edges, the median step ms between CUDA events at each batch
    end, the loss of every step (computed on the card), peak memory,
    mfu against the fp32 CUDA-core peak.  With `ckpt_dir`: the same run
    with elastic checkpoints every LM_CKPT_PERIOD batches, and the
    snapshot's synchronous ms, each background write's seconds and
    bytes.  Returns (module, numbers)."""
    batch, t, warm, timed = LM_TRAIN_LANE
    one = lm_tokens(mx, batch, t, cfg.vocab_size, mx.gpu(0), SEED + 30)
    it = resident(mx, one.data[0], one.label[0], warm + timed)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    events, losses, edges = [], [], {}
    ce = mx.metric.create("ce")

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        label = mod._exec_group.execs[0].arg_dict["softmax_label"]
        total, n = ce.device_update([label], mod.get_outputs())
        losses.append(total / n)
        if p.nbatch in (warm - 1, warm + timed - 1):
            torch.cuda.synchronize()
            edges[p.nbatch] = time.perf_counter()
            edges["acc"] = p.eval_metric.get()[1]

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    kw = {} if ckpt_dir is None else dict(
        checkpoint_dir=ckpt_dir, checkpoint_period=LM_CKPT_PERIOD,
        checkpoint_keep_last=2)
    with _SnapshotProbe() as snaps:
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=lm_opt(batch, t), eval_metric="acc",
                initializer=mx.initializer.Xavier(),
                batch_end_callback=probe, kvstore=None, **kw)
        wall = time.perf_counter() - t0
    steps = warm + timed
    fused = mod._fused_step
    check(fused is not None and fused.steps == steps,
          f"lm lane: the fused step ran {fused.steps if fused else 0} of "
          f"{steps} steps")
    loss = torch.stack(losses).cpu().numpy()
    tokens_s = batch * t * timed / (edges[warm + timed - 1] -
                                    edges[warm - 1])
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warm - 1:],
                                                 events[warm:])]
    med = statistics.median(step_ms)
    n_params = sum(v.size for v in mod.get_params()[0].values())
    flops = lm_train_flops(n_params, cfg, batch, t)
    mfu = tokens_s * flops / (batch * t) / FP32_CUDA_CORE_FLOPS
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0]
    what = "no checkpoints" if ckpt_dir is None else \
        f"checkpoints every {LM_CKPT_PERIOD} batches"
    print(f"lm train lane fp32 batch {batch} x T {t} ({what}): {steps} "
          f"steps through Module.fit in {wall:.2f} s ({warm} warm), fused "
          f"step every step; {tokens_s:.1f} tokens/s over the {timed} "
          f"timed steps; step median {med:.3f} ms (p10 "
          f"{np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{n_params / 1e6:.2f} M parameters, {flops / 1e12:.3f} TFLOP a "
          f"step; peak memory {mem:.2f} GiB [{card}]")
    print(f"lm train lane fp32 ({what}): loss first {loss[0]:.4f}, last "
          f"{loss[-1]:.4f}, every {' '.join(f'{v:.3f}' for v in loss[::4])}"
          f"; train acc {edges['acc']:.4f} {'ok' if ok else 'FAIL'}")
    print(f"mfu lm fp32{'' if ckpt_dir is None else ' checkpointed'} "
          f"{mfu:.4f} (of {FP32_CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s) "
          f"[{card}]")
    check(ok, f"lm lane ({what}): loss not finite or not falling")
    out = {"tokens_s": tokens_s, "step_ms": med, "mfu": mfu,
           "peak_gib": mem, "flops": flops, "n_params": n_params,
           "loss": (float(loss[0]), float(loss[-1]))}
    if ckpt_dir is not None:
        check(snaps.writes and snaps.sync_ms, "lm lane: no snapshot taken")
        secs = [w[0] for w in snaps.writes]
        nbytes = snaps.writes[-1][1]
        parts = {k: statistics.median(w[2][k] for w in snaps.writes)
                 for k in ("wait", "blobs", "write")}
        out.update(sync_ms=statistics.median(snaps.sync_ms),
                   sync_first_ms=snaps.sync_ms[0], write_s=max(secs),
                   write_bytes=nbytes, snapshots=len(snaps.writes),
                   write_parts=parts)
        print(f"lm train lane checkpoints: {len(snaps.writes)} snapshots "
              f"(every {LM_CKPT_PERIOD} batches and the epoch's end); "
              f"the snapshot call on the host median {out['sync_ms']:.2f} "
              f"ms (first {out['sync_first_ms']:.2f} ms, pinned buffers "
              f"allocated; a call waits while the previous write is in "
              f"flight); background write {min(secs):.2f}-{max(secs):.2f} "
              f"s for {nbytes / 1e9:.3f} GB ({nbytes / 1e9 / max(secs):.2f}"
              f" GB/s at the slowest), median parts: copies landing "
              f"{parts['wait']:.3f} s, optimizer blob pickled "
              f"{parts['blobs']:.3f} s, shards written and committed "
              f"{parts['write']:.3f} s [{card}]")
    return mod, out


def lm_component_ms(mx, cfg, card, step_ms):
    """Phase 10d, the parts of a step timed alone at the lane's shapes
    (CUDA events, median of 5 after a warm call): one layer's
    BlockwiseAttention forward and backward (x num_layers), the tied
    head's FullyConnected and SoftmaxOutput forward and backward, and
    the one-hot SoftmaxOutput's backward builds."""
    from incubator_mxnet_tpu_torch.ops import registry
    from incubator_mxnet_tpu_torch.ops.loss_output import _one_hot
    batch, t = LM_TRAIN_LANE[:2]
    c, v = cfg.hidden, cfg.vocab_size
    dev = mx.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           requires_grad=True)

    attn = registry.get("BlockwiseAttention")
    ap = attn.canonicalize_params({"num_heads": cfg.num_heads,
                                   "causal": True})
    fc, so = registry.get("FullyConnected"), registry.get("SoftmaxOutput")
    fp = fc.canonicalize_params({"num_hidden": v, "no_bias": True})
    sp = so.canonicalize_params({})
    q, k, vv = rand(batch, t, c), rand(batch, t, c), rand(batch, t, c)
    h, w = rand(batch * t, c), rand(v, c)
    label = torch.randint(0, v, (batch * t,), device=dev,
                          generator=gen).float()
    ct = torch.randn(batch, t, c, device=dev, generator=gen)

    def attention():
        out = attn.fn(ap, q, k, vv)
        torch.autograd.grad(out, (q, k, vv), ct)

    def head():
        out = so.fn(sp, fc.fn(fp, h, w), label)
        torch.autograd.grad(out, (h, w), torch.ones_like(out))

    def one_hot():
        _one_hot(label.to(torch.int32), v, -1, torch.float32)

    out = {}
    for name, fn in (("attention", attention), ("head", head),
                     ("one_hot", one_hot)):
        fn()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
    attn_ms = out["attention"] * cfg.num_layers
    print(f"lm train parts, alone at batch {batch} x T {t}: attention "
          f"(BlockwiseAttention forward + backward) {out['attention']:.3f} "
          f"ms a layer, {attn_ms:.3f} ms for {cfg.num_layers} "
          f"({attn_ms / step_ms:.3f} of the step); the tied head and "
          f"SoftmaxOutput forward + backward {out['head']:.3f} ms "
          f"({out['head'] / step_ms:.3f}), of which building the "
          f"({batch * t}, {v}) fp32 one-hot {out['one_hot']:.3f} ms "
          f"({out['one_hot'] / step_ms:.3f}) [{card}]")
    del q, k, vv, h, w, ct
    torch.cuda.empty_cache()
    return dict(out, attention_all=attn_ms)



def lm_resume_child(mode, ckpt_dir, out_path):
    """Phase 10c's child process (`python -c`): the reduced-depth LM
    (LM_RESUME) through Module.fit on the card under
    torch.use_deterministic_algorithms(True), from Xavier under one
    seed, over a shuffled NDArrayIter.  `mode`: "full" (no
    checkpoints), "kill" (SIGKILL itself once batch kill_after is done),
    "term" (waits at batch term_after for SIGTERM, whose hook takes the
    final snapshot and exits 143), "resume" (resume=True).  Prints
    "STEP n" after each batch; writes the sha256 of every parameter's
    and momentum's bytes to `out_path`."""
    import hashlib
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import lm_symbol
    r = LM_RESUME
    cfg = lm_train_cfg(num_layers=r["layers"])
    n = r["batch"] * r["batches"]
    x = np.random.RandomState(SEED + 50).randint(
        1, cfg.vocab_size, (n, r["t"] + 1))
    mx.random.seed(SEED)
    np.random.seed(SEED)     # NDArrayIter shuffles with numpy's generator
    it = mx.io.NDArrayIter(x[:, :-1].astype("f4"), x[:, 1:].astype("f4"),
                           batch_size=r["batch"], shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(lm_symbol(cfg), context=mx.gpu(0))
    done = {"n": 0}

    def cb(p):
        done["n"] += 1
        step = p.epoch * r["batches"] + p.nbatch + 1
        print(f"STEP {step}", flush=True)
        if mode == "kill" and step == r["kill_after"]:
            torch.cuda.synchronize()
            os.kill(os.getpid(), signal.SIGKILL)
        if mode == "term" and step == r["term_after"]:
            mgr = p.locals["ckpt_mgr"]
            deadline = time.time() + 120
            while not mgr.preempt_requested and time.time() < deadline:
                time.sleep(0.02)

    mod.fit(it, num_epoch=r["epochs"], optimizer="sgd",
            optimizer_params=lm_opt(r["batch"], r["t"]), eval_metric="acc",
            initializer=mx.initializer.Xavier(),
            checkpoint_dir=None if mode == "full" else ckpt_dir,
            checkpoint_period=r["period"], checkpoint_keep_last=2,
            resume=mode == "resume", batch_end_callback=cb, kvstore=None)
    names = mod._exec_group.param_names

    def digest(a):
        return hashlib.sha256(a.data.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()
    out = {"param:" + k: digest(v)
           for k, v in mod.get_params()[0].items()}
    out.update({"momentum:" + names[i]: digest(s)
                for i, s in mod._updater.states.items()})
    out["num_update"] = mod._optimizer.num_update
    out["batches_run"] = done["n"]
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def lm_resume(card, workdir):
    """Phase 10c: bitwise resume on the card across processes.  Three
    children at once: an uninterrupted fit, a fit SIGKILLed after batch
    kill_after, and a fit sent SIGTERM at batch term_after (it must exit
    143 and leave a valid snapshot marked preempted); then two children
    resume from those directories.  Every parameter and momentum of each
    resumed fit must equal the uninterrupted fit's bit for bit."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    r = LM_RESUME
    env = dict(os.environ, **LM_RESUME_ENV)
    root = tempfile.mkdtemp(dir=workdir, prefix="lm-resume-")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.lm_resume_child(*sys.argv[1:]))")
    procs = {}

    def spawn(name, mode, d):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code, mode, d,
             os.path.join(root, name + ".json")], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(name, timeout=600):
        out, err = procs[name].communicate(timeout=timeout)
        return procs[name].returncode, out, err

    kill_dir, term_dir = (os.path.join(root, "kill"),
                          os.path.join(root, "term"))
    t0 = time.perf_counter()
    try:
        spawn("full", "full", "-")
        spawn("kill", "kill", kill_dir)
        spawn("term", "term", term_dir)
        term = procs["term"]
        seen = []
        for line in term.stdout:
            seen.append(line)
            if line.strip() == f"STEP {r['term_after']}":
                term.send_signal(signal.SIGTERM)
                break
        codes = {name: finish(name) for name in ("full", "kill", "term")}
        codes["term"] = (codes["term"][0], "".join(seen) + codes["term"][1],
                         codes["term"][2])
        for name, want in (("full", 0), ("kill", -signal.SIGKILL),
                           ("term", 143)):
            rc, out, err = codes[name]
            check(rc == want, f"10c {name}: exit {rc}, expected {want}: "
                  f"{out[-800:]} {err[-2000:]}")
        for d in (kill_dir, term_dir):
            check(ckpt.latest(d) is not None, f"10c: no valid snapshot in "
                  f"{d}")
        last_kill = ckpt.load(ckpt.latest(kill_dir))
        last_term = ckpt.load(ckpt.latest(term_dir))
        check(last_term.meta.get("preempted") is True and
              last_term.step == r["term_after"],
              f"10c: SIGTERM's snapshot is step {last_term.step}, meta "
              f"{last_term.meta}")
        t1 = time.perf_counter()
        spawn("resume_kill", "resume", kill_dir)
        spawn("resume_term", "resume", term_dir)
        for name in ("resume_kill", "resume_term"):
            rc, out, err = finish(name)
            check(rc == 0, f"10c {name}: exit {rc}: {err[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for name in ("full", "resume_kill", "resume_term"):
        with open(os.path.join(root, name + ".json")) as f:
            res[name] = json.load(f)
    total = r["batches"] * r["epochs"]
    check(res["full"]["num_update"] == total, "10c: the full fit ran "
          f"{res['full']['num_update']} updates")
    arrays = [k for k in res["full"] if ":" in k]
    for name in ("resume_kill", "resume_term"):
        diff = [k for k in arrays if res[name][k] != res["full"][k]]
        check(not diff and res[name]["num_update"] == total,
              f"10c {name}: {len(diff)} of {len(arrays)} arrays differ "
              f"from the uninterrupted fit bitwise ({diff[:4]})")
    shutil.rmtree(root, ignore_errors=True)
    print(f"lm resume: {r['layers']} layers at width "
          f"{LM_CFG['hidden']} (vocab {LM_CFG['vocab_size']}), batch "
          f"{r['batch']} x {r['t']}, {r['epochs']} epochs of "
          f"{r['batches']} shuffled batches, snapshots every "
          f"{r['period']} batches, deterministic algorithms "
          f"({LM_RESUME_ENV}): SIGKILL after batch {r['kill_after']} "
          f"(newest valid snapshot: step {last_kill.step}), resumed for "
          f"{res['resume_kill']['batches_run']} batches; SIGTERM at batch "
          f"{r['term_after']}: exit 143, final snapshot step "
          f"{last_term.step} marked preempted, resumed for "
          f"{res['resume_term']['batches_run']} batches; {len(arrays)} "
          f"parameters and momenta of both resumed fits equal the "
          f"uninterrupted fit's bitwise; children {t1 - t0:.1f} s + "
          f"{time.perf_counter() - t1:.1f} s [{card}]")
    return {"kill_step": last_kill.step, "arrays": len(arrays)}


def lm_serve_trained(mx, cfg, mod, ckpt_dir, card):
    """Phase 10e: the newest checkpoint of the checkpointed lane loaded
    (`checkpoint.load`, `compat.weights.lm_params_from_numpy`) into
    `serving.DecodeEngine`; prefills of three prompts held to the
    trained Module's forward at each prompt's last position (the log
    softmax, centred), and one greedy token each through the engine
    equal to the Module's argmax where its margin is clear."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.compat.weights import lm_params_from_numpy
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    data = ckpt.load(ckpt.latest(ckpt_dir))
    params = lm_params_from_numpy(data.arrays, ctx=mx.gpu(0))
    trained = mod.get_params()[0]
    check(all(np.array_equal(params[k].asnumpy(), v.asnumpy())
              for k, v in trained.items()),
          "10e: the newest checkpoint is not the trained parameters")
    batch, t = LM_TRAIN_LANE[:2]
    rng = np.random.default_rng(SEED + 60)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LM_PROMPTS]
    x = np.zeros((batch, t), np.float32)
    for i, p in enumerate(prompts):
        x[i, :len(p)] = p
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.gpu(0))],
                                [mx.nd.zeros((batch, t), ctx=mx.gpu(0))]),
                is_train=False)
    probs = mod.get_outputs()[0].data.reshape(batch, t, -1)
    eng = mx.serving.DecodeEngine(cfg, params, slots=4, buckets=LM_BUCKETS,
                                  name="lm-trained", ctx=mx.gpu(0))
    worst = 0.0
    try:
        progs = eng.programs
        ck, cv = init_kv_cache(cfg, 1, mx.gpu(0))
        futs = [eng.submit(p, max_new_tokens=1) for p in prompts]
        toks = [f.result(300)["tokens"][0] for f in futs]
        clear = 0
        for i, p in enumerate(prompts):
            logits = progs.prefill(progs.params, ck, cv, lm_padded(p), 0,
                                   len(p))[3].float().reshape(-1)
            got = torch.log_softmax(logits, -1)
            want = torch.log(probs[i, len(p) - 1].float() + 1e-30)
            worst = max(worst, held(got - got.mean(), want - want.mean(),
                                    LM_TOL, f"10e prefill of {len(p)}"))
            if bool(lm_clear(want[None], LM_TIE)[0]):
                clear += 1
                check(toks[i] == int(want.argmax()),
                      f"10e: greedy token {toks[i]} vs the Module's "
                      f"{int(want.argmax())}")
    finally:
        eng.close(drain=True)
    print(f"lm serve trained: the checkpoint of step {data.step} (equal "
          f"to the trained parameters) in DecodeEngine; prefills of "
          f"{'/'.join(map(str, LM_PROMPTS))} tokens vs the trained "
          f"Module's forward: worst {worst:.3f} of rtol {LM_TOL[0]} + "
          f"{LM_TOL[1]}*max|ref| (log softmax), greedy token equal at "
          f"{clear} of {len(prompts)} clear margins [{card}]")
    return worst


def lm_train_phase(card, workdir):
    """Phase 10; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on the LM's training path."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import lm_symbol
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    cfg = lm_train_cfg()
    sym = lm_symbol(cfg)
    out = {}
    t0 = time.perf_counter()
    out["parity"] = lm_train_parity(mx, sym, card)
    print(f"phase 10a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mod, out["lane"] = lm_train_lane(mx, sym, cfg, card)
    one = lm_tokens(mx, *LM_TRAIN_LANE[:2], cfg.vocab_size, mx.gpu(0),
                    SEED + 31)
    metric = mx.metric.create("acc")
    prof = profile_one_step(lambda: mod.fit_step(one, metric), card,
                            "lm train profile", LM_TRAIN_LANE[0],
                            dtype="fp32", classes=LM_TRAIN_CLASSES)
    out["profile"] = prof
    out["parts"] = lm_component_ms(mx, cfg, card, out["lane"]["step_ms"])
    del mod
    ckpt_dir = tempfile.mkdtemp(dir=workdir, prefix="lm-ckpt-")
    try:
        mod, out["ckpt"] = lm_train_lane(mx, sym, cfg, card,
                                         ckpt_dir=ckpt_dir)
        out["ckpt"]["slowdown"] = out["ckpt"]["step_ms"] / \
            out["lane"]["step_ms"]
        print(f"lm train lane: checkpointed step median "
              f"{out['ckpt']['step_ms']:.3f} ms vs {out['lane']['step_ms']:.3f}"
              f" ms without ({out['ckpt']['slowdown']:.3f}x); tokens/s "
              f"{out['ckpt']['tokens_s']:.1f} vs {out['lane']['tokens_s']:.1f}"
              f" [{card}]")
        out["serve"] = lm_serve_trained(mx, cfg, mod, ckpt_dir, card)
        del mod
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10b/d/e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["resume"] = lm_resume(card, workdir)
    print(f"phase 10c: {time.perf_counter() - t0:.1f} s")
    launches = [w.launches for w in counted]
    print(f"lm train: K1/K2/K3 launches over phase 10: {launches} (no TPU "
          f"kernel is on the LM's training path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on the LM "
          "training path")
    return out


def dtype_keys(prefix, rep):
    """A kernel's case in a second dtype under keys of their own in the
    JSON line."""
    return {f"{prefix}_{key}": rep[key] for key in
            ("shape", "ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")}


def main():
    if sys.argv[1:]:
        print(f"usage: python3 chip_smoke.py (takes no arguments; got "
              f"{' '.join(sys.argv[1:])})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.kernels import _build

    card = card_line()
    print(f"device: {card}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for matmul and cuDNN (fp32 comparisons are fp32)")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            entry = re.search(r"entry function '\w*?_cu_[0-9a-f]+\d+(\w+)'",
                              line)
            if entry:
                print(f"build: {name}: {entry.group(1)[:60]}")
            elif "registers" in line or "spill" in line or \
                    "wgmma" in line.lower():
                print(f"build: {name}: {line.strip()}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        print(f"build: {name}: {log.count('Compiling entry')} kernels, "
              f"{sum(spills)} spill bytes in all")

    k1 = kernel_phase(card)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    attn = attn_kernel_phase(card, flush)
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s")
    launches = serve_phase(card, str(_build.BUILD_DIR.parent))
    t0 = time.perf_counter()
    k2_launches, k3_launches = attention_path_phase(card, flush)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, train = train_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resnet = resnet_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gluon = gluon_phase(card, resnet["bf16"]["images_s"])
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm = lm_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lmt = lm_train_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")

    print(f"card: {card}")
    bf16, fp32, prof = resnet["bf16"], resnet["fp32"], resnet["profile"]
    print(f"resnet50 summary: bf16 batch {RESNET_BATCH} "
          f"{bf16['images_s']:.1f} images/s, step {bf16['step_ms']:.3f} ms, "
          f"mfu {bf16['mfu']:.4f}, peak {bf16['peak_gib']:.2f} GiB; fp32 "
          f"batch {RESNET_FP32[0]} {fp32['images_s']:.1f} images/s, mfu "
          f"{fp32['mfu']:.4f}; profiled bf16 step busy {prof['busy']:.3f}, "
          f"host {prof['host_ms']:.1f} ms; parity {resnet['parity_s']:.1f} s "
          f"[{card}]")
    for key, what in (("bench", "Estimator.fit resnet50_v1"),
                      ("baseline3", "hybridized resnet50_v2 plain loop"),
                      ("eager_v2", "un-hybridized resnet50_v2 plain loop")):
        g = gluon[key]
        print(f"gluon summary: {what} bf16 batch {RESNET_BATCH} "
              f"{g['images_s']:.1f} images/s, step {g['step_ms']:.3f} ms, "
              f"mfu {g['mfu']:.4f}, peak {g['peak_gib']:.2f} GiB "
              f"({g['steady_gib']:.2f} timed), "
              f"gluon_vs_module {g['gluon_vs_module']:.3f}; profiled step "
              f"{g['profile']['kernels']} kernels, busy "
              f"{g['profile']['busy']:.3f}, host "
              f"{g['profile']['host_ms']:.1f} ms [{card}]")
    g = gluon["bench_eager"]
    print(f"gluon summary: Estimator.fit resnet50_v1 eager loop bf16 batch "
          f"{RESNET_BATCH} {g['images_s']:.1f} images/s, step "
          f"{g['step_ms']:.3f} ms, peak {g['peak_gib']:.2f} GiB "
          f"({g['steady_gib']:.2f} timed) [{card}]")
    print(f"gluon summary: parity {gluon['parity_s']:.1f} s [{card}]")
    par = lm["parity"]
    for dt in ("fp32", "bf16"):
        g, prof = lm[dt], lm["profile" if dt == "fp32" else "profile_bf16"]
        print(f"lm summary: {dt} GPT-2-small widths, {LM_SLOTS} slots: "
              f"continuous {g['tokens_s']:.1f} tokens/s, static "
              f"{g['static_tokens_s']:.1f} (ratio {g['ratio']:.3f}), "
              f"{g['ticks']} ticks, tick median {g['tick_ms']:.3f} ms p99 "
              f"{g['tick_p99_ms']:.3f} ms, step {g['step_ms']:.3f} ms, "
              f"prefill " + "/".join(f"{ms:.2f}" for ms in
                                     g["prefill_ms"].values())
              + f" ms (buckets {'/'.join(map(str, LM_BUCKETS))}), peak "
              f"{g['peak_gib']:.2f} GiB; profiled tick {prof['kernels']} "
              f"kernels, device {prof['device_ms']:.3f} ms, busy "
              f"{prof['busy']:.3f}, host {prof['host_ms']:.2f} ms, step "
              f"bytes bound {prof['bound_ms']:.3f} ms [{card}]")
    print(f"lm summary: parity worst {par['worst']:.3f} of the tolerance, "
          f"{par['ties']} near ties, bf16 relative L2 {par['bf16_l2']:.5f} "
          f"[{card}]")
    lane, ck, prof = lmt["lane"], lmt["ckpt"], lmt["profile"]
    parts = lmt["parts"]
    print(f"lm train summary: fp32 GPT-2-small widths, batch "
          f"{LM_TRAIN_LANE[0]} x T {LM_TRAIN_LANE[1]}: "
          f"{lane['tokens_s']:.1f} tokens/s, step {lane['step_ms']:.3f} ms, "
          f"mfu {lane['mfu']:.4f}, peak {lane['peak_gib']:.2f} GiB; "
          f"checkpointed every {LM_CKPT_PERIOD}: {ck['tokens_s']:.1f} "
          f"tokens/s ({ck['slowdown']:.3f}x step), snapshot sync "
          f"{ck['sync_ms']:.2f} ms, write {ck['write_s']:.2f} s for "
          f"{ck['write_bytes'] / 1e9:.3f} GB; profiled step busy "
          f"{prof['busy']:.3f}, host {prof['host_ms']:.1f} ms; attention "
          f"{parts['attention_all']:.2f} ms, head+SoftmaxOutput "
          f"{parts['head']:.2f} ms (one-hot {parts['one_hot']:.2f} ms); "
          f"resume bitwise over {lmt['resume']['arrays']} arrays [{card}]")
    for key, dt in ((REP, F32), (REP_BF16, BF16)):
        m, k, n, _ = key
        k1[dt]["shape"] = f"{str(dt)[6:]} M={m} K={k} N={n}"
    rep = k1[F32]
    for (m, k, n), label in zip(MLP_K1, ("fc1", "fc2")):
        k1[(m, k, n, F32)]["shape"] = f"float32 M={m} K={k} N={n} (mlp " \
            f"{label})"
    src = "incubator_mxnet_tpu_torch/csrc/flash_attn.cu"
    tpu = "incubator_mxnet_tpu/ops/flash_attention.py"
    print(json.dumps({"kernels": [{
        "name": "fc_relu", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/csrc/fc_relu.cu",
        "replaces": "incubator_mxnet_tpu/subgraph/fused_ops.py:29",
        "launches": launches + train_launches,
        "paths": {"serving": launches, "training": train_launches},
        "max_abs_err": rep["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"], "shape": rep["shape"],
        "kernel_route": rep["route"], **dtype_keys("bf16", k1[BF16]),
        **dtype_keys("train_fc1", k1[MLP_K1[0] + (F32,)]),
        **dtype_keys("train_fc2", k1[MLP_K1[1] + (F32,)]),
        "train_k1_share": train["mlp"]["k1_share"]},
        dict(name="flash_fwd", route="cuda", source=src,
             replaces=f"{tpu}:229", launches=k2_launches, **attn[REP_K2],
             **dtype_keys("fp32", attn[REP_K2_F32])),
        dict(name="flash_fwd_stream", route="cuda", source=src,
             replaces=f"{tpu}:180", launches=k3_launches,
             **attn[REP_K3], **dtype_keys("fp32", attn[REP_K3_F32]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

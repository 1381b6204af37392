#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths with seeded random weights:

- paged-KV greedy serving of the full-width ``transformer`` (vocab 32000,
  12 layers, d_model 768, 12 heads, d_ff 3072, bf16 compute, page_len 16)
  through ``ContinuousBatcher`` and the HTTP ``ServeFrontend``, once with
  bf16 KV pages and once with int8 pages;
- training through ``AutoDist.build`` / ``step.run``: ``bert_base`` (vocab
  30522, 12 layers, d_model 768, MLM) at seq 512 with flash attention,
  batch 32, AllReduce, default SGD; the causal ``transformer`` at seq 512
  with flash attention; ``resnet`` at its defaults (ResNet-50, 224 px,
  1000 classes, bf16 compute) at batch 128; and the rest of the zoo at the
  published widths of the JAX package's ``examples/benchmark/train.py``
  (``ZOO``, from the port's ``models.PUBLISHED``): VGG-16 and DenseNet-121
  at 224 px and Inception-v3 at 299 px, batch 128; the LM1B LSTM (vocab
  8192, embed 512, hidden 1024, 2 layers, seq 32) at batch 128; NCF (6040
  users, 3706 items, mf 64, MLP 256-256-128-64) at batch 4096; the MoE
  transformer (4 layers, d_model 512, 8 experts) at batch 32.

Phases, each printing one JSON line:

1. ``device``: CUDA must be present; prints the ``nvidia-smi`` name and
   power limit.
2. ``build``: builds ``autodist_tpu_torch/csrc/paged_attention.cu``,
   ``csrc/flash_attention.cu`` and ``csrc/fused_conv_stats.cu`` with nvcc
   from this checkout, all three at once; prints each kernel's registers
   and spill bytes (``-Xptxas -v``) and the count of tensor-core
   instructions in the SASS (``cuobjdump``, "not found" without it): HMMA
   in the three flash kernels, HGMMA in the six instances of the bf16
   conv-stats kernel; fails on a spill or a kernel without them, and on a
   conv-stats shared-memory plan that differs from the wrapper's mirror.
3. ``kernel_parity``: the paged CUDA kernel against its plain version at
   the main path's shapes (decode B=32 Q=1, prefill B=1 Q=16, verify B=32
   Q=5; H=12, D=64, page_len 16, 32-page shuffled tables, positions that
   reach the last slot), with fp32, bf16 and int8 pages, at the split count
   of its own plan (reported) and at ``PAGED_SPLITS``, a repeated launch
   bitwise equal at each; timed beside the plain version, SDPA over the
   gathered timeline, and the bound.
4. ``serve``: 64 mixed-length requests (max_new 32) per KV mode; every one
   completes, no page leaks, and the kernel's launch count equals
   ``num_layers x (prefill chunks + decode steps)``; then 4 ``POST
   /generate`` and one ``GET /metrics`` over HTTP.
5. ``stream_check``: teacher-forced bf16 logits through the kernel path vs
   the plain path within a stated bound, and identical greedy streams of
   an fp32 2-layer full-width model.
6. ``flash_parity``: the flash forward, dK/dV and dQ kernels against their
   plain versions on the same inputs (B=32, H=12, D=64; bf16 at S=512
   causal and not, S=128 and S=256 causal; fp32 at S=512, the FMA
   kernels), each output within the stated tolerances; the bf16 O, dK, dV
   and dQ also element by element within ``flash_bounds`` (err/bound and
   the relative L2 distance reported); timed beside the plain versions, SDPA
   pinned to one backend (forward; backward for the two backward kernels)
   and the bound.
7. ``conv_stats_parity``: the fused 1x1-conv + BatchNorm-statistics kernel
   against its plain version at the 15 distinct shapes of ResNet-50's 36
   bottleneck 1x1 convs at batch 128 in bf16, and at the first in fp32, then
   at every distinct shape of an Inception-v3 (299 px, 40 fused convs) and
   a DenseNet-121 (224 px, 58) forward at batch 128 in bf16, found by a
   forward on meta tensors; a repeated launch bitwise equal; timed beside
   the plain version, ``torch.matmul`` + moments, ``torch.matmul`` alone and
   the bound; then ``conv_stats_forward`` for each model: Σ launches x ms
   over a forward beside Σ launches x bound.
8. ``train``: bert_base (10 steps) and the causal transformer (4 steps)
   through ``AutoDist(strategy_builder=AllReduce()).build`` and
   ``step.run``, each flash kernel launched exactly ``num_layers x steps``
   times; and ResNet-50 (10 steps), the fused kernel launched exactly
   ``36 x steps`` times and no flash kernel; every loss finite, the last
   below the first.
9. ``train_check``: one step's loss and gradients through the flash
   kernels against the plain (``dot``) path, and both against the same
   model in fp32, at full width within stated bf16 bounds; and
   PSLoadBalancing's first-step loss equal to AllReduce's.
10. ``resnet_check``: ResNet-50 at full width, batch 8, one step's loss and
    gradients: the bf16 kernel path against the model in fp32 on the card
    within stated bf16 bounds (whole model and block by block), and the
    fp32 card run against the fp32 plain path on the CPU within
    summation-order bounds; one forward of every depth (18–152) at 224 px
    launches the kernel once per 1x1 conv; PSLoadBalancing's first-step
    loss equal to AllReduce's.
11. ``zoo_train``: each ``ZOO`` configuration through
    ``AutoDist(strategy_builder=AllReduce()).build`` (default SGD), one
    warm-up step and a window of ``ZOO_STEPS``: host wall a step, the rate
    (images, tokens or examples a second), MFU where the spec has
    ``flops_per_example``, the losses (finite, the last below the first),
    peak memory; Inception and DenseNet launch the fused kernel 40 and 58
    times a step (its forward, as the meta-tensor spy of phase 7 counted;
    its backward is two products), the others never.
12. ``zoo_check``: the zoo models with no kernel of the port (VGG-16,
    LM1B, NCF, MoE) at their published widths in fp32, batch 8: the first
    step's loss and whole gradient through the built step on the card
    against the CPU's plain path from the same weights (1e-5, and 1e-4
    relative, VGG-16's 1e-2: ``ZOO_CHECK``).
13. ``optim_check``: the ``mlp`` in fp32, 3 steps on the card with each of
    adagrad, rmsprop, lamb, lion, adafactor, nesterov momentum and the
    cosine, exponential, warmup_cosine, piecewise and linear schedules,
    against the same update rules on the CPU (1e-5 relative).
14. ``remat_check``: bert_base (seq 512, batch 32, flash) built with no
    remat, ``remat=True`` and ``remat="dots_saveable"`` (the whole loss
    checkpointed) and with ``TransformerConfig.remat`` (each block): one
    step's loss and gradients against the run without remat (1e-6 relative;
    whether bitwise equal is reported), the flash forward launched twice a
    layer under remat and dK/dV and dQ once, and each run's host wall and
    peak memory.
15. ``accum_check``: the fp32 causal transformer (full width, seq 512,
    flash), first step at batch 8 with ``grad_accum_steps=4`` against 1:
    loss and whole gradient within 1e-5 relative.
16. ``dist_train``: the multi-device step on ``torch.distributed``. One
    NCCL rank per visible card (a power of two, at most 8) is started as a
    process of this script (``--dist-rank``) and trains bert_base (seq 512,
    global batch 32, flash) and ResNet-50 (224 px, global batch 128) through
    ``AutoDist(init_method=..., world_size=..., rank=...).build`` for 1 + 5
    Adam steps under AllReduce (``bucket_bytes`` 25 MiB), Zero1 and
    PartitionedPS, and rank 0 also through the one-process step (no group)
    from the same params. At world size 1 the two compute the same thing:
    every loss and every final parameter must be bitwise equal (both run
    with deterministic algorithms). At a larger world size the losses are
    held to ``DIST_LOSS_RTOL``. Each step's gradient and parameter
    collectives equal the plan's prediction; the flash kernels launch
    ``num_layers x 5`` times each in bert_base's window and the fused
    conv-stats kernel ``36 x 5`` in ResNet-50's. Printed: ms a step of
    both, the collectives of a step by purpose and kind. Then a rehearsal,
    not a card result: 4 gloo ranks on the CPU (``--dist-cpu-rank``) train
    a small dense model 3 Adam steps under AllReduce with buckets, Zero1,
    PartitionedPS and PS, against the one-process step within rtol 2e-5 /
    atol 2e-6, and one SGD step of a 128x64 model under Horovod-EF and TopK
    against the mean of the ranks' compressed gradients gathered by hand
    (EF within ``REHEARSAL_BF16_STEPS`` bf16 steps, its residuals and TopK
    bitwise).
17. ``sync_options``: the rest of the synchronizer on one NCCL rank on
    cuda:0, started as a process of this script (``--sync-rank``), with
    deterministic algorithms; 1 warm-up step and a counted window each,
    Adam at 1e-4. bert_base (seq 512, batch 32, flash) under plain
    AllReduce and ``AllReduce(compressor=X)`` for Horovod, Horovod-EF,
    PowerSGD and TopK: one more step's synced gradient (the step's own,
    recorded at its sync) against the plain compressor function on the
    card applied to that step's local gradient and state, bitwise for
    Horovod, EF and TopK (and their new residuals), PowerSGD within
    ``POWERSGD_TOL`` of the largest entry (fp64 Gram-Schmidt against
    cuSOLVER); bert_base under ``PS(staleness=2)``: the first 2 steps leave
    the loss where it was, and the parameters equal, bitwise, the plain
    Adam update driven by the synced gradients of 2 steps before; ResNet-50
    (224 px, batch 128) under ``PS()`` built with ``host_offload=True``
    against the resident step: losses and parameters bitwise equal, the
    offloaded parameters and slots pinned between steps, peak and held
    memory of both; bert_base under ``PS(sync=False, staleness=1)`` with 2
    workers on cuda:0, ``round_robin`` (bitwise equal to the same schedule
    by hand with the port's step and optimizer) and ``threads`` (every push
    applied, lags within the bound). Every run: finite losses that fall, the
    flash kernels ``num_layers x`` gradients and the conv-stats kernel ``36
    x`` steps launched in the window, each step's wire equal to the plan's.

Kernels and library calls are timed as CUDA graphs of repeated calls (card
time without the host's, ``device_ms``), plain versions as eager calls.
Then the kernel table line, the card line and, last, the result line.
Exits non-zero (printing no result) without CUDA, outside a checkout of the
repo, or when any phase fails.
"""
from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer, build_mesh
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.models import PUBLISHED, get_model, get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import lstm_lm
from autodist_tpu_torch.models import resnet as rn
from autodist_tpu_torch.models import vgg
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import (flatten_params, map_params,
                                                unflatten_params)
from autodist_tpu_torch.ops import _build
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.ops import paged_attention as pa
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.runtime.async_ps import AsyncPSTrainer
from autodist_tpu_torch.strategy import AllReduce, PSLoadBalancing, StrategyCompiler, from_name
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.engine import InferenceEngine
from autodist_tpu_torch.serve.server import ServeFrontend, mock_load_prompt

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and per-type rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

H, D, PAGE_LEN, P = 12, 64, 16, 32
# bf16 kernel vs a plain version computed in fp32 on the same bf16 values:
# the kernel rounds its fp32 result to bf16 once (relative 2^-9), so 1e-2
# bounds it with room; fp32 inputs differ only in summation order.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Split counts of the paged kernel's walk that kernel_parity checks and
# times beside the main path's own (pa.split_plan).
PAGED_SPLITS = (1, 2, 4, 8)
# Teacher-forced max |Δlogit| of the kernel path vs the plain (bf16 gather)
# path at full width: the two round attention to bf16 at different points
# (the kernel once, at its output; the gather path also in its einsums). At
# the random-weight model's |logits| < 4 one bf16 step is at most 2^-6; the
# bound is 8 such steps.
STREAM_LOGIT_BOUND = 0.125
SEED = 0
N_REQUESTS, MAX_NEW = 64, 32
# Flash kernels vs their plain versions on the same bf16 inputs: both work
# in fp32 and round each output to bf16 once (2^-8 relative), so 2e-2
# absolute and relative bounds them with room; the fp32 lse differs only in
# summation order (1e-3).
FLASH_TOL, LSE_TOL = 2e-2, 1e-3
# fp32 inputs take the FMA kernels, which differ from the plain versions in
# summation order only.
FLASH_F32_TOL = 1e-4
FLASH_B, FLASH_H, FLASH_D = 32, 12, 64
# The bf16 forward, dK/dV and dQ kernels multiply on the tensor cores; each
# of their outputs is also held, element by element, to a bound on what the
# two arithmetics may differ by (flash_bounds). E is fp32's unit roundoff; a sum
# of n terms in another order moves by at most n E of the terms' magnitudes
# on the plain side and n 2E on the kernel's (the tensor cores align and
# truncate inside an mma, up to one fp32 ulp an addition): 3 n E together.
FLASH_E = 2.0 ** -24
FLASH_BF16_STEP = 2.0 ** -7     # one bf16 step is at most 2^-7 of the value
FLASH_SPLIT = 2.0 ** -16        # hi/lo split of P and dS: 2^-8 of 2^-8
# The bf16 dK, dV and dQ carry the reference's fp32 arithmetic to about
# 2^-16 before their rounding, so they differ from the plain versions only
# where the two fp32 values round to neighbouring bf16 values: about 1e-4
# relative L2 in all (1.0e-4 to 1.1e-4 measured on the H100, PERF.md).
FLASH_GRAD_REL_L2 = 2e-4
FLASH_MMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_dkdv_bf16_kernel",
                     "flash_dq_bf16_kernel")
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 32, 10
LM_BATCH, LM_STEPS = 8, 4
# Flash (kernel) path vs the plain dot path at full width, bf16 compute,
# both also held against the same model in fp32 (dot). Bounds:
# - loss within 1e-2 relative of the dot path's (bf16 rounds at 2^-8);
# - the whole gradient (all tensors as one vector) within 3e-2 relative L2
#   of the fp32 gradient for each path, and of each other: hundreds of
#   independent bf16 roundings average out to about 1% (1.0-1.1% for
#   `tools/torch_flash_accuracy.py --small` on the CPU);
# - each gradient tensor whose norm is at least 1e-3 of the whole within
#   0.15 relative L2 of the dot path's. The flash backward takes delta =
#   rowsum(dO * O) from the bf16-rounded O, as the JAX kernel does, so dS
#   misses summing to zero over the keys by a rounding-sized term; at
#   initialisation the query/key projections' true gradients are small and
#   that term is a sizeable part of them (5.7% vs fp32 for the same tool
#   on the CPU, 1.8% with O kept in fp32). Smaller tensors are covered by
#   the whole-gradient bound.
CHECK_LOSS_RTOL, CHECK_GLOBAL_RTOL, CHECK_GRAD_RTOL = 1e-2, 3e-2, 0.15
CHECK_NORM_FLOOR = 1e-3
CHECK_BATCH = 8
# conv_stats_parity: the 15 distinct shapes of ResNet-50's 36 bottleneck 1x1
# convs at batch 128, 224 px, [M = B*H*W, K, N], with each one's launches in
# a forward (models/resnet.py; stages 0-3). The first is the main shape.
CONV_SHAPES = (((401408, 64, 256), 4), ((401408, 64, 64), 1), ((401408, 256, 64), 2),
               ((401408, 256, 128), 1), ((100352, 128, 512), 4), ((100352, 256, 512), 1),
               ((100352, 512, 128), 3), ((100352, 512, 256), 1), ((25088, 256, 1024), 6),
               ((25088, 512, 1024), 1), ((25088, 1024, 256), 5), ((25088, 1024, 512), 1),
               ((6272, 512, 2048), 3), ((6272, 1024, 2048), 1), ((6272, 2048, 512), 2))
# Kernel vs plain version on the same inputs. Each side sums in fp32 in its
# own order, and a sum of n terms in any order is within n * 2^-24 of the
# terms' magnitudes (the worst case); so
# - y: |dy| <= 2K * 2^-24 * (|x| @ |w|), plus in bf16 one step of the
#   output (2^-7 of |y|) for the rounding of the two sums;
# - s1, s2: |ds| <= 1e-4 * (sum |y32|, sum y32^2): no term goes through more
#   than fcs.chain_length additions (45 at most at these shapes in bf16, 369
#   in fp32; each case checks it against 1e-4 / 2^-24 = 1,677).
CONV_Y_STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 0.0}
CONV_STAT_TOL = 1e-4
RESNET_BATCH, RESNET_STEPS = 128, 10
# resnet_check, ResNet-50 at full width, batch 8.
# - fp32 on the card (kernel, cuDNN without TF32) against fp32 on the CPU
#   (plain version): they differ in summation order only. At
#   initialisation the model amplifies such differences with depth, so the
#   whole gradient is held to 3x the CPU's own change when the batch is
#   reversed (the same sums in another order), measured in the phase; the
#   loss (1e-5) and the head's gradient (1e-4), which see the forward and
#   no backward through BatchNorm, are held directly.
# - bf16 against fp32 on the card: the same amplification carries bf16's
#   rounding (2^-8) to O(1) differences in the deep gradients, as it does
#   in the JAX model (tests/test_torch_resnet.py), so the whole model's
#   gradient difference is reported, not bounded. The loss, a batch average
#   of log-sum-exps, moves far less and is held to 5e-2. Block by block, at
#   each stage's first bottleneck (with its stride and its projection),
#   against a random upstream gradient: the output within
#   2e-2 (a few bf16 roundings of 2^-8), the whole block gradient within
#   0.15 and each tensor of at least 1e-3 of its norm within 0.2 (ReLU masks
#   flip where bf16 rounds a value across 0, and sums of signed gradients
#   cancel, as in train_check's bound).
RESNET_FP32_LOSS_RTOL, RESNET_FP32_HEAD_RTOL, RESNET_SPREAD_FACTOR = 1e-5, 1e-4, 3.0
RESNET_BF16_LOSS_RTOL = 5e-2
RESNET_BLOCK_Y_RTOL, RESNET_BLOCK_GRAD_RTOL, RESNET_BLOCK_TENSOR_RTOL = 2e-2, 0.15, 0.2
# zoo_train: the published widths of examples/benchmark/train.py, nothing
# cut (ResNet-50 has its own phase): (key, zoo name, overrides, batch, what
# a step's rate counts).
ZOO = tuple((key, *cfg) for key, cfg in PUBLISHED.items() if key != "resnet50")
ZOO_STEPS = 5
# The two zoo models whose 1x1 convs feed a BatchNorm: their fused conv-stats
# launches a forward, and the shapes conv_stats_parity adds for them.
CONV_ZOO = {"inceptionv3": 40, "densenet121": 58}
# zoo_check: the zoo models with no kernel of the port, at fp32 compute and
# batch CHECK_BATCH: card vs CPU from the same weights. The loss within
# 1e-5 and the whole gradient within 1e-4 relative (summation order), but
# VGG-16's within 1e-2: its convolutions take other algorithms on the two
# devices (cuDNN's, oneDNN's), and a ReLU input or a max-pool pair that lies
# within that difference of a tie sends its gradient another way through 13
# convs and 5 pools of 224 px maps (1.5e-3 measured on an H100). Either
# bound still fails a gradient off by a factor or a table update lost.
ZOO_CHECK_LOSS_RTOL = 1e-5
# model -> its gradient bound.
ZOO_CHECK = {"vgg16": 1e-2, "lm1b": 1e-4, "ncf": 1e-4, "moe": 1e-4}
# optim_check: the mlp in fp32 on the card against the same update rules on
# the CPU, 3 steps; card and CPU differ in summation order only.
OPTIM_RTOL, OPTIM_STEPS, OPTIM_BATCH = 1e-5, 3, 64
OPTIM_CASES = (
    ("momentum", {"learning_rate": 0.05, "nesterov": True}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "weight_decay": 0.01}),
    ("lion", {"learning_rate": 0.001}),
    ("adafactor", {"learning_rate": 0.01}),
    ("sgd", {"learning_rate": {"schedule": "cosine", "init_value": 0.1, "decay_steps": 2}}),
    ("sgd", {"learning_rate": {"schedule": "exponential", "init_value": 0.1,
                               "transition_steps": 2, "decay_rate": 0.5, "staircase": True}}),
    ("sgd", {"learning_rate": {"schedule": "warmup_cosine", "peak_value": 0.1,
                               "warmup_steps": 1, "decay_steps": 3}}),
    ("sgd", {"learning_rate": {"schedule": "piecewise", "init_value": 0.1,
                               "boundaries_and_scales": {"1": 0.5, "2": 0.1}}}),
    ("sgd", {"learning_rate": {"schedule": "linear", "init_value": 0.1, "end_value": 0.01,
                               "transition_steps": 2}}),
)
# remat_check and accum_check: one step's loss and gradients against the
# run without the option. remat recomputes the same ops on the same inputs
# (bitwise equal where the kernels and cuBLAS are deterministic, reported);
# accumulation adds the same terms in another order: 1e-5 relative (the
# whole gradient as one vector).
REMAT_RTOL, ACCUM_RTOL, ACCUM_BATCH, ACCUM_K = 1e-6, 1e-5, 8, 4
# dist_train: 1 + DIST_STEPS Adam steps a (model, strategy), the last
# DIST_STEPS timed; the ranks' and the rehearsal's time limits.
DIST_STEPS, DIST_OPT = 5, ("adam", {"learning_rate": 1e-4})
DIST_BUILDERS = (("AllReduce", {"bucket_bytes": 25 << 20}), ("Zero1", {}),
                 ("PartitionedPS", {}))
DIST_TIMEOUT_S, DIST_GROUP_TIMEOUT_S = 420.0, 120.0
# At a world size above 1 the ranks' mean of local mean losses against the
# one-process step's: bf16 rounds the two orders of summation apart (2^-8),
# and ResNet's BatchNorm under AllReduce with buckets and Zero1 (JAX's
# manual sync) normalises over each rank's images, not the global batch's.
DIST_LOSS_RTOL = {"bert_base": 1e-2, "resnet50": 5e-2}
# The rehearsal: the e2e dense model of tests/test_e2e_numeric.py.
REHEARSAL_RANKS, REHEARSAL_STEPS = 4, 3
REHEARSAL_BUILDERS = (("AllReduce", {"bucket_bytes": 64}), ("Zero1", {}),
                      ("PartitionedPS", {}), ("PS", {}))
REHEARSAL_RTOL, REHEARSAL_ATOL = 2e-5, 2e-6
# The rehearsal's compressed step: a 128x64 kernel (8192 elements, over
# TopK's min_size of 4096) and its bias, SGD at REHEARSAL_LR, one step.
# Gloo sums the four bf16 payloads of EF in bf16, rounding its partial
# sums; each rounding moves a sum by at most one bf16 step (2^-8) of the
# magnitudes summed, so the synced gradient lies within
# REHEARSAL_BF16_STEPS such steps of the exact mean of the payloads
# (tests/test_torch_dist_sync_options.py measures 2.90 with XLA's one
# rounding on the other side). TopK's gathered pairs are scatter-added in
# rank order: bitwise equal to the hand-made sum.
REHEARSAL_COMPRESSORS = ("HorovodCompressorEF", "TopKCompressor")
REHEARSAL_LR, REHEARSAL_BF16_STEPS = 0.05, 3
# sync_options: one NCCL rank on cuda:0 (the checks hold one rank's wire
# to the plain compressor function); bert_base at TRAIN_SEQ, TRAIN_BATCH,
# flash, and ResNet-50 at RESNET_BATCH, each 1 warm-up step and a counted
# window of SYNC_STEPS (the staleness run 1 + SYNC_STALE_STEPS, so that
# its delayed gradients land), Adam at DIST_OPT.
SYNC_STEPS, SYNC_STALENESS, SYNC_STALE_STEPS = 2, 2, 4
SYNC_COMPRESSORS = ("HorovodCompressor", "HorovodCompressorEF", "PowerSGDCompressor",
                    "TopKCompressor")
# PowerSGD on the card (fp32 matmuls, cuSOLVER's Householder QR) against
# the plain function in fp64 with Gram-Schmidt: the synced gradient and the
# residual within POWERSGD_TOL of each tensor's largest entry, the new q
# within it column by column up to sign (QR fixes the columns' signs, which
# the product P Qn^T does not see). fp32 sums over up to 3072 terms carry
# about 1e-6 of the largest term; the orthonormalisation multiplies that
# by the conditioning of the two columns of P.
POWERSGD_TOL = 1e-3
TOPK_RATIO, TOPK_MIN_SIZE = 0.01, 4096
ASYNC_WORKERS, ASYNC_PUSHES, ASYNC_STALENESS = 2, 4, 1
# Host offload: the peak falls by this share of the optimizer slots' bytes,
# and the memory held between steps by this share of all offloaded bytes.
OFFLOAD_SAVING = (0.9, 1.1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_core_report(ptxas: dict) -> dict:
    """Registers, spill bytes and HMMA count of each tensor-core flash kernel;
    fails on a spill or, where cuobjdump is found, on a kernel without HMMA."""
    hmma = _build.sass_counts("flash_attention", "HMMA")
    report = {}
    for kernel in FLASH_MMA_KERNELS:
        info = next((v for name, v in ptxas.items() if kernel in name), None)
        check(info is not None, f"{kernel}: not in the ptxas report")
        count = (next((n for name, n in hmma.items() if kernel in name), 0)
                 if hmma is not None else "not found (no cuobjdump)")
        check(info.get("spill_stores", 0) == 0 and info.get("spill_loads", 0) == 0,
              f"{kernel}: register spills {info}")
        check(hmma is None or count > 0, f"{kernel}: no HMMA instruction in its SASS")
        report[kernel] = {**info, "hmma": count}
    return report


def time_ms(fn, groups: int = 15, per_group: int = 20) -> float:
    """Median over ``groups`` CUDA-event timings of ``per_group`` eager
    calls: the plain versions, whose host time is small beside their work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_group)
    return statistics.median(samples)


def device_ms(fn, calls: int = 20, replays: int = 15, stream=None) -> float:
    """The card's time for one call of ``fn``, without the host's time to
    issue it: ``calls`` calls captured in one CUDA graph, the median over
    ``replays`` CUDA-event timings of a replay, divided by ``calls``. ``fn``
    is warmed up and captured on ``stream`` (a new side stream by default);
    an autograd backward must have run its forward on that stream, since
    autograd puts each backward op on its forward op's stream."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(samples)


# ------------------------------------------------------------ kernel parity
def parity_case(shape: str, page_kind: str, gen: torch.Generator, dev):
    b, n_q = {"decode": (32, 1), "prefill": (1, 16), "verify": (32, 5)}[shape]
    qdt = torch.float32 if page_kind == "float32" else torch.bfloat16
    n_pages = b * P + 1
    timeline = P * PAGE_LEN
    q4 = torch.randn((b, n_q, H, D), generator=gen, device=dev).to(qdt)
    k = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    v = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    ks = vs = None
    if page_kind == "int8":
        k, ks = pa.quantize_kv(k)
        v, vs = pa.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    # Shuffled distinct pages per row (page 0 stays scratch).
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * P] + 1)
    tables = tables.reshape(b, P).to(torch.int32).contiguous()
    if shape == "prefill":
        qpos = torch.arange(timeline - n_q, timeline, device=dev)[None]
    else:
        base = torch.randint(0, timeline, (b,), generator=gen, device=dev)
        base[0] = timeline - n_q
        qpos = torch.clamp(base[:, None] + torch.arange(n_q, device=dev)[None],
                           max=timeline - 1)
    qpos = qpos.to(torch.int32).contiguous()

    # Reference: the plain version in fp32 on the same (bf16 / int8) values.
    ref = pa.paged_attention_plain(
        q4.float(), k if ks is not None else k.float(),
        v if vs is not None else v.float(), tables, qpos, ks, vs)
    tol = TOL[qdt]
    # The main path's split count, and the others of PAGED_SPLITS: each within
    # the tolerance, timed; a repeated launch bitwise equal.
    n_split, per_split = pa.split_plan(n_q, b, H, P, PAGE_LEN, pa._sm_count(0))
    errs, same, split_ms = {}, {}, {}
    for n in sorted({n_split, *PAGED_SPLITS}):
        out = pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n)
        again = pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n)
        torch.cuda.synchronize()
        errs[n] = (out.float() - ref).abs().max().item()
        same[n] = torch.equal(out, again)
        check(torch.allclose(out.float(), ref, atol=tol, rtol=tol),
              f"kernel vs plain {shape}/{page_kind} at {n} splits: max |err| "
              f"{errs[n]} > tol {tol}")
        check(same[n], f"{shape}/{page_kind} at {n} splits: a repeated launch differs")
        split_ms[n] = device_ms(lambda: pa._launch(q4, k, v, tables, qpos, ks, vs, n_split=n))
    err = max(errs.values())
    kernel_ms = split_ms[n_split]
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q4, k, v, tables, qpos, ks, vs),
                       groups=7, per_group=5)
    # Library yardstick: SDPA over the gathered (dequantised) timeline.
    kg = pa._gather_timeline(k, ks, tables, qdt).transpose(1, 2).contiguous()
    vg = pa._gather_timeline(v, vs, tables, qdt).transpose(1, 2).contiguous()
    mask = pa.position_mask(timeline, qpos)[:, None]          # [B, 1, Q, T]
    qh = q4.transpose(1, 2).contiguous()
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qh, kg, vg,
                                                                  attn_mask=mask))
    nbytes = pa.kernel_bytes(q4, k, tables, qpos, quantized=ks is not None)
    flops = pa.kernel_flops(q4, k, tables, qpos)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[qdt]
    row = dict(shape=shape, pages=page_kind, B=b, Q=n_q, H=H, D=D,
               page_len=PAGE_LEN, P=P, n_split=n_split, pages_per_split=per_split,
               max_abs_err=err, tol=tol, repeat_bitwise=all(same.values()),
               kernel_ms=kernel_ms, kernel_ms_by_split=split_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    emit("kernel_parity", **row)
    return row


# -------------------------------------------------------------------- serve
async def _http(port: int, method: str, path: str, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload.decode()


async def _frontend_round(batcher, prompts):
    fe = await ServeFrontend(batcher, host="127.0.0.1", port=0).start()
    try:
        gens = await asyncio.gather(*(
            _http(fe.port, "POST", "/generate",
                  {"tokens": [int(t) for t in p], "max_new_tokens": 8})
            for p in prompts))
        metrics = await _http(fe.port, "GET", "/metrics")
    finally:
        await fe.close()
    return gens, metrics


def serve_run(params, kv_quant: bool, dev):
    cfg = get_model("transformer", kv_quant=kv_quant)
    engine = InferenceEngine(params, tt.decode_model(cfg), n_slots=32,
                             page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    engine.generate([1, 2, 3], 2)                        # warm-up, not counted
    torch.cuda.synchronize()
    registry = M.MetricsRegistry()
    rng = np.random.default_rng(SEED)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size)
               for i in range(N_REQUESTS)]

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    engine.decode_invocations = engine.prefill_invocations = 0
    batcher = ContinuousBatcher(engine, max_queue=256, registry=registry)
    reqs = [batcher.submit(p, MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    batcher.start()
    for r in reqs:
        r.wait(timeout=600)
    wall = time.perf_counter() - t0
    batcher.stop()
    snap = registry.snapshot()
    states = [r.state for r in reqs]
    check(all(s is RequestState.DONE for s in states),
          f"kv_quant={kv_quant}: states {[s.value for s in states]}")
    check(all(len(r.tokens) == MAX_NEW for r in reqs), "short token streams")
    check(snap["serve_requests_rejected_total"] == 0, "requests rejected")
    gens, metrics = asyncio.run(_frontend_round(
        ContinuousBatcher(engine, registry=registry), prompts[:4]))
    launches = pa.paged_attention.launches
    programs = engine.prefill_invocations + engine.decode_invocations
    torch.cuda.synchronize()

    check(all(code == 200 for code, _ in gens) and metrics[0] == 200,
          f"HTTP codes {[c for c, _ in gens]} /metrics {metrics[0]}")
    check(all(len(json.loads(body)["tokens"]) == 8 for _, body in gens),
          "HTTP streams short")
    check(engine.pool.used_pages == 0
          and engine.pool.free_pages == engine.pool.usable_pages, "page leak")
    check(launches == cfg.num_layers * programs,
          f"launches {launches} != {cfg.num_layers} x {programs} programs")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    decode_tokens = gen_tokens - len(reqs)
    row = dict(kv_quant=kv_quant, requests=len(reqs), completed=len(reqs),
               n_pages=engine.pool.n_pages, wall_s=wall,
               tokens_per_s=gen_tokens / wall,
               decode_tokens=decode_tokens,
               decode_tokens_per_s_gauge=snap["serve_decode_tokens_per_sec"],
               ttft_p50_s=snap["serve_ttft_s"]["p50"],
               ttft_p99_s=snap["serve_ttft_s"]["p99"],
               itl_p50_s=snap["serve_itl_s"]["p50"],
               latency_p50_s=snap["serve_request_latency_s"]["p50"],
               prefill_chunks=engine.prefill_invocations,
               decode_steps=engine.decode_invocations,
               kernel_launches=launches,
               http_generate=[c for c, _ in gens], http_metrics=metrics[0],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    emit("serve", **row)
    return row


# ------------------------------------------------------------- stream check
def stream_check(params, dev):
    cfg = get_model("transformer")
    paths = {"kernel": replace(cfg, paged_attention_impl="kernel"),
             "gather": replace(cfg, paged_attention_impl="gather")}
    b, plen, steps = 8, 24, 16
    n_pages = 1 + b * 4
    tables = (torch.arange(1, n_pages, device=dev).reshape(b, 4)
              .to(torch.int32).contiguous())
    rng = np.random.default_rng(SEED + 1)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(b, plen))
                               ).to(dev, torch.int32)
    caches = {m: tt.init_paged_kv_cache(c, n_pages, PAGE_LEN, device=dev)
              for m, c in paths.items()}
    first = {}
    with torch.no_grad():
        for m, c in paths.items():
            toks = []
            for row in range(b):
                for start in range(0, plen, PAGE_LEN):
                    chunk = torch.zeros((1, PAGE_LEN), dtype=torch.int32, device=dev)
                    part = prompts[row, start:start + PAGE_LEN]
                    chunk[0, :part.numel()] = part
                    t, caches[m] = tt.forward_paged_prefill_chunk(
                        params, chunk, start, plen, caches[m], tables[row], c)
                toks.append(int(t[0]))
            first[m] = toks
        tok = torch.tensor(first["kernel"], dtype=torch.int32, device=dev)
        pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
        drift, agree = 0.0, 0
        for _ in range(steps):
            out = {m: tt.forward_paged_decode_step(params, tok, pos, caches[m],
                                                   tables, c, return_logits=True)
                   for m, c in paths.items()}
            drift = max(drift, (out["kernel"][1] - out["gather"][1]).abs().max().item())
            agree += int((out["kernel"][0] == out["gather"][0]).sum())
            tok, pos = out["kernel"][0], pos + 1         # teacher-forced
    check(drift <= STREAM_LOGIT_BOUND,
          f"bf16 kernel-vs-plain logit drift {drift} > {STREAM_LOGIT_BOUND}")

    # fp32, full width, 2 layers: kernel and plain greedy streams identical.
    f32 = get_model("transformer", num_layers=2, dtype="float32")
    p32 = tt.init_params(f32, seed=SEED + 2, device=dev)
    streams = {}
    for m in ("kernel", "gather"):
        eng = InferenceEngine(p32, tt.decode_model(replace(f32, paged_attention_impl=m)),
                              n_slots=4, page_len=PAGE_LEN, n_pages=64, device=dev)
        rng = np.random.default_rng(SEED + 3)
        streams[m] = [eng.generate(mock_load_prompt(rng, i, vocab=f32.vocab_size), 24)
                      for i in range(8)]
    same = streams["kernel"] == streams["gather"]
    check(same, "fp32 kernel and plain greedy streams differ")
    emit("stream_check", bf16_max_abs_logit_diff=drift, bound=STREAM_LOGIT_BOUND,
         bf16_token_agreement=agree / (b * steps), fp32_streams_identical=same,
         fp32_streams=len(streams["kernel"]))


# ------------------------------------------------------------- flash parity
def flash_bounds(q, k, v, g, lse, delta, causal: bool, plain: dict) -> dict:
    """Per-element bounds on |kernel - plain| for the bf16 kernels' O, dK, dV
    and dQ: one bf16 step of the larger value (each side rounds its fp32 result
    once) plus the arithmetic that differs, in magnitudes of the same
    products (P the softmax from the plain lse):
    - scores, sums of D products in other orders, and exp: each P off by
      ``ds = 3 D E scale (|q| |k|^T) + 4 E`` of itself (both sides);
    - O: p rounded to bf16 against the running max in the kernel and the row
      max in the plain version, 2^-8 each: ``((2^-7 + 3 S E) P + P ds) |V|``,
      plus ``(P ds)`` summed over keys times |O| for the normalisation;
    - dV: P split into hi + lo (2^-16): ``((2^-16 + 3 S E) P + P ds)^T |dO|``;
    - dK: dS = P (dP - delta) split likewise, P's error times |dP - delta|,
      dP's own sums of D products:
      ``w = (2^-16 + 3 S E + ds) |dS| + 3 D E P (|dO| |V|^T)``, then
      ``w^T |q scale|``;
    - dQ: the same dS error summed over keys instead: ``w |K scale|``."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    e = FLASH_E
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    ds = (3 * d * e * scale) * torch.einsum("bqhd,bkhd->bhqk", q32.abs(), k32.abs()) + 4 * e
    p = torch.exp(fa._scores(q32 * scale, k32, causal) - lse[..., None])
    pds = p * ds
    del ds
    o_mag = (torch.einsum("bhqk,bkhd->bqhd", (FLASH_BF16_STEP + 3 * s * e) * p + pds,
                          v32.abs())
             + pds.sum(-1).permute(0, 2, 1)[..., None] * plain["o"].float().abs())
    dv_mag = torch.einsum("bhqk,bqhd->bkhd", (FLASH_SPLIT + 3 * s * e) * p + pds, g32.abs())
    dsd = (torch.einsum("bqhd,bkhd->bhqk", g32, v32) - delta[..., None]).abs()
    w = (FLASH_SPLIT + 3 * s * e) * p * dsd + pds * dsd
    del dsd, pds
    w += (3 * d * e) * p * torch.einsum("bqhd,bkhd->bhqk", g32.abs(), v32.abs())
    dk_mag = torch.einsum("bhqk,bqhd->bkhd", w, (q32 * scale).abs())
    dq_mag = torch.einsum("bhqk,bkhd->bqhd", w, (k32 * scale).abs())
    return {"o": o_mag, "dk": dk_mag, "dv": dv_mag, "dq": dq_mag}


def flash_case(seq: int, causal: bool, dtype, gen: torch.Generator, dev):
    """The three flash kernels against their plain versions at one shape."""
    shape = (FLASH_B, seq, FLASH_H, FLASH_D)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (want_out.float() * g.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_dkdv(q, k, v, g, want_lse, delta, causal)
    dq = fa.flash_dq(q, k, v, g, want_lse, delta, causal)
    torch.cuda.synchronize()
    pk, pv = fa.flash_dkdv_plain(q, k, v, g, want_lse, delta, causal)
    pq = fa.flash_dq_plain(q, k, v, g, want_lse, delta, causal)
    bf16 = dtype == torch.bfloat16
    tol = FLASH_TOL if bf16 else FLASH_F32_TOL
    case = f"flash S={seq} causal={causal} {str(dtype).replace('torch.', '')}"
    errs, rel_l2 = {}, {}
    for name, got, want, t in (("o", out, want_out, tol), ("lse", lse, want_lse, min(tol, LSE_TOL)),
                               ("dk", dk, pk, tol), ("dv", dv, pv, tol),
                               ("dq", dq, pq, tol)):
        diff = got.float() - want.float()
        errs[name] = diff.abs().max().item()
        rel_l2[name] = (diff.norm() / want.float().norm()).item()
        check(torch.allclose(got.float(), want.float(), atol=t, rtol=t),
              f"{case}: {name} max |err| {errs[name]} > tol {t}")
    # err/bound of the worst element, 1 = at the bound (bf16: tensor cores).
    over = {}
    if bf16:
        bounds = flash_bounds(q, k, v, g, want_lse, delta, causal, {"o": want_out})
        for name, got, want in (("o", out, want_out), ("dk", dk, pk), ("dv", dv, pv),
                                ("dq", dq, pq)):
            bound = (FLASH_BF16_STEP * torch.maximum(got.float().abs(), want.float().abs())
                     + bounds[name])
            over[name] = ((got.float() - want.float()).abs() / bound.clamp_min(1e-30)
                          ).max().item()
        del bounds, bound
        for name, ratio in over.items():
            check(ratio <= 1.0, f"{case}: {name} beyond its bound (worst err/bound {ratio})")
        for name in ("dk", "dv", "dq"):
            check(rel_l2[name] <= FLASH_GRAD_REL_L2,
                  f"{case}: {name} rel L2 {rel_l2[name]} > {FLASH_GRAD_REL_L2}")

    # SDPA pinned to one backend, so that its times do not move between runs:
    # flash attention for bf16, memory-efficient for fp32 (flash takes none).
    # Kernels and SDPA are timed as CUDA graphs (device_ms): card time only.
    backend = SDPBackend.FLASH_ATTENTION if bf16 else SDPBackend.EFFICIENT_ATTENTION
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(backend):
        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                    is_causal=causal))
        # SDPA's backward computes dQ, dK and dV in one call: both backward
        # kernels stand beside it. Its forward runs on the capture stream.
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            leaves = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            gh = g.transpose(1, 2)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, leaves, gh,
                                                         retain_graph=True),
                             stream=stream)
        del sdpa_out, leaves
    times = {
        "fwd": (device_ms(lambda: fa.flash_fwd(q, k, v, causal)),
                time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal), groups=5,
                        per_group=3), sdpa_fwd),
        "dkdv": (device_ms(lambda: fa.flash_dkdv(q, k, v, g, want_lse, delta, causal)),
                 time_ms(lambda: fa.flash_dkdv_plain(q, k, v, g, want_lse, delta,
                                                     causal), groups=5, per_group=3),
                 sdpa_bwd),
        "dq": (device_ms(lambda: fa.flash_dq(q, k, v, g, want_lse, delta, causal)),
               time_ms(lambda: fa.flash_dq_plain(q, k, v, g, want_lse, delta, causal),
                       groups=5, per_group=3), sdpa_bwd),
    }
    outputs = {"fwd": ("o", "lse"), "dkdv": ("dk", "dv"), "dq": ("dq",)}
    rows = []
    for kind, (kernel_ms, plain_ms, library_ms) in times.items():
        nbytes = fa.kernel_bytes(q, kind)
        flops = fa.kernel_flops(q, kind, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_OPS_PER_S[dtype]
        names = outputs[kind]
        row = dict(kernel=kind, B=FLASH_B, S=seq, H=FLASH_H, D=FLASH_D,
                   causal=causal, dtype=str(dtype).replace("torch.", ""),
                   design="tensor cores" if bf16 else "fp32 FMA",
                   max_abs_err=max(errs[n] for n in names), tol=tol,
                   err_over_bound={n: over[n] for n in names if n in over} or None,
                   rel_l2={n: rel_l2[n] for n in names},
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library=f"sdpa {'forward' if kind == 'fwd' else 'backward'} "
                           f"({backend.name})",
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        emit("flash_parity", **row)
        rows.append(row)
    return rows


# ------------------------------------------------------- conv stats parity
def _matmul_moments(x, w):
    """The library rendering: ``torch.matmul``, then two fp32 column sums."""
    y = x @ w
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def conv_stats_case(m: int, k: int, n: int, dtype, gen: torch.Generator, dev,
                    launches: int = 0, model: str = "resnet50"):
    """The fused conv-stats kernel against its plain version at one shape:
    post-ReLU activations (``|N(0, 1)|``, what the models' 1x1 convs read)
    and He-scaled weights. ``launches``: the shape's launches in a forward
    of ``model``, carried into the row."""
    chain = fcs.chain_length(m, n, dtype)
    x = torch.randn((m, k), generator=gen, device=dev).abs_().to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) * (2.0 / k) ** 0.5).to(dtype)
    y, s1, s2 = fcs.fused_matmul_stats(x, w)
    again = fcs.fused_matmul_stats(x, w)
    torch.cuda.synchronize()
    repeat_bitwise = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    del again
    py, p1, p2 = fcs.fused_matmul_stats_plain(x, w)
    y_err = (y.float() - py.float()).abs()
    y_bound = (CONV_Y_STEP[dtype] * torch.maximum(y.float().abs(), py.float().abs())
               + 2 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs()))
    y_ok = bool((y_err <= y_bound).all())
    y_ratio = (y_err / y_bound.clamp_min(1e-30)).max().item()
    max_abs_err = y_err.max().item()
    del y_err, y_bound, py
    y32_abs_sum = (x.float() @ w.float()).abs_().sum(0)
    s1_rel = ((s1 - p1).abs() / y32_abs_sum).max().item()
    s2_rel = ((s2 - p2).abs() / p2).max().item()
    del y32_abs_sum

    kernel_ms = device_ms(lambda: fcs.fused_matmul_stats(x, w))
    plain_ms = time_ms(lambda: fcs.fused_matmul_stats_plain(x, w), groups=7, per_group=5)
    library_ms = device_ms(lambda: _matmul_moments(x, w))
    matmul_ms = device_ms(lambda: x @ w)
    nbytes, flops = fcs.kernel_bytes(x, w), fcs.kernel_flops(x, w)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    row = dict(model=model, M=m, K=k, N=n, dtype=str(dtype).replace("torch.", ""),
               launches_per_forward=launches, max_abs_err=max_abs_err,
               y_err_over_bound=y_ratio, s1_rel=s1_rel, s2_rel=s2_rel,
               stat_tol=CONV_STAT_TOL, chain_length=chain, repeat_bitwise=repeat_bitwise,
               tiles_per_block=fcs.tiles_per_block(m, n, dtype),
               groups=fcs.groups(m, n, dtype), kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, matmul_ms=matmul_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    if dtype == torch.bfloat16:
        row["plan"] = fcs.smem_plan(k, n)
    emit("conv_stats_parity", **row)
    shape = f"conv stats {m}x{k}x{n} {row['dtype']}"
    check(chain * 2.0 ** -24 <= CONV_STAT_TOL,
          f"{shape}: addition chain {chain} too long for {CONV_STAT_TOL}")
    check(y_ok, f"{shape}: y beyond its bound (worst err/bound {y_ratio})")
    check(s1_rel <= CONV_STAT_TOL and s2_rel <= CONV_STAT_TOL,
          f"{shape}: sums rel {s1_rel}, {s2_rel} > {CONV_STAT_TOL}")
    check(repeat_bitwise, f"{shape}: a repeated launch differs")
    return row


def conv_forward_totals(rows) -> dict:
    """Σ launches x ms over the bf16 rows of one model: a forward's fused
    conv-stats work, beside its bound and the library calls."""
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    total = {key: sum(r["launches_per_forward"] * r[key] for r in bf16)
             for key in ("kernel_ms", "bound_ms", "matmul_ms", "library_ms")}
    return dict(launches=sum(r["launches_per_forward"] for r in bf16), **total)


def conv_tensor_core_report(ptxas: dict, extra_kn=()) -> dict:
    """Registers, spill bytes and HGMMA count of each instance of the bf16
    conv-stats kernel; fails on a spill or, where cuobjdump is found, on an
    instance without HGMMA. Also holds the wrapper's shared-memory plan
    (fcs.smem_plan) to the library's own at every CONV_SHAPES shape and at
    each ``(K, N)`` of ``extra_kn``."""
    hgmma = _build.sass_counts("fused_conv_stats", "HGMMA")
    report = {}
    for name, info in ptxas.items():
        if "conv_stats_wgmma_kernel" not in name:
            continue
        count = (next((c for sass_name, c in hgmma.items() if sass_name == name), 0)
                 if hgmma is not None else "not found (no cuobjdump)")
        check(info.get("spill_stores", 0) == 0 and info.get("spill_loads", 0) == 0,
              f"{name}: register spills {info}")
        check(hgmma is None or count > 0, f"{name}: no HGMMA instruction in its SASS")
        report[name] = {**info, "hgmma": count}
    check(len(report) == 6, f"conv stats: {len(report)} wgmma kernel instances, not 6")
    for k, n in sorted({(k, n) for (_, k, n), _ in CONV_SHAPES} | set(extra_kn)):
        check(fcs.built_plan(k, n) == fcs.smem_plan(k, n),
              f"conv stats plan at K={k} N={n}: {fcs.built_plan(k, n)} in the library, "
              f"{fcs.smem_plan(k, n)} in the wrapper")
    return report


# -------------------------------------------------------------------- train
def _launch_counts():
    return {"fwd": fa.flash_fwd.launches, "dkdv": fa.flash_dkdv.launches,
            "dq": fa.flash_dq.launches}


def reset_launches() -> None:
    """Every kernel's launch count to 0: just before each main-path window."""
    pa.paged_attention.launches = 0
    fa.reset_launches()
    fcs.fused_matmul_stats.launches = 0


def train_run(model: str, batch_size: int, steps: int, card: str, dev):
    """Build through AutoDist (AllReduce, default SGD), one warm-up step,
    then the counted ``step.run`` window."""
    spec = get_model_spec(model, max_seq_len=TRAIN_SEQ, attention_impl="flash")
    cfg = spec.config
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
    t0 = time.perf_counter()
    step = autodist.build(spec.loss_fn, params, batch)
    build_s = time.perf_counter() - t0
    state = step.init(params)
    state, _ = step.run(state, batch, 1)                # warm-up, not counted
    torch.cuda.synchronize()

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, metrics = step.run(state, batch, steps)
    losses = metrics["loss"].tolist()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    check(all(np.isfinite(losses)), f"{model}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{model}: loss did not fall {losses}")
    for kind, n in launches.items():
        check(n == cfg.num_layers * steps,
              f"{model}: flash {kind} launches {n} != {cfg.num_layers} x {steps}")
    check(fcs.fused_matmul_stats.launches == 0, f"{model}: fused conv kernel launched")
    tokens = batch_size * TRAIN_SEQ * steps
    row = dict(model=model, seq=TRAIN_SEQ, batch=batch_size, steps=steps,
               attention_impl="flash", strategy="AllReduce", optimizer="sgd 0.01",
               build_s=build_s, losses=losses, wall_s=wall,
               ms_per_step=wall / steps * 1e3, tokens_per_s=tokens / wall,
               mfu=spec.flops_per_example * batch_size * steps / wall
               / PEAK_OPS_PER_S[torch.bfloat16],
               kernel_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               card=card)
    emit("train", **row)
    return row


def _loss_and_grads(loss_fn, params, batch):
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in flatten_params(params).items()}
    loss = loss_fn(unflatten_params(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def _rel(a: dict, b: dict) -> float:
    """Relative L2 distance of two gradient dicts, as one vector each."""
    num = sum(((a[n].float() - g.float()) ** 2).sum() for n, g in b.items())
    den = sum((g.float() ** 2).sum() for g in b.values())
    return torch.sqrt(num / den).item()


def train_check(dev):
    """Kernel path vs plain path (and both vs fp32), one step at full width;
    PSLoadBalancing's first-step loss vs AllReduce's."""
    specs = {name: get_model_spec("bert_base", max_seq_len=TRAIN_SEQ,
                                  attention_impl=impl, **extra)
             for name, impl, extra in (("flash", "flash", {}), ("dot", "dot", {}),
                                       ("fp32", "dot", {"dtype": "float32"}))}
    flash = specs["flash"]
    params = flash.init(SEED + 4, device=dev)
    batch = flash.example_batch(CHECK_BATCH, device=dev)
    runs = {name: _loss_and_grads(spec.loss_fn, params, batch)
            for name, spec in specs.items()}
    (loss_f, grads_f), (loss_d, grads_d), (loss_32, grads_32) = (
        runs["flash"], runs["dot"], runs["fp32"])
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    check(loss_rel <= CHECK_LOSS_RTOL,
          f"flash vs dot loss {loss_f} vs {loss_d}: rel {loss_rel} > {CHECK_LOSS_RTOL}")
    whole = {"flash_vs_fp32": _rel(grads_f, grads_32), "dot_vs_fp32": _rel(grads_d, grads_32),
             "flash_vs_dot": _rel(grads_f, grads_d)}
    for name, rel in whole.items():
        check(rel <= CHECK_GLOBAL_RTOL, f"whole gradient {name} rel {rel} > "
              f"{CHECK_GLOBAL_RTOL}")
    global_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads_d.values()))
    worst, worst_name, compared = 0.0, "", 0
    for name, gd in grads_d.items():
        norm = gd.float().norm()
        if norm < CHECK_NORM_FLOOR * global_norm:
            continue
        rel = ((grads_f[name].float() - gd.float()).norm() / norm).item()
        check(rel <= CHECK_GRAD_RTOL, f"grad {name}: flash vs dot rel {rel} > "
              f"{CHECK_GRAD_RTOL}")
        compared += 1
        if rel > worst:
            worst, worst_name = rel, name

    first = {}
    for name, builder in (("AllReduce", AllReduce()), ("PSLoadBalancing", PSLoadBalancing())):
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=builder, device=dev)
        step = autodist.build(flash.loss_fn, params, batch)
        _, m = step.run(step.init(params), batch, 1)
        first[name] = m["loss"][0].item()
    ps_rel = abs(first["PSLoadBalancing"] - first["AllReduce"]) / abs(first["AllReduce"])
    check(ps_rel <= 1e-5, f"PSLoadBalancing first loss {first} differ")
    emit("train_check", model="bert_base", seq=TRAIN_SEQ, batch=CHECK_BATCH,
         loss_flash=loss_f, loss_dot=loss_d, loss_fp32=loss_32, loss_rel=loss_rel,
         loss_rtol=CHECK_LOSS_RTOL, whole_gradient_rel=whole,
         whole_rtol=CHECK_GLOBAL_RTOL, worst_tensor_rel=worst,
         worst_tensor=worst_name, tensor_rtol=CHECK_GRAD_RTOL, tensors_compared=compared,
         tensors_total=len(grads_d), first_step_loss=first, ps_vs_allreduce_rel=ps_rel)

def train_resnet(card: str, dev):
    """ResNet-50 at its defaults (224 px, 1000 classes, bf16) through
    AutoDist (AllReduce, default SGD): one warm-up step, then the counted
    ``step.run`` window."""
    spec = get_model_spec("resnet")
    params = spec.init(SEED, device=dev)
    batch = spec.example_batch(RESNET_BATCH, device=dev)
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
    t0 = time.perf_counter()
    step = autodist.build(spec.loss_fn, params, batch)
    build_s = time.perf_counter() - t0
    state = step.init(params)
    state, _ = step.run(state, batch, 1)                # warm-up, not counted
    torch.cuda.synchronize()

    # The main path's window: counts to 0 just before, read just after.
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, metrics = step.run(state, batch, RESNET_STEPS)
    losses = metrics["loss"].tolist()
    wall = time.perf_counter() - t0
    launches = fcs.fused_matmul_stats.launches
    flash = _launch_counts()
    per_step = rn.fused_launches_per_forward(50)
    row = dict(model=spec.name, image_size=224, batch=RESNET_BATCH, steps=RESNET_STEPS,
               strategy="AllReduce", optimizer="sgd 0.01", build_s=build_s,
               losses=losses, wall_s=wall, ms_per_step=wall / RESNET_STEPS * 1e3,
               images_per_s=RESNET_BATCH * RESNET_STEPS / wall,
               mfu=spec.flops_per_example * RESNET_BATCH * RESNET_STEPS / wall
               / PEAK_OPS_PER_S[torch.bfloat16],
               kernel_launches={"fused_conv_stats": launches, **flash},
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card)
    emit("train", **row)
    check(all(np.isfinite(losses)), f"resnet50: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"resnet50: loss did not fall {losses}")
    check(launches == per_step * RESNET_STEPS,
          f"resnet50: fused conv launches {launches} != {per_step} x {RESNET_STEPS}")
    check(not any(flash.values()), f"resnet50: flash kernels launched {flash}")
    return row


def _bottleneck_grads(p, x, gy, stride, dtype):
    """One bottleneck block's output and the gradients of ``sum(y * gy)``
    with respect to its input and params."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in flatten_params(p).items()}
    xin = x.to(dtype).requires_grad_(True)
    y = rn._bottleneck(unflatten_params(leaves), xin, stride, dtype)
    grads = torch.autograd.grad((y.float() * gy).sum(), [xin, *leaves.values()])
    return y.float(), dict(zip(["input", *leaves], grads))


def resnet_check(dev):
    """ResNet-50 at full width, batch 8: the fp32 kernel path on the card
    against the fp32 plain path on the CPU; the bf16 kernel path against
    fp32 on the card, whole model and block by block; the kernel's launches
    in one forward of every depth at 224 px; PSLoadBalancing's first-step
    loss vs AllReduce's."""
    spec = get_model_spec("resnet")
    params = spec.init(SEED + 5, device=dev)
    batch = spec.example_batch(CHECK_BATCH, device=dev)

    def loss32(p, b):
        return L.softmax_xent(rn.forward(p, b["images"], 50, dtype=torch.float32),
                              b["labels"])

    loss_16, grads_16 = _loss_and_grads(spec.loss_fn, params, batch)
    loss_32, grads_32 = _loss_and_grads(loss32, params, batch)
    cpu = torch.device("cpu")
    cpu_params = map_params(lambda t: t.to(cpu), params)
    cpu_batch = {k: v.to(cpu) for k, v in batch.items()}
    loss_cpu, grads_cpu = _loss_and_grads(loss32, cpu_params, cpu_batch)
    _, grads_flip = _loss_and_grads(loss32, cpu_params,
                                    {k: v.flip(0) for k, v in cpu_batch.items()})
    grads_cpu = {n: g.to(dev) for n, g in grads_cpu.items()}
    spread = _rel({n: g.to(dev) for n, g in grads_flip.items()}, grads_cpu)
    head = [n for n in grads_cpu if n.startswith("head/")]
    fp32 = {"loss_card": loss_32, "loss_cpu": loss_cpu,
            "loss_rel": abs(loss_32 - loss_cpu) / abs(loss_cpu),
            "head_rel": _rel({n: grads_32[n] for n in head},
                             {n: grads_cpu[n] for n in head}),
            "whole_rel": _rel(grads_32, grads_cpu), "cpu_spread_batch_reversed": spread}
    bf16 = {"loss_bf16": loss_16, "loss_rel": abs(loss_16 - loss_32) / abs(loss_32),
            "whole_gradient_rel_reported": _rel(grads_16, grads_32)}
    del grads_16, grads_32, grads_cpu, grads_flip

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    blocks = {}
    for si, (hw, cin) in enumerate(((56, 64), (56, 256), (28, 512), (14, 1024))):
        name, stride = f"stage{si}_block0", 1 if si == 0 else 2
        x = torch.randn((CHECK_BATCH, hw, hw, cin), generator=gen, device=dev).relu_()
        cout = params[name]["conv3"]["kernel"].shape[-1]
        hw_out = -(-hw // stride)
        gy = torch.randn((CHECK_BATCH, hw_out, hw_out, cout), generator=gen, device=dev)
        y16, g16 = _bottleneck_grads(params[name], x, gy, stride, torch.bfloat16)
        y32, g32 = _bottleneck_grads(params[name], x, gy, stride, torch.float32)
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in g32.values()))
        per = {n: ((g16[n].float() - g.float()).norm() / g.float().norm()).item()
               for n, g in g32.items() if g.float().norm() >= CHECK_NORM_FLOOR * norm}
        worst = max(per, key=per.get)
        blocks[name] = {"y_rel": ((y16 - y32).norm() / y32.norm()).item(),
                        "whole_rel": _rel(g16, g32), "worst_tensor": worst,
                        "worst_tensor_rel": per[worst]}

    # Every 1x1 conv of every depth at 224 px is a shape the kernel takes.
    by_depth, finite = {}, True
    for depth in (18, 34, 50, 101, 152):
        dparams = get_model_spec("resnet", depth=depth).init(SEED, device=dev)
        fcs.fused_matmul_stats.launches = 0
        with torch.no_grad():
            logits = rn.forward(dparams, batch["images"][:2], depth)
        by_depth[depth] = fcs.fused_matmul_stats.launches
        finite = finite and bool(torch.isfinite(logits).all())
        del dparams

    first = {}
    for name, builder in (("AllReduce", AllReduce()), ("PSLoadBalancing", PSLoadBalancing())):
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=builder, device=dev)
        step = autodist.build(spec.loss_fn, params, batch)
        _, m = step.run(step.init(params), batch, 1)
        first[name] = m["loss"][0].item()
    ps_rel = abs(first["PSLoadBalancing"] - first["AllReduce"]) / abs(first["AllReduce"])
    emit("resnet_check", model="resnet50", batch=CHECK_BATCH, fp32_card_vs_cpu=fp32,
         bf16_vs_fp32=bf16, bf16_vs_fp32_blocks=blocks, first_step_loss=first,
         ps_vs_allreduce_rel=ps_rel, fused_launches_per_forward_by_depth=by_depth)
    for depth, n in by_depth.items():
        check(n == rn.fused_launches_per_forward(depth),
              f"resnet{depth}: {n} fused launches a forward")
    check(finite, "a resnet depth gave non-finite logits")
    check(fp32["loss_rel"] <= RESNET_FP32_LOSS_RTOL,
          f"resnet fp32 card vs cpu loss rel {fp32['loss_rel']}")
    check(fp32["head_rel"] <= RESNET_FP32_HEAD_RTOL,
          f"resnet fp32 card vs cpu head gradient rel {fp32['head_rel']}")
    check(fp32["whole_rel"] <= RESNET_SPREAD_FACTOR * spread,
          f"resnet fp32 card vs cpu gradient rel {fp32['whole_rel']} > "
          f"{RESNET_SPREAD_FACTOR} x the cpu's own spread {spread}")
    check(bf16["loss_rel"] <= RESNET_BF16_LOSS_RTOL,
          f"resnet bf16 vs fp32 loss rel {bf16['loss_rel']}")
    for name, b in blocks.items():
        check(b["y_rel"] <= RESNET_BLOCK_Y_RTOL, f"{name} bf16 output rel {b['y_rel']}")
        check(b["whole_rel"] <= RESNET_BLOCK_GRAD_RTOL,
              f"{name} bf16 gradient rel {b['whole_rel']}")
        check(b["worst_tensor_rel"] <= RESNET_BLOCK_TENSOR_RTOL,
              f"{name} bf16 {b['worst_tensor']} rel {b['worst_tensor_rel']}")
    check(ps_rel <= 1e-5, f"resnet PSLoadBalancing first loss {first} differ")


# --------------------------------------------------------- zoo conv shapes
def fused_conv_shapes(model: str, overrides: dict, batch: int, dev) -> dict:
    """``{(M, K, N): launches}`` of the fused conv-stats op in one forward of
    ``model`` at ``batch``: a forward on meta tensors (no work, no memory)
    with a spy on the op."""
    spec = get_model_spec(model, **overrides)
    params = map_params(lambda t: t.to("meta"), spec.init(SEED, device=dev))
    size = overrides["image_size"]
    shapes: dict = {}
    plain = fcs.fused_matmul_stats

    def spy(x, w):
        key = (x.shape[0], x.shape[1], w.shape[1])
        shapes[key] = shapes.get(key, 0) + 1
        return plain(x, w)

    fcs.fused_matmul_stats = spy
    try:
        with torch.no_grad():
            spec.apply(params, torch.empty((batch, size, size, 3), device="meta"))
    finally:
        fcs.fused_matmul_stats = plain
    return shapes


def zoo_conv_shapes(dev) -> dict:
    """The distinct fused conv-stats shapes of an Inception-v3 (299 px) and a
    DenseNet-121 (224 px) forward at batch 128, each with its model and its
    launches a forward; their launch totals checked against CONV_ZOO."""
    out = {}
    for key, model, overrides, batch, _ in ZOO:
        if key not in CONV_ZOO:
            continue
        shapes = fused_conv_shapes(model, overrides, batch, dev)
        check(sum(shapes.values()) == CONV_ZOO[key],
              f"{key}: {sum(shapes.values())} fused convs a forward, not {CONV_ZOO[key]}")
        out[key] = shapes
    return out


# ----------------------------------------------------------------- zoo train
def zoo_train(card: str, dev, zoo_shapes: dict):
    """Each ZOO configuration through AutoDist (AllReduce, default SGD at
    0.01): one warm-up step, then the counted ``step.run`` window of
    ZOO_STEPS steps, with the fused launches of ``zoo_shapes``'s forward a
    step."""
    rows = []
    for key, model, overrides, batch_size, unit in ZOO:
        spec = get_model_spec(model, **overrides)
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        AutoDist.reset_default()
        autodist = AutoDist(strategy_builder=AllReduce(), device=dev)
        t0 = time.perf_counter()
        step = autodist.build(spec.loss_fn, params, batch, sparse_names=spec.sparse_names,
                              expert_names=spec.expert_names)
        build_s = time.perf_counter() - t0
        state = step.init(params)
        del params
        state, _ = step.run(state, batch, 1)            # warm-up, not counted
        torch.cuda.synchronize()

        # The main path's window: counts to 0 just before, read just after.
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, metrics = step.run(state, batch, ZOO_STEPS)
        losses = metrics["loss"].tolist()
        wall = time.perf_counter() - t0
        launches = fcs.fused_matmul_stats.launches
        flash = _launch_counts()
        items = batch_size
        if unit == "tokens":
            items *= batch["tokens"].shape[1] - 1           # the predicted positions
        mfu = (spec.flops_per_example * batch_size * ZOO_STEPS / wall
               / PEAK_OPS_PER_S[torch.bfloat16]) if spec.flops_per_example else None
        row = dict(model=key, zoo=model, overrides=overrides, batch=batch_size,
                   steps=ZOO_STEPS, strategy="AllReduce", optimizer="sgd 0.01",
                   build_s=build_s, losses=losses, wall_s=wall,
                   ms_per_step=wall / ZOO_STEPS * 1e3,
                   **{f"{unit}_per_s": items * ZOO_STEPS / wall}, mfu=mfu,
                   kernel_launches={"fused_conv_stats": launches, **flash},
                   fused_per_step=launches / ZOO_STEPS,
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card)
        emit("zoo_train", **row)
        check(all(np.isfinite(losses)), f"{key}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{key}: loss did not fall {losses}")
        want = sum(zoo_shapes.get(key, {}).values())
        check(launches == want * ZOO_STEPS,
              f"{key}: fused conv launches {launches} != {want} x {ZOO_STEPS}")
        check(not any(flash.values()), f"{key}: flash kernels launched {flash}")
        rows.append(row)
        del step, state, batch, metrics
        torch.cuda.empty_cache()
    return rows


def _fp32_spec(key: str):
    """The ModelSpec of PUBLISHED ``key`` with its loss at fp32 compute."""
    zoo, overrides, _, _ = PUBLISHED[key]
    if key == "moe":
        return get_model_spec(zoo, dtype="float32", **overrides)
    spec = get_model_spec(zoo, **overrides)
    if key == "vgg16":
        return replace(spec, loss_fn=lambda p, b: L.softmax_xent(
            vgg.forward(p, b["images"], 16, dtype=torch.float32), b["labels"]))
    if key == "lm1b":      # the lstm_lm defaults: 2 layers of 1024
        return replace(spec, loss_fn=lambda p, b: L.softmax_xent(
            lstm_lm.forward(p, b["tokens"][:, :-1], 2, 1024, dtype=torch.float32),
            b["tokens"][:, 1:]))
    return spec                                       # ncf computes in fp32


def zoo_check(dev):
    """Each ZOO_CHECK model in fp32 at batch CHECK_BATCH: the first step's
    loss and gradients of the built step (``step.loss_and_grads``) on the
    card against the CPU's from the same weights."""
    cpu = torch.device("cpu")
    rows = []
    for key in ZOO_CHECK:
        spec = _fp32_spec(key)
        params = spec.init(SEED, device=cpu)      # the CPU's draws, on both devices
        runs = {}
        for where in (dev, cpu):
            p = map_params(lambda t: t.to(where), params)
            batch = spec.example_batch(CHECK_BATCH, device=where)
            AutoDist.reset_default()
            step = AutoDist(strategy_builder=AllReduce(), device=where).build(
                spec.loss_fn, p, batch, sparse_names=spec.sparse_names,
                expert_names=spec.expert_names)
            loss, _, grads = step.loss_and_grads(step.init(p), batch)
            names = [n for n, t in flatten_params(p).items() if t.is_floating_point()]
            runs[where.type] = (loss.item(), {n: g.to(cpu) for n, g in zip(names, grads)})
        (loss_card, grads_card), (loss_cpu, grads_cpu) = runs["cuda"], runs["cpu"]
        row = dict(model=key, batch=CHECK_BATCH, loss_card=loss_card, loss_cpu=loss_cpu,
                   loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu),
                   whole_gradient_rel=_rel(grads_card, grads_cpu),
                   gradient_norm=torch.sqrt(sum((g ** 2).sum()
                                                for g in grads_cpu.values())).item())
        rows.append(row)
        del runs, params
        torch.cuda.empty_cache()
    emit("zoo_check", loss_rtol=ZOO_CHECK_LOSS_RTOL, grad_rtol=ZOO_CHECK,
         rows=rows)
    for row in rows:
        check(row["loss_rel"] <= ZOO_CHECK_LOSS_RTOL
              and row["whole_gradient_rel"] <= ZOO_CHECK[row["model"]],
              f"zoo_check {row['model']}: card vs cpu {row}")


# -------------------------------------------------------- optimizers, remat
def _mlp_run(name, kwargs, device):
    # The same weights on both devices: drawn on the CPU (a CUDA generator
    # draws other numbers), then moved.
    spec = get_model_spec("mlp")
    params = map_params(lambda t: t.to(device), spec.init(SEED, device="cpu"))
    batch = spec.example_batch(OPTIM_BATCH, device=device)
    AutoDist.reset_default()
    step = AutoDist(strategy_builder=AllReduce(), device=device).build(
        spec.loss_fn, params, batch, optimizer=OptimizerSpec(name, kwargs))
    state, metrics = step.run(step.init(params), batch, OPTIM_STEPS)
    return metrics["loss"].cpu(), {n: t.detach().cpu() for n, t in
                                   flatten_params(state.params).items()}


def optim_check(dev):
    """Each new optimizer and schedule: OPTIM_STEPS fp32 steps of the mlp on
    the card against the same update rules on the CPU."""
    cpu = torch.device("cpu")
    rows = []
    for name, kwargs in OPTIM_CASES:
        card_loss, card = _mlp_run(name, kwargs, dev)
        cpu_loss, host = _mlp_run(name, kwargs, cpu)
        rel = max(((card[n] - t).norm() / t.norm()).item() for n, t in host.items())
        loss_rel = ((card_loss - cpu_loss).abs() / cpu_loss.abs()).max().item()
        label = kwargs["learning_rate"]["schedule"] if name == "sgd" else name
        rows.append(dict(case=label, worst_param_rel=rel, loss_rel=loss_rel,
                         losses=card_loss.tolist()))
        check(rel <= OPTIM_RTOL and loss_rel <= OPTIM_RTOL,
              f"optim {label}: card vs cpu params rel {rel}, losses rel {loss_rel}")
    emit("optim_check", model="mlp", steps=OPTIM_STEPS, batch=OPTIM_BATCH,
         rtol=OPTIM_RTOL, cases=rows)


def _max_diff(a: dict, b: dict) -> float:
    return max((a[n].float() - g.float()).abs().max().item() for n, g in b.items())


def remat_check(dev):
    """bert_base (seq 512, batch 32, flash) built with no remat,
    ``remat=True`` and ``remat="dots_saveable"`` (the whole loss
    checkpointed), and with ``TransformerConfig.remat`` (each block): one
    step's loss and gradients each (flash launches, host wall, peak memory)
    against the run without remat."""
    spec = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    blocks = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash",
                            remat=True)
    params = spec.init(SEED + 7, device=dev)
    batch = spec.example_batch(TRAIN_BATCH, device=dev)
    cfg = spec.config
    runs = {}
    for mode, loss_fn, remat in (("none", spec.loss_fn, False), ("True", spec.loss_fn, True),
                                 ("dots_saveable", spec.loss_fn, "dots_saveable"),
                                 ("blocks", blocks.loss_fn, False)):
        AutoDist.reset_default()
        step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
            loss_fn, params, batch, remat=remat)
        state = step.init(params)
        step.loss_and_grads(state, batch)               # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _, grads = step.loss_and_grads(state, batch)
        torch.cuda.synchronize()
        runs[mode] = dict(loss=loss.item(), launches=_launch_counts(),
                          ms=(time.perf_counter() - t0) * 1e3,
                          peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                          grads=dict(zip(flatten_params(state.params), grads)))
        del step, state, grads
    base = runs["none"]
    rows = {}
    for mode, run in runs.items():
        loss_rel = abs(run["loss"] - base["loss"]) / abs(base["loss"])
        diff = _max_diff(run["grads"], base["grads"])
        rel = _rel(run["grads"], base["grads"])
        bitwise = loss_rel == 0 and diff == 0
        rows[mode] = dict(loss=run["loss"], loss_rel=loss_rel, grad_max_abs_diff=diff,
                          grad_rel=rel, bitwise=bitwise, flash_launches=run["launches"],
                          loss_and_grads_ms=run["ms"], peak_mem_gb=run["peak_mem_gb"])
        fwd = cfg.num_layers * (1 if mode == "none" else 2)
        check(run["launches"] == {"fwd": fwd, "dkdv": cfg.num_layers, "dq": cfg.num_layers},
              f"remat={mode}: flash launches {run['launches']}")
        check(loss_rel <= REMAT_RTOL and rel <= REMAT_RTOL,
              f"remat={mode}: loss rel {loss_rel}, gradient rel {rel} vs no remat")
    emit("remat_check", model="bert_base", seq=TRAIN_SEQ, batch=TRAIN_BATCH,
         attention_impl="flash", rtol=REMAT_RTOL, runs=rows)


def accum_check(dev):
    """The fp32 causal transformer (full width, seq 512, flash), first step at
    batch ACCUM_BATCH: ``grad_accum_steps=ACCUM_K`` against 1."""
    spec = get_model_spec("transformer", max_seq_len=TRAIN_SEQ, attention_impl="flash",
                          dtype="float32")
    params = spec.init(SEED + 8, device=dev)
    batch = spec.example_batch(ACCUM_BATCH, device=dev)
    out = {}
    for k in (1, ACCUM_K):
        AutoDist.reset_default()
        step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
            spec.loss_fn, params, batch, grad_accum_steps=k)
        state = step.init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        loss, _, grads = step.loss_and_grads(state, batch)
        out[k] = (loss.item(), dict(zip(flatten_params(state.params), grads)),
                  torch.cuda.max_memory_allocated(dev) / 1e9)
        del step, state
    (l1, g1, m1), (lk, gk, mk) = out[1], out[ACCUM_K]
    loss_rel = abs(lk - l1) / abs(l1)
    rel = _rel(gk, g1)
    emit("accum_check", model="transformer", dtype="float32", seq=TRAIN_SEQ,
         batch=ACCUM_BATCH, k=ACCUM_K, loss_k1=l1, loss_k=lk, loss_rel=loss_rel,
         whole_gradient_rel=rel, rtol=ACCUM_RTOL, peak_mem_gb={"k1": m1, "k": mk})
    check(loss_rel <= ACCUM_RTOL and rel <= ACCUM_RTOL,
          f"grad_accum_steps={ACCUM_K}: loss rel {loss_rel}, gradient rel {rel}")


# --------------------------------------------------------------- dist_train
def _wire(counts) -> dict:
    """A step's gradient and parameter collectives, by kind."""
    out = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for purpose in ("grad", "param"):
        for kind, n in counts.get(purpose, {}).items():
            out[kind] += n
    return out


def _one_process_step(builder, loss_fn, params, batch, dev):
    """The same strategy lowered onto this process alone (no group)."""
    opt = OptimizerSpec(*DIST_OPT)
    item = ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                 example_batch=batch)
    spec = ResourceSpec.from_local_devices(dev)
    strategy = StrategyCompiler(item).compile(builder.build(item, spec))
    plan = GraphTransformer(strategy, item, build_mesh(spec, device=dev)).transform()
    return DistributedTrainStep(plan, loss_fn, opt.make())


def _train_window(step, params, batch, steps, dev):
    """One step, then ``steps`` counted and timed: ``(state, losses of all,
    ms a timed step, kernel launches of the timed steps, last step's
    collectives)``."""
    state = step.init(params)
    state, first = step(state, batch)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append(m["loss"])
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {"fused_conv_stats": fcs.fused_matmul_stats.launches, **_launch_counts()}
    losses = [float(first["loss"])] + [float(x) for x in metrics]
    return state, losses, ms, launches, step.last_collectives


def dist_rank(rank: int, world: int, work: str) -> int:
    """One NCCL rank of dist_train (see the module docstring)."""
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    models = (("bert_base", get_model_spec("bert_base", max_seq_len=TRAIN_SEQ,
                                           attention_impl="flash"), TRAIN_BATCH),
              ("resnet50", get_model_spec("resnet"), RESNET_BATCH))
    rows = []
    for key, spec, batch_size in models:
        params = spec.init(SEED, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        for name, kwargs in DIST_BUILDERS:
            plain = None
            if rank == 0:
                step = _one_process_step(from_name(name, **kwargs), spec.loss_fn, params,
                                         batch, dev)
                state, losses, ms, _, _ = _train_window(step, params, batch, DIST_STEPS, dev)
                plain = (flatten_params(step.logical_params(state)), losses, ms)
                del step, state
            AutoDist.reset_default()
            autodist = AutoDist(strategy_builder=from_name(name, **kwargs), device="cuda",
                                init_method=f"file://{work}/pg", world_size=world,
                                rank=rank, timeout_s=DIST_GROUP_TIMEOUT_S)
            step = autodist.build(spec.loss_fn, params, batch,
                                  optimizer=OptimizerSpec(*DIST_OPT))
            state, losses, ms, launches, wire = _train_window(step, params, batch,
                                                              DIST_STEPS, dev)
            logical = flatten_params(step.logical_params(state))
            predicted = autodist.plan.collectives_per_step()
            row = dict(model=key, strategy=name, strategy_kwargs=kwargs, world=world,
                       global_batch=batch_size, steps=1 + DIST_STEPS, optimizer=DIST_OPT,
                       losses=losses, ms_per_step=ms, collectives=wire,
                       predicted_wire=predicted, batchnorm_local=step.manual,
                       kernel_launches=launches)
            check(_wire(wire) == predicted,
                  f"{key}/{name}: wire {wire} != the plan's {predicted}")
            if rank == 0:
                plain_params, plain_losses, plain_ms = plain
                diff = max((logical[n].float() - t.float()).abs().max().item()
                           for n, t in plain_params.items())
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
                row.update(plain_losses=plain_losses, plain_ms_per_step=plain_ms,
                           max_param_diff=diff, max_loss_rel=rel,
                           bitwise=diff == 0.0 and losses == plain_losses)
                if world == 1:
                    check(row["bitwise"], f"{key}/{name}: world size 1 not bitwise equal "
                          f"to the one-process step (loss rel {rel}, param diff {diff})")
                else:
                    check(rel <= DIST_LOSS_RTOL[key], f"{key}/{name}: loss rel {rel} > "
                          f"{DIST_LOSS_RTOL[key]}")
                del plain, plain_params
            rows.append(row)
            del step, state, logical
            torch.cuda.empty_cache()
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def _rehearsal_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def _rehearsal_inputs():
    gen = torch.Generator().manual_seed(SEED)
    params = {"w": torch.randn(12, 5, generator=gen), "b": torch.randn(5, generator=gen)}
    return params, (torch.randn(16, 12, generator=gen), torch.randn(16, 5, generator=gen))


def _rehearsal_comp_inputs():
    gen = torch.Generator().manual_seed(SEED + 1)
    params = {"w": torch.randn(128, 64, generator=gen) * 0.1,
              "b": torch.randn(64, generator=gen)}
    return params, (torch.randn(16, 128, generator=gen), torch.randn(16, 64, generator=gen))


def _capture_sync(step) -> list:
    """Record each call of the step's gradient sync: ``(local gradients,
    compressor state before, synced gradients)``, cloned."""
    log, sync = [], step._sync

    def recorded(grads, done, comp_state):
        before = {n: {part: {k: t.clone() for k, t in st[part].items()} for part in st}
                  for n, st in comp_state.items()}
        local = {n: g.detach().clone() for n, g in grads.items()}
        out = sync(grads, done, comp_state)
        log.append((local, before, {n: g.clone() for n, g in out.items()}))
        return out

    step._sync = recorded
    return log


def dist_cpu_rank(rank: int, world: int, work: str) -> int:
    """One gloo rank of the CPU rehearsal."""
    torch.set_num_threads(1)
    params, batch = _rehearsal_inputs()
    out = {}

    def autodist_for(builder):
        AutoDist.reset_default()
        return AutoDist(strategy_builder=builder, device="cpu",
                        resource_spec=ResourceSpec(resource_dict={"nodes": [
                            {"address": "localhost", "gpus": world}]}),
                        init_method=f"file://{work}/pg", world_size=world, rank=rank,
                        timeout_s=DIST_GROUP_TIMEOUT_S)

    for name, kwargs in REHEARSAL_BUILDERS:
        autodist = autodist_for(from_name(name, **kwargs))
        step = autodist.build(_rehearsal_loss, params, batch,
                              optimizer=OptimizerSpec(*DIST_OPT))
        state = step.init(params)
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
        out[name] = {n: t.tolist() for n, t in flatten_params(
            step.logical_params(state)).items()}
        out[name + "/wire"] = [_wire(step.last_collectives),
                               autodist.plan.collectives_per_step()]
    cparams, cbatch = _rehearsal_comp_inputs()
    for name in REHEARSAL_COMPRESSORS:
        autodist = autodist_for(AllReduce(compressor=name))
        step = autodist.build(_rehearsal_loss, cparams, cbatch,
                              optimizer=OptimizerSpec("sgd", {"learning_rate": REHEARSAL_LR}))
        log = _capture_sync(step)
        state, _ = step(step.init(cparams), cbatch)
        local, _, synced = log[0]
        out[name] = {
            "local": {n: g.tolist() for n, g in local.items()},
            "synced": {n: g.tolist() for n, g in synced.items()},
            "residual": {n: st["local"]["residual"].tolist()
                         for n, st in state.comp_state.items() if st["local"]},
            "params": {n: t.tolist() for n, t in flatten_params(
                step.logical_params(state)).items()},
            "wire": [_wire(step.last_collectives), autodist.plan.collectives_per_step()]}
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def _spawn_ranks(flag: str, world: int, work: str, env: dict) -> list:
    """Start ``world`` ranks of this script, wait (``DIST_TIMEOUT_S`` in
    all), kill any left, and return rank by rank their results."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(world), work], env=env)
             for r in range(world)]
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    check(all(c == 0 for c in codes), f"{flag} ranks exited {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json"), encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def dist_train(card: str) -> list:
    """The dist_train phase: NCCL ranks over the cards, then the CPU
    rehearsal. Returns rank 0's rows."""
    world = 1
    while world * 2 <= min(torch.cuda.device_count(), 8):
        world *= 2
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--dist-rank", world, work, env)[0]
    seconds = time.perf_counter() - t0
    for row in rows:
        emit("dist_train", **row, ranks_seconds=seconds, card=card)
        model, steps = row["model"], DIST_STEPS
        launches = row["kernel_launches"]
        if model == "bert_base":
            layers = get_model_spec("bert_base").config.num_layers
            for kind in ("fwd", "dkdv", "dq"):
                check(launches[kind] == layers * steps,
                      f"dist {model}: flash {kind} launches {launches[kind]}")
        else:
            per = rn.fused_launches_per_forward(50) * steps
            check(launches["fused_conv_stats"] == per,
                  f"dist {model}: fused conv launches {launches['fused_conv_stats']} != {per}")
    dist_rehearsal()
    return rows


def dist_rehearsal() -> None:
    """4 gloo ranks on the CPU against the one-process step."""
    t0 = time.perf_counter()
    cpu_env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        ranks = _spawn_ranks("--dist-cpu-rank", REHEARSAL_RANKS, work, cpu_env)
    params, batch = _rehearsal_inputs()
    worst = {}
    for name, kwargs in REHEARSAL_BUILDERS:
        step = _one_process_step(from_name(name, **kwargs), _rehearsal_loss, params, batch,
                                 torch.device("cpu"))
        state = step.init(params)
        for _ in range(REHEARSAL_STEPS):
            state, _ = step(state, batch)
        want = flatten_params(step.logical_params(state))
        for r, got in enumerate(ranks):
            for n, t in want.items():
                check(torch.allclose(torch.tensor(got[name][n]), t, rtol=REHEARSAL_RTOL,
                                     atol=REHEARSAL_ATOL),
                      f"rehearsal {name} rank {r} {n} differs from one process")
            wire, predicted = got[name + "/wire"]
            check(wire == predicted, f"rehearsal {name}: wire {wire} != {predicted}")
        worst[name] = max((torch.tensor(ranks[0][name][n]) - t).abs().max().item()
                          for n, t in want.items())
    comp = {name: _rehearsal_compressed(name, ranks) for name in REHEARSAL_COMPRESSORS}
    emit("dist_train_cpu_rehearsal", note="gloo on the CPU: a rehearsal, not a card result",
         ranks=REHEARSAL_RANKS, steps=REHEARSAL_STEPS, max_abs_diff_vs_one_process=worst,
         rtol=REHEARSAL_RTOL, atol=REHEARSAL_ATOL, compressed_step=comp,
         seconds=time.perf_counter() - t0)


def _rehearsal_compressed(name: str, ranks: list) -> dict:
    """One compressed step of the 4 gloo ranks against the mean of their
    compressed gradients, gathered by hand from each rank's local gradient:
    EF within REHEARSAL_BF16_STEPS bf16 steps of the payloads' magnitudes
    (gloo rounds its bf16 partial sums), its residual ``inp - bf16(inp)``
    bitwise; TopK's scatter-add in rank order bitwise. Every rank's synced
    gradient the same, the update ``p - lr g`` bitwise, the wire the
    plan's."""
    cparams, _ = _rehearsal_comp_inputs()
    n = len(ranks)
    got = [{k: {v: torch.tensor(x) for v, x in r[name][k].items()}
            for k in ("local", "synced", "residual", "params")} for r in ranks]
    local = [g["local"] for g in got]
    worst = 0.0
    for var, synced in got[0]["synced"].items():
        for r in range(1, n):
            check(torch.equal(got[r]["synced"][var], synced),
                  f"rehearsal {name}: rank {r} synced {var} differs from rank 0's")
        flat = [local[r][var].reshape(-1) for r in range(n)]
        if name == "HorovodCompressorEF":
            payload = [f.to(torch.bfloat16).float() for f in flat]
            for r in range(n):
                check(torch.equal(got[r]["residual"][var].reshape(-1), flat[r] - payload[r]),
                      f"rehearsal EF: rank {r} residual of {var} is not inp - bf16(inp)")
            exact = sum(p.double() for p in payload) / n
            bound = REHEARSAL_BF16_STEPS * 2.0 ** -8 * sum(p.abs().double() for p in payload) / n
            err = (synced.reshape(-1).double() - exact).abs()
            check(bool((err <= bound).all()), f"rehearsal EF {var}: synced off the bf16 "
                  f"mean by {(err / bound).max().item()} of its bound")
            worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
        elif flat[0].numel() >= TOPK_MIN_SIZE:
            k = max(1, int(flat[0].numel() * TOPK_RATIO))
            dense = torch.zeros_like(flat[0])
            for r in range(n):
                idx = torch.argsort(flat[r].abs(), descending=True, stable=True)[:k]
                dense[idx] += flat[r][idx]
                residual = flat[r].clone()
                residual[idx] = 0.0
                check(torch.equal(got[r]["residual"][var].reshape(-1), residual),
                      f"rehearsal TopK: rank {r} residual of {var} differs")
            check(torch.equal(synced.reshape(-1), dense / n),
                  f"rehearsal TopK {var}: synced != the rank-order scatter-add")
        else:
            want = sum(flat) / n
            check(torch.allclose(synced.reshape(-1), want, rtol=1e-6, atol=1e-7),
                  f"rehearsal {name} {var}: dense mean differs")
        want_p = cparams[var] + (-REHEARSAL_LR * synced)
        check(torch.equal(got[0]["params"][var], want_p),
              f"rehearsal {name} {var}: params != p - lr g")
    for r in ranks:
        wire, predicted = r[name]["wire"]
        check(wire == predicted, f"rehearsal {name}: wire {wire} != {predicted}")
    return {"ef_worst_of_bound": worst} if name == "HorovodCompressorEF" else \
        {"topk_bitwise": True}


# ------------------------------------------------------------- sync_options
def _plain_compressed(name: str, g, local: dict, shared: dict):
    """The compressor's function at one rank, written plainly on the card:
    ``(synced gradient, residual or None, q or None)``."""
    if name == "HorovodCompressor":
        return g.to(torch.bfloat16).float(), None, None
    if name == "HorovodCompressorEF":
        inp = g + local["residual"]
        out = inp.to(torch.bfloat16).float()
        return out, inp - out, None
    if name == "TopKCompressor":
        if g.numel() < TOPK_MIN_SIZE:
            return g, None, None
        flat = (g + local["residual"]).reshape(-1)
        idx = torch.argsort(flat.abs(), descending=True, stable=True)[
            :max(1, int(flat.numel() * TOPK_RATIO))]
        out, residual = torch.zeros_like(flat), flat.clone()
        out[idx], residual[idx] = flat[idx], 0.0
        return out.view_as(g), residual.view_as(g), None
    if g.dim() < 2:                                     # PowerSGD's vectors
        return g, None, None
    inp = (g + local["residual"]).double()
    mat = inp.reshape(g.shape[0], -1)
    cols = []
    for col in (mat @ shared["q"].double()).T:          # Gram-Schmidt
        for c in cols:
            col = col - (c @ col) * c
        cols.append(col / col.norm())
    p = torch.stack(cols, 1)
    qn = mat.T @ p
    approx = (p @ qn.T).reshape(g.shape)
    return approx.float(), (inp - approx).float(), qn.float()


def _off_by(got, want, signed_columns: bool = False) -> float:
    """max |got - want| over the largest |want|; with ``signed_columns``
    each column compared up to its sign."""
    got, want = got.double(), want.double()
    if signed_columns:
        diff = torch.stack([torch.minimum((g - w).abs().max(), (g + w).abs().max())
                            for g, w in zip(got.T, want.T)])
    else:
        diff = (got - want).abs()
    return (diff.max() / want.abs().max().clamp_min(1e-30)).item()


def _compressor_check(name: str, step, state, log) -> dict:
    """The step's synced gradient, residual and q against the plain
    function on the card: bitwise, PowerSGD within POWERSGD_TOL."""
    local, before, synced = log[-1]
    comps = step.compressors
    worst, compressed = 0.0, 0
    for var, g in local.items():
        if var not in comps:
            check(torch.equal(synced[var], g), f"{name}: uncompressed {var} changed")
            continue
        st = before[var]
        want, residual, q = _plain_compressed(name, g, st["local"], st["shared"])
        new = state.comp_state[var]
        if name == "PowerSGDCompressor":
            errs = [_off_by(synced[var], want)]
            if residual is not None:
                errs += [_off_by(new["local"]["residual"], residual),
                         _off_by(new["shared"]["q"], q, signed_columns=True)]
            worst = max([worst] + errs)
            check(max(errs) <= POWERSGD_TOL, f"{name} {var}: off the plain function by "
                  f"{max(errs)} of its largest entry > {POWERSGD_TOL}")
        else:
            check(torch.equal(synced[var], want), f"{name} {var}: synced gradient is not "
                  f"the plain function's")
            if residual is not None:
                check(torch.equal(new["local"]["residual"], residual),
                      f"{name} {var}: residual is not inp - compressed")
        compressed += residual is not None
    return {"compressed_vars": len(comps), "with_state": compressed,
            "powersgd_worst_of_largest": worst if name == "PowerSGDCompressor" else None}


def _sync_window(step, params, batch, steps: int, dev):
    """One warm-up step, then a counted window of ``steps``: ``(state,
    losses of all, ms a window step, launches, the window's collectives a
    step, peak memory of the window in bytes)``."""
    state = step.init(params)
    state, first = step(state, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    losses, wire = [float(first["loss"])], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        wire.append(_wire(step.last_collectives))
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {"fused_conv_stats": fcs.fused_matmul_stats.launches, **_launch_counts()}
    return state, losses, ms, launches, wire, torch.cuda.max_memory_allocated(dev)


def _check_run(key: str, model: str, losses, launches, wire, predicted, steps: int,
               falls: bool = True) -> None:
    check(all(np.isfinite(losses)), f"{key}: non-finite loss {losses}")
    if falls:
        check(losses[-1] < losses[0], f"{key}: loss did not fall {losses}")
    for counts in wire:
        check(counts == predicted, f"{key}: wire {counts} != the plan's {predicted}")
    if model == "bert_base":
        layers = get_model_spec("bert_base").config.num_layers
        for kind in ("fwd", "dkdv", "dq"):
            check(launches[kind] == layers * steps,
                  f"{key}: flash {kind} launches {launches[kind]} != {layers} x {steps}")
    else:
        per = rn.fused_launches_per_forward(50) * steps
        check(launches["fused_conv_stats"] == per,
              f"{key}: fused conv launches {launches['fused_conv_stats']} != {per}")


def _build_step(builder, loss_fn, params, batch, world: int, rank: int, work: str,
                **kwargs):
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=builder, device="cuda",
                        init_method=f"file://{work}/pg", world_size=world, rank=rank,
                        timeout_s=DIST_GROUP_TIMEOUT_S)
    step = autodist.build(loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT),
                          **kwargs)
    return autodist, step


def _stale_replay(params, log, k: int, names) -> dict:
    """The plain PS update driven by the synced gradients of K steps before
    (zeros for the first K): the parameters after each step."""
    tx = OptimizerSpec(*DIST_OPT).make()
    flat = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    leaves = [flat[n] for n in names]
    slots = tx.init(leaves)
    with torch.no_grad():
        for t in range(len(log)):
            grads = ([log[t - k][2][n] for n in names] if t >= k
                     else [torch.zeros_like(x) for x in leaves])
            for p, u in zip(leaves, tx.update(grads, slots, leaves)):
                p.add_(u.to(p.dtype))
    return flat


def _async_by_hand(spec, params, batch, pushes: int, workers: int, dev):
    """The round-robin schedule by hand with the port's step: each round's
    workers take gradients (``DistributedTrainStep.loss_and_grads``) at
    one snapshot, then apply in worker order with the port's optimizer."""
    from autodist_tpu_torch.kernel.lowering import TrainState

    step = _one_process_step(from_name("PS"), spec.loss_fn, params, batch, dev)
    tx = OptimizerSpec(*DIST_OPT).make()
    names = [n for n, t in flatten_params(params).items() if t.is_floating_point()]
    flat = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    slots = tx.init([flat[n] for n in names])
    losses, tick = [], pushes
    while tick > 0:
        snap = {n: t.clone().requires_grad_(t.is_floating_point()) for n, t in flat.items()}
        rounds = []
        for _ in range(min(workers, tick)):
            tick -= 1
            loss, _, grads = step.loss_and_grads(
                TrainState(0, unflatten_params(snap), None), batch)
            rounds.append((float(loss.detach()), dict(zip(names, grads))))
        for loss, grads in rounds:
            losses.append(loss)
            with torch.no_grad():
                ups = tx.update([grads[n] for n in names], slots, [flat[n] for n in names])
                for n, u in zip(names, ups):
                    flat[n] = flat[n] + u.to(flat[n].dtype)
    return losses, flat


def sync_rank(rank: int, world: int, work: str) -> int:
    """The sync_options phase's NCCL rank (see the module docstring)."""
    dev = pg.local_device(torch.device("cuda"), rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    bert = get_model_spec("bert_base", max_seq_len=TRAIN_SEQ, attention_impl="flash")
    params = bert.init(SEED, device=dev)
    batch = bert.example_batch(TRAIN_BATCH, device=dev)
    rows = []
    base = dict(world=world, global_batch=TRAIN_BATCH, optimizer=DIST_OPT)

    # Plain AllReduce (no buckets): the steps the compressors are timed against.
    ad, step = _build_step(AllReduce(), bert.loss_fn, params, batch, world, rank, work)
    _, losses, plain_ms, launches, wire, _ = _sync_window(step, params, batch, SYNC_STEPS, dev)
    _check_run("AllReduce", "bert_base", losses, launches, wire,
               ad.plan.collectives_per_step(), SYNC_STEPS)
    rows.append(dict(base, model="bert_base", path="AllReduce", losses=losses,
                     ms_per_step=plain_ms, kernel_launches=launches, collectives=wire[-1]))
    del step
    for name in SYNC_COMPRESSORS:
        ad, step = _build_step(AllReduce(compressor=name), bert.loss_fn, params, batch, world,
                          rank, work)
        state, losses, ms, launches, wire, _ = _sync_window(step, params, batch,
                                                            SYNC_STEPS, dev)
        predicted = ad.plan.collectives_per_step()
        _check_run(name, "bert_base", losses, launches, wire, predicted, SYNC_STEPS)
        check(step.manual, f"{name}: the compressed step is not in the manual semantics")
        log = _capture_sync(step)
        state, _ = step(state, batch)                   # the checked step, not counted
        row = dict(base, model="bert_base", path=f"AllReduce({name})", losses=losses,
                   ms_per_step=ms, plain_ms_per_step=plain_ms, kernel_launches=launches,
                   collectives=wire[-1], predicted_wire=predicted,
                   check=_compressor_check(name, step, state, log))
        rows.append(row)
        del step, state, log
        torch.cuda.empty_cache()

    # Bounded staleness: PS(staleness=K) against the plain update driven by
    # the synced gradients of K steps before.
    ad, step = _build_step(from_name("PS", staleness=SYNC_STALENESS), bert.loss_fn, params, batch,
                      world, rank, work)
    log = _capture_sync(step)
    state, losses, ms, launches, wire, _ = _sync_window(step, params, batch,
                                                        SYNC_STALE_STEPS, dev)
    _check_run("PS(staleness)", "bert_base", losses, launches, wire,
               ad.plan.collectives_per_step(), SYNC_STALE_STEPS)
    check(losses[:SYNC_STALENESS + 1] == [losses[0]] * (SYNC_STALENESS + 1),
          f"PS(staleness): the first {SYNC_STALENESS} steps moved the params {losses}")
    names = [n for n, _ in step._floating(state.params)]
    replay = _stale_replay(params, log, SYNC_STALENESS, names)
    got = flatten_params(step.logical_params(state))
    stale_diff = max((got[n].float() - replay[n].float()).abs().max().item() for n in names)
    check(stale_diff == 0.0, f"PS(staleness): params differ from the delayed replay by "
          f"{stale_diff}")
    rows.append(dict(base, model="bert_base", path=f"PS(staleness={SYNC_STALENESS})",
                     losses=losses, ms_per_step=ms, kernel_launches=launches,
                     collectives=wire[-1], replay_max_diff=stale_diff,
                     buffer_bytes=sum(b.numel() * b.element_size()
                                      for b in state.stale_state.values())))
    del step, state, log, replay, got
    torch.cuda.empty_cache()

    # Host offload: ResNet-50 under PS, offloaded against resident.
    resnet = get_model_spec("resnet")
    rparams = resnet.init(SEED, device=dev)
    rbatch = resnet.example_batch(RESNET_BATCH, device=dev)
    runs = {}
    for offload in (False, True):
        ad, step = _build_step(from_name("PS"), resnet.loss_fn, rparams, rbatch, world, rank,
                          work, host_offload=offload)
        state, losses, ms, launches, wire, peak = _sync_window(step, rparams, rbatch,
                                                               SYNC_STEPS, dev)
        _check_run(f"PS(host_offload={offload})", "resnet50", losses, launches, wire,
                   ad.plan.collectives_per_step(), SYNC_STEPS)
        held = [t for n, t in flatten_params(state.params).items() if n in step.offloaded]
        slots = [t for key in ("mu", "nu") for i, t in enumerate(state.opt_state[key])
                 if held and i in step._offload_index(state.params)]
        check(not offload or (held and all(t.is_pinned() for t in held + slots)),
              "host offload: an offloaded leaf is not in pinned host memory between steps")
        runs[offload] = dict(losses=losses, ms=ms, peak=peak, launches=launches,
                             wire=wire[-1], between=torch.cuda.memory_allocated(dev),
                             offloaded_bytes=sum(t.numel() * t.element_size()
                                                 for t in held + slots),
                             slot_bytes=sum(t.numel() * t.element_size() for t in slots),
                             params={n: t.detach().cpu() for n, t in flatten_params(
                                 step.logical_params(state)).items()})
        del step, state, held, slots
        torch.cuda.empty_cache()
    diff = max((runs[True]["params"][n] - t).abs().max().item()
               for n, t in runs[False]["params"].items())
    check(diff == 0.0 and runs[True]["losses"] == runs[False]["losses"],
          f"host offload: differs from the resident step (param diff {diff})")
    # The slots come to the card only after the backward, so the step's peak
    # falls by about them; between steps all the offloaded bytes are off it.
    peak_saved = runs[False]["peak"] - runs[True]["peak"]
    held_saved = runs[False]["between"] - runs[True]["between"]
    slot_bytes, offloaded = runs[True]["slot_bytes"], runs[True]["offloaded_bytes"]
    check(OFFLOAD_SAVING[0] * slot_bytes <= peak_saved <= OFFLOAD_SAVING[1] * slot_bytes,
          f"host offload: peak fell by {peak_saved} bytes, not {OFFLOAD_SAVING} x the "
          f"{slot_bytes} bytes of optimizer slots")
    check(OFFLOAD_SAVING[0] * offloaded <= held_saved <= OFFLOAD_SAVING[1] * offloaded,
          f"host offload: memory between steps fell by {held_saved} bytes, not "
          f"{OFFLOAD_SAVING} x the {offloaded} bytes offloaded")
    rows.append(dict(world=world, global_batch=RESNET_BATCH, optimizer=DIST_OPT,
                     model="resnet50", path="PS(host_offload=True)",
                     losses=runs[True]["losses"], ms_per_step=runs[True]["ms"],
                     resident_ms_per_step=runs[False]["ms"],
                     kernel_launches=runs[True]["launches"], collectives=runs[True]["wire"],
                     offloaded_bytes=runs[True]["offloaded_bytes"], slot_bytes=slot_bytes,
                     copied_bytes_per_step=2 * runs[True]["offloaded_bytes"],
                     peak_bytes=runs[True]["peak"], resident_peak_bytes=runs[False]["peak"],
                     allocated_between_steps=runs[True]["between"],
                     resident_allocated_between_steps=runs[False]["between"],
                     bitwise_vs_resident=True))
    del runs, rparams, rbatch
    torch.cuda.empty_cache()

    # Asynchronous PS: 2 workers on this card. build() gives the threaded
    # trainer; the round-robin one is the same trainer built with that schedule.
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=from_name(
        "PS", sync=False, staleness=ASYNC_STALENESS), device="cuda",
        resource_spec=ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": ASYNC_WORKERS}]}),
        init_method=f"file://{work}/pg", world_size=world, rank=rank,
        timeout_s=DIST_GROUP_TIMEOUT_S)
    built = autodist.build(bert.loss_fn, params, batch, optimizer=OptimizerSpec(*DIST_OPT))
    check(isinstance(built, AsyncPSTrainer) and built.schedule == "threads"
          and built.n_workers == ASYNC_WORKERS, "sync=False not routed to the trainer")
    for schedule in ("round_robin", "threads"):
        trainer = built if schedule == "threads" else AsyncPSTrainer(
            built.loss_fn, built.tx, built.n_workers, staleness=built.staleness,
            schedule=schedule, has_aux=built.has_aux, device=built.device)
        state = trainer.init(params)
        calls = [0]

        def next_batch(tick):
            calls[0] += 1
            return batch

        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        state, m = trainer.run(state, next_batch, ASYNC_PUSHES)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / ASYNC_PUSHES * 1e3
        launches = _launch_counts()
        losses = m["loss"].tolist()
        _check_run(f"async {schedule}", "bert_base", losses, launches, [], None, calls[0])
        check(state.version == ASYNC_PUSHES == len(losses),
              f"async {schedule}: version {state.version}, pushes {len(losses)}")
        check(m["max_lag"] <= ASYNC_STALENESS, f"async {schedule}: lag {m['max_lag']} over "
              f"the bound {ASYNC_STALENESS}")
        row = dict(world=1, global_batch=TRAIN_BATCH, optimizer=DIST_OPT, model="bert_base",
                   path=f"PS(sync=False, staleness={ASYNC_STALENESS}), {schedule}",
                   workers=ASYNC_WORKERS, pushes=ASYNC_PUSHES, gradients=calls[0],
                   losses=losses, lags=m["lag"].tolist(), ms_per_push=ms,
                   kernel_launches=launches)
        if schedule == "round_robin":
            hand_losses, hand = _async_by_hand(bert, params, batch, ASYNC_PUSHES,
                                               ASYNC_WORKERS, dev)
            got = flatten_params(state.params)
            adiff = max((got[n].float() - t.float()).abs().max().item()
                        for n, t in hand.items())
            check(adiff == 0.0 and hand_losses == losses,
                  f"async round_robin: differs from the schedule by hand (param diff "
                  f"{adiff}, losses {losses} vs {hand_losses})")
            row["bitwise_vs_by_hand"] = True
            del hand
        rows.append(row)
        del trainer, state
        torch.cuda.empty_cache()
    del built
    pg.leave()
    with open(os.path.join(work, f"rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def sync_options(card: str) -> list:
    """The sync_options phase: one NCCL rank on cuda:0 (a process of this
    script). Returns its rows."""
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        rows = _spawn_ranks("--sync-rank", 1, work, env)[0]
    for row in rows:
        emit("sync_options", **row, ranks_seconds=time.perf_counter() - t0, card=card)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    zoo_shapes = zoo_conv_shapes(dev)
    zoo_kn = {(k, n) for shapes in zoo_shapes.values() for (_, k, n) in shapes}
    t0 = time.perf_counter()
    libs = ("paged_attention", "flash_attention", "fused_conv_stats")
    _build.build(libs)                       # one nvcc per source, started together
    pa.build_kernel()
    fa.build_kernel()
    fcs.build_kernel()
    ptxas = {name: _build.ptxas_report(name) for name in libs}
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={n: _build.build_seconds.get(n) for n in libs}, ptxas=ptxas,
         flash_tensor_core=tensor_core_report(ptxas["flash_attention"]),
         conv_tensor_core=conv_tensor_core_report(ptxas["fused_conv_stats"], zoo_kn))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = [parity_case(shape, kind, gen, dev)
            for shape in ("decode", "prefill", "verify")
            for kind in ("bfloat16", "int8", "float32")]

    params = tt.init_params(get_model("transformer"), seed=SEED, device=dev)
    serve_rows = [serve_run(params, kv_quant, dev) for kv_quant in (False, True)]
    stream_check(params, dev)
    del params

    flash_rows = [r for seq, causal, dtype in ((TRAIN_SEQ, False, torch.bfloat16),
                                               (TRAIN_SEQ, True, torch.bfloat16),
                                               (128, False, torch.bfloat16),
                                               (256, True, torch.bfloat16),
                                               (TRAIN_SEQ, False, torch.float32))
                  for r in flash_case(seq, causal, dtype, gen, dev)]
    conv_rows = [conv_stats_case(*shape, torch.bfloat16, gen, dev, launches)
                 for shape, launches in CONV_SHAPES]
    conv_rows.append(conv_stats_case(*CONV_SHAPES[0][0], torch.float32, gen, dev))
    emit("conv_stats_forward", model="resnet50", **conv_forward_totals(conv_rows))
    for key, shapes in zoo_shapes.items():
        model_rows = [conv_stats_case(*shape, torch.bfloat16, gen, dev, launches, key)
                      for shape, launches in sorted(shapes.items())]
        emit("conv_stats_forward", model=key, **conv_forward_totals(model_rows))
        conv_rows += model_rows
    train_rows = [train_run("bert_base", TRAIN_BATCH, TRAIN_STEPS, card, dev),
                  train_run("transformer", LM_BATCH, LM_STEPS, card, dev)]
    resnet_row = train_resnet(card, dev)
    train_check(dev)
    resnet_check(dev)
    zoo_rows = zoo_train(card, dev, zoo_shapes)
    zoo_check(dev)
    optim_check(dev)
    remat_check(dev)
    accum_check(dev)
    dist_rows = dist_train(card)
    sync_rows = sync_options(card)

    main_row = rows[0]                  # decode, bf16 pages: the serving hot shape
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "autodist_tpu_torch/csrc/paged_attention.cu",
        "replaces": "autodist_tpu/ops/paged_attention.py:137",
        "launches": sum(r["kernel_launches"] for r in serve_rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    # Flash kernels: the main shape is bert_base's, S=512 non-causal.
    replaces = {"fwd": "autodist_tpu/ops/flash_attention.py:46",
                "dkdv": "autodist_tpu/ops/flash_attention.py:100",
                "dq": "autodist_tpu/ops/flash_attention.py:155"}
    for kind, where in replaces.items():
        row = next(r for r in flash_rows if r["kernel"] == kind and r["S"] == TRAIN_SEQ
                   and not r["causal"] and r["dtype"] == "bfloat16")
        kernels.append({
            "name": f"flash_attention_{kind}",
            "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_attention.cu",
            "replaces": where,
            "launches": sum(t["kernel_launches"][kind]
                            for t in train_rows + dist_rows + sync_rows),
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                               if r["kernel"] == kind),
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # The fused conv-stats kernel: the main shape is the first bottleneck
    # conv of ResNet-50 at batch 128, bf16; the library call is
    # torch.matmul plus the two fp32 column sums. Its launches are those of
    # the three CNNs' train windows.
    row = conv_rows[0]
    kernels.append({
        "name": "fused_conv_stats",
        "route": "cuda",
        "source": "autodist_tpu_torch/csrc/fused_conv_stats.cu",
        "replaces": "examples/benchmark/fused_conv_stats.py:54",
        "launches": resnet_row["kernel_launches"]["fused_conv_stats"]
        + sum(r["kernel_launches"].get("fused_conv_stats", 0)
              for r in zoo_rows + dist_rows + sync_rows),
        "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    RANK_MAINS = {"--dist-rank": dist_rank, "--dist-cpu-rank": dist_cpu_rank,
                  "--sync-rank": sync_rank}
    if len(sys.argv) == 5 and sys.argv[1] in RANK_MAINS:
        sys.exit(RANK_MAINS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

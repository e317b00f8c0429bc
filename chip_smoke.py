"""Smoke run of the PyTorch port on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once) and drives both paths of the port:

* the distributed GEMM case study (1-D GEMM, double-buffered and blocking
  SUMMA, ragged SUMMA) at the paper's EXTRALARGE size on a world of one rank
  (NCCL, grid 1x1), with its two GEMM kernels (split TF32 on the tensor
  cores) held against their plain versions, against a float64 product
  (error at most 10x the plain version's) and against themselves (two
  launches bitwise equal), each loader (TMA, strided TMA, ``cp.async``)
  held to its shapes, the two the path takes (TMA, strided TMA) counted on
  the main path, a ``torch.profiler`` proof that it ran the port's kernels
  and no library GEMM, and kernel times in all 8 majors against
  ``torch.matmul`` (``addmm_`` for the panel);
* the dense LM at phi4-mini-3.8b's full width (32 layers, seeded random
  weights): the attention kernels against their plain versions, one
  full-sequence forward of 4096 tokens (32 ``flash_attention`` launches),
  the serving engine answering 8 requests on 4 slots (``flash_decode`` in
  every prefill chunk and decode step, launches counted by step kind),
  each held against the same run through the kernels' plain versions, a
  profiler proof that no library attention kernel ran, where the time of a
  forward and of a decode step goes (device time by kind, idle share), and
  kernel times beside their bounds (the bf16 products the tensor-core
  kernels run, the float32 bound beside it), plain versions and
  ``scaled_dot_product_attention`` (on float32 upcasts, and on the bf16
  tensors as a speed yardstick);
* tensor-parallel serving at phi4-mini's full width: the same 8 requests
  through ``Engine(mesh=..., microbatches=2)`` on a one-rank NCCL
  ``(data, model)`` mesh (``flash_decode`` launched ``n_layers x
  microbatches`` times a decode step, counted), greedy tokens held against
  the single-host kernel run except at its near ties, decode tok/s and a
  decode step's host and device ms beside the single-host step's; 4
  decode steps of the blocking TP step bitwise equal to the double-buffered
  one; and ``flash_decode`` at one rank's shapes under a model axis of 2
  and 4 (12 heads over 4 KV groups, 6 over 2; one microbatch's 2 slots, on
  views of a whole cache) against its plain version, timed beside its
  bound and ``scaled_dot_product_attention``.  One card gives the model
  axis one rank: no reduction crosses a process;
* the sharding recipe's per-rank program at phi4-mini's full width and
  depth on the same one-rank NCCL ``(data, model)`` mesh, every rank on
  its shards of the weights (``shard_params_by_recipe``; views on one
  rank): the forward of 1 x 4096 tokens under ``make_recipe(cfg, mesh,
  attn_mode="auto")`` (``tp``) and under ``"sp"`` (``flash_attention``
  once a layer, logits at every token against the no-recipe forward,
  host and device ms and kernels launched beside the no-recipe forward's);
  the serving run's 8 requests through ``Engine(recipe=...)``
  (``flash_decode`` once a layer a step, greedy tokens against the
  single-host run except at its near ties, a decode step's host and device
  ms, idle share and kernels launched beside the single-host step's); the
  same 8 requests through ``Engine(recipe=..., mesh=..., microbatches=2)``
  (prefill under the recipe, decode through the TP step, one cache
  allocation: ``flash_decode`` once a layer a prefill chunk and twice a
  layer a decode step, greedy tokens equal to the TP serving run's, the TP
  weights views of the shards, decode tok/s beside the TP run's, the
  card's peak memory); and one training step under ``tp`` at the training
  phase's depth against the no-recipe step.  On one card every axis has one rank: the recipe's
  gathers and reductions move nothing; across ranks they are held on gloo
  CPU processes in the tests;
* the sequence-parallel ring's kernel work at phi4-mini's full width: every
  (rank, step) carry call of a 4-rank ring over 4096 tokens and over a
  ragged 4095 (the schedule of ``_ring_attention_local``, through its own
  offset helper) against the plain version, carry steps chained in block
  order against the single-shot kernel (bitwise), ``ring_attention_seq`` on
  a one-rank NCCL mesh (bitwise against the single-shot kernel, and
  double-buffered against blocking), the bf16 kernels' float32 ``acc / l``
  against float64 (at most 10x the plain version's error) and two launches
  of each bitwise equal, and the tiled transpose against its plain version
  (bitwise), with a profiler proof and times.  ptxas's registers and spills
  of every tensor-core kernel instance are printed.  One card shows
  no ring transfer: the ring's schedule across ranks is checked on gloo CPU
  processes in the tests.
* the MoE family at phi3.5-moe's full width (d_model 4096, 32 query heads
  over 8 KV groups, 16 experts of d_ff 6400, top-2; seeded random weights,
  bf16, 8 of its 32 layers): the two attention kernels at its shapes (GQA
  4) against their plain versions and timed; a forward of 1 x 4096 tokens
  (the global capacity dispatch) and of 16 x 256 (the grouped dispatch)
  through the kernel and through its plain version (routed as the kernel
  run was, so a near tie of the router cannot flip a discrete choice; the
  plain router's disagreements are counted), logits held at every token,
  with ``flash_attention`` launches counted and the device time split into
  attention, expert GEMMs, routing/scatter and the rest; and serving of 8
  requests on 4 slots, prefilled token by token (``flash_decode`` in every
  step, counted), greedy tokens held against the plain run (routed the
  same way) except at its near ties.  One card gives the ``model`` axis
  one rank, so the expert-parallel dispatch falls back (with its warning)
  to the grouped or global one; its all-to-alls are checked on gloo CPU
  processes in the tests.
* the MLA family at minicpm3-4b's full width (d_model 2560, 40 heads, q/kv
  latent ranks 768/256; seeded random weights, bf16; 31 of its 62 layers,
  about 5.2 GB): the flash-attention kernel's (96, 64) instances (q/k of
  d_nope + d_rope = 96, v of d_v = 64) against their plain version at the
  forward's shape and at a ragged 4095, against float64 (at most 10x the
  plain version's error) and against themselves (bitwise), timed beside
  their bound and ``scaled_dot_product_attention`` (the backend it picks
  named); a forward of 1 x 4096 tokens (``flash_attention`` launched
  once a layer) held against its plain path at every token, with its
  device time by kind; and serving of 8 requests on 4 slots through the
  absorbed latent-cache decode (no kernel, as in the reference: whole-prompt
  chunks and decode steps in plain products), greedy tokens held against
  the plain run except at near ties and each first prefill chunk's logits
  against the decompressed forward of the same prompt.
* the hybrid and SSM families: the flash-attention kernel's (112, 112)
  and the flash-decode kernel's D = 112 instances (zamba2-7b's shared
  attention: q/k/v 1x32x4096x112 causal; an MHA decode step of 5 slots of
  a 4096-position cache, one wrapped past it) against their plain
  versions, float64 and themselves, timed beside their bounds and
  ``scaled_dot_product_attention``; zamba2-7b (39 of its 81 layers: 33
  Mamba2 blocks and 6 applications of one shared attention block) and
  rwkv6-3b (16 of its 32 RWKV6 layers) at full width, seeded bf16
  weights: a 1 x 4096 forward (zamba2's through 6 kernel launches,
  held against its plain path at every token) with its device time split
  into the attention kernel, the SSM's scan work (the ``ssm.scan`` ranges),
  cuBLAS GEMMs and the rest; 6 requests on 4 slots (two slots reused, the
  recurrent state zeroed), prefilled token by token, zamba2's through the
  decode kernel (6 launches a step) with greedy tokens held against its
  plain run except at near ties and the TMA map cache's hit rate; a steady
  decode step's host and device time; decode against the forward at
  float32 on the card for both (depth cut, the reference's 5e-3); and
  one zamba2 training step (13 of 81 layers) through the kernel against
  the plain attention's.  The carry form's (112, 112) instance (zamba2's
  shared attention under ``sp`` and ``sp_ring``): ring steps over 4 chunks
  of 1024 tokens (diagonal and off-diagonal, and a ragged 4095) and the
  ring's one step of the whole sequence against the plain version, bf16
  and float32, the chain over 1024-key chunks bitwise the single-shot
  kernel, timed beside its bounds.
* the SSM and hybrid families under a sharding recipe at full width and
  the depth above, on a one-rank NCCL ``(data, model)`` mesh and the
  rank's shards: zamba2-7b's 1 x 4096 forward under ``tp``, ``sp`` and
  ``sp_ring`` (the (112, 112) forward instance 6 times, or under
  ``sp_ring`` the carry instance 6 times) and rwkv6-3b's under ``tp`` and ``sp_ring``, logits
  against the no-recipe forward (``tp`` bitwise), the host ms of a forward
  in turns with it (and under ``sp_ring`` a profiled window beside the
  no-recipe one);
  ``Engine(recipe=...)`` under ``tp`` on the serving phase's requests (a
  slot reused), greedy tokens equal to the single-host run's, the host ms
  of decode steps in turns with the single-host engine's; and zamba2's
  13-layer training step under ``tp`` against the no-recipe step.
* the MLA and MoE families under a sharding recipe, on a one-rank NCCL
  ``(data, model)`` mesh and the rank's shards: the carry form's (96, 64)
  instance (MLA's queries and keys of 96, values and state of 64) at
  minicpm3-4b's ring shapes (1 x 40 x 1024 diagonal and off-diagonal steps,
  the one-card step over 1 x 40 x 4096) against its plain version, bf16
  and float32, the chain over 1024-key chunks and the one-step chain
  bitwise the (96, 64) forward instance, nothing stored past the state,
  timed beside its bounds; minicpm3-4b's and phi3.5-moe's 1 x 4096
  forwards under ``tp``, ``sp`` and ``sp_ring`` (the forward instance once
  a layer, or under ``sp_ring`` the carry instance in its place), logits
  bitwise the no-recipe forward's, phi3.5-moe's expert-parallel dispatch
  falling back (one rank of ``model``) to the capacity dispatch, whose
  ``moe.*`` ranges the profile must hold, each mode's host and device ms,
  idle share and kernels beside the no-recipe forward's; each family's
  first 4 serving requests through ``Engine(recipe=tp)``, tokens equal to
  the single-host run's, a decode step's window in turns with the
  single-host engine's; and one ``tp`` training step of each (minicpm3-4b
  at 8 layers, phi3.5-moe at 1) against the no-recipe step, loss and
  gradient norm bitwise.
* the VLM and audio families at full width and half depth, seeded bf16
  weights: the forward kernel's (128, 128) instance non-causal at the
  VLM's cross attention (q 1 x 32 x 4096 over the image's k/v 1 x 8 x 1024,
  and a decode step's 4 x 32 x 1 over 4 x 8 x 1024), its (64, 64) instance
  at musicgen's causal MHA (1 x 32 x 4096 x 64) and the decode kernel's
  D = 64 instance at musicgen's decode step (4 slots, one row a group),
  each against its plain version, float64 and itself, timed beside its
  bound, its plain version and ``scaled_dot_product_attention``;
  llama-3.2-vision-11b (20 of its 40 layers: 4 groups of 4 self-attention
  blocks and a gated cross-attention block; its gates drawn from U[0.5,
  1], since at their zero init the cross path would not show) on 1 x 4096
  tokens and a seeded image (20 ``flash_attention`` launches, 4 of them
  non-causal),
  logits at every token against the plain path and a second image moving
  them; 4 rows served through ``lm.init_cache`` and ``lm.decode_step``
  (a whole-prompt chunk, then 32 greedy steps, each launching
  ``flash_decode`` 16 times and the cross attention 4 times), greedy
  tokens against the plain run; musicgen-large (24 of its 48 layers,
  ``embeds`` input) on 1 x 4096 frames against the plain path, 8 requests
  through the engine's featurizer on 4 slots (single host and TP on a
  one-rank NCCL mesh, ``flash_decode`` 24 times a step, 48 under TP); decode
  against the forward at float32 for both (depth cut, the reference's
  2e-4); one training step of each (depth cut) against the plain
  attention's, its seconds and peak memory.
* the VLM and audio families under a sharding recipe on a one-rank NCCL
  ``(data, model)`` mesh, on phase 17's model builds: the carry form's
  (64, 64) and (128, 128) instances at the one-card ring step of
  musicgen's and the VLM's self attention (1 x 32 x 4096 x 64 causal MHA;
  1 x 32 x 4096 x 128 over 8 groups) against their plain versions, timed
  beside their bounds and the plain version, with their registers and
  spills; both 1 x 4096 forwards under ``tp``, ``sp`` and ``sp_ring``,
  logits bitwise the no-recipe forward's, the forward instance once a self
  block and once a cross block (non-causal), or under ``sp_ring`` the carry
  instance in place of every self block's launch while the cross blocks
  stay on the forward kernel, each mode's host and device ms beside the
  no-recipe forward's; the VLM's 4 rows through ``lm.decode_step`` under
  ``tp``, tokens equal to the no-recipe run's; musicgen's first 4
  requests (a cut, for the run's length) through ``Engine(recipe=tp)``,
  tokens equal to the single-host run's;
  and one ``tp`` training step of each at the no-recipe step's depth (5
  and 24 layers), loss and gradient norm bitwise the no-recipe step's, its
  seconds and peak memory.
* the last parts of the TPU kernels' contracts, reached through ``ops``
  (no model path runs them; the bf16 GEMMs' launches on the main path are
  counted, and are 0): the bf16 GEMM kernels (``csrc/gemm_bf16.cu``)
  in all 8 majors at EXTRALARGE (TMA loads and store), at the ragged
  dims+1 (plain loads, direct stores) and at 2056 x 2568 x 1408 (TMA
  loads and store, the store clipped at 8-wide edge tiles), each launch
  counted on its loader and its store, with and without acc (bf16 or
  float32) to bf16 and float32 outputs, and the panel (nb = 2, bf16 and
  float32 panels, jb by value and from the device, the other block
  bitwise), each against its plain version, against float64 (at most 10x
  the plain version's error) and bitwise on a rerun; acc passed as the
  output buffer itself bitwise the sum into a new buffer, on either
  store; timed at EXTRALARGE
  beside their bf16 bounds, plain versions and cuBLAS (``torch.matmul``,
  ``torch.mm(out_dtype=float32)``, ``addmm_``, ``torch.addmm(out_dtype=
  float32)``); and the decode kernel's
  (96, 64) instance at minicpm3-4b's widths (40 heads, MHA: a step of 4
  slots over a 4096-position cache, a 4 x 2048 prefill chunk with an idle
  slot), bf16 and float32, against its plain version with the per-block
  rounding margins, timed beside its bound.
* the dry run's prediction against the card (``dryrun_check``): the
  phi4-mini 1 x 4096 forward and the 8-layer training step (2 x 4096
  tokens, 2 microbatches) each traced as ``repro_torch.launch.dryrun``
  traces a cell (a fake world of one rank, ``CardTrace`` fake tensors of
  the same shapes, the op walk) and then run once on the card after a
  warm-up: the predicted peak memory above the program's inputs against
  ``max_memory_allocated`` (within 3% or 256 MiB), the predicted launches
  of every kernel against every wrapper's count (equal), and the
  predicted compute term against the run's device ms (not above it); and
  the package's work formulas (``kernels/work.py``) against this script's
  ``bound`` and ``attn_bound`` at the kernel table's shapes.

Every kernel time (``ms``, ``plain_ms``, ``library_ms``) is device time per
call from ``repro_torch.kernels.timing.queued_ms`` (calls run back to back
behind a sleep kernel, between two CUDA events), and a kernel's time below
its bound fails the run; ``call_ms`` is one call with the host's work.
Phases print one line each (or one line per case); any failed phase raises,
so the exit code is non-zero and no result line is printed.  The line before
the last is the card's name and power limit from ``nvidia-smi``; the last
line is ``{"ok": true, "device": {...}}``.  Needs a CUDA device and the
checkout around this file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
EXTRALARGE = (2048, 2560, 1408)  # PolyBench GEMM (ni, nj, nk), the paper's size
MAJORS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
RTOL, ATOL = 1e-4, 1e-3  # kernel vs plain version: float32 sums in another order
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s (data sheet)
TF32_PEAK = 495e12  # H100 SXM TF32 on the tensor cores, dense, FLOP/s (data sheet)
BF16_PEAK = 989e12  # H100 SXM bf16 on the tensor cores, dense, FLOP/s (data sheet)
SPLIT_PRODUCTS = 3  # the GEMM kernels' split TF32: A_lo B_hi + A_hi B_lo + A_hi B_hi
ACCURACY_RATIO = 10  # GEMM kernel's error vs float64 at most this times the plain version's
# the bf16 GEMM kernels vs their plain versions: both sum in float32 (in other
# orders) and round once, so a bf16 output may be one bf16 ulp apart; a
# float32 output is held as the float32 kernels' is
GEMM_BF16_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-2),
                 torch.float32: dict(rtol=1e-4, atol=1e-3)}
# (acc dtype, out_dtype) of each bf16 GEMM check: without acc to either
# output, a bf16 acc to the bf16 output, a float32 acc to a float32 output
GEMM_BF16_CASES = ((None, None), (None, torch.float32), (torch.bfloat16, None),
                   (torch.float32, torch.float32))
UNALIGNED = (2049, 2561, 1409)  # the ragged SUMMA's dims+1: the strided TMA loader
# rows of multiples of 8 (the bf16 GEMMs' TMA loader and store) but 8-wide
# edge tiles (the store clipped) and an odd count of tile rows (17)
CLIPPED = (2056, 2568, 1408)
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
LIBRARY_GEMM = re.compile(r"cublas|cutlass|xmma|gemm|sm90_|sm80_|ampere_|magma", re.I)
# attention kernels vs plain versions: bf16 allows one bf16 ulp of the output
# (2^-8 relative) on top of float32 sums in another order; float32 only the sums
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-4}
LIBRARY_ATTN = re.compile(r"flash|fmha|sdpa|efficient_attention|cudnn", re.I)
GEMM_NAMES = re.compile(r"nvjet|gemm|gemv|cublas|cutlass|xmma|sm90_|sm80_", re.I)
PORT_ATTN = ("flash_attention_kernel", "flash_decode_kernel", "flash_decode_combine_kernel")
CARRY_INSTANCE = ("true, true", "Lb1ELb1E")  # the carry form's template flags, as named
RING_R = 4  # the ring whose kernel work runs on the card: 4 ranks over SEQ tokens
DEVICE = "cuda"
ARCH, SEQ = "phi4-mini-3.8b", 4096  # the forward's model and length
SLOTS, MAX_LEN, REQUESTS, NEW_TOKENS = 4, 4096, 8, 32  # the serving run
PROMPT_LENS = (128, 2049)  # seeded prompt lengths: [low, high)
TP_MICROBATCHES = 2  # microbatches of the TP serving run's decode steps
TP_SHARD_MODEL_AXES = (2, 4)  # model axes whose per-rank decode shapes are held and timed
DECODE_LENS = (1, 700, 2049, 4096)  # per-slot cache lengths of the timed decode step
# bf16 logits of the kernel path against the plain path, 32 layers deep: the
# attention outputs may round one bf16 ulp apart, and the residual stream
# carries that to the logits (unit scale: embed std 0.02 over d_model 3072)
LOGIT_TOL = 0.25
MOE_ARCH, MOE_DEPTH = "phi3.5-moe-42b-a6.6b", 8  # full width, 8 of its 32 layers
MOE_FORWARDS = ((1, SEQ), (16, 256))  # (B, S): global capacity dispatch; grouped, G = 16
MOE_REQUESTS, MOE_NEW_TOKENS, MOE_PROMPT_LENS = 8, 16, (16, 129)  # prompt lengths [low, high)
MOE_RANGES = {"moe.route": "routing_scatter", "moe.combine": "routing_scatter",
              "moe.experts": "expert_gemms"}  # the MoE's profiler ranges, by kind
MLA_ARCH = "minicpm3-4b"  # full width: 4.08 B parameters at its 62 layers, 8.2 GB in bf16
# its depth cut 62 -> 31 (2.6 B parameters, 5.2 GB), to keep the whole run
# within its earlier length beside the recurrent recipe phases
MLA_DEPTH = 31
# the MLA serving run: phi4-mini's requests (prompts of 128-2048 tokens, 32
# new) on 4 slots of 4096 positions; the absorbed whole-prompt chunk holds
# float32 scores of (4, 40, 2048, 4096), 5.4 GB a live tensor, beside the
# weights
MLA_RAGGED = 4095  # the (96, 64) instance's ragged case: Sq = Skv = 4095
# training at phi4-mini's full width, depth cut 32 -> 8: float32 masters,
# gradients, both Adam moments and the microbatch sum of 1.42 B parameters
# are 28.4 GB, the head's float32 logits and their gradient about 10 GB, and
# the plain backward's recompute of one layer about 6 GB; full depth would
# need 61 GB for the optimizer's state alone
TRAIN_DEPTH, TRAIN_BATCH, TRAIN_MICROBATCHES, TRAIN_STEPS = 8, 2, 2, 3  # batch of 2 x SEQ
# the launcher's run (its checkpoint written and restored: 17 GB and nearly
# two minutes at 8 layers on an H100) at a quarter of the depth, to keep the
# whole run near its earlier length
LAUNCHER_DEPTH = 2
TRAIN_LR = 3e-4
# kernel path against the plain attention path, bf16 activations, one step:
# the loss, a mean over 8192 tokens, to 2e-3 relative; each gradient leaf to
# 5e-2 relative (Frobenius): the two runs' activations and cotangents round
# one bf16 ulp (2^-8) apart wherever the attention output does, every
# gradient is a sum over 8192 tokens of such products, and 8 layers carry
# the differences on (a margin of 10x over one ulp)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 2e-3, 5e-2
# the ZeRO step against make_train_step on the same parameters and batch:
# the forward is the same (loss 1e-6), the gradients are summed with
# atomics (the embedding's backward) and the norm by bucket (1e-4); Adam's
# first update is nearly sign(g) * lr, so an element whose gradient is near
# 0 may move by up to 2 * lr between two correct runs: every element within
# 2 * lr, and at most 1e-4 of them more than lr / 100 apart
ZERO_LOSS_RTOL, ZERO_NORM_RTOL, ZERO_FAR_SHARE = 1e-6, 1e-4, 1e-4
# the sp_ring step on a one-rank mesh against the no-recipe step: the ring's
# one carry step is bitwise the single-shot kernel forward (loss 1e-6); the
# two backward recomputes (carry and single-shot plain versions) sum in other
# orders and round q, k, v's gradients to bf16, one bf16 ulp apart at most
RING_LOSS_RTOL, RING_NORM_RTOL = 1e-6, 5e-3
TRAIN_RANGES = {"attn.recompute": "backward_recompute",
                "train.optimizer": "optimizer"}  # the training step's profiler ranges
HYBRID_ARCH = "zamba2-7b"  # full width (5.74 B parameters at its full depth)
SSM_ARCH = "rwkv6-3b"  # full width (3.07 B parameters at its full depth)
# the hybrid's and the SSM's serving run: 5 requests (seeded prompts of
# 16-48 tokens, 16 new each) on SLOTS slots of MAX_LEN, so a slot serves a
# second request after a release; both families prefill token by token
# (zamba2: 0.1-0.2 s a token on an H100), so the prompts stay short (32-96
# tokens until the dry run's phase was added: a cut for run length)
RECURRENT_REQUESTS, RECURRENT_NEW_TOKENS, RECURRENT_PROMPT_LENS = 5, 16, (16, 49)
# the D = 112 decode step at zamba2's shape (MHA, 32 heads): 5 slots of a
# 4096-position ring buffer, the last wrapped past it (every slot valid, the
# query at position 5999)
HYBRID_DECODE_LENS = (1, 700, 2049, 4096, 6000)
# decode against the forward at float32 on the card, the reference's own
# test of these families (tests/test_decode.py: 5e-3), at full width with
# the depth cut (zamba2: 2 super-blocks and a tail block; rwkv6: 4 layers)
# and, for rwkv6, the chunk cut to 16 as the reference's test cuts it: its
# chunked form clamps each within-chunk factor to exp(+-30) on its own, so
# where a chunk's decay passes e^-30 (about 30 steps of the seeded init's
# e^-1) a score becomes e^-30 * e^30 = 1 in place of a small one, in the
# reference as in the port (ROADMAP.md §3)
RECURRENT_CHECK = {"zamba2-7b": 13, "rwkv6-3b": 4}
RECURRENT_CHECK_CHUNK = {"zamba2-7b": 64, "rwkv6-3b": 16}
RECURRENT_CHECK_TOKENS, RECURRENT_TOL = 128, 5e-3
# one training step of zamba2 at full width, depth cut 81 -> 13 (2
# super-blocks and a tail block, 1.28 B parameters: float32 masters,
# gradients and both moments 20.5 GB), 1 x SEQ tokens, against the same
# step through the plain attention (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL)
HYBRID_TRAIN_DEPTH = 13
SCAN_RANGES = {"ssm.scan": "ssm_scan"}  # models/ssm.py:SCAN_RANGE, the mixers' recurrent work
# zamba2's bf16 logits through the kernel against the plain path, every
# token: the attention outputs may round one bf16 ulp apart, and dozens of
# layers of random weights amplify any such difference (on an H100 a one-ulp
# nudge of the plain path's attention outputs moves its logits by about 5%
# relative, and the kernel path's differ by as much).  So the control is
# measured in the run: the kernel path's relative (Frobenius) distance from
# the plain path at most HYBRID_LOGIT_MARGIN times the plain path's distance
# from itself with every attention output nudged one bf16 ulp up or down
HYBRID_LOGIT_MARGIN = 2.0
# zamba2's shared attention (32 heads, head dim 112) through the carry
# form's (112, 112) instance: the ring's steps over SEQ tokens in RING_R
# chunks of 1024 (and a ragged SEQ - 1), and the ring's one step of the
# whole sequence on one card
HYBRID_HEADS, HYBRID_HEAD_DIM = 32, 112
# the recipe phases of the recurrent families on a one-rank NCCL mesh: the
# modes of the forward, each timed in turns with the no-recipe forward
RECURRENT_RECIPE_MODES = {"zamba2-7b": ("tp", "sp", "sp_ring"), "rwkv6-3b": ("tp", "sp_ring")}
# the serving phases' steady decode window: 4 steps (8 before the recurrent
# recipe phases were added), to keep the run near its length
RECURRENT_WINDOW_STEPS = 4
# the steady decode steps timed in turns: 8 steps of prompts cut to 8 tokens
RECURRENT_RECIPE_STEPS, RECURRENT_RECIPE_PROMPT = 8, 8
# the dense recipe_serve phase's in-turns windows, 4 decode steps each (8 before
# the recurrent recipe phases were added), to keep the run near its length
RECIPE_DECODE_STEPS = 4
# minicpm3-4b's attention operands (40 heads, q/k of d_nope + d_rope = 96, v
# and the carry state of d_v = 64): the carry form's (96, 64) instance
MLA_HEADS, MLA_D, MLA_DV = 40, 96, 64
# float32 sentinels after the (96, 64) carry state's last row: a store past
# its 64 columns a row would land on them
MLA_SENTINEL, MLA_SENTINEL_TAIL = 12345.0, 4096
# the recipe training steps of the MLA and MoE families at full width, depth
# cut: minicpm3-4b 62 -> 8 layers; phi3.5-moe 32 -> 1 (1.30 B parameters a
# layer and 0.26 B of embedding and head, 16 bytes each with AdamW's moments
# and the gradients, and the step's new parameters and moments beside the
# old: about 44 GB at one layer, over the card at two)
MLA_TRAIN_DEPTH, MOE_TRAIN_DEPTH = 8, 1

# the VLM and audio families: llama-3.2-vision-11b (40 layers: 8 groups of 4
# self-attention blocks and a gated cross-attention block over a 1024-position
# image) and musicgen-large (48 layers, MHA at head dim 64, frame embeddings),
# full width, depth cut (FAMILY_DEPTH), seeded bf16 weights; the VLM's cross
# blocks' gates drawn from GATE_RANGE (their zero init would hide the cross path)
VLM_ARCH, AUDIO_ARCH, VLM_ENC_LEN = "llama-3.2-vision-11b", "musicgen-large", 1024
GATE_RANGE = (0.5, 1.0)
# the VLM served through lm.decode_step: 4 rows, a whole-prompt chunk each
# (phi4-mini's prompt lengths), then 32 greedy steps; the steady decode
# windows of both families, 4 steps (phi4-mini's take 8)
VLM_ROWS, VLM_NEW_TOKENS, VLM_WINDOW_STEPS = 4, 32, 4
# decode against the forward at float32, full width, depth cut (the VLM to 2
# groups), at the reference's own tolerance for both families
# (tests/test_decode.py: 2e-4)
VLM_CHECK_DEPTH, AUDIO_CHECK_DEPTH, FAMILY_CHECK_TOKENS, FAMILY_DECODE_TOL = 10, 8, 64, 2e-4
# one training step of each at full width: the VLM at one group (5 layers,
# 2.14 B parameters: float32 masters, gradients, both moments and the step's
# new parameters and moments near 60 GB) over 1 x 2048 tokens (its 128256-wide
# logits and their gradient in float32 are 1 GB a thousand tokens);
# musicgen-large at 24 of its 48 layers (1.21 B parameters) over 1 x SEQ
VLM_TRAIN_DEPTH, VLM_TRAIN_SEQ, AUDIO_TRAIN_DEPTH = 5, 2048, 24
# the recurrent, VLM and audio families' forward, serving and recipe phases
# at full width and about half depth: zamba2 81 -> 39 layers (6 super-blocks
# and the config's 3-layer tail), rwkv6 32 -> 16, the VLM 40 -> 20 (4
# groups), musicgen 48 -> 24; a cut for run length (full depth until a slow
# host took the run past 1,140 s of its 1,200)
FAMILY_DEPTH = {HYBRID_ARCH: 39, SSM_ARCH: 16, VLM_ARCH: 20, AUDIO_ARCH: 24}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def buffers(majors: str, m: int, n: int, k: int, *, nb: int = 1, seed: int = 0):
    """Random A, B and a C-orientation accumulator/panel on the card."""
    c_major, a_major, b_major = majors.split("/")
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((k, m) if a_major == "K" else (m, k), device="cuda", generator=g)
    b = torch.randn((n, k) if b_major == "J" else (k, n), device="cuda", generator=g)
    c = torch.randn((nb * n, m) if c_major == "J" else (m, nb * n), device="cuda", generator=g)
    return a, b, c


def median_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_kernels(prof) -> list:
    """A profile's device events that are kernels: not the spans the
    profiler draws on the device timeline for ``record_function`` ranges
    (the MoE's ``moe.*`` ranges, the training step's)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in MOE_RANGES
            and e.name not in TRAIN_RANGES and e.name not in SCAN_RANGES]


def device_kernel_ms(prof) -> dict[str, float]:
    """Device milliseconds by kernel name in a profile."""
    out: dict[str, float] = {}
    for e in device_kernels(prof):
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def bound(m: int, n: int, k: int, *, acc: bool, dtype=torch.float32, out_bytes: int = 4,
          acc_bytes: int = 4) -> tuple[float, str, float]:
    """Least time for the GEMM kernels' work on the card: bytes (each input
    read once, the output written once: A and B in ``dtype``, the output and
    acc in their own widths) over the memory rate vs the operations over
    their peak, whichever is larger: float32 operands take the split
    scheme's three TF32 products over the TF32 peak, bf16 operands one bf16
    product over the bf16 peak.  Beside it, the float32 CUDA-core bound (one
    product over the float32 peak, or the bytes)."""
    nbytes = (torch.finfo(dtype).bits // 8 * (m * k + k * n) + out_bytes * m * n
              + (acc_bytes * m * n if acc else 0))
    flops = 2 * m * n * k
    t_bytes = nbytes / HBM_RATE
    per_flop = SPLIT_PRODUCTS / TF32_PEAK if dtype == torch.float32 else 1 / BF16_PEAK
    t_ops = flops * per_flop + (m * n / FP32_PEAK if acc else 0)
    t_fp32 = (flops + (m * n if acc else 0)) / FP32_PEAK
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            max(t_bytes, t_fp32) * 1e3)


def logical_f64(a, b, majors: str) -> torch.Tensor:
    """The float64 product A @ B in the output orientation of ``majors``."""
    c_major, a_major, b_major = majors.split("/")
    al = a.double().T if a_major == "K" else a.double()
    bl = b.double().T if b_major == "J" else b.double()
    c = al @ bl
    return c.T if c_major == "J" else c


def check_kernels(ops) -> dict:
    """Phase 2: every kernel against its plain version."""
    worst = {"gemm": 0.0, "gemm_panel": 0.0}
    from repro_torch.kernels import gemm as kernels

    # EXTRALARGE and 2000x2304x1000 take TMA (the second with out-of-bounds
    # boxes), dims+1 and 67x131x45 the strided TMA, 67x131x3 cp.async
    for shape, path in ((EXTRALARGE, "tma"), ((2000, 2304, 1000), "tma"),
                        (UNALIGNED, "tma_strided"), ((67, 131, 45), "tma_strided"),
                        ((67, 131, 3), "async")):
        m, n, k = shape
        errs = {}
        for majors in MAJORS:
            a, b, acc = buffers(majors, m, n, k)
            for with_acc in (False, True):
                c = acc if with_acc else None
                kernels.reset_launches()
                got = ops.gemm(a, b, c, majors=majors)
                if kernels.gemm_cuda.launches_by_path[path] != 1:
                    raise AssertionError(f"gemm {majors} {shape}: expected the {path} loader, "
                                         f"got {kernels.gemm_cuda.launches_by_path}")
                want = ops.gemm(a, b, c, majors=majors, impl="ref")
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                errs[majors + ("+acc" if with_acc else "")] = (got - want).abs().max().item()
        if shape == EXTRALARGE:
            worst["gemm"] = max(errs.values())
        phase("kernel_check", kernel="gemm", shape=shape, loader=path, max_abs_err=errs)
    m, n, k, nb = EXTRALARGE[0], EXTRALARGE[1] // 4, EXTRALARGE[2], 4
    errs = {}
    for majors in MAJORS:
        a, b, panel = buffers(majors, m, n, k, nb=nb)
        for jb in range(nb):
            for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device="cuda")):
                got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
                want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                keep = torch.ones_like(panel, dtype=torch.bool)
                blk = slice(jb * n, (jb + 1) * n)
                if majors.startswith("J"):
                    keep[blk, :] = False
                else:
                    keep[:, blk] = False
                if not torch.equal(got[keep], panel[keep]):
                    raise AssertionError(f"gemm_panel {majors} jb={jb} touched other blocks")
                where = "device" if isinstance(jb_arg, torch.Tensor) else "host"
                errs[f"{majors} jb={jb} {where}"] = (got - want).abs().max().item()
    worst["gemm_panel"] = max(errs.values())
    phase("kernel_check", kernel="gemm_panel", shape=(m, n, k, nb), untouched_blocks="bitwise",
          max_abs_err=errs)
    check_panel_odd_n(ops)
    check_gemm_accuracy(ops)
    return worst


def check_panel_odd_n(ops) -> None:
    """The panel at an odd block width: jb * N is not 16-byte aligned, which
    only the output's stores see; B's rows are N floats long when B is
    K-major, so those majors load through the strided TMA and the others
    through TMA.  The other blocks stay bitwise."""
    from repro_torch.kernels import gemm as kernels

    m, n, k, nb = EXTRALARGE[0], 641, EXTRALARGE[2], 4
    errs = {}
    for majors in MAJORS:
        a, b, panel = buffers(majors, m, n, k, nb=nb)
        path = "tma_strided" if majors.endswith("K") else "tma"
        for jb in (0, nb - 1):
            kernels.reset_launches()
            got = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors)
            if kernels.gemm_panel_cuda.launches_by_path[path] != 1:
                raise AssertionError(f"gemm_panel {majors} N={n}: expected the {path} loader, "
                                     f"got {kernels.gemm_panel_cuda.launches_by_path}")
            want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            keep = torch.ones_like(panel, dtype=torch.bool)
            blk = slice(jb * n, (jb + 1) * n)
            if majors.startswith("J"):
                keep[blk, :] = False
            else:
                keep[:, blk] = False
            if not torch.equal(got[keep], panel[keep]):
                raise AssertionError(f"gemm_panel {majors} N={n} jb={jb} touched other blocks")
            errs[f"{majors} jb={jb}"] = (got - want).abs().max().item()
    phase("kernel_check", kernel="gemm_panel", shape=(m, n, k, nb),
          loader="tma_strided for B K-major, else tma", untouched_blocks="bitwise",
          max_abs_err=errs)


def check_gemm_accuracy(ops) -> None:
    """At EXTRALARGE, every majors: two launches are bitwise equal, and the
    kernel's max abs error against a float64 product is at most
    ACCURACY_RATIO times the plain version's (float32 products, TF32 off)."""
    m, n, k = EXTRALARGE
    rows = {}
    for majors in MAJORS:
        a, b, acc = buffers(majors, m, n, k)
        for c in (None, acc):
            first = ops.gemm(a, b, c, majors=majors)
            if not torch.equal(first, ops.gemm(a, b, c, majors=majors)):
                raise AssertionError(f"gemm {majors}: two launches differ")
        exact = logical_f64(a, b, majors)
        kernel = (ops.gemm(a, b, majors=majors).double() - exact).abs().max().item()
        plain = (ops.gemm(a, b, majors=majors, impl="ref").double() - exact).abs().max().item()
        rows[majors] = dict(kernel=kernel, plain=plain, ratio=kernel / plain)
        if kernel > ACCURACY_RATIO * plain:
            raise AssertionError(f"gemm {majors}: error {kernel} against float64 is over "
                                 f"{ACCURACY_RATIO}x the plain version's {plain}")
    phase("gemm_accuracy", shape=EXTRALARGE, against="float64", deterministic="bitwise",
          max_ratio=max(r["ratio"] for r in rows.values()), max_abs_err=rows)


def drive_main_path(g, mesh1, mesh11) -> dict:
    """Phase 3: the case study's three entry points in all 8 majors."""
    ni, nj, nk = EXTRALARGE
    calls = {"panel1d": 0, "summa": 0, "ragged": 0}
    for majors in MAJORS:
        C, ref = g.run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors=majors, mesh=mesh1)
        np.testing.assert_allclose(C, ref, rtol=1e-3, atol=1e-3)
        phase("main_path", entry="run_distributed_gemm", majors=majors,
              max_abs_err=float(np.abs(C - ref).max()))
        calls["panel1d"] += 1
        for name, run, dims in (("summa", g.run_summa_gemm, (ni, nj, nk)),
                                ("ragged", g.run_ragged_summa_gemm, (ni + 1, nj + 1, nk + 1))):
            out = {}
            for db in (True, False):
                out[db], ref = run(ni=dims[0], nj=dims[1], nk=dims[2], grid=(1, 1),
                                   majors=majors, mesh=mesh11, double_buffer=db)
                np.testing.assert_allclose(out[db], ref, rtol=1e-3, atol=1e-3)
                calls[name] += 1
            if not np.array_equal(out[True], out[False]):
                raise AssertionError(f"{name} {majors}: double-buffered != blocking")
            phase("main_path", entry=run.__name__, majors=majors, dims=dims,
                  max_abs_err=float(np.abs(out[True] - ref).max()), db_equals_blocking=True)
    return calls


def profile_main_path(g, mesh1, mesh11) -> None:
    """Phase 4: the main path's device kernels, by name."""
    from torch.profiler import ProfilerActivity, profile

    ni, nj, nk = EXTRALARGE
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors="J/K/J", mesh=mesh1)
        g.run_summa_gemm(ni=ni, nj=nj, nk=nk, grid=(1, 1), majors="I/K/J", mesh=mesh11)
        g.run_ragged_summa_gemm(ni=ni + 1, nj=nj + 1, nk=nk + 1, grid=(1, 1), majors="J/I/K",
                                mesh=mesh11)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        raise AssertionError("the profiler recorded no device kernels")
    ours = [n for n in names if "layout_gemm" in n]
    library = [n for n in names if LIBRARY_GEMM.search(n) and "layout_gemm" not in n]
    if not any("layout_gemm_kernel" in n for n in ours):
        raise AssertionError(f"layout_gemm_kernel did not run; device kernels: {names}")
    if not any("layout_gemm_panel_kernel" in n for n in ours):
        raise AssertionError(f"layout_gemm_panel_kernel did not run; device kernels: {names}")
    if library:
        raise AssertionError(f"library GEMM kernels ran inside the main path: {library}")
    phase("kernel_proof", device_kernels=len(names), port_kernels=ours, library_gemms=library)


def library_gemm(a, b, majors: str) -> torch.Tensor:
    """One cuBLAS call for the same product in the output orientation
    (transposed operands as views, no copy)."""
    c_major, a_major, b_major = majors.split("/")
    al = a.T if a_major == "K" else a
    bl = b.T if b_major == "J" else b
    return torch.matmul(bl.T, al.T) if c_major == "J" else torch.matmul(al, bl)


def check_bound(name: str, row: dict) -> None:
    """A kernel time below the least time the card needs is a broken
    measurement: fail the run."""
    if row["ms"] < row["bound_ms"]:
        raise AssertionError(f"{name}: {row['ms']} ms is below its bound {row['bound_ms']} ms")


def gemm_times(kernel, plain, library) -> dict:
    """Device times of the kernel, its plain version and the library call
    (``None`` where no one call computes the function: its times are
    ``None``), and CUDA-event medians of the kernel's and the library's
    single calls (host work included)."""
    from repro_torch.kernels.timing import queued_ms

    return dict(ms=queued_ms(kernel), plain_ms=queued_ms(plain),
                library_ms=None if library is None else queued_ms(library),
                call_ms=median_ms(kernel),
                library_call_ms=None if library is None else median_ms(library))


def time_kernels(ops, card: str) -> dict:
    """Phase 5: times at the main path's shapes (all 8 majors at
    EXTRALARGE, the unaligned dims+1, the panel at both) and at 8192^3,
    beside the library."""
    rows = {}
    cases = [("EXTRALARGE", EXTRALARGE, majors) for majors in MAJORS]
    cases += [("unaligned", UNALIGNED, "I/I/K"), ("8192^3", (8192, 8192, 8192), "I/I/K")]
    for label, (m, n, k), majors in cases:
        a, b, _ = buffers(majors, m, n, k)
        row = gemm_times(lambda: ops.gemm(a, b, majors=majors),
                         lambda: ops.gemm(a, b, majors=majors, impl="ref"),
                         lambda: library_gemm(a, b, majors))
        b_ms, b_by, fp32_ms = bound(m, n, k, acc=False)
        row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms)
        check_bound(f"gemm {majors} {(m, n, k)}", row)
        if majors == "I/I/K":
            rows[("gemm", label)] = row
        phase("time", kernel="gemm", majors=majors, shape=(m, n, k), card=card,
              tflops=2 * m * n * k / row["ms"] / 1e9,
              matmul_tflops=2 * m * n * k / row["library_ms"] / 1e9,
              faster_than_matmul=row["ms"] < row["library_ms"], **row)
        del a, b
    # the SUMMA steps at the main path's shapes: grid 1x1, so one block of
    # width nj (the ragged SUMMA's at dims+1, through the strided TMA)
    for label, (m, n, k) in (("EXTRALARGE", EXTRALARGE), ("unaligned", UNALIGNED)):
        a, b, panel = buffers("I/I/K", m, n, k, nb=1)
        row = gemm_times(lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K"),
                         lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K", impl="ref"),
                         lambda: panel[:, 0:n].addmm_(a, b))
        b_ms, b_by, fp32_ms = bound(m, n, k, acc=True)
        row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms)
        check_bound(f"gemm_panel {(m, n, k)}", row)
        rows[("gemm_panel", label)] = row
        phase("time", kernel="gemm_panel", majors="I/I/K", shape=(m, n, k), nb=1, card=card,
              tflops=2 * m * n * k / row["ms"] / 1e9,
              faster_than_addmm=row["ms"] < row["library_ms"], **row)
    return rows


def bf16_buffers(majors: str, m: int, n: int, k: int, *, nb: int = 1, c_dtype=torch.bfloat16,
                 seed: int = 0):
    """:func:`buffers` with A and B in bf16 and the C-orientation buffer in
    ``c_dtype``."""
    a, b, c = buffers(majors, m, n, k, nb=nb, seed=seed)
    return a.to(torch.bfloat16), b.to(torch.bfloat16), c.to(c_dtype)


def check_gemm_bf16(ops, kernels) -> dict:
    """The bf16 GEMM kernels against their plain versions, in all 8 majors
    at EXTRALARGE (the TMA loader and store), at the ragged dims+1 (plain
    loads, direct stores) and at :data:`CLIPPED` (TMA loader and store, the
    store clipped at 8-wide edge tiles, an odd count of tile rows), each
    launch counted on the loader and the store expected: ``ops.gemm`` with
    and without acc (bf16 or float32) and both outputs
    (:data:`GEMM_BF16_CASES`), and ``ops.gemm_panel`` (nb = 2, bf16 and
    float32 panels, jb by value and from the device, the other block
    bitwise).  Each result against the plain version
    (:data:`GEMM_BF16_TOL`), against a float64 product (at most
    ACCURACY_RATIO times the plain version's error) and against a second
    launch (bitwise).  Then acc passed as the output buffer itself, on
    either store, bitwise the sum into a new buffer.  Returns the worst
    error against the plain version at EXTRALARGE by kernel."""
    worst = {"gemm_bf16": 0.0, "gemm_panel_bf16": 0.0}

    def held(name, got, want, exact, again) -> dict:
        torch.testing.assert_close(got, want, **GEMM_BF16_TOL[got.dtype])
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        errs = {"kernel": (got.double() - exact).abs().max().item(),
                "plain": (want.double() - exact).abs().max().item()}
        if errs["kernel"] > ACCURACY_RATIO * errs["plain"]:
            raise AssertionError(f"{name}: error against float64 over {ACCURACY_RATIO}x the "
                                 f"plain version's: {errs}")
        return dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                    error_vs_float64=errs, ratio=errs["kernel"] / errs["plain"])

    def counted(name, fn, path, store) -> None:
        if fn.launches_by_path[path] != 1 or fn.launches_by_store[store] != 1:
            raise AssertionError(f"{name}: expected the {path} loader and the {store} store, "
                                 f"got {fn.launches_by_path}, {fn.launches_by_store}")

    for (m, n, k), path, store in ((EXTRALARGE, "tma", "tma"), (UNALIGNED, "plain", "direct"),
                                   (CLIPPED, "tma", "tma")):
        rows = {}
        for majors in MAJORS:
            a, b, c = bf16_buffers(majors, m, n, k)
            exact = logical_f64(a, b, majors)
            for acc_dtype, out_dtype in GEMM_BF16_CASES:
                acc = None if acc_dtype is None else c.to(acc_dtype)
                run = lambda: ops.gemm(a, b, acc, majors=majors, out_dtype=out_dtype)  # noqa: E731
                kernels.reset_launches()
                got = run()
                label = f"{majors} acc={acc_dtype} out={got.dtype}"
                counted(f"gemm bf16 {label} {(m, n, k)}", kernels.gemm_bf16_cuda, path, store)
                want = ops.gemm(a, b, acc, majors=majors, out_dtype=out_dtype, impl="ref")
                torch.cuda.synchronize()
                rows[label] = held(f"gemm bf16 {label} {(m, n, k)}", got, want,
                                   exact if acc is None else exact + acc.double(), run())
            del a, b, c, exact
        if (m, n, k) == EXTRALARGE:
            worst["gemm_bf16"] = max(r["max_abs_err"] for r in rows.values())
        phase("kernel_check", kernel="gemm_bf16", shape=(m, n, k), loader=path, store=store,
              two_launches="bitwise", limit=ACCURACY_RATIO,
              max_ratio=max(r["ratio"] for r in rows.values()), cases=rows)
    nb = 2
    for (m, n, k), path, store in (
            ((EXTRALARGE[0], EXTRALARGE[1] // nb, EXTRALARGE[2]), "tma", "tma"),
            ((UNALIGNED[0], UNALIGNED[1] // nb + 1, UNALIGNED[2]), "plain", "direct"),
            (CLIPPED, "tma", "tma")):
        rows = {}
        for majors in MAJORS:
            for panel_dtype in (torch.bfloat16, torch.float32):
                a, b, panel = bf16_buffers(majors, m, n, k, nb=nb, c_dtype=panel_dtype)
                product = logical_f64(a, b, majors)
                for jb in range(nb):
                    blk = slice(jb * n, (jb + 1) * n)
                    keep = torch.ones_like(panel, dtype=torch.bool)
                    if majors.startswith("J"):
                        keep[blk, :] = False
                        block = lambda t: t[blk, :]  # noqa: E731
                    else:
                        keep[:, blk] = False
                        block = lambda t: t[:, blk]  # noqa: E731
                    exact = block(panel).double() + product
                    want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
                    for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device="cuda")):
                        where = "device" if isinstance(jb_arg, torch.Tensor) else "host"
                        label = f"{majors} {panel_dtype} jb={jb} {where}"
                        kernels.reset_launches()
                        got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
                        counted(f"gemm_panel bf16 {label} {(m, n, k)}",
                                kernels.gemm_panel_bf16_cuda, path, store)
                        again = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
                        torch.cuda.synchronize()
                        if not torch.equal(got[keep], panel[keep]):
                            raise AssertionError(f"gemm_panel bf16 {majors} jb={jb} touched "
                                                 "other blocks")
                        rows[label] = held(f"gemm_panel bf16 {label}", block(got), block(want),
                                           exact, block(again))
                del a, b, panel, product
        if (m, n, k) == (EXTRALARGE[0], EXTRALARGE[1] // nb, EXTRALARGE[2]):
            worst["gemm_panel_bf16"] = max(r["max_abs_err"] for r in rows.values())
        phase("kernel_check", kernel="gemm_panel_bf16", shape=(m, n, k, nb), loader=path,
              store=store, untouched_blocks="bitwise", two_launches="bitwise",
              limit=ACCURACY_RATIO, max_ratio=max(r["ratio"] for r in rows.values()), cases=rows)
    # acc as the output buffer itself (the entry point allows it; the
    # wrapper always writes a new buffer): the bits of the same sum
    lib = kernels.load_bf16_library()
    aliased = {}
    for (m, n, k), store in ((CLIPPED, "tma"), (UNALIGNED, "direct")):
        for majors in ("I/I/K", "J/K/J"):
            a_trans, b_trans, c_trans = kernels.parse_majors(majors)
            for dtype in (torch.bfloat16, torch.float32):
                a, b, c = bf16_buffers(majors, m, n, k, c_dtype=dtype)
                want = ops.gemm(a, b, c, majors=majors, out_dtype=dtype)
                loader = kernels.loader_path_bf16(m, n, k, majors, a.data_ptr(), b.data_ptr())
                got = kernels.store_path_bf16(m, n, majors, c.data_ptr(), c.element_size(),
                                              c.data_ptr(), c.element_size(), loader=loader)
                if got != store:
                    raise AssertionError(f"acc as output {majors} {(m, n, k)}: store {got}")
                bf16 = dtype == torch.bfloat16
                code = lib.layout_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                            c.data_ptr(), m, n, k, a_trans, b_trans, c_trans,
                                            bf16, bf16, kernels.BF16_LOADERS[loader],
                                            kernels.BF16_STORES[store],
                                            torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"layout_gemm_bf16 failed: cudaError {code}")
                torch.cuda.synchronize()
                if not torch.equal(c, want):
                    raise AssertionError(f"acc as output {majors} {(m, n, k)} {dtype}: not the "
                                         "bits of the sum into a new buffer")
                aliased[f"{majors} {(m, n, k)} {dtype}"] = store
                del a, b, c, want
    phase("kernel_check", kernel="gemm_bf16", case="acc is the output buffer", bitwise=aliased)
    torch.cuda.empty_cache()
    return worst


def library_gemm_f32(a, b, majors: str) -> torch.Tensor:
    """:func:`library_gemm` with a float32 output from bf16 operands (one
    cuBLAS call, ``out_dtype``)."""
    c_major, a_major, b_major = majors.split("/")
    al = a.T if a_major == "K" else a
    bl = b.T if b_major == "J" else b
    if c_major == "J":
        return torch.mm(bl.T, al.T, out_dtype=torch.float32)
    return torch.mm(al, bl, out_dtype=torch.float32)


def time_gemm_bf16(ops, kernels, card: str) -> dict:
    """Times of the bf16 GEMM kernels at EXTRALARGE beside their bf16
    bounds (:func:`bound` with ``dtype``), their plain versions and one
    cuBLAS call: ``ops.gemm`` to a bf16 output in all 8 majors (beside
    ``torch.matmul``) and to a float32 output (beside ``torch.mm`` with
    ``out_dtype``), and ``ops.gemm_panel`` on a bf16 panel of one block
    (beside ``addmm_``) and on a float32 panel (beside ``torch.addmm`` with
    ``out_dtype``: the same sum, float32, into a new tensor)."""
    m, n, k = EXTRALARGE
    rows = {}
    for majors in MAJORS:
        a, b, _ = bf16_buffers(majors, m, n, k)
        for out_dtype in (None, torch.float32):
            if out_dtype is not None and majors != "I/I/K":
                continue
            library = library_gemm if out_dtype is None else library_gemm_f32
            kernels.reset_launches()
            row = gemm_times(lambda: ops.gemm(a, b, majors=majors, out_dtype=out_dtype),
                             lambda: ops.gemm(a, b, majors=majors, out_dtype=out_dtype,
                                              impl="ref"),
                             lambda: library(a, b, majors))
            b_ms, b_by, fp32_ms = bound(m, n, k, acc=False, dtype=torch.bfloat16,
                                        out_bytes=2 if out_dtype is None else 4)
            row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms)
            check_bound(f"gemm bf16 {majors} out={out_dtype}", row)
            out = "bfloat16" if out_dtype is None else "float32"
            if majors == "I/I/K":
                rows[("gemm_bf16", out)] = row
            phase("time", kernel="gemm_bf16", majors=majors, shape=(m, n, k), out_dtype=out,
                  store=[s for s, c in kernels.gemm_bf16_cuda.launches_by_store.items() if c],
                  card=card, tflops=2 * m * n * k / row["ms"] / 1e9,
                  library_tflops=2 * m * n * k / row["library_ms"] / 1e9, **row)
        del a, b
    for panel_dtype in (torch.bfloat16, torch.float32):
        a, b, panel = bf16_buffers("I/I/K", m, n, k, nb=1, c_dtype=panel_dtype)
        if panel_dtype == torch.bfloat16:
            library = lambda: panel[:, 0:n].addmm_(a, b)  # noqa: E731
        else:
            library = lambda: torch.addmm(panel[:, 0:n], a, b, out_dtype=torch.float32)  # noqa: E731
        kernels.reset_launches()
        row = gemm_times(lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K"),
                         lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K", impl="ref"),
                         library)
        width = torch.finfo(panel_dtype).bits // 8
        b_ms, b_by, fp32_ms = bound(m, n, k, acc=True, dtype=torch.bfloat16, out_bytes=width,
                                    acc_bytes=width)
        row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms)
        check_bound(f"gemm_panel bf16 panel={panel_dtype}", row)
        rows[("gemm_panel_bf16", str(panel_dtype).split(".")[1])] = row
        phase("time", kernel="gemm_panel_bf16", majors="I/I/K", shape=(m, n, k), nb=1,
              panel_dtype=str(panel_dtype),
              store=[s for s, c in kernels.gemm_panel_bf16_cuda.launches_by_store.items() if c],
              card=card, tflops=2 * m * n * k / row["ms"] / 1e9,
              **row)
        del a, b, panel
    torch.cuda.empty_cache()
    return rows


def randn(shape, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, device=DEVICE, generator=g).to(dtype)


def attn_bound(flops: float, nbytes: float, *, products: int = 2,
               pv_flops: float | None = None) -> tuple[float, str, float]:
    """Least time for attention work of ``flops`` operations in the
    reference's two float32 products (q k^T and p @ v; p @ v's share is
    ``pv_flops``, by default ``flops / 2``: v with q's head dim) and
    ``nbytes`` bytes: the bf16 kernels run q k^T once and p @ v once per
    piece of p (``products - 1`` pieces) on the tensor cores, over the bf16
    peak, or the bytes over the memory rate, whichever is larger; and,
    beside it, the float32 CUDA-core bound (``flops`` over the float32
    peak, or the bytes)."""
    pv = flops / 2 if pv_flops is None else pv_flops
    t_ops, t_bytes = (flops + (products - 2) * pv) / BF16_PEAK, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            max(flops / FP32_PEAK, t_bytes) * 1e3)


def decode_inputs(B, Hq, G, S, T, D, dtype, *, lens, start=None, seed=20, Dv=None):
    """q, caches (v ``Dv`` wide, by default D), lengths and (with ``start``)
    per-row chunk positions."""
    q = randn((B, Hq, S, D), dtype, seed)
    kc, vc = randn((B, G, T, D), dtype, seed + 1), randn((B, G, T, Dv or D), dtype, seed + 2)
    lens = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    pos = None
    if start is not None:
        start = torch.tensor(start, dtype=torch.int32, device=DEVICE)
        pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=DEVICE)[None, :]
    return q, kc, vc, lens, pos


def rounding_margins(ops, got, want, q, kc, vc, lens, pos, live) -> dict:
    """bf16 decode: the one rule the tolerance cannot see, each KV block's
    probabilities rounded to bf16 against that block's own max.  Rounding
    moves the outputs by less than a bf16 ulp, so the check is on the mean
    |difference| over the live rows: the kernel's from its plain version
    must be under a quarter of its difference from two versions that break
    the rule, one that does not round (float32 caches) and one that rounds
    against the max over the whole cache (a single block)."""
    def mean(other):
        return (got[live].float() - other[live].float()).abs().mean().item()

    T = kc.shape[2]
    out = {"plain": mean(want),
           "unrounded": mean(ops.flash_decode(q, kc.float(), vc.float(), lens, q_positions=pos,
                                              block=512, impl="ref")),
           "one_block": mean(ops.flash_decode(q, kc, vc, lens, q_positions=pos, block=T,
                                              impl="ref"))}
    if not 4 * out["plain"] < min(out["unrounded"], out["one_block"]):
        raise AssertionError(f"flash_decode does not round each block against its own max: "
                             f"mean |difference| {out}")
    return out


def check_attention_kernels(ops) -> dict:
    """The attention kernels against their plain versions on the card, at
    the path's shapes and at ragged and odd ones."""
    worst = {}
    both = (torch.bfloat16, torch.float32)
    for label, (B, Hq, G, S, D), causal in (("forward", (1, 24, 8, SEQ, 128), True),
                                            ("ragged", (1, 24, 8, 1000, 128), True),
                                            ("ragged", (1, 24, 8, 1000, 128), False),
                                            ("small_odd", (2, 6, 2, 77, 64), True)):
        for dt in both:
            q, k, v = (randn(shape, dt, 10 + i) for i, shape in
                       enumerate(((B, Hq, S, D), (B, G, S, D), (B, G, S, D))))
            got = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
            torch.testing.assert_close(got, want, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
            err = (got.float() - want.float()).abs().max().item()
            if label == "forward" and dt == torch.bfloat16:
                worst["flash_attention"] = err
            phase("kernel_check", kernel="flash_attention", case=label, shape=(B, Hq, G, S, D),
                  causal=causal, dtype=str(dt), max_abs_err=err, tol=ATTN_TOL[dt])
            del q, k, v, got, want
    # decode step; prefill chunk (two prompts from 0, a resident slot, an
    # idle one); a cache length T that the 512-key blocks do not divide
    for label, dims, lens, start in (
            ("decode", (4, 24, 8, 1, MAX_LEN, 128), DECODE_LENS, None),
            ("prefill_chunk", (4, 24, 8, 2048, MAX_LEN, 128), (2047, 1000, 300, 0),
             (0, 0, 300, 0)),
            ("T_not_divided", (4, 24, 8, 1, 4000, 128), (4000, 3999, 512, 1), None)):
        for dt in both:
            q, kc, vc, lens_t, pos = decode_inputs(*dims, dt, lens=lens, start=start)
            got = ops.flash_decode(q, kc, vc, lens_t, q_positions=pos, block=512)
            torch.cuda.synchronize()
            want = ops.flash_decode(q, kc, vc, lens_t, q_positions=pos, block=512, impl="ref")
            # every row, the idle slot's too (no visible key: the mean of v)
            torch.testing.assert_close(got, want, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
            err = (got.float() - want.float()).abs().max().item()
            margins = None
            if dt == torch.bfloat16:
                # the rounding rule shows only on rows that see keys
                margins = rounding_margins(ops, got, want, q, kc, vc, lens_t, pos, lens_t > 0)
                if label == "decode":
                    worst["flash_decode"] = err
            phase("kernel_check", kernel="flash_decode", case=label, shape=dims, lens=lens,
                  dtype=str(dt), max_abs_err=err, tol=ATTN_TOL[dt],
                  idle_rows=int((lens_t == 0).sum()), mean_abs_diff_from=margins)
            del q, kc, vc, got, want
    return worst


def forward_full_width(cfg, params, lm, fa) -> dict:
    """The full-width forward of 4096 seeded tokens through the kernel, held
    against the same forward through the plain version."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)
    batch = {"tokens": tokens}
    fa.flash_attention_cuda.launches = 0
    logits, _ = lm.forward(params, batch, cfg)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_attention launches {launches} != {cfg.n_layers} layers")
    if logits.shape != (1, SEQ, cfg.vocab_padded) or not torch.isfinite(logits).all():
        raise AssertionError(f"forward logits {tuple(logits.shape)} not finite/expected shape")
    last = logits[0, -1, :cfg.vocab].float()
    del logits
    forward_ms = median_ms(lambda: lm.forward(params, batch, cfg), iters=5, warmup=1)
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    ref_last = lm.forward(params, batch, ref_cfg)[0][0, -1, :cfg.vocab].float()
    err = (last - ref_last).abs().max().item()
    if err > LOGIT_TOL:
        raise AssertionError(f"last-position logits kernel vs plain: {err} > {LOGIT_TOL}")
    out = dict(tokens=SEQ, launches=launches, forward_ms=forward_ms, last_logits_max_abs_err=err,
               tol=LOGIT_TOL, logit_scale=ref_last.abs().max().item(),
               argmax_equal=bool(last.argmax() == ref_last.argmax()))
    phase("forward", arch=cfg.name, **out)
    return out


# a predicted peak agrees with the card's within 3% or 256 MiB, whichever is larger
DRYRUN_PEAK_RTOL, DRYRUN_PEAK_ATOL = 0.03, 256 << 20


def dryrun_trace(program, make_inputs):
    """The dry run's trace of ``program`` (``repro_torch.launch.dryrun``):
    one rank of a fake world of one, on fake tensors of the card's shapes
    from ``make_inputs(device)``, walked op by op; returns its op stats and
    the trace's seconds.  Nothing is allocated on the card."""
    import torch.distributed as dist

    from repro_torch.core import init_fake_world
    from repro_torch.kernels.fake import card_trace
    from repro_torch.launch.op_walk import OpWalk

    t0 = time.perf_counter()
    init_fake_world(1, 0, DEVICE)
    try:
        mode, dev = card_trace(DEVICE)
        with mode:
            inputs = make_inputs(dev)
            with OpWalk() as walk:
                out = program(*inputs)
            del out, inputs
    finally:
        dist.destroy_process_group()
    return walk.stats(), time.perf_counter() - t0


def dryrun_compare(name: str, st, trace_s: float, program, inputs, launch_counts) -> dict:
    """``dryrun_check`` of one program: its trace's predicted peak memory
    (above what is live at its start), kernel launches by kernel and
    compute/memory roofline terms against one run on the card (after one
    warm-up run: the allocator and cuBLAS map their memory once):
    ``max_memory_allocated`` after ``reset_peak_memory_stats`` less what was
    allocated before, the wrappers' launch counts, and the device ms of one
    more run (``queued_ms``).  Fails on a peak off by more than 3% or 256
    MiB, a launch count that differs, or device ms below ``t_compute``."""
    from repro_torch.kernels.timing import queued_ms
    from repro_torch.launch import roofline

    out = program(*inputs)  # warm-up
    del out
    torch.cuda.synchronize()
    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = program(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    launches = launch_counts()
    del out
    torch.cuda.empty_cache()
    device_ms = queued_ms(lambda: program(*inputs), iters=1, reps=1, warmup=0)
    t_compute_ms, t_memory_ms = st.compute_seconds * 1e3, st.bytes / roofline.HW["hbm_bw"] * 1e3
    predicted = {k: v for k, v in st.kernel_launches.items() if v}
    tol = max(DRYRUN_PEAK_RTOL * peak, DRYRUN_PEAK_ATOL)
    row = dict(program=name, predicted_peak_gb=st.peak_live_bytes / 1e9,
               measured_peak_gb=peak / 1e9, peak_diff_gb=(st.peak_live_bytes - peak) / 1e9,
               peak_tol_gb=tol / 1e9, predicted_launches=predicted, launches=launches,
               t_compute_ms=t_compute_ms, t_memory_ms=t_memory_ms, device_ms=device_ms,
               flops=st.flops, bytes=st.bytes, ops=st.n_ops, trace_s=trace_s,
               total_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    phase("dryrun_check", **row)
    if abs(st.peak_live_bytes - peak) > tol:
        raise AssertionError(f"dryrun_check {name}: predicted peak {st.peak_live_bytes} B vs "
                             f"the card's {peak} B (tolerance {tol:.0f} B)")
    if predicted != launches:
        raise AssertionError(f"dryrun_check {name}: predicted launches {predicted} != the "
                             f"card's {launches}")
    if device_ms < t_compute_ms:
        raise AssertionError(f"dryrun_check {name}: device {device_ms} ms below the "
                             f"predicted compute term {t_compute_ms} ms")
    return row


def kernel_launches(fa, fd, kernels, relayout):
    """``launch_counts`` for :func:`dryrun_compare`: every kernel wrapper's
    ``launches`` by the name the walk records, the ones made since the
    last ``reset`` (the counts themselves are left as they are)."""
    fns = {"flash_attention_kernel": fa.flash_attention_cuda,
           "flash_attention_carry_kernel": fa.flash_attention_carry_cuda,
           "flash_decode_kernel": fd.flash_decode_cuda,
           "layout_gemm_kernel": kernels.gemm_cuda,
           "layout_gemm_panel_kernel": kernels.gemm_panel_cuda,
           "layout_gemm_bf16_kernel": kernels.gemm_bf16_cuda,
           "layout_gemm_panel_bf16_kernel": kernels.gemm_panel_bf16_cuda,
           "transpose_kernel": relayout.transpose_cuda}
    start: dict = {}

    def counts(reset: bool = False):
        if reset:
            start.update({k: fn.launches for k, fn in fns.items()})
            return None
        made = {k: fn.launches - start[k] for k, fn in fns.items()}
        return {k: n for k, n in made.items() if n}
    return counts


def dryrun_forward(cfg, params, lm, launch_counts, cast_params) -> dict:
    """``dryrun_check`` for the forward phase's program: ``lm.forward`` of
    1 x SEQ tokens at full width on bf16 weights."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}

    def program(p, b):
        return lm.forward(p, b, cfg)

    def inputs(dev):
        return (cast_params(lm.abstract_model(cfg, device=dev), cfg.act_dtype),
                {"tokens": torch.empty((1, SEQ), dtype=torch.int64, device=dev)})

    st, trace_s = dryrun_trace(program, inputs)
    return dryrun_compare("forward", st, trace_s, program, (params, batch), launch_counts)


def dryrun_train(cfg, params, batch, launch_counts, lm, trainer, optimizer) -> dict:
    """``dryrun_check`` for the training phase's step: ``make_train_step``
    (TRAIN_MICROBATCHES microbatches, AdamW) on its parameters and batch."""
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    step = trainer.make_train_step(cfg, None, ocfg, microbatches=TRAIN_MICROBATCHES)

    def inputs(dev):
        fake = lm.abstract_model(cfg, device=dev)
        return (fake, optimizer.init_opt_state(fake, ocfg),
                {k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v in batch.items()})

    st, trace_s = dryrun_trace(step, inputs)
    opt = optimizer.init_opt_state(params, ocfg)
    row = dryrun_compare("train_step", st, trace_s, step, (params, opt, batch), launch_counts)
    del opt
    torch.cuda.empty_cache()
    return row


def dryrun_formulas() -> dict:
    """The package's work formulas (``kernels/work.py``, what the kernel
    wrappers report under fake tensors, and ``launch/roofline.py``'s GEMM
    bound) against this script's ``bound`` and
    ``attn_bound`` at the shapes PERF.md's kernel table times: the GEMMs,
    decode and ring steps equal, the causal forward within its pair count
    (S (S + 1) / 2 against S^2 / 2)."""
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention import P_PIECES
    from repro_torch.launch import roofline as rl

    rows = {}
    for label, (m, n, k), kw in (("gemm", EXTRALARGE, {}), ("gemm_unaligned", UNALIGNED, {}),
                                 ("gemm_bf16", EXTRALARGE,
                                  dict(dtype=torch.bfloat16, out_bytes=2)),
                                 ("gemm_panel", EXTRALARGE, dict(acc=True))):
        kw = {"acc": False, **kw}
        rows[label] = (rl.gemm_bound(m, n, k, **kw)[0], bound(m, n, k, **kw)[0])
    B, Hq, G, D = 1, 24, 8, 128
    flops, nbytes, secs = work.flash_attention_work(B, Hq, G, SEQ, SEQ, D, D, causal=True,
                                                    dtype=torch.bfloat16, pieces=P_PIECES)
    rows["flash_attention"] = (max(secs, nbytes / rl.HW["hbm_bw"]) * 1e3, attn_bound(
        4 * B * Hq * SEQ * SEQ * D / 2, 2 * (2 * B * Hq * SEQ * D + 2 * B * G * SEQ * D),
        products=1 + P_PIECES)[0])
    lens = DECODE_LENS
    visible, keys = sum(min(n, MAX_LEN) for n in lens), sum(min(n, MAX_LEN) for n in lens)
    flops, nbytes, secs = work.flash_decode_work(len(lens), Hq, G, 1, visible, keys, D, D,
                                                 dtype=torch.bfloat16)
    rows["flash_decode"] = (max(secs, nbytes / rl.HW["hbm_bw"]) * 1e3, attn_bound(
        4 * Hq * visible * D, 2 * 2 * G * D * keys + 2 * 2 * len(lens) * Hq * D)[0])
    cap = SEQ // RING_R
    for label, step in (("carry_diagonal", 0), ("carry_off_diagonal", 1)):
        q_off, k_off = cap, (1 - step) % RING_R * cap
        flops, nbytes, secs = work.flash_carry_work(
            1, Hq, G, cap, cap, D, D, q_offset=q_off, k_offset=k_off, valid_len=None,
            causal=True, dtype=torch.bfloat16, pieces=P_PIECES)
        pairs = cap * (cap + 1) // 2 if step == 0 else cap * cap
        mine = 2 * (Hq * cap * D + 2 * G * cap * D) + 2 * 4 * (Hq * cap * D + 2 * Hq * cap)
        rows[label] = (max(secs, nbytes / rl.HW["hbm_bw"]) * 1e3,
                       attn_bound(4 * Hq * pairs * D, mine, products=1 + P_PIECES)[0])
    worst = max(abs(a - b) / b for a, b in rows.values())
    phase("dryrun_formulas", bound_ms={k: dict(package=a, script=b) for k, (a, b) in rows.items()},
          max_rel_diff=worst)
    if worst > 1e-3:
        raise AssertionError(f"the package's work formulas differ from bound/attn_bound: {rows}")
    return rows


def _instrument(engine, record_gaps: bool, fd):
    """Wrap the engine's step: device-synchronized seconds per step kind,
    ``flash_decode`` launches per step kind (from the wrapper's counter),
    the ledger's peak occupancy, the first prefill chunk's logits of each
    prefilled slot at its last fed position (``{slot: (V,)}``) and
    (``record_gaps``) the top-2 logit gap of every generated token, keyed by
    (request, token index)."""
    stats = {"prefill_s": 0.0, "decode_s": 0.0, "peak_occupancy": 0.0, "gaps": {},
             "first_prefill": None, "launches": {"prefill": 0, "decode": 0}}
    step = engine._step

    def timed(tokens, counts, *, prefill, **kw):
        owners = {i: (s.request_id, len(s.tokens)) for i, s in enumerate(engine.slots)
                  if s.request_id is not None}
        torch.cuda.synchronize()
        before = fd.flash_decode_cuda.launches
        t0 = time.perf_counter()
        logits = step(tokens, counts, prefill=prefill, **kw)
        torch.cuda.synchronize()
        stats["prefill_s" if prefill else "decode_s"] += time.perf_counter() - t0
        stats["launches"]["prefill" if prefill else "decode"] += \
            fd.flash_decode_cuda.launches - before
        stats["peak_occupancy"] = max(stats["peak_occupancy"], engine.ledger.valid_fraction())
        if prefill and stats["first_prefill"] is None:
            last = engine.last_logits(logits, counts, prefill=True)
            stats["first_prefill"] = {i: last[i].clone()
                                      for i, n in enumerate(counts.tolist()) if n > 0}
        if record_gaps and not prefill:
            last = engine.last_logits(logits, counts, prefill=False)
            top2 = last[:, :engine.cfg.vocab].float().topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            for i, key in owners.items():
                stats["gaps"][key] = gaps[i]
        return logits

    engine._step = timed
    return stats


def serve_prompts(cfg) -> list[list[int]]:
    """The serving run's seeded prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab, size=int(rng.integers(*PROMPT_LENS))).tolist()
            for _ in range(REQUESTS)]


def serve_full_width(cfg, params, Engine, ServeConfig, fd) -> tuple[dict, dict]:
    """8 requests (seeded prompts of 128-2048 tokens, 32 new tokens each) on
    4 slots at max_len 4096, through the kernel and through the plain
    version; greedy tokens compared where the plain run is not a near tie.
    Returns the phase's numbers and the kernel run (its outputs, top-2 gaps
    and step stats: what the TP serving run is held against)."""
    requests = serve_prompts(cfg)
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)
    runs = {}
    for impl in ("cuda", "ref"):
        engine = Engine(dataclasses.replace(cfg, attn_impl=impl), params, scfg)
        stats = _instrument(engine, record_gaps=True, fd=fd)
        for rid, prompt in enumerate(requests):
            engine.submit(rid, prompt, NEW_TOKENS)
        fd.flash_decode_cuda.launches = 0
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fd.flash_decode_cuda.launches
        if sorted(done) != list(range(REQUESTS)) or any(
                len(done[r]) != len(requests[r]) + NEW_TOKENS for r in range(REQUESTS)):
            raise AssertionError(f"{impl}: not every request finished with {NEW_TOKENS} tokens")
        expected = cfg.n_layers * (engine.steps["prefill"] + engine.steps["decode"]) \
            if impl == "cuda" else 0
        if launches != expected:
            raise AssertionError(f"{impl}: flash_decode launches {launches} != {expected}")
        by_kind = {kind: cfg.n_layers * engine.steps[kind] if impl == "cuda" else 0
                   for kind in ("prefill", "decode")}
        if stats["launches"] != by_kind:
            raise AssertionError(f"{impl}: flash_decode launches by step kind "
                                 f"{stats['launches']} != {by_kind}")
        runs[impl] = dict(done=done, stats=stats, steps=dict(engine.steps), wall=wall,
                          launches=launches, prefill=stats["first_prefill"])
        del engine
        torch.cuda.empty_cache()
    k, p = runs["cuda"], runs["ref"]
    prefill_err = max((k["prefill"][i] - p["prefill"][i]).float().abs().max().item()
                      for i in p["prefill"])
    if prefill_err > LOGIT_TOL:
        raise AssertionError(f"first prefill logits kernel vs plain: {prefill_err} > {LOGIT_TOL}")
    agree, near_ties = greedy_agreement(requests, k["done"], p["done"], p["stats"]["gaps"],
                                        "kernel", "plain")
    st = k["stats"]
    out = dict(requests=REQUESTS, slots=SLOTS, max_len=MAX_LEN, new_tokens=NEW_TOKENS,
               prompt_lens=[len(r) for r in requests], steps=k["steps"],
               flash_decode_launches=k["launches"],
               flash_decode_launches_by_kind=st["launches"], prefill_s=st["prefill_s"],
               decode_s=st["decode_s"], decode_tok_s=REQUESTS * NEW_TOKENS / st["decode_s"],
               wall_s=k["wall"], peak_kv_occupancy=st["peak_occupancy"],
               plain_wall_s=p["wall"], first_prefill_logits_max_abs_err=prefill_err,
               tol=LOGIT_TOL, greedy_agreement=agree, divergences_at_near_ties=near_ties)
    phase("serve", arch=cfg.name, **out)
    return out, k


def greedy_agreement(requests, got, want, gaps, got_name: str, want_name: str, *,
                     new_tokens: int = NEW_TOKENS):
    """Share of generated tokens of ``got`` equal to ``want``'s, request for
    request up to the first divergence, and the divergences: each must fall
    where ``want``'s top-2 logit gap is at most LOGIT_TOL (a near tie), else
    the run fails.  Past a divergence the two runs continue different texts."""
    agree, near_ties = 0, []
    for rid, prompt in enumerate(requests):
        for j, (a, b) in enumerate(zip(got[rid][len(prompt):], want[rid][len(prompt):])):
            if a == b:
                agree += 1
                continue
            gap = gaps[(rid, len(prompt) + j)]
            if gap > LOGIT_TOL:
                raise AssertionError(f"request {rid} token {j}: {got_name} {a} vs {want_name} "
                                     f"{b} with a {want_name} top-2 gap of {gap} > {LOGIT_TOL}")
            near_ties.append({"request": rid, "token": j, f"{want_name}_top2_gap": gap})
            break
    return agree / (len(requests) * new_tokens), near_ties


def profile_lm(cfg, params, lm, Engine, ServeConfig) -> None:
    """One short forward and a few engine steps under the profiler: both
    attention kernels ran, and no library attention kernel."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.arange(2, 514, device=DEVICE)[None, :]
    engine = Engine(cfg, params, ServeConfig(max_len=512, batch_slots=2, eos_token=-1))
    engine.submit(0, list(range(2, 130)), 3)
    engine.submit(1, list(range(7, 40)), 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm.forward(params, {"tokens": tokens}, cfg)
        engine.run()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    ours = [n for n in names if any(k in n for k in PORT_ATTN)]
    library = [n for n in names if LIBRARY_ATTN.search(n) and not any(k in n for k in PORT_ATTN)]
    for kernel in ("flash_attention_kernel", "flash_decode_kernel"):
        if not any(kernel in n for n in ours):
            raise AssertionError(f"{kernel} did not run; device kernels: {names}")
    if library:
        raise AssertionError(f"library attention kernels ran: {library}")
    phase("lm_kernel_proof", device_kernels=len(names), port_kernels=ours,
          library_attention=library)


def by_kind(times: dict[str, float]) -> dict[str, float]:
    """Device ms split into the port's attention kernels, library GEMMs (the
    projections and the head) and everything else."""
    out = {"attention_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in times.items():
        kind = ("attention_kernels" if any(k in name for k in PORT_ATTN)
                else "gemm" if GEMM_NAMES.search(name) else "other")
        out[kind] += ms
    return out


def window(fn, n: int, classify=None) -> dict:
    """``n`` calls of ``fn`` once unprofiled (the host clock per call) and
    once under the profiler (device time per call, by kind and by kernel,
    kernels launched, and the device's idle share of the host time).  The
    kinds are :func:`by_kind`'s, or ``classify(profile)``'s."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = device_kernel_ms(prof)
    launches = len(device_kernels(prof))
    ours = sorted({name for name in times if any(k in name for k in PORT_ATTN)})
    library = sorted({name for name in times
                      if LIBRARY_ATTN.search(name) and not any(k in name for k in PORT_ATTN)})
    busy = sum(times.values()) / n
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall, device_ms=busy, idle_share=1 - busy / wall,
                kernels_launched=launches / n,
                device_ms_by_kind={k: v / n for k, v in
                                   (classify(prof) if classify else by_kind(times)).items()},
                top_kernels=[(name[:80], ms / n) for name, ms in top], port_kernels=ours,
                library_attention=library)


def breakdown_lm(cfg, params, lm, Engine, ServeConfig) -> dict:
    """Where the time goes at full width: for one forward of 4096 tokens and
    for steady decode steps of the serving run's first batch, the host-clock
    time of a step, the device time by kind, the kernels launched and the
    device's idle share (:func:`window`).  Returns the decode window."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)
    fwd = window(lambda: lm.forward(params, {"tokens": tokens}, cfg), 2)
    phase("breakdown", arch=cfg.name, window="forward", tokens=SEQ, **fwd)
    return decode_window(cfg, params, Engine, ServeConfig, 8)


def decode_window(cfg, params, Engine, ServeConfig, steps: int) -> dict:
    """``steps`` steady decode steps of the serving run's first SLOTS
    requests, after their prefill chunk and one decode step
    (:func:`window`)."""
    engine = Engine(cfg, params, ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1))
    for rid, prompt in enumerate(serve_prompts(cfg)[:SLOTS]):
        engine.submit(rid, prompt, NEW_TOKENS)
    engine._fill_slots()  # the prefill chunk, outside the windows
    engine._decode_once()
    dec = window(engine._decode_once, steps)
    phase("breakdown", arch=cfg.name, window="decode_step", slots=SLOTS,
          cache_lens=list(engine.ledger.lengths), **dec)
    del engine
    torch.cuda.empty_cache()
    return dec


def recipe_forward(cfg, params, lm, fa, mesh, sharding, shard_params_by_recipe) -> dict:
    """``recipe_forward``: the forward of the forward phase's 1 x SEQ tokens
    under ``make_recipe(cfg, mesh, attn_mode=...)`` on a one-rank NCCL
    ``(data, model)`` mesh, ``auto`` (``tp``: the heads divide one rank) and
    ``sp``, on the rank's shards of the weights (views: every axis has one
    rank): ``flash_attention`` launched once a layer, logits at every token
    within LOGIT_TOL of the no-recipe forward (and whether bitwise), and
    the host and device ms, idle share and kernels launched of a forward
    (:func:`window`), in turns with the no-recipe forward's (no recipe,
    ``auto``, ``sp``, no recipe: host times drift between phases)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}
    want = lm.forward(params, batch, cfg)[0]
    specs = lm.build_specs(cfg)
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched")
    plain = [window(lambda: lm.forward(params, batch, cfg), 2)]
    out = {}
    for mode in ("auto", "sp"):
        recipe = sharding.make_recipe(cfg, mesh, attn_mode=mode)
        shards = shard_params_by_recipe(params, specs, recipe)
        fa.flash_attention_cuda.launches = 0
        with sharding.use_recipe(recipe):
            mine = sharding.local_batch(recipe, batch)
            got = lm.gather_logits(lm.forward(shards, mine, cfg)[0], recipe, 1)
        torch.cuda.synchronize()
        launches = fa.flash_attention_cuda.launches
        if launches != cfg.n_layers:
            raise AssertionError(f"recipe forward {mode}: flash_attention launches {launches} "
                                 f"!= {cfg.n_layers}")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"recipe forward {mode}: logits {tuple(got.shape)} not finite "
                                 "or not the expected shape")
        err = (got - want).abs().max().item()
        bitwise = torch.equal(got, want)
        del got
        if err > LOGIT_TOL:
            raise AssertionError(f"recipe forward {mode} vs no recipe: {err} > {LOGIT_TOL}")

        def fwd(shards=shards, recipe=recipe):
            with sharding.use_recipe(recipe):
                lm.forward(shards, sharding.local_batch(recipe, batch), cfg)

        out[recipe.attn_mode] = dict(
            mode=mode, flash_attention_launches=launches, logits_max_abs_err=err,
            bitwise_equal_no_recipe=bitwise, tol=LOGIT_TOL, forward=window(fwd, 2))
    plain.append(window(lambda: lm.forward(params, batch, cfg), 2))
    for attn_mode, row in out.items():
        row["kernels_launched_vs_no_recipe"] = row["forward"]["kernels_launched"] - \
            plain[0]["kernels_launched"]
        phase("recipe_forward", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl",
              attn_mode=attn_mode, tokens=SEQ,
              no_recipe_forward=[{k: w[k] for k in keys} for w in plain], **row)
    del want
    torch.cuda.empty_cache()
    return out


def recipe_serve(cfg, params, lm, Engine, ServeConfig, fd, mesh, sharding,
                 shard_params_by_recipe, single: dict) -> dict:
    """``recipe_serve``: the serving run's 8 requests on 4 slots through
    ``Engine(recipe=make_recipe(cfg, mesh))`` (``tp``) on a one-rank NCCL
    mesh, on the rank's shards: every request finishes, ``flash_decode``
    launches once a layer in every prefill chunk and decode step, and the
    greedy tokens equal the single-host kernel run's (``single``) except at
    its near ties.  Then a steady decode step's host and device ms, idle
    share and kernels launched (:func:`window`) in turns with the
    single-host engine's on the same requests (single host, recipe,
    recipe, single host): on one rank the recipe's gathers and reductions
    move nothing and launch nothing."""
    requests = serve_prompts(cfg)
    recipe = sharding.make_recipe(cfg, mesh)
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)

    def engine_for(prompts, recipe=recipe):
        engine = Engine(cfg, params if recipe is None else shards,
                        ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1),
                        recipe=recipe)
        for rid, prompt in enumerate(prompts):
            engine.submit(rid, prompt, NEW_TOKENS)
        return engine

    engine = engine_for(requests)
    stats = _instrument(engine, record_gaps=False, fd=fd)
    fd.flash_decode_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.flash_decode_cuda.launches
    if sorted(done) != list(range(REQUESTS)) or any(
            len(done[r]) != len(requests[r]) + NEW_TOKENS for r in range(REQUESTS)):
        raise AssertionError(f"recipe_serve: not every request finished with {NEW_TOKENS} "
                             "tokens")
    by_kind = {kind: cfg.n_layers * engine.steps[kind] for kind in ("prefill", "decode")}
    if stats["launches"] != by_kind or launches != sum(by_kind.values()):
        raise AssertionError(f"recipe_serve: flash_decode launches {stats['launches']} (total "
                             f"{launches}) != {by_kind}")
    agree, near_ties = greedy_agreement(requests, done, single["done"], single["stats"]["gaps"],
                                        "recipe", "single_host")
    steps = dict(engine.steps)
    del engine
    torch.cuda.empty_cache()
    engines = {"single_host": engine_for(requests[:SLOTS], None),
               "recipe": engine_for(requests[:SLOTS])}
    for engine in engines.values():
        engine._fill_slots()
        engine._decode_once()
    wins = {name: [] for name in engines}
    for name in ("single_host", "recipe", "recipe", "single_host"):
        wins[name].append(window(engines[name]._decode_once, RECIPE_DECODE_STEPS))
    del engines
    torch.cuda.empty_cache()
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched")
    out = dict(mesh=dict(mesh.shape), attn_mode=recipe.attn_mode, requests=REQUESTS,
               slots=SLOTS, max_len=MAX_LEN, new_tokens=NEW_TOKENS, steps=steps,
               flash_decode_launches=launches, flash_decode_launches_by_kind=stats["launches"],
               prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
               decode_tok_s=REQUESTS * NEW_TOKENS / stats["decode_s"], wall_s=wall,
               decode_step=[{k: w[k] for k in keys} for w in wins["recipe"]],
               single_host_decode_step=[{k: w[k] for k in keys} for w in wins["single_host"]],
               kernels_launched_vs_single_host=wins["recipe"][0]["kernels_launched"] -
               wins["single_host"][0]["kernels_launched"],
               greedy_agreement_with_single_host=agree, divergences_at_near_ties=near_ties,
               tol=LOGIT_TOL)
    phase("recipe_serve", arch=cfg.name, backend="nccl", **out)
    return out


def recipe_tp_serve(cfg, params, lm, Engine, ServeConfig, fd, mesh, sharding,
                    shard_params_by_recipe, tree_leaves, tp: dict, tp_done: dict) -> dict:
    """``recipe_tp_serve``: the serving run's 8 requests on 4 slots through
    ``Engine(recipe=make_recipe(cfg, mesh), mesh=mesh, microbatches=2)`` on
    a one-rank NCCL ``(data, model)`` mesh and the rank's shards: prefill
    under the recipe, decode through the explicit TP step, both on the
    recipe's cache blocks.  Fails unless every request finishes,
    ``flash_decode`` launches ``n_layers`` times a prefill chunk and
    ``n_layers x microbatches`` times a decode step, the greedy tokens equal
    the ``tp_serve`` run's (``tp_done``) exactly (on one rank the recipe's
    prefill is the program without a recipe), and the TP step's weights are
    views of the shards (no second copy on one rank).  Prints prefill s,
    decode tok/s and wall s beside ``tp_serve``'s (``tp``), what building
    the engine added to the card's memory (its K/V and nothing else) and
    the card's peak GB."""
    requests = serve_prompts(cfg)
    recipe = sharding.make_recipe(cfg, mesh)
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engine = Engine(cfg, shards, ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1),
                    recipe=recipe, mesh=mesh, microbatches=TP_MICROBATCHES)
    built_gb = (torch.cuda.memory_allocated() - before) / 1e9
    build_peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    kv_gb = sum(t.numel() * t.element_size() for t in engine.state.caches) / 1e9
    views = all(a.data_ptr() == b.data_ptr() for a, b in
                zip(tree_leaves(engine.tp_params), tree_leaves(engine.params), strict=True))
    if not views:
        raise AssertionError("recipe_tp_serve: the TP weights are not views of the shards")
    for rid, prompt in enumerate(requests):
        engine.submit(rid, prompt, NEW_TOKENS)
    stats = _instrument(engine, record_gaps=False, fd=fd)
    fd.flash_decode_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.flash_decode_cuda.launches
    if sorted(done) != list(range(REQUESTS)) or any(
            len(done[r]) != len(requests[r]) + NEW_TOKENS for r in range(REQUESTS)):
        raise AssertionError(f"recipe_tp_serve: not every request finished with {NEW_TOKENS} "
                             "tokens")
    by_kind = {"prefill": cfg.n_layers * engine.steps["prefill"],
               "decode": cfg.n_layers * TP_MICROBATCHES * engine.steps["decode"]}
    if stats["launches"] != by_kind or launches != sum(by_kind.values()):
        raise AssertionError(f"recipe_tp_serve: flash_decode launches {stats['launches']} "
                             f"(total {launches}) != {by_kind}")
    differ = [r for r in range(REQUESTS) if done[r] != tp_done[r]]
    if differ:
        raise AssertionError(f"recipe_tp_serve: requests {differ} differ from tp_serve's tokens")
    steps = dict(engine.steps)
    del engine
    torch.cuda.empty_cache()
    out = dict(mesh=dict(mesh.shape), attn_mode=recipe.attn_mode, microbatches=TP_MICROBATCHES,
               requests=REQUESTS, slots=SLOTS, max_len=MAX_LEN, new_tokens=NEW_TOKENS,
               steps=steps, flash_decode_launches=launches,
               flash_decode_launches_by_kind=stats["launches"], tokens_equal_tp_serve=True,
               prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
               decode_tok_s=REQUESTS * NEW_TOKENS / stats["decode_s"], wall_s=wall,
               tp_serve_prefill_s=tp["prefill_s"], tp_serve_decode_tok_s=tp["decode_tok_s"],
               tp_serve_wall_s=tp["wall_s"], tp_weights_views_of_shards=views,
               engine_built_gb=built_gb, engine_build_peak_gb=build_peak_gb, kv_cache_gb=kv_gb,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    phase("recipe_tp_serve", arch=cfg.name, backend="nccl", **out)
    return out


def tp_engine(cfg, params, Engine, ServeConfig, mesh, prompts):
    """The TP serving engine on ``mesh`` with ``prompts`` submitted."""
    engine = Engine(cfg, params, ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1),
                    mesh=mesh, microbatches=TP_MICROBATCHES)
    for rid, prompt in enumerate(prompts):
        engine.submit(rid, prompt, NEW_TOKENS)
    return engine


def serve_tp(cfg, params, Engine, ServeConfig, fd, mesh, single: dict, single_dec: dict,
             window_steps: int = 8) -> dict:
    """``tp_serve``: the serving run's 8 requests on 4 slots through the
    tensor-parallel decode step (``microbatches=2``) on a one-rank NCCL
    ``(data, model)`` mesh: every request finishes, ``flash_decode``
    launches ``n_layers`` times a prefill chunk and ``n_layers x
    microbatches`` times a decode step, and the greedy tokens equal the
    single-host kernel run's (``single``) except at its near ties.  Then
    decode tok/s and a steady decode step's host and device ms
    (:func:`window`) beside the single-host run's (``single_dec``).
    Returns the phase's numbers and the run's tokens."""
    requests = serve_prompts(cfg)
    engine = tp_engine(cfg, params, Engine, ServeConfig, mesh, requests)
    stats = _instrument(engine, record_gaps=False, fd=fd)
    fd.flash_decode_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.flash_decode_cuda.launches
    if sorted(done) != list(range(REQUESTS)) or any(
            len(done[r]) != len(requests[r]) + NEW_TOKENS for r in range(REQUESTS)):
        raise AssertionError(f"tp_serve: not every request finished with {NEW_TOKENS} tokens")
    by_kind = {"prefill": cfg.n_layers * engine.steps["prefill"],
               "decode": cfg.n_layers * TP_MICROBATCHES * engine.steps["decode"]}
    if stats["launches"] != by_kind or launches != sum(by_kind.values()):
        raise AssertionError(f"tp_serve: flash_decode launches {stats['launches']} (total "
                             f"{launches}) != {by_kind}")
    agree, near_ties = greedy_agreement(requests, done, single["done"], single["stats"]["gaps"],
                                        "tp", "single_host")
    steps = dict(engine.steps)
    del engine
    torch.cuda.empty_cache()
    # a steady decode step of the first batch, as breakdown_lm's single-host window
    engine = tp_engine(cfg, params, Engine, ServeConfig, mesh, requests[:SLOTS])
    engine._fill_slots()
    engine._decode_once()
    dec = window(engine._decode_once, window_steps)
    del engine
    torch.cuda.empty_cache()
    out = dict(mesh=dict(mesh.shape), microbatches=TP_MICROBATCHES, requests=REQUESTS,
               slots=SLOTS, max_len=MAX_LEN, new_tokens=NEW_TOKENS, steps=steps,
               flash_decode_launches=launches, flash_decode_launches_by_kind=stats["launches"],
               flash_decode_launches_per_decode_step=stats["launches"]["decode"] / steps["decode"],
               prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
               decode_tok_s=REQUESTS * NEW_TOKENS / stats["decode_s"], wall_s=wall,
               single_host_decode_tok_s=REQUESTS * NEW_TOKENS / single["stats"]["decode_s"],
               single_host_wall_s=single["wall"], decode_step=dec,
               single_host_decode_step={k: single_dec[k] for k in
                                        ("wall_ms", "device_ms", "idle_share", "kernels_launched")},
               greedy_agreement_with_single_host=agree, divergences_at_near_ties=near_ties,
               tol=LOGIT_TOL)
    phase("tp_serve", arch=cfg.name, **out)
    return out, done


def check_tp_blocking(cfg, params, Engine, ServeConfig, mesh, make_tp_decode_step,
                      steps: int = 4) -> None:
    """``tp_blocking``: from one state after a prefill (3 of the 4 slots
    resident, one idle), ``steps`` greedy decode steps of the blocking TP
    step equal the double-buffered step's bitwise: every step's logits, the
    caches, lengths and positions."""
    engine = tp_engine(cfg, params, Engine, ServeConfig, mesh, serve_prompts(cfg)[:SLOTS - 1])
    engine._fill_slots()
    base = engine.state
    active = torch.tensor([s.request_id is not None for s in engine.slots], device=DEVICE)
    first = torch.tensor([[s.tokens[-1] if s.request_id is not None else 0]
                          for s in engine.slots], device=DEVICE)
    runs = {}
    for db in (True, False):
        step = make_tp_decode_step(cfg, mesh, slots=SLOTS, microbatches=TP_MICROBATCHES,
                                   double_buffer=db)
        state = type(base)(caches=type(base.caches)(*(t.clone() for t in base.caches)),
                           positions=base.positions.clone())
        tokens, logits = first, []
        for _ in range(steps):
            out, state = step(engine.tp_params, state, {"tokens": tokens}, active)
            logits.append(out)
            tokens = out[:, -1:, :cfg.vocab].argmax(dim=-1)
        runs[db] = dict(logits=torch.stack(logits), k=state.caches.k, v=state.caches.v,
                        length=state.caches.length, positions=state.positions)
    torch.cuda.synchronize()
    differ = [name for name in runs[True] if not torch.equal(runs[True][name], runs[False][name])]
    if differ:
        raise AssertionError(f"tp decode: blocking != double-buffered in {differ}")
    if not torch.isfinite(runs[True]["logits"]).all():
        raise AssertionError("tp decode: logits not finite")
    phase("tp_blocking", steps=steps, active_slots=int(active.sum()),
          db_equals_blocking="bitwise", compared=sorted(runs[True]))
    del engine, runs
    torch.cuda.empty_cache()


def tp_shard_decode(ops, card: str) -> dict:
    """``tp_shard``: ``flash_decode`` at one rank's shapes of a TP decode
    step under a model axis of M = 2 and M = 4 (phi4-mini's 24 query heads
    over 8 KV groups cut to 24/M over 8/M; one microbatch's 2 slots, cache
    lengths 2049 and 4096 of 4096), on views of a whole cache as the TP
    step makes them (the last rank's groups of the second microbatch's
    rows), against the plain version, and timed beside its bound, the plain
    version and ``scaled_dot_product_attention``."""
    rows = {}
    B, S, T, D = SLOTS // TP_MICROBATCHES, 1, MAX_LEN, 128
    lens = DECODE_LENS[2:]
    for M in TP_SHARD_MODEL_AXES:
        Hq, G = 24 // M, 8 // M
        q = randn((B, Hq, S, D), torch.bfloat16, 110 + M)
        rows_mb = slice(SLOTS - B, SLOTS)
        groups = slice(8 - G, 8)
        kc = randn((SLOTS, 8, T, D), torch.bfloat16, 120 + M)[rows_mb, groups]
        vc = randn((SLOTS, 8, T, D), torch.bfloat16, 130 + M)[rows_mb, groups]
        lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        got = ops.flash_decode(q, kc, vc, lens_t)
        torch.cuda.synchronize()
        want = ops.flash_decode(q, kc, vc, lens_t, impl="ref")
        tol = ATTN_TOL[torch.bfloat16]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        err = (got.float() - want.float()).abs().max().item()
        mask = torch.arange(T, device=DEVICE)[None, None, None, :] < lens_t[:, None, None, None]
        qf, kf, vf = q.float(), kc.float(), vc.float()
        t = time_three(lambda: ops.flash_decode(q, kc, vc, lens_t),
                       lambda: ops.flash_decode(q, kc, vc, lens_t, impl="ref"),
                       lambda: library_attention(qf, kf, vf, attn_mask=mask),
                       lambda: library_attention(q, kc, vc, attn_mask=mask), plain_iters=5)
        visible = S * sum(min(n, T) for n in lens)
        kv_bytes = 2 * 2 * G * D * sum(min(n, T) for n in lens)
        b_ms, b_by, fp32_ms = attn_bound(4 * Hq * visible * D, kv_bytes + 2 * 2 * q.numel())
        rows[M] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms, **t)
        check_bound(f"flash_decode tp shard M={M}", rows[M])
        phase("tp_shard", kernel="flash_decode", model_axis=M, shape=(B, Hq, G, S, T, D),
              lens=lens, strides=tuple(kc.stride()), dtype="bfloat16", tol=tol, card=card,
              **rows[M])
        del q, kc, vc, qf, kf, vf, got, want
    torch.cuda.empty_cache()
    return rows


def library_attention(q, k, v, **kw):
    """One PyTorch call computing the same attention (the yardstick, never
    used by the port): ``scaled_dot_product_attention`` with GQA.  On
    float32 upcasts it computes the reference's float32 function; on the
    bf16 tensors themselves it rounds p to bf16, another function, and is
    timed beside it as a speed yardstick only."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def time_three(kernel, plain, library, library_bf16=None, *, plain_iters: int = 20) -> dict:
    """Device ms (``queued_ms``) of the kernel, its plain version and the
    library call (and the library call on the bf16 tensors), and the
    kernel's ms per call with the host's launch work (``median_ms``)."""
    from repro_torch.kernels.timing import queued_ms

    out = dict(ms=queued_ms(kernel), plain_ms=queued_ms(plain, iters=plain_iters),
               library_ms=queued_ms(library, iters=plain_iters), call_ms=median_ms(kernel))
    if library_bf16 is not None:
        out["library_bf16_ms"] = queued_ms(library_bf16, iters=plain_iters)
    return out


def time_attention_kernels(ops, card: str, pieces: int) -> dict:
    """Times of the attention kernels at the path's shapes (bf16), beside
    the bounds of the products they run (the forward's p @ v in
    ``pieces`` bf16 pieces) and the float32 bound."""
    rows = {}
    B, Hq, G, S, D = 1, 24, 8, SEQ, 128
    q, k, v = (randn(shape, torch.bfloat16, 30 + i) for i, shape in
               enumerate(((B, Hq, S, D), (B, G, S, D), (B, G, S, D))))
    qf, kf, vf = q.float(), k.float(), v.float()
    t = time_three(lambda: ops.flash_attention(q, k, v),
                   lambda: ops.flash_attention(q, k, v, impl="ref"),
                   lambda: library_attention(qf, kf, vf, is_causal=True),
                   lambda: library_attention(q, k, v, is_causal=True))
    flops = 4 * B * Hq * S * S * D / 2
    b_ms, b_by, fp32_ms = attn_bound(flops, 2 * (2 * q.numel() + k.numel() + v.numel()),
                                     products=1 + pieces)
    rows["flash_attention"] = dict(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms, **t)
    check_bound("flash_attention", rows["flash_attention"])
    phase("time", kernel="flash_attention", shape=(B, Hq, G, S, D), causal=True,
          dtype="bfloat16", card=card, tflops=flops / t["ms"] / 1e9, **rows["flash_attention"])
    del q, k, v, qf, kf, vf
    for label, dims, lens, start in (
            ("decode", (SLOTS, 24, 8, 1, MAX_LEN, 128), DECODE_LENS, None),
            ("prefill_chunk", (SLOTS, 24, 8, 2048, MAX_LEN, 128), (2047, 1000, 300, 0),
             (0, 0, 300, 0))):
        B, Hq, G, S, T, D = dims
        q, kc, vc, lens_t, pos = decode_inputs(*dims, torch.bfloat16, lens=lens, start=start,
                                               seed=40)
        t_idx = torch.arange(T, device=DEVICE)
        mask = t_idx[None, None, None, :] < lens_t[:, None, None, None]
        if pos is not None:
            mask = mask & (t_idx[None, None, None, :] <= pos[:, None, :, None])
        qf, kf, vf = q.float(), kc.float(), vc.float()
        t = time_three(lambda: ops.flash_decode(q, kc, vc, lens_t, q_positions=pos),
                       lambda: ops.flash_decode(q, kc, vc, lens_t, q_positions=pos, impl="ref"),
                       lambda: library_attention(qf, kf, vf, attn_mask=mask),
                       lambda: library_attention(q, kc, vc, attn_mask=mask), plain_iters=5)
        # the work this run's data needs: each row's visible keys
        if pos is None:
            visible = S * sum(min(n, T) for n in lens)
        else:
            p = torch.minimum(pos.long() + 1, lens_t[:, None].long().clamp(max=T))
            visible = int(p.clamp(min=0).sum())
        kv_bytes = 2 * 2 * G * D * sum(min(n, T) for n in lens)
        b_ms, b_by, fp32_ms = attn_bound(4 * Hq * visible * D, kv_bytes + 2 * 2 * q.numel())
        rows[("flash_decode", label)] = dict(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms,
                                             **t)
        check_bound(f"flash_decode {label}", rows[("flash_decode", label)])
        phase("time", kernel="flash_decode", case=label, shape=dims, lens=lens,
              dtype="bfloat16", card=card, **rows[("flash_decode", label)])
        del q, kc, vc, qf, kf, vf, mask
    return rows


def ring_qkv(S: int, dtype, seed: int, *, pad_to: int | None = None):
    """phi4-mini's attention operands over S tokens (1 x 24 x S x 128 q,
    1 x 8 x S x 128 k/v), zero-padded to ``pad_to`` positions as the ring
    pads a ragged sequence."""
    q, k, v = (randn(shape, dtype, seed + i) for i, shape in
               enumerate(((1, 24, S, 128), (1, 8, S, 128), (1, 8, S, 128))))
    if pad_to is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad_to - S)) for x in (q, k, v))
    return q, k, v


def plain_carry(q):
    B, Hq, S, D = q.shape
    return (torch.zeros((B, Hq, S, D), device=DEVICE),
            torch.full((B, Hq, S), -1e30, device=DEVICE), torch.zeros((B, Hq, S), device=DEVICE))


def check_carry_kernel(ops, ring_step_offsets, ragged_seq_extents) -> dict:
    """``carry_check``: every (rank, step) call that a 4-rank ring over
    SEQ tokens, and over a ragged SEQ - 1 (padded keys masked by
    ``valid_len``), makes on each rank, with the offsets of the ring's own
    helper; each kernel call starts from the plain version's state and is
    held against the plain version in acc, m and l."""
    worst = {}
    for S in (SEQ, SEQ - 1):
        cap, _ = ragged_seq_extents(S, RING_R)
        valid = None if S == RING_R * cap else S
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = ring_qkv(S, dt, 50, pad_to=RING_R * cap)
            errs, calls = {"acc": 0.0, "m": 0.0, "l": 0.0}, 0
            for rank in range(RING_R):
                qr = q[:, :, rank * cap:(rank + 1) * cap]
                state = plain_carry(qr)
                for step in range(RING_R):
                    q_off, k_off = ring_step_offsets(rank, step, RING_R, cap)
                    blk = slice(k_off, k_off + cap)
                    kw = dict(q_offset=q_off, k_offset=k_off, valid_len=valid, causal=True)
                    want = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], state,
                                                     impl="ref", **kw)
                    got = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk],
                                                    tuple(t.clone() for t in state), **kw)
                    torch.cuda.synchronize()
                    for name, g, w in zip(("acc", "m", "l"), got, want):
                        torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
                        errs[name] = max(errs[name], (g - w).abs().max().item())
                    state, calls = want, calls + 1
            if S == SEQ and dt == torch.bfloat16:
                worst["flash_attention_carry"] = max(errs.values())
            phase("carry_check", arch=ARCH, ring=RING_R, seq=S, chunk=cap, valid_len=valid,
                  dtype=str(dt), calls=calls, max_abs_err=errs, tol=ATTN_TOL[dt])
            del q, k, v
    return worst


def chain(ops, q, k, v, *, causal: bool, chunks: int = RING_R):
    """Carry steps over ``chunks`` KV chunks in block order, normalized as
    the ring's epilogue does."""
    n = k.shape[2] // chunks
    carry = None
    for c in range(chunks):
        blk = slice(c * n, (c + 1) * n)
        carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, q_offset=0,
                                          k_offset=c * n, causal=causal)
    acc, _, l = carry
    return (acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)


def check_carry_chain(ops) -> None:
    """``carry_chain``: 4 carry steps in block order equal the single-shot
    kernel bitwise, float32 and bf16, causal and not, at the forward's
    shape."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = ring_qkv(SEQ, dt, 60)
        for causal in (True, False):
            chained = chain(ops, q, k, v, causal=causal)
            single = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(chained, single):
                raise AssertionError(f"carry chain != single-shot kernel ({dt}, causal={causal}): "
                                     f"max |diff| {(chained.float() - single.float()).abs().max()}")
            phase("carry_chain", shape=tuple(q.shape), kv=tuple(k.shape), chunks=RING_R,
                  dtype=str(dt), causal=causal, bitwise_equal=True)
        del q, k, v


def exact_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k (B, G, Skv, D) and v
    (B, G, Skv, Dv) in float64, row by row and head by head, causal (top-left
    aligned) or not: the function the kernels approximate."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    rep = Hq // k.shape[1]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=DEVICE)
    if causal:
        mask = mask.tril()
    out = torch.empty((*q.shape[:-1], v.shape[-1]), dtype=torch.float64, device=DEVICE)
    for b in range(B):
        for h in range(Hq):
            s = (q[b, h].double() @ k[b, h // rep].double().T) * D ** -0.5
            p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
            out[b, h] = p @ v[b, h // rep].double()
    return out


def check_attention_accuracy(ops) -> dict:
    """``attention_accuracy``: at the forward's shape (bf16 q 1x24x4096x128,
    k/v 1x8x4096x128, causal), the float32 ``acc / l`` of one carry step
    over all keys (the forward kernel's body and arithmetic, before its
    bf16 output rounding) and of the 4-step carry chain, against a float64
    computation: max abs error at most ACCURACY_RATIO times the plain
    version's (all float32)."""
    q, k, v = ring_qkv(SEQ, torch.bfloat16, 110)
    exact = exact_attention(q, k, v)

    def err(carry) -> float:
        acc, _, l = carry
        return ((acc / torch.where(l == 0, 1.0, l)[..., None]).double() - exact).abs().max().item()

    errs = {"plain": err(ops.flash_attention_carry(q, k, v, None, causal=True, impl="ref")),
            "kernel": err(ops.flash_attention_carry(q, k, v, None, causal=True))}
    n = SEQ // RING_R
    carry = None
    for c in range(RING_R):
        blk = slice(c * n, (c + 1) * n)
        carry = ops.flash_attention_carry(q, k[:, :, blk], v[:, :, blk], carry, k_offset=c * n,
                                          causal=True)
    errs["chain"] = err(carry)
    ratios = {name: errs[name] / errs["plain"] for name in ("kernel", "chain")}
    if max(ratios.values()) > ACCURACY_RATIO:
        raise AssertionError(f"attention error against float64 over {ACCURACY_RATIO}x the plain "
                             f"version's: {errs}")
    phase("attention_accuracy", shape=tuple(q.shape), against="float64", max_abs_err=errs,
          ratio=ratios, limit=ACCURACY_RATIO)
    return ratios


def check_attention_deterministic(ops, ring_step_offsets) -> None:
    """``attention_deterministic``: two launches of each bf16 kernel on the
    same inputs are bitwise equal, at the path's shapes: the forward, an
    off-diagonal carry step (rank 1, step 1; acc, m and l), a decode step
    and a prefill chunk."""
    q, k, v = ring_qkv(SEQ, torch.bfloat16, 120)
    cap = SEQ // RING_R
    q_off, k_off = ring_step_offsets(1, 1, RING_R, cap)
    qr, kb, vb = q[:, :, cap:2 * cap], k[:, :, k_off:k_off + cap], v[:, :, k_off:k_off + cap]
    state = plain_carry(qr)

    def carry_step():
        out = ops.flash_attention_carry(qr, kb, vb, tuple(t.clone() for t in state),
                                        q_offset=q_off, k_offset=k_off, causal=True)
        return torch.cat([t.flatten() for t in out])

    dec = decode_inputs(SLOTS, 24, 8, 1, MAX_LEN, 128, torch.bfloat16, lens=DECODE_LENS)
    pre = decode_inputs(SLOTS, 24, 8, 2048, MAX_LEN, 128, torch.bfloat16, lens=(2047, 1000, 300, 0),
                        start=(0, 0, 300, 0))
    cases = {"forward": lambda: ops.flash_attention(q, k, v),
             "carry_off_diagonal": carry_step,
             "decode_step": lambda: ops.flash_decode(*dec[:4], q_positions=dec[4]),
             "prefill_chunk": lambda: ops.flash_decode(*pre[:4], q_positions=pre[4])}
    for name, fn in cases.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two launches differ")
    phase("attention_deterministic", cases=list(cases), bitwise_equal=True)


def drive_ring_entry(ops, fa, ring_attention_seq, mesh) -> int:
    """``ring_entry``, the ring's path on one card: ``ring_attention_seq`` on
    a one-rank NCCL mesh at full width (bf16 as the model runs it, and
    float32), double-buffered and blocking, each equal to the single-shot
    kernel bitwise.  Returns the carry kernel's launches in that run."""
    inputs = {dt: ring_qkv(SEQ, dt, 70) for dt in (torch.bfloat16, torch.float32)}
    fa.flash_attention_carry_cuda.launches = 0
    outs = {(dt, db): ring_attention_seq(*inputs[dt], mesh=mesh, causal=True, double_buffer=db)
            for dt in inputs for db in (True, False)}
    torch.cuda.synchronize()
    launches = fa.flash_attention_carry_cuda.launches
    if launches != len(outs):
        raise AssertionError(f"ring_attention_seq launched the carry kernel {launches} times, "
                             f"expected {len(outs)} (one step each on one rank)")
    for dt, (q, k, v) in inputs.items():
        single = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if not torch.equal(outs[(dt, True)], outs[(dt, False)]):
            raise AssertionError(f"ring_attention_seq {dt}: double-buffered != blocking")
        if not torch.equal(outs[(dt, True)], single):
            raise AssertionError(f"ring_attention_seq {dt} != single-shot kernel")
        phase("ring_entry", shape=tuple(q.shape), mesh=dict(mesh.shape), dtype=str(dt),
              equals_single_shot="bitwise", db_equals_blocking="bitwise")
    phase("ring_entry_launches", flash_attention_carry=launches)
    return launches


TRANSPOSE_CASES = (((2048, 2048), torch.float32), ((4, 24, 1024, 128), torch.bfloat16),
                   ((16, 256, 512), torch.int32))


def transpose_input(shape, dtype, seed: int = 80) -> torch.Tensor:
    if dtype == torch.int32:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=dtype, device=DEVICE, generator=g)
    return randn(shape, dtype, seed)


def check_transpose(ops, relayout) -> int:
    """``transpose_check``: ``ops.transpose_tiled`` (the path) on the three
    cases, then each held against the plain version bitwise; the reference's
    tile rule raises."""
    xs = [transpose_input(shape, dt) for shape, dt in TRANSPOSE_CASES]
    relayout.transpose_cuda.launches = 0
    outs = [ops.transpose_tiled(x) for x in xs]
    torch.cuda.synchronize()
    launches = relayout.transpose_cuda.launches
    if launches != len(xs):
        raise AssertionError(f"transpose launches {launches} != {len(xs)}")
    for x, got in zip(xs, outs):
        want = ops.transpose_tiled(x, impl="ref")
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"transpose {tuple(x.shape)} {x.dtype} is not bitwise")
        phase("transpose_check", shape=tuple(x.shape), dtype=str(x.dtype), bitwise_equal=True)
    try:
        ops.transpose_tiled(torch.zeros((300, 256), device=DEVICE))
    except ValueError as e:
        phase("transpose_check", shape=(300, 256), raises=str(e))
    else:
        raise AssertionError("transpose_tiled took (300, 256), which the reference refuses")
    return launches


def profile_ring(ops, ring_attention_seq, mesh) -> None:
    """``ring_kernel_proof``: under the profiler, the ring entry runs the
    carry form of the flash kernel, the transpose entry its kernel, and no
    library attention kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = ring_qkv(512, torch.bfloat16, 90)
    x = transpose_input((2048, 2048), torch.float32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ring_attention_seq(q, k, v, mesh=mesh, causal=True)
        ops.transpose_tiled(x)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    carry = [n for n in names if "flash_attention_kernel" in n
             and any(t in n for t in CARRY_INSTANCE)]
    transpose = [n for n in names if "transpose_kernel" in n]
    library = [n for n in names if LIBRARY_ATTN.search(n) and not any(k in n for k in PORT_ATTN)]
    if not carry:
        raise AssertionError(f"the carry kernel did not run; device kernels: {names}")
    if not transpose:
        raise AssertionError(f"transpose_kernel did not run; device kernels: {names}")
    if library:
        raise AssertionError(f"library attention kernels ran: {library}")
    phase("ring_kernel_proof", device_kernels=len(names), carry_kernels=carry,
          transpose_kernels=transpose, library_attention=library)


def time_ring_kernels(ops, card: str, ring_step_offsets, pieces: int) -> dict:
    """Device times of a diagonal and an off-diagonal carry step of the
    4-rank ring (rank 1, steps 0 and 1; bf16, full width; p @ v in
    ``pieces`` bf16 pieces), of the 4-step chain against the single-shot
    kernel, and of the 2048 x 2048 float32 transpose, each beside its bound,
    plain version and library call."""
    from repro_torch.kernels.timing import queued_ms

    rows = {}
    cap = SEQ // RING_R
    q, k, v = ring_qkv(SEQ, torch.bfloat16, 100)
    qr = q[:, :, cap:2 * cap]
    for label, step in (("diagonal", 0), ("off_diagonal", 1)):
        q_off, k_off = ring_step_offsets(1, step, RING_R, cap)
        kb, vb = k[:, :, k_off:k_off + cap], v[:, :, k_off:k_off + cap]
        carry = plain_carry(qr)
        kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
        t = dict(ms=queued_ms(lambda: ops.flash_attention_carry(qr, kb, vb, carry, **kw)),
                 plain_ms=queued_ms(lambda: ops.flash_attention_carry(qr, kb, vb, carry,
                                                                      impl="ref", **kw)),
                 library_ms=None,
                 call_ms=median_ms(lambda: ops.flash_attention_carry(qr, kb, vb, carry, **kw)))
        pairs = cap * (cap + 1) // 2 if label == "diagonal" else cap * cap  # visible (q, k)
        flops = 4 * 24 * pairs * 128
        nbytes = 2 * (qr.numel() + kb.numel() + vb.numel()) + 2 * 4 * sum(c.numel() for c in carry)
        b_ms, b_by, fp32_ms = attn_bound(flops, nbytes, products=1 + pieces)
        rows[("flash_attention_carry", label)] = dict(bound_ms=b_ms, bound_by=b_by,
                                                      fp32_bound_ms=fp32_ms, **t)
        check_bound(f"flash_attention_carry {label}", rows[("flash_attention_carry", label)])
        phase("time", kernel="flash_attention_carry", case=label, rank=1, step=step,
              q=tuple(qr.shape), kv=tuple(kb.shape), dtype="bfloat16", card=card,
              library="none: no PyTorch call returns the unnormalized (acc, m, l)",
              tflops=flops / t["ms"] / 1e9, **rows[("flash_attention_carry", label)])
    chain_ms = queued_ms(lambda: chain(ops, q, k, v, causal=True), iters=10)
    single_ms = queued_ms(lambda: ops.flash_attention(q, k, v, causal=True), iters=10)
    phase("time", kernel="flash_attention_carry", case="chain_of_4_vs_single_shot",
          shape=tuple(q.shape), dtype="bfloat16", card=card, chain_ms=chain_ms,
          single_shot_ms=single_ms)
    rows["chain"] = dict(chain_ms=chain_ms, single_shot_ms=single_ms)
    del q, k, v, qr
    x = transpose_input((2048, 2048), torch.float32)
    t = dict(ms=queued_ms(lambda: ops.transpose_tiled(x)),
             plain_ms=queued_ms(lambda: ops.transpose_tiled(x, impl="ref")),
             library_ms=queued_ms(lambda: x.transpose(-2, -1).contiguous()),
             call_ms=median_ms(lambda: ops.transpose_tiled(x)))
    b_ms, b_by, _ = attn_bound(0, 2 * x.numel() * x.element_size())
    rows["transpose"] = dict(bound_ms=b_ms, bound_by=b_by, **t)
    phase("time", kernel="transpose", shape=tuple(x.shape), dtype="float32", card=card,
          gb_per_s=2 * x.numel() * 4 / t["ms"] / 1e6, **rows["transpose"])
    return rows


class RouterLog:
    """Inside the block, record every MoE routing call of the port
    (``ffn._route``): the experts each token's router chose, in k order,
    and its margin (the k-th probability minus the next one; a small
    margin is a near tie).  With ``force`` (another run's log) the i-th call
    routes as that run's i-th did, its gates taken from this run's
    probabilities, so a rounding difference cannot flip a discrete choice
    and the two runs differ only by their arithmetic."""

    def __init__(self, ffn, force=None):
        self.ffn, self.route, self.force, self.calls = ffn, ffn._route, force, []

    def __enter__(self):
        route = self.route

        def logged(x, router, top_k):
            probs, gate_vals, gate_idx = route(x, router, top_k)
            top = probs.topk(top_k + 1, dim=-1).values
            self.calls.append((gate_idx, top[..., top_k - 1] - top[..., top_k]))
            if self.force is not None:
                gate_idx = self.force[len(self.calls) - 1][0]
                gate_vals = torch.gather(probs, -1, gate_idx)
                gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gate_vals, gate_idx

        self.ffn._route = logged
        return self

    def __exit__(self, *exc):
        self.ffn._route = self.route


def router_disagreements(forced: RouterLog, k: int) -> dict:
    """Where the forced run's own router would have chosen other experts
    than the run it was forced to follow: the count of (token, layer)
    decisions, and their margins' largest value (the run diverges from the
    first one on, so later ones need not be near ties)."""
    n, margins = 0, []
    for (own, margin), (other, _) in zip(forced.calls, forced.force, strict=True):
        differ = (own.reshape(-1, k).sort(-1).values
                  != other.reshape(-1, k).sort(-1).values).any(-1)
        n += int(differ.sum())
        margins += margin.reshape(-1)[differ].tolist()
    return {"decisions": sum(own.reshape(-1, k).shape[0] for own, _ in forced.calls),
            "disagreements": n, "max_margin": max(margins, default=None),
            "min_margin": min(margins, default=None)}


def by_ranges(prof, ranges: dict[str, str], *, attention: str = "attention_kernels",
              gemm: str = "gemm") -> dict[str, float]:
    """Device ms of a profile's kernels split into the port's attention
    kernels, the kinds of ``ranges`` (profiler range name -> kind: the
    kernels that start inside a range's device span; one stream, so no
    other kernel runs in a span), the GEMMs outside them and the rest.
    Raises unless every kind's range has a device span."""
    spans = sorted((e.time_range.start, e.time_range.end, ranges[e.name])
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name in ranges)
    out = {attention: 0.0, **{kind: 0.0 for kind in ranges.values()}, gemm: 0.0, "other": 0.0}
    for e in device_kernels(prof):
        t = e.time_range.start
        kind = (attention if any(k in e.name for k in PORT_ATTN) else
                next((kind for lo, hi, kind in spans if lo <= t < hi), None)
                or (gemm if GEMM_NAMES.search(e.name) else "other"))
        out[kind] += e.time_range.elapsed_us() / 1e3
    if {kind for *_, kind in spans} != set(ranges.values()):
        raise AssertionError(f"the profile lacks a device span of {sorted(ranges)}: {spans[:4]}")
    return out


def moe_by_kind(prof) -> dict[str, float]:
    """:func:`by_ranges` of the MoE's ``moe.experts`` and
    ``moe.route``/``moe.combine`` ranges: attention kernels, expert GEMMs,
    routing/scatter, the other GEMMs (projections, router, head), the rest."""
    return by_ranges(prof, MOE_RANGES, gemm="other_gemms")


def seeded_params(cfg, lm) -> dict:
    """``lm.init_model``'s seeded draws, each leaf cast to the activation
    dtype as it is made (a float32 tree whole needs twice the memory)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def draw(tree):  # init_params' order: sorted keys, one generator
        if isinstance(tree, dict):
            return {k: draw(tree[k]) for k in sorted(tree)}
        return tree.initialize(gen, DEVICE).to(cfg.act_dtype)

    return draw(lm.build_specs(cfg))


def moe_model(configs, lm):
    """``moe_model``: phi3.5-moe at full width, cut to MOE_DEPTH layers,
    with :func:`seeded_params` (the float32 tree whole would need 43 GB at
    once)."""
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_DEPTH)
    t0 = time.perf_counter()
    params = seeded_params(cfg, lm)
    torch.cuda.synchronize()
    phase("moe_model", arch=cfg.name, layers=MOE_DEPTH,
          published_layers=configs.get(MOE_ARCH).n_layers, d_model=cfg.d_model,
          heads=(cfg.n_heads, cfg.n_kv, cfg.head_dim), d_ff=cfg.d_ff, experts=cfg.n_experts,
          top_k=cfg.moe_top_k, vocab=cfg.vocab, params=lm.count_params(cfg),
          active_params=lm.count_params(cfg, active_only=True), init_s=time.perf_counter() - t0,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    return cfg, params


def moe_forward(cfg, params, lm, fa, ffn) -> dict:
    """``moe_forward``: the forward of seeded tokens at each (B, S) of
    MOE_FORWARDS (1 x 4096: the global capacity dispatch, C = 640; 16 x 256:
    the grouped dispatch, G = 16) through the attention kernel
    (``flash_attention`` launched once a layer) and through its plain
    version routed as the kernel run was (:class:`RouterLog`), the logits
    of every token held to LOGIT_TOL, with the plain router's disagreements
    counted; forward ms; and where a forward's device time goes
    (:func:`window`, split by :func:`moe_by_kind`)."""
    out = {"launches": 0}
    for B, S in MOE_FORWARDS:
        g = torch.Generator(device=DEVICE).manual_seed(B)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), device=DEVICE, generator=g)}
        fa.flash_attention_cuda.launches = 0
        with RouterLog(ffn) as log:
            logits, aux = lm.forward(params, batch, cfg)
        torch.cuda.synchronize()
        launches = fa.flash_attention_cuda.launches
        fa.flash_attention_cuda.launches = 0
        with RouterLog(ffn, force=log.calls) as forced:
            ref_logits, ref_aux = lm.forward(params, batch,
                                             dataclasses.replace(cfg, attn_impl="ref"))
        torch.cuda.synchronize()
        if (launches, fa.flash_attention_cuda.launches) != (cfg.n_layers, 0):
            raise AssertionError(f"flash_attention launches {launches} (plain run "
                                 f"{fa.flash_attention_cuda.launches}) != {cfg.n_layers}")
        if logits.shape != (B, S, cfg.vocab_padded) or not torch.isfinite(logits).all():
            raise AssertionError(f"moe forward logits {tuple(logits.shape)} not finite/expected")
        err = (logits[..., :cfg.vocab].float() - ref_logits[..., :cfg.vocab].float()).abs().max()
        err = err.item()
        if err > LOGIT_TOL:
            raise AssertionError(f"moe forward {B}x{S} logits kernel vs plain: {err} > {LOGIT_TOL}")
        out["launches"] += launches
        del logits, ref_logits
        forward_ms = median_ms(lambda: lm.forward(params, batch, cfg), iters=3, warmup=1)
        brk = window(lambda: lm.forward(params, batch, cfg), 2, classify=moe_by_kind)
        if not any("flash_attention_kernel_wgmma" in n for n in brk["port_kernels"]):
            raise AssertionError(f"the profiled forward ran no flash_attention_kernel_wgmma: "
                                 f"{brk['port_kernels']}")
        row = dict(B=B, S=S, dispatch="grouped" if B % cfg.moe_groups == 0 else "global",
                   flash_attention_launches=launches, forward_ms=forward_ms,
                   tokens_per_s=B * S / forward_ms * 1e3, aux=float(aux), plain_aux=float(ref_aux),
                   logits_max_abs_err=err, tol=LOGIT_TOL,
                   plain_router=router_disagreements(forced, cfg.moe_top_k), breakdown=brk)
        phase("moe_forward", arch=cfg.name, **row)
        out[(B, S)] = row
        torch.cuda.empty_cache()
    return out


def moe_serve(cfg, params, Engine, ServeConfig, fd, ffn) -> dict:
    """``moe_serve``: MOE_REQUESTS requests (seeded prompts of 16-128
    tokens, MOE_NEW_TOKENS new tokens each) on SLOTS slots of MAX_LEN
    positions, through the decode kernel, then through its plain version
    routed as the kernel run was (:class:`RouterLog`; both runs take the
    same steps).  The MoE family prefills token by token, so
    ``flash_decode`` launches once a layer in every step.  Greedy tokens
    equal the plain run's except at its near ties (top-2 gap <=
    LOGIT_TOL).  Then a steady decode step of 4 resident requests
    (:func:`window`)."""
    rng = np.random.default_rng(0)
    requests = [rng.integers(2, cfg.vocab, size=int(rng.integers(*MOE_PROMPT_LENS))).tolist()
                for _ in range(MOE_REQUESTS)]
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)
    runs, log = {}, None
    for impl in (None, "ref"):
        engine = Engine(dataclasses.replace(cfg, attn_impl=impl), params, scfg)
        stats = _instrument(engine, record_gaps=True, fd=fd)
        for rid, prompt in enumerate(requests):
            engine.submit(rid, prompt, MOE_NEW_TOKENS)
        fd.flash_decode_cuda.launches = 0
        t0 = time.perf_counter()
        with RouterLog(ffn, force=None if log is None else log.calls) as log:
            done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fd.flash_decode_cuda.launches
        if sorted(done) != list(range(MOE_REQUESTS)) or any(
                len(done[r]) != len(requests[r]) + MOE_NEW_TOKENS for r in range(MOE_REQUESTS)):
            raise AssertionError(f"moe_serve {impl}: not every request finished")
        steps = dict(engine.steps)
        expected = cfg.n_layers * (steps["prefill"] + steps["decode"]) if impl is None else 0
        if launches != expected or stats["launches"]["prefill"] != (
                cfg.n_layers * steps["prefill"] if impl is None else 0):
            raise AssertionError(f"moe_serve {impl}: flash_decode launches {launches} "
                                 f"({stats['launches']}) != {expected}")
        runs[impl] = dict(done=done, stats=stats, steps=steps, wall=wall, launches=launches,
                          log=log)
        del engine
        torch.cuda.empty_cache()
    k, p = runs[None], runs["ref"]
    agree, near_ties = 0, []
    for rid, prompt in enumerate(requests):
        for j, (a, b) in enumerate(zip(k["done"][rid][len(prompt):], p["done"][rid][len(prompt):])):
            if a == b:
                agree += 1
                continue
            gap = p["stats"]["gaps"][(rid, len(prompt) + j)]
            if gap > LOGIT_TOL:
                raise AssertionError(f"moe_serve request {rid} token {j}: kernel {a} vs plain "
                                     f"{b} with a plain top-2 gap of {gap} > {LOGIT_TOL}")
            near_ties.append({"request": rid, "token": j, "plain_top2_gap": gap})
            break
    # a steady decode step of the first 4 requests, outside the runs above
    engine = Engine(cfg, params, scfg)
    for rid, prompt in enumerate(requests[:SLOTS]):
        engine.submit(rid, prompt, 4 * MOE_NEW_TOKENS)
    engine._fill_slots()
    engine._decode_once()
    fd.flash_decode_cuda.launches = 0
    dec = window(engine._decode_once, 8, classify=moe_by_kind)
    if not any("flash_decode_kernel_wgmma" in n for n in dec["port_kernels"]):
        raise AssertionError(f"the profiled decode steps ran no flash_decode_kernel_wgmma: "
                             f"{dec['port_kernels']}")
    if fd.flash_decode_cuda.launches != 2 * 8 * cfg.n_layers:
        raise AssertionError(f"moe decode window: flash_decode launches "
                             f"{fd.flash_decode_cuda.launches} != {2 * 8 * cfg.n_layers}")
    cache_lens = list(engine.ledger.lengths)
    del engine
    torch.cuda.empty_cache()
    st = k["stats"]
    out = dict(requests=MOE_REQUESTS, slots=SLOTS, max_len=MAX_LEN, new_tokens=MOE_NEW_TOKENS,
               prompt_lens=[len(r) for r in requests], steps=k["steps"],
               flash_decode_launches=k["launches"], flash_decode_launches_by_kind=st["launches"],
               prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               serve_decode_tok_s=MOE_REQUESTS * MOE_NEW_TOKENS / st["decode_s"],
               wall_s=k["wall"], plain_wall_s=p["wall"], decode_step=dec,
               decode_step_cache_lens=cache_lens, decode_tok_s=SLOTS / dec["wall_ms"] * 1e3,
               greedy_agreement=agree / (MOE_REQUESTS * MOE_NEW_TOKENS),
               divergences_at_near_ties=near_ties, tol=LOGIT_TOL,
               plain_router=router_disagreements(p["log"], cfg.moe_top_k))
    phase("moe_serve", arch=cfg.name, **out)
    return dict(out, done=k["done"], prompts=requests)


def time_moe_attention(ops, card: str, pieces: int) -> dict:
    """Both attention kernels at phi3.5-moe's shapes (32 query heads over 8
    KV groups, GQA 4; bf16): against the plain version, and timed beside
    the bound, the plain version and ``scaled_dot_product_attention``."""
    rows, tol = {}, ATTN_TOL[torch.bfloat16]
    B, Hq, G, S, D = 1, 32, 8, SEQ, 128
    q, k, v = (randn(shape, torch.bfloat16, 150 + i) for i, shape in
               enumerate(((B, Hq, S, D), (B, G, S, D), (B, G, S, D))))
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = ops.flash_attention(q, k, v, impl="ref")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = (got.float() - want.float()).abs().max().item()
    qf, kf, vf = q.float(), k.float(), v.float()
    t = time_three(lambda: ops.flash_attention(q, k, v),
                   lambda: ops.flash_attention(q, k, v, impl="ref"),
                   lambda: library_attention(qf, kf, vf, is_causal=True),
                   lambda: library_attention(q, k, v, is_causal=True))
    flops = 4 * B * Hq * S * S * D / 2
    b_ms, b_by, fp32_ms = attn_bound(flops, 2 * (2 * q.numel() + k.numel() + v.numel()),
                                     products=1 + pieces)
    rows["flash_attention"] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                   fp32_bound_ms=fp32_ms, **t)
    check_bound("flash_attention gqa4", rows["flash_attention"])
    phase("time", kernel="flash_attention", arch=MOE_ARCH, shape=(B, Hq, G, S, D), causal=True,
          dtype="bfloat16", tol=tol, card=card, **rows["flash_attention"])
    del q, k, v, qf, kf, vf, got, want
    dims = (SLOTS, 32, 8, 1, MAX_LEN, 128)
    q, kc, vc, lens_t, _ = decode_inputs(*dims, torch.bfloat16, lens=DECODE_LENS, seed=160)
    got = ops.flash_decode(q, kc, vc, lens_t)
    torch.cuda.synchronize()
    want = ops.flash_decode(q, kc, vc, lens_t, impl="ref")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = (got.float() - want.float()).abs().max().item()
    mask = torch.arange(MAX_LEN, device=DEVICE)[None, None, None, :] < lens_t[:, None, None, None]
    qf, kf, vf = q.float(), kc.float(), vc.float()
    t = time_three(lambda: ops.flash_decode(q, kc, vc, lens_t),
                   lambda: ops.flash_decode(q, kc, vc, lens_t, impl="ref"),
                   lambda: library_attention(qf, kf, vf, attn_mask=mask),
                   lambda: library_attention(q, kc, vc, attn_mask=mask), plain_iters=5)
    visible = sum(min(n, MAX_LEN) for n in DECODE_LENS)
    b_ms, b_by, fp32_ms = attn_bound(4 * 32 * visible * 128,
                                     2 * 2 * 8 * 128 * visible + 2 * 2 * q.numel())
    rows["flash_decode"] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                fp32_bound_ms=fp32_ms, **t)
    check_bound("flash_decode gqa4", rows["flash_decode"])
    phase("time", kernel="flash_decode", arch=MOE_ARCH, case="decode", shape=dims,
          lens=DECODE_LENS, dtype="bfloat16", tol=tol, card=card, **rows["flash_decode"])
    del q, kc, vc, qf, kf, vf, got, want, mask
    torch.cuda.empty_cache()
    return rows


def check_mla_kernel(ops, card: str, pieces: int) -> dict:
    """``mla_kernel``: the flash-attention kernel's (96, 64) instances at
    minicpm3's forward shape (q/k 1x40x4096x96, v 1x40x4096x64, causal, GQA
    1) and at a ragged 4095, bf16 and float32, against the plain version;
    the bf16 output against float64 (at most ACCURACY_RATIO times the plain
    version's error; both outputs are rounded to bf16); two launches
    bitwise equal; and the bf16 time beside the bound (q k^T once, p @ v
    once a piece of p), the plain version and ``scaled_dot_product_attention``
    (the backend it picks at this shape named)."""
    from torch.nn.attention import SDPBackend

    rows = {}
    H, D, Dv = 40, 96, 64
    for label, S in (("forward", SEQ), ("ragged", MLA_RAGGED)):
        for dt in (torch.bfloat16, torch.float32):
            q, k = randn((1, H, S, D), dt, 170), randn((1, H, S, D), dt, 171)
            v = randn((1, H, S, Dv), dt, 172)
            got = ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = ops.flash_attention(q, k, v, impl="ref")
            if got.shape != (1, H, S, Dv):
                raise AssertionError(f"mla kernel output {tuple(got.shape)}")
            torch.testing.assert_close(got, want, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
            err = (got.float() - want.float()).abs().max().item()
            bitwise = torch.equal(got, ops.flash_attention(q, k, v))
            if not bitwise:
                raise AssertionError(f"mla kernel {label} {dt}: two launches differ")
            row = dict(max_abs_err=err, tol=ATTN_TOL[dt], two_launches="bitwise")
            if label == "forward" and dt == torch.bfloat16:
                exact = exact_attention(q, k, v)
                errs = {"kernel": (got.double() - exact).abs().max().item(),
                        "plain": (want.double() - exact).abs().max().item(),
                        "kernel_mean": (got.double() - exact).abs().mean().item(),
                        "plain_mean": (want.double() - exact).abs().mean().item()}
                ratio = errs["kernel"] / errs["plain"]
                if ratio > ACCURACY_RATIO:
                    raise AssertionError(f"mla kernel error against float64 over "
                                         f"{ACCURACY_RATIO}x the plain version's: {errs}")
                del exact
                qf, kf, vf = q.float(), k.float(), v.float()
                t = time_three(lambda: ops.flash_attention(q, k, v),
                               lambda: ops.flash_attention(q, k, v, impl="ref"),
                               lambda: library_attention(qf, kf, vf, is_causal=True),
                               lambda: library_attention(q, k, v, is_causal=True))
                qk, pv = 2 * H * S * S * D / 2, 2 * H * S * S * Dv / 2
                nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
                b_ms, b_by, fp32_ms = attn_bound(qk + pv, nbytes, products=1 + pieces,
                                                 pv_flops=pv)
                row.update(error_vs_float64=errs, error_vs_float64_ratio=ratio,
                           limit=ACCURACY_RATIO, bound_ms=b_ms, bound_by=b_by,
                           fp32_bound_ms=fp32_ms, tflops=(qk + pv) / t["ms"] / 1e9,
                           library_bf16_backend=SDPBackend(torch._fused_sdp_choice(
                               q, k, v, is_causal=True, enable_gqa=True)).name,
                           **t)
                check_bound("flash_attention (96, 64)", row)
                del qf, kf, vf
            rows[(label, str(dt))] = row
            phase("mla_kernel", kernel="flash_attention", case=label, shape=(1, H, H, S, D, Dv),
                  causal=True, dtype=str(dt), card=card, **row)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows[("forward", str(torch.bfloat16))]


def mla_model(configs, lm):
    """``mla_model``: minicpm3-4b at full width, MLA_DEPTH layers, with
    :func:`seeded_params` (bf16)."""
    cfg = dataclasses.replace(configs.get(MLA_ARCH), n_layers=MLA_DEPTH)
    t0 = time.perf_counter()
    params = seeded_params(cfg, lm)
    torch.cuda.synchronize()
    phase("mla_model", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
          heads=cfg.n_heads, ranks=(cfg.mla_q_rank, cfg.mla_kv_rank),
          head_dims=(cfg.mla_d_nope, cfg.mla_d_rope, cfg.mla_d_v), d_ff=cfg.d_ff,
          vocab=cfg.vocab, params=lm.count_params(cfg), init_s=time.perf_counter() - t0,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    return cfg, params


def mla_forward(cfg, params, lm, fa) -> dict:
    """``mla_forward``: the forward of 1 x SEQ seeded tokens through the
    kernel (``flash_attention`` launched once a layer, the profiled forward
    on ``flash_attention_kernel_wgmma`` and no library attention kernel)
    and through its plain version, logits held to LOGIT_TOL at every token;
    forward ms; and where its device time goes (:func:`window`)."""
    g = torch.Generator(device=DEVICE).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}
    fa.flash_attention_cuda.launches = 0
    logits, _ = lm.forward(params, batch, cfg)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    fa.flash_attention_cuda.launches = 0
    ref_logits, _ = lm.forward(params, batch, dataclasses.replace(cfg, attn_impl="ref"))
    torch.cuda.synchronize()
    if (launches, fa.flash_attention_cuda.launches) != (cfg.n_layers, 0):
        raise AssertionError(f"mla forward: flash_attention launches {launches} (plain run "
                             f"{fa.flash_attention_cuda.launches}) != {cfg.n_layers}")
    if logits.shape != (1, SEQ, cfg.vocab_padded) or not torch.isfinite(logits).all():
        raise AssertionError(f"mla forward logits {tuple(logits.shape)} not finite/expected")
    err = (logits[..., :cfg.vocab].float() - ref_logits[..., :cfg.vocab].float()).abs().max()
    err = err.item()
    if err > LOGIT_TOL:
        raise AssertionError(f"mla forward logits kernel vs plain: {err} > {LOGIT_TOL}")
    scale = ref_logits[..., :cfg.vocab].float().abs().max().item()
    del logits, ref_logits
    torch.cuda.empty_cache()
    forward_ms = median_ms(lambda: lm.forward(params, batch, cfg), iters=3, warmup=1)
    brk = window(lambda: lm.forward(params, batch, cfg), 2)
    if not any("flash_attention_kernel_wgmma" in n for n in brk["port_kernels"]):
        raise AssertionError(f"the profiled mla forward ran no flash_attention_kernel_wgmma: "
                             f"{brk['port_kernels']}")
    if brk["library_attention"]:
        raise AssertionError(f"library attention kernels ran: {brk['library_attention']}")
    out = dict(tokens=SEQ, flash_attention_launches=launches, forward_ms=forward_ms,
               tokens_per_s=SEQ / forward_ms * 1e3, logits_max_abs_err=err, tol=LOGIT_TOL,
               logit_scale=scale, breakdown=brk)
    phase("mla_forward", arch=cfg.name, **out)
    torch.cuda.empty_cache()
    return out


def mla_serve(cfg, params, lm, Engine, ServeConfig, fa, fd) -> dict:
    """``mla_serve``: REQUESTS requests (:func:`serve_prompts`, NEW_TOKENS
    new tokens each) on SLOTS slots of MAX_LEN positions through the
    absorbed decode (whole-prompt chunks and decode steps; no attention
    kernel launches, as in the reference), run with the kernels' default
    and with ``attn_impl="ref"``: greedy tokens equal except at the plain
    run's near ties.  Each slot's first prefill chunk's logits at its last
    prompt position are held to LOGIT_TOL against the decompressed forward
    (through the kernel) of the same prompt.  Then a steady decode step of
    4 resident requests (:func:`window`)."""
    requests = serve_prompts(cfg)
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)
    runs = {}
    for impl in (None, "ref"):
        engine = Engine(dataclasses.replace(cfg, attn_impl=impl), params, scfg)
        stats = _instrument(engine, record_gaps=True, fd=fd)
        for rid, prompt in enumerate(requests):
            engine.submit(rid, prompt, NEW_TOKENS)
        fa.flash_attention_cuda.launches = fd.flash_decode_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(done) != list(range(REQUESTS)) or any(
                len(done[r]) != len(requests[r]) + NEW_TOKENS for r in range(REQUESTS)):
            raise AssertionError(f"mla_serve {impl}: not every request finished")
        launches = (fa.flash_attention_cuda.launches, fd.flash_decode_cuda.launches)
        if launches != (0, 0):
            raise AssertionError(f"mla_serve {impl}: the absorbed decode launched attention "
                                 f"kernels {launches}")
        runs[impl] = dict(done=done, stats=stats, steps=dict(engine.steps), wall=wall,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del engine
        torch.cuda.empty_cache()
    k, p = runs[None], runs["ref"]
    agree, near_ties = greedy_agreement(requests, k["done"], p["done"], p["stats"]["gaps"],
                                        "kernel", "plain")
    # the absorbed chunk against the decompressed forward of the same prompts
    absorbed_err = 0.0
    for slot, last in k["stats"]["first_prefill"].items():
        feed = torch.tensor(requests[slot][:-1], device=DEVICE)[None, :]
        want = lm.forward(params, {"tokens": feed}, cfg)[0][0, -1, :cfg.vocab].float()
        absorbed_err = max(absorbed_err, (last[:cfg.vocab].float() - want).abs().max().item())
    if absorbed_err > LOGIT_TOL:
        raise AssertionError(f"mla prefill chunk (absorbed) vs forward (decompressed) logits: "
                             f"{absorbed_err} > {LOGIT_TOL}")
    engine = Engine(cfg, params, scfg)
    for rid, prompt in enumerate(requests[:SLOTS]):
        engine.submit(rid, prompt, NEW_TOKENS)
    engine._fill_slots()
    engine._decode_once()
    dec = window(engine._decode_once, 8)
    cache_lens = list(engine.ledger.lengths)
    del engine
    torch.cuda.empty_cache()
    st = k["stats"]
    out = dict(requests=REQUESTS, slots=SLOTS, max_len=MAX_LEN, new_tokens=NEW_TOKENS,
               prompt_lens=[len(r) for r in requests], steps=k["steps"],
               attention_kernel_launches=0, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               serve_decode_tok_s=REQUESTS * NEW_TOKENS / st["decode_s"], wall_s=k["wall"],
               plain_wall_s=p["wall"], peak_memory_gb=k["peak_gb"],
               peak_kv_occupancy=st["peak_occupancy"], decode_step=dec,
               decode_step_cache_lens=cache_lens, decode_tok_s=SLOTS / dec["wall_ms"] * 1e3,
               greedy_agreement=agree, divergences_at_near_ties=near_ties,
               absorbed_vs_forward_logits_max_abs_err=absorbed_err, tol=LOGIT_TOL)
    phase("mla_serve", arch=cfg.name, **out)
    return dict(out, done=k["done"], prompts=requests)


def train_config(configs):
    """phi4-mini-3.8b at full width, TRAIN_DEPTH of its 32 layers (bf16
    activations, remat ``block``: the config's own)."""
    return dataclasses.replace(configs.get(ARCH), n_layers=TRAIN_DEPTH)


def train_batch(cfg, step: int = 0) -> dict:
    """``data.pipeline.make_batch`` of TRAIN_BATCH x SEQ tokens on the card."""
    from repro_torch.data.pipeline import ShapeCell, make_batch
    from repro_torch.launch.train import to_device

    cell = ShapeCell("train", seq_len=SEQ, global_batch=TRAIN_BATCH, kind="train")
    return to_device(make_batch(cfg, cell, step), DEVICE)


def train_launcher(cfg) -> dict:
    """``train``'s launcher part: TRAIN_STEPS steps through
    ``launch/train.py``'s own loop (``run``), at full width and cut depth: a
    first run of TRAIN_STEPS - 1 steps writes its checkpoint, a second run
    restores it and takes the last step."""
    import shutil

    from repro_torch.launch import train as launcher

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    flags = ["--arch", ARCH, "--device", DEVICE, "--seq-len", str(SEQ), "--global-batch",
             str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICROBATCHES), "--lr", str(TRAIN_LR),
             "--ckpt-dir", str(ckpt), "--log-every", "1"]
    t0 = time.perf_counter()
    first = launcher.run(launcher.parse_args(flags + ["--steps", str(TRAIN_STEPS - 1)]), cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    second = launcher.run(launcher.parse_args(flags + ["--steps", str(TRAIN_STEPS)]), cfg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    seconds = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = first["loss"] + second["loss"]
    if second["start_step"] != TRAIN_STEPS - 1 or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"the launcher did not restore its checkpoint: {first}, {second}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    step_s = first["seconds"][1:] + second["seconds"]  # the first step builds and warms up
    out = dict(steps=TRAIN_STEPS, restored_at=second["start_step"], losses=losses,
               step_seconds=first["seconds"] + second["seconds"],
               tokens_per_s=TRAIN_BATCH * SEQ / float(np.median(step_s)),
               peak_memory_gb=peak, seconds=seconds)
    phase("train_launcher", arch=cfg.name, layers=cfg.n_layers, **out)
    return out


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` in float32 Frobenius norms."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def train_grads(cfg, params, batch, fa, trainer, tree_leaves) -> tuple:
    """``train``'s gradient checks: one step's loss and gradients through the
    attention kernel (``flash_attention`` launched 2 microbatches x layers
    x (forward + remat's recompute) times, every leaf finite and nonzero),
    held against the same step through the plain attention.  Returns the
    kernel run's ``(loss, grads)``."""
    fa.flash_attention_cuda.launches = 0
    loss, _, grads = trainer._accum_loss_grads(params, batch, cfg, TRAIN_MICROBATCHES)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    expected = TRAIN_MICROBATCHES * cfg.n_layers * 2
    if launches != expected:
        raise AssertionError(f"flash_attention launches in a training step {launches} != "
                             f"{expected}")
    leaves = tree_leaves(grads)
    for i, g in enumerate(leaves):
        if g.dtype != torch.float32 or not torch.isfinite(g).all() or not g.abs().sum() > 0:
            raise AssertionError(f"gradient leaf {i} {tuple(g.shape)} is not a finite, nonzero "
                                 f"float32 tensor")
    plain_cfg = dataclasses.replace(cfg, attn_impl="ref")
    plain_loss, _, plain = trainer._accum_loss_grads(params, batch, plain_cfg,
                                                     TRAIN_MICROBATCHES)
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    errs = [rel_err(a, b) for a, b in zip(leaves, tree_leaves(plain))]
    del plain
    if loss_err > TRAIN_LOSS_RTOL or max(errs) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"kernel vs plain training step: loss {loss_err} (tol "
                             f"{TRAIN_LOSS_RTOL}), gradients {errs} (tol {TRAIN_GRAD_RTOL})")
    out = dict(flash_attention_launches=launches, expected=expected, loss=loss.item(),
               plain_loss=plain_loss.item(), loss_rel_err=loss_err, grad_rel_err_max=max(errs),
               grad_rel_err_median=float(np.median(errs)), leaves=len(leaves),
               tol=dict(loss=TRAIN_LOSS_RTOL, grads=TRAIN_GRAD_RTOL))
    phase("train_grads", arch=cfg.name, **out)
    return loss, grads, out


def train_by_kind(prof) -> dict[str, float]:
    """:func:`by_ranges` of a training step's TRAIN_RANGES: the attention
    kernel, the plain backward's recompute, the optimizer, cuBLAS GEMMs and
    the rest."""
    return by_ranges(prof, TRAIN_RANGES, attention="attention_kernel")


def train_breakdown(cfg, params, batch, trainer, optimizer) -> dict:
    """``train``'s window: after a warm-up step, one ``make_train_step``
    step unprofiled (host clock) and one under the profiler (device time by
    kind, idle share), with the step's peak memory."""
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    step = trainer.make_train_step(cfg, None, ocfg, microbatches=TRAIN_MICROBATCHES)
    opt = optimizer.init_opt_state(params, ocfg)
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, batch)  # the allocator maps the step's memory once
    win = window(lambda: step(params, opt, batch), 1, classify=train_by_kind)
    win["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("breakdown", arch=cfg.name, window="train_step", layers=cfg.n_layers,
          tokens=TRAIN_BATCH * SEQ, microbatches=TRAIN_MICROBATCHES, **win)
    return win


def zero_train(cfg, params, batch, grads, trainer, optimizer, tree_leaves, mesh) -> dict:
    """``zero_train``: ``make_zero_train_step`` on a one-rank NCCL ``data``
    mesh held against ``make_train_step`` on the same parameters and batch
    (see ZERO_*), and the ZeRO update's blocking plan against its
    double-buffered one, bitwise, both fed the same gradients (``grads``,
    the kernel run's): the embedding's backward adds with atomics, so two
    backward runs need not agree bitwise."""
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    base, m_base = params_and_metrics(trainer.make_train_step(
        cfg, None, ocfg, microbatches=TRAIN_MICROBATCHES)(
            params, optimizer.init_opt_state(params, ocfg), batch))
    base = [t.cpu() for t in tree_leaves(base)]  # on the host: the card holds the next step
    buckets = trainer.zero_train_buckets(cfg, bucket_bytes=4 << 20, ranks=1)
    zstep = trainer.make_zero_train_step(cfg, mesh, ocfg, microbatches=TRAIN_MICROBATCHES)
    t0 = time.perf_counter()
    zero, m_zero = params_and_metrics(zstep(
        params, optimizer.init_zero_opt_state(params, buckets, ocfg),
        trainer.zero_local_batch(mesh, batch)))
    torch.cuda.synchronize()
    zero_s = time.perf_counter() - t0
    loss_err = abs(m_zero["loss"].item() - m_base["loss"].item()) / m_base["loss"].item()
    norm_err = abs(m_zero["grad_norm"].item() - m_base["grad_norm"].item()) / \
        m_base["grad_norm"].item()
    lr = m_base["lr"].item()
    worst, far, total = 0.0, 0, 0
    for a, b in zip(tree_leaves(zero), base):
        d = (a.cpu() - b).abs()
        worst = max(worst, d.max().item())
        far += int((d > lr / 100).sum())
        total += d.numel()
    del base, zero
    if loss_err > ZERO_LOSS_RTOL or norm_err > ZERO_NORM_RTOL or worst > 2 * lr * (1 + 1e-3) \
            or far > ZERO_FAR_SHARE * total:
        raise AssertionError(f"ZeRO step vs make_train_step: loss {loss_err}, norm {norm_err}, "
                             f"max |dp| {worst} (2 lr = {2 * lr}), {far} of {total} elements "
                             "more than lr / 100 apart")
    runs = []
    for db in (True, False):
        update = trainer.make_zero_update(cfg, mesh, ocfg, double_buffer=db)
        new = update(params, optimizer.init_zero_opt_state(params, buckets, ocfg), grads)[0]
        runs.append([t.cpu() for t in tree_leaves(new)])
        del new
        if len(runs) == 2:
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("the ZeRO update's blocking plan is not bitwise its "
                                     "double-buffered one")
    del runs
    out = dict(buckets=len(buckets), loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
               max_abs_param_diff=worst, two_lr=2 * lr, elements_over_lr_100=far,
               elements=total, blocking_equal_double_buffered="bitwise (same gradients)",
               step_s=zero_s, tol=dict(loss=ZERO_LOSS_RTOL, grad_norm=ZERO_NORM_RTOL,
                                       far_share=ZERO_FAR_SHARE))
    phase("zero_train", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl", **out)
    return out, m_base


def params_and_metrics(step_result) -> tuple:
    """A train step's new parameters and metrics (its optimizer state let go)."""
    return step_result[0], step_result[2]


def sp_ring_train(cfg, params, batch, m_base, fa, trainer, optimizer, make_recipe,
                  mesh) -> dict:
    """``sp_ring_train``: one ``make_train_step`` step under the ``sp_ring``
    recipe on a one-rank NCCL ``(data, model)`` mesh: the ring's carry kernel
    launched once a layer and microbatch in the forward and again in remat's
    recompute (its gradient through ``_CarryStep``), held against the
    no-recipe step's metrics ``m_base`` (see RING_*)."""
    from repro_torch.models.sharding import local_batch

    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
    fa.flash_attention_cuda.launches = fa.flash_attention_carry_cuda.launches = 0
    t0 = time.perf_counter()
    m_ring = trainer.make_train_step(cfg, recipe, ocfg, microbatches=TRAIN_MICROBATCHES)(
        params, optimizer.init_opt_state(params, ocfg),
        local_batch(recipe, batch, microbatches=TRAIN_MICROBATCHES))[2]
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    carry, single = fa.flash_attention_carry_cuda.launches, fa.flash_attention_cuda.launches
    expected = TRAIN_MICROBATCHES * cfg.n_layers * 2
    if carry != expected or single != 0:
        raise AssertionError(f"sp_ring step launched the carry kernel {carry} times (expected "
                             f"{expected}) and the single-shot kernel {single} times")
    loss_err = abs(m_ring["loss"].item() - m_base["loss"].item()) / m_base["loss"].item()
    norm_err = abs(m_ring["grad_norm"].item() - m_base["grad_norm"].item()) / \
        m_base["grad_norm"].item()
    if loss_err > RING_LOSS_RTOL or norm_err > RING_NORM_RTOL:
        raise AssertionError(f"sp_ring step vs no recipe: loss {loss_err}, grad norm {norm_err}")
    out = dict(flash_attention_carry_launches=carry, expected=expected, loss=m_ring["loss"].item(),
               loss_rel_err=loss_err, grad_norm=m_ring["grad_norm"].item(),
               grad_norm_rel_err=norm_err, step_s=ring_s,
               tol=dict(loss=RING_LOSS_RTOL, grad_norm=RING_NORM_RTOL))
    phase("sp_ring_train", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl", **out)
    return out


def recipe_train(cfg, params, batch, m_base, fa, lm, trainer, optimizer, sharding,
                 shard_params_by_recipe, mesh) -> dict:
    """``recipe_train``: one ``make_train_step`` step under the ``tp``
    recipe on a one-rank NCCL ``(data, model)`` mesh, on the rank's shards
    (views: one rank cuts nothing): ``flash_attention`` launched once a
    layer and microbatch in the forward and again in remat's recompute, the
    loss and gradient norm held against the no-recipe step's ``m_base`` to
    TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL, the step's seconds and peak
    memory."""
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    step = trainer.make_train_step(cfg, recipe, ocfg, microbatches=TRAIN_MICROBATCHES)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    m = step(shards, optimizer.init_opt_state(shards, ocfg),
             sharding.local_batch(recipe, batch, microbatches=TRAIN_MICROBATCHES))[2]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    expected = TRAIN_MICROBATCHES * cfg.n_layers * 2
    if launches != expected:
        raise AssertionError(f"tp recipe step launched flash_attention {launches} times, "
                             f"expected {expected}")
    loss_err = abs(m["loss"].item() - m_base["loss"].item()) / m_base["loss"].item()
    norm_err = abs(m["grad_norm"].item() - m_base["grad_norm"].item()) / \
        m_base["grad_norm"].item()
    if loss_err > TRAIN_LOSS_RTOL or norm_err > TRAIN_GRAD_RTOL:
        raise AssertionError(f"tp recipe step vs no recipe: loss {loss_err}, grad norm "
                             f"{norm_err}")
    out = dict(attn_mode=recipe.attn_mode, flash_attention_launches=launches, expected=expected,
               loss=m["loss"].item(), loss_rel_err=loss_err, grad_norm=m["grad_norm"].item(),
               grad_norm_rel_err=norm_err, step_s=step_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, layers=cfg.n_layers,
               tokens=TRAIN_BATCH * SEQ, tol=dict(loss=TRAIN_LOSS_RTOL, grad_norm=TRAIN_GRAD_RTOL))
    phase("recipe_train", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl", **out)
    return out


def scan_by_kind(prof) -> dict[str, float]:
    """:func:`by_ranges` of the SSM mixers' ``ssm.scan`` ranges: the
    attention kernels, the mixers' recurrent work (the conv, the decays,
    the chunked products and the state loop, the norms), cuBLAS GEMMs (the
    projections and the head) and the rest."""
    return by_ranges(prof, SCAN_RANGES)


def check_forward_instance(ops, card: str, label: str, dims, causal: bool, pieces: int,
                           seed: int) -> dict:
    """``kernel_instance``: the forward kernel at ``dims`` (B, Hq, G, Sq, Skv,
    D), bf16 and float32, against its plain version (ATTN_TOL) and itself
    (two launches bitwise); the bf16 kernel against float64 (at most
    ACCURACY_RATIO times the plain version's error); the bf16 time beside
    its bound, its plain version and ``scaled_dot_product_attention``.
    Returns the bf16 row."""
    from torch.nn.attention import SDPBackend

    B, Hq, G, Sq, Skv, D = dims
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        q = randn((B, Hq, Sq, D), dt, seed)
        k, v = (randn((B, G, Skv, D), dt, seed + i) for i in (1, 2))
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
        torch.testing.assert_close(got, want, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
        if not torch.equal(got, ops.flash_attention(q, k, v, causal=causal)):
            raise AssertionError(f"flash_attention {label} {dt}: two launches differ")
        row = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                   tol=ATTN_TOL[dt], two_launches="bitwise")
        if dt == torch.bfloat16:
            exact = exact_attention(q, k, v, causal=causal)
            errs = {"kernel": (got.double() - exact).abs().max().item(),
                    "plain": (want.double() - exact).abs().max().item()}
            ratio = errs["kernel"] / errs["plain"]
            if ratio > ACCURACY_RATIO:
                raise AssertionError(f"flash_attention {label} error against float64 over "
                                     f"{ACCURACY_RATIO}x the plain version's: {errs}")
            del exact
            qf, kf, vf = q.float(), k.float(), v.float()
            t = time_three(lambda: ops.flash_attention(q, k, v, causal=causal),
                           lambda: ops.flash_attention(q, k, v, causal=causal, impl="ref"),
                           lambda: library_attention(qf, kf, vf, is_causal=causal),
                           lambda: library_attention(q, k, v, is_causal=causal))
            # causal here is Sq == Skv, top-left: half the score matrix
            flops = 4 * B * Hq * Sq * Skv * D * (0.5 if causal else 1.0)
            b_ms, b_by, fp32_ms = attn_bound(flops, 2 * (2 * q.numel() + k.numel() + v.numel()),
                                             products=1 + pieces)
            row.update(error_vs_float64=errs, error_vs_float64_ratio=ratio,
                       limit=ACCURACY_RATIO, bound_ms=b_ms, bound_by=b_by,
                       fp32_bound_ms=fp32_ms, tflops=flops / t["ms"] / 1e9,
                       library_bf16_backend=SDPBackend(torch._fused_sdp_choice(
                           q, k, v, is_causal=causal)).name, **t)
            check_bound(f"flash_attention {label}", row)
            del qf, kf, vf
        rows[dt] = row
        phase("kernel_instance", kernel="flash_attention", case=label, shape=dims,
              causal=causal, dtype=str(dt), card=card, **row)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows[torch.bfloat16]


def check_decode_instance(ops, card: str, label: str, dims, lens, seed: int, *,
                          at_last: bool = False, Dv: int | None = None, start=None) -> dict:
    """``kernel_instance``: the decode kernel at ``dims`` (B, Hq, G, S, T, D),
    v ``Dv`` wide (by default D), with cache lengths ``lens`` (``at_last``:
    each slot's one query at its own last position, a length past T a ring
    buffer wrapped, every slot valid; ``start``: each slot's first query
    position, a prefill chunk), bf16 and float32, against its plain version
    and itself; the bf16 kernel's per-block rounding
    (:func:`rounding_margins`); the bf16 time beside its bound (the bytes
    of the visible K/V, or the operations its rows' visible keys need),
    its plain version and ``scaled_dot_product_attention``.  Returns the
    bf16 row."""
    B, Hq, G, S, T, D = dims
    Dv = Dv or D
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        q, kc, vc, lens_t, pos = decode_inputs(*dims, dt, lens=lens, start=start, seed=seed,
                                               Dv=Dv)
        if at_last:
            pos = (lens_t - 1)[:, None]
        got = ops.flash_decode(q, kc, vc, lens_t, q_positions=pos)
        torch.cuda.synchronize()
        want = ops.flash_decode(q, kc, vc, lens_t, q_positions=pos, impl="ref")
        if got.shape != (B, Hq, S, Dv):
            raise AssertionError(f"flash_decode {label}: output {tuple(got.shape)}")
        torch.testing.assert_close(got, want, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
        if not torch.equal(got, ops.flash_decode(q, kc, vc, lens_t, q_positions=pos)):
            raise AssertionError(f"flash_decode {label} {dt}: two launches differ")
        row = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                   tol=ATTN_TOL[dt], two_launches="bitwise")
        if dt == torch.bfloat16:
            row["mean_abs_diff_from"] = rounding_margins(ops, got, want, q, kc, vc, lens_t, pos,
                                                         lens_t > 0)
            t_idx = torch.arange(T, device=DEVICE)
            mask = t_idx[None, None, None, :] < lens_t.clamp(max=T)[:, None, None, None]
            if pos is not None:
                mask = mask & (t_idx[None, None, None, :] <= pos[:, None, :, None])
            qf, kf, vf = q.float(), kc.float(), vc.float()
            t = time_three(lambda: ops.flash_decode(q, kc, vc, lens_t, q_positions=pos),
                           lambda: ops.flash_decode(q, kc, vc, lens_t, q_positions=pos,
                                                    impl="ref"),
                           lambda: library_attention(qf, kf, vf, attn_mask=mask),
                           lambda: library_attention(q, kc, vc, attn_mask=mask), plain_iters=5)
            # the work this run's data needs: each row's visible keys
            cached = sum(min(n, T) for n in lens)
            if pos is None:
                visible = S * cached
            else:
                seen = torch.minimum(pos.long() + 1, lens_t[:, None].long().clamp(max=T))
                visible = int(seen.clamp(min=0).sum())
            b_ms, b_by, fp32_ms = attn_bound(
                2 * Hq * visible * (D + Dv),
                2 * G * (D + Dv) * cached + 2 * (q.numel() + got.numel()),
                pv_flops=2 * Hq * visible * Dv)
            row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms, **t)
            check_bound(f"flash_decode {label}", row)
            del qf, kf, vf, mask
        rows[dt] = row
        phase("kernel_instance", kernel="flash_decode", case=label, shape=dims, Dv=Dv,
              lens=lens, start=start, dtype=str(dt), card=card, **row)
        del q, kc, vc, got, want
    torch.cuda.empty_cache()
    return rows[torch.bfloat16]


def check_mla_decode(ops, card: str) -> dict:
    """The decode kernel's (96, 64) instance at minicpm3-4b's widths (40
    heads, MHA; q/k of d_nope + d_rope = 96, v of d_v = 64): a decode step of
    4 slots over a 4096-position cache (lengths DECODE_LENS) and a prefill
    chunk of 4 x 2048 queries (lengths 2047, 1000, 300, 0: two prompts from
    0, a resident slot, an idle one), each :func:`check_decode_instance`.
    The model's own decode is the absorbed form, with no kernel; this
    instance is the reference's ``flash_decode_pallas`` with a v head dim of
    its own, reached through ``ops.flash_decode``."""
    H, D, Dv = MLA_HEADS, MLA_D, MLA_DV
    return {"step": check_decode_instance(ops, card, "mla_decode_step",
                                          (SLOTS, H, H, 1, MAX_LEN, D), DECODE_LENS, 200, Dv=Dv),
            "prefill_chunk": check_decode_instance(ops, card, "mla_prefill_chunk",
                                                   (SLOTS, H, H, 2048, MAX_LEN, D),
                                                   (2047, 1000, 300, 0), 210, Dv=Dv,
                                                   start=(0, 0, 300, 0))}


def check_hybrid_kernels(ops, card: str, pieces: int) -> dict:
    """The flash-attention kernel's (112, 112) instances
    at zamba2's forward shape (q/k/v 1x32x4096x112, causal, MHA) and the
    flash-decode kernel's D = 112 instances at its decode step (MHA, 32
    heads; 5 slots of a 4096-position cache, lengths HYBRID_DECODE_LENS,
    the last wrapped past it: every slot valid and the query past T)
    (:func:`check_forward_instance`, :func:`check_decode_instance`)."""
    H, D = HYBRID_HEADS, HYBRID_HEAD_DIM
    return {"flash_attention": check_forward_instance(ops, card, "zamba2_forward",
                                                      (1, H, H, SEQ, SEQ, D), True, pieces, 180),
            "flash_decode": check_decode_instance(ops, card, "zamba2_decode_step",
                                                  (len(HYBRID_DECODE_LENS), H, H, 1, MAX_LEN, D),
                                                  HYBRID_DECODE_LENS, 190, at_last=True)}


class nudged_attention:
    """Inside the block, the plain attention's outputs (``ops.flash_attention``
    with ``impl="ref"``) each move one ulp of their dtype up or down, by a
    seeded coin: the plain path perturbed by as much as a kernel that rounds
    its output one ulp apart could move it."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig = ops, ops.flash_attention

        def nudged(q, k, v, **kw):
            o = self.orig(q, k, v, **kw)
            up = torch.rand(o.shape, device=o.device, generator=self.gen) < 0.5
            return torch.nextafter(o, torch.where(up, float("inf"), float("-inf")).to(o.dtype))

        ops.flash_attention = nudged
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.orig


def hybrid_qkv(S: int, dtype, seed: int, *, pad_to: int | None = None):
    """zamba2's shared-attention operands over S tokens (q/k/v 1 x 32 x S x
    112, MHA), zero-padded to ``pad_to`` positions as the ring pads a
    ragged sequence."""
    q, k, v = (randn((1, HYBRID_HEADS, S, HYBRID_HEAD_DIM), dtype, seed + i) for i in range(3))
    if pad_to is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad_to - S)) for x in (q, k, v))
    return q, k, v


def check_hybrid_carry(ops, card: str, ring_step_offsets, ragged_seq_extents,
                       pieces: int) -> dict:
    """``hybrid_carry``: the carry form's (112, 112) instance at zamba2's
    shapes, bf16 and float32, against its plain version: ranks 1 and 3 of a
    4-rank ring over SEQ tokens and over a ragged SEQ - 1 (padded keys
    masked by ``valid_len``), each a diagonal step from the empty state and
    then an off-diagonal step from the state it left (the ring's own offset
    helper), in acc, m and l; the ring's one step of the whole sequence on
    one card; carry steps over 4 chunks of 1024 keys chained in block order
    equal to the single-shot (112, 112) kernel bitwise, causal and not; two
    launches bitwise equal.  Times (bf16, ``queued_ms``) of the
    off-diagonal and diagonal steps and of the one-card step beside their
    bounds (``attn_bound``: the bf16 products, p @ v in ``pieces`` pieces,
    and the state read and written once) and the plain version's; no
    PyTorch call returns the unnormalized state."""
    from repro_torch.kernels.timing import queued_ms

    out, worst = {}, 0.0
    for dt in (torch.bfloat16, torch.float32):
        for S in (SEQ, SEQ - 1):
            cap, _ = ragged_seq_extents(S, RING_R)
            valid = None if S == RING_R * cap else S
            q, k, v = hybrid_qkv(S, dt, 200, pad_to=RING_R * cap)
            errs, calls = {"acc": 0.0, "m": 0.0, "l": 0.0}, 0
            for rank in (1, RING_R - 1):
                qr = q[:, :, rank * cap:(rank + 1) * cap]
                state = plain_carry(qr)
                for step in (0, 1):  # diagonal, then off-diagonal
                    q_off, k_off = ring_step_offsets(rank, step, RING_R, cap)
                    blk = slice(k_off, k_off + cap)
                    kw = dict(q_offset=q_off, k_offset=k_off, valid_len=valid, causal=True)
                    want = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], state,
                                                     impl="ref", **kw)
                    got = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk],
                                                    tuple(t.clone() for t in state), **kw)
                    torch.cuda.synchronize()
                    for name, g, w in zip(("acc", "m", "l"), got, want):
                        torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
                        errs[name] = max(errs[name], (g - w).abs().max().item())
                    if step == 1 and not torch.equal(got[0], ops.flash_attention_carry(
                            qr, k[:, :, blk], v[:, :, blk], tuple(t.clone() for t in state),
                            **kw)[0]):
                        raise AssertionError(f"carry (112, 112) {dt}: two launches differ")
                    state, calls = want, calls + 1
            if dt == torch.bfloat16:
                worst = max(worst, *errs.values())
            phase("hybrid_carry_check", arch=HYBRID_ARCH, ring=RING_R, seq=S, chunk=cap,
                  valid_len=valid, ranks=(1, RING_R - 1), steps=("diagonal", "off_diagonal"),
                  dtype=str(dt), calls=calls, max_abs_err=errs, tol=ATTN_TOL[dt],
                  two_launches="bitwise")
            del q, k, v
        q, k, v = hybrid_qkv(SEQ, dt, 210)
        want = ops.flash_attention_carry(q, k, v, None, impl="ref")
        got = ops.flash_attention_carry(q, k, v, None)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("acc", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
            errs[name] = (g - w).abs().max().item()
        if dt == torch.bfloat16:
            worst = max(worst, *errs.values())
        del got, want
        for causal in (True, False):
            chained = chain(ops, q, k, v, causal=causal)
            single = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(chained, single):
                raise AssertionError(f"carry chain (112, 112) != single-shot kernel ({dt}, "
                                     f"causal={causal}): max |diff| "
                                     f"{(chained.float() - single.float()).abs().max()}")
        phase("hybrid_carry_chain", shape=tuple(q.shape), chunks=RING_R, dtype=str(dt),
              one_card_step_max_abs_err=errs, tol=ATTN_TOL[dt],
              chain_equals_single_shot="bitwise, causal and not")
        del q, k, v, chained, single
    cap = SEQ // RING_R
    q, k, v = hybrid_qkv(SEQ, torch.bfloat16, 220)
    qr = q[:, :, cap:2 * cap]
    cases = []
    for label, step in (("diagonal", 0), ("off_diagonal", 1)):
        q_off, k_off = ring_step_offsets(1, step, RING_R, cap)
        cases.append((label, qr, k[:, :, k_off:k_off + cap], v[:, :, k_off:k_off + cap],
                      dict(q_offset=q_off, k_offset=k_off, causal=True),
                      cap * (cap + 1) // 2 if step == 0 else cap * cap))
    cases.append(("one_card_step", q, k, v, dict(causal=True), SEQ * (SEQ + 1) // 2))
    for label, qq, kb, vb, kw, pairs in cases:
        carry = plain_carry(qq)
        t = dict(ms=queued_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry, **kw)),
                 plain_ms=queued_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry,
                                                                      impl="ref", **kw),
                                    iters=5 if label == "one_card_step" else 20),
                 library_ms=None,
                 call_ms=median_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry, **kw)))
        flops = 4 * HYBRID_HEADS * pairs * HYBRID_HEAD_DIM
        nbytes = 2 * (qq.numel() + kb.numel() + vb.numel()) + \
            2 * 4 * sum(c.numel() for c in carry)
        b_ms, b_by, fp32_ms = attn_bound(flops, nbytes, products=1 + pieces)
        out[label] = dict(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms, **t)
        check_bound(f"flash_attention_carry (112, 112) {label}", out[label])
        phase("time", kernel="flash_attention_carry", arch=HYBRID_ARCH, case=label,
              q=tuple(qq.shape), kv=tuple(kb.shape), dtype="bfloat16", card=card,
              library="none: no PyTorch call returns the unnormalized (acc, m, l)",
              tflops=flops / t["ms"] / 1e9, **out[label])
        del carry
    del q, k, v, qr, cases
    torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


def host_ms(fn, n: int) -> float:
    """Host-clock ms per call of ``fn`` over ``n`` calls, the card
    synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def recurrent_recipe_forward(cfg, params, lm, fa, mesh, sharding, shard_params_by_recipe,
                             no_recipe_window: dict) -> dict:
    """``recurrent_recipe_forward``: the forward of the forward phase's 1 x
    SEQ tokens under ``make_recipe(cfg, mesh, attn_mode=...)`` for each mode
    of RECURRENT_RECIPE_MODES, on a one-rank NCCL ``(data, model)`` mesh and
    the rank's shards (views: one rank cuts nothing).  zamba2's shared
    attention launches the (112, 112) forward instance once an application
    under ``tp`` and ``sp``, and under ``sp_ring`` the ring's one step, the
    carry instance, in its place; rwkv6 launches no attention kernel.
    Logits under ``tp`` equal the no-recipe forward's bitwise (the same
    program on one rank), the other modes' within LOGIT_TOL (and whether
    bitwise).  Times, in turns with the no-recipe forward (no recipe, each
    mode, no recipe): host ms of a forward (:func:`host_ms`, 2 calls); and
    for ``sp_ring``, the mode whose kernels differ, one forward's window
    (:func:`window`: host and device ms, idle share, kernels launched,
    device ms by kind) beside the forward phase's no-recipe window
    (``no_recipe_window``).  The other modes launch the same kernels on the
    same operands (bitwise logits) and are not profiled: a profiled forward
    of these models takes seconds of trace processing."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}
    want = lm.forward(params, batch, cfg)[0]
    specs = lm.build_specs(cfg)
    n_shared = lm.hybrid_dims(cfg)[0] if cfg.family == "hybrid" else 0
    fns = {"no_recipe": lambda: lm.forward(params, batch, cfg)}
    out = {}
    for mode in RECURRENT_RECIPE_MODES[cfg.name]:
        recipe = sharding.make_recipe(cfg, mesh, attn_mode=mode)
        shards = shard_params_by_recipe(params, specs, recipe)
        fa.flash_attention_cuda.launches = fa.flash_attention_carry_cuda.launches = 0
        with sharding.use_recipe(recipe):
            mine = sharding.local_batch(recipe, batch)
            got = lm.gather_logits(lm.forward(shards, mine, cfg)[0], recipe, 1)
        torch.cuda.synchronize()
        launches = (fa.flash_attention_cuda.launches, fa.flash_attention_carry_cuda.launches)
        expected = (0, n_shared) if mode == "sp_ring" else (n_shared, 0)
        if launches != expected:
            raise AssertionError(f"{cfg.name} recipe forward {mode}: (flash_attention, carry) "
                                 f"launches {launches} != {expected}")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name} recipe forward {mode}: logits {tuple(got.shape)} "
                                 "not finite or not the expected shape")
        err = (got - want).abs().max().item()
        bitwise = torch.equal(got, want)
        del got
        if (mode == "tp" and not bitwise) or err > LOGIT_TOL:
            raise AssertionError(f"{cfg.name} recipe forward {mode} vs no recipe: max |diff| "
                                 f"{err} (bitwise {bitwise}; tp must be bitwise, the others "
                                 f"within {LOGIT_TOL})")

        def fwd(shards=shards, recipe=recipe):
            with sharding.use_recipe(recipe):
                lm.forward(shards, sharding.local_batch(recipe, batch), cfg)

        fns[mode] = fwd
        out[mode] = dict(flash_attention_launches=launches[0],
                         flash_attention_carry_launches=launches[1], logits_max_abs_err=err,
                         bitwise_equal_no_recipe=bitwise, tol=LOGIT_TOL)
    host = {name: [] for name in fns}
    for name in ("no_recipe", *out, "no_recipe"):
        host[name].append(host_ms(fns[name], 2))
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched", "device_ms_by_kind")
    ring = window(fns["sp_ring"], 1, classify=scan_by_kind)
    if cfg.family == "hybrid" and not any("flash_attention_kernel_wgmma" in n
                                          for n in ring["port_kernels"]):
        raise AssertionError(f"the profiled sp_ring forward ran no flash_attention_kernel_wgmma: "
                             f"{ring['port_kernels']}")
    for mode, row in out.items():
        row.update(host_ms=host[mode], no_recipe_host_ms=host["no_recipe"])
        if mode == "sp_ring":
            row.update(forward={k: ring[k] for k in keys},
                       no_recipe_forward={k: no_recipe_window[k] for k in keys},
                       kernels_launched_vs_no_recipe=ring["kernels_launched"] -
                       no_recipe_window["kernels_launched"])
        phase("recurrent_recipe_forward", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl",
              attn_mode=mode, tokens=SEQ, **row)
    del want, fns
    torch.cuda.empty_cache()
    return out


def recurrent_recipe_serve(cfg, params, lm, Engine, ServeConfig, fd, mesh, sharding,
                           shard_params_by_recipe, single_done: dict) -> dict:
    """``recurrent_recipe_serve``: the serving phase's requests through
    ``Engine(recipe=make_recipe(cfg, mesh, attn_mode="tp"))`` on a one-rank
    NCCL mesh, on the rank's shards and its blocks of the decode state
    (prefilled token by token, a slot reused): every request finishes,
    zamba2's ``flash_decode`` launches once a shared application in every
    step, and the greedy tokens equal the single-host kernel run's
    (``single_done``) exactly (the same program on one rank).  Then the
    host ms of RECURRENT_RECIPE_STEPS steady decode steps (:func:`host_ms`;
    the first SLOTS prompts cut to RECURRENT_RECIPE_PROMPT tokens) in turns
    with the single-host engine's on the same requests (single host,
    recipe, recipe, single host)."""
    requests = recurrent_prompts(cfg)
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    per_step = lm.hybrid_dims(cfg)[0] if cfg.family == "hybrid" else 0
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)

    def engine_for(prompts, recipe=recipe):
        engine = Engine(cfg, params if recipe is None else shards, scfg, recipe=recipe)
        for rid, prompt in enumerate(prompts):
            engine.submit(rid, prompt, RECURRENT_NEW_TOKENS)
        return engine

    engine = engine_for(requests)
    stats = _instrument(engine, record_gaps=False, fd=fd)
    fd.flash_decode_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.flash_decode_cuda.launches
    by_kind = {kind: per_step * engine.steps[kind] for kind in ("prefill", "decode")}
    if stats["launches"] != by_kind or launches != sum(by_kind.values()):
        raise AssertionError(f"{cfg.name} recipe serve: flash_decode launches "
                             f"{stats['launches']} (total {launches}) != {by_kind}")
    if done != single_done:
        raise AssertionError(f"{cfg.name} recipe serve: greedy tokens differ from the "
                             "single-host run's")
    steps = dict(engine.steps)
    del engine
    torch.cuda.empty_cache()
    short = [r[:RECURRENT_RECIPE_PROMPT] for r in requests[:SLOTS]]
    engines = {"single_host": engine_for(short, None), "recipe": engine_for(short)}
    for engine in engines.values():
        engine._fill_slots()
        engine._decode_once()
    host = {name: [] for name in engines}
    for name in ("single_host", "recipe", "recipe", "single_host"):
        host[name].append(host_ms(engines[name]._decode_once, RECURRENT_RECIPE_STEPS))
    del engines
    torch.cuda.empty_cache()
    out = dict(mesh=dict(mesh.shape), attn_mode=recipe.attn_mode, requests=len(requests),
               slots=SLOTS, max_len=MAX_LEN, new_tokens=RECURRENT_NEW_TOKENS,
               slot_reuses=len(requests) - SLOTS, steps=steps, flash_decode_launches=launches,
               flash_decode_launches_by_kind=stats["launches"], prefill_s=stats["prefill_s"],
               decode_s=stats["decode_s"], wall_s=wall,
               decode_tok_s=len(requests) * RECURRENT_NEW_TOKENS / stats["decode_s"],
               greedy_tokens_equal_single_host=True, decode_step_host_ms=host["recipe"],
               single_host_decode_step_host_ms=host["single_host"])
    phase("recurrent_recipe_serve", arch=cfg.name, backend="nccl", **out)
    return out


def recurrent_model(configs, lm, name: str):
    """``recurrent_model``: ``name`` at full width, FAMILY_DEPTH layers,
    with :func:`seeded_params` (bf16)."""
    cfg = dataclasses.replace(configs.get(name), n_layers=FAMILY_DEPTH[name])
    t0 = time.perf_counter()
    params = seeded_params(cfg, lm)
    torch.cuda.synchronize()
    phase("recurrent_model", arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
          d_model=cfg.d_model, heads=(cfg.n_heads, cfg.n_kv, cfg.head_dim), d_ff=cfg.d_ff,
          vocab=cfg.vocab, params=lm.count_params(cfg), init_s=time.perf_counter() - t0,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    return cfg, params


def recurrent_forward(cfg, params, lm, fa, fd) -> dict:
    """``hybrid_forward`` / ``ssm_forward``: the forward of 1 x SEQ seeded
    tokens; the hybrid's through the kernel (``flash_attention`` launched
    once a shared application, the profiled forward on
    ``flash_attention_kernel_wgmma`` and no library attention kernel) and
    through its plain version, logits at every token held within
    HYBRID_LOGIT_MARGIN of the one-ulp control (:func:`nudged_attention`); the
    SSM's launches no attention kernel.  Forward ms, peak memory, and where
    the device time goes (:func:`window` by :func:`scan_by_kind`)."""
    hybrid = cfg.family == "hybrid"
    g = torch.Generator(device=DEVICE).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}
    fa.flash_attention_cuda.launches = fd.flash_decode_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    logits, _ = lm.forward(params, batch, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = (fa.flash_attention_cuda.launches, fd.flash_decode_cuda.launches)
    expected = (lm.hybrid_dims(cfg)[0] if hybrid else 0, 0)
    if launches != expected:
        raise AssertionError(f"{cfg.name} forward: attention launches {launches} != {expected}")
    if logits.shape != (1, SEQ, cfg.vocab_padded) or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} forward logits {tuple(logits.shape)} not finite")
    out = dict(tokens=SEQ, flash_attention_launches=launches[0], peak_memory_gb=peak)
    if hybrid:
        fa.flash_attention_cuda.launches = 0
        ref_logits, _ = lm.forward(params, batch, dataclasses.replace(cfg, attn_impl="ref"))
        torch.cuda.synchronize()
        if fa.flash_attention_cuda.launches:
            raise AssertionError("the plain hybrid forward launched the kernel")
        got, want = logits[..., :cfg.vocab].float(), ref_logits[..., :cfg.vocab].float()
        del logits, ref_logits
        with nudged_attention(seed=11):
            nudged = lm.forward(params, batch, dataclasses.replace(cfg, attn_impl="ref"))[0]
        control = rel_err(nudged[..., :cfg.vocab], want)
        del nudged
        rel = rel_err(got, want)
        if rel > HYBRID_LOGIT_MARGIN * control:
            raise AssertionError(f"{cfg.name} forward logits kernel vs plain: relative error "
                                 f"{rel} > {HYBRID_LOGIT_MARGIN} x the one-ulp control {control}")
        diff = (got - want).abs()
        out.update(logits_rel_err=rel, one_ulp_control_rel_err=control,
                   margin=HYBRID_LOGIT_MARGIN,
                   logits_max_abs_err=diff.max().item(),
                   logits_abs_err_p999=diff.flatten()[::97].quantile(0.999).item(),
                   logit_scale=want.abs().max().item(),
                   argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item())
        del got, want, diff
    else:
        del logits
    torch.cuda.empty_cache()
    forward_ms = median_ms(lambda: lm.forward(params, batch, cfg), iters=3, warmup=1)
    brk = window(lambda: lm.forward(params, batch, cfg), 2, classify=scan_by_kind)
    if hybrid and not any("flash_attention_kernel_wgmma" in n for n in brk["port_kernels"]):
        raise AssertionError(f"the profiled hybrid forward ran no flash_attention_kernel_wgmma: "
                             f"{brk['port_kernels']}")
    if brk["library_attention"] or (not hybrid and brk["port_kernels"]):
        raise AssertionError(f"{cfg.name}: attention kernels {brk['port_kernels']} "
                             f"{brk['library_attention']}")
    out.update(forward_ms=forward_ms, tokens_per_s=SEQ / forward_ms * 1e3, breakdown=brk)
    phase("hybrid_forward" if hybrid else "ssm_forward", arch=cfg.name, **out)
    torch.cuda.empty_cache()
    return out


def recurrent_prompts(cfg) -> list[list[int]]:
    rng = np.random.default_rng(1)
    return [rng.integers(2, cfg.vocab, size=int(rng.integers(*RECURRENT_PROMPT_LENS))).tolist()
            for _ in range(RECURRENT_REQUESTS)]


def recurrent_serve(cfg, params, lm, Engine, ServeConfig, fd) -> dict:
    """``hybrid_serve`` / ``ssm_serve``: RECURRENT_REQUESTS requests on
    SLOTS slots of MAX_LEN positions, prefilled token by token; more
    requests than slots, so slots are released and reused (their recurrent
    state zeroed).  The hybrid runs through the decode kernel
    (``flash_decode`` launched once a shared application every step,
    counted by step kind) and through its plain version: greedy tokens equal
    except at the plain run's near ties, first prefill logits to LOGIT_TOL;
    the TMA map cache's hits and misses over the kernel run.  The SSM runs
    no kernel.  Then a steady decode step of SLOTS resident requests, their
    prompts cut to the shortest length (:func:`window` by
    :func:`scan_by_kind`)."""
    hybrid = cfg.family == "hybrid"
    per_step = lm.hybrid_dims(cfg)[0] if hybrid else 0
    requests = recurrent_prompts(cfg)
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)
    runs = {}
    for impl in ((None, "ref") if hybrid else (None,)):
        engine = Engine(dataclasses.replace(cfg, attn_impl=impl), params, scfg)
        stats = _instrument(engine, record_gaps=True, fd=fd)
        for rid, prompt in enumerate(requests):
            engine.submit(rid, prompt, RECURRENT_NEW_TOKENS)
        maps = fd.map_cache_stats()
        fd.flash_decode_cuda.launches = 0
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fd.flash_decode_cuda.launches
        maps = {k: v - maps[k] for k, v in fd.map_cache_stats().items()}
        if sorted(done) != list(range(RECURRENT_REQUESTS)) or any(
                len(done[r]) != len(requests[r]) + RECURRENT_NEW_TOKENS
                for r in range(RECURRENT_REQUESTS)):
            raise AssertionError(f"{cfg.name} serve {impl}: not every request finished")
        by_kind = {kind: per_step * engine.steps[kind] if impl is None else 0
                   for kind in ("prefill", "decode")}
        if launches != sum(by_kind.values()) or stats["launches"] != by_kind:
            raise AssertionError(f"{cfg.name} serve {impl}: flash_decode launches {launches}, "
                                 f"by kind {stats['launches']} != {by_kind}")
        runs[impl] = dict(done=done, stats=stats, steps=dict(engine.steps), wall=wall,
                          launches=launches, maps=maps)
        del engine
        torch.cuda.empty_cache()
    k = runs[None]
    st = k["stats"]
    out = dict(requests=RECURRENT_REQUESTS, slots=SLOTS, max_len=MAX_LEN,
               new_tokens=RECURRENT_NEW_TOKENS, prompt_lens=[len(r) for r in requests],
               slot_reuses=RECURRENT_REQUESTS - SLOTS, steps=k["steps"],
               flash_decode_launches=k["launches"], flash_decode_launches_by_kind=st["launches"],
               prefill_s=st["prefill_s"],
               prefill_s_per_token=st["prefill_s"] / k["steps"]["prefill"],
               decode_s=st["decode_s"],
               serve_decode_tok_s=RECURRENT_REQUESTS * RECURRENT_NEW_TOKENS / st["decode_s"],
               wall_s=k["wall"], peak_kv_occupancy=st["peak_occupancy"])
    if hybrid:
        p = runs["ref"]
        prefill_err = max((k["stats"]["first_prefill"][i] - p["stats"]["first_prefill"][i])
                          .float().abs().max().item() for i in p["stats"]["first_prefill"])
        if prefill_err > LOGIT_TOL:
            raise AssertionError(f"{cfg.name} first prefill logits kernel vs plain: "
                                 f"{prefill_err} > {LOGIT_TOL}")
        agree, near_ties = greedy_agreement(requests, k["done"], p["done"], p["stats"]["gaps"],
                                            "kernel", "plain", new_tokens=RECURRENT_NEW_TOKENS)
        lookups = k["maps"]["hits"] + k["maps"]["misses"]
        out.update(plain_wall_s=p["wall"], first_prefill_logits_max_abs_err=prefill_err,
                   tol=LOGIT_TOL, greedy_agreement=agree, divergences_at_near_ties=near_ties,
                   tma_map_cache=dict(k["maps"], hit_rate=k["maps"]["hits"] / max(lookups, 1)))
    engine = Engine(cfg, params, scfg)
    for rid, prompt in enumerate(requests[:SLOTS]):  # the shortest prompt's length each
        engine.submit(rid, prompt[:RECURRENT_PROMPT_LENS[0]], RECURRENT_NEW_TOKENS)
    engine._fill_slots()
    engine._decode_once()
    fd.flash_decode_cuda.launches = 0
    dec = window(engine._decode_once, RECURRENT_WINDOW_STEPS, classify=scan_by_kind)
    if fd.flash_decode_cuda.launches != 2 * RECURRENT_WINDOW_STEPS * per_step:
        raise AssertionError(f"{cfg.name} decode steps: flash_decode launches "
                             f"{fd.flash_decode_cuda.launches} != "
                             f"{2 * RECURRENT_WINDOW_STEPS * per_step}")
    if hybrid and not any("flash_decode_kernel_wgmma" in n for n in dec["port_kernels"]):
        raise AssertionError(f"the profiled hybrid decode ran no flash_decode_kernel_wgmma: "
                             f"{dec['port_kernels']}")
    out.update(decode_step=dec, decode_step_cache_lens=list(engine.ledger.lengths),
               decode_tok_s=SLOTS / dec["wall_ms"] * 1e3)
    del engine
    torch.cuda.empty_cache()
    phase("hybrid_serve" if hybrid else "ssm_serve", arch=cfg.name, **out)
    out["done"] = k["done"]  # the kernel run's tokens, which the recipe run is held to
    return out


def recurrent_decode_vs_forward(configs, lm, name: str) -> dict:
    """``recurrent_check``: ``name`` at full width, float32 activations,
    the depth cut to RECURRENT_CHECK[name] layers and the chunk to
    RECURRENT_CHECK_CHUNK[name]: the logits of
    RECURRENT_CHECK_TOKENS decode steps of one token (the exact recurrence
    and, for the hybrid, the float32 decode kernel over the ring-buffer
    cache) against the forward over the same tokens (the chunked form and
    the float32 forward kernel), to RECURRENT_TOL, the reference's own
    tolerance for these families."""
    cfg = dataclasses.replace(configs.get(name), n_layers=RECURRENT_CHECK[name],
                              act_dtype=torch.float32, ssm_chunk=RECURRENT_CHECK_CHUNK[name])
    params = lm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(6), device=DEVICE)
    B, S = 2, RECURRENT_CHECK_TOKENS
    g = torch.Generator(device=DEVICE).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (B, S), device=DEVICE, generator=g)
    full, _ = lm.forward(params, {"tokens": tokens}, cfg)
    state = lm.DecodeState(lm.init_cache(cfg, B, S, device=DEVICE),
                           torch.zeros((B,), dtype=torch.int32, device=DEVICE))
    steps = []
    for t in range(S):
        logits, state = lm.decode_step(params, state, {"tokens": tokens[:, t:t + 1]}, cfg)
        steps.append(logits)
    err = (torch.cat(steps, dim=1) - full).abs().max().item()
    scale = full.abs().max().item()
    if not err <= RECURRENT_TOL:
        raise AssertionError(f"{name} float32 decode vs forward: {err} > {RECURRENT_TOL}")
    out = dict(layers=cfg.n_layers, chunk=cfg.ssm_chunk, tokens=S, batch=B, max_abs_err=err,
               tol=RECURRENT_TOL, logit_scale=scale)
    phase("recurrent_check", arch=name, dtype="float32", **out)
    del params, full, state, steps
    torch.cuda.empty_cache()
    return out


def hybrid_train(configs, lm, fa, trainer, optimizer, tree_leaves, sharding,
                 shard_params_by_recipe, mesh) -> tuple[dict, dict]:
    """``hybrid_train``: zamba2 at full width, HYBRID_TRAIN_DEPTH layers
    (float32 masters, bf16 activations, remat by super-block and block): one
    ``make_train_step`` step of 1 x SEQ tokens after a warm-up step, its
    seconds and peak memory; its gradients through the (112, 112) kernel
    (``flash_attention`` launched once a shared application in the forward
    and once more in remat's recompute; the backward recomputes through the
    plain version), every leaf finite and nonzero but the LoRAs' ``lora_a``
    (zero while ``lora_b`` is at its zero initialisation), held against the
    same gradients through the plain attention.  Then ``hybrid_recipe_train``:
    the same step under the ``tp`` recipe on the one-rank NCCL ``mesh``, on
    the rank's shards (views), after a warm-up step as the no-recipe
    step's: the forward instance launched as often, its loss and gradient
    norm against the no-recipe step's (bitwise on one rank, held to
    TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL), seconds and peak memory."""
    cfg = dataclasses.replace(configs.get(HYBRID_ARCH), n_layers=HYBRID_TRAIN_DEPTH)
    params = lm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(8), device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(9)
    toks = torch.randint(0, cfg.vocab, (1, SEQ + 1), device=DEVICE, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fa.flash_attention_cuda.launches = 0
    loss, _, grads = trainer._accum_loss_grads(params, batch, cfg, 1)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    expected = 2 * lm.hybrid_dims(cfg)[0]
    if launches != expected:
        raise AssertionError(f"hybrid training step: flash_attention launches {launches} != "
                             f"{expected}")
    leaves = tree_leaves(grads)
    # lora_a's gradient goes through lora_b, which starts at zero
    zero_at_init = grads["shared_lora"]["lora_a"]
    for i, leaf in enumerate(leaves):
        nonzero = bool(leaf.abs().sum() > 0)
        if not torch.isfinite(leaf).all() or nonzero == (leaf is zero_at_init):
            raise AssertionError(f"hybrid gradient leaf {i} {tuple(leaf.shape)}: not finite, or "
                                 f"nonzero {nonzero} where {leaf is not zero_at_init} is due")
    plain_loss, _, plain = trainer._accum_loss_grads(
        params, batch, dataclasses.replace(cfg, attn_impl="ref"), 1)
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    errs = [rel_err(a, b) for a, b in zip(leaves, tree_leaves(plain))]
    del grads, plain, leaves
    torch.cuda.empty_cache()
    if loss_err > TRAIN_LOSS_RTOL or max(errs) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"hybrid kernel vs plain training step: loss {loss_err}, "
                             f"gradients {max(errs)}")
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    step = trainer.make_train_step(cfg, None, ocfg)
    opt = optimizer.init_opt_state(params, ocfg)
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_params, new_opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    if not np.isfinite(metrics["loss"].item()) or not np.isfinite(metrics["grad_norm"].item()):
        raise AssertionError(f"hybrid training step metrics not finite: {metrics}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del new_params, new_opt
    torch.cuda.empty_cache()
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    rstep = trainer.make_train_step(cfg, recipe, ocfg)
    mine = sharding.local_batch(recipe, batch)
    torch.cuda.reset_peak_memory_stats()
    rstep(shards, opt, mine)  # warm-up, as the no-recipe step's
    torch.cuda.synchronize()
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    m_rec = rstep(shards, opt, mine)[2]
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    rec_launches = fa.flash_attention_cuda.launches
    if rec_launches != expected:
        raise AssertionError(f"hybrid tp recipe step: flash_attention launches {rec_launches} "
                             f"!= {expected}")
    rec_loss_err = abs(m_rec["loss"].item() - metrics["loss"].item()) / metrics["loss"].item()
    rec_norm_err = abs(m_rec["grad_norm"].item() - metrics["grad_norm"].item()) / \
        metrics["grad_norm"].item()
    if rec_loss_err > TRAIN_LOSS_RTOL or rec_norm_err > TRAIN_GRAD_RTOL:
        raise AssertionError(f"hybrid tp recipe step vs no recipe: loss {rec_loss_err}, grad "
                             f"norm {rec_norm_err}")
    rec = dict(attn_mode=recipe.attn_mode, layers=cfg.n_layers, tokens=SEQ,
               flash_attention_launches=rec_launches, expected=expected,
               loss=m_rec["loss"].item(), loss_rel_err=rec_loss_err,
               grad_norm=m_rec["grad_norm"].item(), grad_norm_rel_err=rec_norm_err,
               bitwise_equal_no_recipe=bool(m_rec["loss"].item() == metrics["loss"].item() and
                                            m_rec["grad_norm"].item() ==
                                            metrics["grad_norm"].item()),
               step_s=rec_s, no_recipe_step_s=step_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               tol=dict(loss=TRAIN_LOSS_RTOL, grad_norm=TRAIN_GRAD_RTOL))
    phase("hybrid_recipe_train", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl", **rec)
    out = dict(layers=cfg.n_layers, params=lm.count_params(cfg), tokens=SEQ,
               flash_attention_launches=launches, expected=expected, loss=loss.item(),
               plain_loss=plain_loss.item(), loss_rel_err=loss_err, grad_rel_err_max=max(errs),
               grad_rel_err_median=float(np.median(errs)),
               tol=dict(loss=TRAIN_LOSS_RTOL, grads=TRAIN_GRAD_RTOL), step_s=step_s,
               tokens_per_s=SEQ / step_s, grad_norm=metrics["grad_norm"].item(),
               peak_memory_gb=peak_gb)
    phase("hybrid_train", arch=cfg.name, **out)
    del params, shards, opt
    torch.cuda.empty_cache()
    return out, rec


def mla_carry_state(B: int, H: int, S: int, tail: int = 0):
    """An empty carry state ``(acc (B, H, S, MLA_DV), m, l)``; with
    ``tail``, ``acc`` is the head of a float32 buffer whose last ``tail``
    elements hold the sentinel MLA_SENTINEL, returned as the fourth item, so
    a store past the state's columns shows."""
    n = B * H * S * MLA_DV
    buf = torch.full((n + tail,), MLA_SENTINEL, device=DEVICE)
    buf[:n] = 0.0
    return (buf[:n].view(B, H, S, MLA_DV), torch.full((B, H, S), -1e30, device=DEVICE),
            torch.zeros((B, H, S), device=DEVICE), buf[n:])


def check_mla_carry(ops, card: str, ring_step_offsets, pieces: int) -> dict:
    """``mla_carry_kernel``: the carry form's (96, 64) instance (new in this
    slice: MLA's queries and keys of 96, values and state of 64) at
    minicpm3-4b's shapes, bf16 and float32, against its plain version:
    ranks 1 and 3 of a 4-rank ring over SEQ tokens, a diagonal step from the
    empty state and then an off-diagonal step from the state it left, in
    acc, m and l, with MLA_SENTINEL_TAIL float32 sentinels right after the
    state's last row left untouched; the one-card step of the whole
    sequence; carry steps over 4 chunks of 1024 keys chained in block order
    equal to the single-shot (96, 64) forward instance bitwise, and a
    one-step chain equal to it bitwise, causal and not; two launches
    bitwise equal.  Times (bf16, ``queued_ms``) of the off-diagonal and
    diagonal steps and of the one-card step beside their bounds
    (``attn_bound``: q k^T at 96 columns, p @ v at 64 in ``pieces``
    pieces, the state read and written once) and the plain version's; no
    PyTorch call returns the unnormalized state."""
    from repro_torch.kernels.timing import queued_ms

    H, D, Dv = MLA_HEADS, MLA_D, MLA_DV
    out, worst = {}, 0.0

    def qkv(S, dt, seed):
        return randn((1, H, S, D), dt, seed), randn((1, H, S, D), dt, seed + 1), \
            randn((1, H, S, Dv), dt, seed + 2)

    for dt in (torch.bfloat16, torch.float32):
        cap = SEQ // RING_R
        q, k, v = qkv(SEQ, dt, 300)
        errs, calls = {"acc": 0.0, "m": 0.0, "l": 0.0}, 0
        for rank in (1, RING_R - 1):
            qr = q[:, :, rank * cap:(rank + 1) * cap]
            state = mla_carry_state(1, H, cap)[:3]
            for step in (0, 1):  # diagonal, then off-diagonal
                q_off, k_off = ring_step_offsets(rank, step, RING_R, cap)
                blk = slice(k_off, k_off + cap)
                kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
                want = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], state,
                                                 impl="ref", **kw)
                *mine, tail = mla_carry_state(1, H, cap, MLA_SENTINEL_TAIL)
                for t, src in zip(mine, state):
                    t.copy_(src)
                got = ops.flash_attention_carry(qr, k[:, :, blk], v[:, :, blk], tuple(mine), **kw)
                torch.cuda.synchronize()
                if got[0].shape != (1, H, cap, Dv):
                    raise AssertionError(f"carry (96, 64) state {tuple(got[0].shape)}")
                if not bool((tail == MLA_SENTINEL).all()):
                    raise AssertionError(f"carry (96, 64) {dt}: the kernel wrote past the "
                                         "state's 64 columns")
                for name, g, w in zip(("acc", "m", "l"), got, want):
                    torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
                    errs[name] = max(errs[name], (g - w).abs().max().item())
                if step == 1 and not torch.equal(got[0], ops.flash_attention_carry(
                        qr, k[:, :, blk], v[:, :, blk], tuple(t.clone() for t in state),
                        **kw)[0]):
                    raise AssertionError(f"carry (96, 64) {dt}: two launches differ")
                state, calls = want, calls + 1
        if dt == torch.bfloat16:
            worst = max(worst, *errs.values())
        phase("mla_carry_kernel", check="ring_steps", arch=MLA_ARCH, ring=RING_R, seq=SEQ,
              chunk=cap, ranks=(1, RING_R - 1), steps=("diagonal", "off_diagonal"), dtype=str(dt),
              calls=calls, max_abs_err=errs, tol=ATTN_TOL[dt], two_launches="bitwise",
              sentinels_past_the_state="untouched")
        want = ops.flash_attention_carry(q, k, v, None, impl="ref")
        got = ops.flash_attention_carry(q, k, v, None)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("acc", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
            errs[name] = (g - w).abs().max().item()
        if dt == torch.bfloat16:
            worst = max(worst, *errs.values())
        del got, want
        for causal in (True, False):
            single = ops.flash_attention(q, k, v, causal=causal)
            for chunks in (RING_R, 1):
                chained = chain(ops, q, k, v, causal=causal, chunks=chunks)
                torch.cuda.synchronize()
                if not torch.equal(chained, single):
                    raise AssertionError(
                        f"carry chain of {chunks} (96, 64) != single-shot kernel ({dt}, "
                        f"causal={causal}): max |diff| "
                        f"{(chained.float() - single.float()).abs().max()}")
        phase("mla_carry_kernel", check="chains", shape=(1, H, SEQ, D, Dv), chunks=(RING_R, 1),
              dtype=str(dt), one_card_step_max_abs_err=errs, tol=ATTN_TOL[dt],
              chain_equals_single_shot="bitwise, 4 chunks and 1, causal and not")
        del q, k, v, chained, single
    cap = SEQ // RING_R
    q, k, v = qkv(SEQ, torch.bfloat16, 320)
    qr = q[:, :, cap:2 * cap]
    cases = []
    for label, step in (("diagonal", 0), ("off_diagonal", 1)):
        q_off, k_off = ring_step_offsets(1, step, RING_R, cap)
        cases.append((label, qr, k[:, :, k_off:k_off + cap], v[:, :, k_off:k_off + cap],
                      dict(q_offset=q_off, k_offset=k_off, causal=True),
                      cap * (cap + 1) // 2 if step == 0 else cap * cap))
    cases.append(("one_card_step", q, k, v, dict(causal=True), SEQ * (SEQ + 1) // 2))
    for label, qq, kb, vb, kw, pairs in cases:
        carry = mla_carry_state(1, H, qq.shape[2])[:3]
        t = dict(ms=queued_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry, **kw)),
                 plain_ms=queued_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry,
                                                                      impl="ref", **kw),
                                    iters=5 if label == "one_card_step" else 20),
                 library_ms=None,
                 call_ms=median_ms(lambda: ops.flash_attention_carry(qq, kb, vb, carry, **kw)))
        qk, pv = 2 * H * pairs * D, 2 * H * pairs * Dv
        nbytes = 2 * (qq.numel() + kb.numel() + vb.numel()) + \
            2 * 4 * sum(c.numel() for c in carry)
        b_ms, b_by, fp32_ms = attn_bound(qk + pv, nbytes, products=1 + pieces, pv_flops=pv)
        out[label] = dict(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms, **t)
        check_bound(f"flash_attention_carry (96, 64) {label}", out[label])
        phase("time", kernel="flash_attention_carry", arch=MLA_ARCH, case=label,
              q=tuple(qq.shape), kv=tuple(kb.shape), v=tuple(vb.shape), dtype="bfloat16",
              card=card, library="none: no PyTorch call returns the unnormalized (acc, m, l)",
              tflops=(qk + pv) / t["ms"] / 1e9, **out[label])
        del carry
    del q, k, v, qr, cases
    torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


def latent_recipe_forward(cfg, params, lm, fa, mesh, sharding, shard_params_by_recipe,
                          no_recipe_window: dict, classify=None) -> dict:
    """``mla_recipe_forward`` / ``moe_recipe_forward``: the forward of 1 x
    SEQ seeded tokens under ``make_recipe(cfg, mesh, attn_mode=...)`` for
    ``tp``, ``sp`` and ``sp_ring`` on a one-rank NCCL ``(data, model)`` mesh
    and the rank's shards (views: one rank cuts nothing).  Every axis has
    one rank, so the logits equal the no-recipe forward's bitwise: ``tp``
    and ``sp`` launch the forward instance once a layer, ``sp_ring`` the
    ring's one carry step in its place.  For the MoE family the recipe's
    ``ep`` dispatch falls back (a model axis of one rank) with one warning
    a layer, as in the reference, and ``classify`` (:func:`moe_by_kind`)
    raises unless the profile holds the capacity dispatch's ``moe.*``
    ranges.  Times: host ms of a forward (:func:`host_ms`, 2 calls) in turns
    with the no-recipe forward (no recipe, each mode, no recipe), and each
    mode's profiled window (:func:`window`: host and device ms, idle share,
    kernels launched, device ms by kind) beside the family's no-recipe
    window (``no_recipe_window``)."""
    import warnings

    g = torch.Generator(device=DEVICE).manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, SEQ), device=DEVICE, generator=g)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ep without a recipe: the same fallback
        want = lm.forward(params, batch, cfg)[0]
    specs = lm.build_specs(cfg)
    fns = {"no_recipe": lambda: lm.forward(params, batch, cfg)}
    out = {}
    for mode in ("tp", "sp", "sp_ring"):
        recipe = sharding.make_recipe(cfg, mesh, attn_mode=mode)
        shards = shard_params_by_recipe(params, specs, recipe)
        fa.flash_attention_cuda.launches = fa.flash_attention_carry_cuda.launches = 0
        with sharding.use_recipe(recipe), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mine = sharding.local_batch(recipe, batch)
            got = lm.gather_logits(lm.forward(shards, mine, cfg)[0], recipe, 1)
        torch.cuda.synchronize()
        fell_back = sum("falling back" in str(w.message) for w in caught)
        launches = (fa.flash_attention_cuda.launches, fa.flash_attention_carry_cuda.launches)
        expected = (0, cfg.n_layers) if mode == "sp_ring" else (cfg.n_layers, 0)
        if launches != expected:
            raise AssertionError(f"{cfg.name} recipe forward {mode}: (flash_attention, carry) "
                                 f"launches {launches} != {expected}")
        want_back = cfg.n_layers if cfg.family == "moe" else 0
        if fell_back != want_back:
            raise AssertionError(f"{cfg.name} recipe forward {mode}: {fell_back} ep fallback "
                                 f"warnings, expected {want_back}")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name} recipe forward {mode}: logits {tuple(got.shape)} "
                                 "not finite or not the expected shape")
        if not torch.equal(got, want):
            raise AssertionError(f"{cfg.name} recipe forward {mode} vs no recipe on one rank: "
                                 f"max |diff| {(got.float() - want.float()).abs().max().item()} "
                                 "(must be bitwise)")
        del got

        def fwd(shards=shards, recipe=recipe):
            with sharding.use_recipe(recipe), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                lm.forward(shards, sharding.local_batch(recipe, batch), cfg)

        fns[mode] = fwd
        out[mode] = dict(flash_attention_launches=launches[0],
                         flash_attention_carry_launches=launches[1], ep_fallback_warnings=fell_back,
                         bitwise_equal_no_recipe=True)
    host = {name: [] for name in fns}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("no_recipe", *out, "no_recipe"):
            host[name].append(host_ms(fns[name], 2))
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched", "device_ms_by_kind")
    for mode, row in out.items():
        win = window(fns[mode], 1, classify=classify)
        if not any("flash_attention_kernel_wgmma" in n for n in win["port_kernels"]):
            raise AssertionError(f"the profiled {mode} forward ran no "
                                 f"flash_attention_kernel_wgmma: {win['port_kernels']}")
        row.update(host_ms=host[mode], no_recipe_host_ms=host["no_recipe"],
                   forward={k: win[k] for k in keys},
                   no_recipe_forward={k: no_recipe_window[k] for k in keys},
                   kernels_launched_vs_no_recipe=win["kernels_launched"] -
                   no_recipe_window["kernels_launched"])
        phase(f"{cfg.family}_recipe_forward", arch=cfg.name, layers=cfg.n_layers,
              mesh=dict(mesh.shape), backend="nccl", attn_mode=mode, tokens=SEQ, **row)
    del want, fns
    torch.cuda.empty_cache()
    return out


def latent_recipe_serve(cfg, params, lm, Engine, ServeConfig, fd, mesh, sharding,
                        shard_params_by_recipe, requests, new_tokens: int, single_done: dict,
                        decode_launches: int, classify=None) -> dict:
    """``mla_recipe_serve`` / ``moe_recipe_serve`` / ``audio_recipe_serve``:
    the family's serving requests cut to the first SLOTS (admitted together,
    so each row's tokens are those of the family's serving run) through
    ``Engine(recipe=make_recipe(cfg, mesh, attn_mode="tp"))`` on a one-rank
    NCCL mesh, on the rank's shards and its blocks of the decode state:
    every request finishes, ``flash_decode`` launches ``decode_launches``
    times a step (the MoE and audio families' layers; none in MLA's
    absorbed decode),
    and the greedy tokens equal the single-host run's (``single_done``)
    exactly (the same program on one rank).  Then a steady decode step's
    window (:func:`window`, RECIPE_DECODE_STEPS steps) under the recipe and
    of the single-host engine on the same requests, in turns (single host,
    recipe, recipe, single host)."""
    import warnings

    requests = requests[:SLOTS]
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    scfg = ServeConfig(max_len=MAX_LEN, batch_slots=SLOTS, eos_token=-1)

    def engine_for(recipe=recipe, extra: int = 0):
        engine = Engine(cfg, params if recipe is None else shards, scfg, recipe=recipe)
        for rid, prompt in enumerate(requests):
            engine.submit(rid, prompt, new_tokens + extra)
        return engine

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ep fallback of every decode step
        engine = engine_for()
        stats = _instrument(engine, record_gaps=False, fd=fd)
        fd.flash_decode_cuda.launches = 0
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fd.flash_decode_cuda.launches
        steps = dict(engine.steps)
        by_kind = {kind: decode_launches * steps[kind] for kind in ("prefill", "decode")}
        if stats["launches"] != by_kind or launches != sum(by_kind.values()):
            raise AssertionError(f"{cfg.name} recipe serve: flash_decode launches "
                                 f"{stats['launches']} (total {launches}) != {by_kind}")
        if done != {rid: single_done[rid] for rid in range(len(requests))}:
            raise AssertionError(f"{cfg.name} recipe serve: greedy tokens differ from the "
                                 "single-host run's")
        del engine
        torch.cuda.empty_cache()
        engines = {"single_host": engine_for(None, 64), "recipe": engine_for(extra=64)}
        for engine in engines.values():
            engine._fill_slots()
            engine._decode_once()
        wins = {name: [] for name in engines}
        for name in ("single_host", "recipe", "recipe", "single_host"):
            wins[name].append(window(engines[name]._decode_once, RECIPE_DECODE_STEPS,
                                     classify=classify))
    del engines
    torch.cuda.empty_cache()
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched", "device_ms_by_kind")
    out = dict(mesh=dict(mesh.shape), attn_mode=recipe.attn_mode, requests=len(requests),
               slots=SLOTS, max_len=MAX_LEN, new_tokens=new_tokens, steps=steps,
               flash_decode_launches=launches, flash_decode_launches_by_kind=stats["launches"],
               prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], wall_s=wall,
               greedy_tokens_equal_single_host=True,
               decode_step=[{k: w[k] for k in keys} for w in wins["recipe"]],
               single_host_decode_step=[{k: w[k] for k in keys} for w in wins["single_host"]])
    phase(f"{cfg.family}_recipe_serve", arch=cfg.name, layers=cfg.n_layers, backend="nccl",
          **out)
    return out


def latent_recipe_train(cfg, lm, fa, trainer, optimizer, sharding, shard_params_by_recipe,
                        mesh, seed: int) -> dict:
    """``recipe_train_mla`` / ``recipe_train_moe``: ``cfg`` (full width, its
    depth cut) with seeded float32 masters, one ``make_train_step`` step of
    1 x SEQ tokens without a recipe and under the ``tp`` recipe on the
    one-rank NCCL ``mesh`` (the rank's shards: views), each after a warm-up
    step: ``flash_attention`` launched once a layer in the forward and once
    more in remat's recompute, the recipe step's loss and gradient norm
    bitwise the no-recipe step's (every axis one rank: the same program,
    the MoE's aux loss included), each step's seconds and peak memory."""
    import warnings

    params = lm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(seed), device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (1, SEQ + 1), device=DEVICE, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    opt = optimizer.init_opt_state(params, ocfg)
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    expected = 2 * cfg.n_layers
    rows = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the MoE's ep fallback on one rank
        for name, rec, p in (("no_recipe", None, params), ("tp", recipe, shards)):
            step = trainer.make_train_step(cfg, rec, ocfg)
            b = batch if rec is None else sharding.local_batch(rec, batch)
            torch.cuda.reset_peak_memory_stats()
            step(p, opt, b)  # warm-up
            torch.cuda.synchronize()
            fa.flash_attention_cuda.launches = 0
            t0 = time.perf_counter()
            m = step(p, opt, b)[2]
            torch.cuda.synchronize()
            rows[name] = dict(step_s=time.perf_counter() - t0,
                              flash_attention_launches=fa.flash_attention_cuda.launches,
                              loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                              aux=m["aux"].item() if "aux" in m else None,
                              peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            del m
            torch.cuda.empty_cache()
    for name, row in rows.items():
        if row["flash_attention_launches"] != expected:
            raise AssertionError(f"{cfg.name} {name} step: flash_attention launches "
                                 f"{row['flash_attention_launches']} != {expected}")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise AssertionError(f"{cfg.name} {name} step metrics not finite: {row}")
    a, b = rows["tp"], rows["no_recipe"]
    if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
        raise AssertionError(f"{cfg.name} tp recipe step vs no recipe on one rank: loss "
                             f"{a['loss']} vs {b['loss']}, grad norm {a['grad_norm']} vs "
                             f"{b['grad_norm']} (must be bitwise)")
    out = dict(layers=cfg.n_layers, params=lm.count_params(cfg), tokens=SEQ,
               expected_launches=expected, bitwise_equal_no_recipe=True, tp=a, no_recipe=b)
    phase(f"recipe_train_{cfg.family}", arch=cfg.name, mesh=dict(mesh.shape), backend="nccl",
          **out)
    del params, shards, opt
    torch.cuda.empty_cache()
    return out


class attention_calls:
    """Inside the block, the forward kernel's launches counted by its causal
    flag: ``ops``' call of the card wrapper is wrapped, and the wrapper's own
    ``launches`` counter still counts each launch once."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = {"causal": 0, "non_causal": 0}

    def __enter__(self):
        self.kernel = self.ops.flash_attention_cuda

        def counted(q, k, v, *, causal=True, **kw):
            out = self.kernel(q, k, v, causal=causal, **kw)
            self.counts["causal" if causal else "non_causal"] += 1
            return out

        self.ops.flash_attention_cuda = counted
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention_cuda = self.kernel


def check_family_kernels(ops, card: str, pieces: int) -> dict:
    """``vlm_kernels`` and the audio family's instances: the forward
    kernel's (128, 128) instance non-causal at the VLM's cross attention
    (q 1 x 32 x SEQ over the image's k/v 1 x 8 x 1024, and a decode step's
    VLM_ROWS x 32 x 1 over VLM_ROWS x 8 x 1024: a query tile of one row),
    its (64, 64) instance at musicgen's causal MHA (1 x 32 x SEQ x 64), and
    the decode kernel's D = 64 instance at musicgen's decode step (SLOTS
    slots, 32 heads over 32 groups: one row a group; lengths DECODE_LENS of
    MAX_LEN).  Each :func:`check_forward_instance` /
    :func:`check_decode_instance`."""
    enc = VLM_ENC_LEN
    return {
        "cross_forward": check_forward_instance(ops, card, "vlm_cross_forward",
                                                (1, 32, 8, SEQ, enc, 128), False, pieces, 230),
        "cross_step": check_forward_instance(ops, card, "vlm_cross_decode_step",
                                             (VLM_ROWS, 32, 8, 1, enc, 128), False, pieces, 233),
        "audio_forward": check_forward_instance(ops, card, "audio_forward",
                                                (1, 32, 32, SEQ, SEQ, 64), True, pieces, 236),
        "audio_decode": check_decode_instance(ops, card, "audio_decode_step",
                                              (SLOTS, 32, 32, 1, MAX_LEN, 64), DECODE_LENS, 239),
    }


def open_gates(params, seed: int) -> None:
    """The VLM's cross blocks' gates drawn from U(GATE_RANGE), seeded, in
    place of their zero initialisation: at ``tanh(0) = 0`` every cross block
    passes its input through and the image would not reach the logits."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    lo, hi = GATE_RANGE
    for name in ("gate_attn", "gate_ffn"):
        t = params["cross_blocks"][name]
        params["cross_blocks"][name] = (lo + (hi - lo) * torch.rand(
            t.shape, device=DEVICE, generator=g)).to(t.dtype)


def family_model(configs, lm, name: str):
    """``family_model``: ``name`` at full width, FAMILY_DEPTH layers, with
    :func:`seeded_params` (bf16), a VLM's gates opened (:func:`open_gates`)."""
    cfg = dataclasses.replace(configs.get(name), n_layers=FAMILY_DEPTH[name])
    t0 = time.perf_counter()
    params = seeded_params(cfg, lm)
    if cfg.family == "vlm":
        open_gates(params, 24)
    torch.cuda.synchronize()
    phase("family_model", arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
          d_model=cfg.d_model, heads=(cfg.n_heads, cfg.n_kv, cfg.head_dim), d_ff=cfg.d_ff,
          vocab=cfg.vocab, input_kind=cfg.input_kind, params=lm.count_params(cfg),
          gates=GATE_RANGE if cfg.family == "vlm" else None, init_s=time.perf_counter() - t0,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    return cfg, params


def family_batch(cfg, B: int, S: int, seed: int, *, scale: float = 1.0) -> dict:
    """Seeded inputs of ``cfg``'s kind on the card: token ids, or frames
    (``embeds``, float32, times ``scale``); a VLM's float32 image."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if cfg.input_kind == "embeds":
        return {"embeds": scale * torch.randn((B, S, cfg.d_model), device=DEVICE, generator=g)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), device=DEVICE, generator=g)}
    if cfg.input_kind == "tokens+image":
        batch["image_embeds"] = scale * torch.randn((B, cfg.enc_len, cfg.enc_dim),
                                                    device=DEVICE, generator=g)
    return batch


def family_forward(cfg, params, lm, ops, fa) -> dict:
    """``vlm_forward`` / ``audio_forward``: the forward of 1 x SEQ seeded
    inputs (the VLM's with a seeded 1 x 1024 x 4096 image) through the
    kernels (``flash_attention`` once a layer: the VLM's self blocks causal,
    its cross blocks non-causal) and through their plain versions, logits at
    every token within LOGIT_TOL; for the VLM, a second image must move the
    logits by more than LOGIT_TOL (the cross path is live).  Forward ms and
    where the device time goes (:func:`window`)."""
    vlm = cfg.family == "vlm"
    batch = family_batch(cfg, 1, SEQ, 25)
    fa.flash_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with attention_calls(ops) as calls:
        logits = lm.forward(params, batch, cfg)[0][..., :cfg.vocab].float()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = fa.flash_attention_cuda.launches
    n_cross = lm.vlm_dims(cfg)[0] if vlm else 0
    want_calls = {"causal": cfg.n_layers - n_cross, "non_causal": n_cross}
    if launches != cfg.n_layers or calls.counts != want_calls:
        raise AssertionError(f"{cfg.name} forward: flash_attention launches {launches} "
                             f"{calls.counts} != {cfg.n_layers} {want_calls}")
    if logits.shape != (1, SEQ, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} forward logits {tuple(logits.shape)} not finite")
    fa.flash_attention_cuda.launches = 0
    plain = lm.forward(params, batch, dataclasses.replace(cfg, attn_impl="ref"))[0]
    torch.cuda.synchronize()
    if fa.flash_attention_cuda.launches:
        raise AssertionError(f"{cfg.name}: the plain forward launched the kernel")
    diff = (logits - plain[..., :cfg.vocab].float()).abs()
    err = diff.max().item()
    del plain
    if err > LOGIT_TOL:
        raise AssertionError(f"{cfg.name} forward logits kernel vs plain: {err} > {LOGIT_TOL}")
    out = dict(tokens=SEQ, flash_attention_launches=launches, by_causal_flag=calls.counts,
               logits_max_abs_err=err, logits_abs_err_p999=diff.flatten()[::97].quantile(
                   0.999).item(), tol=LOGIT_TOL, logit_scale=logits.abs().max().item(),
               peak_memory_gb=peak)
    del diff
    if vlm:
        other = dict(batch, image_embeds=family_batch(cfg, 1, 1, 26)["image_embeds"])
        moved = (lm.forward(params, other, cfg)[0][..., :cfg.vocab].float() - logits).abs()
        moved = moved.max().item()
        if not moved > LOGIT_TOL:
            raise AssertionError(f"{cfg.name}: a second image moved the logits by {moved} <= "
                                 f"{LOGIT_TOL}; the cross path is not live")
        out["second_image_moves_logits_by"] = moved
    del logits
    torch.cuda.empty_cache()
    forward_ms = median_ms(lambda: lm.forward(params, batch, cfg), iters=3, warmup=1)
    brk = window(lambda: lm.forward(params, batch, cfg), 2)
    if not any("flash_attention_kernel_wgmma" in n for n in brk["port_kernels"]) or \
            brk["library_attention"]:
        raise AssertionError(f"{cfg.name} profiled forward: {brk['port_kernels']} "
                             f"{brk['library_attention']}")
    out.update(forward_ms=forward_ms, tokens_per_s=SEQ / forward_ms * 1e3, breakdown=brk)
    phase("vlm_forward" if vlm else "audio_forward", arch=cfg.name, **out)
    torch.cuda.empty_cache()
    return out


def vlm_prompts(cfg) -> list[list[int]]:
    rng = np.random.default_rng(2)
    return [rng.integers(2, cfg.vocab, size=int(rng.integers(*PROMPT_LENS))).tolist()
            for _ in range(VLM_ROWS)]


def vlm_generate(cfg, params, lm, fd, fa, prompts, image, impl, recipe=None) -> dict:
    """The VLM served through ``lm.init_cache`` and ``lm.decode_step``, the
    way the reference's own test drives it: every row's prompt but its last
    token as one whole-prompt chunk (``prefill=True``, padded to a power of
    two, ``new_counts`` the rows' lengths), then VLM_NEW_TOKENS greedy steps
    of one token a row, each row with its own image every step.  Returns the
    tokens, each step's top-2 logit gaps, the launches of both kernels per
    step kind, seconds, and a function that runs one more decode step.
    Under ``recipe`` (active around the call) each step's sampled position
    is gathered from the rank's block (``lm.last_logits``)."""
    from repro_torch.models.sharding import local_batch

    def rows(batch):  # a step's inputs: this rank's rows under the recipe
        return batch if recipe is None else local_batch(recipe, batch, decode=True)

    c = dataclasses.replace(cfg, attn_impl=impl)
    B = len(prompts)
    state = lm.DecodeState(lm.init_cache(c, B, MAX_LEN, device=DEVICE),
                           torch.zeros((B,), dtype=torch.int32, device=DEVICE))
    feeds = [p[:-1] for p in prompts]
    S = 1 << (max(len(f) for f in feeds) - 1).bit_length()
    chunk = torch.zeros((B, S), dtype=torch.long)
    for r, f in enumerate(feeds):
        chunk[r, :len(f)] = torch.tensor(f)
    counts = torch.tensor([len(f) for f in feeds], dtype=torch.int32, device=DEVICE)
    launches = {}

    def counted(kind, fn):
        torch.cuda.synchronize()
        before = (fd.flash_decode_cuda.launches, fa.flash_attention_cuda.launches)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = (fd.flash_decode_cuda.launches - before[0],
               fa.flash_attention_cuda.launches - before[1])
        launches.setdefault(kind, set()).add(now)
        return out, dt

    (_, state), prefill_s = counted("prefill", lambda: lm.decode_step(
        params, state, rows({"tokens": chunk.to(DEVICE), "image_embeds": image}), c,
        new_counts=counts, prefill=True))
    out = [list(p) for p in prompts]
    gaps, decode_s = {}, 0.0
    ones = torch.ones((B,), dtype=torch.int32, device=DEVICE)
    last = [p[-1] for p in prompts]
    for j in range(VLM_NEW_TOKENS):
        tok = torch.tensor(last, device=DEVICE)[:, None]
        (logits, state), dt = counted("decode", lambda: lm.decode_step(
            params, state, rows({"tokens": tok, "image_embeds": image}), c, new_counts=ones))
        decode_s += dt
        top2 = lm.last_logits(logits, ones, recipe)[:, :cfg.vocab].float().topk(2, dim=-1)
        last = top2.indices[:, 0].tolist()
        for r, gap in enumerate((top2.values[:, 0] - top2.values[:, 1]).tolist()):
            gaps[(r, len(prompts[r]) + j)] = gap
            out[r].append(last[r])
    holder = {"state": state, "last": last}

    def step():
        tok = torch.tensor(holder["last"], device=DEVICE)[:, None]
        logits, holder["state"] = lm.decode_step(params, holder["state"],
                                                 rows({"tokens": tok, "image_embeds": image}), c,
                                                 new_counts=ones)
        holder["last"] = lm.last_logits(logits, ones, recipe)[:, :cfg.vocab].argmax(-1).tolist()

    return dict(done=out, gaps=gaps, launches={k: sorted(v) for k, v in launches.items()},
                prefill_s=prefill_s, decode_s=decode_s, chunk=S, step=step)


def vlm_decode(cfg, params, lm, fd, fa) -> dict:
    """``vlm_decode``: VLM_ROWS rows (seeded prompts of 128-2048 tokens, a
    seeded image each) served by :func:`vlm_generate` through the kernels
    (a step launches ``flash_decode`` once a self block and
    ``flash_attention`` once a cross block, non-causal with Sq = the step's
    length over the image's 1024 positions) and through their plain
    versions: greedy tokens equal except at the plain run's near ties.
    Then a steady decode step's host and device ms, idle share and kernels
    (:func:`window`)."""
    prompts = vlm_prompts(cfg)
    image = family_batch(cfg, VLM_ROWS, 1, 27)["image_embeds"]
    n_cross, group_self = lm.vlm_dims(cfg)
    runs = {impl: vlm_generate(cfg, params, lm, fd, fa, prompts, image, impl)
            for impl in (None, "ref")}
    k, p = runs[None], runs["ref"]
    want = {"prefill": [(n_cross * group_self, n_cross)], "decode": [(n_cross * group_self,
                                                                     n_cross)]}
    if k["launches"] != want or p["launches"] != {"prefill": [(0, 0)], "decode": [(0, 0)]}:
        raise AssertionError(f"vlm decode launches (flash_decode, flash_attention) a step: "
                             f"{k['launches']} (plain {p['launches']}) != {want}")
    agree, near_ties = greedy_agreement(prompts, k["done"], p["done"], p["gaps"], "kernel",
                                        "plain", new_tokens=VLM_NEW_TOKENS)
    fd.flash_decode_cuda.launches = fa.flash_attention_cuda.launches = 0
    dec = window(k["step"], VLM_WINDOW_STEPS)
    per_step = (fd.flash_decode_cuda.launches / (2 * VLM_WINDOW_STEPS),
                fa.flash_attention_cuda.launches / (2 * VLM_WINDOW_STEPS))
    if per_step != (n_cross * group_self, n_cross):
        raise AssertionError(f"vlm steady decode step launches {per_step}")
    out = dict(rows=VLM_ROWS, max_len=MAX_LEN, new_tokens=VLM_NEW_TOKENS,
               prompt_lens=[len(r) for r in prompts], chunk=k["chunk"],
               launches_per_step=dict(flash_decode=n_cross * group_self,
                                      flash_attention_non_causal=n_cross),
               prefill_s=k["prefill_s"], decode_s=k["decode_s"],
               decode_tok_s=VLM_ROWS * VLM_NEW_TOKENS / k["decode_s"],
               plain_decode_s=p["decode_s"], greedy_agreement=agree,
               divergences_at_near_ties=near_ties, tol=LOGIT_TOL, decode_step=dec)
    phase("vlm_decode", arch=cfg.name, **out)
    out["done"] = k["done"]  # what the recipe's decode is held against
    del runs, k, p
    torch.cuda.empty_cache()
    return out


def family_decode_vs_forward(configs, lm, name: str, depth: int) -> dict:
    """``family_check``: ``name`` at full width, float32 activations, the
    depth cut to ``depth`` layers, seeded float32 weights (a VLM's gates
    opened): FAMILY_CHECK_TOKENS one-token (or one-frame) decode steps
    against the forward over the same inputs, to FAMILY_DECODE_TOL, the
    reference's own tolerance for these families (``tests/test_decode.py``).
    The float32 kernels (FFMA bodies) run on both sides."""
    cfg = dataclasses.replace(configs.get(name), n_layers=depth, act_dtype=torch.float32)
    params = lm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(28), device=DEVICE)
    if cfg.family == "vlm":
        open_gates(params, 29)
    B, S = 2, FAMILY_CHECK_TOKENS
    batch = family_batch(cfg, B, S, 30, scale=0.3)  # the reference test's input scale
    full = lm.forward(params, batch, cfg)[0]
    state = lm.DecodeState(lm.init_cache(cfg, B, S, device=DEVICE),
                           torch.zeros((B,), dtype=torch.int32, device=DEVICE))
    key = "embeds" if cfg.input_kind == "embeds" else "tokens"
    steps = []
    for t in range(S):
        logits, state = lm.decode_step(params, state, {**batch, key: batch[key][:, t:t + 1]},
                                       cfg)
        steps.append(logits)
    err = (torch.cat(steps, dim=1) - full).abs().max().item()
    if not err <= FAMILY_DECODE_TOL:
        raise AssertionError(f"{name} float32 decode vs forward: {err} > {FAMILY_DECODE_TOL}")
    out = dict(layers=depth, tokens=S, batch=B, max_abs_err=err, tol=FAMILY_DECODE_TOL,
               logit_scale=full.abs().max().item())
    phase("family_check", arch=name, dtype="float32", **out)
    del params, full, state, steps
    torch.cuda.empty_cache()
    return out


def family_train(configs, lm, fa, ops, trainer, optimizer, tree_leaves, name: str, depth: int,
                 seq: int, mesh, sharding, shard_params_by_recipe) -> dict:
    """``vlm_train`` / ``audio_train``: ``name`` at full width, ``depth``
    layers (float32 masters, bf16 activations, remat by group and block), a
    pipeline-shaped batch of 1 x ``seq`` (tokens and a seeded image, or
    frames; labels): one step's gradients through the kernels (every
    launch counted; the backward recomputes through the plain version),
    every leaf finite and nonzero, held against the same gradients through
    the plain attention (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL); then one
    ``make_train_step`` step after a warm-up step, its seconds and peak
    memory; then ``recipe_train_vlm`` / ``recipe_train_audio``: the same
    step under ``make_recipe(cfg, mesh, attn_mode="tp")`` on the one-rank
    NCCL ``mesh`` and the rank's shards of the same parameters (views),
    after a warm-up step, its loss and gradient norm bitwise the no-recipe
    step's (every axis one rank: the same program), its seconds and peak
    memory."""
    cfg = dataclasses.replace(configs.get(name), n_layers=depth)
    params = lm.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(31), device=DEVICE)
    if cfg.family == "vlm":
        open_gates(params, 32)
    batch = family_batch(cfg, 1, seq, 33)
    g = torch.Generator(device=DEVICE).manual_seed(34)
    batch["labels"] = torch.randint(0, cfg.vocab, (1, seq), device=DEVICE, generator=g)
    fa.flash_attention_cuda.launches = 0
    with attention_calls(ops) as calls:
        loss, _, grads = trainer._accum_loss_grads(params, batch, cfg, 1)
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    if cfg.family == "vlm":  # self blocks run 3 times under nested remat, cross blocks twice
        n_cross, group_self = lm.vlm_dims(cfg)
        want = {"causal": 3 * n_cross * group_self, "non_causal": 2 * n_cross}
    else:
        want = {"causal": 2 * cfg.n_layers, "non_causal": 0}
    if calls.counts != want or launches != sum(want.values()):
        raise AssertionError(f"{name} training step: flash_attention launches {launches} "
                             f"{calls.counts} != {want}")
    leaves = tree_leaves(grads)
    for i, leaf in enumerate(leaves):
        if leaf.dtype != torch.float32 or not torch.isfinite(leaf).all() or \
                not leaf.abs().sum() > 0:
            raise AssertionError(f"{name} gradient leaf {i} {tuple(leaf.shape)} is not a finite, "
                                 f"nonzero float32 tensor")
    plain_loss, _, plain = trainer._accum_loss_grads(
        params, batch, dataclasses.replace(cfg, attn_impl="ref"), 1)
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    errs = [rel_err(a, b) for a, b in zip(leaves, tree_leaves(plain))]
    del grads, plain, leaves
    torch.cuda.empty_cache()
    if loss_err > TRAIN_LOSS_RTOL or max(errs) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"{name} kernel vs plain training step: loss {loss_err}, "
                             f"gradients {max(errs)}")
    ocfg = optimizer.OptConfig(lr=TRAIN_LR)
    step = trainer.make_train_step(cfg, None, ocfg)
    opt = optimizer.init_opt_state(params, ocfg)
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_params, new_opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    if not np.isfinite(metrics["loss"].item()) or not np.isfinite(metrics["grad_norm"].item()):
        raise AssertionError(f"{name} training step metrics not finite: {metrics}")
    out = dict(layers=depth, params=lm.count_params(cfg), tokens=seq,
               flash_attention_launches=launches, by_causal_flag=calls.counts,
               loss=loss.item(), plain_loss=plain_loss.item(), loss_rel_err=loss_err,
               grad_rel_err_max=max(errs), grad_rel_err_median=float(np.median(errs)),
               tol=dict(loss=TRAIN_LOSS_RTOL, grads=TRAIN_GRAD_RTOL), step_s=step_s,
               tokens_per_s=seq / step_s, grad_norm=metrics["grad_norm"].item(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    phase("vlm_train" if cfg.family == "vlm" else "audio_train", arch=cfg.name, **out)
    del new_params, new_opt
    torch.cuda.empty_cache()
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    step = trainer.make_train_step(cfg, recipe, ocfg)
    mine = sharding.local_batch(recipe, batch)
    torch.cuda.reset_peak_memory_stats()
    step(shards, opt, mine)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    rec = step(shards, opt, mine)[2]
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    got = (rec["loss"].item(), rec["grad_norm"].item())
    want = (metrics["loss"].item(), metrics["grad_norm"].item())
    if got != want:
        raise AssertionError(f"{name} tp recipe step vs no recipe on one rank: (loss, grad "
                             f"norm) {got} vs {want} (must be bitwise)")
    rec_launches = fa.flash_attention_cuda.launches
    if rec_launches != launches:
        raise AssertionError(f"{name} tp recipe step: flash_attention launches {rec_launches} "
                             f"!= the no-recipe step's {launches}")
    out["recipe"] = dict(mesh=dict(mesh.shape), attn_mode="tp", step_s=rec_s,
                         no_recipe_step_s=step_s, loss=got[0], no_recipe_loss=want[0],
                         grad_norm=got[1],
                         bitwise_equal_no_recipe=True, flash_attention_launches=rec_launches,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    phase(f"recipe_train_{cfg.family}", arch=cfg.name, layers=depth, tokens=seq,
          backend="nccl", **out["recipe"])
    del params, opt, shards, rec, metrics
    torch.cuda.empty_cache()
    return out


def family_recipe_forward(cfg, params, lm, ops, fa, mesh, sharding, shard_params_by_recipe,
                          no_recipe_window: dict) -> dict:
    """``vlm_recipe_forward`` / ``audio_recipe_forward``: the family forward
    phase's 1 x SEQ seeded inputs (the VLM's with its image) under
    ``make_recipe(cfg, mesh, attn_mode=...)`` for ``tp``, ``sp`` and
    ``sp_ring`` on a one-rank NCCL ``(data, model)`` mesh and the rank's
    shards (views: one rank cuts nothing).  Every axis has one rank, so the
    logits equal the no-recipe forward's bitwise.  Launches by kernel,
    instance and causal flag: ``tp`` and ``sp`` launch the forward
    kernel's (D, D) instance once a self block (causal) and once a cross
    block (non-causal); ``sp_ring`` launches the carry instance's one ring
    step in place of every self block's causal launch, while the cross
    blocks stay on the forward kernel.  Times: host ms of a forward
    (:func:`host_ms`, 2 calls) in turns with the no-recipe forward (no
    recipe, each mode, no recipe), and each mode's profiled window
    (:func:`window`) beside the family's no-recipe window
    (``no_recipe_window``)."""
    batch = family_batch(cfg, 1, SEQ, 25)  # the family forward phase's inputs
    want = lm.forward(params, batch, cfg)[0]
    specs = lm.build_specs(cfg)
    n_cross = lm.vlm_dims(cfg)[0] if cfg.family == "vlm" else 0
    n_self = cfg.n_layers - n_cross
    fns = {"no_recipe": lambda: lm.forward(params, batch, cfg)}
    out = {}
    for mode in ("tp", "sp", "sp_ring"):
        recipe = sharding.make_recipe(cfg, mesh, attn_mode=mode)
        shards = shard_params_by_recipe(params, specs, recipe)
        fa.flash_attention_cuda.launches = fa.flash_attention_carry_cuda.launches = 0
        with sharding.use_recipe(recipe), attention_calls(ops) as calls:
            mine = sharding.local_batch(recipe, batch)
            got = lm.gather_logits(lm.forward(shards, mine, cfg)[0], recipe, 1)
        torch.cuda.synchronize()
        ring = mode == "sp_ring"
        launches = dict(flash_attention=dict(calls.counts),
                        flash_attention_carry=fa.flash_attention_carry_cuda.launches)
        expected = dict(flash_attention={"causal": 0 if ring else n_self, "non_causal": n_cross},
                        flash_attention_carry=n_self if ring else 0)
        if launches != expected or \
                fa.flash_attention_cuda.launches != sum(expected["flash_attention"].values()):
            raise AssertionError(f"{cfg.name} recipe forward {mode}: launches {launches} != "
                                 f"{expected}")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name} recipe forward {mode}: logits {tuple(got.shape)} "
                                 "not finite or not the expected shape")
        if not torch.equal(got, want):
            raise AssertionError(f"{cfg.name} recipe forward {mode} vs no recipe on one rank: "
                                 f"max |diff| {(got.float() - want.float()).abs().max().item()} "
                                 "(must be bitwise)")
        del got

        def fwd(shards=shards, recipe=recipe):
            with sharding.use_recipe(recipe):
                lm.forward(shards, sharding.local_batch(recipe, batch), cfg)

        fns[mode] = fwd
        out[mode] = dict(instance=(cfg.head_dim, cfg.head_dim), launches=launches,
                         bitwise_equal_no_recipe=True)
    host = {name: [] for name in fns}
    for name in ("no_recipe", *out, "no_recipe"):
        host[name].append(host_ms(fns[name], 2))
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched", "device_ms_by_kind")
    for mode, row in out.items():
        win = window(fns[mode], 1)
        kernel = "flash_attention_kernel_wgmma"
        if not any(kernel in n for n in win["port_kernels"]) or win["library_attention"]:
            raise AssertionError(f"{cfg.name} profiled {mode} forward: {win['port_kernels']} "
                                 f"{win['library_attention']}")
        row.update(host_ms=host[mode], no_recipe_host_ms=host["no_recipe"],
                   forward={k: win[k] for k in keys},
                   no_recipe_forward={k: no_recipe_window[k] for k in keys},
                   kernels_launched_vs_no_recipe=win["kernels_launched"] -
                   no_recipe_window["kernels_launched"])
        phase(f"{cfg.family}_recipe_forward", arch=cfg.name, layers=cfg.n_layers,
              mesh=dict(mesh.shape), backend="nccl", attn_mode=mode, tokens=SEQ, **row)
    del want, fns
    torch.cuda.empty_cache()
    return out


def vlm_recipe_decode(cfg, params, lm, fd, fa, mesh, sharding, shard_params_by_recipe,
                      single: dict) -> dict:
    """``vlm_recipe_decode``: the ``vlm_decode`` phase's VLM_ROWS rows (its
    prompts and images) through :func:`vlm_generate` with
    ``make_recipe(cfg, mesh, attn_mode="tp")`` active on a one-rank NCCL
    mesh, on the rank's shards and its blocks of the cache
    (``lm.init_cache`` under the recipe): a step launches ``flash_decode``
    once a self block and ``flash_attention`` once a cross block, and the
    greedy tokens equal the no-recipe run's (``single``) exactly (the same
    program on one rank).  Then a steady decode step's window under the
    recipe beside the phase's no-recipe window."""
    prompts = vlm_prompts(cfg)
    image = family_batch(cfg, VLM_ROWS, 1, 27)["image_embeds"]
    n_cross, group_self = lm.vlm_dims(cfg)
    recipe = sharding.make_recipe(cfg, mesh, attn_mode="tp")
    shards = shard_params_by_recipe(params, lm.build_specs(cfg), recipe)
    with sharding.use_recipe(recipe):
        run = vlm_generate(cfg, shards, lm, fd, fa, prompts, image, None, recipe)
    want = {kind: [(n_cross * group_self, n_cross)] for kind in ("prefill", "decode")}
    if run["launches"] != want:
        raise AssertionError(f"vlm recipe decode launches (flash_decode, flash_attention) a "
                             f"step: {run['launches']} != {want}")
    if run["done"] != single["done"]:
        raise AssertionError("vlm recipe decode: greedy tokens differ from the no-recipe run's")

    def step():
        with sharding.use_recipe(recipe):
            run["step"]()

    dec = window(step, VLM_WINDOW_STEPS)
    keys = ("wall_ms", "device_ms", "idle_share", "kernels_launched", "device_ms_by_kind")
    out = dict(mesh=dict(mesh.shape), attn_mode=recipe.attn_mode, rows=VLM_ROWS,
               new_tokens=VLM_NEW_TOKENS, chunk=run["chunk"],
               launches_per_step=dict(flash_decode=n_cross * group_self,
                                      flash_attention_non_causal=n_cross),
               prefill_s=run["prefill_s"], decode_s=run["decode_s"],
               decode_tok_s=VLM_ROWS * VLM_NEW_TOKENS / run["decode_s"],
               greedy_tokens_equal_no_recipe=True, decode_step={k: dec[k] for k in keys},
               no_recipe_decode_step={k: single["decode_step"][k] for k in keys})
    phase("vlm_recipe_decode", arch=cfg.name, backend="nccl", **out)
    del run, shards
    torch.cuda.empty_cache()
    return out


def check_family_carry(ops, card: str, pieces: int, ptxas: dict) -> dict:
    """``family_carry``: the carry form's (64, 64) and (128, 128) instances
    at the one-card ring step of musicgen's and the VLM's self attention
    (the ``sp_ring`` forward on one rank: q/k/v 1 x 32 x SEQ x 64, causal
    MHA; q 1 x 32 x SEQ x 128 over k/v of 8 KV groups), from the ring's
    explicit empty state, bf16 and float32, against their plain versions
    (acc, m and l within ATTN_TOL; two launches bitwise).  The bf16 step's
    time (``queued_ms``) beside its bound (``attn_bound``: the bf16
    products, p @ v in ``pieces`` pieces, and the state read and written
    once), the plain version's time, and the instance's registers and spill
    stores (``ptxas``); no PyTorch call returns the unnormalized state."""
    from repro_torch.kernels.timing import queued_ms

    out = {}
    for label, arch, (G, D) in (("musicgen_64_64", AUDIO_ARCH, (32, 64)),
                                ("vlm_128_128", VLM_ARCH, (8, 128))):
        row = dict(ptxas=ptxas[f"flash_attention_kernel_wgmma<{D},{D},1,1>"])
        for dt in (torch.bfloat16, torch.float32):
            q = randn((1, 32, SEQ, D), dt, 250)
            k, v = (randn((1, G, SEQ, D), dt, 251 + i) for i in range(2))
            carry = plain_carry(q)
            want = ops.flash_attention_carry(q, k, v, carry, impl="ref")
            got = ops.flash_attention_carry(q, k, v, tuple(t.clone() for t in carry))
            torch.cuda.synchronize()
            errs = {}
            for name, g, w in zip(("acc", "m", "l"), got, want):
                torch.testing.assert_close(g, w, rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt])
                errs[name] = (g - w).abs().max().item()
            if not torch.equal(got[0], ops.flash_attention_carry(
                    q, k, v, tuple(t.clone() for t in carry))[0]):
                raise AssertionError(f"carry ({D}, {D}) {dt}: two launches differ")
            row[str(dt)] = dict(max_abs_err=errs, tol=ATTN_TOL[dt], two_launches="bitwise")
            del got, want
            if dt == torch.bfloat16:
                t = dict(ms=queued_ms(lambda: ops.flash_attention_carry(q, k, v, carry)),
                         plain_ms=queued_ms(lambda: ops.flash_attention_carry(
                             q, k, v, carry, impl="ref"), iters=5),
                         library_ms=None,
                         call_ms=median_ms(lambda: ops.flash_attention_carry(q, k, v, carry)))
                flops = 4 * 32 * (SEQ * (SEQ + 1) // 2) * D
                nbytes = 2 * (q.numel() + k.numel() + v.numel()) + \
                    2 * 4 * sum(c.numel() for c in carry)
                b_ms, b_by, fp32_ms = attn_bound(flops, nbytes, products=1 + pieces)
                row.update(bound_ms=b_ms, bound_by=b_by, fp32_bound_ms=fp32_ms,
                           tflops=flops / t["ms"] / 1e9, max_abs_err=max(errs.values()), **t)
                check_bound(f"flash_attention_carry ({D}, {D}) one_card_step", row)
            del q, k, v, carry
        out[label] = row
        phase("time", kernel="flash_attention_carry", arch=arch, case="one_card_step",
              instance=(D, D), q=(1, 32, SEQ, D), kv=(1, G, SEQ, D), dtype="bfloat16", card=card,
              library="none: no PyTorch call returns the unnormalized (acc, m, l)", **row)
    torch.cuda.empty_cache()
    return out


def kernel_instances(log: str, kernel: str = r"layout_gemm\w*?kernel") -> dict:
    """ptxas's registers and spill per instance of the kernels whose names
    match ``kernel``, by name and integer template arguments (the GEMM
    kernels': A_T, B_T, loader: 0 cp.async, 1 TMA, 2 strided TMA; the bf16
    attention kernels': D and HAS_CARRY, EMIT_STATE, or D and TR)."""
    out = {}
    for m in re.finditer(rf"Compiling entry function '\w*?({kernel})I(\w+?)EEv"
                         r"(.*?)(?=Compiling entry function|\Z)", log, re.S):
        args = ",".join(re.findall(r"L[bi](\d+)E", m.group(2) + "E"))
        body = m.group(3)
        regs = re.search(r"Used (\d+) registers", body)
        out[f"{m.group(1)}<{args}>"] = dict(
            registers=int(regs.group(1)) if regs else None,
            spill_store_bytes=sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", body)))
    return out


def main() -> int:
    run_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    # the training phases hold float32 masters, moments and gradients of 1.42 B
    # parameters beside a step's activations: segments that grow in place keep
    # freed blocks usable for the next, larger tensors (read at the first
    # allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import init_world, make_mesh
    from repro_torch.examples import distributed_gemm as g
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import gemm as kernels
    from repro_torch.kernels import ops, relayout
    from repro_torch.models import ffn, lm
    from repro_torch.models.attention import ring_attention_seq, ring_step_offsets
    from repro_torch.models.module import tree_leaves
    from repro_torch.models import sharding
    from repro_torch.models.sharding import make_recipe, ragged_seq_extents
    from repro_torch.models.weights import cast_params, shard_params_by_recipe
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.tp_decode import make_tp_decode_step
    from repro_torch.train import optimizer, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # phase 1: the card and the build (one nvcc per source, all at once)
    card = nvidia_smi()
    t0 = time.perf_counter()
    build.build_all()
    kernels.load_library()
    kernels.load_bf16_library()
    fa.load_library()
    fd.load_library()
    relayout.load_library()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in build.SOURCES:
        log = build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        ptxas[name] = dict(registers=[min(regs), max(regs)] if regs else None,
                           spill_store_bytes=sum(int(n) for n in
                                                 re.findall(r"(\d+) bytes spill stores", log)))
    phase("card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
          torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)
    phase("gemm_instances", dynamic_shared_bytes=kernels.load_library().layout_gemm_smem_bytes(),
          ptxas=kernel_instances(build.build_log("gemm")))
    bf16_lib = kernels.load_bf16_library()
    phase("gemm_bf16_instances",
          dynamic_shared_bytes={store: bf16_lib.layout_gemm_bf16_smem_bytes(code)
                                for store, code in kernels.BF16_STORES.items()},
          ptxas=kernel_instances(build.build_log("gemm_bf16")))
    attn_ptxas = {name: kernel_instances(build.build_log(name), rf"{name}_kernel_wgmma")
                  for name in ("flash_attention", "flash_decode")}
    attn_ptxas["flash_attention_float32"] = kernel_instances(build.build_log("flash_attention"),
                                                             "flash_attention_kernel")
    phase("attention_instances", ptxas=attn_ptxas)

    # phase 2: kernels against their plain versions
    worst = check_kernels(ops)
    phase("kernels_vs_plain", max_abs_err=worst, rtol=RTOL, atol=ATOL)

    # phase 3: the main path on a world of one rank (NCCL)
    device = init_world("cuda")
    try:
        mesh1 = make_mesh((1,), ("r",), device=device)
        mesh11 = make_mesh((1, 1), ("rows", "cols"), device=device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        calls = drive_main_path(g, mesh1, mesh11)
        main_s = time.perf_counter() - t0
        launches = {"gemm": kernels.gemm_cuda.launches,
                    "gemm_panel": kernels.gemm_panel_cuda.launches,
                    "gemm_bf16": kernels.gemm_bf16_cuda.launches,
                    "gemm_panel_bf16": kernels.gemm_panel_bf16_cuda.launches}
        # 1-D: one gemm per rank per call; SUMMA and ragged SUMMA: R = 1 panel step per call
        # (the case study runs in float32: no bf16 GEMM on this path)
        expected = {"gemm": calls["panel1d"], "gemm_panel": calls["summa"] + calls["ragged"],
                    "gemm_bf16": 0, "gemm_panel_bf16": 0}
        if launches != expected:
            raise AssertionError(f"main-path launches {launches} != expected {expected}")
        # EXTRALARGE loads through TMA, the ragged dims+1 through the strided TMA
        by_path = {"gemm": dict(kernels.gemm_cuda.launches_by_path),
                   "gemm_panel": dict(kernels.gemm_panel_cuda.launches_by_path)}
        paths = {p: sum(c[p] for c in by_path.values()) for p in ("tma", "tma_strided")}
        if not all(paths.values()):
            raise AssertionError(f"the main path did not run both TMA loaders: {by_path}")
        phase("main_path_launches", backend=str(dist.get_backend()), calls=calls,
              launches=launches, launches_by_path=by_path, seconds=main_s)

        # phase 4: kernel proof under the profiler
        profile_main_path(g, mesh1, mesh11)
    finally:
        dist.destroy_process_group()

    # phase 5: times
    rows = time_kernels(ops, card)
    torch.cuda.empty_cache()

    # phase 5b: the bf16 GEMM kernels (both loaders, all 8 majors) against
    # their plain versions, float64 and themselves, and their times
    t0 = time.perf_counter()
    worst.update(check_gemm_bf16(ops, kernels))
    rows.update(time_gemm_bf16(ops, kernels, card))
    phase("gemm_bf16", max_abs_err={k: worst[k] for k in ("gemm_bf16", "gemm_panel_bf16")},
          seconds=time.perf_counter() - t0)

    # phase 6: the attention kernels against their plain versions
    t0 = time.perf_counter()
    worst.update(check_attention_kernels(ops))
    phase("attention_kernels_vs_plain", max_abs_err=worst, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # phase 6b: the ring's kernel work and the transpose against their plain
    # versions, the carry chain against the single-shot kernel; the bf16
    # kernels against float64 and against themselves
    t0 = time.perf_counter()
    worst.update(check_carry_kernel(ops, ring_step_offsets, ragged_seq_extents))
    check_carry_chain(ops)
    accuracy = check_attention_accuracy(ops)
    check_attention_deterministic(ops, ring_step_offsets)
    transpose_launches = check_transpose(ops, relayout)
    phase("ring_kernels_vs_plain", max_abs_err=worst, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # phase 6c: the ring's entry point on a one-rank NCCL mesh, and the
    # profiler proof of the new kernels
    device = init_world("cuda")
    try:
        ring_mesh = make_mesh((1, 1), ("data", "model"), device=device)
        carry_launches = drive_ring_entry(ops, fa, ring_attention_seq, ring_mesh)
        profile_ring(ops, ring_attention_seq, ring_mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # phase 7: the dense LM at full width, seeded random weights; the
    # engine's activation-dtype copy of the weights is made here once
    cfg = configs.get(ARCH)
    t0 = time.perf_counter()
    params = cast_params(lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       device="cuda"), cfg.act_dtype)
    torch.cuda.synchronize()
    phase("model", arch=cfg.name, params=lm.count_params(cfg), init_s=time.perf_counter() - t0,
          memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    fwd = forward_full_width(cfg, params, lm, fa)
    torch.cuda.empty_cache()
    # phase 7b: the dry run's trace of the forward against the card's run
    t0 = time.perf_counter()
    dryrun_formulas()
    dryrun_forward(cfg, params, lm, kernel_launches(fa, fd, kernels, relayout), cast_params)
    dryrun_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # phase 8: serving at full width
    srv, single = serve_full_width(cfg, params, Engine, ServeConfig, fd)
    torch.cuda.empty_cache()

    # phase 9: the LM path's kernels under the profiler
    profile_lm(cfg, params, lm, Engine, ServeConfig)
    single_dec = breakdown_lm(cfg, params, lm, Engine, ServeConfig)

    # phase 9b: tensor-parallel serving on a one-rank NCCL (data, model) mesh,
    # and the sharding recipe's program (forward under tp and sp, serving)
    device = init_world("cuda")
    try:
        tp_mesh = make_mesh((1, 1), ("data", "model"), device=device)
        tp, tp_done = serve_tp(cfg, params, Engine, ServeConfig, fd, tp_mesh, single,
                               single_dec)
        check_tp_blocking(cfg, params, Engine, ServeConfig, tp_mesh, make_tp_decode_step)
        t0 = time.perf_counter()
        rec_fwd = recipe_forward(cfg, params, lm, fa, tp_mesh, sharding, shard_params_by_recipe)
        rec_srv = recipe_serve(cfg, params, lm, Engine, ServeConfig, fd, tp_mesh, sharding,
                               shard_params_by_recipe, single)
        rec_tp_srv = recipe_tp_serve(cfg, params, lm, Engine, ServeConfig, fd, tp_mesh,
                                     sharding, shard_params_by_recipe, tree_leaves, tp, tp_done)
        recipe_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    del params, single, tp_done
    torch.cuda.empty_cache()

    # phase 10: attention, carry and transpose kernel times
    rows.update(time_attention_kernels(ops, card, fa.P_PIECES))
    torch.cuda.empty_cache()
    shards = tp_shard_decode(ops, card)
    rows.update(time_ring_kernels(ops, card, ring_step_offsets, fa.P_PIECES))
    torch.cuda.empty_cache()

    # phase 11: the MoE family, phi3.5-moe at full width (depth cut),
    # seeded random weights
    moe_cfg, moe_params = moe_model(configs, lm)
    moe_fwd = moe_forward(moe_cfg, moe_params, lm, fa, ffn)
    moe_srv = moe_serve(moe_cfg, moe_params, Engine, ServeConfig, fd, ffn)
    # phase 11b: the MoE family under a sharding recipe on a one-rank NCCL
    # (data, model) mesh, beside the phase's no-recipe runs
    device = init_world("cuda")
    try:
        lmesh = make_mesh((1, 1), ("data", "model"), device=device)
        t1 = time.perf_counter()
        moe_rec_fwd = latent_recipe_forward(moe_cfg, moe_params, lm, fa, lmesh, sharding,
                                            shard_params_by_recipe,
                                            moe_fwd[(1, SEQ)]["breakdown"], classify=moe_by_kind)
        moe_rec_srv = latent_recipe_serve(moe_cfg, moe_params, lm, Engine, ServeConfig, fd,
                                          lmesh, sharding, shard_params_by_recipe,
                                          moe_srv["prompts"], MOE_NEW_TOKENS, moe_srv["done"],
                                          moe_cfg.n_layers, classify=moe_by_kind)
        latent_recipe_s = time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    del moe_params
    torch.cuda.empty_cache()
    moe_attn = time_moe_attention(ops, card, fa.P_PIECES)
    gqa4 = ("ms", "max_abs_err", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "library_bf16_ms")

    # phase 12: the MLA family, minicpm3-4b at full width (MLA_DEPTH layers), seeded
    # random weights; the kernel's (96, 64) instances first
    mla_attn = check_mla_kernel(ops, card, fa.P_PIECES)
    mla_dec = check_mla_decode(ops, card)
    t1 = time.perf_counter()
    mla_carry = check_mla_carry(ops, card, ring_step_offsets, fa.P_PIECES)
    latent_recipe_s += time.perf_counter() - t1
    mla_cfg, mla_params = mla_model(configs, lm)
    mla_fwd = mla_forward(mla_cfg, mla_params, lm, fa)
    mla_srv = mla_serve(mla_cfg, mla_params, lm, Engine, ServeConfig, fa, fd)
    # phase 12b: the MLA family under a sharding recipe on a one-rank NCCL mesh
    device = init_world("cuda")
    try:
        lmesh = make_mesh((1, 1), ("data", "model"), device=device)
        t1 = time.perf_counter()
        mla_rec_fwd = latent_recipe_forward(mla_cfg, mla_params, lm, fa, lmesh, sharding,
                                            shard_params_by_recipe, mla_fwd["breakdown"])
        latent_recipe_serve(mla_cfg, mla_params, lm, Engine, ServeConfig, fd, lmesh, sharding,
                            shard_params_by_recipe, mla_srv["prompts"], NEW_TOKENS,
                            mla_srv["done"], 0)
        latent_recipe_s += time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    del mla_params
    torch.cuda.empty_cache()

    # phase 13: training at phi4-mini's full width, TRAIN_DEPTH layers: the
    # launcher's loop with a checkpoint, a step's device time by kind, the
    # gradients through the kernel against the plain attention, the ZeRO
    # step and the sp_ring step on one-rank NCCL meshes
    t0 = time.perf_counter()
    train_cfg = train_config(configs)
    launch = train_launcher(dataclasses.replace(train_cfg, n_layers=LAUNCHER_DEPTH))
    torch.cuda.empty_cache()
    train_params = lm.init_model(train_cfg, torch.Generator(device=DEVICE).manual_seed(0),
                                 device=DEVICE)
    batch = train_batch(train_cfg)
    tbreak = train_breakdown(train_cfg, train_params, batch, trainer, optimizer)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dryrun_train(train_cfg, train_params, batch, kernel_launches(fa, fd, kernels, relayout),
                 lm, trainer, optimizer)
    dryrun_s += time.perf_counter() - t1
    phase("dryrun_phases", seconds=dryrun_s)
    _, train_g, tgrad = train_grads(train_cfg, train_params, batch, fa, trainer, tree_leaves)
    torch.cuda.empty_cache()
    device = init_world("cuda")
    try:
        zero, m_base = zero_train(train_cfg, train_params, batch, train_g, trainer, optimizer,
                                  tree_leaves, make_mesh((1,), ("data",), device=device))
        del train_g
        torch.cuda.empty_cache()
        train_mesh = make_mesh((1, 1), ("data", "model"), device=device)
        ring = sp_ring_train(train_cfg, train_params, batch, m_base, fa, trainer, optimizer,
                             make_recipe, train_mesh)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec_train = recipe_train(train_cfg, train_params, batch, m_base, fa, lm, trainer,
                                 optimizer, sharding, shard_params_by_recipe, train_mesh)
        recipe_s += time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    del train_params
    torch.cuda.empty_cache()
    phase("training", seconds=time.perf_counter() - t0, launcher_peak_memory_gb=
          launch["peak_memory_gb"], step_peak_memory_gb=tbreak["peak_memory_gb"],
          zero_step_s=zero["step_s"], sp_ring_step_s=ring["step_s"],
          recipe_step_s=rec_train["step_s"])
    phase("recipe_phases", seconds=recipe_s)

    # phase 14: the hybrid and SSM families: the kernels' head dim of 112
    # (zamba2's shared attention; the forward, decode and carry forms)
    # against their plain versions and timed;
    # zamba2-7b and rwkv6-3b at full width, FAMILY_DEPTH (seeded bf16 weights):
    # forwards of 1 x SEQ tokens and serving with reused slots, zamba2's
    # through the kernels and held against its plain path; decode against
    # the forward at float32; one zamba2 training step
    t0 = time.perf_counter()
    hyb_attn = check_hybrid_kernels(ops, card, fa.P_PIECES)
    hyb_carry = check_hybrid_carry(ops, card, ring_step_offsets, ragged_seq_extents,
                                   fa.P_PIECES)
    recurrent, rec_recipe, recurrent_recipe_s = {}, {}, 0.0
    # phase 15: the SSM and hybrid families under a sharding recipe on a
    # one-rank NCCL (data, model) mesh, beside the phase's no-recipe runs
    device = init_world("cuda")
    try:
        rmesh = make_mesh((1, 1), ("data", "model"), device=device)
        for name in (HYBRID_ARCH, SSM_ARCH):
            rcfg, rparams = recurrent_model(configs, lm, name)
            recurrent[name] = (recurrent_forward(rcfg, rparams, lm, fa, fd),
                               recurrent_serve(rcfg, rparams, lm, Engine, ServeConfig, fd))
            t1 = time.perf_counter()
            rec_recipe[name] = (
                recurrent_recipe_forward(rcfg, rparams, lm, fa, rmesh, sharding,
                                         shard_params_by_recipe,
                                         recurrent[name][0]["breakdown"]),
                recurrent_recipe_serve(rcfg, rparams, lm, Engine, ServeConfig, fd, rmesh,
                                       sharding, shard_params_by_recipe,
                                       recurrent[name][1]["done"]))
            recurrent_recipe_s += time.perf_counter() - t1
            del rparams
            torch.cuda.empty_cache()
        checks = {name: recurrent_decode_vs_forward(configs, lm, name)
                  for name in RECURRENT_CHECK}
        t1 = time.perf_counter()
        hyb_train, hyb_rec_train = hybrid_train(configs, lm, fa, trainer, optimizer, tree_leaves,
                                                sharding, shard_params_by_recipe, rmesh)
        recurrent_recipe_s += hyb_rec_train["step_s"]
    finally:
        dist.destroy_process_group()
    phase("recurrent_recipe_phases", seconds=recurrent_recipe_s)
    hyb_fwd, hyb_srv = recurrent[HYBRID_ARCH]
    phase("recurrent_families", seconds=time.perf_counter() - t0,
          decode_vs_forward_max_abs_err={k: v["max_abs_err"] for k, v in checks.items()},
          hybrid_forward_ms=hyb_fwd["forward_ms"], ssm_forward_ms=recurrent[SSM_ARCH][0][
              "forward_ms"], hybrid_decode_tok_s=hyb_srv["decode_tok_s"],
          ssm_decode_tok_s=recurrent[SSM_ARCH][1]["decode_tok_s"],
          hybrid_train_step_s=hyb_train["step_s"],
          hybrid_recipe_train_step_s=hyb_rec_train["step_s"])

    # phase 16: one training step of the MLA and MoE families under the tp
    # recipe on a one-rank NCCL mesh, beside the no-recipe step
    device = init_world("cuda")
    try:
        t1 = time.perf_counter()
        tmesh = make_mesh((1, 1), ("data", "model"), device=device)
        latent_train = {
            family: latent_recipe_train(
                dataclasses.replace(configs.get(arch), n_layers=depth), lm, fa, trainer,
                optimizer, sharding, shard_params_by_recipe, tmesh, seed)
            for family, arch, depth, seed in (("mla", MLA_ARCH, MLA_TRAIN_DEPTH, 40),
                                              ("moe", MOE_ARCH, MOE_TRAIN_DEPTH, 50))}
        latent_recipe_s += time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    phase("latent_moe_recipe_phases", seconds=latent_recipe_s)

    # phase 17: the VLM and audio families at full width, FAMILY_DEPTH: the
    # kernels at their shapes, llama-3.2-vision-11b's forward and decode
    # through lm.decode_step, musicgen-large's forward and serving (single
    # host and TP on a one-rank NCCL mesh), decode against the forward at
    # float32 (depth cut), one training step of each (depth cut); and
    # (phase 18) both families under a sharding recipe on a one-rank NCCL
    # (data, model) mesh beside each no-recipe run, on the same model builds
    t0 = time.perf_counter()
    fam_attn = check_family_kernels(ops, card, fa.P_PIECES)
    fam_carry = check_family_carry(ops, card, fa.P_PIECES, attn_ptxas["flash_attention"])
    fam_recipe_s = 0.0
    device = init_world("cuda")
    try:
        fmesh = make_mesh((1, 1), ("data", "model"), device=device)
        vlm_cfg, vlm_params = family_model(configs, lm, VLM_ARCH)
        vlm_fwd = family_forward(vlm_cfg, vlm_params, lm, ops, fa)
        vlm_dec = vlm_decode(vlm_cfg, vlm_params, lm, fd, fa)
        t1 = time.perf_counter()
        vlm_rec_fwd = family_recipe_forward(vlm_cfg, vlm_params, lm, ops, fa, fmesh, sharding,
                                            shard_params_by_recipe, vlm_fwd["breakdown"])
        vlm_rec_dec = vlm_recipe_decode(vlm_cfg, vlm_params, lm, fd, fa, fmesh, sharding,
                                        shard_params_by_recipe, vlm_dec)
        fam_recipe_s += time.perf_counter() - t1
        del vlm_params
        torch.cuda.empty_cache()
        audio_cfg, audio_params = family_model(configs, lm, AUDIO_ARCH)
        audio_fwd = family_forward(audio_cfg, audio_params, lm, ops, fa)
        audio_srv, audio_single = serve_full_width(audio_cfg, audio_params, Engine, ServeConfig,
                                                   fd)
        audio_dec = decode_window(audio_cfg, audio_params, Engine, ServeConfig, VLM_WINDOW_STEPS)
        audio_tp, _ = serve_tp(audio_cfg, audio_params, Engine, ServeConfig, fd, fmesh,
                               audio_single, audio_dec, window_steps=VLM_WINDOW_STEPS)
        t1 = time.perf_counter()
        audio_rec_fwd = family_recipe_forward(audio_cfg, audio_params, lm, ops, fa, fmesh,
                                              sharding, shard_params_by_recipe,
                                              audio_fwd["breakdown"])
        audio_rec_srv = latent_recipe_serve(audio_cfg, audio_params, lm, Engine, ServeConfig,
                                            fd, fmesh, sharding, shard_params_by_recipe,
                                            serve_prompts(audio_cfg), NEW_TOKENS,
                                            audio_single["done"], audio_cfg.n_layers)
        fam_recipe_s += time.perf_counter() - t1
        del audio_params, audio_single
        torch.cuda.empty_cache()
        fam_checks = {name: family_decode_vs_forward(configs, lm, name, depth)
                      for name, depth in ((VLM_ARCH, VLM_CHECK_DEPTH),
                                          (AUDIO_ARCH, AUDIO_CHECK_DEPTH))}
        fam_train = {name: family_train(configs, lm, fa, ops, trainer, optimizer, tree_leaves,
                                        name, depth, seq, fmesh, sharding,
                                        shard_params_by_recipe)
                     for name, depth, seq in ((VLM_ARCH, VLM_TRAIN_DEPTH, VLM_TRAIN_SEQ),
                                              (AUDIO_ARCH, AUDIO_TRAIN_DEPTH, SEQ))}
        fam_recipe_s += sum(v["recipe"]["step_s"] for v in fam_train.values())
    finally:
        dist.destroy_process_group()
    phase("vlm_audio_recipe_phases", seconds=fam_recipe_s)
    phase("vlm_audio_families", seconds=time.perf_counter() - t0,
          vlm_forward_ms=vlm_fwd["forward_ms"], audio_forward_ms=audio_fwd["forward_ms"],
          vlm_decode_tok_s=vlm_dec["decode_tok_s"], audio_decode_tok_s=audio_srv["decode_tok_s"],
          audio_tp_decode_tok_s=audio_tp["decode_tok_s"],
          decode_vs_forward_max_abs_err={k: v["max_abs_err"] for k, v in fam_checks.items()},
          train_step_s={k: v["step_s"] for k, v in fam_train.items()},
          train_peak_memory_gb={k: v["peak_memory_gb"] for k, v in fam_train.items()},
          recipe_train_step_s={k: v["recipe"]["step_s"] for k, v in fam_train.items()},
          recipe_train_peak_memory_gb={k: v["recipe"]["peak_memory_gb"]
                                       for k, v in fam_train.items()})

    gemm_src = "src/repro_torch/kernels/csrc/gemm.cu"
    report = []
    for name, replaces in (("gemm", "src/repro/kernels/gemm.py:80"),
                           ("gemm_panel", "src/repro/kernels/gemm.py:181")):
        row = rows[(name, "EXTRALARGE")]
        report.append({"name": name, "route": "cuda", "source": gemm_src, "replaces": replaces,
                       "launches": launches[name], "max_abs_err": worst[name], **row})
    # the bf16 kernels: their launches on the main path, counted as the
    # float32 kernels' are (no path of the repo runs the GEMM in bf16)
    for name, replaces, other, keys in (
            ("gemm_bf16", "src/repro/kernels/gemm.py:80", ("gemm_bf16", "float32"),
             ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")),
            ("gemm_panel_bf16", "src/repro/kernels/gemm.py:181", ("gemm_panel_bf16", "float32"),
             ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms"))):
        prefix = "float32_out_" if name == "gemm_bf16" else "float32_panel_"
        report.append({"name": name, "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/gemm_bf16.cu",
                       "replaces": replaces, "operands": "bfloat16", "launches": launches[name],
                       "launches_on": "no model path: reached through ops on bf16 operands",
                       "max_abs_err": worst[name], **rows[(name, "bfloat16")],
                       **{prefix + key: rows[other][key] for key in keys}})
    report.append({"name": "flash_attention", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:169",
                   "launches": fwd["launches"], "max_abs_err": worst["flash_attention"],
                   "error_vs_float64_ratio": accuracy["kernel"],
                   "moe_forward_launches": moe_fwd["launches"],
                   **{f"moe_gqa4_{key}": moe_attn["flash_attention"][key] for key in gqa4},
                   "mla_forward_launches": mla_fwd["flash_attention_launches"],
                   **{f"mla_96_64_{key}": mla_attn[key] for key in
                      (*gqa4, "error_vs_float64_ratio", "library_bf16_backend")},
                   "train_launches": tgrad["flash_attention_launches"],
                   **{f"recipe_{mode}_forward_launches": row["flash_attention_launches"]
                      for mode, row in rec_fwd.items()},
                   "recipe_train_launches": rec_train["flash_attention_launches"],
                   "hybrid_forward_launches": hyb_fwd["flash_attention_launches"],
                   "hybrid_train_launches": hyb_train["flash_attention_launches"],
                   **{f"hybrid_recipe_{mode}_forward_launches": row["flash_attention_launches"]
                      for mode, row in rec_recipe[HYBRID_ARCH][0].items() if mode != "sp_ring"},
                   "hybrid_recipe_train_launches": hyb_rec_train["flash_attention_launches"],
                   **{f"zamba2_112_{key}": hyb_attn["flash_attention"][key] for key in
                      (*gqa4, "error_vs_float64_ratio", "library_bf16_backend")},
                   **{f"{fam}_recipe_{mode}_forward_launches": row["flash_attention_launches"]
                      for fam, rec in (("mla", mla_rec_fwd), ("moe", moe_rec_fwd))
                      for mode, row in rec.items() if mode != "sp_ring"},
                   **{f"{fam}_recipe_train_launches": row["tp"]["flash_attention_launches"]
                      for fam, row in latent_train.items()},
                   "vlm_forward_launches": vlm_fwd["flash_attention_launches"],
                   "vlm_forward_launches_by_causal_flag": vlm_fwd["by_causal_flag"],
                   "vlm_decode_step_launches": vlm_dec["launches_per_step"][
                       "flash_attention_non_causal"],
                   "audio_forward_launches": audio_fwd["flash_attention_launches"],
                   **{f"{fam}_train_launches": fam_train[arch]["flash_attention_launches"]
                      for fam, arch in (("vlm", VLM_ARCH), ("audio", AUDIO_ARCH))},
                   **{f"{fam}_recipe_{mode}_forward_launches": row["launches"]["flash_attention"]
                      for fam, rec in (("vlm", vlm_rec_fwd), ("audio", audio_rec_fwd))
                      for mode, row in rec.items()},
                   **{f"{fam}_recipe_train_launches":
                      fam_train[arch]["recipe"]["flash_attention_launches"]
                      for fam, arch in (("vlm", VLM_ARCH), ("audio", AUDIO_ARCH))},
                   **{f"{case}_{key}": fam_attn[name][key]
                      for case, name in (("vlm_cross", "cross_forward"),
                                         ("vlm_cross_step", "cross_step"),
                                         ("musicgen_64_64", "audio_forward"))
                      for key in (*gqa4, "error_vs_float64_ratio", "library_bf16_backend")},
                   **rows["flash_attention"]})
    prefill = rows[("flash_decode", "prefill_chunk")]
    report.append({"name": "flash_decode", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                   "replaces": "src/repro/kernels/flash_decode.py:71",
                   "launches": srv["flash_decode_launches"],
                   "launches_by_kind": srv["flash_decode_launches_by_kind"],
                   "tp_serve_launches": tp["flash_decode_launches"],
                   "tp_serve_launches_by_kind": tp["flash_decode_launches_by_kind"],
                   "recipe_serve_launches": rec_srv["flash_decode_launches"],
                   "recipe_serve_launches_by_kind": rec_srv["flash_decode_launches_by_kind"],
                   "recipe_tp_serve_launches": rec_tp_srv["flash_decode_launches"],
                   "recipe_tp_serve_launches_by_kind":
                   rec_tp_srv["flash_decode_launches_by_kind"],
                   "moe_serve_launches": moe_srv["flash_decode_launches"],
                   "moe_recipe_serve_launches": moe_rec_srv["flash_decode_launches"],
                   "hybrid_serve_launches": hyb_srv["flash_decode_launches"],
                   "hybrid_serve_launches_by_kind": hyb_srv["flash_decode_launches_by_kind"],
                   "hybrid_recipe_serve_launches":
                   rec_recipe[HYBRID_ARCH][1]["flash_decode_launches"],
                   **{f"zamba2_112_{key}": hyb_attn["flash_decode"][key] for key in gqa4},
                   **{f"moe_gqa4_{key}": moe_attn["flash_decode"][key] for key in gqa4},
                   "vlm_decode_step_launches": vlm_dec["launches_per_step"]["flash_decode"],
                   "audio_serve_launches": audio_srv["flash_decode_launches"],
                   "audio_serve_launches_by_kind": audio_srv["flash_decode_launches_by_kind"],
                   "audio_tp_serve_launches": audio_tp["flash_decode_launches"],
                   "audio_recipe_serve_launches": audio_rec_srv["flash_decode_launches"],
                   "audio_recipe_serve_launches_by_kind":
                   audio_rec_srv["flash_decode_launches_by_kind"],
                   "vlm_recipe_decode_step_launches":
                   vlm_rec_dec["launches_per_step"]["flash_decode"],
                   **{f"musicgen_d64_{key}": fam_attn["audio_decode"][key] for key in gqa4},
                   **{f"mla_96_64_{case}_{key}": mla_dec[case][key]
                      for case in ("step", "prefill_chunk") for key in gqa4},
                   "max_abs_err": worst["flash_decode"], **rows[("flash_decode", "decode")],
                   **{f"prefill_chunk_{key}": prefill[key]
                      for key in ("ms", "bound_ms", "bound_by", "fp32_bound_ms", "plain_ms",
                                  "library_ms", "library_bf16_ms")},
                   **{f"tp_shard_m{M}_{key}": shards[M][key] for M in TP_SHARD_MODEL_AXES
                      for key in ("ms", "max_abs_err", "bound_ms", "bound_by", "plain_ms",
                                  "library_ms", "library_bf16_ms")}})
    report.append({"name": "flash_attention_carry", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:229",
                   "launches": carry_launches, "max_abs_err": worst["flash_attention_carry"],
                   "train_launches": ring["flash_attention_carry_launches"],
                   "hybrid_recipe_sp_ring_forward_launches":
                   rec_recipe[HYBRID_ARCH][0]["sp_ring"]["flash_attention_carry_launches"],
                   "zamba2_112_max_abs_err": hyb_carry["max_abs_err"],
                   **{f"zamba2_112_{case}_{key}": hyb_carry[case][key]
                      for case in ("off_diagonal", "diagonal", "one_card_step")
                      for key in ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
                   **{f"{fam}_recipe_sp_ring_forward_launches":
                      rec["sp_ring"]["flash_attention_carry_launches"]
                      for fam, rec in (("mla", mla_rec_fwd), ("moe", moe_rec_fwd))},
                   **{f"{fam}_recipe_sp_ring_forward_launches":
                      rec["sp_ring"]["launches"]["flash_attention_carry"]
                      for fam, rec in (("vlm", vlm_rec_fwd), ("audio", audio_rec_fwd))},
                   **{f"{case}_one_card_step_{key}": fam_carry[case][key]
                      for case in ("musicgen_64_64", "vlm_128_128")
                      for key in ("ms", "max_abs_err", "bound_ms", "bound_by", "plain_ms",
                                  "library_ms", "ptxas")},
                   "mla_96_64_max_abs_err": mla_carry["max_abs_err"],
                   **{f"mla_96_64_{case}_{key}": mla_carry[case][key]
                      for case in ("off_diagonal", "diagonal", "one_card_step")
                      for key in ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
                   "chain_error_vs_float64_ratio": accuracy["chain"],
                   **rows[("flash_attention_carry", "off_diagonal")]})
    report.append({"name": "transpose_tiled", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/transpose.cu",
                   "replaces": "src/repro/kernels/relayout.py:35",
                   "launches": transpose_launches, "max_abs_err": 0.0, **rows["transpose"]})
    for row in report:
        check_bound(row["name"], row)
    phase("run", seconds=time.perf_counter() - run_t0)
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``src/repro_torch`` (never ``jax`` or ``repro``) on ``cuda:0`` in
phases, each printing one JSON line; a failing phase raises, and the
script exits non-zero without the final ``ok`` line:

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a); the
   sign_compress library must hold one kernel, ``sign_compress_kernel``;
3. kernels: each CUDA kernel against its plain PyTorch version at the main
   path's shape, the resident ``(8, 89344, 128)`` f32 state of full-width
   DeepFM on a K=8 ring (``fused_adam`` beside ``torch._fused_adam_``,
   held to the same plain version; ``sign_compress_stacked`` over
   DeepFM's 11 leaf segments and over the whole buffer; ``sign_compress``
   over one worker's 11,202,602 elements; ``payload_mix`` with the ring's
   2 payloads and one-peer-exponential's union of 5), with CUDA-event times
   (median of 20 after warm-up) beside the least time the card's memory
   rate allows; each sign record also holds one launch of the persistent
   kernel a call, none of the three it replaced, and a second call equal
   to the first to the bit; then the CD-Adam neighbour-copy update, plain
   torch ops, timed alone;
4. slice, once per path: the paper's experiment through the user's entry
   points, ``launch.deepfm_ctr.run`` (DeepFM 39 fields x 25,000 features,
   embed 10, MLP 400-400-400, K=8, packed, p=4, 512 examples per worker,
   20 ``fit`` steps) then one ``opt.round`` of p=4: D-Adam and CD-Adam
   (sign compressor, gamma 0.4) on the ring, then the straggler-tolerant
   runtime: D-Adam with staleness 2 at straggler rate 0.3, D-Adam over
   the one-peer-exponential schedule with overlap, CD-Adam with overlap.
   The launch counters are zeroed just before each path and read just
   after: every kernel of the path must have run, exactly as often as its
   schedule says; a profile of one communication period follows each;
5. checkpoint: the CD-Adam overlap and D-Adam straggler states saved from
   the card and restored into ``opt.init``: the resident buffers equal to
   the bit, the straggler buffers cold, then one more step;
6. churn: the D-Adam straggler state resized K 8 -> 6 (clone) -> 8 (mean)
   at full width, 4 steps after each resize;
7. card vs CPU: three steps of each path from one init and one set of
   batches on the card (kernels) and on the CPU (plain versions) must
   agree (p=3 for the synchronous paths, p=1 for the straggler-tolerant
   ones, so that rounds 2 and 3 mix buffered payloads); on the CD-Adam
   paths every step's hat moves are held to the CPU's one by one (size
   to the tolerance, flipped signs counted) and the neighbour copies to
   their neighbours' own hats to the bit;
8. serve: llama3.2-1b at full width (16 layers, d_model 2048, vocab
   128,256; weights from a seed) published into a ``ParamStore`` and
   served by ``DecodeEngine`` over buckets (1, 128) and (8, 1024), 32 new
   tokens, 11 prompts (batch padding, seq padding with the rewind, group
   splitting), then a second published version and the same prompts
   again: every prefill runs the CUDA flash kernel once per layer and no
   other kernel runs; then prefill and decode times per bucket, tokens/s,
   peak memory and a profile of one batch;
9. serve card vs CPU: the same weights (full width, 2 layers) on both,
   teacher-forced logits within the f32 tolerance at f32 compute and, at
   bf16, no farther from the f32 logits on the card than on the CPU;
   greedy tokens equal wherever the CPU's top-2 logit gap exceeds twice
   the devices' difference;
10. online: full-width DeepFM, K=8 packed D-Adam, ``train_online`` for 12
   steps publishing the consensus mean every 4: versions 1-3, held-out
   AUC of each snapshot, the last one equal to ``unpack_mean`` of the
   live buffer computed on the CPU;
11. serve_rwkv: rwkv6-3b at full width (32 layers, d_model 2560, 40 WKV
   heads of 64, vocab 65,536; weights from a seed) published into a
   ``ParamStore`` and served by ``DecodeEngine`` over the same buckets,
   32 new tokens, 7 prompts (1024 x 5 in one batch with 3 padding rows,
   128 x 2 in two calls), then a second version (recast with the f32
   leaves kept) and the prompts again: every prefill and decode step runs
   the CUDA WKV kernel once per layer and no other kernel runs; then the
   times per bucket, tokens/s, peak memory and a profile of one batch;
12. serve_rwkv card vs CPU: as 9, for rwkv6-3b cut to 2 layers, one
   (2, 128) prefill and 4 decode steps;
13. lm_train: llama3.2-1b at full width (16 layers, d_model 2048, GQA
   32/8, d_ff 8192, vocab 128,256; 1,235,814,400 parameters a worker)
   trained through the port's CLI as a user runs it
   (``repro_torch.launch.train.main``: K=2 ring, packed D-Adam, p=4, 2 x
   1024 tokens a worker, 8 steps): 6 ``fused_adam`` and 2
   ``gossip_adam_mix`` launches and no other kernel, the loss falling from
   near ln 128,256; the peak memory, step times (local and comm apart), a
   profile of one period, and both Adam kernels timed on the trained
   (2, R, 128) state, ``torch._fused_adam_`` beside them;
14. lm_train_bf16: the same run through ``make_optimizer(moment_dtype=
   torch.bfloat16)`` and ``DecentralizedTrainer.fit``: the same launches,
   a peak below lm_train's, the same timings;
15. lm_train_cd: CD-Adam (sign, gamma 0.4) on llama3.2-1b at full width
   cut to 4 layers: one ``sign_compress_stacked`` (one scale per worker
   and leaf) and one ``consensus_mix`` per comm step; then a kernel record
   of ``sign_compress_stacked`` on its trained (2, R, 128) state over the
   model's leaves, held to the plain version worker by worker;
16. lm card vs CPU: llama3.2-1b and rwkv6-3b at full width cut to
   LM_CARD_CPU_LAYERS (1) layer, f32 compute, three packed D-Adam steps
   at p=3 in lock step on both, from one init: step 1 within
   LM_STEP1_TOL, step 3 as in 7;
17. damped: adaptive batch damping (AdaDamp, 8 chunks of the 512
   examples, one signal per worker) on full-width DeepFM, K=8 packed
   D-Adam at p=4, 20 steps through ``DecentralizedTrainer(damping=)``:
   the D-Adam launches, every worker's chunk count non-decreasing in
   [1, 8], the evaluations their sum, the loss falling, one step
   signature under ``recompile_limit=1``; step times, a
   profile of one period, the peak; then card vs CPU as in 7, damped,
   the per-worker counts equal on both devices and parting between
   workers;
18. vision: ResNet-20 at width 16 on CIFAR-shaped images, K=8 packed
   D-Adam at p=8 with weight decay 1e-4, 128 images a worker, 20 steps:
   the launches, the loss falling, held-out accuracy of the consensus
   mean, step times, a profile, the peak; then card vs CPU at 8 images a
   worker (``VISION_M_TOL``);
19. lm_train_damped (after lm_train_bf16): lm_train through the CLI with
   ``--damping geodamp:2:2:2``: lm_train's launches, 28 worker-chunk
   evaluations, a peak within 2 GB of lm_train's, a profile of one period;
20. serve_zamba2 (after serve_rwkv_card_vs_cpu): zamba2-7b whole (81
   Mamba2 layers, d_model 3584, the shared attention block of 32 heads of
   112 at its 5 sites; 6,751,130,832 parameters from a seed) served by
   ``DecodeEngine`` over the same buckets at exact seq, 7 prompts (1024 x
   5 in one batch, 128 x 2 in two calls), one version: one flash launch
   per site per prefill and no other kernel, the f32 leaves kept, times
   per bucket, tokens/s, peak memory, a profile with its flash launches;
   then the decode contract at full depth (ZAMBA2_CONTRACT_RATIO);
21. serve_zamba2_card_vs_cpu: as 9, for zamba2 cut to 2 layers with a
   shared block after each;
22. serve_moe: phi3.5-moe at full width cut to 4 of 32 layers (16
   experts of d_ff 6400, top-2), llama's buckets and 11 prompts, one
   version: one flash launch per layer per prefill, the router kept in
   f32, the share of (token, choice) pairs the capacity dropped in each
   layer of a full (8, 1024) prefill;
23. lm card vs CPU for zamba2 (a layer and its block) and phi3.5-moe (4
   of its 16 experts), as 16;
24. serve_vlm (after serve_moe): phi-3-vision whole (32 layers, d_model
   3072, 32/32 heads of 96, d_ff 8192, vocab 32,064, the 1024 -> 3072
   projector; 576 patch features a row from a seed) served by
   ``DecodeEngine.generate_batch(extras=)`` on llama's buckets, one
   version: a full (8, 1024) batch with 3 batch-padding rows, two
   padded rows of 1000 (the rewind at L - 1 + 576), a full (1, 128) and a
   padded 97: 32 flash launches (D = 96 over 576 + S positions) per
   prefill, none in decode, no other kernel; times per bucket, tokens/s,
   peak memory, a profile of one batch;
25. serve_vlm_card_vs_cpu: as 9, phi-3-vision cut to 2 layers, the patch
   features drawn on the CPU and copied;
26. serve_whisper: whisper-large-v3 whole (32 encoder and 32 decoder
   layers, d_model 1280, 20/20 heads of 64, d_ff 5120, vocab 51,866;
   1500 frame embeddings a row from a seed) on buckets (1, 128) and (8,
   384) at exact seq (a prompt and 32 new tokens within the published 448
   positions): 96 flash launches per prefill (32 encoder, non-causal; 32
   decoder, causal; 32 cross-attention, non-causal with S != T), none in
   decode, no other kernel; the same records, then the decode contract
   at full depth, as serve_zamba2's;
27. serve_whisper_card_vs_cpu: as 9, at 2 encoder and 2 decoder layers;
28. lm card vs CPU for whisper (2 + 2 layers), as 16: the
   cross-attention's backward on the card;
29. lm_example: the port of examples/decentralized_lm.py as a user runs
   it (``repro_torch.launch.decentralized_lm``, the 100m preset, K=4
   ring, packed D-Adam at p=4, 12 steps): 9 ``fused_adam`` and 3
   ``gossip_adam_mix`` launches and no other kernel, the loss falling.
30. axis (after the DeepFM slices, before 7): ``comm='axis'`` with K=8
   ranks spawned on the one card in a gloo group, every message staged
   through host memory (NCCL needs a card per rank and is not run): the
   paper's experiment at full width through ``make_optimizer(comm=
   'axis')`` and ``DecentralizedTrainer.fit``, 12 steps at p=4, for
   D-Adam and CD-Adam on the ring and D-Adam with staleness 2 at rate
   0.3. Per rank: the launches of its schedule, the bytes a round (the
   accounting's equal to the stacked path's, and those on the wire), the
   local and comm step medians, the peak memory; its buffers after steps
   1, 3 and 4 against its rows of the same path stacked on the card (its
   loss evaluated worker by worker, as a rank evaluates it; the batched
   stacked run's gap is recorded beside), the loss after 12 steps within
   AXIS_LOSS_RTOL; a float32 and an int8 block sent to the next rank equal
   to the bit. The kernels phase also holds ``fused_adam``,
   ``consensus_mix`` and ``sign_compress_stacked`` at one rank's K = 1
   shard.
31. axis2d (after axis): the 2D worker x model layout, K=4 workers of
   M=2 ranks each (8 ranks on the one card in a gloo group,
   host-staged), each rank one ``(1, rows / 2, 128)`` block of its
   worker's row-sharded state: the paper's experiment at full width
   through the trainer's packed mode (the worker's blocks all-gathered
   once a step), 12 steps at p=4, for D-Adam and CD-Adam (leaf scales
   summed over each model group: ``sign_compress_stacked(reduce_axis=)``,
   two launches a round) on the ring and D-Adam with AdaDamp at 8
   chunks; per rank the launches, the collectives by kind, the bytes a
   round (the accounting's equal to the stacked path's), the step times
   and peak memory, its buffers after steps 1, 3 and 4 against its block
   of the same path stacked over 4 workers on the card (loss worker by
   worker), the loss and the evaluations; then the sharded-packed mode
   (``sharded_mlp_loss`` at 8192 x 1024, no model-group all-gather)
   against the stacked run of ``mlp_loss``; CD-Adam's scales equal to the
   bit on every rank of a worker, every block received equal to its
   sender's; and the training CLI's run at ``--model-parallel 2`` (its
   sharding plan) against ``--model-parallel 1`` (reduced llama3.2-1b at
   f32 compute, 4 steps). The kernels phase holds the ``reduce_axis``
   form on one rank's block.
32. axis_elastic and axis_online (inside axis's spawn): ranks that leave
   and join the worker group in the world of 8 (``trainer.resize`` on
   every rank with its old group, ``share_log``): D-Adam tau=2 from its
   12-step state K 8 -> 6 by clone (ranks 6 and 7 leave), 4 steps, 6 -> 8
   by the mean (they join), 4 steps; CD-Adam 8 -> 6 by clone, 4 steps.
   Every member's buffers right after each resize and after each step
   equal to the bit (``bit_sums``) to its rows of the same plan stacked
   on the card (loss worker by worker), exact launches per rank (none
   outside a membership), ages cold, hats zero, the count kept, the
   resize's seconds and bytes a rank. Then ``train_online`` at K=8, 12
   steps publishing the mean every 4 and one worker's replica: the
   history (4, 1), (8, 2), (12, 3) on every rank, every tree equal to the
   bit to the stacked run's ``publish_params``, the held-out AUC by
   version, the publish ms a rank.
33. axis2d_elastic (inside axis2d's spawn): the D-Adam state at (K, M) =
   (4, 2) resized by clone to (2, 4), 2 steps and one mean publish, every
   rank's block equal to the bit to its block of the stacked K=4 -> 2 run
   in the (2, 4) layout, the launches exact.
34. examples (before lm_example): the ports of examples/quickstart.py,
   serve_lm.py, online_serve.py and compressed_comm.py as a user runs
   them on the card, their launches exact (``EXAMPLES``); compressed_comm
   with ``--backend packed`` (150 steps at p=4: D-Adam's 113 ``fused_adam``
   and 37 ``gossip_adam_mix``, sign CD-Adam's 150 ``fused_adam`` and 37
   each of ``sign_compress_stacked`` and ``consensus_mix``; top-k and
   quantize on the reference backend), each row's comm MB the JAX
   accounting's;
34b. axis2d_plan (after axis2d): the sharding plan (slice 22).
   llama3.2-1b at full width (f32 params, bf16 compute) through the
   training CLI at ``--comm axis --workers 2 --model-parallel 2 --backend
   packed`` on 4 gloo ranks of the one card (each held to PLAN_RANK_SHARE
   of it), packed D-Adam at p=2, 4 steps, PLAN_BATCH x PLAN_SEQ tokens a
   worker: each rank holds one (1, 4827904, 128) block and its plan shard
   of every matrix; no model all-gather, 2 redistributions and 100 model
   sums a step, 4 ``fused_adam`` launches a rank; the losses held within
   PLAN_LOSS_RTOL of the stacked twin's (``--comm stacked``, the same
   params and batches); the peak a rank, the step medians and the
   collectives a step; the packed route without the plan at the same
   setting beside it (its peak, or the share it runs out of). Then the
   planned route on the card against the CPU at the four dense configs
   reduced (f32 compute, 2 steps; step 1's loss within LM_STEP1_TOL, the
   blocks by step3_check), the planned config's invariant gate, and
   ``fused_adam``'s record at a rank's block beside ``torch._fused_adam_``.
   Since slice 23 the card-vs-CPU part also runs the reduced phi3.5-moe,
   llama4-maverick and phi-3-vision, and the gate also
   ``axis2d-plan-moe`` (the reduced phi3.5-moe).
34c. axis2d_plan_moe and axis2d_plan_vlm (after axis2d_plan): the sharding
   plan for the MoE and vision-language families (slice 23) at full
   width, through the library path (the config's depth and param dtype
   cut in the config), on the same 4 gloo ranks (K=2 x M=2, each held to
   PLAN_RANK_SHARE), PLAN_BATCH x PLAN_SEQ text tokens a worker, packed
   D-Adam at p=2, PLAN_FAMILY_STEPS (3) steps, so that step 3's loss
   reads the comm step's mix (one spawn runs both):
   phi3.5-moe at 1 of 32 layers with bf16 params and the config's bf16
   moments (the f32 router makes the packed buffer f32, as in JAX),
   phi-3-vision at PLAN_VLM_LAYERS of 32 layers with f32 params (576
   patch positions before the text). Each rank in the planned mode
   with its (1, rows / 2, 128) block, no model all-gather, 2
   redistributions and the plan's sums a step, ``fused_adam`` on every
   step; the losses within PLAN_LOSS_RTOL of the stacked twin's (the same
   params and batches, K=2 on the card); the MoE twin's dropped pairs a
   call; the peak, step times and collectives a rank; ``fused_adam``'s
   record at each rank block (f32 p with bf16 moments, and f32) beside
   its plain version and, where p and the moments share a dtype,
   ``torch._fused_adam_``.
35. invariants (after axis2d): ``repro_torch.analysis``'s gate on the
   card: the sweep's 20 stacked configs (reference and packed x D-Adam
   and CD-Adam x plain, schedule, stale, overlap, damping; one period
   each, the launches exact), the topology zoo, the serving gate
   (``DecodeEngine``, no collective) and the known-bug corpus (its axis
   items run in the axis phase's ranks and must fail); beside them the
   reports of every axis rank body's fit, each run under the gate
   (``gated_fit``: ``analysis.check.period_spec``, the collectives by
   kind, the launches, no uncounted ``torch.distributed`` call) and the
   planned 2D config's (axis2d_plan). A failing spec fails the phase.
36. lm_train_bf16p (after lm_train_bf16): llama3.2-1b at full width with
   ``param_dtype=torch.bfloat16`` through lm_train_bf16's library path
   (neither CLI has a parameter-dtype flag), moments by default (bf16):
   the buffer, m and v bf16, lm_train's launches, finite losses falling
   from near ln(vocab), a peak below lm_train_bf16's, the share of the
   first step's updates that bf16 rounding swallowed (no f32 master copy,
   as in JAX); step times, a profile of one period, MFU, and both Adam
   kernels at the LM shape, each held to the bit to its plain version
   there row range by row range;
37. lm_train_cd_bf16p and lm_train_tau2_bf16p (after lm_train_cd): at
   LM_CD_LAYERS layers with bf16 params, CD-Adam as lm_train_cd runs it
   (sign_compress_stacked and consensus_mix on bf16 buffers; then the
   sign kernel record on its trained bf16 state) and D-Adam with
   staleness 2 at straggler rate 0.3 (payload_mix on bf16 buffers), each
   run's launches exact.
38. claims (after examples): the paper's four claims on the card, the
   six runs of tests/test_system.py (K=8 ring, DeepFM at 8 fields x 32
   features, hidden (32, 32), 32 examples a worker, 120 steps) through
   ``launch.deepfm_ctr.run``: D-Adam at p = 1, 4, 8 and 8 and sign
   CD-Adam at p = 4 packed, D-PSGD on the reference backend; each run's
   launches exact and its comm MB the JAX accounting's, and the claims at
   that file's thresholds (``CLAIMS``).

lm_train and lm_train_bf16 also record their model FLOPs (6 N D) and
MFU at the card's bf16 peak, and each serving phase the MFU of its big
bucket's prefill (2 N D, N the active params; ``analysis.roofline``).

The CPU sides of the lm card-vs-CPU phases (16, 23, 28) run in a worker
thread started after axis2d (``LMCPUSides``), beside the card phases;
each step's card side and comparison run in the main thread between two
phases once its CPU side is ready, the last before lm_example.

Every phase's line holds ``elapsed_s``, the seconds since the script
started. Every profile is read through ``profile_tables`` (the
profiler's raw kineto events), not through torch's FunctionEvent list,
whose building takes tens of seconds for one LM period.

The kernels phase holds every bf16-param form at the DeepFM shape too
(``fused_adam`` and ``gossip_adam_mix`` with bf16 params and bf16 or f32
moments, ``gossip_mix``, ``consensus_mix``, ``payload_mix`` over 2 and 5
payloads, ``sign_compress_stacked`` over the leaves and in its
``reduce_axis`` form, ``sign_compress``), each to the bit (the sign
records' hats at the kernel's own scales), beside its bf16 byte bound;
``torch._fused_adam_`` on all-bf16 tensors beside ``fused_adam``; the
``{"kernels"}`` line counts a bf16-param form's launches on the bf16-param
paths only. It holds ``fused_adam`` and ``gossip_adam_mix`` with
bf16 moments too (``fused_adam`` to the bit, as with f32 moments;
``gossip_adam_mix``'s m and v within one bf16 ulp, p within 2e-5) and at
the vision phase's weight decay 1e-4, and takes
the profiler's device time of every kernel beside its CUDA-event time
(and of ``torch._fused_adam_`` beside ``fused_adam``, with both launch
paths' ``host_us``: 1,000 back-to-back calls at 128 elements). It
also holds ``flash_attention`` against its plain
version at eighteen shapes: the serve bucket's prefill, an 8192-token
prompt, a 512-key window, a non-causal f32 D=128 case, a ragged S=1021,
bf16 head dims 96 and 112, in f32 the serve bucket and head dims 96, 112
and 32, the (8, 1024) prefills of zamba2-7b (D=112, 32/32 heads) and
phi3.5-moe (D=128, 32/8), phi-3-vision's (8, 1600) prefill (D=96, 32/32),
and whisper's encoder (8, 1500, non-causal), cross-attention (384 tokens
against 1500 frames, non-causal) and decoder (8, 384) at D=64 20/20, the
cross-attention in f32 too (bf16 runs the wgmma kernel, f32 the 3xTF32
one; each record names its ``design``); at each it times the one SDPA call
that computes the same function, and names the CUDA kernels that call
launched.
And it
holds ``rwkv_scan`` against its plain version at the serve bucket's
prefill, a (1, 128) prefill, a decode step, a ragged f32 D=32 S=1000 case
and a 1024-step sequence cut into two calls that carry the state.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 at once.

    python3 chip_smoke.py --parent DIR

times ``fused_adam`` at the DeepFM buffer, one rank's K = 1 shard, with
bf16 moments and at the LM's (2, 9655040, 128) f32 state beside
``torch._fused_adam_`` (events, device ms, ``host_us``), the f32
``flash_attention`` cases, ``gossip_adam_mix``,
``sign_compress_stacked`` over DeepFM's leaves and over lm_train_cd's
layout, and one D-Adam and one CD-Adam period of full-width DeepFM
(device and wall ms) of the tree at DIR (an earlier commit unpacked by
``git archive <commit> | tar -x -C DIR``, its kernels built in its own
tree) against this tree's, one process per turn in the order parent,
change, change, parent, then prints the medians of each side and the
``nvidia-smi`` line; it runs no other phase and prints no ``ok`` line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import (H100_SXM,  # noqa: E402
                                           flash_flops)

DEVICE = "cuda"
K = 8
SHAPE = (K, 89344, 128)          # the resident buffer of full-width DeepFM
FULL = dict(n_fields=39, features_per_field=25_000, embed_dim=10,
            hidden=(400, 400, 400), per_worker=512)
ETA = 1e-3
ADAM = dict(eta=ETA, beta1=0.9, beta2=0.999, tau=1e-6, weight_decay=0.0)
REPS = 20
# Late in a long run the profiler loses the first kernel records of each
# window, more the more it has recorded before: five flash launches kept
# all 5 records in a fresh process, then 4, 4, 3, 2, 2 and 1 after each of
# six profiles of 30,000 small kernels, which lost their own first 0-3
# (NVIDIA H100 80GB HBM3, 700 W; torch 2.11 with CUPTI 12.8). So every
# profile window opens with PROFILE_PAD launches of PyTorch's spin kernel
# (``torch.cuda._sleep(1)``), which no sum or list counts.
PROFILE_PAD = 256
PAD_KERNEL = "spin_kernel"
# A kernel and its plain version run the same f32 operations in the same
# order (the kernels are built without FMA contraction), so they agree to
# the last bit but for rsqrtf's approximation, which the main path
# (tau > 0) does not reach.
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
# Card against CPU: after the first step (same params, same batch) the
# only differences are summation orders (cuBLAS against the CPU BLAS, the
# card's embedding backward accumulating with atomics), far inside the
# repo's optimizer-state tolerance. From the second step on they are not
# rounding-sized: a parameter difference of ~3e-8 flips the ReLU gate of
# the pre-activations that lie that close to zero (many, at this init
# and Adam's sign-like first step), which moves some gradients by percents,
# and Adam's normalised step turns that into parameter differences of a
# fraction of eta in a small share of the elements (measured on the H100:
# 0.023% of the elements, at most 0.11 eta, after 3 steps). So after step
# 3 the losses must agree to the tolerance, and the parameters outside it
# must be few (<= 1%) and each within eta; a fault of the port (a wrong
# leaf, worker or neighbour) breaks step 1 or whole leaves. On CD-Adam a
# sign that falls the other way moves a hat by 2 * scale, and every later
# mix moves the params there by gamma * w times that: ``hat_check``.
CARD_CPU_TOL = dict(rtol=2e-5, atol=2e-6)
CARD_CPU_MAX_SHARE = 0.01
# the H100 SXM's data-sheet memory rate (bytes/s) and f32 rate outside
# the tensor cores (operations/s), at its full 700 W power limit; every
# rate has one home, repro_torch.analysis.roofline.H100_SXM
MEM_RATE = H100_SXM.hbm_bytes_per_s
F32_RATE = H100_SXM.peak("float32")
# The sign-compression scale is a sum: the kernel adds tiles and then a
# fixed tree, the plain version calls torch.sum, so the two differ by the
# order of the sum. q must be equal; hat moves by scale * sign and may
# differ by that scale error on top of KERNEL_TOL.
SCALE_RTOL = 1e-5
BIT_EQUAL = dict(rtol=0.0, atol=0.0)
# bf16 moments: the kernels and the plain versions compute in f32 and round
# m and v once to bf16, to nearest-even: m and v within one bf16 ulp (equal
# but where a tie would break the other way), p, which stays f32, within
# the f32 tolerance of tests/test_kernels.py
BF16_MOMENT_P_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 parameter buffers (a model's param_dtype=bfloat16): every kernel
# widens to f32, does the plain version's f32 operations in its order and
# rounds each output once to its dtype, to nearest-even, as .to(bfloat16)
# does, so it is held to the plain version to the bit (BIT_EQUAL); the
# sign records' scales are sums in another order (SCALE_RTOL), and their
# bf16 hat is held to the bit to round(hat + scale * q) at the kernel's own
# scales. torch._fused_adam_ on all-bf16 tensors computes the same update
# in another order of f32 operations (lerp for m, one product for the
# step), so it may round a bf16 output the other way: held within one bf16
# ulp, 2**-7 of the value (BF16_LIBRARY_TOL).
BF16_LIBRARY_TOL = dict(rtol=8e-3, atol=1e-6)
# the sign records' bytes without L2 reuse in bf16: x, hat (2 + 2), q (1),
# then hat, q (2 + 1) and hat_out (2)
SIGN_NO_REUSE_BYTES_BF16 = 10
NO_MIXED_LIBRARY = ("none: torch._fused_adam_ takes one dtype for its "
                    "params and moments")
NO_BF16_EINSUM = ("none: one einsum takes W and x in one dtype, and the "
                  "ring's 1/3 weights in bf16 are another function")
# the one kernel of a sign_compress[_stacked] call, and the three of the
# design it replaced: a profile of this tree that records one of those
# fails its phase; --parent matches either tree's names
SIGN_KERNELS = ("sign_compress_kernel",)
OLD_SIGN_KERNELS = ("absmean_kernel", "scale_kernel", "apply_kernel")
OLD_SIGN_KERNEL = re.compile(r"\b(" + "|".join(OLD_SIGN_KERNELS)
                             + r")\(float const\*")
# the persistent sign_compress kernel reads x and hat and writes q in its
# first pass, then reads hat and q and writes hat in its second: 18 bytes
# an element when the 50 MB L2 serves none of the second pass
SIGN_NO_REUSE_BYTES = 18
NO_LIBRARY = "none: no single PyTorch call computes this update"
NO_STACKED_SUM = ("none: no single PyTorch call sums these operands "
                  "without first stacking them")
GAMMA = 0.4
PARAMS = 11_202_602
# the dense bf16 tensor-core peak of the H100 SXM at 700 W, and its f32
# rate as three TF32 products (operations/s)
BF16_RATE = H100_SXM.peak("bfloat16")
F32_3XTF32_RATE = H100_SXM.peak("float32_3xtf32")
# flash_attention against its plain version. Both accumulate in f32 and
# differ by the order of the sums (f32: tests/test_kernels.py's 2e-5),
# by the exponentials (ex2.approx, ~1e-6) and by the kernels' splits: the
# bf16 kernel carries p as bf16 hi + lo (to ~2**-17), the f32 kernel each
# product as three TF32 products (hi.hi + hi.lo + lo.hi, to ~2**-21), all
# far below the atol. In bf16 both round nearly the same f32 value once, so
# they differ by at most one bf16 ulp, at most 2**-7 of the value (rtol
# 8e-3), plus the f32 difference where the output is near zero (atol
# 2e-5).
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=8e-3, atol=2e-5)}
# f32 flash_attention against the same function in float64: its largest
# error may be at most F32_FLASH_F64_RATIO times the plain version's. The
# tensor core truncates as it adds into an accumulator; carried across the
# keys, that put the 3xTF32 kernel 9.0e-6 from float64 at whisper's cross-
# attention (8, 384, 1500, D=64, outputs up to 0.45), 15x the plain
# version's 5.8e-7; summing each k step on a fresh fragment brought it to
# 8.3e-7 (1.4x; NVIDIA H100 80GB HBM3, 700 W)
F32_FLASH_F64_RATIO = 2.0
# (name, B, S, T, Hq, Hk, D, dtype, causal, window)
FLASH_CASES = (
    ("serve bucket prefill", 8, 1024, 1024, 32, 8, 64, torch.bfloat16, True,
     0),
    ("long prompt", 1, 8192, 8192, 32, 8, 64, torch.bfloat16, True, 0),
    ("window 512", 2, 2048, 2048, 32, 8, 64, torch.bfloat16, True, 512),
    ("non-causal f32, D=128", 2, 512, 1024, 16, 16, 128, torch.float32,
     False, 0),
    ("ragged S=1021", 2, 1021, 1021, 32, 8, 64, torch.bfloat16, True, 0),
    ("D=96", 2, 1024, 1024, 32, 8, 96, torch.bfloat16, True, 0),
    ("D=112", 2, 1024, 1024, 32, 8, 112, torch.bfloat16, True, 0),
    ("serve bucket prefill, f32", 8, 1024, 1024, 32, 8, 64, torch.float32,
     True, 0),
    ("D=96 f32", 2, 1024, 1024, 32, 8, 96, torch.float32, True, 0),
    ("D=112 f32", 2, 1024, 1024, 32, 8, 112, torch.float32, True, 0),
    ("D=32 f32", 2, 1024, 1024, 32, 8, 32, torch.float32, True, 0),
    ("zamba2-7b prefill: D=112, 32/32 heads", 8, 1024, 1024, 32, 32, 112,
     torch.bfloat16, True, 0),
    ("phi3.5-moe prefill: D=128, 32/8 heads", 8, 1024, 1024, 32, 8, 128,
     torch.bfloat16, True, 0),
    ("phi-3-vision prefill: 576 patches + 1024 tokens, D=96, 32/32 heads",
     8, 1600, 1600, 32, 32, 96, torch.bfloat16, True, 0),
    ("whisper encoder: non-causal over 1500 frames", 8, 1500, 1500, 20, 20,
     64, torch.bfloat16, False, 0),
    ("whisper cross-attention: 384 tokens against 1500 frames", 8, 384,
     1500, 20, 20, 64, torch.bfloat16, False, 0),
    ("whisper decoder self-attention", 8, 384, 384, 20, 20, 64,
     torch.bfloat16, True, 0),
    ("whisper cross-attention, f32", 8, 384, 1500, 20, 20, 64,
     torch.float32, False, 0),
)
# --parent: fused_adam at LM_SHAPE, SHAPE, one rank's K = 1 shard and
# SHAPE with bf16 moments beside torch._fused_adam_, the f32 flash cases
# above that a tree takes, gossip_adam_mix and sign_compress_stacked at
# SHAPE and the DeepFM periods (ab_side), timed in one process per turn of
# parent (P) and change (C)
AB_ORDER = "PCCP"
# fused_adam's launch path alone (host_us): the wall time of HOST_CALLS
# back-to-back calls at HOST_N elements, where the kernel takes a few µs,
# over HOST_CALLS, in HOST_BATCHES batches; the same for
# torch._fused_adam_
HOST_N = 128
HOST_CALLS = 1000
HOST_BATCHES = 5
# serving: llama3.2-1b at full width over two buckets; the prompts fill
# the (8, 1024) bucket (1024 x 5), pad it in seq and take the rewind
# (1000 x 2, 700), split a group over the (1, 128) bucket (128 x 2) and
# pad a short prompt (97): 6 prefills per pass, each one flash launch per
# layer
SERVE_ARCH = "llama3.2-1b"
SERVE_BUCKETS = ((1, 128), (8, 1024))
SERVE_NEW = 32
SERVE_LENGTHS = (1024,) * 5 + (1000,) * 2 + (700, 128, 128, 97)
SERVE_PREFILLS = 6
# serving, card against CPU. At f32 compute the teacher-forced logits must
# agree to the f32 tolerance of tests/test_kernels.py, and the greedy
# tokens must be equal wherever the CPU's top-2 gap exceeds twice the
# step's card-CPU difference (or 2e-5). At bf16 compute no
# elementwise 2e-2 bound holds between two correct pipelines at full
# width: each rounds the 2048-wide hidden state to bf16 at every op, and
# on the H100 (2 layers) the CPU's bf16 logits lie up to 0.072 from its
# own f32 ones, the card's up to 0.071, and the two up to 0.047 apart
# (0.03% of the elements past 2e-2). So the card's bf16 logits must lie
# no farther from the CPU's f32 logits than the CPU's bf16 logits do
# (times SERVE_BF16_RATIO), and greedy tokens must be equal wherever the
# CPU's top-2 gap exceeds twice the step's largest card-CPU difference
# (or 2e-2, if larger): past that no rounding can swap them.
SERVE_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# phi-3-vision's f32 logits, card against CPU, take SERVE_F32_TOL's atol
# times each position's largest |logit| (``f32_row_scale``; the rtol
# unchanged). Its 576 patch positions enter at unit scale (N(0, 1)
# features through a 1/sqrt(1024) projector, 50 times the 0.02 token
# embeddings), so every hidden state is O(1) from the first layer, and
# at d_model 3072 the two devices' f32 GEMMs (cuBLAS against the CPU's
# BLAS, no TF32) part by up to 3.0e-5 at logits up to 4.39, 34 of 320,640
# past the elementwise 2e-5, with the flash kernel out of both (naive
# sdpa; NVIDIA H100 80GB HBM3, 700 W): a dot product's rounding scales
# with its terms, not with its sum.
# serving rwkv6-3b at full width over the same buckets: five full (8, 1024)
# rows in one batch (3 padding rows) and two (1, 128) calls, 3 batches a
# pass, each one WKV launch per layer per prefill and per decode step
SERVE_RWKV_ARCH = "rwkv6-3b"
SERVE_RWKV_LENGTHS = (1024,) * 5 + (128,) * 2
SERVE_RWKV_BATCHES = 3
# rwkv_scan against its plain version: each state element is w * S rounded
# plus k * v rounded in both (no FMA contraction in the kernel), so the
# final state must be equal to the bit, and a sequence cut into two calls
# equal to one call; y sums over the key dim in another order than the
# plain version's einsum: f32 2e-5 (tests/test_kernels.py)
WKV_Y_TOL = dict(rtol=2e-5, atol=2e-5)
# (name, B, S, H, D, r/k/v dtype); w from the model's decays at init
# (w0 = -5), u and a nonzero state at JAX's scales
WKV_CASES = (
    ("serve bucket prefill", 8, 1024, 40, 64, torch.bfloat16),
    ("B=1 prefill", 1, 128, 40, 64, torch.bfloat16),
    ("decode step", 8, 1, 40, 64, torch.bfloat16),
    ("D=32 f32, ragged S=1000", 8, 1000, 80, 32, torch.float32),
)
NO_WKV_LIBRARY = "none: no PyTorch call computes the WKV recurrence"
# serving zamba2-7b whole: 81 Mamba2 layers (d_model 3584, d_inner 7168,
# 112 SSM heads of 64, state 64) and the shared attention block (32 heads
# of 112, no GQA, d_ff 14,336) at its 5 sites; 6,751,130,832 parameters,
# nothing cut. The same buckets at exact seq (the recurrent state would
# fold pads in): five (8, 1024) rows in one batch (3 padding rows) and two
# (1, 128) calls, 3 prefills, each one flash launch per site. One version
# is served: a second would hold 27 GB more beside the first's 40.5.
SERVE_ZAMBA2_ARCH = "zamba2-7b"
SERVE_ZAMBA2_LENGTHS = (1024,) * 5 + (128,) * 2
SERVE_ZAMBA2_PREFILLS = 3
# zamba2's decode contract at full depth: a (1, 128) prompt's prefill and
# ZAMBA2_CONTRACT_NEW decode steps through the engine's bf16 params against
# one forward over the whole sequence. Through 81 layers two correct bf16
# pipelines part by their roundings far past an elementwise 2e-2, so both
# are measured against the f32 forward of the f32 params: the served path
# may lie at most ZAMBA2_CONTRACT_RATIO times as far from it as the bf16
# forward does, in the largest difference and in the RMS one. A wrong
# state, site or position lies O(1) away.
ZAMBA2_CONTRACT_NEW = 8
ZAMBA2_CONTRACT_RATIO = 2.0
# serving phi3.5-moe at full width (d_model 4096, GQA 32/8 of head dim
# 128, 16 experts of d_ff 6400, top-2, vocab 32,064) cut to 4 of its 32
# layers: 32 take 42B parameters, 168 GB in f32. llama's buckets and
# padded prompts (a pad token takes expert capacity, as in JAX), 6
# prefills, each one flash launch per layer; one version
SERVE_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
SERVE_MOE_LAYERS = 4
# LM card against CPU at LM_CARD_CPU_LAYERS layers (2 until the vlm and
# audio phases took the smoke past 1,000 of its 1,200 s on a slow host:
# the CPU's side of these phases is the smoke's largest cost, and an
# earlier path may run at a smaller depth): zamba2 with its shared block
# after each layer (at period 14 the first 13 layers have none),
# phi3.5-moe with 4 of its 16 experts (all 16 make 2.9B parameters a
# worker at 2 layers, 23 GB a resident buffer at K=2, more than the host
# holds for the CPU's plain Adam); whisper, the newest path, at 2 encoder
# and 2 decoder layers
LM_CARD_CPU_LAYERS = 1
LM_CARD_CPU_CUTS = {"zamba2-7b": dict(shared_attn_period=1),
                    "phi3.5-moe-42b-a6.6b": dict(n_experts=4),
                    "whisper-large-v3": dict(n_layers=2,
                                             n_encoder_layers=2)}
# The CPU sides of these phases (their plain versions: 219 s of the
# smoke's 295 s in them on an NVIDIA H100 80GB HBM3 host) run in a worker
# thread started after the axis phases (whose 8 ranks share the host's
# cores), in LM_CPU_ORDER (the largest first), with LM_CPU_THREADS torch
# threads, beside the card phases. The worker hands each step's state
# over; the main thread, between two phases, runs the card side to that
# step and compares. Two child-process designs ran first (NVIDIA H100
# 80GB HBM3, 700 W): with the states of steps 1 and 2 kept as copies in
# shared memory the child's peak RSS reached 84.7 GB of the host's 101,
# and in both the card's copies out of shared memory took 25-100 s an
# arch (1,227 and 1,175 s for the smoke)
LM_CPU_ORDER = (("phi3.5-moe-42b-a6.6b", LM_CARD_CPU_CUTS[
    "phi3.5-moe-42b-a6.6b"]), ("zamba2-7b", LM_CARD_CPU_CUTS["zamba2-7b"]),
    ("rwkv6-3b", {}), ("llama3.2-1b", {}),
    ("whisper-large-v3", LM_CARD_CPU_CUTS["whisper-large-v3"]))
LM_CPU_THREADS = 4
LM_CPU_WAIT_S = 900
# serving phi-3-vision whole: 32 layers (d_model 3072, 32/32 heads of 96,
# d_ff 8192, vocab 32,064) and the projector, each request's 576 patch
# features (1024 wide, from a seed) before its text; 3,820,879,872
# parameters in the analytic count, nothing cut. llama's buckets, one
# version. Requests (rows, prompt length), one generate_batch call each
# on the tightest bucket: five full (8, 1024) rows (3 batch-padding
# rows), two rows of 1000 (the rewind at L - 1 + 576; 6 padding rows), a
# full (1, 128) and a padded 97 (the rewind): 4 prefills, each one flash
# launch per layer over 576 + S positions
SERVE_VLM_ARCH = "phi-3-vision-4.2b"
SERVE_VLM_REQUESTS = ((5, 1024), (2, 1000), (1, 128), (1, 97))
# serving whisper-large-v3 whole: 32 encoder and 32 decoder layers
# (d_model 1280, 20/20 heads of 64, d_ff 5120, vocab 51,866), each
# request's 1500 frame embeddings from a seed. Buckets (1, 128) and
# (8, 384): a prompt and 32 new tokens stay within the published 448
# text positions. Exact seq (JAX's engine pads no audio prompt): five
# (8, 384) rows (3 padding rows) and two (1, 128) calls, 3 prefills, each
# 96 flash launches (32 in the encoder, 32 decoder self-attention, 32
# cross-attention: non-causal, 384 or 128 tokens against 1500 frames)
SERVE_WHISPER_ARCH = "whisper-large-v3"
SERVE_WHISPER_BUCKETS = ((1, 128), (8, 384))
SERVE_WHISPER_REQUESTS = ((5, 384), (1, 128), (1, 128))
# the CUDA functions each serving kernel's wrapper launches, as the
# profiler names them (bf16 and f32 flash are two designs)
FLASH_FUNCTION = {torch.bfloat16: "flash_wgmma_kernel",
                  torch.float32: "flash_tf32x3_kernel"}
KERNEL_FUNCTIONS = {"flash_attention": tuple(FLASH_FUNCTION.values()),
                    "rwkv_scan": ("rwkv_scan_kernel",)}
SERVE_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SERVE_BF16_RATIO = 1.25
# the online phase: 12 fit steps at p=4 take fused_adam on the 9 local
# steps and gossip_adam_mix on the 3 communication steps
ONLINE_STEPS, ONLINE_EVERY = 12, 4
ONLINE_LAUNCHES = {"fused_adam": 9, "gossip_adam_mix": 3}
CD_ADAM = dict(gamma=GAMMA, compressor="sign")
# Each path of the main-path run: the optimizer, and the kernel launches
# of 20 fit steps at p=4 then one opt.round of p=4 (every other kernel 0).
# Synchronous D-Adam: the local steps take fused_adam, each comm step one
# gossip_adam_mix, the round's mix gossip_mix. Every other path takes
# fused_adam on all 24 steps; the straggler-tolerant D-Adam rounds (6) mix
# through payload_mix, CD-Adam's rounds take one consensus_mix and one
# sign_compress_stacked (all 11 leaves) each.
PATHS = {
    "d-adam": dict(kind="d-adam", opt={}, launches={
        "fused_adam": 19, "gossip_adam_mix": 5, "gossip_mix": 1}),
    "cd-adam": dict(kind="cd-adam", opt=CD_ADAM, launches={
        "fused_adam": 24, "consensus_mix": 6, "sign_compress_stacked": 6}),
    "d-adam-straggler": dict(kind="d-adam", opt=dict(
        staleness=2, straggler_rate=0.3, straggler_seed=1), launches={
        "fused_adam": 24, "payload_mix": 6}),
    "d-adam-one-peer-exp-overlap": dict(kind="d-adam", opt=dict(
        topology="one-peer-exponential", overlap=True), launches={
        "fused_adam": 24, "payload_mix": 6}),
    "cd-adam-overlap": dict(kind="cd-adam", opt=dict(CD_ADAM, overlap=True),
                            launches={"fused_adam": 24, "consensus_mix": 6,
                                      "sign_compress_stacked": 6}),
}
# LM training: llama3.2-1b at full width (16 layers, d_model 2048, GQA
# 32/8, d_ff 8192, vocab 128,256) on a K=2 ring, packed D-Adam at p=4,
# 2 sequences of 1024 tokens per worker, 8 steps: fused_adam on the 6
# local steps, gossip_adam_mix on the 2 comm steps. K=2 is cut from the
# CLI's 4 (at K=4 one f32 buffer is 19.8 GB and the state alone 59 GB).
# eta is 1e-4: at the CLI's default 1e-3 (no warm-up, no bias correction)
# the full-width loss climbed from 12.18 to 14.01 in 8 steps (NVIDIA H100
# 80GB HBM3, 700 W).
LM_ARCH = "llama3.2-1b"
LM_K, LM_PERIOD, LM_BATCH, LM_SEQ, LM_STEPS = 2, 4, 2, 1024, 8
LM_ETA = 1e-4
LM_ARGS = ["--arch", LM_ARCH, "--full", "--workers", str(LM_K),
           "--backend", "packed", "--optimizer", "d-adam",
           "--period", str(LM_PERIOD), "--batch", str(LM_BATCH),
           "--seq", str(LM_SEQ), "--steps", str(LM_STEPS),
           "--eta", str(LM_ETA), "--log-every", "1", "--device", DEVICE]
LM_PARAMS = 1_235_814_400
LM_LAUNCHES = {"fused_adam": 6, "gossip_adam_mix": 2}
# the LM example (the port of examples/decentralized_lm.py) as a user runs
# it: the 100m preset (12 layers, d_model 768, GQA 12/4, d_ff 2048, vocab
# 32,768, tied embeddings), K=4 ring, packed D-Adam at p=4, 4 x 128 tokens
# a worker, 12 steps, one fit call a step: fused_adam on the 9 local steps,
# gossip_adam_mix on the 3 comm steps. eta is LM_ETA: at the example's
# 1e-3 the loss climbed from 10.561 to 10.878 in these 12 steps (NVIDIA
# H100 80GB HBM3, 700 W), as the JAX example's does on its first tens of
# steps (tests/test_torch_examples.py)
LM_EXAMPLE_ARGS = ["--preset", "100m", "--workers", "4", "--period", "4",
                   "--steps", "12", "--log-every", "1", "--eta", str(LM_ETA),
                   "--device", DEVICE]
LM_EXAMPLE_LAUNCHES = {"fused_adam": 9, "gossip_adam_mix": 3}
# the last three example drivers as a user runs them, each with its
# defaults on the card: quickstart (K=8 DeepFM, 8 fields x 32 features,
# 100 steps on the JAX example's reference backend: no kernel), serve_lm
# (the reduced llama3.2-1b, 2 layers, buckets (1, 16) and (4, 16), five
# prompts in three prefills a call, two calls around a hot swap: a flash
# launch per layer per prefill) and online_serve (K=8 packed D-Adam at
# p=4, 60 steps, publishing every 20: fused_adam on the 45 local steps,
# gossip_adam_mix on the 15 comm steps)
# gossip_adam_mix on the 15 comm steps), and the compressor study
# (compressed_comm, the port of examples/compressed_comm.py, at its 150
# steps on --backend packed: its D-Adam and sign rows on the packed path,
# its top-k and quantize rows on the reference one, which launches no
# kernel): (name, arguments beside --device, launches)
COMPRESSED_STEPS, COMPRESSED_PERIOD = 150, 4


def dadam_launches(steps: int, period: int) -> collections.Counter:
    """Packed synchronous D-Adam on a stacked ring: ``fused_adam`` on each
    local step, one ``gossip_adam_mix`` (the Adam step and the mix in one
    pass) on each comm step, every ``period``-th."""
    comm = steps // period
    return collections.Counter(fused_adam=steps - comm,
                               gossip_adam_mix=comm)


def cdadam_launches(steps: int, period: int) -> collections.Counter:
    """Packed sign CD-Adam on a stacked ring: ``fused_adam`` on every step,
    one ``sign_compress_stacked`` and one ``consensus_mix`` on each comm
    step."""
    comm = steps // period
    return collections.Counter(fused_adam=steps, sign_compress_stacked=comm,
                               consensus_mix=comm)


EXAMPLES = (("quickstart", [], {}),
            ("serve_lm", [], {"flash_attention": 2 * 3 * 2}),
            ("online_serve", [], {"fused_adam": 45, "gossip_adam_mix": 15}),
            ("compressed_comm", ["--backend", "packed"], dict(
                dadam_launches(COMPRESSED_STEPS, COMPRESSED_PERIOD)
                + cdadam_launches(COMPRESSED_STEPS, COMPRESSED_PERIOD))))
# each row's comm MB after its 150 steps: the JAX package's byte accounting
# for the example's configuration (tests/test_torch_compressed_comm.py
# holds the port's equal to it), exact
COMPRESSED_COMM_MB = {"full precision": 3.618896000000003,
                      "sign (paper)": 0.9073879999999998,
                      "topk 1/16 [reference]": 0.45347199999999976,
                      "quantize 16 levels [reference]": 0.9073879999999998}
# the paper's four claims (tests/test_system.py, tests/test_torch_system.py)
# on the card: its six runs (K=8 ring, DeepFM 8 fields x 32 features, embed
# 10, hidden (32, 32), 32 examples a worker, 120 steps at eta 1e-3; AUC of
# the consensus mean on 256 held-out examples a worker from seed 999) at its
# thresholds, D-Adam and CD-Adam packed, D-PSGD on the reference backend
# (it has no kernel backend): (name, kind, options, comm MB). The comm MB
# is the JAX package's byte accounting for each run, exact
CLAIMS_STEPS = 120
CLAIMS_RUN = dict(hidden=(32, 32), per_worker=32, heldout=(256, 999))
CLAIMS = (("vanilla p=1", "d-adam", dict(period=1), 6.238080000000003),
          ("fig1 p=4", "d-adam", dict(period=4), 1.5595200000000007),
          ("fig1 p=8", "d-adam", dict(period=8), 0.7797600000000003),
          ("fig2 p=8", "d-adam", dict(period=8), 0.7797600000000003),
          ("fig34 cd-adam sign p=4", "cd-adam",
           dict(period=4, gamma=GAMMA, compressor="sign"),
           0.3920400000000002),
          ("d-psgd", "d-psgd", dict(backend="reference"),
           6.238080000000003))
# CD-Adam at full width cut to 4 layers (16 would take about 100 GB):
# fused_adam on all 8 steps, sign_compress_stacked and consensus_mix once
# per comm step
LM_CD_LAYERS = 4
LM_CD_LAUNCHES = {"fused_adam": 8, "sign_compress_stacked": 2,
                  "consensus_mix": 2}
# bf16 parameter buffers on the LM (lm_train_bf16p): llama3.2-1b with
# param_dtype=bfloat16 through lm_train_bf16's library path, moments by
# default (the buffer's dtype, so bf16), lm_train's launches. No f32 master
# copy is kept, as the JAX package keeps none: an Adam step below half an
# ulp of its bf16 parameter is lost, as in JAX's run
# (tests/test_torch_bf16_params.py). The share lost in the first step is
# read on every SWALLOW_STRIDE-th row of each worker (1/64 of the buffer,
# 77 MB, so the peak stays the run's own).
SWALLOW_STRIDE = 64
# the plain versions at the LM shape take f32 temporaries of their operands:
# they are compared with the kernels LM_CHECK_ROWS rows of every worker at a
# time
LM_CHECK_ROWS = 1 << 19
# then, at LM_CD_LAYERS layers with bf16 params (lm_train_cd_bf16p and
# lm_train_tau2_bf16p): CD-Adam as lm_train_cd runs it (sign_compress_stacked
# and consensus_mix on bf16 buffers), then D-Adam with staleness 2 at
# straggler rate 0.3 (payload_mix on bf16 buffers at each of its 2 rounds;
# the synchronous gossip_mix is not on that path)
LM_TAU2 = dict(staleness=2, straggler_rate=0.3, straggler_seed=1)
LM_TAU2_LAUNCHES = {"fused_adam": LM_STEPS, "payload_mix": 2}
# the paths whose buffers are bf16: the kernel records of the bf16-param
# forms count their launches there, the others everywhere else
BF16P_PATHS = ("lm_train_bf16p", "lm_train_cd_bf16p", "lm_train_tau2_bf16p")
# the first loss of random weights lies near ln(vocab): the logits' spread
# at init adds about half its square
LM_LOSS0_SLACK = 1.5
# calls per timing at the LM shape (each moves 50-70 GB)
LM_REPS = 5
# lm_train's resident f32 state: llama3.2-1b at full width, LM_K workers
LM_SHAPE = (LM_K, 9_655_040, 128)
# card against CPU after the first LM step: summation orders only (f32
# compute, no TF32). Adam's first step is about eta * 3.16 * g / (|g| +
# 3.2e-5), so a gradient that is itself a cancellation near f32's
# rounding floor (rwkv6's embedding grads pass the layer norm over a
# 0.02-scale embedding) moves its element by a share of eta that the two
# devices' roundings change: at most LM_STEP1_MAX_SHARE of the elements
# may lie outside LM_STEP1_TOL (on an NVIDIA H100 80GB HBM3 at 700 W: 1
# element of rwkv6's 1.01e9 at step 1, none of llama's).
LM_STEP1_TOL = dict(rtol=2e-5, atol=2e-5)
LM_STEP1_MAX_SHARE = 1e-8
# adaptive batch damping on the paper's experiment: benchmarks/damping.py's
# ctr task (CTR_CHUNKS = 8 chunks of the per-worker batch, per-worker
# AdaDamp signals) at the paper's width, K=8 ring, packed D-Adam at p=4,
# 20 fit steps: fused_adam on the 15 local steps, gossip_adam_mix on the 5
# comm steps, whatever the chunk counts (every step runs all 8 chunks)
DAMPING = dict(policy="adadamp", max_chunks=8, per_worker=True)
DAMPED_STEPS, DAMPED_PERIOD = 20, 4
DAMPED_LAUNCHES = {"fused_adam": 15, "gossip_adam_mix": 5}
# lm_train through the CLI with --damping geodamp:2:2:2: chunk counts 1, 1,
# 2, 2, 2, 2, 2, 2 a worker, so 2 x 14 = 28 worker-chunk evaluations; the
# same launches as lm_train. Its peak may pass lm_train's by at most
# LM_DAMPED_PEAK_SLACK_GB: the Adam step's seven buffers set both (the
# damped backward holds p, m, v, the accumulator and one chunk's gradient
# with half the activations).
LM_DAMPED_ARGS = LM_ARGS + ["--damping", "geodamp:2:2:2"]
LM_DAMPED_EVALS = LM_K * (1 + 1 + 2 * 6)
LM_DAMPED_PEAK_SLACK_GB = 2.0
# the paper's CIFAR experiment: ResNet-20 at He et al.'s width 16
# (272,250 parameters a worker) on CIFAR-shaped synthetic images, K=8
# ring, packed D-Adam at p=8, eta 1e-3, weight decay 1e-4
# (benchmarks/vision_resnet.py's D-Adam row, width 8 -> 16, 8 -> 128
# images a worker), 20 fit steps: fused_adam on 18, gossip_adam_mix on 2
VISION = dict(width=16, per_worker=128, period=8, steps=20,
              weight_decay=1e-4)
VISION_PARAMS = 272_250
VISION_LAUNCHES = {"fused_adam": 18, "gossip_adam_mix": 2}
# ResNet-20 card against CPU. cuDNN's algorithms (Winograd transforms
# among them in the vision profile) sum otherwise than the CPU's direct
# convolutions: the step-1 weight gradients lay up to 2.29e-5 and, in
# another run, 9.14e-5 of their leaf's largest apart on an NVIDIA H100
# 80GB HBM3 at 700 W (the CPU holds 2e-5 against JAX); a wrong leaf or
# worker lies O(1) apart. Adam's first step is +-3.16 eta wherever |g|
# passes 3.2e-5, so a gradient near zero whose sign the two devices round
# apart moves its element 6.3 eta apart (5.8 eta in that run, in 0.16% of
# the elements), and group norm's backward makes such gradients common.
# So: step 1's loss within CARD_CPU_TOL, its m (the gradient plus the
# decay) within VISION_M_TOL of each leaf's largest; every step's params
# within adam_part_cap, the most two Adam runs from one start can part;
# the later losses and the shares outside CARD_CPU_TOL are recorded.
VISION_M_TOL = 1e-3
# per-worker bytes of full-width DeepFM on the wire per round (the list
# over one schedule cycle): D-Adam sends the f32 params to each neighbour
# (ring: 2; one-peer-exponential with buffers: its union of 5 offsets
# every round), CD-Adam an int8 sign per parameter and one f32 scale per
# leaf (11 leaves) to each of the ring's 2
WIRE_BYTES = {"d-adam": [2 * 4 * PARAMS], "cd-adam": [2 * (PARAMS + 11 * 4)],
              "d-adam-straggler": [2 * 4 * PARAMS],
              "d-adam-one-peer-exp-overlap": [5 * 4 * PARAMS],
              "cd-adam-overlap": [2 * (PARAMS + 11 * 4)]}
# comm='axis' on the one card: the paper's experiment at full width, K=8
# ranks (one worker each) spawned in a gloo group on cuda:0, every message
# staged through host memory (NCCL needs a card per rank), p=4, 12 fit
# steps a path. Per rank: fused_adam on every step; CD-Adam's 3 rounds
# one consensus_mix and one sign_compress_stacked each (K = 1, the 11
# leaf segments); the mixes are f32 torch ops, as in the JAX package's
# comm='axis' (gossip_mix, gossip_adam_mix and payload_mix are
# stacked-only there).
AXIS_STEPS, AXIS_PERIOD = 12, 4
AXIS_PATHS = {
    "d-adam": dict(kind="d-adam", opt={}, launches={"fused_adam": 12}),
    "cd-adam": dict(kind="cd-adam", opt=CD_ADAM, launches={
        "fused_adam": 12, "consensus_mix": 3, "sign_compress_stacked": 3}),
    "d-adam-straggler": dict(kind="d-adam", opt=dict(
        staleness=2, straggler_rate=0.3, straggler_seed=1),
        launches={"fused_adam": 12}),
}
# the buffers held against the stacked run on the card, by step: after
# the first local step (within CARD_CPU_TOL), the third and the first
# round's (by step3_check's rule). The stacked run evaluates its loss
# worker by worker: the card's cuBLAS sums the batched products of 1 and
# of 8 workers in other orders, which at step 3 put 0.27% of the elements
# (10% of the first MLP layer's) outside CARD_CPU_TOL and one 1.29 eta off
# (NVIDIA H100 80GB HBM3, 700 W; each axis record holds that gap as
# stacked_batched_vs_per_worker). CD-Adam's first round mixes zero hats,
# so its params there are its half-step's.
AXIS_SNAPSHOTS = {1: ("buf", "m", "v"), 3: ("buf", "m", "v"), 4: ("buf",)}
# the mean loss over the 8 x 512 examples after the 12 steps, against the
# stacked run's: the few flipped gates move parameters by at most eta in
# at most 1% of the elements
AXIS_LOSS_RTOL = 1e-4
AXIS_GROUP_TIMEOUT_S = 120
AXIS_SPAWN_TIMEOUT_S = 420
# elastic membership inside the axis phase's world of 8 ranks: each plan
# goes on from its path's state after the 12 steps, every rank of the
# world calls trainer.resize with its old group, and each new membership
# takes AXIS_ELASTIC_STEPS steps (one round) on its own global batches.
# D-Adam tau=2 (the stacked churn path): K 8 -> 6 by clone (ranks 6 and 7
# leave), then 6 -> 8 by the mean (they join again); CD-Adam 8 -> 6 by
# clone, from hats at zero. Per member and membership: fused_adam on each
# step, CD-Adam's round one consensus_mix and one sign_compress_stacked;
# a rank outside a membership launches nothing. Every member's buffers
# right after each resize and after each step are held equal to the bit
# to its rows of the same run stacked on the card (its loss worker by
# worker), by two exact int64 sums of their bit patterns (bit_sums)
AXIS_ELASTIC = {"d-adam-straggler": ((6, "clone"), (8, "mean")),
                "cd-adam": ((6, "clone"),)}
AXIS_ELASTIC_STEPS = 4
AXIS_ELASTIC_LAUNCHES = {
    "d-adam-straggler": {"fused_adam": AXIS_ELASTIC_STEPS},
    "cd-adam": {"fused_adam": AXIS_ELASTIC_STEPS, "consensus_mix": 1,
                "sign_compress_stacked": 1}}
BUFS = ("buf", "m", "v")
# train_online under comm='axis' on the world of 8: packed D-Adam from the
# axis phase's init over its 12 batches, the consensus mean published
# every 4 steps (versions 1-3 at steps 4, 8, 12), then worker
# AXIS_ONLINE_WORKER's replica; every published tree equal to the bit on
# every rank and to the stacked run's publish_params (its loss worker by
# worker). fused_adam on every step of every rank
AXIS_ONLINE_EVERY, AXIS_ONLINE_WORKER = 4, 5
AXIS_ONLINE_LAUNCHES = {"fused_adam": AXIS_STEPS}
# comm='axis' with the 2D worker x model layout on the one card: K=4
# workers of M=2 ranks each (8 ranks in a gloo group, host-staged), the
# paper's experiment at full width through the trainer's packed mode
# (DeepFM has no sharded spelling in the JAX registry): each step
# all-gathers the worker's 2 blocks once over its model group. p=4, 12 fit
# steps a path, as the axis phase. Per rank: fused_adam on every step;
# CD-Adam's 3 rounds one consensus_mix and one sign_compress_stacked with
# reduce_axis each, which is two launches of the kernel; the mixes are f32
# torch ops, as under the 1D layout.
AXIS2D_K, AXIS2D_M = 4, 2
AXIS2D_PATHS = {
    "d-adam": dict(kind="d-adam", opt={}, launches={"fused_adam": 12}),
    "cd-adam": dict(kind="cd-adam", opt=CD_ADAM, launches={
        "fused_adam": 12, "consensus_mix": 3,
        "sign_compress_stacked_reduce": 6}),
    "d-adam-adadamp": dict(kind="d-adam", opt={}, damping=DAMPING,
                           launches={"fused_adam": 12}),
}
# the sharded-packed mode on the card: tests/test_grad_pipeline.py's
# sharded_mlp_loss (row_parallel_dot for the weight, full_leaf for the
# bias) at d_in 8192 x d_out 1024 (8,389,632 parameters a worker), 64
# examples a worker, 6 steps at p=2, eta 1e-3, held to the stacked run of
# mlp_loss (one worker at a time): the row-parallel product sums two
# halves where cuBLAS sums one, so D-Adam is held by step3_check's rule
# and CD-Adam, whose signs flip where those sums part, by the JAX
# package's flip budget for its sharded run (mean drift < 1e-4, < 1% of
# the elements past 1e-3, none past 0.1)
AXIS2D_MLP = dict(d_in=8192, d_out=1024, per_worker=64, steps=6, period=2)
# a rank's launches in those 6 steps: fused_adam on each, CD-Adam's 3
# rounds one consensus_mix and the reduce_axis form's 2 launches each
AXIS2D_MLP_LAUNCHES = {"d-adam": {"fused_adam": 6},
                       "cd-adam": {"fused_adam": 6, "consensus_mix": 3,
                                   "sign_compress_stacked_reduce": 6}}
# the training CLI's run at --model-parallel 2 against --model-parallel 1:
# the reduced llama3.2-1b (the CLI's default) at f32 compute, K=2 packed
# D-Adam, 4 steps; at 2 the CLI builds the arch's sharding plan, whose
# products sum in another order (at bf16 the two would part by rounding)
AXIS2D_CLI = ["--comm", "axis", "--workers", "2", "--backend", "packed",
              "--steps", "4", "--period", "2", "--log-every", "2",
              "--dist-backend", "gloo"]
# elastic membership of the 2D layout: the D-Adam path's state after its
# 12 steps at (K, M) = (4, 2) resized by clone to (2, 4) (a new row
# layout: rows / 4 a rank), 2 steps, then one mean publish; held to the
# stacked K=4 -> 2 run, its blocks repacked to (2, 4)'s layout, by
# bit_sums. fused_adam on each step of each rank
AXIS2D_ELASTIC = dict(K=2, M=4, strategy="clone", steps=2)
AXIS2D_ELASTIC_LAUNCHES = {"fused_adam": AXIS2D_ELASTIC["steps"]}
# the 2D layout's sharding plan (slice 22) at full width: llama3.2-1b
# whole (f32 params, bf16 compute) through the training CLI at --comm
# axis --workers 2 --model-parallel 2 --backend packed: 4 gloo ranks on the
# one card, each holding one (1, 4827904, 128) block and, in a step, its
# plan shard of every matrix; packed D-Adam at p=2, 4 steps (two comm
# steps, each followed by a step whose loss reads its mix), one fit call a
# step (--log-every 1). Each rank is held to a quarter of the card
# (PLAN_RANK_SHARE of the caching allocator; four of them and the four
# CUDA contexts fill the 79.18 GiB card), so a rank that outgrows its share
# fails alone instead of starving the others. The data: PLAN_BATCH
# sequences of PLAN_SEQ tokens a worker, half of lm_train's 2 x 1024: at 2
# x 1024 the naive attention's probabilities took every rank past its
# share in step 1's forward (NVIDIA H100 80GB HBM3, 700 W)
PLAN_K, PLAN_M, PLAN_PERIOD, PLAN_STEPS = 2, 2, 2, 4
PLAN_BATCH, PLAN_SEQ = 1, 1024
PLAN_RANK_SHARE = 0.24
PLAN_BLOCK = [1, 4_827_904, 128]


def plan_args() -> list:
    """The CLI's arguments of the planned run's stacked twin (lm_train's
    route, ``--comm stacked``) at PLAN_BATCH x PLAN_SEQ tokens a
    worker."""
    out = list(LM_ARGS)
    for flag, val in (("--period", PLAN_PERIOD), ("--steps", PLAN_STEPS),
                      ("--batch", PLAN_BATCH), ("--seq", PLAN_SEQ)):
        out[out.index(flag) + 1] = str(val)
    return out


PLAN_AXIS = ["--comm", "axis", "--model-parallel", str(PLAN_M),
             "--dist-backend", "gloo"]
# a rank's launches: fused_adam on every step (under axis the mixes are
# torch ops); its model sums a step: 6 L + 3 = 99 of the loss
# (train.grad.plan_model_sums) and one of each log point's consensus
PLAN_LAUNCHES = {"fused_adam": PLAN_STEPS}
PLAN_SUMS_PER_STEP = 6 * 16 + 3 + 1
# the planned products sum in another order than the stacked run's (f32
# partials added across the model group, then rounded to bf16 once): at
# bf16 compute the two runs part by rounding, as JAX's planned and
# unplanned runs do (2e-4 relative at step 1 on the reduced llama). The
# losses are held within PLAN_LOSS_RTOL of the stacked run's, ten times
# that distance: a wrong shard, a lost sum or a gradient scaled by M moves
# a loss by far more after one Adam step
PLAN_LOSS_RTOL = 2e-3
# card against CPU (b): the four dense configs reduced, and (slice 23) the
# reduced phi3.5-moe, llama4-maverick and phi-3-vision, at f32 compute,
# the planned trainer for 2 steps at p=2 on the same 4 ranks' card group
# and CPU group, from one init and one batch stream; the losses within
# LM_STEP1_TOL, the blocks by step3_check
PLAN_CARD_CPU_ARCHS = ("llama3.2-1b", "yi-6b", "starcoder2-15b",
                       "qwen1.5-32b", "phi3.5-moe-42b-a6.6b",
                       "llama4-maverick-400b-a17b", "phi-3-vision-4.2b")
PLAN_CARD_CPU_STEPS = 2
PLAN_CARD_CPU_LAUNCHES = {"fused_adam": PLAN_CARD_CPU_STEPS}
# the invariant gates of analysis.check's planned 2D configs, on the card
PLAN_GATES = ("axis2d-plan", "axis2d-plan-moe")
# the sharding plan for the MoE and vision-language families (slice 23),
# at full width on the same 4 gloo ranks of the one card (K=2 x M=2, each
# rank held to PLAN_RANK_SHARE), PLAN_BATCH x PLAN_SEQ text tokens a
# worker, packed D-Adam at p=2 for PLAN_FAMILY_STEPS steps (local, comm,
# local: step 3's loss reads the comm step's reverse redistribution, Adam
# update and mix; one fit call a step), through the library path: the
# config's depth and param dtype are cut in the config, for which neither
# CLI has a flag. phi3.5-moe at 1 of 32 layers with bf16 params and the
# config's bf16 moments: its router is an f32 leaf, so the packed buffer
# is f32 (the widest leaf dtype, as in JAX), 18.89 GB a rank at the peak;
# f32 params and moments would need ~25 GB (~32 B a block element, as the
# dense plan measured).
# phi-3-vision at PLAN_VLM_LAYERS of 32 layers with f32 params (576 patch
# positions before the text): at 9 layers a rank reserves 19.74 GB at its
# peak of the 20.4 GB share (NVIDIA H100 80GB HBM3, 700 W); a layer adds
# 113.2 M params a worker, 56.6 M a rank's block, ~1.8 GB at ~32 B a
# block element, so a tenth does not fit. Each family's plan sums a step:
# plan_model_sums + the log point's one; block: one rank's (1, rows / 2,
# 128); each held to its stacked twin (the same config, params and
# batches, K=2 on the card) within PLAN_LOSS_RTOL
PLAN_FAMILY_STEPS = 3
PLAN_VLM_LAYERS = 9
PLAN_FAMILIES = {
    "moe": dict(arch="phi3.5-moe-42b-a6.6b", n_layers=1,
                param_dtype=torch.bfloat16, block=[1, 6_106_112, 128],
                dtypes=["torch.float32", "torch.bfloat16", "torch.bfloat16"],
                sums=9 * 1 + 3 + 1),
    "vlm": dict(arch="phi-3-vision-4.2b", n_layers=PLAN_VLM_LAYERS,
                param_dtype=torch.float32, block=[1, 4_763_904, 128],
                dtypes=["torch.float32"] * 3,
                sums=6 * PLAN_VLM_LAYERS + 4 + 1),
}
PLAN_FAMILY_LAUNCHES = {"fused_adam": PLAN_FAMILY_STEPS}
# the stacked twin's launches: fused_adam on the local steps,
# gossip_adam_mix on the comm steps
PLAN_TWIN_LAUNCHES = {
    "fused_adam": PLAN_FAMILY_STEPS - PLAN_FAMILY_STEPS // PLAN_PERIOD,
    "gossip_adam_mix": PLAN_FAMILY_STEPS // PLAN_PERIOD}


def emit(obj) -> None:
    """One JSON line; a phase's record also gets the seconds since the
    script started (``elapsed_s``), the run's timeline."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = HOST_CALLS) -> tuple[float, float]:
    """Wall µs a call over ``calls`` back-to-back calls of ``fn``, the
    card synchronised before and after: at HOST_N elements the launch
    path's host time, which a short kernel's events include. The host's
    speed wanders with its load, even within one process, so
    HOST_BATCHES batches run after warm-up: (their median, their
    least)."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times), min(times)


def fused_adam_library_call(p, g, m, v, hp, step):
    """``torch._fused_adam_`` in place on lists of p, g, m and v: the
    update of ``fused_adam`` (weight decay as L2 on g, tau as eps) once
    its bias corrections are 1, which a step of 1e7 gives."""
    steps = [step] * len(p)
    return lambda: torch._fused_adam_(
        p, g, m, v, [], steps, lr=hp["eta"], beta1=hp["beta1"],
        beta2=hp["beta2"], weight_decay=hp["weight_decay"], eps=hp["tau"],
        amsgrad=False, maximize=False)


def fused_adam_host(fa, hp, moments=torch.float32, library=True):
    """``host_us`` of ``fa.fused_adam`` and (f32 moments) of
    ``torch._fused_adam_`` at HOST_N elements."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    p, g, m, v = (torch.rand(HOST_N, generator=gen, device="cuda") * 0.01
                  for _ in range(4))
    m, v = m.to(moments), v.to(moments)
    out = {"host_n": HOST_N}
    out["host_us"], out["host_us_min"] = host_us(
        lambda: fa.fused_adam(p, g, m, v, **hp))
    if library:
        out["library_host_us"], out["library_host_us_min"] = host_us(
            fused_adam_library_call([p], [g], [m], [v], hp,
                                    torch.tensor(1e7, device="cuda")))
    return out


def compare(got, want, tol, what: str):
    """Max abs and rel error of ``got`` against ``want``; raises past
    ``|got - want| <= atol + rtol * |want|``."""
    max_abs = max_rel = 0.0
    for a, b in zip(got, want):
        d = (a.double() - b.double()).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / b.double().abs().clamp_min(
            1e-30)).max()))
        bad = int((d > tol["atol"] + tol["rtol"] * b.double().abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} elements outside {tol}; "
                                 f"max abs err {max_abs:.3g}")
    return max_abs, max_rel


def compare_compressed(got, want, what: str):
    """q equal, scales within SCALE_RTOL, hat within KERNEL_TOL plus the
    scale error. Returns the max abs error over the three and the scales'
    max rel error (a hat element that is 0 in one version and a rounding
    of 0 in the other has no meaningful relative error)."""
    q, scale, hat = got
    if not torch.equal(q, want[0]):
        raise AssertionError(f"{what}: q differs in "
                             f"{int((q != want[0]).sum())} elements")
    errs = [compare([scale], [want[1]], dict(rtol=SCALE_RTOL, atol=0.0),
                    f"{what} scale")]
    slack = float(want[1].abs().max()) * SCALE_RTOL
    errs.append(compare([hat], [want[2]],
                        dict(rtol=KERNEL_TOL["rtol"],
                             atol=KERNEL_TOL["atol"] + slack), f"{what} hat"))
    return max(e[0] for e in errs), errs[0][1]


def check_bitwise_repeat(got, kernel, what: str) -> None:
    """A second call of ``kernel`` on the same inputs must give ``got``
    to the bit (the sign_compress scales are summed in a fixed order and
    its counters zeroed at every call)."""
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: a second call differs from the "
                             f"first")


def launches_per_call(c: dict, ops) -> int:
    """The launches one call of ``c["kernel"]`` adds to its wrapper's
    count, measured; it must be the record's ``per_call``."""
    before = ops.launch_counts()[c["name"]]
    c["kernel"]()
    torch.cuda.synchronize()
    got = ops.launch_counts()[c["name"]] - before
    if got != c["per_call"]:
        raise AssertionError(f"{c['name']}: {got} launches a call, not "
                             f"{c['per_call']}")
    return got


def sign_extra(elements: int, per_call: int,
               no_reuse: int = SIGN_NO_REUSE_BYTES) -> dict:
    """The sign_compress record's two-pass figure (18 bytes an element in
    f32, 10 in bf16) beside its one-pass bound, and its launch and
    equality checks."""
    return {"bytes_no_reuse": no_reuse * elements,
            "no_reuse_ms": no_reuse * elements / MEM_RATE * 1e3,
            "launches_per_call": per_call, "second_call_bit_equal": True}


def check_hat_at_scales(got, hat, bounds, what: str) -> None:
    """A bf16 (or f32) hat equal to the bit to ``hat + scale * q`` at the
    kernel's own scales, rounded once to hat's dtype; ``bounds`` are the
    segments' element ranges in a worker, the scales ``(K, L)``, ``(K,)``
    or ``()``."""
    q, scale, hat_new = got
    kw = q.shape[0] if q.dim() > 1 else 1
    sc = scale.reshape(kw, -1)
    lengths = torch.tensor([b - a for a, b in bounds], device=q.device)
    scale_el = torch.repeat_interleave(sc, lengths, dim=1,
                                       output_size=q.numel() // kw)
    want = (hat.reshape(kw, -1).to(torch.float32)
            + scale_el * q.reshape(kw, -1).to(torch.float32)).to(hat.dtype)
    bad = int((hat_new.reshape(kw, -1) != want).sum())
    if bad:
        raise AssertionError(f"{what}: hat differs from hat + scale * q at "
                             f"the kernel's scales in {bad} elements")


def compare_compressed_bf16(got, want, hat, bounds, what: str):
    """bf16 sign records: q equal, the f32 scales within SCALE_RTOL, hat
    bf16 and held by ``check_hat_at_scales``. Returns hat's max abs
    distance from the plain version's (a rounding of the scales' sums may
    move a bf16 hat by one ulp) and the scales' max rel error."""
    q, scale, hat_new = got
    if not torch.equal(q, want[0]):
        raise AssertionError(f"{what}: q differs in "
                             f"{int((q != want[0]).sum())} elements")
    if hat_new.dtype != hat.dtype:
        raise AssertionError(f"{what}: hat {hat_new.dtype}, not {hat.dtype}")
    rel = compare([scale], [want[1]], dict(rtol=SCALE_RTOL, atol=0.0),
                  f"{what} scale")[1]
    check_hat_at_scales(got, hat, bounds, what)
    return float((hat_new.float() - want[2].float()).abs().max()), rel


def compare_bf16_moments(got, want, what: str):
    """p within BF16_MOMENT_P_TOL, bf16 m and v within one bf16 ulp (the
    bits read as integers; both round one f32 value to nearest-even).
    Returns the max abs error over the three and p's max rel error."""
    max_abs, max_rel = compare(got[:1], want[:1], BF16_MOMENT_P_TOL,
                               f"{what} p")
    for name, a, b in zip("mv", got[1:], want[1:]):
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            raise AssertionError(f"{what} {name}: {a.dtype} / {b.dtype}")
        ulps = int((a.view(torch.int16).int() - b.view(torch.int16).int())
                   .abs().max())
        if ulps > 1:
            raise AssertionError(f"{what} {name}: {ulps} bf16 ulps apart")
        max_abs = max(max_abs, float((a.float() - b.float()).abs().max()))
    return max_abs, max_rel


def full_width_spec():
    """The resident layout of full-width DeepFM over K workers (shapes
    only: the stacked tree is made on the meta device)."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import pack as packing
    from repro_torch.models.deepfm import init_deepfm

    one = init_deepfm(torch.Generator().manual_seed(0),
                      FULL["n_fields"] * FULL["features_per_field"],
                      FULL["n_fields"], FULL["embed_dim"], FULL["hidden"])
    stacked = tree_map(lambda x: torch.empty((K,) + tuple(x.shape),
                                             device="meta"), one)
    spec = packing.make_spec(stacked, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True)
    if spec.buf_shape() != SHAPE or spec.n != PARAMS:
        raise AssertionError(f"layout {spec.buf_shape()}, {spec.n} params")
    return spec


def block_mask(spec, m: int):
    """True on the elements of shard block ``m`` of the row-sharded layout
    ``spec`` that hold a parameter; shaped ``(1, local_rows, 128)``."""
    from repro_torch.kernels import pack as packing

    true = torch.zeros(spec.local_rows * 128, dtype=torch.bool,
                       device="cuda")
    for o, c, sz in zip(spec.offsets, packing.local_chunk_elems(spec),
                        spec.sizes):
        true[o:o + max(0, min(c, sz - m * c))] = True
    return true.reshape(1, spec.local_rows, 128)


def resident_mask(spec):
    """True on the elements of the resident layout ``spec`` that hold a
    parameter, False on its padding; shaped to broadcast over workers."""
    true = torch.zeros(spec.padded, dtype=torch.bool, device="cuda")
    for o, sz in zip(spec.offsets, spec.sizes):
        true[o:o + sz] = True
    return true.reshape(1, *spec.buf_shape()[1:])


def lm_cd_layout():
    """The resident layout of lm_train_cd's state: llama3.2-1b at full
    width cut to LM_CD_LAYERS layers, LM_K workers, leaf-aligned (one
    worker's params are drawn on the card for their shapes and freed)."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.kernels import pack as packing
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                              n_layers=LM_CD_LAYERS)
    one = build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0))
    stacked = tree_map(lambda x: torch.empty((LM_K,) + tuple(x.shape),
                                             device="meta"), one)
    del one
    torch.cuda.empty_cache()
    return packing.make_spec(stacked, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True)


def phase_env():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, smi


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: the name is the one
    "<length><name>" that ends in ``_kernel``, then each of its template
    args ("I...E"): f32 (``f``), bf16 (``13__nv_bfloat16``, or a
    substitution ``S..._``, which in these kernels can only repeat it), or
    an int (``Li<n>E``, the head dim)."""
    for at in range(len(mangled)):
        digits = re.match(r"\d+", mangled[at:])
        if not digits:
            continue
        start = at + digits.end()
        name = mangled[start:start + int(digits.group())]
        if not re.fullmatch(r"[a-z_][a-z0-9_]*_kernel", name):
            continue
        rest = mangled[start + len(name):]
        if not rest.startswith("I"):
            return name
        args, i = [], 1
        while i < len(rest) and rest[i] != "E":
            if rest.startswith("Li", i):
                j = rest.index("E", i)
                args.append(rest[i + 2:j])
            elif rest[i] == "S":
                j = rest.index("_", i)
                args.append("bf16")
            elif rest[i].isdigit():
                d = re.match(r"\d+", rest[i:]).group()
                j = i + len(d) + int(d) - 1
                args.append("bf16" if "bfloat16" in rest[i:j + 1] else "?")
            else:
                j = i
                args.append("f32" if rest[i] == "f" else "?")
            i = j + 1
        return f"{name}<{','.join(args)}>"
    return "?"


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    # ptxas names each entry function (mangled: "<length><name>_kernel",
    # then "I<template args>E" for a template) before its resource line
    regs = {}
    for name, lib in libs.items():
        log = (lib.parent / f"lib{name}.log").read_text()
        entry = "?"
        for ln in log.splitlines():
            found = re.search(r"entry function '(\w+)'", ln)
            if found:
                entry = kernel_label(found.group(1))
            elif "Used" in ln:
                regs[f"{name}:{entry}"] = ln.split("ptxas info    : ")[-1]
    sign = sorted(k for k in regs if k.startswith("sign_compress:"))
    if sign != ["sign_compress:sign_compress_kernel<bf16>",
                "sign_compress:sign_compress_kernel<f32>"]:
        raise AssertionError(f"the sign_compress library holds {sign}")
    emit({"phase": "build", "seconds": round(seconds, 3),
          "libs": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": regs})


def phase_kernels():
    """Each kernel against its plain version on the card at the main
    path's shape; returns the kernel records without launch counts."""
    from repro_torch.core.schedule import one_peer_exponential
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import gossip as gk
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(SHAPE, generator=gen, device="cuda")
    g = torch.randn(SHAPE, generator=gen, device="cuda") * 0.1
    m = torch.randn(SHAPE, generator=gen, device="cuda") * 0.01
    v = torch.rand(SHAPE, generator=gen, device="cuda") * 0.01
    # CD-Adam's operands: x, hat_self and the ring's two neighbour copies,
    # zero in the layout's padding as on the main path
    spec = full_width_spec()
    ranges = packing.leaf_row_ranges(spec)
    true = resident_mask(spec)
    x, hs, hn1, hn2 = (torch.randn(SHAPE, generator=gen, device="cuda")
                       * true for _ in range(4))
    xs = torch.randn(PARAMS, generator=gen, device="cuda")
    hs1 = torch.randn(PARAMS, generator=gen, device="cuda")
    topo = make_topology("ring", K)
    mix = (topo.offsets, topo.offset_weights, topo.self_weight)
    # the one-peer-exponential union at K=8 (offsets 1, 7, 2, 6, 4), its
    # first round's view
    union = one_peer_exponential(K).union_views()[0]
    deg = len(topo.offsets)
    adam = ADAM
    adam_wd = dict(ADAM, weight_decay=VISION["weight_decay"])
    W = torch.as_tensor(topo.weights, dtype=torch.float32, device="cuda")
    buf_bytes = p.numel() * p.element_size()
    n = p.numel()
    # torch._fused_adam_ computes the same update (weight decay as L2 on
    # g, as the TPU kernel adds wd * p to g; with tau as eps) once its bias
    # corrections are 1: a step of 1e7 rounds 1 - beta^step to 1. It
    # updates in place, so it runs on copies of p, m and v, one set for
    # each hyperparameter set; the first call is held to the plain
    # version, the later ones (the timing) step the copies on.
    lib_step = torch.tensor(1e7, device="cuda")

    def fused_adam_library(hp, p=p, g=g, m=m, v=v):
        lib = (p.clone(), m.clone(), v.clone())
        step = fused_adam_library_call([lib[0]], [g], [lib[1]], [lib[2]],
                                       hp, lib_step)

        def call():
            step()
            return lib

        err = compare(call(), fa.fused_adam_plain(p, g, m, v, **hp),
                      KERNEL_TOL, "torch._fused_adam_ against "
                      f"fused_adam_plain, weight decay {hp['weight_decay']}"
                      )[0]
        return call, err

    fused_adam_lib, fused_adam_library_err = fused_adam_library(adam)
    fused_adam_lib_wd, fused_adam_library_err_wd = fused_adam_library(
        adam_wd)
    # comm='axis': one rank's (1, 89344, 128) shard, the K = 1 launches of
    # the axis phase
    p1, g1, m1, v1, x1, hs_1, hn1_1, hn2_1 = (
        t[:1] for t in (p, g, m, v, x, hs, hn1, hn2))
    n1 = p1.numel()
    fused_adam_lib_1, fused_adam_library_err_1 = fused_adam_library(
        adam, p1, g1, m1, v1)
    axis_variant = "K = 1: one rank's comm='axis' shard"
    # the 2D layout: one rank's (1, rows/2, 128) block of DeepFM's
    # row-sharded layout at M = 2 (the axis2d phase's), zero in its
    # padding; sign_compress_stacked with reduce_axis divides by the
    # leaves' global true counts, and a stand-in for the model group's sum
    # (two equal shards: the sums doubled) runs between its two launches
    spec2 = axis2d_spec(full_width_spec(), AXIS2D_M)
    ranges2 = packing.leaf_row_ranges(spec2)
    x2, hs2 = (torch.randn((1,) + spec2.block_shape()[1:], generator=gen,
                           device="cuda") * block_mask(spec2, 0)
               for _ in range(2))
    n2 = x2.numel()

    def two_shards(sums):
        return sums + sums
    # bf16 moments (make_optimizer(moment_dtype=torch.bfloat16)): p and g
    # f32, m and v bf16; 20 bytes an element
    mb, vb = m.to(torch.bfloat16), v.to(torch.bfloat16)
    # bf16 parameter buffers (a model's param_dtype=bfloat16): p, g, the
    # payloads, x and the hats bf16, the moments f32 or bf16 (the packed
    # default at bf16 params: bf16); 3 bytes of p's dtype and 4 of the
    # moments' an element for the Adam kernels
    bf = torch.bfloat16
    pb, gb, xb, hsb, hn1b, hn2b, xsb, hs1b, x2b, hs2b = (
        t.to(bf) for t in (p, g, x, hs, hn1, hn2, xs, hs1, x2, hs2))
    grid_b = {t: fa.grid_blocks(p.device, t, bf) for t in fa.MOMENT_DTYPES}
    leaf_bounds = tuple((a * 128, b * 128) for a, b in ranges)
    leaf_bounds2 = tuple((a * 128, b * 128) for a, b in ranges2)
    # torch._fused_adam_ on all-bf16 p, g, m, v (one dtype for its lists),
    # on copies; its first call is held to the plain version within
    # BF16_LIBRARY_TOL, and where it lies farther it is no yardstick
    lib_b = (pb.clone(), mb.clone(), vb.clone())
    lib_b_step = fused_adam_library_call([lib_b[0]], [gb], [lib_b[1]],
                                         [lib_b[2]], adam, lib_step)

    def fused_adam_lib_b():
        lib_b_step()
        return lib_b

    lib_b_pairs = list(zip(fused_adam_lib_b(),
                           fa.fused_adam_plain(pb, gb, mb, vb, **adam)))
    lib_b_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in lib_b_pairs)
    lib_b_bad = sum(int((~torch.isclose(a.float(), b.float(),
                                        **BF16_LIBRARY_TOL)).sum())
                    for a, b in lib_b_pairs)
    del lib_b_pairs
    # fused_adam: the plain version to the bit (the same f32 operations in
    # the same order, bf16 rounded once to nearest-even in both), a second
    # call equal to the first, the library call's device time beside the
    # kernel's, the launch paths' host_us, and the persistent grid
    f32_host = fused_adam_host(fa, adam)
    grid = {t: fa.grid_blocks(p.device, t) for t in fa.MOMENT_DTYPES}
    # f32 operations per element: Adam half-step 12 (3 for m, 4 for v, 4
    # for the step incl. sqrt and division, 1 for p); mix 1 + 2 per offset
    cases = [
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, m, v, **adam),
             plain=lambda: fa.fused_adam_plain(p, g, m, v, **adam),
             tol=BIT_EQUAL, repeat=True, extra=dict(
                 f32_host, grid_blocks=grid[torch.float32]),
             library=fused_adam_lib, library_device=True,
             library_desc="torch._fused_adam_ (state_steps 1e7: bias "
                          "corrections 1; checked against the plain "
                          "version within KERNEL_TOL)",
             library_err=fused_adam_library_err,
             bytes=7 * buf_bytes, ops=12 * n, device="fused_adam_kernel"),
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, mb, vb, **adam),
             plain=lambda: fa.fused_adam_plain(p, g, mb, vb, **adam),
             tol=BIT_EQUAL, repeat=True, extra=dict(
                 fused_adam_host(fa, adam, torch.bfloat16, library=False),
                 grid_blocks=grid[torch.bfloat16]),
             library=None, bytes=20 * n, ops=12 * n,
             device="fused_adam_kernel", variant="bf16 m and v"),
        # ResNet-20's weight decay (the paper's CIFAR setting): the
        # kernels' weight-decay operand, off on every other path
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, m, v, **adam_wd),
             plain=lambda: fa.fused_adam_plain(p, g, m, v, **adam_wd),
             tol=BIT_EQUAL, repeat=True, extra=dict(
                 fused_adam_host(fa, adam_wd),
                 grid_blocks=grid[torch.float32]),
             library=fused_adam_lib_wd, library_device=True,
             library_desc="torch._fused_adam_(weight_decay=1e-4) (state_"
                          "steps 1e7; checked against the plain version "
                          "within KERNEL_TOL)",
             library_err=fused_adam_library_err_wd,
             bytes=7 * buf_bytes, ops=14 * n,
             device="fused_adam_kernel", variant="weight decay 1e-4"),
        dict(name="gossip_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:124",
             kernel=lambda: (gk.gossip_mix(p, *mix),),
             plain=lambda: (gk.gossip_mix_plain(p, *mix),),
             library=lambda: torch.einsum("kj,jrc->krc", W, p),
             library_desc="torch.einsum('kj,jrc->krc', W, x)",
             bytes=2 * buf_bytes, ops=(1 + 2 * deg) * n,
             device="gossip_mix_kernel"),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(p, g, m, v, *mix, **adam),
             plain=lambda: gk.gossip_adam_mix_plain(p, g, m, v, *mix,
                                                    **adam),
             tol=BIT_EQUAL, library=None, bytes=7 * buf_bytes,
             ops=((deg + 1) * 12 + 1 + 2 * deg) * n,
             device="gossip_adam_mix_kernel"),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(p, g, mb, vb, *mix, **adam),
             plain=lambda: gk.gossip_adam_mix_plain(p, g, mb, vb, *mix,
                                                    **adam),
             bf16_moments=True, library=None, bytes=20 * n,
             ops=((deg + 1) * 12 + 1 + 2 * deg) * n,
             device="gossip_adam_mix_kernel", variant="bf16 m and v"),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(p, g, m, v, *mix, **adam_wd),
             plain=lambda: gk.gossip_adam_mix_plain(p, g, m, v, *mix,
                                                    **adam_wd),
             tol=BIT_EQUAL, library=None, bytes=7 * buf_bytes,
             ops=((deg + 1) * 14 + 1 + 2 * deg) * n,
             device="gossip_adam_mix_kernel", variant="weight decay 1e-4"),
        # consensus: per offset a subtraction, a product and a sum, then
        # gamma's product and the sum with x
        dict(name="consensus_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:307",
             kernel=lambda: (gk.consensus_mix(x, hs, (hn1, hn2),
                                              topo.offset_weights, GAMMA),),
             plain=lambda: (gk.consensus_mix_plain(
                 x, hs, (hn1, hn2), topo.offset_weights, GAMMA),),
             tol=BIT_EQUAL, library=None, bytes=(3 + deg) * buf_bytes,
             ops=(2 + 3 * deg) * n, device="consensus_mix_kernel"),
        # sign compress: read x and hat, write hat and the int8 q (13 bytes
        # an element); d, |d|, the sum, sign (two compares and a
        # subtraction), scale * sign and the sum with hat. One launch a
        # call, and a second call equal to the first to the bit.
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(
                 x, hs, n_true=spec.sizes, row_ranges=ranges),
             plain=lambda: sc.sign_compress_stacked_plain(
                 x, hs, n_true=spec.sizes, row_ranges=ranges),
             compressed=True, library=None, bytes=13 * n, ops=8 * n,
             device=SIGN_KERNELS, per_call=1, elements=n,
             variant="scales='leaf': DeepFM's 11 leaf segments, (K, 11) "
                     "scales"),
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(x, hs, n_true=spec.n),
             plain=lambda: sc.sign_compress_stacked_plain(x, hs,
                                                          n_true=spec.n),
             compressed=True, library=None, bytes=13 * n, ops=8 * n,
             device=SIGN_KERNELS, per_call=1, elements=n,
             variant="scales='worker': one segment, (K,) scales"),
        dict(name="sign_compress_stacked_reduce",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174, 192 "
                      "(reduce_axis, :187-188)",
             kernel=lambda: sc.sign_compress_stacked(
                 x2, hs2, n_true=spec2.sizes, row_ranges=ranges2,
                 reduce_axis=two_shards),
             plain=lambda: sc.sign_compress_stacked_plain(
                 x2, hs2, n_true=spec2.sizes, row_ranges=ranges2,
                 reduce_axis=two_shards),
             compressed=True, same_scale_hat=(hs2, leaf_bounds2),
             library=None,
             bytes=13 * n2, ops=8 * n2, device=SIGN_KERNELS, per_call=2,
             elements=n2,
             variant="reduce_axis (the 2D layout): one rank's "
                     f"{tuple(x2.shape)} block at M = "
                     f"{AXIS2D_M}, DeepFM's 11 leaf segments; two launches "
                     "a call, the first's sums summed (here doubled) "
                     "between them"),
        dict(name="sign_compress",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:65",
             kernel=lambda: sc.sign_compress(xs, hs1),
             plain=lambda: sc.sign_compress_plain(xs, hs1),
             compressed=True, library=None, bytes=13 * PARAMS,
             ops=8 * PARAMS, device=SIGN_KERNELS, per_call=1,
             elements=PARAMS,
             variant="one worker's 11,202,602 elements, flat"),
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p1, g1, m1, v1, **adam),
             plain=lambda: fa.fused_adam_plain(p1, g1, m1, v1, **adam),
             tol=BIT_EQUAL, repeat=True, extra=dict(
                 f32_host, grid_blocks=grid[torch.float32]),
             library=fused_adam_lib_1, library_device=True,
             library_desc="torch._fused_adam_ (state_steps 1e7; checked "
                          "against the plain version within KERNEL_TOL)",
             library_err=fused_adam_library_err_1,
             bytes=7 * 4 * n1, ops=12 * n1, device="fused_adam_kernel",
             variant=axis_variant),
        dict(name="consensus_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:307",
             kernel=lambda: (gk.consensus_mix(x1, hs_1, (hn1_1, hn2_1),
                                              topo.offset_weights, GAMMA),),
             plain=lambda: (gk.consensus_mix_plain(
                 x1, hs_1, (hn1_1, hn2_1), topo.offset_weights, GAMMA),),
             tol=BIT_EQUAL, library=None, bytes=(3 + deg) * 4 * n1,
             ops=(2 + 3 * deg) * n1, device="consensus_mix_kernel",
             variant=axis_variant),
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(
                 x1, hs_1, n_true=spec.sizes, row_ranges=ranges),
             plain=lambda: sc.sign_compress_stacked_plain(
                 x1, hs_1, n_true=spec.sizes, row_ranges=ranges),
             compressed=True, library=None, bytes=13 * n1, ops=8 * n1,
             device=SIGN_KERNELS, per_call=1, elements=n1,
             variant=axis_variant + ", DeepFM's 11 leaf segments"),
        # payload mix: read x and each payload, write out; per element a
        # product, then a product and a sum per payload
        dict(name="payload_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:161",
             kernel=lambda: (gk.payload_mix(p, (g, m), topo.offset_weights,
                                            topo.self_weight),),
             plain=lambda: (gk.payload_mix_plain(
                 p, (g, m), topo.offset_weights, topo.self_weight),),
             tol=BIT_EQUAL, library=None, bytes=(2 + deg) * buf_bytes,
             ops=(1 + 2 * deg) * n, library_note=NO_STACKED_SUM,
             device="payload_mix_kernel", variant="ring: 2 payloads"),
        dict(name="payload_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:161",
             kernel=lambda: (gk.payload_mix(p, (g, m, v, hn1, hn2),
                                            union.offset_weights,
                                            union.self_weight),),
             plain=lambda: (gk.payload_mix_plain(
                 p, (g, m, v, hn1, hn2), union.offset_weights,
                 union.self_weight),),
             tol=BIT_EQUAL, library=None, bytes=7 * buf_bytes,
             ops=(1 + 2 * 5) * n, library_note=NO_STACKED_SUM,
             device="payload_mix_kernel",
             variant="one-peer-exponential union: 5 payloads"),
        # bf16 parameter buffers: every form to the bit but the sign
        # records' hats (compare_compressed_bf16)
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(pb, gb, mb, vb, **adam),
             plain=lambda: fa.fused_adam_plain(pb, gb, mb, vb, **adam),
             tol=BIT_EQUAL, repeat=True, params=bf,
             extra=dict(grid_blocks=grid_b[bf],
                        library_outside_tol=lib_b_bad),
             library=fused_adam_lib_b if not lib_b_bad else None,
             library_device=not lib_b_bad,
             library_desc="torch._fused_adam_ on bf16 p, g, m, v "
                          "(state_steps 1e7; within BF16_LIBRARY_TOL of "
                          "the plain version)",
             library_note=f"none: torch._fused_adam_ on bf16 lies outside "
                          f"BF16_LIBRARY_TOL in {lib_b_bad} elements",
             library_err=lib_b_err, bytes=14 * n, ops=12 * n,
             device="fused_adam_kernel", variant="bf16 params, bf16 m and v"),
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(pb, gb, m, v, **adam),
             plain=lambda: fa.fused_adam_plain(pb, gb, m, v, **adam),
             tol=BIT_EQUAL, repeat=True, params=bf,
             extra=dict(grid_blocks=grid_b[torch.float32]), library=None,
             library_note=NO_MIXED_LIBRARY, bytes=22 * n, ops=12 * n,
             device="fused_adam_kernel", variant="bf16 params, f32 m and v"),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(pb, gb, mb, vb, *mix, **adam),
             plain=lambda: gk.gossip_adam_mix_plain(pb, gb, mb, vb, *mix,
                                                    **adam),
             tol=BIT_EQUAL, params=bf, library=None, bytes=14 * n,
             ops=((deg + 1) * 12 + 1 + 2 * deg) * n,
             device="gossip_adam_mix_kernel",
             variant="bf16 params, bf16 m and v"),
        dict(name="gossip_adam_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:258",
             kernel=lambda: gk.gossip_adam_mix(pb, gb, m, v, *mix, **adam),
             plain=lambda: gk.gossip_adam_mix_plain(pb, gb, m, v, *mix,
                                                    **adam),
             tol=BIT_EQUAL, params=bf, library=None, bytes=22 * n,
             ops=((deg + 1) * 12 + 1 + 2 * deg) * n,
             device="gossip_adam_mix_kernel",
             variant="bf16 params, f32 m and v"),
        dict(name="gossip_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:124",
             kernel=lambda: (gk.gossip_mix(pb, *mix),),
             plain=lambda: (gk.gossip_mix_plain(pb, *mix),),
             tol=BIT_EQUAL, params=bf, library=None,
             library_note=NO_BF16_EINSUM, bytes=4 * n,
             ops=(1 + 2 * deg) * n, device="gossip_mix_kernel",
             variant="bf16 buffer"),
        dict(name="consensus_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:307",
             kernel=lambda: (gk.consensus_mix(xb, hsb, (hn1b, hn2b),
                                              topo.offset_weights, GAMMA),),
             plain=lambda: (gk.consensus_mix_plain(
                 xb, hsb, (hn1b, hn2b), topo.offset_weights, GAMMA),),
             tol=BIT_EQUAL, params=bf, library=None,
             bytes=(3 + deg) * 2 * n, ops=(2 + 3 * deg) * n,
             device="consensus_mix_kernel", variant="bf16 buffers"),
        dict(name="payload_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:161",
             kernel=lambda: (gk.payload_mix(pb, (gb, xb),
                                            topo.offset_weights,
                                            topo.self_weight),),
             plain=lambda: (gk.payload_mix_plain(
                 pb, (gb, xb), topo.offset_weights, topo.self_weight),),
             tol=BIT_EQUAL, params=bf, library=None,
             bytes=(2 + deg) * 2 * n, ops=(1 + 2 * deg) * n,
             library_note=NO_STACKED_SUM, device="payload_mix_kernel",
             variant="bf16 buffers, ring: 2 payloads"),
        dict(name="payload_mix", source="src/repro_torch/csrc/gossip.cu",
             replaces="src/repro/kernels/gossip.py:161",
             kernel=lambda: (gk.payload_mix(pb, (gb, xb, hsb, hn1b, hn2b),
                                            union.offset_weights,
                                            union.self_weight),),
             plain=lambda: (gk.payload_mix_plain(
                 pb, (gb, xb, hsb, hn1b, hn2b), union.offset_weights,
                 union.self_weight),),
             tol=BIT_EQUAL, params=bf, library=None, bytes=7 * 2 * n,
             ops=(1 + 2 * 5) * n, library_note=NO_STACKED_SUM,
             device="payload_mix_kernel",
             variant="bf16 buffers, one-peer-exponential union: 5 "
                     "payloads"),
        dict(name="sign_compress_stacked",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174",
             kernel=lambda: sc.sign_compress_stacked(
                 xb, hsb, n_true=spec.sizes, row_ranges=ranges),
             plain=lambda: sc.sign_compress_stacked_plain(
                 xb, hsb, n_true=spec.sizes, row_ranges=ranges),
             compressed_bf16=(hsb, leaf_bounds), params=bf, library=None,
             bytes=7 * n, ops=8 * n, device=SIGN_KERNELS, per_call=1,
             elements=n,
             variant="bf16 x and hat, scales='leaf': DeepFM's 11 leaf "
                     "segments"),
        dict(name="sign_compress_stacked_reduce",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:174, 192 "
                      "(reduce_axis, :187-188)",
             kernel=lambda: sc.sign_compress_stacked(
                 x2b, hs2b, n_true=spec2.sizes, row_ranges=ranges2,
                 reduce_axis=two_shards),
             plain=lambda: sc.sign_compress_stacked_plain(
                 x2b, hs2b, n_true=spec2.sizes, row_ranges=ranges2,
                 reduce_axis=two_shards),
             compressed_bf16=(hs2b, leaf_bounds2), params=bf, library=None,
             bytes=7 * n2, ops=8 * n2, device=SIGN_KERNELS, per_call=2,
             elements=n2,
             variant="bf16 x and hat, reduce_axis: one rank's "
                     f"{tuple(x2.shape)} block at M = {AXIS2D_M}"),
        dict(name="sign_compress",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:65",
             kernel=lambda: sc.sign_compress(xsb, hs1b),
             plain=lambda: sc.sign_compress_plain(xsb, hs1b),
             compressed_bf16=(hs1b, ((0, PARAMS),)), params=bf,
             library=None, bytes=7 * PARAMS, ops=8 * PARAMS,
             device=SIGN_KERNELS, per_call=1, elements=PARAMS,
             variant="bf16 x and hat, one worker's 11,202,602 elements, "
                     "flat"),
    ]
    records = []
    for c in cases:
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        tol = c.get("tol", KERNEL_TOL)
        if c.get("compressed"):
            tol = {"q": "equal", "scale_rtol": SCALE_RTOL,
                   "hat": f"{KERNEL_TOL} + max scale * {SCALE_RTOL}"}
            max_abs, max_rel = compare_compressed(got, want, c["name"])
            check_bitwise_repeat(got, c["kernel"], c["name"])
            if c.get("same_scale_hat"):
                tol["hat_given_the_kernels_scales"] = "equal"
                check_hat_at_scales(got, *c["same_scale_hat"], c["name"])
        elif c.get("compressed_bf16"):
            tol = {"q": "equal", "scale_rtol": SCALE_RTOL,
                   "hat_given_the_kernels_scales": "equal"}
            max_abs, max_rel = compare_compressed_bf16(
                got, want, *c["compressed_bf16"], c["name"])
            check_bitwise_repeat(got, c["kernel"], c["name"])
        elif c.get("bf16_moments"):
            tol = {"p": BF16_MOMENT_P_TOL, "m, v": "within 1 bf16 ulp"}
            max_abs, max_rel = compare_bf16_moments(got, want, c["name"])
        else:
            max_abs, max_rel = compare(got, want, tol, c["name"])
        if c.get("repeat"):
            check_bitwise_repeat(got, c["kernel"], c["name"])
        del got, want
        ms = median_ms(c["kernel"])
        device_ms = device_kernel_ms(c["kernel"], c["device"],
                                     per_call=c.get("per_call"))
        plain_ms = median_ms(c["plain"])
        library_ms = (median_ms(c["library"])
                      if c["library"] is not None else None)
        t_bytes = c["bytes"] / MEM_RATE * 1e3
        t_ops = c["ops"] / F32_RATE * 1e3
        rec = {"name": c["name"], "route": "cuda", "source": c["source"],
               "replaces": c["replaces"], "launches": None,
               "max_abs_err": max_abs, "max_rel_err": max_rel,
               "tol": tol, "ms": ms, "kernel_ms": ms,
               "kernel_device_ms": device_ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": c["bytes"], "library_ms": library_ms,
               "library": (c["library_desc"] if c["library"] is not None
                           else c.get("library_note", NO_LIBRARY))}
        if "library_err" in c:
            rec["library_max_abs_err"] = c["library_err"]
        if c.get("library_device"):
            # every kernel the library call launches
            rec["library_device_ms"] = device_kernel_ms(c["library"], "")
        if c.get("repeat"):
            rec["second_call_bit_equal"] = True
        rec.update(c.get("extra", {}))
        if c.get("compressed") or c.get("compressed_bf16"):
            rec.update(sign_extra(
                c["elements"], launches_per_call(c, ops),
                SIGN_NO_REUSE_BYTES_BF16 if c.get("compressed_bf16")
                else SIGN_NO_REUSE_BYTES))
        if "variant" in c:
            rec["variant"] = c["variant"]
        rec["params"] = str(c.get("params", torch.float32)).split(".")[-1]
        emit({"phase": "kernel", **rec})
        records.append(rec)

    # CD-Adam's neighbour-copy update is plain torch ops on the main path
    # (no kernel of its own): shift q and the (K, 11) scales per offset,
    # spread the scales over the leaves' rows, multiply and add
    from repro_torch.core.cdadam import update_nbr_hats
    q, scales, _ = sc.sign_compress_stacked(x, hs, n_true=spec.sizes,
                                            row_ranges=ranges)
    nbr_ms = median_ms(lambda: update_nbr_hats((hn1, hn2), q, scales, topo,
                                               ranges))
    # each neighbour copy is read and written once, q read once per offset
    nbr_bytes = deg * (2 * buf_bytes + n)
    emit({"phase": "torch_ops", "name": "cdadam.update_nbr_hats",
          "ms": nbr_ms, "bound_ms": nbr_bytes / MEM_RATE * 1e3,
          "bytes": nbr_bytes, "offsets": deg})
    del p, g, m, v, mb, vb, x, hs, hn1, hn2, xs, hs1, q, scales, cases
    del p1, g1, m1, v1, x1, hs_1, hn1_1, hn2_1, x2, hs2
    del pb, gb, xb, hsb, hn1b, hn2b, xsb, hs1b, x2b, hs2b, lib_b
    del fused_adam_lib, fused_adam_lib_wd, fused_adam_lib_1
    torch.cuda.empty_cache()
    return records + flash_records() + rwkv_records()


def attention_keep(S: int, T: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """The ``(S, T)`` boolean mask of the (query, key) pairs kept."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    keep = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (k_pos <= q_pos)
    if window > 0:
        keep = keep & (q_pos - k_pos < window)
    return keep


def attention_f64(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The flash kernel's function in float64 on the operands' device, the
    yardstick of the f32 versions' rounding."""
    B, S, Hq, D = q.shape
    T, G = k.shape[1], Hq // k.shape[2]
    kk, vv = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.double(), kk) / math.sqrt(D)
    s = s.masked_fill(~attention_keep(S, T, causal, window, q.device),
                      -math.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), vv)


def sdpa_library(q, k, v, causal: bool, window: int):
    """One ``F.scaled_dot_product_attention`` call computing the flash
    kernel's function on the same ``(B, S, H, D)`` tensors (heads moved
    by a view): ``is_causal`` without a window (SDPA's causal mask is
    aligned top-left, as the kernel's), else the band as a boolean
    ``attn_mask`` made beforehand. Returns ``(call, description)``."""
    import torch.nn.functional as F

    S, T = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(enable_gqa=q.shape[2] != k.shape[2])
    if window > 0:
        kw["attn_mask"] = attention_keep(S, T, causal, window, q.device)
        desc = "attn_mask=<boolean band>"
    else:
        kw["is_causal"] = causal
        desc = f"is_causal={causal}"
    desc = (f"F.scaled_dot_product_attention({desc}, "
            f"enable_gqa={kw['enable_gqa']})")
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)), desc


def flash_records():
    """``flash_attention`` against its plain version on the card, with
    its time beside the plain version's, SDPA's (one call computing the
    same function: its distance from the plain version is recorded, not
    held) and the bound: q, k, v read and the output written once over
    the memory rate, against 4 * D operations per kept (query, key) pair
    (the two products) over the bf16 tensor-core peak, or in f32 three
    times as many over the TF32 peak."""
    from repro_torch.kernels import flash_attention as fa

    records = []
    for name, B, S, T, Hq, Hk, D, dt, causal, window in FLASH_CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, T, Hk, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, T, Hk, D), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        library, library_desc = sdpa_library(q, k, v, causal, window)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        lib_out = library().transpose(1, 2)
        torch.cuda.synchronize()
        max_abs, max_rel = compare([got.float()], [want.float()],
                                   FLASH_TOL[dt], f"flash_attention {name}")
        library_err = float((lib_out.float() - want.float()).abs().max())
        f64_err = None
        if dt == torch.float32:
            ref = attention_f64(q, k, v, causal, window)
            f64_err = {n: float((x.double() - ref).abs().max())
                       for n, x in (("kernel", got), ("plain", want))}
            del ref
            if f64_err["kernel"] > F32_FLASH_F64_RATIO * f64_err["plain"]:
                raise AssertionError(f"flash_attention {name}: {f64_err} "
                                     "from float64")
        del got, want, lib_out
        torch.cuda.empty_cache()
        ms = median_ms(lambda: fa.flash_attention(q, k, v, **kw))
        device_ms = device_kernel_ms(
            lambda: fa.flash_attention(q, k, v, **kw), FLASH_FUNCTION[dt])
        plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        torch.cuda.empty_cache()
        library_ms = median_ms(library)
        library_kernels = launched_kernels(library)
        del library
        size = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * size
        ops = flash_flops(B, S, T, Hq, D, causal, window)
        # bf16: the two products on the tensor cores; f32: each as three
        # TF32 products (3xTF32), the fastest f32-accurate product the card
        # has, so at a third of the TF32 peak
        t_ops = (ops / BF16_RATE if dt == torch.bfloat16
                 else ops / F32_3XTF32_RATE) * 1e3
        t_bytes = n_bytes / MEM_RATE * 1e3
        rec = {"name": "flash_attention", "route": "cuda",
               "design": ("wgmma" if dt == torch.bfloat16
                          else "mma.sync 3xTF32"),
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:114",
               "launches": None, "max_abs_err": max_abs,
               "max_rel_err": max_rel, "tol": FLASH_TOL[dt], "ms": ms,
               "kernel_ms": ms, "kernel_device_ms": device_ms,
               "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": n_bytes, "operations": ops,
               "library_ms": library_ms, "library": library_desc,
               "library_kernels": library_kernels,
               "library_max_abs_err": library_err,
               "f64_max_abs_err": f64_err,
               "variant": f"{name}: B={B} S={S} T={T} Hq={Hq} Hk={Hk} "
                          f"D={D} {str(dt).split('.')[-1]} causal={causal} "
                          f"window={window}"}
        if dt == torch.float32:
            # the same work on the CUDA cores at the f32 peak outside the
            # tensor cores (the bound of the earlier CUDA-core design): a note
            # only
            rec["bound_f32_cores_ms"] = max(t_bytes, ops / F32_RATE * 1e3)
        emit({"phase": "kernel", **rec})
        records.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    return records


def wkv_inputs(B, S, H, D, dt, seed=0):
    """r, k, v ~ 0.3 N in ``dt``; w f32 from the decays of a model at
    init (exp(-exp(w0 + small)), w0 = -5); u ~ 0.1 N; a state ~ 0.1 N."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def n(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    r, k, v = (n((B, S, H, D), 0.3).to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(-5.0 + n((B, S, H, D), 0.5)))
    return r, k, v, w, n((H, D), 0.1), n((B, H, D, D), 0.1)


@contextlib.contextmanager
def card_profile():
    """A profile of the CPU and the card whose window opens with
    PROFILE_PAD spin kernels, done before the caller's work starts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


# names torch's profiler leaves out of its FunctionEvent list
PROFILER_FILTERED = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))


@dataclasses.dataclass
class ProfileTables:
    """What the smoke reads from a profile: ``kernels``, name -> [device
    µs, launches] of the card's activities (kernels, copies, fills), the
    pad left out; ``torch_calls``, the top-level ``aten::`` ops by name
    (each a call from Python); ``ranges``, each ``repro_torch.`` range's
    device ms (the card time of the ops inside it) and calls."""

    kernels: dict
    torch_calls: collections.Counter
    ranges: dict


def profile_tables(prof) -> ProfileTables:
    """The sums that ``key_averages()`` and ``events()`` give, read from
    the profiler's raw kineto events: torch builds its FunctionEvent list
    at ~70 µs an event, tens of seconds for a model's period (20.6 s of
    lm_train's, against 1.8 s here, with equal sums; NVIDIA H100 80GB
    HBM3 host), to give the device time of each activity name and the CPU
    ops without a CPU parent. As torch does, a CPU op's parent is the
    innermost op on its thread that spans it, and an op whose start and
    end threads differ is async and has none. A profile that holds a
    ``repro_torch.`` range (CD-Adam's periods: a few hundred ops) takes
    the ranges from ``key_averages()``."""
    from torch.autograd import DeviceType

    kernels, threads, calls = {}, {}, collections.Counter()
    has_ranges = False
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in PROFILER_FILTERED:
            continue
        if e.device_type() == DeviceType.CUDA:
            # a range shows on the card's timeline too, as no activity
            if PAD_KERNEL in name or name.startswith("repro_torch."):
                continue
            got = kernels.setdefault(name, [0.0, 0])
            got[0] += (e.end_ns() - e.start_ns()) / 1e3
            got[1] += 1
        elif e.device_type() == DeviceType.CPU:
            has_ranges |= name.startswith("repro_torch.")
            if e.is_async() or e.start_thread_id() != e.end_thread_id():
                if name.startswith("aten::"):
                    calls[name] += 1
                continue
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), name))
    for evs in threads.values():
        evs.sort()
        ends = []       # the ends of the open ops, outermost first
        for start, neg_end, name in evs:
            while ends and (start >= ends[-1] or -neg_end > ends[-1]):
                ends.pop()
            if not ends and name.startswith("aten::"):
                calls[name] += 1
            ends.append(-neg_end)
    ranges = {}
    if has_ranges:
        for e in prof.key_averages():
            if e.key.startswith("repro_torch."):
                ranges[e.key] = {"device_ms": e.device_time_total / 1e3,
                                 "calls": e.count}
    return ProfileTables(kernels, calls, ranges)


def launched_kernels(fn) -> list:
    """The names (their first 60 characters) of the CUDA kernels one call
    of ``fn`` launched (one profile): what a library call runs."""
    with card_profile() as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({k[:60] for k in profile_tables(prof).kernels})


def check_no_old_sign_kernel(kernels: dict, what: str) -> None:
    """Raise if a profile's ``kernels`` (``ProfileTables.kernels``) hold a
    launch of one of the three kernels that the persistent sign_compress
    kernel replaced."""
    old = sorted({k[:60] for k in kernels if OLD_SIGN_KERNEL.search(k)})
    if old:
        raise AssertionError(f"{what}: the profile recorded {old}, kernels "
                             f"of the replaced sign_compress design")


def matched_device_us(kernels: dict, names) -> tuple[float, int]:
    """(device µs, calls) of the kernels of a profile's ``kernels`` whose
    name holds one of ``names``."""
    us, calls = 0.0, 0
    for k, (t, n) in kernels.items():
        if any(name in k for name in names):
            us += t
            calls += n
    return us, calls


def device_kernel_ms(fn, kernel, reps: int = REPS, attempts: int = 3,
                     per_call: int | None = None,
                     old_ok: bool = False) -> float:
    """Device time per call of ``fn`` of the CUDA kernels whose name holds
    ``kernel`` (one name, or a tuple of the names of one call's kernels),
    from a profile of ``reps`` calls: the kernels alone, where CUDA events
    around one call also count the host time before its launch. A profile
    that recorded fewer than ``reps`` such kernels, or no time for them,
    is taken again; after ``attempts`` of them this raises, so no time is
    reported that was not measured. With ``per_call``, a profile that
    recorded more than ``per_call`` launches a call raises, and unless
    ``old_ok`` one that recorded a kernel of the replaced sign_compress
    design does."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with card_profile() as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = profile_tables(prof).kernels
        if not old_ok:
            check_no_old_sign_kernel(kernels, str(kernel))
        us, calls = matched_device_us(kernels, names)
        if per_call is not None and calls > per_call * reps:
            raise AssertionError(f"{kernel}: {calls} launches in {reps} "
                                 f"calls, not {per_call} a call")
        if calls >= reps and us > 0:
            return us / 1e3 / reps
    raise AssertionError(f"the profiler recorded {calls} launches of "
                         f"{kernel} ({us} µs) in {reps} calls, {attempts} "
                         f"times")


def fused_adam_sides(fa, gk) -> dict:
    """``--parent``'s fused_adam cases, each turn's first (late in a
    process the profiler loses records): at SHAPE, one rank's K = 1
    shard, SHAPE with bf16 moments and LM_SHAPE (f32 moments; last: a
    case timed right after its 69 GB were freed ran slower), the
    kernel's CUDA-event ms of one call, its device ms and ``host_us``
    (the launch path at HOST_N elements), and with f32 moments the same
    of ``torch._fused_adam_``: in place on copies of p, m and v, at
    LM_SHAPE on p, m and v themselves (no room for copies) after the
    kernel's timings, a tensor a worker. At LM_SHAPE also the plain
    version worker by worker (seven buffers leave no room for its
    temporaries at once) and ``gossip_adam_mix`` on LM_K's ring."""
    from repro_torch.core.topology import make_topology

    ring = make_topology("ring", LM_K)
    ring = (ring.offsets, ring.offset_weights, ring.self_weight)
    hosts = {t: fused_adam_host(fa, ADAM, t, library=t == torch.float32)
             for t in (torch.float32, torch.bfloat16)}
    step = torch.tensor(1e7, device="cuda")
    out = {}
    for name, shape, moments in (
            ("fused_adam", SHAPE, torch.float32),
            ("fused_adam, K = 1", (1,) + SHAPE[1:], torch.float32),
            ("fused_adam, bf16 m and v", SHAPE, torch.bfloat16),
            ("fused_adam, LM_SHAPE", LM_SHAPE, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda") * 0.1
        m = (torch.randn(shape, generator=gen, device="cuda")
             * 0.01).to(moments)
        v = (torch.rand(shape, generator=gen, device="cuda")
             * 0.01).to(moments)
        lm = shape == LM_SHAPE
        reps, warmup = (LM_REPS, 1) if lm else (REPS, 3)

        def kernel():
            return fa.fused_adam(p, g, m, v, **ADAM)

        rec = {"ms": median_ms(kernel, reps=reps, warmup=warmup),
               "device_ms": device_kernel_ms(kernel, "fused_adam_kernel",
                                             reps=reps),
               **hosts[moments]}
        if lm:
            def plain():
                for k in range(LM_K):
                    fa.fused_adam_plain(p[k:k + 1], g[k:k + 1], m[k:k + 1],
                                        v[k:k + 1], **ADAM)

            def mixed():
                return gk.gossip_adam_mix(p, g, m, v, *ring, **ADAM)

            rec["plain_ms"] = median_ms(plain, reps=reps, warmup=warmup)
            out["gossip_adam_mix, LM_SHAPE"] = {
                "ms": median_ms(mixed, reps=reps, warmup=warmup),
                "device_ms": device_kernel_ms(
                    mixed, "gossip_adam_mix_kernel", reps=reps)}
        if moments == torch.float32:
            lib = (p, m, v) if lm else (p.clone(), m.clone(), v.clone())
            # a tensor a worker at LM_SHAPE, as lm_shape_times passes it
            call = fused_adam_library_call(*(list(t) if lm else [t] for t in (
                lib[0], g, lib[1], lib[2])), ADAM, step)
            rec.update(library_ms=median_ms(call, reps=reps, warmup=warmup),
                       library_device_ms=device_kernel_ms(call, "",
                                                          reps=reps))
            del lib, call
        out[name] = rec
        del p, g, m, v
        torch.cuda.empty_cache()
    return out


def ab_side(src: str) -> dict:
    """One turn of ``--parent``: the ``repro_torch`` under ``src`` timed
    on ``fused_adam`` beside ``torch._fused_adam_`` (``fused_adam_sides``),
    on the f32 flash cases whose head dim it takes, on
    ``gossip_adam_mix`` at SHAPE over the ring and on
    ``sign_compress_stacked`` at SHAPE over DeepFM's leaves, on the inputs
    ``flash_records`` and ``phase_kernels`` make (CUDA-event and device ms
    of each; the sign kernels of either tree's design), then on
    ``sign_compress_stacked`` over lm_train_cd's leaves on random buffers
    of its state's shape (CUDA events), and one D-Adam and one CD-Adam
    period of full-width DeepFM (device and wall ms)."""
    sys.path.insert(0, src)
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adam as fad
    from repro_torch.kernels import gossip as gk
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    def timed(fn, kernel):
        return {"ms": median_ms(fn), "device_ms": device_kernel_ms(fn, kernel)}

    out = fused_adam_sides(fad, gk)
    for name, B, S, T, Hq, Hk, D, dt, causal, window in FLASH_CASES:
        if dt != torch.float32 or D not in fa.HEAD_DIMS[dt]:
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
        k = torch.randn((B, T, Hk, D), generator=gen, device="cuda")
        v = torch.randn((B, T, Hk, D), generator=gen, device="cuda")
        out[name] = timed(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), "flash_")
        del q, k, v
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(SHAPE, generator=gen, device="cuda")
    g = torch.randn(SHAPE, generator=gen, device="cuda") * 0.1
    m = torch.randn(SHAPE, generator=gen, device="cuda") * 0.01
    v = torch.rand(SHAPE, generator=gen, device="cuda") * 0.01
    topo = make_topology("ring", K)
    out["gossip_adam_mix"] = timed(lambda: gk.gossip_adam_mix(
        p, g, m, v, topo.offsets, topo.offset_weights, topo.self_weight,
        **ADAM), "gossip_adam_mix_kernel")
    del p, g, m, v
    spec = full_width_spec()
    ranges = packing.leaf_row_ranges(spec)
    true = resident_mask(spec)
    x, hs = (torch.randn(SHAPE, generator=gen, device="cuda") * true
             for _ in range(2))

    def sign():
        return sc.sign_compress_stacked(x, hs, n_true=spec.sizes,
                                        row_ranges=ranges)

    out["sign_compress_stacked"] = {
        "ms": median_ms(sign), "device_ms": device_kernel_ms(
            sign, SIGN_KERNELS + OLD_SIGN_KERNELS, old_ok=True)}
    del x, hs, true
    lm = lm_cd_layout()
    x, hs = (torch.randn(lm.buf_shape(), generator=gen, device="cuda")
             for _ in range(2))
    lm_ranges = packing.leaf_row_ranges(lm)
    out["sign_compress_stacked, lm_train_cd layout"] = {
        "ms": median_ms(lambda: sc.sign_compress_stacked(
            x, hs, n_true=lm.sizes, row_ranges=lm_ranges), reps=LM_REPS,
            warmup=1), "device_ms": None}
    del x, hs
    torch.cuda.empty_cache()
    out["d-adam period"] = deepfm_period_times("d-adam")
    out["cd-adam period"] = deepfm_period_times("cd-adam")
    return out


def deepfm_period_times(path: str) -> dict:
    """One communication period (3 local steps, 1 comm step) of ``path``
    ("d-adam" or "cd-adam" on the ring) at full-width DeepFM through the
    tree's own trainer: wall and device ms (``device_profile``), after
    one period of warm-up."""
    from repro_torch.launch import deepfm_ctr

    period = 4
    res = deepfm_ctr.run("parent_ab", "deepfm", PATHS[path]["kind"], period,
                         backend="packed", device=DEVICE, period=period,
                         **PATHS[path]["opt"], **FULL)
    batches = [next(res.batches) for _ in range(period)]

    def run_period():
        st = res.state
        for b in batches:
            st, _ = res.trainer.step(st, b)

    run_period()
    prof = device_profile(run_period, old_ok=True)
    out = {"ms": prof["wall_ms"], "device_ms": prof["device_ms"]}
    del res
    torch.cuda.empty_cache()
    return out


def phase_parent_ab(parent: str):
    """``--parent``: ``ab_side`` of the tree at ``parent`` and of this
    one, each turn of AB_ORDER a process of its own; one line per turn,
    then the median of each side per case (None where a side lacks it)."""
    trees = {"P": Path(parent).resolve(), "C": ROOT}
    runs = {"P": [], "C": []}
    for side in AB_ORDER:
        res = subprocess.run(
            [sys.executable, __file__, "--ab-side", str(trees[side] / "src")],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"the {side} turn failed:\n{res.stdout}"
                                 f"{res.stderr}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(rec)
        emit({"phase": "parent_ab", "side": side, "tree": str(trees[side]),
              "times": rec})

    def med(side, case, key):
        vals = [r[case].get(key) for r in runs[side]]
        return None if None in vals else statistics.median(vals)

    median = {case: {name: ({key: med(side, case, key)
                             for key in runs["C"][0][case]}
                            if case in runs[side][0] else None)
                     for side, name in (("P", "parent"), ("C", "change"))}
              for case in runs["C"][0]}
    emit({"phase": "parent_ab", "order": AB_ORDER, "median": median})


def wkv_work(B, S, H, D, itemsize):
    """(bytes, operations) of one call: r, k, v at their size, w and y in
    f32, u read once, the state read and written; 4 * D^2 operations per
    (b, h, t): 2 D^2 for r . S, 2 D^2 for the decay and the add."""
    n = B * S * H * D
    return (n * (3 * itemsize + 8) + H * D * 4 + 2 * B * H * D * D * 4,
            4 * D * D * B * H * S)


def rwkv_records():
    """``rwkv_scan`` against its plain version on the card: the final
    state equal to the bit, y within WKV_Y_TOL; kernel, plain and bound
    ms at each shape, then the continuity contract (one S=1024 call
    against two calls of 512 that carry the state, equal to the bit),
    timed as the two calls."""
    from repro_torch.kernels import rwkv_scan as wk

    records = []
    cont = ("1024 steps as two calls of 512", 8, 1024, 40, 64,
            torch.bfloat16)
    for name, B, S, H, D, dt in WKV_CASES + (cont,):
        ins = wkv_inputs(B, S, H, D, dt)
        r, k, v, w, u, s0 = ins
        if name == cont[0]:
            h = S // 2

            def kernel():
                y1, s1 = wk.rwkv_scan(r[:, :h], k[:, :h], v[:, :h],
                                      w[:, :h], u, s0)
                y2, s2 = wk.rwkv_scan(r[:, h:], k[:, h:], v[:, h:],
                                      w[:, h:], u, s1)
                return torch.cat([y1, y2], 1), s2

            def plain():
                y1, s1 = wk.rwkv_scan_plain(r[:, :h], k[:, :h], v[:, :h],
                                            w[:, :h], u, s0)
                y2, s2 = wk.rwkv_scan_plain(r[:, h:], k[:, h:], v[:, h:],
                                            w[:, h:], u, s1)
                return torch.cat([y1, y2], 1), s2

            one = wk.rwkv_scan(*ins)
            halves = [wkv_work(B, h, H, D, r.element_size())
                      for _ in range(2)]
            n_bytes = sum(b for b, _ in halves)
            ops = sum(o for _, o in halves)
        else:
            def kernel():
                return wk.rwkv_scan(*ins)

            def plain():
                return wk.rwkv_scan_plain(*ins)

            one = None
            n_bytes, ops = wkv_work(B, S, H, D, r.element_size())
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        state_equal = torch.equal(got[1], want[1])
        if not state_equal:
            raise AssertionError(f"rwkv_scan {name}: final state differs "
                                 f"from the plain version's by "
                                 f"{float((got[1] - want[1]).abs().max())}")
        max_abs, max_rel = compare([got[0]], [want[0]], WKV_Y_TOL,
                                   f"rwkv_scan {name} y")
        if one is not None and not (torch.equal(one[0], got[0])
                                    and torch.equal(one[1], got[1])):
            raise AssertionError("rwkv_scan: two calls carrying the state "
                                 "differ from one call")
        del got, want, one
        ms = median_ms(kernel)
        device_ms = device_kernel_ms(kernel, "rwkv_scan_kernel")
        plain_ms = median_ms(plain, reps=5 if S > 1 else REPS,
                             warmup=1 if S > 1 else 3)
        t_bytes, t_ops = n_bytes / MEM_RATE * 1e3, ops / F32_RATE * 1e3
        rec = {"name": "rwkv_scan", "route": "cuda", "design": "lane-split",
               "source": "src/repro_torch/csrc/rwkv_scan.cu",
               "replaces": "src/repro/kernels/rwkv_scan.py:78",
               "launches": None, "max_abs_err": max_abs,
               "max_rel_err": max_rel,
               "tol": {"y": WKV_Y_TOL, "state": "equal"}, "ms": ms,
               "kernel_ms": ms, "kernel_device_ms": device_ms,
               "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": n_bytes, "operations": ops, "library_ms": None,
               "library": NO_WKV_LIBRARY, "state_bit_equal": state_equal,
               "variant": f"{name}: B={B} S={S} H={H} D={D} "
                          f"{str(dt).split('.')[-1]}"}
        emit({"phase": "kernel", **rec})
        records.append(rec)
        del ins, r, k, v, w, u, s0
        torch.cuda.empty_cache()
    return records


def stamped_steps(trainer, state, batches, timed: int, period: int):
    """``timed`` more ``fit`` steps with a synchronised stamp after each
    (they log only at their end): the new state and the step medians,
    local and comm apart."""
    stamps = []

    def hook(step, st):
        torch.cuda.synchronize()
        stamps.append((st.count, time.perf_counter()))

    torch.cuda.synchronize()
    stamps.append((state.count, time.perf_counter()))
    state, _ = trainer.fit(state, batches, timed, log_every=timed,
                           hook=hook, hook_every=1)
    dts = [(c, (t - t0) * 1e3) for (_, t0), (c, t) in zip(stamps,
                                                            stamps[1:])]
    return state, {"step_ms_median": statistics.median(d for _, d in dts),
                   "local_step_ms_median": statistics.median(
                       d for c, d in dts if c % period),
                   "comm_step_ms_median": statistics.median(
                       d for c, d in dts if c % period == 0),
                   "timed_steps": timed}


def phase_slice(path: str):
    """The paper's experiment at full width through the entry points,
    with the launch counters zeroed just before and read just after; then
    a few more steps, timed one by one, and a profile of one period.
    Returns the launch counts and ``(trainer, state, result)``."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import deepfm_ctr

    spec = PATHS[path]
    period, steps, timed = 4, 20, 8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = deepfm_ctr.run(f"{path} p={period}, paper width", "deepfm",
                         spec["kind"], steps, backend="packed", device=DEVICE,
                         period=period, log_every=1, **spec["opt"], **FULL)
    trainer, opt = res.trainer, res.trainer.opt
    round_batches = [next(res.batches) for _ in range(period)]
    batches = tree_map(lambda *xs: torch.stack(xs), *round_batches)

    def grad_fn(buf, batch):
        state = dataclasses.replace(res.state, buf=buf)
        return trainer.pipeline.value_and_grad(state, batch)[1]

    state = opt.round(res.state, grad_fn, batches)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {name: spec["launches"].get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches} != schedule "
                             f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res.log.loss
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path}: non-finite loss in {losses}")
    # init and batches come from fixed seeds, so the sequence is the same
    # in every run on this card
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{path}: loss did not fall: {losses}")
    if not bool(torch.isfinite(state.buf).all()):
        raise AssertionError(f"{path}: non-finite params after opt.round")
    wire = opt.comm_bytes_round_list(opt.params_of(state))
    if wire != WIRE_BYTES[path]:
        raise AssertionError(f"{path}: {wire} bytes per round, expected "
                             f"{WIRE_BYTES[path]}")
    auc_after_round = deepfm_ctr.heldout_auc(
        res.teacher, trainer.averaged_params(state),
        deepfm_ctr.MODELS["deepfm"][2])

    state, times = stamped_steps(trainer, state, res.batches, timed, period)
    stale = getattr(state, "stale", None)
    emit({"phase": "slice", "path": path, "kind": spec["kind"],
          "config": {"K": K, "topology": spec["opt"].get("topology", "ring"),
                     "period": period, "steps": steps, **spec["opt"], **FULL,
                     "hidden": list(FULL["hidden"])},
          "buffer_shape": list(state.buf.shape),
          "params_per_worker": state.spec.n,
          "losses": losses, **times,
          "auc_after_fit": res.auc, "auc_after_round": auc_after_round,
          "comm_mb_fit": res.log.comm_mb[-1],
          "comm_mb_per_round": trainer.comm_mb_per_round(state),
          "comm_bytes_round_list": wire,
          "consensus": res.log.consensus[-1],
          "stale_age_max": (int(stale.age.max()) if stale is not None
                            else None),
          "peak_mem_gb": peak_gb, "launches": launches})
    phase_profile(path, trainer, state, [next(res.batches)
                                         for _ in range(period)])
    return launches, (trainer, state, res)


def phase_profile(path, trainer, state, batches):
    """Device time by kernel over one communication period of steps, the
    device's busy share of the window's wall time, and the device time of
    the port's named ranges (``repro_torch.*``)."""
    def period():
        st = state
        for b in batches:
            st, _ = trainer.step(st, b)

    emit({"phase": "profile", "path": path, "steps": len(batches),
          **device_profile(period)})


def device_profile(fn, kernel_names=(), old_ok: bool = False):
    """Profile ``fn()``: its wall time (synchronised), the device time
    summed over kernels, the busy share, the torch calls made from Python
    (top-level ``aten::`` ops, each a host round trip), the port's named
    ranges, the top kernels by device time, and the device ms and calls of
    the CUDA kernels whose name holds one of ``kernel_names``. Unless
    ``old_ok``, a profile that recorded a kernel of the replaced
    sign_compress design raises."""
    torch.cuda.synchronize()
    with card_profile() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tables = profile_tables(prof)
    if not old_ok:
        check_no_old_sign_kernel(tables.kernels, "device_profile")
    rows = sorted(((us / 1e3, n, k[:90])
                   for k, (us, n) in tables.kernels.items()), reverse=True)
    device_ms = sum(r[0] for r in rows)
    calls = tables.torch_calls
    kernel_us, kernel_calls = matched_device_us(tables.kernels,
                                                kernel_names)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_ms": kernel_us / 1e3, "kernel_calls": kernel_calls,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "torch_calls": sum(calls.values()),
            "torch_calls_top": calls.most_common(8),
            "ranges": tables.ranges,
            "top": [{"kernel": k, "ms": ms, "calls": n}
                    for ms, n, k in rows[:16]]}


def state_tensors(state):
    """The resident buffers of a packed state, by name, on the CPU."""
    out = {n: getattr(state, n).cpu() for n in ("buf", "m", "v")}
    if hasattr(state, "hat_buf"):
        out["hat_buf"] = state.hat_buf.cpu()
        for i, h in enumerate(state.hat_nbr_bufs):
            out[f"hat_nbr_bufs[{i}]"] = h.cpu()
    if getattr(state, "stale", None) is not None:
        for i, b in enumerate(state.stale.bufs):
            out[f"stale.bufs[{i}]"] = b.cpu()
    return out


def phase_checkpoint(path: str, trainer, state, batches):
    """Save a state from the card, restore it into ``opt.init``: the
    resident buffers equal to the bit, the straggler buffers cold; then
    one more step."""
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.core.dadam import COLD_AGE

    opt = trainer.opt
    folder = ROOT / "build" / "smoke_checkpoints"
    f = folder / f"{path}.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(str(f), state, step=state.count, meta={"path": path})
    save_s = time.perf_counter() - t0
    nbytes = f.stat().st_size
    like = opt.init(opt.params_of(state))
    t0 = time.perf_counter()
    restored, step = ckpt.restore(str(f), like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    f.unlink()
    (folder / f"{path}.npz.json").unlink()
    if step != state.count or restored.count != state.count:
        raise AssertionError(f"{path}: restored step {step}, count "
                             f"{restored.count} != {state.count}")
    names = ["buf", "m", "v"]
    if hasattr(state, "hat_buf"):
        names.append("hat_buf")
    pairs = [(n, getattr(restored, n), getattr(state, n)) for n in names]
    pairs += [(f"hat_nbr_bufs[{i}]", a, b) for i, (a, b) in enumerate(zip(
        getattr(restored, "hat_nbr_bufs", ()),
        getattr(state, "hat_nbr_bufs", ())))]
    for name, a, b in pairs:
        if a.device != b.device or not torch.equal(a, b):
            raise AssertionError(f"{path}: restored {name} differs")
    if getattr(state, "stale", None) is not None:
        st = restored.stale
        cold = (bool((st.age == COLD_AGE).all())
                and not any(bool(b.any()) for b in st.bufs))
    else:
        cold = not any(bool(t.any()) for ring in restored.pending
                       for t in ring.values())
    if not cold:
        raise AssertionError(f"{path}: straggler buffers not cold")
    restored, loss = trainer.step(restored, next(batches))
    loss = float(loss)
    if not math.isfinite(loss) or not bool(torch.isfinite(
            restored.buf).all()):
        raise AssertionError(f"{path}: step after restore: loss {loss}")
    emit({"phase": "checkpoint", "path": path, "file_bytes": nbytes,
          "save_s": save_s, "restore_s": restore_s,
          "bit_equal": [n for n, _, _ in pairs], "cold": cold,
          "loss_after_restore": loss})


def phase_churn(trainer, state, teacher):
    """Elastic membership at full width: K 8 -> 6 (clone) -> 8 (mean),
    4 steps after each resize."""
    from repro_torch.data.synthetic import ctr_batch_stacked

    rec = {"phase": "churn", "path": "d-adam-straggler", "resizes": []}
    for k_new, strategy in ((6, "clone"), (8, "mean")):
        state = trainer.resize(state, trainer.opt.rebuild(K=k_new),
                               strategy=strategy)
        shape = tuple(state.buf.shape)
        if shape != (k_new,) + SHAPE[1:] or trainer.opt.K != k_new:
            raise AssertionError(f"resize to {k_new}: buffer {shape}")
        gen = torch.Generator(device=DEVICE).manual_seed(10 + k_new)
        stream = (ctr_batch_stacked(teacher, gen, k_new, FULL["per_worker"])
                  for _ in range(4))
        state, log = trainer.fit(state, stream, 4, log_every=1)
        if not all(math.isfinite(x) for x in log.loss):
            raise AssertionError(f"K={k_new}: losses {log.loss}")
        rec["resizes"].append({"K": k_new, "strategy": strategy,
                               "buffer_shape": list(shape),
                               "losses": log.loss,
                               "stale_age": state.stale.age.tolist()})
    emit(rec)


def outside_tol(a, b):
    d = (a.double() - b.double()).abs()
    return d, d > CARD_CPU_TOL["atol"] + CARD_CPU_TOL["rtol"] * b.double().abs()


def step3_check(name, a, b, slack=None):
    """Step 3 against the CPU: few elements outside the tolerance, each
    within eta, and, for the params of a CD-Adam path, within eta plus
    what the earlier hat gaps moved them by (``slack``, elementwise)."""
    d, outside = outside_tol(a, b)
    over = d - ETA if slack is None else d - ETA - slack
    rec = {"max_abs_err": float(d.max()),
           "max_past_cap": float(over.max()),
           "share_outside": float(outside.double().mean())}
    if rec["share_outside"] > CARD_CPU_MAX_SHARE or rec["max_past_cap"] > 0:
        raise AssertionError(f"step 3 {name}: {rec} past share "
                             f"{CARD_CPU_MAX_SHARE} / eta {ETA} + slack")
    return rec


def leaf_rows(spec):
    """Each packed row's leaf (int64, (rows,)) and each leaf's true element
    count (f64); the rows past the last leaf form one more, empty leaf."""
    from repro_torch.kernels import pack as packing

    ranges = packing.leaf_row_ranges(spec)
    leaf = torch.full((spec.buf_shape()[1],), len(ranges), dtype=torch.long)
    for i, (r0, r1) in enumerate(ranges):
        leaf[r0:r1] = i
    n_true = torch.tensor(list(spec.sizes) + [1], dtype=torch.float64)
    return leaf, n_true.clamp(min=1)


def hat_check(path, card, cpu, opt, spec, period):
    """CD-Adam's hat copies, card against CPU, step by step (``card`` and
    ``cpu``: the state tensors after each step).

    On each device, every round must follow the sign compressor's rule:
    worker k's hat moves by ``scale * sign(x - hat)``, with x the round's
    mixed params and hat the one before, and one scale per (worker, leaf),
    the mean of ``|x - hat|`` over the leaf's true elements; off the
    rounds it stays as it was. That is checked to the tolerance from the
    state alone, so a wrong leaf, worker or scale fails it. Worker k's
    copy of neighbour i's hat must be that worker's own hat of ``delay``
    steps before (1 under overlap), to the bit: both add the same
    ``scale * sign`` values in the same order, so a wrong slot, worker or
    offset in the ring's push or gather fails it.

    Card against CPU, the hats can then part only where ``sign(x - hat)``
    differs between the devices, a residual within their difference of x:
    by 2 * scale where the sign fell the other way, by one scale where the
    residual is exactly zero on one device. Those positions are counted,
    at most the share allowed.

    Returns the record and the params' slack at step 3: the mix (8) adds
    ``gamma * sum_i w_i * (hat_nbr_i - hat_self)`` at every later round,
    so each step's hat gaps move the later params by at most gamma times
    the weighted sum of their sizes."""
    from repro_torch.core.dadam import shift_worker

    topo, delay = opt.topo, 1 if opt.cfg.overlap else 0
    weights = [float(w) for w in topo.offset_weights]
    nbrs = [f"hat_nbr_bufs[{i}]" for i in range(len(topo.offsets))]
    zeros = torch.zeros_like(card[0]["hat_buf"])
    leaf, n_true = (x.to(zeros.device) for x in leaf_rows(spec))
    signs, rule_err = {}, {}
    for dev, snaps in (("card", card), ("cpu", cpu)):
        prev = zeros.double()
        signs[dev], rule_err[dev] = [], []
        for t in range(len(snaps)):
            own = snaps[t - delay]["hat_buf"] if t >= delay else zeros
            for name, s in zip(nbrs, topo.offsets):
                if not torch.equal(snaps[t][name],
                                   shift_worker(own, s, topo.K)):
                    raise AssertionError(
                        f"{path} {dev} step {t + 1}: {name} is not the "
                        f"neighbour's hat of {delay} step(s) before")
            hat = snaps[t]["hat_buf"].double()
            sign = torch.zeros_like(hat)
            if (t + 1) % period == 0:
                resid = snaps[t]["buf"].double() - prev
                scale = (torch.zeros((topo.K, len(n_true)),
                                     dtype=torch.float64, device=hat.device)
                         .index_add_(1, leaf, resid.abs().sum(-1))
                         / n_true)[:, leaf, None]
                sign = torch.sign(resid)
                want = scale * sign
            else:
                want = torch.zeros_like(hat)
            err = (hat - prev - want).abs()
            past = err - (CARD_CPU_TOL["atol"]
                          + CARD_CPU_TOL["rtol"] * want.abs())
            rule_err[dev].append(float(err.max()))
            if float(past.max()) > 0:
                raise AssertionError(
                    f"{path} {dev} step {t + 1}: the hat moved by "
                    f"{float(err.max())} off scale * sign(x - hat)")
            signs[dev].append(sign)
            prev = hat
    disputed = torch.zeros_like(zeros, dtype=torch.bool)
    slack = torch.zeros_like(zeros, dtype=torch.float64)
    steps = []
    for t in range(len(card)):
        sc, sh = signs["card"][t], signs["cpu"][t]
        flip, zero = sc * sh < 0, (sc == 0) != (sh == 0)
        disputed |= flip | zero
        steps.append({"step": t + 1, "flips": int(flip.sum()),
                      "zero_on_one": int(zero.sum()),
                      "rule_err_card": rule_err["card"][t],
                      "rule_err_cpu": rule_err["cpu"][t]})
        if t + 1 < len(card):
            # the hat gaps after this step enter every later mix
            g = sum(weights) * (card[t]["hat_buf"].double()
                                - cpu[t]["hat_buf"].double()).abs()
            for w, name in zip(weights, nbrs):
                g += w * (card[t][name].double() - cpu[t][name].double()).abs()
            slack += GAMMA * g
    share = float(disputed.double().mean())
    if share > CARD_CPU_MAX_SHARE:
        raise AssertionError(f"{path}: {share} of the positions hold a "
                             "sign that differs")
    return {"delay": delay, "steps": steps, "disputed_share": share,
            "max_slack": float(slack.max())}, slack


def phase_card_vs_cpu(path: str, period: int = 3, damping=None):
    """Three steps from one init and one set of batches, on the card and
    on the CPU: at period 3 two fused_adam steps, then a communication
    step; at period 1 three rounds, the later ones mixing buffered
    payloads on the straggler-tolerant paths. The straggler draw is made
    on the host from its seed, so both devices see the same arrivals.
    With ``damping`` (a DampingConfig's fields) the trainer is damped: the
    chunk counts of every step must be equal on both devices, and differ
    between workers at some step."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)
    from repro_torch.models.deepfm import deepfm_loss, init_deepfm
    from repro_torch.train.damping import DampingConfig, chunks_of
    from repro_torch.train.loop import DecentralizedTrainer

    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, "cpu")
    params = init_deepfm(torch.Generator().manual_seed(0), task.n_features,
                         task.n_fields, FULL["embed_dim"], FULL["hidden"])
    gen = torch.Generator().manual_seed(1)
    batches = [ctr_batch_stacked(teacher, gen, K, FULL["per_worker"])
               for _ in range(3)]
    spec = PATHS[path]
    kind, opt_kw = spec["kind"], dict(spec["opt"])
    topology = opt_kw.pop("topology", "ring")
    dcfg = DampingConfig(**damping) if damping is not None else None
    out, ages, counts = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        opt = make_optimizer(kind, K, eta=ETA, period=period,
                             topology=topology, backend="packed",
                             device=dev, **opt_kw)
        tr = DecentralizedTrainer(deepfm_loss, opt, damping=dcfg)
        it = iter(batches)
        state, log, snaps = tr.init(params), None, []
        for _ in range(3):
            if dcfg is not None:
                counts.setdefault(dev, []).append(
                    chunks_of(tr.damp_state, dcfg, K).tolist())
            state, log = tr.fit(state, it, 1, log_every=1, log=log)
            snaps.append(state_tensors(state))
        out[dev] = (snaps, log.loss, time.perf_counter() - t0)
        stale = getattr(state, "stale", None)
        ages[dev] = stale.age.tolist() if stale is not None else None
        pack_spec = state.spec
        del tr, state
        torch.cuda.empty_cache()
    (card, closs, ct), (cpu, hloss, ht) = out[DEVICE], out["cpu"]
    # the checks run in f64 on the card, both runs' snapshots copied there:
    # the same comparisons, without the host's minutes over 91M elements
    card, cpu = ([{n: x.to(DEVICE) for n, x in snap.items()}
                  for snap in snaps] for snaps in (card, cpu))
    step1 = {n: compare([card[0][n]], [cpu[0][n]], CARD_CPU_TOL,
                        f"step 1 {n}")[0] for n in card[0]}
    loss_err = compare([torch.tensor(closs)], [torch.tensor(hloss)],
                       CARD_CPU_TOL, "losses")[0]
    hats, slack = (hat_check(path, card, cpu, opt, pack_spec, period)
                   if "hat_buf" in card[0] else (None, None))
    step3 = {n: step3_check(n, card[2][n], cpu[2][n],
                            slack if n == "buf" else None)
             for n in card[2] if not n.startswith("hat")}
    if ages[DEVICE] != ages["cpu"]:
        raise AssertionError(f"{path}: stale ages {ages}")
    if dcfg is not None and (counts[DEVICE] != counts["cpu"] or not any(
            len(set(c)) > 1 for c in counts["cpu"])):
        raise AssertionError(f"{path} damped: chunk counts {counts}: not "
                             f"equal on both devices, or equal between "
                             f"workers at every step")
    emit({"phase": "card_vs_cpu", "path": path, "steps": 3,
          "damping": damping, "chunk_counts": counts.get("cpu"),
          "period": period, "stale_age": ages["cpu"],
          "losses_card": closs, "losses_cpu": hloss, "loss_max_abs_err":
          loss_err, "step1_max_abs_err": step1, "step3": step3,
          "hats": hats, "tol": CARD_CPU_TOL,
          "max_share_outside": CARD_CPU_MAX_SHARE,
          "seconds_card": ct, "seconds_cpu": ht})


# ------------------------------ comm='axis' ---------------------------------


def axis_inputs(k: int = K):
    """The init and the batches of the axis phases (``k`` workers), made
    on the CPU from seeds: the same in the parent and in every rank."""
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)
    from repro_torch.models.deepfm import init_deepfm

    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, "cpu")
    params = init_deepfm(torch.Generator().manual_seed(0), task.n_features,
                         task.n_fields, FULL["embed_dim"], FULL["hidden"])
    gen = torch.Generator().manual_seed(1)
    batches = [ctr_batch_stacked(teacher, gen, k, FULL["per_worker"])
               for _ in range(AXIS_STEPS)]
    return params, batches


def per_worker_deepfm_loss(params, batch):
    """``deepfm_loss`` worker by worker on ``(1, ...)`` slices of the
    stacked params and batch, so that its GEMMs and its embedding gradient
    run as a comm='axis' rank runs them: the card's cuBLAS sums a batched
    product of 1 and of 8 workers in other orders (``batched_vs_per_worker``
    in the axis records)."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.deepfm import deepfm_loss

    return torch.cat([
        deepfm_loss(tree_map(lambda x, k=k: x[k:k + 1], params),
                    tree_map(lambda x, k=k: x[k:k + 1], batch))
        for k in range(tree_leaves(batch)[0].shape[0])])


def axis_trainer(path: str, group=None, per_worker: bool = False):
    """The path's trainer: stacked on the card without ``group`` (its loss
    worker by worker with ``per_worker``), else this rank's comm='axis'
    one."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.models.deepfm import deepfm_loss
    from repro_torch.train.loop import DecentralizedTrainer

    spec = AXIS_PATHS[path]
    where = (dict(device=DEVICE) if group is None
             else dict(comm="axis", group=group))
    opt = make_optimizer(spec["kind"], K, eta=ETA, period=AXIS_PERIOD,
                         backend="packed", **where, **spec["opt"])
    return DecentralizedTrainer(
        per_worker_deepfm_loss if per_worker else deepfm_loss, opt)


def axis_snapshot(state, step: int) -> dict:
    return {f"{n}@{step}": getattr(state, n).detach().clone()
            for n in AXIS_SNAPSHOTS[step]}


def axis_stacked_run(path: str, params, batches, per_worker: bool):
    """The path stacked on the card: its snapshots, last loss, consensus
    and bytes per round; for the per-worker run of an AXIS_ELASTIC path
    also the bit sums of its elastic plan (``elastic``), and for D-Adam's
    those of its publishes at AXIS_ONLINE_EVERY steps (``published``)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.serve.publish import publish_params

    trainer = axis_trainer(path, per_worker=per_worker)
    snaps, published = {}, []
    online = per_worker and path == "d-adam"

    def hook(step, st):
        if step in AXIS_SNAPSHOTS:
            snaps.update(axis_snapshot(st, step))
        if online and step % AXIS_ONLINE_EVERY == 0:
            params = publish_params(st, mode="mean")
            published.append({"step": step, "params": params, "sums": [
                bit_sums(x) for x in tree_leaves(params)]})

    state, log = trainer.fit(trainer.init(params), iter(batches),
                             AXIS_STEPS, log_every=AXIS_STEPS, hook=hook,
                             hook_every=1)
    rec = {"loss": log.loss[-1], "consensus": log.consensus[-1],
           "bytes_round_list": trainer.opt.comm_bytes_round_list(
               trainer.opt.params_of(state))}
    if online:
        rec["published"] = published
        rec["worker_sums"] = [bit_sums(x) for x in tree_leaves(
            publish_params(state, mode="worker",
                           worker=AXIS_ONLINE_WORKER))]
    if per_worker and path in AXIS_ELASTIC:
        rec["elastic"] = axis_elastic_stacked(path, trainer, state, log)
    return snaps, rec


def axis_stacked_refs(folder: Path, params, batches) -> dict:
    """Each path stacked on the card from the axis phase's init and
    batches, its loss worker by worker: its buffers at the snapshot steps,
    each rank's rows written to ``<folder>/<path>-<rank>.pt``. Beside it
    the same path with the batched loss, as the ``slice`` phase runs it,
    held to the first by ``step3_check``'s measures (recorded, not
    gated). Returns each path's last losses, consensus and bytes per
    round, and the elastic plans' and publishes' bit sums."""
    out = {}
    for path in AXIS_PATHS:
        snaps, rec = axis_stacked_run(path, params, batches, True)
        for r in range(K):
            torch.save({n: x[r:r + 1].to("cpu", copy=True)
                        for n, x in snaps.items()},
                       folder / f"{path}-{r}.pt")
        batched, brec = axis_stacked_run(path, params, batches, False)
        rec["batched_vs_per_worker"] = {
            n: {"max_abs_err": float(d.max()),
                "share_outside": float(outside.double().mean())}
            for n in snaps for d, outside in [outside_tol(batched[n],
                                                          snaps[n])]}
        rec["loss_batched"] = brec["loss"]
        out[path] = rec
        del snaps, batched
        torch.cuda.empty_cache()
    return out


def bit_sums(x: torch.Tensor) -> list:
    """Two int64 sums of ``x``'s bit patterns, plain and weighted by
    position (mod 2^64, so the order of the sum does not matter): equal
    for tensors equal to the bit; a difference in one element changes
    both."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[x.element_size()]
    b = x.detach().contiguous().reshape(-1).view(ints).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def axis_elastic_batches(k: int, segment: int):
    """The global batches of an elastic membership of ``k`` workers (the
    ``segment``-th of its plan), made on the CPU from a seed: the same in
    the parent and in every rank."""
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)

    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, "cpu")
    gen = torch.Generator().manual_seed(20 + segment)
    return [ctr_batch_stacked(teacher, gen, k, FULL["per_worker"])
            for _ in range(AXIS_ELASTIC_STEPS)]


def axis_elastic_stacked(path: str, trainer, state, log) -> list:
    """The elastic plan of ``path`` stacked on the card, going on from its
    state after the 12 steps: each worker's bit sums right after each
    resize (``after``) and after each step (``steps``), and the last
    loss."""
    def rows(st, k):
        return [{n: bit_sums(getattr(st, n)[r]) for n in BUFS}
                for r in range(k)]

    segs = []
    for i, (k_new, strategy) in enumerate(AXIS_ELASTIC[path]):
        state = trainer.resize(state, trainer.opt.rebuild(K=k_new),
                               strategy=strategy)
        seg = {"K": k_new, "after": rows(state, k_new), "steps": []}
        state, log = trainer.fit(
            state, iter(axis_elastic_batches(k_new, i)), AXIS_ELASTIC_STEPS,
            log_every=AXIS_ELASTIC_STEPS, log=log,
            hook=lambda step, st: seg["steps"].append(rows(st, k_new)),
            hook_every=1)
        seg["loss"] = log.loss[-1]
        segs.append(seg)
    return segs


def axis_elastic_rank(path: str, trainer, state, log, group) -> list:
    """A rank's part of the elastic plan of ``path``: for each membership a
    new worker group over the world's first K' ranks, ``trainer.resize``
    with the old group (the rank's state, or None when it held no worker),
    ``share_log``, then the steps. Returns per membership the resize's
    seconds and bytes, and for a member its buffers' bit sums right after
    the resize and after each step, the cold ages, whether the hats are
    zero, the step times, the loss and the launches."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_group

    spec = AXIS_PATHS[path]
    old, segs = group, []
    for i, (k_new, strategy) in enumerate(AXIS_ELASTIC[path]):
        new = make_worker_group(k_new, device=DEVICE, backend="gloo",
                                timeout_s=AXIS_GROUP_TIMEOUT_S)
        opt = make_optimizer(spec["kind"], k_new, eta=ETA,
                             period=AXIS_PERIOD, backend="packed",
                             comm="axis", group=new, **spec["opt"])
        torch.cuda.synchronize()
        ops.reset_launches()
        old.reset_counts()
        t0 = time.perf_counter()
        state = trainer.resize(state, opt, strategy=strategy, group=old)
        torch.cuda.synchronize()
        seg = {"K": k_new, "strategy": strategy, "member": new.member,
               "resize_s": time.perf_counter() - t0,
               "resize_bytes": old.collective_summary()["resize"]}
        if new.member:
            log = trainer.share_log(log)
            stale = getattr(state, "stale", None)
            hats = ([state.hat_buf, *state.hat_nbr_bufs]
                    if hasattr(state, "hat_buf") else [])
            seg.update(after={n: bit_sums(getattr(state, n)) for n in BUFS},
                       block=list(state.buf.shape), count=state.count,
                       ages=None if stale is None else stale.age.tolist(),
                       hats_zero=all(not bool(h.any()) for h in hats)
                       if hats else None)
            steps, stamps = [], [(0, time.perf_counter())]

            def hook(step, st):
                torch.cuda.synchronize()
                stamps.append((step, time.perf_counter()))
                steps.append({n: bit_sums(getattr(st, n)) for n in BUFS})
                torch.cuda.synchronize()
                stamps.append((step, time.perf_counter()))

            (state, log), seg["invariants"] = gated_fit(
                f"axis_elastic {path} K={k_new}", trainer, state, new,
                AXIS_ELASTIC_STEPS, AXIS_ELASTIC_LAUNCHES[path],
                lambda: trainer.fit(
                    state, iter(axis_elastic_batches(k_new, i)),
                    AXIS_ELASTIC_STEPS, log_every=AXIS_ELASTIC_STEPS,
                    log=log, hook=hook, hook_every=1))
            dts = [(t1 - t0) * 1e3 for (_, t0), (_, t1)
                   in zip(stamps[0::2], stamps[1::2])]
            seg.update(steps=steps, loss=log.loss[-1],
                       steps_total=log.steps_total, step_ms=dts,
                       finite=bool(torch.isfinite(state.buf).all()))
        seg["launches"] = ops.launch_counts()
        segs.append(seg)
        old = new
    return segs


def axis_online_rank(group, params, batches) -> dict:
    """``train_online`` on this rank of the world's group of K=8: the
    publish history, the bit sums of every published tree and of worker
    AXIS_ONLINE_WORKER's replica, the launches, and the publish times
    (median of 3, each synchronised) of both modes on the final state."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.serve.publish import ParamStore, publish_params
    from repro_torch.train.online import train_online

    trainer = axis_trainer("d-adam", group)
    state = trainer.init(params)
    store, sums = ParamStore(), []
    publish = store.publish

    def keep(p, **kw):
        sums.append([bit_sums(x) for x in tree_leaves(p)])
        return publish(p, **kw)

    store.publish = keep
    torch.cuda.synchronize()
    ops.reset_launches()
    res = train_online(trainer, state, iter(batches), AXIS_STEPS,
                       store=store, publish_every=AXIS_ONLINE_EVERY,
                       mode="mean", log_every=AXIS_STEPS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    ms = {}
    for mode in ("mean", "worker"):
        times = []
        for _ in range(3):
            _, dt = synced(lambda: publish_params(
                res.state, mode=mode, worker=AXIS_ONLINE_WORKER,
                group=group))
            times.append(dt)
        ms[mode] = statistics.median(times)
    worker = publish_params(res.state, mode="worker",
                            worker=AXIS_ONLINE_WORKER, group=group)
    return {"published": res.published, "sums": sums,
            "worker_sums": [bit_sums(x) for x in tree_leaves(worker)],
            "launches": launches, "publish_ms": ms, "loss": res.log.loss[-1]}


def gated_fit(name: str, trainer, state, group, steps: int, launches,
              fit, activation_bytes: int = 0):
    """``fit()`` (``steps`` steps of ``trainer.fit`` from ``state``, one
    log point) under the invariant gate: ``analysis.check.period_spec``
    of those steps with ``launches`` exact, run by
    ``analysis.invariants.check_invariants`` on ``group``. Returns
    ``(fit(), report)``."""
    from repro_torch.analysis.check import period_spec
    from repro_torch.analysis.invariants import check_invariants

    out = []
    report = check_invariants(
        lambda: out.append(fit()), (),
        period_spec(name, trainer, state, steps=steps, launches=launches,
                    activation_bytes=activation_bytes), group)
    return out[0], report


def gate_record(name: str, reports) -> dict:
    """The ``invariants`` record of one config from its member ranks'
    reports: raises with the first failing rank's report."""
    for rank, rep in enumerate(reports):
        if not rep.ok:
            raise AssertionError(f"invariants {name} rank {rank}:\n"
                                 + rep.format(verbose=False))
    return {"config": name, "ok": True, "ranks": len(reports),
            "checks": len(reports[0].checks),
            "summary_rank0": reports[0].summary}


def axis_check(name: str, got, want) -> dict:
    """A rank's buffer against its rows of the stacked run: step 1 within
    CARD_CPU_TOL everywhere, later steps by ``step3_check``'s rule."""
    if name.endswith("@1"):
        err = compare([got], [want], CARD_CPU_TOL, f"axis step 1 {name}")[0]
        return {"max_abs_err": err, "share_outside": 0.0}
    return step3_check(f"axis {name}", got, want)


def axis_rank(rank: int, init_method: str, folder: str):
    """One rank of the axis phase: every path of AXIS_PATHS through
    ``make_optimizer(comm='axis')`` and ``DecentralizedTrainer.fit`` on
    cuda:0 in a gloo group; returns its launches, step times, bytes,
    peak memory, last loss and its buffers' checks against its rows of the
    stacked run."""
    import hashlib

    from repro_torch.core.dadam import shift_worker
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = make_worker_group(K, init_method=init_method, device=DEVICE,
                              backend="gloo", timeout_s=AXIS_GROUP_TIMEOUT_S)
    params, batches = axis_inputs()
    out = {"transport": group.transport, "device": str(group.device)}
    for path in AXIS_PATHS:
        refs = torch.load(Path(folder) / f"{path}-{rank}.pt")
        trainer = axis_trainer(path, group)
        state = trainer.init(params)
        checks, stamps = {}, []

        def hook(step, st):
            torch.cuda.synchronize()
            stamps.append((step, time.perf_counter()))
            if step in AXIS_SNAPSHOTS:
                for n, x in axis_snapshot(st, step).items():
                    checks[n] = axis_check(n, x, refs[n].to(x.device))
            torch.cuda.synchronize()
            stamps.append((step, time.perf_counter()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        stamps.append((0, time.perf_counter()))
        (state, log), report = gated_fit(
            f"axis {path}", trainer, state, group, AXIS_STEPS,
            AXIS_PATHS[path]["launches"],
            lambda: trainer.fit(state, iter(batches), AXIS_STEPS,
                                log_every=AXIS_STEPS, hook=hook,
                                hook_every=1))
        launches = ops.launch_counts()
        sent = (group.bytes_sent, group.messages)
        # step t's time: from the end of step t-1's hook to the start of
        # step t's (the checks in between are left out)
        dts = [(step, (t1 - t0) * 1e3) for (_, t0), (step, t1)
               in zip(stamps[0::2], stamps[1::2])]
        rounds = AXIS_STEPS // AXIS_PERIOD
        out[path] = {
            "launches": launches, "checks": checks, "invariants": report,
            "loss": log.loss[-1], "consensus": log.consensus[-1],
            "local_step_ms_median": statistics.median(
                d for s, d in dts if s % AXIS_PERIOD),
            "comm_step_ms_median": statistics.median(
                d for s, d in dts if s % AXIS_PERIOD == 0),
            "bytes_round_list": trainer.opt.comm_bytes_round_list(
                trainer.opt.params_of(state)),
            "wire_bytes_per_round": sent[0] // rounds,
            "messages_per_round": sent[1] // rounds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(torch.isfinite(state.buf).all())}
        # a block of each dtype to the rank that reads it: digests of what
        # this rank sent and received, held against each other by the
        # parent
        if path == "d-adam":
            digests = {}
            for dt in (torch.float32, torch.int8):
                x = state.buf if dt == torch.float32 else \
                    torch.sign(state.buf).to(dt)
                got = shift_worker(x, 1, K, group, tag=7)
                digests[str(dt)] = [hashlib.sha256(
                    t.cpu().numpy().tobytes()).hexdigest() for t in (x, got)]
            out["digests"] = digests
        if path in AXIS_ELASTIC:
            out[f"elastic-{path}"] = axis_elastic_rank(path, trainer, state,
                                                       log, group)
        del trainer, state, refs
        torch.cuda.empty_cache()
    out["online"] = axis_online_rank(group, params, batches)
    from repro_torch.analysis.check import corpus_axis_reports
    out["corpus"] = corpus_axis_reports(group)
    return out


def phase_axis():
    """comm='axis' on the one card: K=8 ranks spawned in a gloo group
    (every message staged through host memory), the paper's experiment at
    full width on each path of AXIS_PATHS, held against the same path
    stacked on the card, its loss evaluated worker by worker (as a rank
    evaluates it). NCCL, which needs a card per rank, does not run
    here."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, batches = axis_inputs()
    with tempfile.TemporaryDirectory(prefix="smoke_axis_") as folder:
        stacked = axis_stacked_refs(Path(folder), params, batches)
        del params, batches
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        # one torch thread a rank: 8 ranks share the host's cores
        ranks = spawn(axis_rank, K, (folder,), timeout_s=AXIS_SPAWN_TIMEOUT_S,
                      threads=1)
    by_path, gates = {}, []
    for path, spec in AXIS_PATHS.items():
        want = {n: spec["launches"].get(n, 0) for n in ops.launch_counts()}
        recs = [r[path] for r in ranks]
        for rank, rec in enumerate(recs):
            if rec["launches"] != want:
                raise AssertionError(f"axis {path} rank {rank}: launches "
                                     f"{rec['launches']} != {want}")
            if rec["bytes_round_list"] != stacked[path]["bytes_round_list"] \
                    or rec["bytes_round_list"] != WIRE_BYTES[path]:
                raise AssertionError(
                    f"axis {path} rank {rank}: {rec['bytes_round_list']} "
                    f"bytes a round, stacked {stacked[path]}")
            if not rec["finite"]:
                raise AssertionError(f"axis {path} rank {rank}: non-finite")
            if not math.isclose(rec["loss"], stacked[path]["loss"],
                                rel_tol=AXIS_LOSS_RTOL):
                raise AssertionError(
                    f"axis {path} rank {rank}: loss {rec['loss']} against "
                    f"stacked {stacked[path]['loss']}")
        by_path[f"axis-{path}"] = {n: sum(r["launches"][n] for r in recs)
                                   for n in want}
        gates.append(gate_record(f"axis {path}",
                                 [r["invariants"] for r in recs]))
        checks = {n: {"max_abs_err": max(r["checks"][n]["max_abs_err"]
                                         for r in recs),
                      "share_outside": max(r["checks"][n]["share_outside"]
                                           for r in recs)}
                  for n in recs[0]["checks"]}
        emit({"phase": "axis", "path": path, "kind": spec["kind"],
              "config": {"K": K, "period": AXIS_PERIOD, "steps": AXIS_STEPS,
                         **spec["opt"], **FULL,
                         "hidden": list(FULL["hidden"])},
              "transport": ranks[0]["transport"],
              "ranks_device": ranks[0]["device"],
              "nccl": "not run: NCCL needs a card per rank and this "
                      "machine has one",
              "launches_per_rank": recs[0]["launches"],
              "local_step_ms_median_per_rank": [
                  r["local_step_ms_median"] for r in recs],
              "comm_step_ms_median_per_rank": [
                  r["comm_step_ms_median"] for r in recs],
              "bytes_per_worker_per_round": recs[0]["bytes_round_list"],
              "wire_bytes_per_rank_per_round": recs[0][
                  "wire_bytes_per_round"],
              "messages_per_rank_per_round": recs[0]["messages_per_round"],
              "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in recs],
              "loss": recs[0]["loss"], "loss_stacked": stacked[path]["loss"],
              "loss_stacked_batched": stacked[path]["loss_batched"],
              "stacked_batched_vs_per_worker": stacked[path][
                  "batched_vs_per_worker"],
              "consensus": recs[0]["consensus"],
              "consensus_stacked": stacked[path]["consensus"],
              "checks": checks, "tol": CARD_CPU_TOL,
              "max_share_outside": CARD_CPU_MAX_SHARE,
              "loss_rtol": AXIS_LOSS_RTOL})
    for dt in ranks[0]["digests"]:
        for k in range(K):
            sent = ranks[(k + 1) % K]["digests"][dt][0]
            if ranks[k]["digests"][dt][1] != sent:
                raise AssertionError(f"axis: rank {k} received a {dt} block "
                                     f"not equal to the bit to its sender's")
    by_path.update(axis_elastic_checks(ranks, stacked, gates))
    by_path["axis-online"] = axis_online_checks(ranks, stacked["d-adam"])
    emit({"phase": "axis_exchange", "blocks_equal_to_the_bit":
          sorted(ranks[0]["digests"]), "ranks": K,
          "stacked_reference_s": t_ref,
          "seconds": time.perf_counter() - t0})
    return by_path, gates, [r["corpus"] for r in ranks]


def axis_elastic_checks(ranks, stacked, gates: list) -> dict:
    """Each elastic plan's memberships against the stacked run: exact
    launches on every rank (none outside the membership), every member's
    bit sums right after the resize and after each step equal to its
    rows', cold ages and hats at zero, the count kept, the loss, the
    members' invariant reports of the steps (their records appended to
    ``gates``); one record per plan. Returns the launches summed over the
    ranks."""
    from repro_torch.core.dadam import COLD_AGE
    from repro_torch.kernels import ops

    by_path = {}
    for path, plan in AXIS_ELASTIC.items():
        segs_ref = stacked[path]["elastic"]
        rec_segs = []
        total = collections.Counter()
        for i, (k_new, strategy) in enumerate(plan):
            ref = segs_ref[i]
            segs = [r[f"elastic-{path}"][i] for r in ranks]
            for rank, seg in enumerate(segs):
                what = f"axis_elastic {path} K={k_new} rank {rank}"
                member = rank < k_new
                want = {n: (AXIS_ELASTIC_LAUNCHES[path].get(n, 0) if member
                            else 0) for n in ops.launch_counts()}
                if seg["member"] != member or seg["launches"] != want:
                    raise AssertionError(f"{what}: member {seg['member']}, "
                                         f"launches {seg['launches']} != "
                                         f"{want}")
                total.update(seg["launches"])
                if not member:
                    continue
                if seg["after"] != ref["after"][rank]:
                    raise AssertionError(f"{what}: the resized buffers are "
                                         "not its rows of the stacked "
                                         "resize, to the bit")
                for t, (got, want_t) in enumerate(zip(seg["steps"],
                                                      ref["steps"])):
                    if got != want_t[rank]:
                        raise AssertionError(
                            f"{what}: step {t + 1} buffers not equal to the "
                            "bit to the stacked run's")
                if seg["block"] != [1] + list(SHAPE[1:]) or \
                        seg["count"] != AXIS_STEPS + i * AXIS_ELASTIC_STEPS:
                    raise AssertionError(f"{what}: block {seg['block']}, "
                                         f"count {seg['count']}")
                if seg["ages"] is not None and \
                        any(a != COLD_AGE for row in seg["ages"] for a in row):
                    raise AssertionError(f"{what}: ages {seg['ages']}")
                if seg["hats_zero"] is False:
                    raise AssertionError(f"{what}: hats not zero")
                if not seg["finite"] or not math.isclose(
                        seg["loss"], ref["loss"], rel_tol=AXIS_LOSS_RTOL):
                    raise AssertionError(f"{what}: loss {seg['loss']} "
                                         f"against {ref['loss']}")
            members = [s for s in segs if s["member"]]
            gates.append(gate_record(f"axis_elastic {path} K={k_new}",
                                     [s["invariants"] for s in members]))
            rec_segs.append({
                "K": k_new, "strategy": strategy,
                "leavers_or_spares": [r for r, s in enumerate(segs)
                                      if not s["member"]],
                "block_per_rank": members[0]["block"],
                "count": members[0]["count"], "ages": members[0]["ages"],
                "hats_zero": members[0]["hats_zero"],
                "steps_equal_to_the_bit": len(ref["steps"]),
                "resize_s_per_rank": [s["resize_s"] for s in segs],
                "resize_bytes_sent_per_rank": [s["resize_bytes"]["bytes"]
                                               for s in segs],
                "step_ms_per_rank": [s["step_ms"] for s in members],
                "launches_per_member": members[0]["launches"],
                "loss": members[0]["loss"], "loss_stacked": ref["loss"]})
        emit({"phase": "axis_elastic", "path": path,
              "kind": AXIS_PATHS[path]["kind"],
              "config": {"K": K, "period": AXIS_PERIOD,
                         "steps_per_membership": AXIS_ELASTIC_STEPS,
                         **AXIS_PATHS[path]["opt"]},
              "transport": ranks[0]["transport"],
              "memberships": rec_segs,
              "held_to": "the same plan stacked on the card, its loss "
                         "worker by worker: bit_sums of buf, m and v"})
        by_path[f"axis-elastic-{path}"] = dict(total)
    return by_path


def axis_online_checks(ranks, ref) -> dict:
    """``train_online`` under axis against the stacked run's publishes:
    the history, every published tree's bit sums on every rank, the
    worker publish, the launches; the held-out AUC of each version (of
    the stacked run's trees, equal to the bit). Returns the launches
    summed over the ranks."""
    from repro_torch.data.synthetic import ctr_teacher, make_ctr_task
    from repro_torch.kernels import ops
    from repro_torch.launch import deepfm_ctr
    from repro_torch.models.deepfm import deepfm_logits

    steps = [p["step"] for p in ref["published"]]
    want_hist = [(s, i + 1) for i, s in enumerate(steps)]
    total = collections.Counter()
    for rank, r in enumerate(ranks):
        rec = r["online"]
        want = {n: AXIS_ONLINE_LAUNCHES.get(n, 0) for n in ops.launch_counts()}
        what = f"axis_online rank {rank}"
        if rec["launches"] != want:
            raise AssertionError(f"{what}: launches {rec['launches']}")
        if [tuple(p) for p in rec["published"]] != want_hist:
            raise AssertionError(f"{what}: published {rec['published']}")
        if rec["sums"] != [p["sums"] for p in ref["published"]] or \
                rec["worker_sums"] != ref["worker_sums"]:
            raise AssertionError(f"{what}: a published tree is not the "
                                 "stacked run's, to the bit")
        total.update(rec["launches"])
    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, DEVICE)
    aucs = {v + 1: deepfm_ctr.heldout_auc(teacher, p["params"],
                                          deepfm_logits)
            for v, p in enumerate(ref["published"])}
    emit({"phase": "axis_online", "K": K, "steps": AXIS_STEPS,
          "publish_every": AXIS_ONLINE_EVERY, "mode": "mean",
          "published": want_hist, "worker_publish": AXIS_ONLINE_WORKER,
          "trees_equal_to_the_bit_on_every_rank_and_to_stacked": True,
          "auc_by_version": aucs,
          "publish_ms_per_rank": [r["online"]["publish_ms"] for r in ranks],
          "launches_per_rank": ranks[0]["online"]["launches"],
          "loss": ranks[0]["online"]["loss"]})
    return dict(total)


def axis2d_spec(spec1, M: int):
    """The row-sharded layout (``row_shards=M``) of the tree of
    ``spec1``'s shapes."""
    from repro_torch._tree import tree_unflatten
    from repro_torch.kernels import pack as packing

    like = tree_unflatten(spec1.treedef, [
        torch.empty(shape, dtype=dt, device="meta")
        for shape, dt in zip(spec1.shapes, spec1.dtypes)])
    return packing.make_spec(like, stacked=True,
                             block_rows=packing.BLOCK_ROWS, leaf_align=True,
                             row_shards=M)


def axis2d_trainer(path: str, group=None):
    """The 2D phase's trainer of ``path``: stacked over AXIS2D_K workers
    on the card without ``group``, its loss worker by worker (as a rank
    evaluates it); else this rank's, on a 2D group."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.models.deepfm import deepfm_loss
    from repro_torch.train.damping import DampingConfig
    from repro_torch.train.loop import DecentralizedTrainer

    spec = AXIS2D_PATHS[path]
    where = (dict(device=DEVICE) if group is None
             else dict(comm="axis", group=group))
    opt = make_optimizer(spec["kind"], AXIS2D_K, eta=ETA,
                         period=AXIS_PERIOD, backend="packed", **where,
                         **spec["opt"])
    damping = spec.get("damping")
    return DecentralizedTrainer(
        per_worker_deepfm_loss if group is None else deepfm_loss, opt,
        damping=DampingConfig(**damping) if damping else None)


def mlp2d_inputs():
    """The sharded-packed runs' init and batches, from seeds on the CPU."""
    c = AXIS2D_MLP
    gen = torch.Generator().manual_seed(3)
    params = {"bias": torch.zeros(c["d_out"]),
              "w": torch.randn(c["d_in"], c["d_out"], generator=gen) * 0.02}
    batches = [{"x": torch.randn(AXIS2D_K, c["per_worker"], c["d_in"],
                                 generator=gen),
                "y": torch.randn(AXIS2D_K, c["per_worker"], c["d_out"],
                                 generator=gen)}
               for _ in range(c["steps"])]
    return params, batches


def mlp_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["bias"]
    return torch.mean((pred - batch["y"]) ** 2)


def sharded_mlp_loss(chunks, batch, ctx):
    """``mlp_loss`` from a rank's block: the weight's rows by
    ``row_parallel_dot``, the bias (leaf 0) by ``full_leaf``."""
    from repro_torch.train.grad import row_parallel_dot

    h = row_parallel_dot(batch["x"], chunks["w"], batch["y"].shape[-1], ctx)
    pred = h + ctx.full_leaf(chunks["bias"], 0)
    return torch.mean((pred - batch["y"]) ** 2)


def mlp2d_trainer(kind: str, group=None):
    from repro_torch.core.api import make_optimizer
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    where = (dict(device=DEVICE) if group is None
             else dict(comm="axis", group=group))
    opt = make_optimizer(kind, AXIS2D_K, eta=ETA,
                         period=AXIS2D_MLP["period"], backend="packed",
                         **where, **(CD_ADAM if kind == "cd-adam" else {}))
    return DecentralizedTrainer(
        stacked_loss(mlp_loss), opt,
        sharded_loss=None if group is None else sharded_mlp_loss)


def axis2d_refs(folder: Path) -> dict:
    """Each path stacked on the card over AXIS2D_K workers, its loss
    worker by worker: its buffers at the snapshot steps repacked into the
    2D layout, each rank's block written to ``<folder>/<path>-<rank>.pt``;
    the sharded-packed runs' stacked twins' final params likewise. Returns
    each path's last loss, consensus, evaluations and bytes per round."""
    from repro_torch.kernels import pack as packing

    params, batches = axis_inputs(AXIS2D_K)
    out = {}
    for path in AXIS2D_PATHS:
        trainer = axis2d_trainer(path)
        snaps = {}

        def hook(step, st):
            if step in AXIS_SNAPSHOTS:
                snaps.update(axis_snapshot(st, step))

        state, log = trainer.fit(trainer.init(params), iter(batches),
                                 AXIS_STEPS, log_every=AXIS_STEPS, hook=hook,
                                 hook_every=1)
        spec2 = axis2d_spec(state.spec, AXIS2D_M)
        rows = spec2.local_rows
        blocks = {n: packing.pack(packing.unpack(x, state.spec), spec2)
                  for n, x in snaps.items()}
        for w in range(AXIS2D_K):
            for m in range(AXIS2D_M):
                torch.save({n: x[w:w + 1, m * rows:(m + 1) * rows].to(
                    "cpu", copy=True) for n, x in blocks.items()},
                    folder / f"{path}-{w * AXIS2D_M + m}.pt")
        out[path] = {"loss": log.loss[-1], "consensus": log.consensus[-1],
                     "evals": log.grad_evals[-1],
                     "bytes_round_list": trainer.opt.comm_bytes_round_list(
                         trainer.opt.params_of(state))}
        if path == "d-adam":
            out["elastic"] = axis2d_elastic_stacked(trainer, state, log)
        del trainer, state, snaps, blocks
        torch.cuda.empty_cache()
    mparams, mbatches = mlp2d_inputs()
    for kind in ("d-adam", "cd-adam"):
        trainer = mlp2d_trainer(kind)
        state, _ = trainer.fit(trainer.init(mparams), iter(mbatches),
                               AXIS2D_MLP["steps"],
                               log_every=AXIS2D_MLP["steps"])
        torch.save({n: x.to("cpu", copy=True) for n, x in
                    trainer.opt.params_of(state).items()},
                   folder / f"mlp-{kind}.pt")
        del trainer, state
    return out


def axis2d_block_sums(state, M: int) -> list:
    """bit_sums of every (worker, model block) of a stacked packed state's
    buffers, repacked into the row-sharded layout of M shards: entry
    ``w M + m`` is what global rank w M + m holds under (K, M)."""
    from repro_torch.kernels import pack as packing

    packed = {}
    for n, spec in (("buf", state.spec), ("m", state.spec_m),
                    ("v", state.spec_m)):
        spec2 = axis2d_spec(spec, M)
        packed[n] = (packing.pack(packing.unpack(getattr(state, n), spec),
                                  spec2), spec2.local_rows)
    return [{n: bit_sums(x[w:w + 1, m * rows:(m + 1) * rows])
             for n, (x, rows) in packed.items()}
            for w in range(state.buf.shape[0]) for m in range(M)]


def axis2d_elastic_stacked(trainer, state, log) -> dict:
    """The 2D elastic plan stacked on the card (AXIS2D_ELASTIC): the K=4
    D-Adam state resized to K=2, the blocks' bit sums in the (2, 4)
    layout right after and after each step, and the mean publish's."""
    from repro_torch._tree import tree_leaves
    from repro_torch.serve.publish import publish_params

    E = AXIS2D_ELASTIC
    state = trainer.resize(state, trainer.opt.rebuild(K=E["K"]),
                           strategy=E["strategy"])
    rec = {"after": axis2d_block_sums(state, E["M"]), "steps": []}
    state, log = trainer.fit(
        state, iter(axis_elastic_batches(E["K"], 9)), E["steps"],
        log_every=E["steps"], log=log,
        hook=lambda step, st: rec["steps"].append(
            axis2d_block_sums(st, E["M"])), hook_every=1)
    rec["published"] = [bit_sums(x) for x in tree_leaves(
        publish_params(state, mode="mean"))]
    rec["loss"] = log.loss[-1]
    return rec


def axis2d_elastic_rank(trainer, state, log, group) -> dict:
    """This rank's part of AXIS2D_ELASTIC: a new group of (2, 4) over the
    world, ``trainer.resize`` by clone, ``share_log``, the steps and one
    mean publish; the resize's seconds and bytes, the block's bit sums
    right after and after each step, the publish's, the launches."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.api import make_optimizer
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_group
    from repro_torch.serve.publish import publish_params

    E = AXIS2D_ELASTIC
    new = make_worker_group(E["K"], device=DEVICE, backend="gloo",
                            timeout_s=AXIS_GROUP_TIMEOUT_S,
                            model_parallel=E["M"])
    opt = make_optimizer("d-adam", E["K"], eta=ETA, period=AXIS_PERIOD,
                         backend="packed", comm="axis", group=new)
    torch.cuda.synchronize()
    ops.reset_launches()
    group.reset_counts()
    t0 = time.perf_counter()
    state = trainer.resize(state, opt, strategy=E["strategy"], group=group)
    torch.cuda.synchronize()
    rec = {"member": new.member, "worker": new.rank,
           "model_rank": new.model_rank,
           "resize_s": time.perf_counter() - t0,
           "resize_bytes": group.collective_summary()["resize"],
           "block": list(state.buf.shape), "rows": state.spec.rows,
           "row_shards": state.spec.row_shards, "count": state.count,
           "after": {n: bit_sums(getattr(state, n)) for n in BUFS},
           "steps": []}
    log = trainer.share_log(log)
    (state, log), rec["invariants"] = gated_fit(
        "axis2d_elastic (2, 4)", trainer, state, new, E["steps"],
        AXIS2D_ELASTIC_LAUNCHES,
        lambda: trainer.fit(
            state, iter(axis_elastic_batches(E["K"], 9)), E["steps"],
            log_every=E["steps"], log=log,
            hook=lambda step, st: rec["steps"].append(
                {n: bit_sums(getattr(st, n)) for n in BUFS}),
            hook_every=1))
    _, rec["publish_ms"] = synced(lambda: publish_params(
        state, mode="mean", group=new))
    rec["published"] = [bit_sums(x) for x in tree_leaves(
        publish_params(state, mode="mean", group=new))]
    rec["launches"] = ops.launch_counts()
    rec["loss"] = log.loss[-1]
    return rec


def flip_budget(d: torch.Tensor) -> dict:
    """The JAX package's budget for a CD-Adam run whose products sum in
    another order (``test_sharded_equals_unpack_equals_reference``)."""
    rec = {"mean_abs_err": float(d.mean()),
           "share_past_1e-3": float((d > 1e-3).double().mean()),
           "max_abs_err": float(d.max())}
    if rec["mean_abs_err"] >= 1e-4 or rec["share_past_1e-3"] >= 0.01 \
            or rec["max_abs_err"] >= 0.1:
        raise AssertionError(f"sharded CD-Adam past the flip budget: {rec}")
    return rec


def axis2d_rank(rank: int, init_method: str, folder: str):
    """One rank of the 2D phase: every path of AXIS2D_PATHS through
    ``make_optimizer(comm='axis')`` on a 2D group and
    ``DecentralizedTrainer.fit`` on cuda:0; then the sharded-packed runs.
    Returns its launches, collectives, step times, bytes, peak memory,
    last loss, its buffers' checks against its block of the stacked run,
    and digests of the scales and blocks it sent and received."""
    import functools
    import hashlib

    from repro_torch.core.dadam import shift_worker
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as packing
    from repro_torch.launch.mesh import make_worker_group, model_sum

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = make_worker_group(AXIS2D_K, init_method=init_method,
                              device=DEVICE, backend="gloo",
                              timeout_s=AXIS_GROUP_TIMEOUT_S,
                              model_parallel=AXIS2D_M)
    params, batches = axis_inputs(AXIS2D_K)
    out = {"transport": group.transport, "device": str(group.device),
           "worker": group.rank, "model_rank": group.model_rank}
    rounds = AXIS_STEPS // AXIS_PERIOD
    for path in AXIS2D_PATHS:
        refs = torch.load(Path(folder) / f"{path}-{rank}.pt")
        trainer = axis2d_trainer(path, group)
        state = trainer.init(params)
        checks, stamps = {}, []

        def hook(step, st):
            torch.cuda.synchronize()
            stamps.append((step, time.perf_counter()))
            if step in AXIS_SNAPSHOTS:
                for n, x in axis_snapshot(st, step).items():
                    checks[n] = axis_check(n, x, refs[n].to(x.device))
            torch.cuda.synchronize()
            stamps.append((step, time.perf_counter()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        stamps.append((0, time.perf_counter()))
        (state, log), report = gated_fit(
            f"axis2d {path}", trainer, state, group, AXIS_STEPS,
            AXIS2D_PATHS[path]["launches"],
            lambda: trainer.fit(state, iter(batches), AXIS_STEPS,
                                log_every=AXIS_STEPS, hook=hook,
                                hook_every=1))
        launches = ops.launch_counts()
        coll = group.collective_summary()
        dts = [(step, (t1 - t0) * 1e3) for (_, t0), (step, t1)
               in zip(stamps[0::2], stamps[1::2])]
        rec = {"launches": launches, "checks": checks, "collectives": coll,
               "invariants": report,
               "loss": log.loss[-1], "consensus": log.consensus[-1],
               "evals": log.grad_evals[-1],
               "block": list(state.buf.shape), "rows": state.spec.rows,
               "local_step_ms_median": statistics.median(
                   d for s, d in dts if s % AXIS_PERIOD),
               "comm_step_ms_median": statistics.median(
                   d for s, d in dts if s % AXIS_PERIOD == 0),
               "bytes_round_list": trainer.opt.comm_bytes_round_list(
                   trainer._params_like(state)),
               "wire_bytes_per_round": coll["exchange"]["bytes"] // rounds,
               "messages_per_round": coll["exchange"]["count"] // rounds,
               "model_all_gathers_per_step":
                   coll["model_all_gather"]["count"] / AXIS_STEPS,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "finite": bool(torch.isfinite(state.buf).all())}
        if path == "cd-adam":
            # the scales every rank of the worker applies and sends
            _, scales, _ = ops.sign_compress_stacked(
                state.buf, state.hat_buf, n_true=state.spec.sizes,
                row_ranges=packing.leaf_row_ranges(state.spec),
                reduce_axis=functools.partial(model_sum, wg=group))
            rec["scales_digest"] = digest(scales)
        if path == "d-adam":
            # a block of each dtype to the rank of the same model index
            # that reads it: digests of what was sent and received
            rec["digests"] = {}
            for dt in (torch.float32, torch.int8):
                x = state.buf if dt == torch.float32 else \
                    torch.sign(state.buf).to(dt)
                got = shift_worker(x, 1, AXIS2D_K, group, tag=7)
                rec["digests"][str(dt)] = [digest(x), digest(got)]
            # the elastic plan goes on from this state, after the path's
            # launches were read
            out["elastic"] = axis2d_elastic_rank(trainer, state, log, group)
        out[path] = rec
        del trainer, state, refs
        torch.cuda.empty_cache()
    mparams, mbatches = mlp2d_inputs()
    for kind in ("d-adam", "cd-adam"):
        want = torch.load(Path(folder) / f"mlp-{kind}.pt")
        trainer = mlp2d_trainer(kind, group)
        state = trainer.init(mparams)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, log), report = gated_fit(
            f"axis2d sharded-packed mlp {kind}", trainer, state, group,
            AXIS2D_MLP["steps"], AXIS2D_MLP_LAUNCHES[kind],
            lambda: trainer.fit(state, iter(mbatches), AXIS2D_MLP["steps"],
                                log_every=AXIS2D_MLP["steps"]),
            activation_bytes=4 * AXIS2D_MLP["per_worker"]
            * AXIS2D_MLP["d_out"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, coll = ops.launch_counts(), group.collective_summary()
        got = trainer.opt.params_of(state)
        w = group.rank
        rec = {"mode": trainer.pipeline.mode, "launches": launches,
               "collectives": coll, "invariants": report,
               "loss": log.loss[-1],
               "step_ms_mean": wall / AXIS2D_MLP["steps"] * 1e3}
        for n in ("bias", "w"):
            a, b = got[n][0], want[n][w].to(got[n].device)
            if kind == "cd-adam":
                rec[n] = flip_budget((a.double() - b.double()).abs())
            else:
                rec[n] = step3_check(f"axis2d mlp {n}", a, b)
        out[f"mlp-{kind}"] = rec
        del trainer, state, want
    return out


def phase_axis2d():
    """comm='axis' with the 2D worker x model layout on the one card:
    AXIS2D_K x AXIS2D_M ranks spawned in a gloo group (host-staged), the
    paper's experiment at full width on each path of AXIS2D_PATHS held
    against the same path stacked on the card (its loss worker by
    worker), the sharded-packed mode at AXIS2D_MLP's widths, digests of
    the scales and blocks, and the training CLI's run at --model-parallel
    2 (its sharding plan) against 1, at f32 compute. NCCL, which needs a
    card per rank, does not run here."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks_n = AXIS2D_K * AXIS2D_M
    with tempfile.TemporaryDirectory(prefix="smoke_axis2d_") as folder:
        stacked = axis2d_refs(Path(folder))
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        ranks = spawn(axis2d_rank, ranks_n, (folder,),
                      timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=1)
    t_ranks = time.perf_counter() - t0 - t_ref
    by_path, gates = {}, []
    for path, spec in AXIS2D_PATHS.items():
        want = {n: spec["launches"].get(n, 0) for n in ops.launch_counts()}
        recs = [r[path] for r in ranks]
        for rank, rec in enumerate(recs):
            what = f"axis2d {path} rank {rank}"
            if rec["launches"] != want:
                raise AssertionError(f"{what}: launches {rec['launches']} "
                                     f"!= {want}")
            if rec["bytes_round_list"] != stacked[path]["bytes_round_list"] \
                    or rec["bytes_round_list"] != WIRE_BYTES[path.split(
                        "-adadamp")[0]]:
                raise AssertionError(
                    f"{what}: {rec['bytes_round_list']} bytes a round, "
                    f"stacked {stacked[path]['bytes_round_list']}")
            if rec["block"] != [1, rec["rows"] // AXIS2D_M, 128]:
                raise AssertionError(f"{what}: block {rec['block']}")
            if rec["model_all_gathers_per_step"] != 1:
                raise AssertionError(
                    f"{what}: {rec['model_all_gathers_per_step']} model "
                    "all-gathers a step, not 1")
            if rec["evals"] != stacked[path]["evals"]:
                raise AssertionError(f"{what}: {rec['evals']} evaluations, "
                                     f"stacked {stacked[path]['evals']}")
            if not rec["finite"]:
                raise AssertionError(f"{what}: non-finite")
            if not math.isclose(rec["loss"], stacked[path]["loss"],
                                rel_tol=AXIS_LOSS_RTOL):
                raise AssertionError(
                    f"{what}: loss {rec['loss']} against stacked "
                    f"{stacked[path]['loss']}")
        by_path[f"axis2d-{path}"] = {n: sum(r["launches"][n] for r in recs)
                                     for n in want}
        gates.append(gate_record(f"axis2d {path}",
                                 [r["invariants"] for r in recs]))
        checks = {n: {"max_abs_err": max(r["checks"][n]["max_abs_err"]
                                         for r in recs),
                      "share_outside": max(r["checks"][n]["share_outside"]
                                           for r in recs)}
                  for n in recs[0]["checks"]}
        emit({"phase": "axis2d", "path": path, "kind": spec["kind"],
              "config": {"K": AXIS2D_K, "M": AXIS2D_M,
                         "period": AXIS_PERIOD, "steps": AXIS_STEPS,
                         **spec["opt"], **FULL,
                         "hidden": list(FULL["hidden"]),
                         **({"damping": spec["damping"]}
                            if "damping" in spec else {})},
              "grad_mode": "packed (the worker's blocks all-gathered once a "
                           "step)",
              "transport": ranks[0]["transport"],
              "ranks_device": ranks[0]["device"],
              "nccl": "not run: NCCL needs a card per rank and this "
                      "machine has one",
              "block_per_rank": recs[0]["block"],
              "launches_per_rank": recs[0]["launches"],
              "local_step_ms_median_per_rank": [
                  r["local_step_ms_median"] for r in recs],
              "comm_step_ms_median_per_rank": [
                  r["comm_step_ms_median"] for r in recs],
              "bytes_per_worker_per_round": recs[0]["bytes_round_list"],
              "wire_bytes_per_rank_per_round": [
                  r["wire_bytes_per_round"] for r in recs],
              "messages_per_rank_per_round": recs[0]["messages_per_round"],
              "model_all_gathers_per_step": recs[0][
                  "model_all_gathers_per_step"],
              "collectives_per_rank_rank0": recs[0]["collectives"],
              "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in recs],
              "evals": recs[0]["evals"],
              "loss": recs[0]["loss"], "loss_stacked": stacked[path]["loss"],
              "consensus": recs[0]["consensus"],
              "consensus_stacked": stacked[path]["consensus"],
              "checks": checks, "tol": CARD_CPU_TOL,
              "max_share_outside": CARD_CPU_MAX_SHARE,
              "loss_rtol": AXIS_LOSS_RTOL})
    for kind in ("d-adam", "cd-adam"):
        recs = [r[f"mlp-{kind}"] for r in ranks]
        for rank, rec in enumerate(recs):
            coll = rec["collectives"]
            if rec["mode"] != "sharded-packed" \
                    or coll["model_all_gather"]["count"] != 0:
                raise AssertionError(
                    f"axis2d mlp {kind} rank {rank}: mode {rec['mode']}, "
                    f"{coll['model_all_gather']['count']} model all-gathers")
        by_path[f"axis2d-mlp-{kind}"] = {
            n: sum(r["launches"][n] for r in recs)
            for n in ops.launch_counts()}
        gates.append(gate_record(f"axis2d sharded-packed mlp {kind}",
                                 [r["invariants"] for r in recs]))
        emit({"phase": "axis2d", "path": f"sharded-packed mlp {kind}",
              "config": {"K": AXIS2D_K, "M": AXIS2D_M, **AXIS2D_MLP,
                         **(CD_ADAM if kind == "cd-adam" else {})},
              "mode": recs[0]["mode"],
              "launches_per_rank": recs[0]["launches"],
              "collectives_rank0": recs[0]["collectives"],
              "step_ms_mean_per_rank": [r["step_ms_mean"] for r in recs],
              "loss": recs[0]["loss"],
              "params_against_stacked": {
                  n: {k: max(r[n][k] for r in recs) for k in recs[0][n]}
                  for n in ("bias", "w")}})
    # every rank of a worker holds CD-Adam's scales to the bit; every
    # block received is its sender's
    M = AXIS2D_M
    for w in range(AXIS2D_K):
        got = {ranks[w * M + m]["cd-adam"]["scales_digest"]
               for m in range(M)}
        if len(got) != 1:
            raise AssertionError(f"axis2d: worker {w}'s ranks hold "
                                 f"{len(got)} different scales")
    for dt in ranks[0]["d-adam"]["digests"]:
        for r in range(ranks_n):
            w, m = divmod(r, M)
            sender = ranks[((w + 1) % AXIS2D_K) * M + m]
            if ranks[r]["d-adam"]["digests"][dt][1] != \
                    sender["d-adam"]["digests"][dt][0]:
                raise AssertionError(f"axis2d: rank {r} received a {dt} "
                                     "block not equal to the bit to its "
                                     "sender's")
    by_path["axis2d-elastic"] = axis2d_elastic_checks(ranks,
                                                      stacked["elastic"])
    gates.append(gate_record("axis2d_elastic (2, 4)",
                             [r["elastic"]["invariants"] for r in ranks]))
    t_cli = time.perf_counter()
    cli = {m: spawn(axis2d_cli_f32_rank, 2 * m,
                    (AXIS2D_CLI + ["--model-parallel", str(m)],),
                    timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=1)[0]
           for m in (1, 2)}
    if cli[2]["mode"] != "planned":
        raise AssertionError(f"axis2d CLI: mode {cli[2]['mode']}")
    for a, b in zip(cli[2]["loss"], cli[1]["loss"]):
        if not math.isclose(a, b, rel_tol=AXIS_LOSS_RTOL):
            raise AssertionError(f"axis2d CLI: --model-parallel 2 losses "
                                 f"{cli[2]['loss']} against 1's "
                                 f"{cli[1]['loss']}")
    emit({"phase": "axis2d_exchange",
          "scales_equal_across_each_model_group": True,
          "blocks_equal_to_the_bit": sorted(ranks[0]["d-adam"]["digests"]),
          "ranks": ranks_n,
          "cli": {"argv": AXIS2D_CLI, "compute": "float32",
                  "losses_model_parallel_1": cli[1]["loss"],
                  "losses_model_parallel_2": cli[2]["loss"],
                  "mode_model_parallel_2": cli[2]["mode"],
                  "seconds": time.perf_counter() - t_cli},
          "stacked_reference_s": t_ref, "ranks_s": t_ranks,
          "seconds": time.perf_counter() - t0})
    return by_path, gates


def axis2d_cli_f32_rank(rank: int, init_method: str, argv: list) -> dict:
    """One rank of the training CLI's run (``launch.train._run``, what
    ``main`` spawns) with the reduced configs at f32 compute."""
    from repro_torch.launch import train as cli

    reduced = cli.get_reduced
    cli.get_reduced = lambda arch_id: dataclasses.replace(
        reduced(arch_id), model=dataclasses.replace(
            reduced(arch_id).model, compute_dtype=torch.float32))
    run = cli._run(cli.parser().parse_args(argv), init_method=init_method)
    return {"loss": list(run.log.loss),
            "mode": run.trainer.pipeline.mode}


def axis2d_elastic_checks(ranks, ref) -> dict:
    """The 2D elastic plan against the stacked run: exact launches, every
    rank's block right after the resize and after each step equal to the
    bit to its block of the stacked run in the (2, 4) layout, the mean
    publish likewise, the count kept. Returns the launches summed over
    the ranks."""
    from repro_torch.kernels import ops

    E = AXIS2D_ELASTIC
    total = collections.Counter()
    recs = [r["elastic"] for r in ranks]
    for rank, rec in enumerate(recs):
        what = f"axis2d_elastic rank {rank}"
        want = {n: AXIS2D_ELASTIC_LAUNCHES.get(n, 0)
                for n in ops.launch_counts()}
        if rec["launches"] != want:
            raise AssertionError(f"{what}: launches {rec['launches']}")
        if (rec["worker"], rec["model_rank"]) != divmod(rank, E["M"]) or \
                rec["row_shards"] != E["M"] or \
                rec["block"] != [1, rec["rows"] // E["M"], 128] or \
                rec["count"] != AXIS_STEPS:
            raise AssertionError(f"{what}: worker {rec['worker']}, block "
                                 f"{rec['block']}, count {rec['count']}")
        if rec["after"] != ref["after"][rank]:
            raise AssertionError(f"{what}: the resized block is not its "
                                 "block of the stacked resize, to the bit")
        for t, (got, want_t) in enumerate(zip(rec["steps"], ref["steps"])):
            if got != want_t[rank]:
                raise AssertionError(f"{what}: step {t + 1} block not equal "
                                     "to the bit to the stacked run's")
        if rec["published"] != ref["published"]:
            raise AssertionError(f"{what}: the mean publish is not the "
                                 "stacked run's, to the bit")
        total.update(rec["launches"])
    emit({"phase": "axis2d_elastic",
          "from": {"K": AXIS2D_K, "M": AXIS2D_M}, "to": E,
          "block_per_rank": recs[0]["block"], "count": recs[0]["count"],
          "steps_equal_to_the_bit": len(ref["steps"]),
          "publish_equal_to_the_bit": True,
          "resize_s_per_rank": [r["resize_s"] for r in recs],
          "resize_bytes_sent_per_rank": [r["resize_bytes"]["bytes"]
                                         for r in recs],
          "publish_ms_per_rank": [r["publish_ms"] for r in recs],
          "launches_per_rank": recs[0]["launches"],
          "loss": recs[0]["loss"], "loss_stacked": ref["loss"]})
    return dict(total)


def axis2d_plan_rank(rank: int, init_method: str, argv: list,
                     route: str) -> dict:
    """One rank of the training CLI's run (``launch.train._run``, what
    ``main`` spawns) at ``argv``, held to PLAN_RANK_SHARE of the card:
    ``route`` 'plan' as the CLI builds it, 'allgather' with the plan left
    out (the packed 2D route that gathers the worker's whole buffer a
    step). The rank's losses, step times (each step a fit call whose log
    point reads the device), peak, collectives, launches and block; an
    out-of-memory error comes back as the record's ``oom``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli

    torch.cuda.set_per_process_memory_fraction(PLAN_RANK_SHARE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    if route == "allgather":
        cli.make_plan = lambda *a, **k: None
    try:
        run = cli._run(cli.parser().parse_args(argv),
                       init_method=init_method)
    except torch.OutOfMemoryError as e:
        return {"oom": str(e).splitlines()[0],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.synchronize()
    group, log = run.trainer.opt.group, run.log
    walls = [0.0] + list(log.wall_s)
    step_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
    return {"mode": run.trainer.pipeline.mode, "loss": list(log.loss),
            "step_ms": step_ms,
            "local_step_ms_median": statistics.median(
                d for c, d in zip(log.step, step_ms) if c % PLAN_PERIOD),
            "comm_step_ms_median": statistics.median(
                d for c, d in zip(log.step, step_ms)
                if c % PLAN_PERIOD == 0),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "collectives": group.collective_summary(),
            "launches": ops.launch_counts(),
            "block": list(run.state.buf.shape),
            "finite": bool(torch.isfinite(run.state.buf).all()),
            "worker": group.rank, "model_rank": group.model_rank,
            "transport": group.transport}


def plan_card_cpu_rank(rank: int, init_method: str, archs) -> dict:
    """Card against CPU for the planned route: on this rank's card group
    and CPU group (both K=2 x M=2 over the one world), each reduced dense
    config of ``archs`` at f32 compute trained PLAN_CARD_CPU_STEPS planned
    steps from one init and one batch stream; then the invariant gate of
    ``analysis.check``'s planned config (the reduced llama, one period)
    on the card group."""
    from repro_torch._tree import tree_map
    from repro_torch.analysis import check
    from repro_torch.configs import get_reduced
    from repro_torch.core.api import make_optimizer
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_group
    from repro_torch.launch.shardings import make_plan
    from repro_torch.launch.train import make_batch_iter
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    groups = {dev: make_worker_group(
        PLAN_K, model_parallel=PLAN_M, init_method=init_method, rank=rank,
        device=dev, backend="gloo", timeout_s=AXIS_GROUP_TIMEOUT_S)
        for dev in ("cuda", "cpu")}
    out = {}
    for arch_id in archs:
        arch = get_reduced(arch_id)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, compute_dtype=torch.float32))
        api = build_model(arch.model)
        params = api.init(torch.Generator().manual_seed(0))
        res = {}
        for dev, g in groups.items():
            ops.reset_launches()
            opt = make_optimizer("d-adam", PLAN_K, backend="packed",
                                 comm="axis", group=g, eta=LM_ETA,
                                 period=PLAN_PERIOD)
            trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                           plan=make_plan(arch, g))
            state = trainer.init(tree_map(lambda x: x.to(g.device),
                                          params))
            it = make_batch_iter(arch.model, PLAN_K, 2, 16, 0.5,
                                 torch.device("cpu"))
            state, log = trainer.fit(state, it, PLAN_CARD_CPU_STEPS,
                                     log_every=1)
            res[dev] = (log.loss, state.buf.cpu(), ops.launch_counts(),
                        trainer.pipeline.mode)
        card, cpu = res["cuda"], res["cpu"]
        out[arch_id] = {
            "losses": card[0], "losses_cpu": cpu[0], "mode": card[3],
            "launches": card[2],
            "step1": compare(
                [torch.tensor(card[0][0])], [torch.tensor(cpu[0][0])],
                LM_STEP1_TOL, f"axis2d_plan card vs CPU {arch_id} step 1"),
            "blocks": step3_check(f"axis2d_plan card vs CPU {arch_id}",
                                  card[1], cpu[1])}
    out["invariants"] = {
        b: check.check_config(check.SweepConfig(b, "d-adam", "plain",
                                                K=PLAN_K, M=PLAN_M),
                              "cuda", groups["cuda"])
        for b in PLAN_GATES}
    return out


def plan_block_record(block=None, dtype=torch.float32, moments=None,
                      what: str = "the planned run's block",
                      variant: str = "") -> dict:
    """``fused_adam`` at one rank's ``block`` of a planned full-width run
    (by default ``PLAN_BLOCK``, ``(1, 4827904, 128)`` f32: llama3.2-1b's
    packed rows at M=2), p and g of ``dtype``, m and v of ``moments`` (p's
    by default), on drawn buffers, alone on the card: held to the plain
    version to the bit, the kernel's CUDA-event and device ms, the plain
    version's, and ``torch._fused_adam_``'s where p and the moments share
    a dtype (one dtype for its lists; in place on copies, held to the
    plain version within KERNEL_TOL at f32, BF16_LIBRARY_TOL at bf16),
    beside the byte bound (p read and written, g read, m and v read and
    written: 28 B an element at f32, 20 with bf16 moments). A record of
    the ``kernels`` line (its launches summed by path in ``run_phases``)."""
    from repro_torch.kernels import fused_adam as fa

    block = list(block or PLAN_BLOCK)
    moments = moments or dtype
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = torch.randn(block, generator=gen, device="cuda").to(dtype)
    g = (torch.randn(block, generator=gen, device="cuda") * 0.1).to(dtype)
    m = (torch.randn(block, generator=gen, device="cuda") * 0.01).to(moments)
    v = (torch.rand(block, generator=gen, device="cuda") * 0.01).to(moments)
    n = p.numel()
    per = 3 * p.element_size() + 4 * m.element_size()

    def kernel():
        return fa.fused_adam(p, g, m, v, **ADAM)

    def plain():
        return fa.fused_adam_plain(p, g, m, v, **ADAM)

    got, want = kernel(), plain()
    max_abs, max_rel = compare(got, want, BIT_EQUAL, f"fused_adam at {what}")
    rec = {"name": "fused_adam", "route": "cuda",
           "source": "src/repro_torch/csrc/fused_adam.cu",
           "replaces": "src/repro/kernels/fused_adam.py:66",
           "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
           "tol": BIT_EQUAL, "library_ms": None,
           "library": "none: torch._fused_adam_ takes one dtype for its "
                      "lists"}
    if moments == dtype:
        lib_tol = KERNEL_TOL if dtype == torch.float32 else BF16_LIBRARY_TOL
        lib = [p.clone()], [m.clone()], [v.clone()]
        call = fused_adam_library_call(lib[0], [g], lib[1], lib[2], ADAM,
                                       torch.tensor(1e7, device="cuda"))
        call()
        rec["library_max_abs_err"] = compare(
            (lib[0][0], lib[1][0], lib[2][0]), want, lib_tol,
            f"torch._fused_adam_ against fused_adam_plain at {what}")[0]
        rec.update(library_ms=median_ms(call, reps=LM_REPS, warmup=1),
                   library_device_ms=device_kernel_ms(call, "",
                                                      reps=LM_REPS),
                   library="torch._fused_adam_ (state_steps 1e7; checked "
                           "against the plain version within "
                           + ("KERNEL_TOL)" if dtype == torch.float32
                              else "BF16_LIBRARY_TOL)"))
        del lib, call
    del got, want
    ms = median_ms(kernel, reps=LM_REPS, warmup=1)
    rec.update({
        "ms": ms, "kernel_ms": ms,
        "kernel_device_ms": device_kernel_ms(kernel, "fused_adam_kernel",
                                             reps=LM_REPS),
        "plain_ms": median_ms(plain, reps=LM_REPS, warmup=1),
        "bound_ms": max(per * n / MEM_RATE, 12 * n / F32_RATE) * 1e3,
        "bound_by": "bytes", "bytes": per * n,
        "variant": variant or (f"the planned run's block {PLAN_BLOCK}: one "
                               "rank's 1/M of llama3.2-1b's packed rows at "
                               "M=2"),
        "params": "float32" if dtype == torch.float32 else "bfloat16"})
    if moments != torch.float32:
        rec["moments"] = str(moments).split(".")[-1]
    emit({"phase": "kernel", **rec})
    del p, g, m, v
    torch.cuda.empty_cache()
    return rec


def phase_axis2d_plan():
    """The sharding plan on the card (slice 22): (a) llama3.2-1b at full
    width through the CLI at --model-parallel 2 on 4 gloo ranks of the
    one card, held to its stacked twin (lm_train's route, the same params
    and batches), with the peak a rank, the step medians, the collectives
    a step, no model all-gather and the fused_adam launches; the packed
    route without the plan at the same setting beside it (its peak, or
    the setting at which it runs out of its share); (b) the planned route
    on the card against the CPU at the four dense configs reduced; (c)
    the planned config's invariant gate; then ``fused_adam``'s record at
    a rank's block. Returns (launches summed over the ranks of (a), the
    gate records, that record)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stacked_argv = plan_args()
    argv = stacked_argv + PLAN_AXIS
    ranks_n = PLAN_K * PLAN_M
    ranks = spawn(axis2d_plan_rank, ranks_n, (argv, "plan"),
                  timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=2)
    t_plan = time.perf_counter() - t0
    want = {n: PLAN_LAUNCHES.get(n, 0) for n in ops.launch_counts()}
    for rank, rec in enumerate(ranks):
        what = f"axis2d_plan rank {rank}"
        if "oom" in rec:
            raise AssertionError(f"{what}: out of its share of the card at "
                                 f"{PLAN_BATCH} x {PLAN_SEQ}: {rec['oom']}")
        coll = rec["collectives"]
        if rec["mode"] != "planned" or rec["block"] != PLAN_BLOCK \
                or not rec["finite"]:
            raise AssertionError(f"{what}: mode {rec['mode']}, block "
                                 f"{rec['block']}, finite {rec['finite']}")
        if rec["launches"] != want:
            raise AssertionError(f"{what}: launches {rec['launches']}")
        if coll["model_all_gather"]["count"] != 0 or \
                coll["model_redistribute"]["count"] != 2 * PLAN_STEPS or \
                coll["model_sum"]["count"] != PLAN_SUMS_PER_STEP * PLAN_STEPS:
            raise AssertionError(f"{what}: collectives {coll}")
        if rec["loss"] != ranks[0]["loss"]:
            raise AssertionError(f"{what}: losses {rec['loss']} against "
                                 f"rank 0's {ranks[0]['loss']}")
    torch.cuda.empty_cache()
    stacked, stacked_ms = synced(lambda: train_cli.main(stacked_argv))
    want_losses = list(stacked.log.loss)
    del stacked
    torch.cuda.empty_cache()
    # finite and from near ln(vocab); whether 4 steps of 1 x 1024 tokens
    # lower the loss depends on the batches, which the stacked twin shares
    cfg = get_arch(LM_ARCH).model
    losses = ranks[0]["loss"]
    if not all(math.isfinite(x) for x in losses) or abs(
            losses[0] - math.log(cfg.vocab_size)) > LM_LOSS0_SLACK:
        raise AssertionError(f"axis2d_plan: losses {losses} (ln vocab "
                             f"{math.log(cfg.vocab_size):.3f})")
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["loss"],
                                                 want_losses)]
    if max(rel) > PLAN_LOSS_RTOL:
        raise AssertionError(f"axis2d_plan: losses {ranks[0]['loss']} "
                             f"against the stacked run's {want_losses}")
    t_gather = time.perf_counter()
    gather = spawn(axis2d_plan_rank, ranks_n, (argv, "allgather"),
                   timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=2)
    t_gather = time.perf_counter() - t_gather
    torch.cuda.empty_cache()
    t_cpu = time.perf_counter()
    cc = spawn(plan_card_cpu_rank, ranks_n, (PLAN_CARD_CPU_ARCHS,),
               timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=2)
    t_cpu = time.perf_counter() - t_cpu
    per_step = {k: {"count": v["count"] / PLAN_STEPS,
                    "bytes": v["bytes"] / PLAN_STEPS,
                    "max_bytes": v["max_bytes"]}
                for k, v in ranks[0]["collectives"].items() if v["count"]}
    gates = [gate_record(f"{b}/d-adam/plain (K=2, M=2)",
                         [r["invariants"][b] for r in cc])
             for b in PLAN_GATES]
    card_cpu = {}
    for arch_id in PLAN_CARD_CPU_ARCHS:
        recs = [r[arch_id] for r in cc]
        if any(r["mode"] != "planned" or r["launches"] != {
                n: PLAN_CARD_CPU_LAUNCHES.get(n, 0) for n in r["launches"]}
               for r in recs):
            raise AssertionError(f"axis2d_plan card vs CPU {arch_id}: "
                                 f"{[(r['mode'], r['launches']) for r in recs]}")
        card_cpu[arch_id] = {
            "losses": recs[0]["losses"], "losses_cpu": recs[0]["losses_cpu"],
            "step1_max_abs_err": max(r["step1"][0] for r in recs),
            "blocks": {k: max(r["blocks"][k] for r in recs)
                       for k in recs[0]["blocks"]}}
    emit({"phase": "axis2d_plan", "argv": argv,
          "config": {"arch": LM_ARCH, "full": True, "K": PLAN_K,
                     "M": PLAN_M, "period": PLAN_PERIOD,
                     "steps": PLAN_STEPS, "batch": PLAN_BATCH,
                     "seq": PLAN_SEQ, "params": "float32",
                     "compute": "bfloat16",
                     "rank_share_of_card": PLAN_RANK_SHARE},
          "transport": ranks[0]["transport"],
          "block_per_rank": ranks[0]["block"],
          "losses": ranks[0]["loss"], "losses_stacked": want_losses,
          "loss_rel_err": rel, "loss_rtol": PLAN_LOSS_RTOL,
          "stacked_main_ms": stacked_ms,
          "peak_mem_gb_per_rank": [r["peak_gb"] for r in ranks],
          "step_ms_per_rank": [r["step_ms"] for r in ranks],
          "local_step_ms_median_per_rank": [
              r["local_step_ms_median"] for r in ranks],
          "comm_step_ms_median_per_rank": [
              r["comm_step_ms_median"] for r in ranks],
          "collectives_per_step_rank0": per_step,
          "model_all_gathers_per_step": 0,
          "launches_per_rank": ranks[0]["launches"],
          "allgather_route": [
              {k: r[k] for k in ("oom", "peak_gb", "local_step_ms_median",
                                 "comm_step_ms_median", "loss") if k in r}
              for r in gather],
          "card_vs_cpu": card_cpu,
          "seconds": {"plan": t_plan, "allgather": t_gather,
                      "card_vs_cpu": t_cpu,
                      "total": time.perf_counter() - t0}})
    launches = {n: sum(r["launches"][n] for r in ranks) for n in want}
    return launches, gates, plan_block_record()


def plan_family_arch(fam: str):
    """The full-width arch of PLAN_FAMILIES[fam], cut to its depth and
    param dtype."""
    from repro_torch.configs import get_arch

    f = PLAN_FAMILIES[fam]
    arch = get_arch(f["arch"])
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=f["n_layers"], param_dtype=f["param_dtype"]))


def plan_family_rank(rank: int, init_method: str, fams) -> dict:
    """One rank of the planned runs of ``fams`` (PLAN_FAMILIES' keys), one
    after the other on one K=2 x M=2 gloo group of the card, held to
    PLAN_RANK_SHARE: for each, the library path of the CLI's rank body
    (``make_optimizer`` packed D-Adam under comm='axis', the trainer with
    ``make_plan(arch, group)``, the params from the CLI's seed, its batch
    stream), the counters zeroed after init, PLAN_FAMILY_STEPS steps one
    fit call each, the counters read. The rank's losses, step times,
    peak, collectives, launches, block, the plan sums' formula; an
    out-of-memory error comes back as the record's ``oom``."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_worker_group
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models.registry import build_model
    from repro_torch.train.grad import plan_model_sums
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    # four ranks each held to a quarter of the card leave the card itself
    # no room for a rank's cached but unused blocks: expandable segments
    # keep what a rank reserves near what it holds (the MoE's f32 buffer,
    # bf16 moments and bf16 shards of many sizes fragment the cache). Set
    # before the rank's first CUDA call, where the allocator reads it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_per_process_memory_fraction(PLAN_RANK_SHARE)
    group = make_worker_group(PLAN_K, model_parallel=PLAN_M,
                              init_method=init_method, rank=rank,
                              device=DEVICE, backend="gloo",
                              timeout_s=AXIS_GROUP_TIMEOUT_S)
    out = {}
    for fam in fams:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        arch = plan_family_arch(fam)
        cfg = arch.model
        try:
            api = build_model(cfg)
            opt = make_optimizer("d-adam", K=PLAN_K, eta=LM_ETA,
                                 period=PLAN_PERIOD, topology="ring",
                                 backend="packed", comm="axis", group=group,
                                 moment_dtype=arch.parallel.moment_dtype)
            trainer = DecentralizedTrainer(stacked_loss(api.loss), opt,
                                           plan=make_plan(arch, group))
            state = trainer.init(api.init(torch.Generator(
                device=DEVICE).manual_seed(cli.PARAM_SEED)))
            it = cli.make_batch_iter(cfg, PLAN_K, PLAN_BATCH, PLAN_SEQ, 0.5,
                                     torch.device(DEVICE))
            torch.cuda.synchronize()
            ops.reset_launches()
            group.reset_counts()
            log = None
            for _ in range(PLAN_FAMILY_STEPS):
                state, log = trainer.fit(state, it, 1, log_every=1, log=log)
            torch.cuda.synchronize()
        except torch.OutOfMemoryError as e:
            out[fam] = {"oom": str(e).splitlines()[0],
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            # the group's other ranks wait on this one: say why now
            print(f"{fam} rank {rank}: {out[fam]}", file=sys.stderr,
                  flush=True)
            continue
        walls = [0.0] + list(log.wall_s)
        step_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
        out[fam] = {
            "mode": trainer.pipeline.mode, "loss": list(log.loss),
            "step_ms": step_ms,
            "local_step_ms": [d for c, d in zip(log.step, step_ms)
                              if c % PLAN_PERIOD],
            "comm_step_ms": [d for c, d in zip(log.step, step_ms)
                             if c % PLAN_PERIOD == 0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_peak_gb": torch.cuda.max_memory_reserved() / 1e9,
            "collectives": group.collective_summary(),
            "launches": ops.launch_counts(),
            "block": list(state.buf.shape),
            "dtypes": [str(t.dtype) for t in (state.buf, state.m, state.v)],
            "finite": bool(torch.isfinite(state.buf).all()),
            "formula": plan_model_sums(trainer._plan, state.spec, cfg),
            "worker": group.rank, "model_rank": group.model_rank,
            "transport": group.transport}
        del trainer, state, it, opt, api
    return out


def plan_family_twin(fam: str) -> dict:
    """The stacked twin of PLAN_FAMILIES[fam]'s planned run on the card:
    the same config, params and batch stream at K=2 (``lm_library_trainer``
    at p=2), PLAN_FAMILY_STEPS steps one fit call each, its launches
    exact; for the MoE, the share of (token, choice) pairs the capacity
    dropped in each call of the layer (``moe.dropped_share``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.models import moe

    arch = plan_family_arch(fam)
    cfg = arch.model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api, trainer = lm_library_trainer(cfg, "d-adam", period=PLAN_PERIOD,
                                      moment_dtype=arch.parallel.moment_dtype)
    state = trainer.init(api.init(torch.Generator(
        device=DEVICE).manual_seed(cli.PARAM_SEED)))
    it = cli.make_batch_iter(cfg, PLAN_K, PLAN_BATCH, PLAN_SEQ, 0.5,
                             torch.device(DEVICE))
    shares, forward = [], moe.moe_forward

    def spy(params, x, shard=None, **routing):
        shares.append(moe.dropped_share(params, x, **routing))
        return forward(params, x, shard=shard, **routing)

    ops.reset_launches()
    moe.moe_forward = spy
    try:
        log = None
        for _ in range(PLAN_FAMILY_STEPS):
            state, log = trainer.fit(state, it, 1, log_every=1, log=log)
    finally:
        moe.moe_forward = forward
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(f"axis2d_plan_{fam} stacked twin", launches,
                   PLAN_TWIN_LAUNCHES)
    rec = {"loss": list(log.loss), "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0,
           "params_per_worker": state.spec.n}
    if shares:
        g, C = moe.capacity(PLAN_BATCH * PLAN_SEQ, cfg.experts_per_token,
                            cfg.n_experts, cfg.capacity_factor,
                            cfg.moe_group_size)
        rec.update(dropped_share_by_call=shares,
                   dropped_share=sum(shares) / len(shares),
                   route_group=[PLAN_BATCH, PLAN_SEQ, g, C])
    del trainer, state, it, api
    torch.cuda.empty_cache()
    return rec


def phase_axis2d_plan_families():
    """The sharding plan on the card for the MoE and vision-language
    families (slice 23): phi3.5-moe at full width (1 of 32 layers, bf16
    params, bf16 moments, an f32 buffer) and phi-3-vision at full width
    (PLAN_VLM_LAYERS of 32 layers, f32 params), each at K=2 x M=2 on 4
    gloo ranks of the one card held to PLAN_RANK_SHARE (one spawn runs
    both), each rank in the planned mode with its block, no model
    all-gather, 2 redistributions and the plan's sums a step, fused_adam
    on every step; the losses of all PLAN_FAMILY_STEPS steps (the last
    after a comm step) within PLAN_LOSS_RTOL of the stacked twin's, the
    MoE's dropped pairs; then ``fused_adam``'s record at each rank block
    (f32 p with bf16 moments, and f32). Returns ({path: launches summed
    over the ranks}, the records)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    ranks = spawn(plan_family_rank, PLAN_K * PLAN_M, (list(PLAN_FAMILIES),),
                  timeout_s=AXIS_SPAWN_TIMEOUT_S, threads=2)
    t_ranks = time.perf_counter() - t0
    torch.cuda.empty_cache()
    by_path, records = {}, []
    for fam, f in PLAN_FAMILIES.items():
        phase = f"axis2d_plan_{fam}"
        cfg = plan_family_arch(fam).model
        recs = [r[fam] for r in ranks]
        for rank, rec in enumerate(recs):
            what = f"{phase} rank {rank}"
            if "oom" in rec:
                raise AssertionError(
                    f"{what}: out of its share of the card at "
                    f"{f['n_layers']} layers, {PLAN_BATCH} x {PLAN_SEQ}: "
                    f"{rec['oom']} (peak {rec['peak_gb']:.2f} GB)")
            coll = rec["collectives"]
            if rec["mode"] != "planned" or rec["block"] != f["block"] \
                    or not rec["finite"] or rec["dtypes"] != f["dtypes"]:
                raise AssertionError(
                    f"{what}: mode {rec['mode']}, block {rec['block']}, "
                    f"finite {rec['finite']}, dtypes {rec['dtypes']}")
            check_launches(what, rec["launches"], PLAN_FAMILY_LAUNCHES)
            if coll["model_all_gather"]["count"] != 0 or \
                    coll["model_redistribute"]["count"] != \
                    2 * PLAN_FAMILY_STEPS or \
                    rec["formula"] + 1 != f["sums"] or \
                    coll["model_sum"]["count"] != \
                    f["sums"] * PLAN_FAMILY_STEPS:
                raise AssertionError(f"{what}: formula {rec['formula']}, "
                                     f"collectives {coll}")
            if rec["loss"] != recs[0]["loss"]:
                raise AssertionError(f"{what}: losses {rec['loss']} "
                                     f"against rank 0's {recs[0]['loss']}")
        twin = plan_family_twin(fam)
        losses = recs[0]["loss"]
        if not all(math.isfinite(x) for x in losses) or abs(
                losses[0] - math.log(cfg.vocab_size)) > LM_LOSS0_SLACK:
            raise AssertionError(f"{phase}: losses {losses} (ln vocab "
                                 f"{math.log(cfg.vocab_size):.3f})")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, twin["loss"])]
        if max(rel) > PLAN_LOSS_RTOL:
            raise AssertionError(f"{phase}: losses {losses} against the "
                                 f"stacked twin's {twin['loss']}")
        per_step = {k: {"count": v["count"] / PLAN_FAMILY_STEPS,
                        "bytes": v["bytes"] / PLAN_FAMILY_STEPS,
                        "max_bytes": v["max_bytes"]}
                    for k, v in recs[0]["collectives"].items() if v["count"]}
        full_layers = get_arch(f["arch"]).model.n_layers
        emit({"phase": phase,
              "config": {"arch": f["arch"], "full": True,
                         "n_layers": [f["n_layers"], full_layers],
                         "K": PLAN_K, "M": PLAN_M, "period": PLAN_PERIOD,
                         "steps": PLAN_FAMILY_STEPS, "batch": PLAN_BATCH,
                         "seq": PLAN_SEQ,
                         "positions": PLAN_SEQ + cfg.n_patches,
                         "param_dtype": str(f["param_dtype"]),
                         "buffer_m_v_dtypes": recs[0]["dtypes"],
                         "compute": "bfloat16",
                         "rank_share_of_card": PLAN_RANK_SHARE},
              "params_per_worker": twin["params_per_worker"],
              "transport": recs[0]["transport"],
              "block_per_rank": recs[0]["block"],
              "losses": losses, "losses_stacked": twin["loss"],
              "loss_rel_err": rel, "loss_rtol": PLAN_LOSS_RTOL,
              "peak_mem_gb_per_rank": [r["peak_gb"] for r in recs],
              "reserved_peak_gb_per_rank": [r["reserved_peak_gb"]
                                            for r in recs],
              "card_free_gb_before_spawn": free_gb,
              "step_ms_per_rank": [r["step_ms"] for r in recs],
              "local_step_ms_per_rank": [r["local_step_ms"] for r in recs],
              "comm_step_ms_per_rank": [r["comm_step_ms"] for r in recs],
              "collectives_per_step_rank0": per_step,
              "model_all_gathers_per_step": 0,
              "model_sums_per_step": f["sums"],
              "launches_per_rank": recs[0]["launches"],
              "stacked_twin": twin,
              "seconds": {"ranks_both_families": t_ranks,
                          "total": time.perf_counter() - t0}})
        by_path[phase] = {n: sum(r["launches"].get(n, 0) for r in recs)
                          for n in recs[0]["launches"]}
        dts = {"torch.float32": torch.float32,
               "torch.bfloat16": torch.bfloat16}
        records.append(plan_block_record(
            f["block"], dts[f["dtypes"][0]], dts[f["dtypes"][1]],
            f"the planned {fam} run's block",
            f"the planned {f['arch']} run's block {f['block']}: one "
            f"rank's 1/M of its packed rows at M=2, "
            f"{f['n_layers']} of {full_layers} layers"))
    return by_path, records


def phase_invariants(gates: list, corpus) -> None:
    """The invariant gates on the card (``repro_torch.analysis``): the
    sweep's stacked configs (reference and packed x D-Adam and CD-Adam x
    its five variants, one period each, their launches exact), the
    topology zoo, the serving gate and the known-bug corpus (its axis
    items ran in the axis phase's ranks: ``corpus``), beside the reports
    ``gates`` of the axis phases' rank bodies (every path's fit, every
    elastic membership's steps, the sharded MLP). One record with every
    config's report and its per-kind summary; a failed spec or a corpus
    item that does not fail raises."""
    from repro_torch.analysis import check

    t0 = time.perf_counter()
    for cfg in check.sweep_configs():
        if not cfg.axis:
            gates.append(gate_record(cfg.name,
                                     [check.check_config(cfg, DEVICE)]))
    zoo = check.topology_reports()
    for rep in zoo:
        if not rep.ok:
            raise AssertionError(rep.format(verbose=False))
    serve = check.serve_decode_report(device=DEVICE)
    gates.append(gate_record(serve.name, [serve]))
    corpus_ok, corpus_lines = check.run_corpus(corpus)
    if not corpus_ok:
        raise AssertionError("invariants: the corpus did not fail as "
                             "expected:\n" + "\n".join(corpus_lines))
    names = [f"{n}-{k}" for n, k in check.TOPOLOGY_ZOO] + [
        r.name for r in zoo[len(check.TOPOLOGY_ZOO):]]
    emit({"phase": "invariants", "configs": gates,
          "topology": dict(zip(names, (r.ok for r in zoo))),
          "corpus": corpus_lines,
          "passed": len(gates), "seconds": time.perf_counter() - t0})


def serve_prompts(cfg, lengths, seed=1):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (L,), generator=gen,
                          device=DEVICE, dtype=torch.int32) for L in lengths]


def synced(fn):
    """(result, wall ms) of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_extras(cfg, batch: int, seed: int = 5) -> dict:
    """The family's prefill inputs besides the tokens (``family_extras``:
    patch features, frame embeddings), drawn on the card from a seed."""
    from repro_torch.models.registry import family_extras

    return family_extras(cfg, batch,
                         torch.Generator(device=DEVICE).manual_seed(seed))


def serve_prefill_mfu(cfg, B: int, S: int, times: dict) -> dict:
    """The model FLOPs of a full (B, S) prefill, 2 N D with N the active
    params (``analysis.roofline.prefill_model_flops``: a vlm's patch
    positions, whisper's encoder over its frames), and their share of the
    card's dense peak of the compute dtype by its median prefill ms."""
    from repro_torch.analysis.roofline import mfu, prefill_model_flops

    flops = prefill_model_flops(cfg, B, S)
    dtype = ("bfloat16" if cfg.compute_dtype == torch.bfloat16
             else "float32")
    return {"bucket": f"{B}x{S}", "active_params": cfg.active_param_count(),
            "model_flops": flops, "prefill_ms": times["prefill_ms"],
            "mfu_at": f"{dtype} dense peak of the {H100_SXM.name} data "
                      "sheet",
            "mfu": mfu(flops, times["prefill_ms"] / 1e3, dtype=dtype)}


def bucket_times(engine, cfg, buckets, new_tokens):
    """Per bucket: a full prompt's prefill (n_new = 1: no decode step),
    then n_new tokens, each synchronised, median of 3; decode ms per token
    from the difference. The family's extras come with each batch."""
    per_bucket = {}
    for B, S in buckets:
        toks = torch.randint(0, cfg.vocab_size, (B, S), device=DEVICE,
                             dtype=torch.int32)
        ex = device_extras(cfg, B) or None
        pre = [synced(lambda: engine.generate_batch(toks, 1, extras=ex))[1]
               for _ in range(3)]
        full = [synced(lambda: engine.generate_batch(toks, new_tokens,
                                                     extras=ex))[1]
                for _ in range(3)]
        pre_ms, full_ms = statistics.median(pre), statistics.median(full)
        per_bucket[f"{B}x{S}"] = {
            "prefill_ms": pre_ms, "generate_ms": full_ms,
            "decode_ms_per_token": (full_ms - pre_ms) / (new_tokens - 1),
            "tokens_per_s": B * new_tokens / full_ms * 1e3}
    return per_bucket


def request_batches(engine, cfg, requests, seed=1):
    """One bucket batch per request ``(rows, prompt length)``: the
    tightest bucket, the prompts right-padded to its seq (an exact seq
    where the engine pads none), batch-padding rows repeating row 0, and
    the family's extras for the real rows, repeated likewise. Returns
    ``[(tokens, true_len, rows, extras)]``."""
    from repro_torch.models.registry import family_extras
    from repro_torch.serve import select_bucket

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for rows, L in requests:
        B, S = select_bucket(engine.buckets, rows, L, pad_seq=engine.pad_seq)
        if rows > B:
            raise ValueError(f"{rows} rows exceed the bucket ({B}, {S})")
        pad = [0] * (B - rows)
        toks = torch.randint(0, cfg.vocab_size, (rows, L), generator=gen,
                             device=DEVICE, dtype=torch.int32)
        toks = torch.nn.functional.pad(toks, (0, S - L))
        ex = {k: torch.cat([x, x[pad]])
              for k, x in family_extras(cfg, rows, gen).items()}
        out.append((torch.cat([toks, toks[pad]]), L, rows, ex))
    return out


def serve_full_width(phase, cfg, buckets, lengths, new_tokens, kernel,
                     per_pass, seeds=(None, 1), profile_tokens=8,
                     requests=None):
    """A model at full width through the port's serving entry points:
    weights from a seed published into a ParamStore, DecodeEngine over
    the buckets, the prompts served; then for each further seed in
    ``seeds`` a new version published and the prompts served again. The
    prompts are ``lengths`` through ``engine.generate``, or, for a family
    with extras (``generate`` passes none, as JAX's), ``requests`` through
    ``generate_batch(extras=)`` (``request_batches``). The launch counters
    are zeroed just before and read just after: ``kernel`` launched
    ``per_pass`` times a pass, no other kernel. Then the per-bucket times
    and a profile of one batch of the largest bucket. ``profile_tokens``
    new tokens (at most ``new_tokens``) go into the profile. Returns the
    phase's record and the engine."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import DecodeEngine, ParamStore

    api = build_model(cfg)
    # the previous phase's tensors are gone: the peak is this phase's own
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # device memory held (GB) at each stage, and the peak up to it
    mem = {}

    def mark(stage):
        mem[stage] = {"held": torch.cuda.memory_allocated() / 1e9,
                      "peak": torch.cuda.max_memory_allocated() / 1e9}

    mark("start")
    store = ParamStore()
    _, init_ms = synced(lambda: store.publish(
        api.init(torch.Generator(device=DEVICE).manual_seed(0))))
    mark("v1 published")
    n_params = sum(x.numel() for x in tree_leaves(store.snapshot()[1]))
    engine = DecodeEngine(cfg, store, buckets=buckets,
                          max_new_tokens=new_tokens)
    if requests is None:
        prompts = serve_prompts(cfg, lengths)

        def serve_pass():
            return engine.generate(prompts, new_tokens)
    else:
        prompts = request_batches(engine, cfg, requests)
        lengths = [L for rows, L in requests for _ in range(rows)]

        def serve_pass():
            return [o for toks, L, rows, ex in prompts
                    for o in engine.generate_batch(
                        toks, new_tokens, true_len=L, extras=ex)[:rows]]
    ops.reset_launches()
    outs, walls = [], []
    for seed in seeds:
        if seed is not None:   # hot-swap: the next version, another seed
            store.publish(api.init(torch.Generator(device=DEVICE)
                                   .manual_seed(seed)))
            mark(f"v{len(walls) + 1} published")
        out, ms = synced(serve_pass)
        outs.append(out)
        walls.append(ms)
        mark(f"pass {len(walls)} served")
    launches = ops.launch_counts()
    want = {n: 0 for n in launches}
    want[kernel] = per_pass * len(seeds)
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} != {want}")
    if engine.last_version != len(seeds):
        raise AssertionError(f"served version {engine.last_version}")
    if engine.compile_counts != {"prefill": len(buckets),
                                 "decode": len(buckets)}:
        raise AssertionError(f"signatures {engine.compile_counts}")
    for out in outs:
        for o in out:
            if (o.shape != (new_tokens,) or o.dtype != torch.int32
                    or not bool(((o >= 0) & (o < cfg.vocab_size)).all())):
                raise AssertionError(f"served tokens {o}")
    if len(outs) > 1 and all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("version 2 served the same tokens as 1")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_bucket = bucket_times(engine, cfg, buckets, new_tokens)
    B, S = max(buckets)
    prefill_mfu = serve_prefill_mfu(cfg, B, S, per_bucket[f"{B}x{S}"])
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=DEVICE,
                         dtype=torch.int32)
    n_prof = min(profile_tokens, new_tokens)
    ex = device_extras(cfg, B) or None
    # the profiler may drop events of a large profile: take it again when
    # it recorded fewer of the kernel's launches than were made (at most 3
    # profiles, as device_kernel_ms)
    for _ in range(3):
        before = ops.launch_counts()[kernel]
        prof = device_profile(lambda: engine.generate_batch(toks, n_prof,
                                                            extras=ex),
                              KERNEL_FUNCTIONS[kernel])
        profiled = ops.launch_counts()[kernel] - before
        kernel_ms = prof.pop("kernel_ms")
        calls = prof.pop("kernel_calls")
        if calls == profiled and (kernel_ms > 0 or not profiled):
            break
    else:
        raise AssertionError(
            f"{phase}: the profile holds {calls} launches and {kernel_ms} "
            f"device ms for {kernel}'s {profiled} launches; its top "
            f"kernels {prof['top'][:6]}")
    n_out = sum(o.numel() for o in outs[-1])
    rec = {"phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "param_count": cfg.param_count(),
           "param_bytes_f32": 4 * n_params,
           "buckets": [list(b) for b in buckets], "new_tokens": new_tokens,
           "prompt_lengths": list(lengths),
           "requests": None if requests is None else [list(r)
                                                      for r in requests],
           "init_ms": init_ms,
           "serve_ms": walls, "tokens_per_s": n_out / walls[-1] * 1e3,
           "per_bucket": per_bucket, "prefill_mfu": prefill_mfu,
           "peak_mem_gb": peak_gb,
           "mem_gb_by_stage": mem, "last_version": engine.last_version,
           "compile_counts": engine.compile_counts, "launches": launches,
           "profile_batch": f"{B}x{S}, {n_prof} new tokens",
           "profile": {**prof, f"{kernel}_ms": kernel_ms,
                       "kernel_share": (kernel_ms / prof["device_ms"]
                                        if prof["device_ms"] else None)}}
    del store, outs, prompts
    return rec, engine


def phase_serve(cfg=None, buckets=SERVE_BUCKETS, lengths=SERVE_LENGTHS,
                new_tokens=SERVE_NEW, prefills=SERVE_PREFILLS):
    """llama3.2-1b at full width (``serve_full_width``): one flash launch
    per layer per prefill. Returns the launch counts."""
    from repro_torch.configs import get_arch

    cfg = cfg or get_arch(SERVE_ARCH).model
    rec, engine = serve_full_width("serve", cfg, buckets, lengths,
                                   new_tokens, "flash_attention",
                                   cfg.n_layers * prefills)
    # the analytic count leaves out the RMS-norm weights (two per layer
    # and the final one)
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    if rec["params"] != cfg.param_count() + norms:
        raise AssertionError(f"{rec['params']} params, config "
                             f"{cfg.param_count()} + {norms} norm weights")
    emit(rec)
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_serve_card_vs_cpu(cfg=None, seq=128, new_tokens=4, batch=1,
                            phase="serve_card_vs_cpu", f32_row_scale=False):
    """The same weights on the card and on the CPU (full width, depth cut
    to 2): greedy tokens of a (batch, seq) request through the engine on
    each, at f32 and at bf16 compute; then the logits of both devices
    teacher-forced along the card's tokens of that compute dtype (the
    prefill and new_tokens - 1 decode steps, through the family's
    kernels). The family's extras (patch features, frame embeddings) are
    drawn on the CPU and copied to the card. See SERVE_F32_TOL for what
    each dtype is held to."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import (build_model, family_extras,
                                             impl_kwargs)
    from repro_torch.serve import DecodeEngine, cast_params

    cfg = cfg or dataclasses.replace(get_arch(SERVE_ARCH).model, n_layers=2)
    cfgs = {"f32": dataclasses.replace(cfg, compute_dtype=torch.float32),
            "bf16": cfg}
    api = build_model(cfg)
    params = {"cpu": api.init(torch.Generator().manual_seed(2))}
    params[DEVICE] = tree_map(lambda x: x.to(DEVICE), params["cpu"])
    prompt = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    extras = family_extras(cfg, batch, torch.Generator().manual_seed(4))
    extras = {dev: {k: x.to(dev) for k, x in extras.items()}
              for dev in ("cpu", DEVICE)}
    toks, secs = {}, {}
    for dt, c in cfgs.items():
        for dev in ("cpu", DEVICE):
            eng = DecodeEngine(c, params[dev], buckets=((batch, seq),),
                               max_new_tokens=new_tokens)
            t0 = time.perf_counter()
            toks[dev, dt] = eng.generate_batch(
                prompt.to(dev), new_tokens, extras=extras[dev] or None).cpu()
            secs[dev, dt] = time.perf_counter() - t0

    def forced(dev, c, along):
        """(batch, new_tokens, V) f32 logits along the tokens ``along``."""
        api_c = build_model(c)
        p = cast_params(params[dev], c.compute_dtype, keep=api_c.f32_leaves)
        pre_kw, dec_kw = impl_kwargs(c, attn_impl="kernel",
                                     wkv_impl="kernel")
        with torch.no_grad():
            logits, cache = api_c.prefill(
                p, {"tokens": prompt.to(dev), **extras[dev]},
                cache_len=eng_cache_len(c, seq, new_tokens), **pre_kw)
            out = [logits[:, -1]]
            for t in range(new_tokens - 1):
                logits, cache = api_c.decode_step(
                    p, cache, along[:, t].to(dev), **dec_kw)
                out.append(logits)
        return torch.stack(out, 1).float().cpu()

    def tokens_equal(dt, lg, floor):
        """The greedy tokens of ``dt``, card against CPU, must be equal
        wherever the CPU's top-2 gap exceeds the larger of ``floor`` and
        twice the step's largest card-CPU difference (past that no
        rounding can swap them); from the first near-tie on the sequences
        may part."""
        diff = (lg[DEVICE] - lg["cpu"]).abs().amax(dim=-1)
        top2 = torch.topk(lg["cpu"], 2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).tolist()
        margins = torch.clamp(2 * diff, min=floor).tolist()
        card, cpu = toks[DEVICE, dt], toks["cpu", dt]
        checked = 0
        for b in range(batch):
            for t in range(new_tokens):
                if card[b, t] != cpu[b, t]:
                    if gaps[b][t] > margins[b][t]:
                        raise AssertionError(
                            f"{dt} row {b} token {t}: card {card[b]} cpu "
                            f"{cpu[b]} with a gap of {gaps[b][t]} > "
                            f"{margins[b][t]}")
                    break  # a near-tie: the sequences part from here
                checked += 1
        return {"card": card.tolist(), "cpu": cpu.tolist(),
                "checked": checked, "top2_gaps_cpu": gaps,
                "margins": margins}

    devs = (DEVICE, "cpu")
    f32 = {d: forced(d, cfgs["f32"], toks[DEVICE, "f32"]) for d in devs}
    bf16 = {d: forced(d, cfg, toks[DEVICE, "bf16"]) for d in devs}
    # the CPU's f32 logits along the bf16 tokens: the bf16 yardstick
    ref = forced("cpu", cfgs["f32"], toks[DEVICE, "bf16"])
    f32_tol = SERVE_F32_TOL
    if f32_row_scale:
        f32_tol = dict(SERVE_F32_TOL, atol=SERVE_F32_TOL["atol"] * f32[
            "cpu"].abs().amax(dim=-1, keepdim=True).double())
    f32_err = compare([f32[DEVICE]], [f32["cpu"]], f32_tol,
                      "teacher-forced logits, f32")
    card_dev = float((bf16[DEVICE] - ref).abs().max())
    cpu_dev = float((bf16["cpu"] - ref).abs().max())
    if card_dev > SERVE_BF16_RATIO * cpu_dev:
        raise AssertionError(f"bf16 logits: the card lies {card_dev} from "
                             f"the f32 logits, the CPU {cpu_dev}")
    diff = (bf16[DEVICE] - bf16["cpu"]).abs()
    outside = diff > (SERVE_BF16_TOL["atol"] + SERVE_BF16_TOL["rtol"]
                      * bf16["cpu"].abs())
    emit({"phase": phase, "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": batch,
          "seq": seq, "new_tokens": new_tokens,
          "tokens": {"f32": tokens_equal("f32", f32, SERVE_F32_TOL["atol"]),
                     "bf16": tokens_equal("bf16", bf16,
                                          SERVE_BF16_TOL["atol"])},
          "f32_max_abs_err": f32_err[0], "f32_tol": SERVE_F32_TOL,
          "f32_atol_times_row_max": f32_row_scale,
          "f32_row_max": float(f32["cpu"].abs().max()),
          "bf16_max_abs_err": float(diff.max()),
          "bf16_share_outside_2e-2": float(outside.double().mean()),
          "bf16_from_f32_card": card_dev, "bf16_from_f32_cpu": cpu_dev,
          "bf16_ratio_allowed": SERVE_BF16_RATIO,
          "seconds_card": {dt: secs[DEVICE, dt] for dt in cfgs},
          "seconds_cpu": {dt: secs["cpu", dt] for dt in cfgs}})
    del params
    torch.cuda.empty_cache()


def eng_cache_len(cfg, seq: int, new_tokens: int) -> int:
    """The cache length of a (batch, seq) bucket's engine with
    ``new_tokens`` of headroom (the vlm prefix included)."""
    from repro_torch.serve.engine import kv_cache_len

    return kv_cache_len(cfg, seq + (cfg.n_patches or 0) + new_tokens)


def phase_online():
    """``train_online`` at the paper's width: K=8 packed D-Adam on the
    ring, 12 steps, the consensus mean published every 4. The launch
    counters are zeroed just before and read just after."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.stream import ctr_stream
    from repro_torch.data.synthetic import ctr_teacher, make_ctr_task
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as packing
    from repro_torch.launch import deepfm_ctr
    from repro_torch.models.deepfm import (deepfm_logits, deepfm_loss,
                                           init_deepfm)
    from repro_torch.serve import ParamStore
    from repro_torch.train.loop import DecentralizedTrainer
    from repro_torch.train.online import train_online

    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, DEVICE)
    opt = make_optimizer("d-adam", K=K, eta=ETA, period=4,
                         backend="packed", device=DEVICE)
    trainer = DecentralizedTrainer(deepfm_loss, opt)
    state = trainer.init(init_deepfm(
        torch.Generator(device=DEVICE).manual_seed(0), task.n_features,
        task.n_fields, FULL["embed_dim"], FULL["hidden"]))
    store, snaps = ParamStore(), {}
    publish = store.publish

    def keep(params, **kw):
        version = publish(params, **kw)
        snaps[version] = params
        return version

    store.publish = keep
    torch.cuda.synchronize()
    ops.reset_launches()
    res, wall_ms = synced(lambda: train_online(
        trainer, state, ctr_stream(teacher, K, FULL["per_worker"], seed=1),
        ONLINE_STEPS, store=store, publish_every=ONLINE_EVERY, mode="mean",
        log_every=ONLINE_EVERY))
    launches = ops.launch_counts()
    want = {n: ONLINE_LAUNCHES.get(n, 0) for n in launches}
    if launches != want:
        raise AssertionError(f"online: launches {launches} != {want}")
    steps = list(range(ONLINE_EVERY, ONLINE_STEPS + 1, ONLINE_EVERY))
    if res.published != [(s, i + 1) for i, s in enumerate(steps)]:
        raise AssertionError(f"published {res.published}")
    if not all(math.isfinite(x) for x in res.log.loss):
        raise AssertionError(f"online losses {res.log.loss}")
    aucs = {v: deepfm_ctr.heldout_auc(teacher, p, deepfm_logits)
            for v, p in sorted(snaps.items())}
    want_mean = packing.unpack_mean(res.state.buf.cpu(), res.state.spec)
    got = [x.cpu() for x in tree_leaves(store.snapshot()[1])]
    max_abs, _ = compare(got, tree_leaves(want_mean), KERNEL_TOL,
                         "published mean vs unpack_mean on the CPU")
    emit({"phase": "online", "K": K, "period": 4, "steps": ONLINE_STEPS,
          "publish_every": ONLINE_EVERY, "published": res.published,
          "versions": res.versions, "losses": res.log.loss,
          "auc_by_version": aucs, "wall_ms": wall_ms,
          "mean_vs_cpu_max_abs_err": max_abs, "tol": KERNEL_TOL,
          "launches": launches})
    return launches


def phase_serve_rwkv(cfg=None, buckets=SERVE_BUCKETS,
                     lengths=SERVE_RWKV_LENGTHS, new_tokens=SERVE_NEW,
                     batches=SERVE_RWKV_BATCHES):
    """rwkv6-3b at full width (``serve_full_width``; exact seq buckets: the
    recurrent state would fold pads in): one WKV launch per layer per
    prefill and per decode step, and the second version's recast keeps
    the f32 leaves. Returns the launch counts."""
    from repro_torch.configs import get_arch

    cfg = cfg or get_arch(SERVE_RWKV_ARCH).model
    rec, engine = serve_full_width("serve_rwkv", cfg, buckets, lengths,
                                   new_tokens, "rwkv_scan",
                                   cfg.n_layers * new_tokens * batches)
    kept = check_f32_leaves_kept("serve_rwkv", engine,
                                 engine._params()[1]["layers"])
    emit({**rec, "heads": cfg.d_model // cfg.rwkv_head_size,
          "f32_leaves_kept": kept})
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


def check_f32_leaves_kept(phase, engine, layers):
    """The engine's compute-dtype copy keeps the family's f32 leaves (of
    ``layers``, a dict of stacked leaves) in f32 and casts the rest.
    Returns their names."""
    kept = {n: str(x.dtype) for n, x in layers.items()
            if x.dtype != engine.cfg.compute_dtype}
    if set(kept) != set(engine.api.f32_leaves) & set(layers) or set(
            kept.values()) - {"torch.float32"}:
        raise AssertionError(f"{phase}: the cast kept {kept}, not the f32 "
                             f"leaves {engine.api.f32_leaves}")
    return sorted(kept)


def decode_contract(phase, engine, cfg, new, forward):
    """The decode contract at full depth (ZAMBA2_CONTRACT_RATIO): a
    (1, 128) prompt's prefill through the flash kernel and ``new`` decode
    steps on the engine's bf16 params, against one bf16 and one f32
    forward (the f32 params) over the whole sequence. ``forward(params,
    tokens, extras, cfg)`` gives the family's (1, S, V) logits; the
    family's extras are drawn on the card."""
    _, p32 = engine._source.snapshot()
    p16 = engine._params()[1]
    seq = torch.randint(0, cfg.vocab_size, (1, 128 + new), device=DEVICE,
                        generator=torch.Generator(device=DEVICE)
                        .manual_seed(4), dtype=torch.int32)
    ex = device_extras(cfg, 1, seed=6)
    with torch.no_grad():
        logits, cache = engine.api.prefill(p16, {"tokens": seq[:, :128],
                                                 **ex},
                                           cache_len=128 + new,
                                           attn_impl="kernel")
        steps = [logits[:, 0]]
        for t in range(128, 128 + new):
            logits, cache = engine.api.decode_step(p16, cache, seq[:, t])
            steps.append(logits)
        served = torch.stack(steps, 1).float()
        fwd = {"bf16": forward(p16, seq, ex, cfg),
               "f32": forward(p32, seq, ex, dataclasses.replace(
                   cfg, compute_dtype=torch.float32))}
    # positions 127 .. 127 + new: the prompt's last and each decoded one
    ref = fwd["f32"][:, 127:].float()
    errs = {"served": served - ref, "bf16_forward":
            fwd["bf16"][:, 127:].float() - ref}
    rec = {"prompt": 128, "decode_steps": new, "positions": new + 1,
           "ratio_allowed": ZAMBA2_CONTRACT_RATIO,
           "served_vs_bf16_forward_max_abs": float(
               (served - fwd["bf16"][:, 127:].float()).abs().max())}
    for k, e in errs.items():
        rec[f"{k}_vs_f32_max_abs"] = float(e.abs().max())
        rec[f"{k}_vs_f32_rms"] = float(e.pow(2).mean().sqrt())
    if not bool(torch.isfinite(served).all()) or any(
            rec[f"served_vs_f32_{m}"] > ZAMBA2_CONTRACT_RATIO
            * rec[f"bf16_forward_vs_f32_{m}"] for m in ("max_abs", "rms")):
        raise AssertionError(f"{phase}: decode contract {rec}")
    return rec


def phase_serve_zamba2(cfg=None, buckets=SERVE_BUCKETS,
                       lengths=SERVE_ZAMBA2_LENGTHS, new_tokens=SERVE_NEW,
                       prefills=SERVE_ZAMBA2_PREFILLS,
                       contract_new=ZAMBA2_CONTRACT_NEW):
    """zamba2-7b whole (``serve_full_width``, one version; exact seq
    buckets): one flash launch per attention site per prefill (D = 112),
    the f32 leaves kept, the tree's parameter count, and the decode
    contract (``zamba2_contract``). Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import hybrid

    cfg = cfg or get_arch(SERVE_ZAMBA2_ARCH).model
    sites = hybrid.n_attn_sites(cfg)
    # the profile: the prefill and one decode step (~10,000 torch calls a
    # step)
    rec, engine = serve_full_width("serve_zamba2", cfg, buckets, lengths,
                                   new_tokens, "flash_attention",
                                   sites * prefills, seeds=(None,),
                                   profile_tokens=2)
    kept = check_f32_leaves_kept("serve_zamba2", engine,
                                 engine._params()[1]["layers"])
    # the analytic count leaves out each layer's norm, conv_b and D, and
    # the shared block's two norms and the final one
    di, N = cfg.d_inner, cfg.ssm_state
    extra = (cfg.n_layers * (cfg.d_model + di + 2 * N
                             + cfg.resolved_ssm_heads) + 3 * cfg.d_model)
    if rec["params"] != cfg.param_count() + extra:
        raise AssertionError(f"{rec['params']} params, config "
                             f"{cfg.param_count()} + {extra}")
    contract = decode_contract(
        "serve_zamba2", engine, cfg, contract_new,
        lambda p, seq, ex, c: hybrid.forward(p, seq, c)[0])
    emit({**rec, "attention_sites": sites,
          "head_dim": cfg.resolved_head_dim, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "f32_leaves_kept": kept,
          "decode_contract": contract})
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_serve_moe(cfg=None, buckets=SERVE_BUCKETS, lengths=SERVE_LENGTHS,
                    new_tokens=SERVE_NEW, prefills=SERVE_PREFILLS):
    """phi3.5-moe at full width cut to SERVE_MOE_LAYERS layers
    (``serve_full_width``, one version; llama's padded prompts): one flash
    launch per layer per prefill (D = 128, GQA 32/8), the router kept in
    f32; then the share of (token, choice) pairs the capacity dropped in
    each layer of one full (8, 1024) prefill. Returns the launch
    counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    full = get_arch(SERVE_MOE_ARCH).model
    cfg = cfg or dataclasses.replace(full, n_layers=SERVE_MOE_LAYERS)
    rec, engine = serve_full_width("serve_moe", cfg, buckets, lengths,
                                   new_tokens, "flash_attention",
                                   cfg.n_layers * prefills, seeds=(None,))
    kept = check_f32_leaves_kept("serve_moe", engine,
                                 engine._params()[1]["layers"]["moe"])
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    if rec["params"] != cfg.param_count() + norms:
        raise AssertionError(f"{rec['params']} params, config "
                             f"{cfg.param_count()} + {norms} norm weights")
    B, S = max(buckets)
    shares, forward = [], moe.moe_forward

    def spy(params, x, shard=None, **routing):
        shares.append(moe.dropped_share(params, x, **routing))
        return forward(params, x, shard=shard, **routing)

    moe.moe_forward = spy
    try:
        engine.generate_batch(torch.randint(
            0, cfg.vocab_size, (B, S), device=DEVICE, dtype=torch.int32), 1)
    finally:
        moe.moe_forward = forward
    group, cap = moe.capacity(B * S, cfg.experts_per_token, cfg.n_experts,
                              cfg.capacity_factor, cfg.moe_group_size)
    emit({**rec, "cut": {"n_layers": [cfg.n_layers, full.n_layers]},
          "n_experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "d_ff": cfg.d_ff, "head_dim": cfg.resolved_head_dim,
          "f32_leaves_kept": kept,
          "prefill_group": [B, S, group, cap],
          "dropped_share_by_layer": shares,
          "dropped_share": sum(shares) / len(shares)})
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_serve_vlm(cfg=None, buckets=SERVE_BUCKETS,
                    requests=SERVE_VLM_REQUESTS, new_tokens=SERVE_NEW):
    """phi-3-vision whole (``serve_full_width`` over ``requests``, one
    version): 576 patch features a row from a seed, one flash launch per
    layer per prefill (D = 96, 32/32 heads, over 576 + S positions) and
    none in decode, the tree's parameter count (the projector and the
    norms beside the analytic count). Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import vlm

    cfg = cfg or get_arch(SERVE_VLM_ARCH).model
    rec, engine = serve_full_width("serve_vlm", cfg, buckets, None,
                                   new_tokens, "flash_attention",
                                   cfg.n_layers * len(requests),
                                   seeds=(None,), requests=requests)
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + vlm.CLIP_DIM * cfg.d_model
    if rec["params"] != cfg.param_count() + extra:
        raise AssertionError(f"{rec['params']} params, config "
                             f"{cfg.param_count()} + {extra}")
    emit({**rec, "n_patches": cfg.n_patches,
          "head_dim": cfg.resolved_head_dim, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads,
          "flash_per_prefill": cfg.n_layers})
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_serve_whisper(cfg=None, buckets=SERVE_WHISPER_BUCKETS,
                        requests=SERVE_WHISPER_REQUESTS,
                        new_tokens=SERVE_NEW,
                        contract_new=ZAMBA2_CONTRACT_NEW):
    """whisper-large-v3 whole (``serve_full_width`` over ``requests``, one
    version, exact seq): 1500 frame embeddings a row from a seed; per
    prefill one flash launch per encoder layer (non-causal), per decoder
    layer (causal) and per cross-attention (non-causal, S != T), none in
    decode; the tree's parameter count; then the decode contract at full
    depth (``decode_contract``). Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import whisper

    cfg = cfg or get_arch(SERVE_WHISPER_ARCH).model
    per_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    if max(s for _, s in buckets) + new_tokens > 448:
        raise AssertionError("whisper's buckets pass its 448 positions")
    # the profile: the prefill and one decode step (~3,600 torch calls a
    # step)
    rec, engine = serve_full_width("serve_whisper", cfg, buckets, None,
                                   new_tokens, "flash_attention",
                                   per_prefill * len(requests),
                                   seeds=(None,), profile_tokens=2,
                                   requests=requests)
    # the analytic count takes every attention block without its q/k/v
    # biases, every MLP without its biases, no norms, and the vocab twice
    # (an untied head); the tree ties the head to ``embed`` and adds the
    # learned text positions
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv_b = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    mlp_b = cfg.d_ff + d
    extra = (cfg.n_encoder_layers * (qkv_b + mlp_b + 4 * d)
             + cfg.n_layers * (2 * qkv_b + mlp_b + 6 * d) + 4 * d
             + whisper.MAX_TEXT_POSITIONS * d - cfg.vocab_size * d)
    if rec["params"] != cfg.param_count() + extra:
        raise AssertionError(f"{rec['params']} params, config "
                             f"{cfg.param_count()} + {extra}")
    contract = decode_contract(
        "serve_whisper", engine, cfg, contract_new,
        lambda p, seq, ex, c: whisper.forward(p, seq, ex["audio_embeds"], c))
    emit({**rec, "n_audio_ctx": cfg.n_audio_ctx,
          "n_encoder_layers": cfg.n_encoder_layers,
          "head_dim": cfg.resolved_head_dim, "n_heads": cfg.n_heads,
          "flash_per_prefill": per_prefill, "decode_contract": contract})
    del engine
    torch.cuda.empty_cache()
    return rec["launches"]


# ------------------------- damping and vision --------------------------------


def watch_cost_us(*args, calls: int = 200) -> float:
    """Median host µs of one ``observe`` and ``check`` of a recompile
    watch over ``args`` (what ``fit`` adds to a step under
    ``recompile_limit``), over ``calls`` calls."""
    from repro_torch.analysis.recompile import SignatureWatch

    watch = SignatureWatch("cost", limit=1)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        watch.observe(*args)
        watch.check()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def phase_damped():
    """Adaptive batch damping on the paper's experiment at full width
    through ``DecentralizedTrainer(damping=...).fit``: the launch counters
    zeroed just before and read just after; every worker's chunk count
    non-decreasing within [1, 8], the evaluations their sum, finite
    losses, and the loss falling: the consensus mean's on a fixed
    held-out batch of 512 examples a worker (a step's own loss is the
    mean over its live chunks, 64 examples at count 1, whose spread
    between batches exceeds what 20 steps take off it); then step times
    and a profile of one period. Returns the launch counts."""
    from repro_torch._tree import tree_map
    from repro_torch.core.api import make_optimizer
    from repro_torch.data.synthetic import (ctr_batch_stacked, ctr_teacher,
                                            make_ctr_task)
    from repro_torch.kernels import ops
    from repro_torch.launch import deepfm_ctr
    from repro_torch.models.deepfm import (deepfm_logits, deepfm_loss,
                                           init_deepfm)
    from repro_torch.train.damping import DampingConfig, chunks_of
    from repro_torch.train.loop import DecentralizedTrainer

    dcfg = DampingConfig(**DAMPING)
    task = make_ctr_task(seed=0, n_fields=FULL["n_fields"],
                         features_per_field=FULL["features_per_field"],
                         embed_dim=FULL["embed_dim"])
    teacher = ctr_teacher(task, DEVICE)
    test = ctr_batch_stacked(teacher, torch.Generator(
        device=DEVICE).manual_seed(99), K, FULL["per_worker"])
    test = {"feat_ids": test["feat_ids"].reshape(1, -1, task.n_fields),
            "label": test["label"].reshape(1, -1)}

    def heldout_loss(params):
        with torch.no_grad():
            return float(deepfm_loss(tree_map(lambda x: x[None], params),
                                     test)[0])

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer("d-adam", K=K, eta=ETA, period=DAMPED_PERIOD,
                         backend="packed", device=DEVICE)
    trainer = DecentralizedTrainer(deepfm_loss, opt, damping=dcfg,
                                   recompile_limit=1)
    state = trainer.init(init_deepfm(
        torch.Generator(device=DEVICE).manual_seed(0), task.n_features,
        task.n_fields, FULL["embed_dim"], FULL["hidden"]))
    heldout = [heldout_loss(trainer.averaged_params(state))]
    batches = deepfm_ctr.batch_stream(teacher, FULL["per_worker"])
    ops.reset_launches()
    # each step's counts, taken on the device before it (no sync)
    counts = [chunks_of(trainer.damp_state, dcfg, K)]
    state, log = trainer.fit(
        state, batches, DAMPED_STEPS, log_every=1,
        hook=lambda step, st: counts.append(chunks_of(trainer.damp_state,
                                                      dcfg, K)),
        hook_every=1)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches("damped", launches, DAMPED_LAUNCHES)
    # every level of every worker ran one step signature (limit 1, so fit
    # raises on a second)
    signatures = len(trainer.recompile_watch.signatures)
    if signatures != 1:
        raise AssertionError(f"damped: {signatures} step signatures")
    watch_us = watch_cost_us(state, trainer.damp_state, next(batches))
    per_step = torch.stack(counts[:DAMPED_STEPS]).tolist()
    flat = [c for row in per_step for c in row]
    if (min(flat) < 1 or max(flat) > dcfg.max_chunks
            or any(b < a for prev, row in zip(per_step, per_step[1:])
                   for a, b in zip(prev, row))):
        raise AssertionError(f"damped: chunk counts {per_step}")
    if log.grad_evals[-1] != sum(flat):
        raise AssertionError(f"damped: {log.grad_evals[-1]} evaluations, "
                             f"counts sum to {sum(flat)}")
    if not all(math.isfinite(x) for x in log.loss):
        raise AssertionError(f"damped: non-finite loss in {log.loss}")
    heldout.append(heldout_loss(trainer.averaged_params(state)))
    if not heldout[1] < heldout[0]:
        raise AssertionError(f"damped: held-out loss did not fall: "
                             f"{heldout}")
    auc = deepfm_ctr.heldout_auc(teacher, trainer.averaged_params(state),
                                 deepfm_logits)
    state, times = stamped_steps(trainer, state, batches, 8, DAMPED_PERIOD)
    one = [next(batches) for _ in range(DAMPED_PERIOD)]

    def run_period():
        st = state
        for b in one:
            st, _ = trainer.step(st, b)

    prof = device_profile(run_period)
    emit({"phase": "profile", "path": "damped", "steps": DAMPED_PERIOD,
          **prof})
    emit({"phase": "damped", "damping": DAMPING, "K": K,
          "period": DAMPED_PERIOD, "steps": DAMPED_STEPS, **FULL,
          "hidden": list(FULL["hidden"]),
          "chunk_counts": per_step, "step_signatures": signatures,
          "watch_us": watch_us,
          "losses": log.loss,
          "heldout_loss_before_after": heldout,
          "grad_evals": log.grad_evals, "auc_after_fit": auc,
          "comm_mb": log.comm_mb[-1], "peak_mem_gb": peak_gb,
          "period_device_ms": prof["device_ms"],
          "period_wall_ms": prof["wall_ms"],
          "busy_share": prof["busy_share"], **times,
          "counts_after_timing": chunks_of(trainer.damp_state, dcfg,
                                           K).tolist(),
          "launches": launches})
    del trainer, state, batches, one
    torch.cuda.empty_cache()
    return launches


def image_stream(device, per_worker: int, seed: int = 11):
    """An endless stream of K workers' image batches drawn on ``device``
    from ``seed``, and the class patterns they share."""
    from repro_torch.data.synthetic import (PATTERN_SEED, class_patterns,
                                            image_batch_stacked)

    patterns = class_patterns(torch.Generator(device=device).manual_seed(
        PATTERN_SEED))
    gen = torch.Generator(device=device).manual_seed(seed)

    def stream():
        while True:
            yield image_batch_stacked(gen, K, per_worker, patterns=patterns)

    return stream(), patterns


def vision_trainer(device, period: int):
    """ResNet-20 at VISION's width, packed D-Adam on a K=8 ring on
    ``device``: (trainer, state), the init drawn on the CPU."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.models.deepfm import init_resnet20, resnet20_loss
    from repro_torch.train.loop import DecentralizedTrainer

    opt = make_optimizer("d-adam", K=K, eta=ETA, period=period,
                         weight_decay=VISION["weight_decay"],
                         topology="ring", backend="packed", device=device)
    trainer = DecentralizedTrainer(resnet20_loss, opt)
    return trainer, trainer.init(init_resnet20(
        torch.Generator().manual_seed(0), width=VISION["width"]))


def phase_vision():
    """ResNet-20 (the paper's CIFAR task) at He et al.'s width through
    ``DecentralizedTrainer.fit``: the launch counters zeroed just before
    and read just after, the loss falling; held-out accuracy of the
    consensus mean, step times, a profile of one period, the peak memory.
    Returns the launch counts."""
    from repro_torch._tree import tree_map
    from repro_torch.data.synthetic import image_batch_stacked
    from repro_torch.kernels import ops
    from repro_torch.models.deepfm import resnet20_logits, resnet20_loss
    from repro_torch.train.metrics import accuracy

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, state = vision_trainer(DEVICE, VISION["period"])
    batches, patterns = image_stream(DEVICE, VISION["per_worker"])
    test = image_batch_stacked(torch.Generator(device=DEVICE).manual_seed(99),
                               K, VISION["per_worker"], patterns=patterns)
    test = {"images": test["images"].reshape((1, -1) + test["images"]
                                             .shape[2:]),
            "label": test["label"].reshape(1, -1)}

    def heldout():
        """The consensus mean as one worker on all K workers' held-out
        images: (loss, accuracy)."""
        mean = tree_map(lambda x: x[None], trainer.averaged_params(state))
        with torch.no_grad():
            logits = resnet20_logits(mean, test["images"])
            return (float(resnet20_loss(mean, test)[0]),
                    accuracy(logits[0], test["label"][0]))

    before = heldout()
    ops.reset_launches()
    (state, log), wall_ms = synced(lambda: trainer.fit(
        state, batches, VISION["steps"], log_every=1))
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches("vision", launches, VISION_LAUNCHES)
    if state.spec.n != VISION_PARAMS:
        raise AssertionError(f"vision: {state.spec.n} params per worker")
    if not all(math.isfinite(x) for x in log.loss):
        raise AssertionError(f"vision: non-finite loss in {log.loss}")
    after = heldout()
    if not (log.loss[-1] < log.loss[0] and after[0] < before[0]):
        raise AssertionError(f"vision: loss did not fall: {log.loss}, "
                             f"held-out {before} -> {after}")
    state, times = stamped_steps(trainer, state, batches, 8,
                                 VISION["period"])
    one = [next(batches) for _ in range(VISION["period"])]

    def run_period():
        st = state
        for b in one:
            st, _ = trainer.step(st, b)

    prof = device_profile(run_period)
    emit({"phase": "profile", "path": "vision", "steps": VISION["period"],
          **prof})
    emit({"phase": "vision", "K": K, **VISION, "eta": ETA,
          "params_per_worker": state.spec.n,
          "buffer_shape": list(state.buf.shape), "losses": log.loss,
          "heldout_loss_accuracy_before_after": [before, after],
          "heldout_images": K * VISION["per_worker"],
          "comm_mb": log.comm_mb[-1], "fit_wall_ms": wall_ms,
          "peak_mem_gb": peak_gb, "period_device_ms": prof["device_ms"],
          "period_wall_ms": prof["wall_ms"],
          "busy_share": prof["busy_share"], **times, "launches": launches})
    del trainer, state, batches, one
    torch.cuda.empty_cache()
    return launches


def phase_vision_card_vs_cpu(per_worker: int = 8, period: int = 3):
    """ResNet-20 at VISION's width, 8 images a worker, three packed D-Adam
    steps at period 3 (two fused_adam steps, then gossip_adam_mix, all with
    weight decay 1e-4) on the card and on the CPU from one init and one set
    of batches drawn on the CPU, held as VISION_M_TOL's comment says; the
    record is printed before the bounds are checked."""
    from repro_torch._tree import tree_leaves
    from repro_torch.kernels import pack as packing

    stream, _ = image_stream("cpu", per_worker)
    batches = [next(stream) for _ in range(3)]
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        trainer, state = vision_trainer(dev, period)
        log, snaps = None, []
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for b in batches:
                state, log = trainer.fit(state, iter([b]), 1, log_every=1,
                                         log=log)
                snaps.append({n: getattr(state, n).cpu()
                              for n in ("buf", "m")})
        out[dev] = (snaps, log.loss, time.perf_counter() - t0, state.spec)
        del trainer, state
        torch.cuda.empty_cache()
    (card, closs, ct, spec), (cpu, hloss, ht, _) = out[DEVICE], out["cpu"]
    # step 1's loss comes from one init on one batch; the later ones from
    # params that have parted as VISION_M_TOL's comment says
    loss_err = abs(closs[0] - hloss[0])
    m_err = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
             for a, b in zip(tree_leaves(packing.unpack(card[0]["m"], spec)),
                             tree_leaves(packing.unpack(cpu[0]["m"], spec)))]
    steps = []
    for t in range(3):
        d, outside = outside_tol(card[t]["buf"], cpu[t]["buf"])
        steps.append({"step": t + 1, "loss_abs_err": abs(closs[t] - hloss[t]),
                      "buf_max_abs_err": float(d.max()),
                      "buf_share_outside": float(outside.double().mean()),
                      "cap": adam_part_cap(t + 1, eta=ETA)})
    steps[0].update(m_max_err_of_leaf_max=max(m_err),
                    m_worst_leaf=m_err.index(max(m_err)))
    emit({"phase": "vision_card_vs_cpu", "width": VISION["width"],
          "per_worker": per_worker, "period": period,
          "losses_card": closs, "losses_cpu": hloss, "steps": steps,
          "tol": CARD_CPU_TOL, "m_tol_of_leaf_max": VISION_M_TOL,
          "seconds_card": ct, "seconds_cpu": ht})
    bad = [what for what, fails in (
        ("step 1 loss", loss_err > CARD_CPU_TOL["atol"]
         + CARD_CPU_TOL["rtol"] * abs(hloss[0])),
        ("step 1 m", max(m_err) > VISION_M_TOL),
        ("params", any(r["buf_max_abs_err"] > r["cap"] for r in steps)))
        if fails]
    if bad:
        raise AssertionError(f"vision card vs CPU: {bad} past their bounds")


# ------------------------------ LM training --------------------------------


def lm_batches(cfg, seed: int, steps: int, batch: int = 1, seq: int = 64):
    """``steps`` batches ``{"tokens": (LM_K, batch, seq + 1)}`` on the CPU,
    uniform tokens from numpy, and the family's extras (frame embeddings,
    patch features) from a torch generator."""
    import numpy as np

    from repro_torch.models.registry import family_extras

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_K, batch, seq + 1)).astype(np.int32))}
        for k, x in family_extras(cfg, LM_K * batch, gen).items():
            b[k] = x.reshape((LM_K, batch) + tuple(x.shape[1:]))
        out.append(b)
    return out


def check_lm_losses(phase: str, losses, vocab: int) -> None:
    """Finite, starting near ln(vocab) (random weights guess uniformly,
    give or take the logits' spread at init) and lower at the end."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss in {losses}")
    if abs(losses[0] - math.log(vocab)) > LM_LOSS0_SLACK:
        raise AssertionError(f"{phase}: first loss {losses[0]} is not "
                             f"near ln {vocab} = {math.log(vocab):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall: {losses}")


def check_launches(phase: str, launches, want) -> None:
    want = {n: want.get(n, 0) for n in launches}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} != {want}")


def lm_step_times(phase: str, trainer, box: list, batches, period: int,
                  timed: int = 8) -> dict:
    """Synchronised host stamps around ``timed`` more steps (local and
    comm medians apart), then a device profile of one period. The state
    travels in ``box`` (a one-element list, replaced by the state after),
    and every step is a ``fit`` call of its own: a caller's name for a
    state keeps it alive through the call, and at full width one extra
    state (up to 29.7 GB) does not fit beside a step."""
    state = box.pop()
    stamps, log = [], None
    torch.cuda.synchronize()
    stamps.append((state.count, time.perf_counter()))
    for _ in range(timed):
        state, log = trainer.fit(state, batches, 1, log_every=1, log=log)
        torch.cuda.synchronize()
        stamps.append((state.count, time.perf_counter()))
    dts = [(c, (t - t0) * 1e3) for (_, t0), (c, t) in zip(stamps,
                                                            stamps[1:])]
    one = [next(batches) for _ in range(period)]

    def run_period():
        nonlocal state
        for b in one:
            state, _ = trainer.step(state, b)

    prof = device_profile(run_period)
    box.append(state)
    del state
    emit({"phase": "profile", "path": phase, "steps": period, **prof})
    return {"step_ms_median": statistics.median(d for _, d in dts),
            "local_step_ms_median": statistics.median(
                d for c, d in dts if c % period),
            "comm_step_ms_median": statistics.median(
                d for c, d in dts if c % period == 0),
            "timed_steps": timed,
            "period_device_ms": prof["device_ms"],
            "period_wall_ms": prof["wall_ms"]}


def lm_mfu(cfg, rec) -> dict:
    """The LM step's model FLOPs, 6 N D with N the active params and D
    the K workers' tokens a step, and their share of the card's dense
    bf16 peak (``analysis.roofline``) by the step medians of ``rec``."""
    from repro_torch.analysis.roofline import mfu, model_flops_for

    tokens = LM_K * LM_BATCH * LM_SEQ
    flops = model_flops_for(cfg.active_param_count(), tokens, "train")
    return {"model_flops": flops, "tokens_per_step": tokens,
            "mfu_at": f"bfloat16 dense peak of the {H100_SXM.name} "
                      "data sheet",
            **{f"mfu{part}": mfu(flops, rec[f"{key}_ms_median"] / 1e3)
               for part, key in (("", "step"), ("_local", "local_step"),
                                 ("_comm", "comm_step"))}}


def lm_bit_check(what: str, got, plain, rows: int) -> int:
    """The kernel's outputs ``got`` ((K, rows, 128) each) equal to the bit
    to ``plain(a, b)``, the plain version on rows [a, b) of every worker,
    LM_CHECK_ROWS rows at a time (an Adam update is elementwise and the
    mix takes every worker at one index, so a row range is computed as in
    the whole call). Returns the elements compared."""
    for a in range(0, rows, LM_CHECK_ROWS):
        b = min(a + LM_CHECK_ROWS, rows)
        for x, y in zip(got, plain(a, b)):
            bad = int((x[:, a:b] != y).sum())
            if bad:
                raise AssertionError(f"{what}: {bad} elements of rows "
                                     f"[{a}, {b}) differ from the plain "
                                     f"version")
    return got[0].numel()


def lm_shape_times(phase: str, state, moment: str):
    """``fused_adam`` and ``gossip_adam_mix`` (K=2 ring) timed on the
    trained state's own resident buffers, (2, R, 128) params (f32, or bf16
    on lm_train_bf16p) with ``moment`` m and v, and a gradient drawn to
    their shape and dtype: the median CUDA-event time of LM_REPS calls
    each (the wrapper's host time, tens of µs, is under 0.5% of a call
    here; the profiler dropped launches of these 10-30 ms calls), beside
    the byte bound. With f32 params seven buffers of this size leave no
    room for the plain version's temporaries, and the comparison with it
    stays at SHAPE; with bf16 params each kernel's outputs are held to the
    bit to the plain version row range by row range (``lm_bit_check``).
    Where p and m share a dtype, then ``torch._fused_adam_`` the same way,
    the library call beside ``fused_adam`` (in place on p, m and v, one
    tensor a worker, after the kernels' timings; phase_kernels holds it to
    the plain version)."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import gossip as gk

    p, m, v = state.buf, state.m, state.v
    gen = torch.Generator(device=p.device).manual_seed(5)
    g = (torch.randn(p.shape, generator=gen, device=p.device) * 1e-3).to(
        p.dtype)
    topo = make_topology("ring", LM_K)
    mix = (topo.offsets, topo.offset_weights, topo.self_weight)
    n = p.numel()
    n_bytes = n * (3 * p.element_size() + 4 * m.element_size())
    bound_ms = n_bytes / MEM_RATE * 1e3
    out = {"shape": list(p.shape), "rows": int(p.shape[1]),
           "params": str(p.dtype).split(".")[-1], "moments": moment,
           "bytes": n_bytes, "bound_ms": bound_ms}
    kernels = (
        ("fused_adam", lambda: fa.fused_adam(p, g, m, v, **ADAM),
         lambda a, b: fa.fused_adam_plain(
             p[:, a:b], g[:, a:b], m[:, a:b], v[:, a:b], **ADAM)),
        ("gossip_adam_mix", lambda: gk.gossip_adam_mix(
            p, g, m, v, *mix, **ADAM),
         lambda a, b: gk.gossip_adam_mix_plain(
             p[:, a:b], g[:, a:b], m[:, a:b], v[:, a:b], *mix, **ADAM)))
    for name, fn, plain in kernels:
        ms = median_ms(fn, reps=LM_REPS, warmup=1)
        out[name] = {"ms": ms, "share_of_bound": bound_ms / ms}
        if p.dtype == torch.bfloat16:
            got = fn()
            out[name]["bit_equal_to_plain"] = lm_bit_check(
                f"{phase} {name}", got, plain, int(p.shape[1]))
            del got
    if m.dtype == p.dtype:
        ms = median_ms(fused_adam_library_call(
            list(p), list(g), list(m), list(v), ADAM,
            torch.tensor(1e7, device=p.device)), reps=LM_REPS, warmup=1)
        out["fused_adam"].update(library_ms=ms,
                                 library="torch._fused_adam_, in place")
    emit({"phase": "lm_shape_kernels", "path": phase, **out})
    del g
    return out


def phase_lm_train():
    """llama3.2-1b at full width through the training CLI as a user runs
    it: ``repro_torch.launch.train.main(LM_ARGS)``, the launch counters
    zeroed just before and read just after, the peak memory of the run;
    then step times, a profile of one period and the LM-shape kernel
    times on its state. Returns (launches, record)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run, wall_ms = synced(lambda: train.main(LM_ARGS))
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches("lm_train", launches, LM_LAUNCHES)
    cfg = get_arch(LM_ARCH).model
    if run.n_params != LM_PARAMS or run.state.spec.n != LM_PARAMS:
        raise AssertionError(f"lm_train: {run.n_params} params per worker")
    check_lm_losses("lm_train", run.log.loss, cfg.vocab_size)
    if not bool(torch.isfinite(run.state.buf).all()):
        raise AssertionError("lm_train: non-finite params")
    rec = {"phase": "lm_train", "argv": LM_ARGS,
           "params_per_worker": run.n_params,
           "buffer_shape": list(run.state.buf.shape),
           "buffer_gb": run.state.buf.numel() * 4 / 1e9,
           "moments": "float32", "losses": run.log.loss,
           "ln_vocab": math.log(cfg.vocab_size),
           "consensus": run.log.consensus, "comm_mb": run.log.comm_mb,
           "main_wall_ms": wall_ms, "peak_mem_gb": peak_gb,
           "launches": launches}
    trainer, batches, box = run.trainer, run.batches, [run.state]
    del run
    rec.update(lm_step_times("lm_train", trainer, box, batches, LM_PERIOD))
    rec.update(lm_mfu(cfg, rec))
    del trainer, batches
    state = box.pop()
    rec["lm_shape"] = lm_shape_times("lm_train", state, "float32")
    emit(rec)
    del state
    torch.cuda.empty_cache()
    return launches, rec


def lm_library_trainer(cfg, kind: str, device=None, period=LM_PERIOD,
                       **opt_kw):
    """The library path of the LM phases: ``build_model``, the stacked-loss
    adapter, ``make_optimizer`` (packed, K=2 ring) and the trainer."""
    from repro_torch.core.api import make_optimizer
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import DecentralizedTrainer, stacked_loss

    api = build_model(cfg)
    opt = make_optimizer(kind, K=LM_K, eta=LM_ETA, period=period,
                         topology="ring", backend="packed",
                         device=device or DEVICE, **opt_kw)
    return api, DecentralizedTrainer(stacked_loss(api.loss), opt)


def lm_library_run(phase: str, cfg, kind: str, want, first_step=None,
                   **opt_kw):
    """Init from the CLI's seed and ``LM_STEPS`` steps on the CLI's
    stream, one ``fit`` call a step (as the CLI's ``--log-every 1``), the
    counters zeroed before and read after, the peak memory of init and
    the steps. ``first_step(state)``, where given, is called on the state
    after init and returns a callable that is called on the state after
    the first step. Returns (trainer, [state], log, batches, launches,
    peak GB)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    api, trainer = lm_library_trainer(cfg, kind, **opt_kw)
    state = trainer.init(api.init(torch.Generator(
        device=DEVICE).manual_seed(train.PARAM_SEED)))
    batches = train.make_batch_iter(cfg, LM_K, LM_BATCH, LM_SEQ, 0.5,
                                    torch.device(DEVICE))
    log = None
    after = first_step(state) if first_step is not None else None
    for i in range(LM_STEPS):
        state, log = trainer.fit(state, batches, 1, log_every=1, log=log)
        if after is not None and i == 0:
            after(state)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(phase, launches, want)
    check_lm_losses(phase, log.loss, cfg.vocab_size)
    box = [state]
    del state
    return trainer, box, log, batches, launches, peak_gb


def phase_lm_train_bf16(f32_rec):
    """``lm_train``'s run through the library API with bf16 Adam moments
    (``make_optimizer(moment_dtype=torch.bfloat16)``; the CLI has no
    moment flag): the same launches, its peak memory against the f32
    run's, the same step times, profile and LM-shape kernel times."""
    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH).model
    trainer, box, log, batches, launches, peak_gb = lm_library_run(
        "lm_train_bf16", cfg, "d-adam", LM_LAUNCHES,
        moment_dtype=torch.bfloat16)
    if box[0].m.dtype != torch.bfloat16 or box[0].v.dtype != torch.bfloat16:
        raise AssertionError(f"lm_train_bf16: moments {box[0].m.dtype}")
    if not peak_gb < f32_rec["peak_mem_gb"]:
        raise AssertionError(f"lm_train_bf16: peak {peak_gb} GB not below "
                             f"f32's {f32_rec['peak_mem_gb']}")
    rec = {"phase": "lm_train_bf16", "moments": "bfloat16",
           "buffer_shape": list(box[0].buf.shape), "losses": log.loss,
           "losses_f32_moments": f32_rec["losses"],
           "peak_mem_gb": peak_gb, "peak_mem_gb_f32": f32_rec["peak_mem_gb"],
           "peak_saved_gb": f32_rec["peak_mem_gb"] - peak_gb,
           "launches": launches}
    rec.update(lm_step_times("lm_train_bf16", trainer, box, batches,
                             LM_PERIOD))
    rec.update(lm_mfu(cfg, rec))
    del trainer, batches
    state = box.pop()
    rec["lm_shape"] = lm_shape_times("lm_train_bf16", state, "bfloat16")
    emit(rec)
    del state
    torch.cuda.empty_cache()
    return launches, rec


def swallowed_probe(out: dict):
    """A ``first_step`` probe for ``lm_library_run``: of the elements of
    every SWALLOW_STRIDE-th row whose first Adam step is not zero (m != 0
    after it; the first step is a local one), the share whose bf16
    parameter it left unchanged, into ``out``."""
    def before(state):
        b0 = state.buf[:, ::SWALLOW_STRIDE].clone()

        def after(state):
            moved = state.m[:, ::SWALLOW_STRIDE] != 0
            same = (state.buf[:, ::SWALLOW_STRIDE].view(torch.int16)
                    == b0.view(torch.int16))
            out.update(swallowed_share=float((moved & same).sum()
                                             / moved.sum()),
                       swallowed_sampled=int(moved.sum()),
                       swallowed_stride_rows=SWALLOW_STRIDE)
        return after
    return before


def phase_lm_train_bf16p(f32_rec, bf16m_rec):
    """``lm_train_bf16``'s library path with bf16 parameter buffers: the
    model built with ``param_dtype=torch.bfloat16`` (neither CLI has a
    parameter-dtype flag), moments by default (bf16): the buffer, m and v
    bf16, lm_train's launches on them, finite losses falling from near
    ln(vocab), a peak below lm_train_bf16's; the share of the first
    step's updates that bf16 rounding swallowed; the same step times,
    profile, MFU and LM-shape kernel times (each kernel held to the bit to
    its plain version there). Returns (launches, record)."""
    from repro_torch.configs import get_arch

    bf = torch.bfloat16
    cfg = dataclasses.replace(get_arch(LM_ARCH).model, param_dtype=bf)
    swallowed = {}
    trainer, box, log, batches, launches, peak_gb = lm_library_run(
        "lm_train_bf16p", cfg, "d-adam", LM_LAUNCHES,
        first_step=swallowed_probe(swallowed))
    st = box[0]
    if (st.buf.dtype, st.m.dtype, st.v.dtype) != (bf, bf, bf):
        raise AssertionError(f"lm_train_bf16p: buffer {st.buf.dtype}, "
                             f"moments {st.m.dtype} {st.v.dtype}")
    if st.spec.n != LM_PARAMS or not bool(torch.isfinite(st.buf).all()):
        raise AssertionError(f"lm_train_bf16p: {st.spec.n} params, or not "
                             f"finite")
    if not peak_gb < bf16m_rec["peak_mem_gb"]:
        raise AssertionError(f"lm_train_bf16p: peak {peak_gb} GB not below "
                             f"lm_train_bf16's {bf16m_rec['peak_mem_gb']}")
    rec = {"phase": "lm_train_bf16p", "params": "bfloat16",
           "moments": "bfloat16", "buffer_shape": list(st.buf.shape),
           "buffer_gb": st.buf.numel() * st.buf.element_size() / 1e9,
           "losses": log.loss, "losses_f32": f32_rec["losses"],
           "losses_bf16_moments": bf16m_rec["losses"],
           "peak_mem_gb": peak_gb, "peak_mem_gb_f32": f32_rec["peak_mem_gb"],
           "peak_mem_gb_bf16_moments": bf16m_rec["peak_mem_gb"],
           **swallowed, "launches": launches}
    del st
    rec.update(lm_step_times("lm_train_bf16p", trainer, box, batches,
                             LM_PERIOD))
    rec.update(lm_mfu(cfg, rec))
    del trainer, batches
    state = box.pop()
    rec["lm_shape"] = lm_shape_times("lm_train_bf16p", state, "bfloat16")
    emit(rec)
    del state
    torch.cuda.empty_cache()
    return launches, rec


def phase_lm_bf16p_paths():
    """llama3.2-1b at full width cut to LM_CD_LAYERS layers with bf16
    params through the library path: CD-Adam as lm_train_cd runs it
    (sign_compress_stacked and consensus_mix on bf16 buffers, the hats
    bf16), then the kernel record of sign_compress_stacked on its trained
    bf16 state; then D-Adam with staleness 2 at straggler rate 0.3
    (payload_mix on bf16 buffers). Each run's launches exact. Returns
    (CD-Adam's launches, D-Adam tau=2's launches, the sign record)."""
    from repro_torch.configs import get_arch

    bf = torch.bfloat16
    cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                              n_layers=LM_CD_LAYERS, param_dtype=bf)
    trainer, box, log, batches, cd_launches, peak_gb = lm_library_run(
        "lm_train_cd_bf16p", cfg, "cd-adam", LM_CD_LAUNCHES, **CD_ADAM)
    state = box.pop()
    dts = {t.dtype for t in (state.buf, state.m, state.v, state.hat_buf,
                             *state.hat_nbr_bufs)}
    if dts != {bf}:
        raise AssertionError(f"lm_train_cd_bf16p: buffers {dts}")
    emit({"phase": "lm_train_cd_bf16p", "n_layers": cfg.n_layers,
          "params": "bfloat16", "params_per_worker": state.spec.n,
          "buffer_shape": list(state.buf.shape), "losses": log.loss,
          "consensus": log.consensus, "comm_mb": log.comm_mb,
          "peak_mem_gb": peak_gb, "launches": cd_launches})
    del trainer, batches, box
    torch.cuda.empty_cache()
    sign = lm_sign_record(state, "lm_train_cd_bf16p")
    del state
    torch.cuda.empty_cache()
    trainer, box, log, batches, tau_launches, peak_gb = lm_library_run(
        "lm_train_tau2_bf16p", cfg, "d-adam", LM_TAU2_LAUNCHES, **LM_TAU2)
    state = box.pop()
    dts = {t.dtype for t in (state.buf, state.m, state.v,
                             *state.stale.bufs)}
    if dts != {bf}:
        raise AssertionError(f"lm_train_tau2_bf16p: buffers {dts}")
    emit({"phase": "lm_train_tau2_bf16p", "n_layers": cfg.n_layers,
          "params": "bfloat16", **LM_TAU2,
          "buffer_shape": list(state.buf.shape), "losses": log.loss,
          "consensus": log.consensus, "comm_mb": log.comm_mb,
          "stale_age_max": int(state.stale.age.max()),
          "peak_mem_gb": peak_gb, "launches": tau_launches})
    del trainer, batches, box, state
    torch.cuda.empty_cache()
    return cd_launches, tau_launches, sign


def phase_lm_train_damped(f32_rec):
    """lm_train through the CLI with ``--damping geodamp:2:2:2``: the
    launch counters zeroed just before and read just after, the same
    launches as lm_train, LM_DAMPED_EVALS worker-chunk evaluations, finite
    losses, and a peak within LM_DAMPED_PEAK_SLACK_GB of lm_train's; then
    the step times and a profile of one period. Returns (launches,
    record)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run, wall_ms = synced(lambda: train.main(LM_DAMPED_ARGS))
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches("lm_train_damped", launches, LM_LAUNCHES)
    evals = (run.log.grad_evals[-1], int(run.trainer.damp_state.evals))
    if evals != (LM_DAMPED_EVALS, LM_DAMPED_EVALS):
        raise AssertionError(f"lm_train_damped: evaluations {evals}, not "
                             f"{LM_DAMPED_EVALS}")
    if not all(math.isfinite(x) for x in run.log.loss):
        raise AssertionError(f"lm_train_damped: losses {run.log.loss}")
    if peak_gb > f32_rec["peak_mem_gb"] + LM_DAMPED_PEAK_SLACK_GB:
        raise AssertionError(f"lm_train_damped: peak {peak_gb} GB, "
                             f"lm_train's {f32_rec['peak_mem_gb']}")
    rec = {"phase": "lm_train_damped", "argv": LM_DAMPED_ARGS,
           "losses": run.log.loss, "losses_undamped": f32_rec["losses"],
           "grad_evals": run.log.grad_evals, "main_wall_ms": wall_ms,
           "peak_mem_gb": peak_gb,
           "peak_mem_gb_undamped": f32_rec["peak_mem_gb"],
           "launches": launches}
    trainer, batches, box = run.trainer, run.batches, [run.state]
    del run
    rec.update(lm_step_times("lm_train_damped", trainer, box, batches,
                             LM_PERIOD))
    rec["period_device_ms_undamped"] = f32_rec["period_device_ms"]
    emit(rec)
    del trainer, batches, box
    torch.cuda.empty_cache()
    return launches


def phase_lm_train_cd():
    """CD-Adam (sign, gamma 0.4) on llama3.2-1b at full width cut to
    LM_CD_LAYERS layers, through the library path: one
    ``sign_compress_stacked`` and one ``consensus_mix`` per comm step, the
    compressor's scales one per (worker, leaf). Then the kernel record of
    ``sign_compress_stacked`` on the trained state (``lm_sign_record``).
    Returns (launches, that record)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                              n_layers=LM_CD_LAYERS)
    shapes = []
    compress = ops.sign_compress_stacked

    def recorded(*args, **kw):
        out = compress(*args, **kw)
        shapes.append(tuple(out[1].shape))
        return out

    ops.sign_compress_stacked = recorded
    try:
        trainer, box, log, batches, launches, peak_gb = lm_library_run(
            "lm_train_cd", cfg, "cd-adam", LM_CD_LAUNCHES, **CD_ADAM)
    finally:
        ops.sign_compress_stacked = compress
    state = box.pop()
    want = [(LM_K, len(state.spec.sizes))] * LM_CD_LAUNCHES[
        "sign_compress_stacked"]
    if shapes != want:
        raise AssertionError(f"lm_train_cd: scales {shapes} != {want}")
    layout = lm_cd_layout()
    if (layout.buf_shape() != state.spec.buf_shape()
            or layout.sizes != state.spec.sizes):
        raise AssertionError(f"lm_train_cd: layout {state.spec.buf_shape()}"
                             f" is not lm_cd_layout's {layout.buf_shape()}")
    rec = {"phase": "lm_train_cd", "n_layers": cfg.n_layers,
           "params_per_worker": state.spec.n,
           "buffer_shape": list(state.buf.shape), "losses": log.loss,
           "consensus": log.consensus, "comm_mb": log.comm_mb,
           "scales_shapes": shapes, "peak_mem_gb": peak_gb,
           "launches": launches}
    emit(rec)
    del trainer, batches
    torch.cuda.empty_cache()
    sign = lm_sign_record(state)
    del state
    torch.cuda.empty_cache()
    return launches, sign


def lm_sign_record(state, phase: str = "lm_train_cd") -> dict:
    """``sign_compress_stacked`` on lm_train_cd's (or, in bf16,
    lm_train_cd_bf16p's) trained state: x its params, hat its own xhat,
    (2, R, 128) f32 or bf16 over the model's leaf segments. Held to the
    plain version worker by worker (the plain version's temporaries for
    both workers would take about 25 GB), and a second call to the first
    to the bit; the median CUDA-event time of LM_REPS single calls, the
    device time per call from events around LM_REPS calls queued back to
    back (the profiler drops launches at this size: ``lm_shape_times``),
    the plain version's time over both workers, the one-pass bound (13
    bytes an element, 7 in bf16) and the two-pass figure (18, 10 in bf16).
    One launch a call: the wrapper's counter must count each call once,
    and the build found ``sign_compress_kernel`` the library's only
    kernel."""
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    x, hat = state.buf, state.hat_buf
    kw = dict(n_true=state.spec.sizes,
              row_ranges=packing.leaf_row_ranges(state.spec))
    bf16 = x.dtype == torch.bfloat16
    bounds = tuple((a * 128, b * 128) for a, b in kw["row_ranges"])

    calls = [0]

    def kernel():
        calls[0] += 1
        return sc.sign_compress_stacked(x, hat, **kw)

    def plain():
        return [sc.sign_compress_stacked_plain(x[k:k + 1], hat[k:k + 1],
                                               **kw)
                for k in range(x.shape[0])]

    launched = sc.sign_compress_stacked.launches
    got = kernel()
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for k in range(x.shape[0]):
        want = sc.sign_compress_stacked_plain(x[k:k + 1], hat[k:k + 1],
                                              **kw)
        mine = tuple(t[k:k + 1] for t in got)
        what = f"{phase} sign_compress_stacked, worker {k}"
        err = (compare_compressed_bf16(mine, want, hat[k:k + 1], bounds,
                                       what) if bf16
               else compare_compressed(mine, want, what))
        max_abs, max_rel = max(max_abs, err[0]), max(max_rel, err[1])
        del want
    check_bitwise_repeat(got, kernel, f"{phase} sign_compress_stacked")
    del got
    torch.cuda.empty_cache()
    n = x.numel()
    ms = median_ms(kernel, reps=LM_REPS, warmup=1)
    kernel()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LM_REPS):
        kernel()
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / LM_REPS
    launched = sc.sign_compress_stacked.launches - launched
    if launched != calls[0]:
        raise AssertionError(f"{phase} sign_compress_stacked: "
                             f"{launched} launches in {calls[0]} calls")
    plain_ms = median_ms(plain, reps=LM_REPS, warmup=1)
    # x and hat read, q and hat written: 13 bytes an element, 7 in bf16
    one_pass = 7 if bf16 else 13
    t_bytes, t_ops = one_pass * n / MEM_RATE * 1e3, 8 * n / F32_RATE * 1e3
    rec = {"name": "sign_compress_stacked", "route": "cuda",
           "source": "src/repro_torch/csrc/sign_compress.cu",
           "replaces": "src/repro/kernels/sign_compress.py:174",
           "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
           "tol": ({"q": "equal", "scale_rtol": SCALE_RTOL,
                    "hat_given_the_kernels_scales": "equal"} if bf16 else
                   {"q": "equal", "scale_rtol": SCALE_RTOL,
                    "hat": f"{KERNEL_TOL} + max scale * {SCALE_RTOL}"}),
           "ms": ms, "kernel_ms": ms, "kernel_device_ms": device_ms,
           "kernel_device_ms_by": f"CUDA events around {LM_REPS} calls "
                                  f"back to back",
           "plain_ms": plain_ms, "plain": "worker by worker",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": one_pass * n, "library_ms": None, "library": NO_LIBRARY,
           "variant": f"{phase}'s trained state {list(x.shape)}, "
                      f"{len(kw['n_true'])} leaf segments",
           "params": str(x.dtype).split(".")[-1],
           **sign_extra(n, launched // calls[0],
                        SIGN_NO_REUSE_BYTES_BF16 if bf16
                        else SIGN_NO_REUSE_BYTES)}
    emit({"phase": "kernel", **rec})
    return rec


def phase_lm_example():
    """The LM example as a user runs it (``repro_torch.launch.
    decentralized_lm.main(LM_EXAMPLE_ARGS)``), the launch counters zeroed
    just before and read just after: LM_EXAMPLE_LAUNCHES and no other
    kernel, the losses finite, starting near ln(vocab) and lower at the
    end. Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import decentralized_lm

    cfg = decentralized_lm.PRESETS["100m"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    log, wall_ms = synced(lambda: decentralized_lm.main(LM_EXAMPLE_ARGS))
    launches = ops.launch_counts()
    check_launches("lm_example", launches, LM_EXAMPLE_LAUNCHES)
    check_lm_losses("lm_example", log.loss, cfg.vocab_size)
    emit({"phase": "lm_example", "args": LM_EXAMPLE_ARGS,
          "losses": log.loss, "consensus": log.consensus,
          "comm_mb_total": log.comm_mb_total, "wall_ms": wall_ms,
          "step_ms": wall_ms / log.steps_total,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches})
    return launches


def phase_examples():
    """quickstart, serve_lm, online_serve and compressed_comm
    (``repro_torch.launch``) as a user runs them (``main(["--device",
    DEVICE, ...])``), the launch counters zeroed just before each and read
    just after: EXAMPLES' launches and no other kernel; the quickstart's
    losses finite and falling, serve_lm serving version 2 after its hot
    swap, online_serve's versions at steps 20, 40 and 60, compressed_comm's
    four rows in order with finite losses, AUCs above 0.5 and each row's
    comm MB equal to COMPRESSED_COMM_MB. Returns the launches summed."""
    import importlib

    from repro_torch.kernels import ops

    total = collections.Counter()
    rec = {"phase": "examples"}
    for name, args, want in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.launch.{name}")
        torch.cuda.synchronize()
        ops.reset_launches()
        out, wall_ms = synced(lambda: mod.main(["--device", DEVICE] + args))
        launches = ops.launch_counts()
        check_launches(f"examples {name}", launches, want)
        total.update(launches)
        if name == "quickstart":
            log, _ = out
            if not all(math.isfinite(x) for x in log.loss) or \
                    not log.loss[-1] < log.loss[0]:
                raise AssertionError(f"quickstart losses {log.loss}")
            got = {"losses": log.loss, "comm_mb": log.comm_mb}
        elif name == "serve_lm":
            if out.engine.last_version != 2 or any(
                    o.shape != out.outs[0][0].shape for o in out.outs[1]):
                raise AssertionError("serve_lm: not version 2 after the "
                                     "hot swap")
            got = {"last_version": out.engine.last_version,
                   "compile_counts": out.engine.compile_counts}
        elif name == "online_serve":
            result, auc_v = out
            if result.published != [(20, 1), (40, 2), (60, 3)] or \
                    not math.isfinite(auc_v):
                raise AssertionError(f"online_serve: {result.published}, "
                                     f"AUC {auc_v}")
            got = {"published": result.published, "auc": auc_v,
                   "loss": result.log.loss[-1]}
        else:
            mb = {r.label: r.comm_mb for r in out}
            if list(mb) != list(COMPRESSED_COMM_MB) or mb != \
                    COMPRESSED_COMM_MB or not all(
                        math.isfinite(r.loss) and 0.5 < r.auc < 1.0
                        for r in out):
                raise AssertionError(f"compressed_comm: rows {out}")
            got = {"rows": [r._asdict() for r in out]}
        rec[name] = {**got, "wall_ms": wall_ms, "launches": launches}
    emit(rec)
    return dict(total)


def phase_claims():
    """The paper's four claims on the card (CLAIMS, the runs of
    tests/test_system.py through ``launch.deepfm_ctr.run``), the launch
    counters zeroed just before each run and read just after: each run's
    launches exact (``dadam_launches``, ``cdadam_launches``; none for
    D-PSGD) and its comm MB the JAX accounting's; then Fig. 1 (p = 4 and 8
    within 1.35x + 0.05 of p = 1's loss and 0.05 of its AUC), Fig. 2 (p =
    8's bytes under 1/6 of p = 1's), Figs. 3-4 (CD-Adam's AUC within 0.06
    of p = 1's at under 1/12 of its bytes), Adam's AUC 0.03 above
    D-PSGD's, and p = 1's AUC above 0.62. One record with each run's loss,
    AUC, comm MB, wall ms and launches. Returns the launches summed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import deepfm_ctr

    total = collections.Counter()
    runs = {}
    for name, kind, kw, want_mb in CLAIMS:
        kw = {"backend": "packed", **kw}
        torch.cuda.synchronize()
        ops.reset_launches()
        res, wall_ms = synced(lambda: deepfm_ctr.run(
            name, "deepfm", kind, CLAIMS_STEPS, device=DEVICE, **CLAIMS_RUN,
            **kw))
        launches = ops.launch_counts()
        if kw["backend"] == "reference":
            want = {}
        elif kind == "cd-adam":
            want = cdadam_launches(CLAIMS_STEPS, kw["period"])
        else:
            want = dadam_launches(CLAIMS_STEPS, kw["period"])
        check_launches(f"claims {name}", launches, want)
        total.update(launches)
        mb = res.log.comm_mb[-1]
        if mb != want_mb or not math.isfinite(res.log.loss[-1]):
            raise AssertionError(f"claims {name}: loss {res.log.loss[-1]}, "
                                 f"comm {mb} MB != {want_mb}")
        runs[name] = {"loss": res.log.loss[-1], "auc": res.auc,
                      "comm_mb": mb, "wall_ms": wall_ms,
                      "launches": launches}
        del res
    v, sign, sgd = runs["vanilla p=1"], runs["fig34 cd-adam sign p=4"], \
        runs["d-psgd"]
    claims = {
        "fig1": all(runs[n]["loss"] < v["loss"] * 1.35 + 0.05
                    and runs[n]["auc"] > v["auc"] - 0.05
                    for n in ("fig1 p=4", "fig1 p=8")),
        "fig2": runs["fig2 p=8"]["comm_mb"] < v["comm_mb"] / 6,
        "fig34": sign["auc"] > v["auc"] - 0.06
        and sign["comm_mb"] < v["comm_mb"] / 12,
        "adam_beats_sgd": v["auc"] > sgd["auc"] + 0.03,
        "learns": v["auc"] > 0.62}
    emit({"phase": "claims", "steps": CLAIMS_STEPS, "K": K, **CLAIMS_RUN,
          "claims": claims, "runs": runs})
    if not all(claims.values()):
        raise AssertionError(f"claims: {claims}")
    return dict(total)


def adam_part_cap(steps: int, eta: float = LM_ETA, beta1: float = 0.9,
                  beta2: float = 0.999) -> float:
    """How far two runs of Adam (no bias correction) from one start can
    move an element apart in ``steps`` steps: by Cauchy-Schwarz step t
    moves it by at most eta * (1 - beta1) / sqrt(1 - beta2) *
    sqrt(sum_{j<t} (beta1^2 / beta2)^j), each run either way (3.16 eta at
    step 1, 4.97 at step 3); a mix is a convex combination and adds
    nothing."""
    lead = (1 - beta1) / math.sqrt(1 - beta2)
    r = beta1 * beta1 / beta2
    return 2 * eta * lead * sum(math.sqrt(sum(r ** j for j in range(t)))
                                for t in range(1, steps + 1))


def lm_outside(a, b, tol, spec, chunk: int = 1 << 26):
    """(max abs difference, share of elements outside ``tol``, the share
    in each leaf) of two resident buffers of layout ``spec``, worker by
    worker and leaf by leaf in f32 chunks (the buffers are GBs)."""
    from repro_torch.kernels import pack as packing

    max_abs, outside, per_leaf = 0.0, 0, []
    for r0, r1 in packing.leaf_row_ranges(spec):
        n_out = 0
        for k in range(a.shape[0]):
            fa, fb = a[k, r0:r1].reshape(-1), b[k, r0:r1].reshape(-1)
            for i in range(0, fa.numel(), chunk):
                x, y = fa[i:i + chunk].float(), fb[i:i + chunk].float()
                d = (x - y).abs()
                max_abs = max(max_abs, float(d.max()))
                n_out += int((d > tol["atol"] + tol["rtol"] * y.abs()).sum())
        per_leaf.append(n_out / (a.shape[0] * (r1 - r0) * a.shape[-1]))
        outside += n_out
    return max_abs, outside / a.numel(), per_leaf


def lm_card_cpu_cfg(arch: str, cut: dict):
    """``arch`` at full width cut to LM_CARD_CPU_LAYERS layers (and by
    ``cut``), f32 compute."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).model, **{
        "n_layers": LM_CARD_CPU_LAYERS, "compute_dtype": torch.float32,
        **cut})


def lm_cpu_worker(items, acks, threads: int) -> None:
    """The CPU sides of the LM card-vs-CPU phases, in a thread of this
    process with ``threads`` torch threads: for each arch of LM_CPU_ORDER
    the init (from the CPU's seed 0) and three packed D-Adam steps at p=3
    on the CPU (the kernels' plain versions). Each step's state goes to
    ``items`` (the init with step 1's; the step makes new buffers, so the
    state handed over stays as it was); the main thread acknowledges each
    on ``acks`` once it has compared it. A step starts only when every
    state before its input has been acknowledged, and an arch's steps
    only when the last arch's have: so at most the input state is pending,
    and the worker holds what an in-line CPU side holds."""
    import traceback

    torch.set_num_threads(threads)
    acked = set()

    def wait_for(keys):
        while not set(keys) <= acked:
            key = acks.get()
            if key is None:
                raise SystemExit(0)
            acked.add(key)

    try:
        last = []
        for arch, cut in LM_CPU_ORDER:
            cfg = lm_card_cpu_cfg(arch, cut)
            api, run = lm_library_trainer(cfg, "d-adam", device="cpu",
                                          period=3)
            params = api.init(torch.Generator().manual_seed(0))
            batches = lm_batches(cfg, seed=3, steps=3)
            state, log = run.init(params), None
            wait_for(last)
            for t in range(3):
                wait_for([(arch, u) for u in range(t - 1)])
                t0 = time.perf_counter()
                state, log = run.fit(state, iter(batches[t:t + 1]), 1,
                                     log_every=1, log=log)
                items.put({"arch": arch, "step": t,
                           "params": params if t == 0 else None,
                           "state": {n: getattr(state, n) for n in BUFS},
                           "loss": log.loss[-1],
                           "seconds_cpu": time.perf_counter() - t0,
                           "params_per_worker": state.spec.n})
            last = [(arch, t) for t in range(3)]
            del state, run, api, params
    except SystemExit:
        pass
    except BaseException:
        items.put({"error": traceback.format_exc()})


class LMCPUSides:
    """The thread of :func:`lm_cpu_worker` and the main thread's side of
    it: :meth:`poll` compares every CPU state that is ready with the
    card's (between two phases), :meth:`finish` waits for the rest,
    :meth:`close` stops the worker. The card side of an arch goes on from
    its last step within one poll, and runs again from the init in a
    later one. A thread, not a process: the states stay in this process's
    memory, where the card copies them at the host's rate (copies out of
    another process's shared memory ran many times slower on the H100
    host), and the profiler records only the thread that starts it."""

    def __init__(self):
        import queue
        import threading

        self.items, self.acks = queue.Queue(), queue.Queue()
        self.thread = threading.Thread(
            target=lm_cpu_worker, args=(self.items, self.acks,
                                        LM_CPU_THREADS), daemon=True)
        self.thread.start()
        self.left = [arch for arch, _ in LM_CPU_ORDER]
        self.runs = {}

    def poll(self, block: bool = False) -> None:
        import queue

        cursors = {}
        try:
            while self.left:
                try:
                    item = self.items.get(block=block, timeout=(
                        LM_CPU_WAIT_S if block else None))
                except queue.Empty:
                    if block:
                        raise TimeoutError(
                            f"the LM CPU sides of {self.left} not ready "
                            f"after {LM_CPU_WAIT_S} s")
                    return
                if "error" in item:
                    raise AssertionError(f"LM CPU worker failed:\n"
                                         f"{item['error']}")
                arch, t = item["arch"], item["step"]
                lm_card_vs_cpu_step(self.runs, cursors, arch,
                                    dict(LM_CPU_ORDER)[arch], item)
                del item
                self.acks.put((arch, t))
                if t == 2:
                    self.left.remove(arch)
                    lm_card_vs_cpu_emit(self.runs.pop(arch))
                    cursors.pop(arch, None)
        finally:
            cursors.clear()
            torch.cuda.empty_cache()

    def finish(self) -> None:
        self.poll(block=True)
        self.thread.join(timeout=60)

    def close(self) -> None:
        self.acks.put(None)
        self.thread.join(timeout=120)


def lm_card_vs_cpu_step(runs: dict, cursors: dict, arch: str, cut: dict,
                        cpu: dict) -> None:
    """Step ``cpu["step"]`` of ``arch``'s card side against the CPU
    state ``cpu["state"]``: ``arch`` at full width cut to
    LM_CARD_CPU_LAYERS layers (and by ``cut``: LM_CARD_CPU_CUTS), f32
    compute, packed D-Adam at period 3 on the card from the CPU side's
    init and the same batches (seq 64), through the library path. The
    card state goes on from ``cursors[arch]`` when it holds the step
    before, else runs again from the init. Params and moments within
    LM_STEP1_TOL after step 1 but for LM_STEP1_MAX_SHARE of them, and
    after step 3 at most CARD_CPU_MAX_SHARE of them outside CARD_CPU_TOL,
    as ``card_vs_cpu`` holds DeepFM's, in every leaf too. The params that
    part lie within ``adam_part_cap``: unlike DeepFM's (within eta), an
    LM's can part by more than eta (rwkv6's by 1.86 eta at step 3 on the
    H100, 1.1e-5 of them), as far as Adam's normalised steps reach; a
    wrong leaf, worker or neighbour shows as whole leaves apart."""
    t = cpu["step"]
    if t == 0:
        cfg = lm_card_cpu_cfg(arch, cut)
        api, run = lm_library_trainer(cfg, "d-adam", device=DEVICE,
                                      period=3)
        runs[arch] = {"arch": arch, "cut": cut, "cfg": cfg, "run": run,
                      "params": cpu["params"], "steps": [],
                      "batches": lm_batches(cfg, seed=3, steps=3),
                      "losses_card": [], "losses_cpu": [],
                      "seconds_card": 0.0, "seconds_cpu": 0.0,
                      "card_reruns": 0}
    rec = runs[arch]
    state, log, done = cursors.get(arch, (None, None, None))
    if done != t - 1:
        rec["card_reruns"] += t > 0
        state, log, done = rec["run"].init(rec["params"]), None, -1
    for u in range(done + 1, t + 1):
        t0 = time.perf_counter()
        state, log = rec["run"].fit(state, iter(rec["batches"][u:u + 1]),
                                    1, log_every=1, log=log)
        torch.cuda.synchronize()
        if u == t:
            rec["seconds_card"] += time.perf_counter() - t0
    cursors[arch] = (state, log, t)
    got = {}
    for name in BUFS:
        # compared on the card: the CPU's buffer is copied over
        card = getattr(state, name)
        host = cpu["state"][name].to(card.device)
        tol = LM_STEP1_TOL if t == 0 else CARD_CPU_TOL
        max_abs, share, per_leaf = lm_outside(card, host, tol, state.spec)
        got[name] = {"max_abs_err": max_abs, "share_outside": share,
                     "outside": round(share * card.numel()),
                     "max_leaf_share": max(per_leaf)}
        del host
        share_cap = LM_STEP1_MAX_SHARE if t == 0 else CARD_CPU_MAX_SHARE
        bad = share > share_cap or (t and max(per_leaf) > share_cap)
        if name == "buf":
            got[name]["cap"] = adam_part_cap(t + 1)
            bad = bad or max_abs > got[name]["cap"]
        if t in (0, 2) and bad:
            raise AssertionError(f"{arch} step {t + 1} {name}: "
                                 f"{got[name]} past share {share_cap}")
    rec["steps"].append({"step": t + 1, **got})
    rec["losses_card"].append(log.loss[-1])
    rec["losses_cpu"].append(cpu["loss"])
    rec["seconds_cpu"] += cpu["seconds_cpu"]
    rec["params_per_worker"] = cpu["params_per_worker"]


def lm_card_vs_cpu_emit(rec: dict) -> None:
    """The record of one arch's three steps: the losses within
    CARD_CPU_TOL, each step's distances."""
    arch = rec["arch"]
    loss_err = compare([torch.tensor(rec["losses_card"])],
                       [torch.tensor(rec["losses_cpu"])], CARD_CPU_TOL,
                       f"{arch} losses")[0]
    emit({"phase": "lm_card_vs_cpu", "arch": arch,
          "n_layers": rec["cfg"].n_layers,
          "cut": rec["cut"], "compute_dtype": "float32", "seq": 64,
          "period": 3, "params_per_worker": rec["params_per_worker"],
          "losses_card": rec["losses_card"],
          "losses_cpu": rec["losses_cpu"],
          "loss_max_abs_err": loss_err, "steps": rec["steps"],
          "step1_tol": LM_STEP1_TOL, "step1_max_share": LM_STEP1_MAX_SHARE,
          "tol": CARD_CPU_TOL,
          "max_share_outside": CARD_CPU_MAX_SHARE,
          "seconds_card": rec["seconds_card"],
          "seconds_cpu": rec["seconds_cpu"],
          "card_reruns": rec["card_reruns"],
          "cpu_side": f"a worker thread, {LM_CPU_THREADS} torch threads"})


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree to time fused_adam "
                    "(beside torch._fused_adam_), the f32 flash, "
                    "gossip_adam_mix and sign_compress_stacked kernels and "
                    "the DeepFM periods against")
    ap.add_argument("--ab-side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ab_side:
        emit(ab_side(args.ab_side))
        return 0
    card, smi = phase_env()
    if args.parent:
        phase_parent_ab(args.parent)
        print(smi, flush=True)
        return 0
    phase_build()
    records = phase_kernels()
    by_path = {}
    for path in PATHS:
        by_path[path], (trainer, state, res) = phase_slice(path)
        # the async states go on from their slice, so no phase holds
        # another path's buffers while its peak memory is read
        if path in ("d-adam-straggler", "cd-adam-overlap"):
            phase_checkpoint(path, trainer, state, res.batches)
        if path == "d-adam-straggler":
            phase_churn(trainer, state, res.teacher)
        del trainer, state, res
    axis_paths, gates, corpus = phase_axis()
    by_path.update(axis_paths)
    axis2d_paths, gates2d = phase_axis2d()
    by_path.update(axis2d_paths)
    by_path["axis2d_plan"], gates_plan, plan_block = phase_axis2d_plan()
    records.append(plan_block)
    family_paths, family_blocks = phase_axis2d_plan_families()
    by_path.update(family_paths)
    records.extend(family_blocks)
    phase_invariants(gates + gates2d + gates_plan, corpus)
    # after the axis phases, whose 8 ranks share the host's cores
    lm_cpu = LMCPUSides()
    try:
        return run_phases(lm_cpu, records, by_path, card, smi)
    finally:
        lm_cpu.close()


def run_phases(lm_cpu: LMCPUSides, records: list, by_path: dict,
               card: str, smi: str) -> int:
    """The phases after the axis phases, in order; between two phases the
    card sides of the LM card-vs-CPU phases whose CPU sides are ready."""
    def step(out=None):
        lm_cpu.poll()
        return out

    step(phase_card_vs_cpu("d-adam"))
    step(phase_card_vs_cpu("cd-adam"))
    step(phase_card_vs_cpu("d-adam-straggler", period=1))
    step(phase_card_vs_cpu("cd-adam-overlap", period=1))
    by_path["damped"] = step(phase_damped())
    step(phase_card_vs_cpu("d-adam", damping=DAMPING))
    by_path["vision"] = step(phase_vision())
    step(phase_vision_card_vs_cpu())
    by_path["serve"] = step(phase_serve())
    step(phase_serve_card_vs_cpu())
    by_path["online"] = step(phase_online())
    by_path["serve_rwkv"] = step(phase_serve_rwkv())
    from repro_torch.configs import get_arch
    step(phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_RWKV_ARCH).model, n_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_rwkv_card_vs_cpu"))
    by_path["serve_zamba2"] = step(phase_serve_zamba2())
    step(phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_ZAMBA2_ARCH).model,
                                n_layers=2, shared_attn_period=1),
        seq=128, new_tokens=5, batch=2, phase="serve_zamba2_card_vs_cpu"))
    by_path["serve_moe"] = step(phase_serve_moe())
    by_path["serve_vlm"] = step(phase_serve_vlm())
    step(phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_VLM_ARCH).model, n_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_vlm_card_vs_cpu",
        f32_row_scale=True))
    by_path["serve_whisper"] = step(phase_serve_whisper())
    step(phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_WHISPER_ARCH).model,
                                n_layers=2, n_encoder_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_whisper_card_vs_cpu"))
    by_path["lm_train"], f32_rec = step(phase_lm_train())
    by_path["lm_train_bf16"], bf16_rec = step(phase_lm_train_bf16(f32_rec))
    by_path["lm_train_bf16p"], bf16p_rec = step(
        phase_lm_train_bf16p(f32_rec, bf16_rec))
    by_path["lm_train_damped"] = step(phase_lm_train_damped(f32_rec))
    by_path["lm_train_cd"], lm_sign = step(phase_lm_train_cd())
    records.append(lm_sign)
    (by_path["lm_train_cd_bf16p"], by_path["lm_train_tau2_bf16p"],
     lm_sign_bf16) = step(phase_lm_bf16p_paths())
    records.append(lm_sign_bf16)
    by_path["examples"] = step(phase_examples())
    by_path["claims"] = step(phase_claims())
    lm_cpu.finish()
    by_path["lm_example"] = phase_lm_example()
    lm_shape = {"float32": f32_rec["lm_shape"],
                "bfloat16": bf16_rec["lm_shape"],
                "bf16 params": bf16p_rec["lm_shape"]}
    for rec in records:
        # a bf16-param form counts the launches of the bf16-param paths,
        # every other form those of the other paths
        bf16p = rec.get("params") == "bfloat16"
        rec["launches_by_path"] = {k: c[rec["name"]]
                                   for k, c in by_path.items()
                                   if (k in BF16P_PATHS) == bf16p}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["name"] in ("fused_adam", "gossip_adam_mix"):
            # the same kernel at the LM shape, on lm_train's (f32),
            # lm_train_bf16's (bf16 moments) and lm_train_bf16p's (bf16
            # params and moments) state
            key = {"bf16 m and v": "bfloat16",
                   "bf16 params, bf16 m and v": "bf16 params"}.get(
                       rec.get("variant"), "float32")
            if bf16p and key == "float32":
                continue        # bf16 params with f32 moments: no LM run
            lm = lm_shape[key]
            rec["lm_shape"] = {"shape": lm["shape"], "bound_ms":
                               lm["bound_ms"], **lm[rec["name"]]}
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

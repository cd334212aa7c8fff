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
   [1, 8], the evaluations their sum, the loss falling; step times, a
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

Every phase's line holds ``elapsed_s``, the seconds since the script
started.

The kernels phase holds ``fused_adam`` and ``gossip_adam_mix`` with
bf16 moments too (m and v within one bf16 ulp, p within 2e-5) and at the
vision phase's weight decay 1e-4, and takes
the profiler's device time of every kernel beside its CUDA-event time. It
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

times the f32 ``flash_attention`` cases, ``gossip_adam_mix``,
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
# the tensor cores (operations/s), at its full 700 W power limit
MEM_RATE = 3.35e12
F32_RATE = 67e12
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
# the dense bf16 and TF32 tensor-core peaks of the H100 SXM at 700 W
# (operations/s)
BF16_RATE = 989e12
TF32_RATE = 495e12
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
# --parent: the f32 flash cases above that a tree takes, gossip_adam_mix
# and sign_compress_stacked at SHAPE and the DeepFM periods (ab_side),
# timed in one process per turn of parent (P) and change (C)
AB_ORDER = "PCCP"
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
# CD-Adam at full width cut to 4 layers (16 would take about 100 GB):
# fused_adam on all 8 steps, sign_compress_stacked and consensus_mix once
# per comm step
LM_CD_LAYERS = 4
LM_CD_LAUNCHES = {"fused_adam": 8, "sign_compress_stacked": 2,
                  "consensus_mix": 2}
# the first loss of random weights lies near ln(vocab): the logits' spread
# at init adds about half its square
LM_LOSS0_SLACK = 1.5
# calls per timing at the LM shape (each moves 50-70 GB)
LM_REPS = 5
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


def sign_extra(elements: int) -> dict:
    """The sign_compress record's 18-byte figure beside its 13-byte
    bound, and its launch and equality checks."""
    return {"bytes_no_reuse": SIGN_NO_REUSE_BYTES * elements,
            "no_reuse_ms": SIGN_NO_REUSE_BYTES * elements / MEM_RATE * 1e3,
            "launches_per_call": 1, "second_call_bit_equal": True}


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
    """``name<dtype,D>`` of a mangled kernel: the name is the one
    "<length><name>" that ends in ``_kernel``, then its template args
    ("I...E"; the dtype where the template takes one, the head dim)."""
    for at in range(len(mangled)):
        digits = re.match(r"\d+", mangled[at:])
        if not digits:
            continue
        start = at + digits.end()
        name = mangled[start:start + int(digits.group())]
        if re.fullmatch(r"[a-z_][a-z0-9_]*_kernel", name):
            args = re.match(r"I.*?E", mangled[start + len(name):])
            if not args:
                return name
            dt = ("bf16," if "bfloat16" in args.group() else
                  "f32," if args.group().startswith("If") else "")
            d = re.search(r"Li(\d+)E", args.group())
            return f"{name}<{dt}{d.group(1) if d else '?'}>"
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
    if sign != ["sign_compress:sign_compress_kernel"]:
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

    def fused_adam_library(hp):
        lib = (p.clone(), m.clone(), v.clone())

        def call():
            torch._fused_adam_(
                [lib[0]], [g], [lib[1]], [lib[2]], [], [lib_step],
                lr=hp["eta"], beta1=hp["beta1"], beta2=hp["beta2"],
                weight_decay=hp["weight_decay"], eps=hp["tau"],
                amsgrad=False, maximize=False)
            return lib

        err = compare(call(), fa.fused_adam_plain(p, g, m, v, **hp),
                      KERNEL_TOL, "torch._fused_adam_ against "
                      f"fused_adam_plain, weight decay {hp['weight_decay']}"
                      )[0]
        return call, err

    fused_adam_lib, fused_adam_library_err = fused_adam_library(adam)
    fused_adam_lib_wd, fused_adam_library_err_wd = fused_adam_library(
        adam_wd)
    # bf16 moments (make_optimizer(moment_dtype=torch.bfloat16)): p and g
    # f32, m and v bf16; 20 bytes an element
    mb, vb = m.to(torch.bfloat16), v.to(torch.bfloat16)
    # f32 operations per element: Adam half-step 12 (3 for m, 4 for v, 4
    # for the step incl. sqrt and division, 1 for p); mix 1 + 2 per offset
    cases = [
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, m, v, **adam),
             plain=lambda: fa.fused_adam_plain(p, g, m, v, **adam),
             library=fused_adam_lib,
             library_desc="torch._fused_adam_ (state_steps 1e7: bias "
                          "corrections 1; checked against the plain "
                          "version within KERNEL_TOL)",
             library_err=fused_adam_library_err,
             bytes=7 * buf_bytes, ops=12 * n, device="fused_adam_kernel"),
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, mb, vb, **adam),
             plain=lambda: fa.fused_adam_plain(p, g, mb, vb, **adam),
             bf16_moments=True, library=None, bytes=20 * n, ops=12 * n,
             device="fused_adam_kernel", variant="bf16 m and v"),
        # ResNet-20's weight decay (the paper's CIFAR setting): the
        # kernels' weight-decay operand, off on every other path
        dict(name="fused_adam", source="src/repro_torch/csrc/fused_adam.cu",
             replaces="src/repro/kernels/fused_adam.py:66",
             kernel=lambda: fa.fused_adam(p, g, m, v, **adam_wd),
             plain=lambda: fa.fused_adam_plain(p, g, m, v, **adam_wd),
             library=fused_adam_lib_wd,
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
        dict(name="sign_compress",
             source="src/repro_torch/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:65",
             kernel=lambda: sc.sign_compress(xs, hs1),
             plain=lambda: sc.sign_compress_plain(xs, hs1),
             compressed=True, library=None, bytes=13 * PARAMS,
             ops=8 * PARAMS, device=SIGN_KERNELS, per_call=1,
             elements=PARAMS,
             variant="one worker's 11,202,602 elements, flat"),
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
        elif c.get("bf16_moments"):
            tol = {"p": BF16_MOMENT_P_TOL, "m, v": "within 1 bf16 ulp"}
            max_abs, max_rel = compare_bf16_moments(got, want, c["name"])
        else:
            max_abs, max_rel = compare(got, want, tol, c["name"])
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
        if c.get("compressed"):
            rec.update(sign_extra(c["elements"]))
        if "variant" in c:
            rec["variant"] = c["variant"]
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
    del fused_adam_lib, fused_adam_lib_wd
    torch.cuda.empty_cache()
    return records + flash_records() + rwkv_records()


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks keep, per batch row and head."""
    import numpy as np

    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(S, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


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
        ops = 4 * D * B * Hq * attention_pairs(S, T, causal, window)
        # bf16: the two products on the tensor cores; f32: each as three
        # TF32 products (3xTF32), the fastest f32-accurate product the card
        # has, so 3 * ops at the TF32 peak
        t_ops = (ops / BF16_RATE if dt == torch.bfloat16
                 else 3 * ops / TF32_RATE) * 1e3
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


def card_events(prof):
    """The profile's aggregated CUDA kernel events, the pad left out."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and PAD_KERNEL not in e.key]


def launched_kernels(fn) -> list:
    """The names (their first 60 characters) of the CUDA kernels one call
    of ``fn`` launched (one profile): what a library call runs."""
    with card_profile() as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in card_events(prof)})


def check_no_old_sign_kernel(prof, what: str) -> None:
    """Raise if the profile recorded a launch of one of the three kernels
    that the persistent sign_compress kernel replaced."""
    old = sorted({e.key[:60] for e in card_events(prof)
                  if OLD_SIGN_KERNEL.search(e.key)})
    if old:
        raise AssertionError(f"{what}: the profile recorded {old}, kernels "
                             f"of the replaced sign_compress design")


def matched_device_us(prof, names) -> tuple[float, int]:
    """(device µs, calls) of the profiled CUDA kernels whose name holds
    one of ``names``."""
    us, calls = 0.0, 0
    for e in card_events(prof):
        if any(n in e.key for n in names):
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            calls += e.count
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
        if not old_ok:
            check_no_old_sign_kernel(prof, str(kernel))
        us, calls = matched_device_us(prof, names)
        if per_call is not None and calls > per_call * reps:
            raise AssertionError(f"{kernel}: {calls} launches in {reps} "
                                 f"calls, not {per_call} a call")
        if calls >= reps and us > 0:
            return us / 1e3 / reps
    raise AssertionError(f"the profiler recorded {calls} launches of "
                         f"{kernel} ({us} µs) in {reps} calls, {attempts} "
                         f"times")


def ab_side(src: str) -> dict:
    """One turn of ``--parent``: the ``repro_torch`` under ``src`` timed
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
    from repro_torch.kernels import gossip as gk
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    def timed(fn, kernel):
        return {"ms": median_ms(fn), "device_ms": device_kernel_ms(fn, kernel)}

    out = {}
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
        vals = [r[case][key] for r in runs[side]]
        return None if None in vals else statistics.median(vals)

    median = {case: {name: ({key: med(side, case, key)
                             for key in ("ms", "device_ms")}
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
    if not old_ok:
        check_no_old_sign_kernel(prof, "device_profile")
    rows, ranges = [], {}
    for e in prof.key_averages():
        if e.key.startswith("repro_torch."):
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            got = ranges.setdefault(e.key, {"device_ms": 0.0, "calls": 0})
            got["device_ms"] = max(got["device_ms"], total / 1e3)
            got["calls"] = max(got["calls"], e.count)
            continue
        if not str(e.device_type).endswith("CUDA") or PAD_KERNEL in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    calls = collections.Counter(
        e.name for e in prof.events()
        if e.cpu_parent is None and e.name.startswith("aten::"))
    kernel_us, kernel_calls = matched_device_us(prof, kernel_names)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_ms": kernel_us / 1e3, "kernel_calls": kernel_calls,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "torch_calls": sum(calls.values()),
            "torch_calls_top": calls.most_common(8), "ranges": ranges,
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
           "per_bucket": per_bucket, "peak_mem_gb": peak_gb,
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

    def spy(params, x, **routing):
        shares.append(moe.dropped_share(params, x, **routing))
        return forward(params, x, **routing)

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
    trainer = DecentralizedTrainer(deepfm_loss, opt, damping=dcfg)
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
          "chunk_counts": per_step, "losses": log.loss,
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


def lm_shape_times(phase: str, state, moment: str):
    """``fused_adam`` and ``gossip_adam_mix`` (K=2 ring) timed on the
    trained state's own resident buffers, (2, R, 128) f32 params with
    ``moment`` m and v, and a gradient drawn to their shape: the median
    CUDA-event time of LM_REPS calls each (the wrapper's host time, tens
    of µs, is under 0.5% of a call here; the profiler dropped launches of
    these 20-30 ms calls), beside the byte bound. Seven buffers of this
    size leave no room for the plain version's temporaries; the
    comparison with it stays at SHAPE. With f32 moments, then
    ``torch._fused_adam_`` the same way, the library call beside
    ``fused_adam`` (in place on p, m and v, one tensor a worker, after the
    kernels' timings; phase_kernels holds it to the plain version)."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import gossip as gk

    p, m, v = state.buf, state.m, state.v
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
    topo = make_topology("ring", LM_K)
    mix = (topo.offsets, topo.offset_weights, topo.self_weight)
    n = p.numel()
    n_bytes = n * (3 * 4 + 4 * m.element_size())
    bound_ms = n_bytes / MEM_RATE * 1e3
    out = {"shape": list(p.shape), "rows": int(p.shape[1]),
           "moments": moment, "bytes": n_bytes, "bound_ms": bound_ms}
    for name, fn in (
            ("fused_adam", lambda: fa.fused_adam(p, g, m, v, **ADAM)),
            ("gossip_adam_mix", lambda: gk.gossip_adam_mix(
                p, g, m, v, *mix, **ADAM))):
        ms = median_ms(fn, reps=LM_REPS, warmup=1)
        out[name] = {"ms": ms, "share_of_bound": bound_ms / ms}
    if m.dtype == torch.float32:
        step = torch.tensor(1e7, device="cuda")
        ms = median_ms(lambda: torch._fused_adam_(
            list(p), list(g), list(m), list(v), [], [step] * p.shape[0],
            lr=ADAM["eta"], beta1=ADAM["beta1"], beta2=ADAM["beta2"],
            weight_decay=ADAM["weight_decay"], eps=ADAM["tau"],
            amsgrad=False, maximize=False), reps=LM_REPS, warmup=1)
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


def lm_library_run(phase: str, cfg, kind: str, want, **opt_kw):
    """Init from the CLI's seed and ``LM_STEPS`` steps on the CLI's
    stream, one ``fit`` call a step (as the CLI's ``--log-every 1``), the
    counters zeroed before and read after, the peak memory of init and
    the steps. Returns (trainer, [state], log, batches, launches, peak
    GB)."""
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
    for _ in range(LM_STEPS):
        state, log = trainer.fit(state, batches, 1, log_every=1, log=log)
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
    del trainer, batches
    state = box.pop()
    rec["lm_shape"] = lm_shape_times("lm_train_bf16", state, "bfloat16")
    emit(rec)
    del state
    torch.cuda.empty_cache()
    return launches, rec


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


def lm_sign_record(state) -> dict:
    """``sign_compress_stacked`` on lm_train_cd's trained state: x its
    params, hat its own xhat, (2, R, 128) f32 over the model's leaf
    segments. Held to the plain version worker by worker (the plain
    version's temporaries for both workers would take about 25 GB), and a
    second call to the first to the bit; the median CUDA-event time of
    LM_REPS single calls, the device time per call from events around
    LM_REPS calls queued back to back (the profiler drops launches at
    this size: ``lm_shape_times``), the plain version's time over both
    workers, the 13-byte bound and the 18-byte figure. One launch a call:
    the wrapper's counter must count each call once, and the build found
    ``sign_compress_kernel`` the library's only kernel."""
    from repro_torch.kernels import pack as packing
    from repro_torch.kernels import sign_compress as sc

    x, hat = state.buf, state.hat_buf
    kw = dict(n_true=state.spec.sizes,
              row_ranges=packing.leaf_row_ranges(state.spec))

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
        err = compare_compressed(tuple(t[k:k + 1] for t in got), want,
                                 f"lm_train_cd sign_compress_stacked, "
                                 f"worker {k}")
        max_abs, max_rel = max(max_abs, err[0]), max(max_rel, err[1])
        del want
    check_bitwise_repeat(got, kernel, "lm_train_cd sign_compress_stacked")
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
        raise AssertionError(f"lm_train_cd sign_compress_stacked: "
                             f"{launched} launches in {calls[0]} calls")
    plain_ms = median_ms(plain, reps=LM_REPS, warmup=1)
    t_bytes, t_ops = 13 * n / MEM_RATE * 1e3, 8 * n / F32_RATE * 1e3
    rec = {"name": "sign_compress_stacked", "route": "cuda",
           "source": "src/repro_torch/csrc/sign_compress.cu",
           "replaces": "src/repro/kernels/sign_compress.py:174",
           "launches": None, "max_abs_err": max_abs, "max_rel_err": max_rel,
           "tol": {"q": "equal", "scale_rtol": SCALE_RTOL,
                   "hat": f"{KERNEL_TOL} + max scale * {SCALE_RTOL}"},
           "ms": ms, "kernel_ms": ms, "kernel_device_ms": device_ms,
           "kernel_device_ms_by": f"CUDA events around {LM_REPS} calls "
                                  f"back to back",
           "plain_ms": plain_ms, "plain": "worker by worker",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": 13 * n, "library_ms": None, "library": NO_LIBRARY,
           "variant": f"lm_train_cd's trained state {list(x.shape)}, "
                      f"{len(kw['n_true'])} leaf segments",
           **sign_extra(n)}
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


def phase_lm_card_vs_cpu(arch: str, **cut):
    """``arch`` at full width cut to LM_CARD_CPU_LAYERS layers (and by
    ``cut``, config fields replaced: LM_CARD_CPU_CUTS), f32 compute, three
    steps of packed D-Adam at period 3 on the card and on the CPU in lock
    step, from one init (drawn on the CPU) and one set of batches (seq
    64), through the library path: params and moments within LM_STEP1_TOL
    after step 1 but for LM_STEP1_MAX_SHARE of them, and after step 3 at
    most CARD_CPU_MAX_SHARE of them outside CARD_CPU_TOL, as
    ``card_vs_cpu`` holds DeepFM's, in every leaf too. The params that
    part lie within ``adam_part_cap``: unlike DeepFM's (within eta), an
    LM's can part by more than eta (rwkv6's by 1.86 eta at step 3 on the
    H100, 1.1e-5 of them), as far as Adam's normalised steps reach; a
    wrong leaf, worker or neighbour shows as whole leaves apart."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch).model, **{
        "n_layers": LM_CARD_CPU_LAYERS, "compute_dtype": torch.float32,
        **cut})
    batches = lm_batches(cfg, seed=3, steps=3)
    runs, states, logs = {}, {}, {}
    seconds = {DEVICE: 0.0, "cpu": 0.0}
    step_rec = []
    for dev in (DEVICE, "cpu"):
        api, runs[dev] = lm_library_trainer(cfg, "d-adam", device=dev,
                                            period=3)
    params = api.init(torch.Generator().manual_seed(0))
    for dev in (DEVICE, "cpu"):
        states[dev], logs[dev] = runs[dev].init(params), None
    del params
    for t in range(3):
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            states[dev], logs[dev] = runs[dev].fit(
                states[dev], iter(batches[t:t + 1]), 1, log_every=1,
                log=logs[dev])
            if dev == DEVICE:
                torch.cuda.synchronize()
            seconds[dev] += time.perf_counter() - t0
        got = {}
        spec = states["cpu"].spec
        for name in ("buf", "m", "v"):
            # compared on the card: the CPU's buffer is copied over
            card = getattr(states[DEVICE], name)
            cpu = getattr(states["cpu"], name).to(card.device)
            tol = LM_STEP1_TOL if t == 0 else CARD_CPU_TOL
            max_abs, share, per_leaf = lm_outside(card, cpu, tol, spec)
            got[name] = {"max_abs_err": max_abs, "share_outside": share,
                         "outside": round(share * card.numel()),
                         "max_leaf_share": max(per_leaf)}
            del cpu
            share_cap = LM_STEP1_MAX_SHARE if t == 0 else CARD_CPU_MAX_SHARE
            bad = share > share_cap or (t and max(per_leaf) > share_cap)
            if name == "buf":
                got[name]["cap"] = adam_part_cap(t + 1)
                bad = bad or max_abs > got[name]["cap"]
            if t in (0, 2) and bad:
                raise AssertionError(f"{arch} step {t + 1} {name}: "
                                     f"{got[name]} past share {share_cap}")
        step_rec.append({"step": t + 1, **got})
    loss_err = compare([torch.tensor(logs[DEVICE].loss)],
                       [torch.tensor(logs["cpu"].loss)], CARD_CPU_TOL,
                       f"{arch} losses")[0]
    emit({"phase": "lm_card_vs_cpu", "arch": arch,
          "n_layers": cfg.n_layers,
          "cut": cut, "compute_dtype": "float32", "seq": 64, "period": 3,
          "params_per_worker": states["cpu"].spec.n,
          "losses_card": logs[DEVICE].loss, "losses_cpu": logs["cpu"].loss,
          "loss_max_abs_err": loss_err, "steps": step_rec,
          "step1_tol": LM_STEP1_TOL, "step1_max_share": LM_STEP1_MAX_SHARE,
          "tol": CARD_CPU_TOL,
          "max_share_outside": CARD_CPU_MAX_SHARE,
          "seconds_card": seconds[DEVICE], "seconds_cpu": seconds["cpu"]})
    del states, runs
    torch.cuda.empty_cache()


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree to time the f32 "
                    "flash, gossip_adam_mix and sign_compress_stacked "
                    "kernels and the DeepFM periods against")
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
    phase_card_vs_cpu("d-adam")
    phase_card_vs_cpu("cd-adam")
    phase_card_vs_cpu("d-adam-straggler", period=1)
    phase_card_vs_cpu("cd-adam-overlap", period=1)
    by_path["damped"] = phase_damped()
    phase_card_vs_cpu("d-adam", damping=DAMPING)
    by_path["vision"] = phase_vision()
    phase_vision_card_vs_cpu()
    by_path["serve"] = phase_serve()
    phase_serve_card_vs_cpu()
    by_path["online"] = phase_online()
    by_path["serve_rwkv"] = phase_serve_rwkv()
    from repro_torch.configs import get_arch
    phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_RWKV_ARCH).model, n_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_rwkv_card_vs_cpu")
    by_path["serve_zamba2"] = phase_serve_zamba2()
    phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_ZAMBA2_ARCH).model,
                                n_layers=2, shared_attn_period=1),
        seq=128, new_tokens=5, batch=2, phase="serve_zamba2_card_vs_cpu")
    by_path["serve_moe"] = phase_serve_moe()
    by_path["serve_vlm"] = phase_serve_vlm()
    phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_VLM_ARCH).model, n_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_vlm_card_vs_cpu",
        f32_row_scale=True)
    by_path["serve_whisper"] = phase_serve_whisper()
    phase_serve_card_vs_cpu(
        cfg=dataclasses.replace(get_arch(SERVE_WHISPER_ARCH).model,
                                n_layers=2, n_encoder_layers=2),
        seq=128, new_tokens=5, batch=2, phase="serve_whisper_card_vs_cpu")
    by_path["lm_train"], f32_rec = phase_lm_train()
    by_path["lm_train_bf16"], bf16_rec = phase_lm_train_bf16(f32_rec)
    by_path["lm_train_damped"] = phase_lm_train_damped(f32_rec)
    by_path["lm_train_cd"], lm_sign = phase_lm_train_cd()
    records.append(lm_sign)
    phase_lm_card_vs_cpu(LM_ARCH)
    phase_lm_card_vs_cpu(SERVE_RWKV_ARCH)
    for arch, cut in LM_CARD_CPU_CUTS.items():
        phase_lm_card_vs_cpu(arch, **cut)
    by_path["lm_example"] = phase_lm_example()
    lm_shape = {"float32": f32_rec["lm_shape"],
                "bfloat16": bf16_rec["lm_shape"]}
    for rec in records:
        rec["launches_by_path"] = {k: c[rec["name"]]
                                   for k, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["name"] in ("fused_adam", "gossip_adam_mix"):
            # the same kernel at the LM shape, on lm_train's (f32) and
            # lm_train_bf16's (bf16) state
            moment = ("bfloat16" if rec.get("variant") == "bf16 m and v"
                      else "float32")
            lm = lm_shape[moment]
            rec["lm_shape"] = {"shape": lm["shape"], "bound_ms":
                               lm["bound_ms"], **lm[rec["name"]]}
    emit({"kernels": records})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

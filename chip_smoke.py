#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the port's four CUDA kernel libraries from the checkout's
sources (one ``nvcc`` each, started together) and then:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds the flash-attention kernel against its plain PyTorch version on
   the card: the reference kernel tests' sweep in f32 and bf16, causal,
   windowed and non-causal, plus GQA, ragged lengths, head dim 80,
   ring-buffer positions with unwritten (-1) slots (also with S and T
   ragged against the kernel's 128-row tiles, at head dims 80 and 128),
   strided views, the served attention models' prefill shapes, the
   other dense configs' head layouts (MHA 32/32, groups of 6 and 4, at
   head dim 128) and whisper-base's three attentions (MHA 8/8 at head dim
   64: the encoder's, non-causal at S = T = 512; the cross-attention,
   non-causal with 1024 queries over 512 keys; the decoder's, causal at
   1024); then what training reads of it: its log-sum-exp output at
   those shapes and the train shapes, and the autograd op's gradients
   with the kernel forward against those with the plain forward;
3. times the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) at qwen3's, granite's and zamba2's prefill shapes (head dims
   128, 64 and 80) and whisper-base's two non-causal ones, in device
   time (the kernel's and SDPA's three times each, with the kernels SDPA
   ran) and in CUDA events, beside the card's bound;
4. holds the grouped expert matmul (MoE) kernels against their plain
   version in f32 and bf16 (bf16 has a wide kernel for many rows an
   expert and a narrow one for few; each case checks which ran): the
   reference sweep, ragged capacities, 64-row half-tiles ending inside a
   batch row, rows on each side of the narrow kernel's limit, its N at 8
   to 64, strided 4-d expert buffers and granite-moe's prefill and decode
   shapes; then times both products (wi and wo) at those two shapes, with
   the kernel chosen and the host's time a call, beside the plain version,
   ``torch.bmm`` (a yardstick only) and the card's bound;
5. holds the Mamba2 SSD scan kernel against its plain version in f32 and
   bf16: the reference sweep, ragged lengths, an initial state, a strided
   view and zamba2's prefill shape (its bf16 error printed apart); then
   times it and the plain version there, beside the card's bound (no
   single PyTorch call computes it), and the kernel on the first batch
   row alone;
6. holds the RWKV6 WKV kernel against its plain version in f32 and bf16:
   the reference sweep, a nonzero bonus u, ragged lengths, an initial
   state, decays up to and at the rate cap, lengths ending inside and at
   the end of a turn of the kernel's ring of two chunks, strided views and
   rwkv6-7b's prefill shape; then times it and the plain version there,
   beside the card's bound (no single PyTorch call computes the
   recurrence);
7. serves full-width qwen3-0.6b (28 layers), granite-moe-1b-a400m (24
   layers, 32 experts top-8), zamba2-2.7b (54 Mamba2 layers and a shared
   attention block after every 6th) and rwkv6-7b (32 RWKV6 layers,
   attention-free), one after the other, random weights from seed 0,
   under GCR admission: 8 streams on 3 slots, prompt 1024, 16 generated
   tokens each.  Each run starts with the launch counts at 0 and checks
   them after (flash once an attention block a wave; for granite also
   the expert products, three a layer a forward pass; for zamba2 the
   scan, for rwkv6 the WKV, once a layer a wave), the admission counts,
   finite logits, and the first wave's prefill logits against the same
   wave on the plain versions (and prints both runs' distance from that
   wave in f32 on the plain versions); for granite it also counts the
   tokens whose top-8 experts agree between the two.  Each run then
   profiles one prefill wave and a few decode steps (device busy time,
   idle share, the heaviest kernels) and frees its model; then prefills
   and decodes whisper-base (6 encoder and 6 decoder layers, f32 frames)
   and internvl2-2b (24 layers, 256 f32 patches before 768 tokens) at
   full width through ``make_prefill`` and ``make_decode_step`` (no
   engine serves them), 3 prompts of 1024 positions and 16 greedy steps:
   flash launches (18 and 24 a prefill, none a decode step), the
   prefill logits against the plain versions', finite decode logits and
   a profile;
8. trains full-width qwen3-0.6b (28 layers, bf16 weights, f32 AdamW
   moments) on B4 x S1024 through ``steps.make_train_step``: one step's
   loss and gradients with the kernels against plain attention from the
   same weights and batch (bf16 at full width; f32 at 4 layers, where the
   gradients are held), then timed steps with the flash launches counted
   (two a layer a step: the forward and its recomputation), peak memory,
   and a profile of one step with the kernels and one with plain
   attention; then runs ``launch/train.py``'s ``main`` for 2 steps at
   full width (one checkpoint), and on the smoke config straight, stopped
   after its checkpoint at step 4, and resumed, and checks that the
   resumed run starts at next_batch 4 and gives the straight run's
   losses; before the launcher it trains the other kinds the same way
   (kernels against the plain versions in bf16 and in f32 at 4 layers,
   timed steps with every kernel's launches counted, a profile, and the
   kind's plain backward alone): granite-moe-1b-a400m and zamba2-2.7b at
   full width and depth, rwkv6-7b at full width and 8 of its 32 layers
   (its bf16 gradients held equal to the plain versions'), whisper-base
   (f32 at full depth too) and internvl2-2b at full width and depth;
   after the launcher it runs ``launch/train.py`` for 2 steps on each
   frontend arch's smoke config, fed by the pipeline's f32 frames and
   patches;
9. runs the multi-device layer (``parallel_phase``): one spawned process
   a visible card under NCCL (rendezvous through a FileStore) on
   ``make_host_mesh`` (model 2 where it divides the world, else 1); it
   trains full-width qwen3-0.6b and granite-moe-1b-a400m through
   ``make_train_step(rules=...)`` against the plain step on a copy of the
   same weights (each step's loss and every gathered leaf within the
   bf16 train tolerance, flash and wide gmm launches equal both ways),
   times both ways alone (wall, device busy, idle share, kernels a step,
   peak memory), runs ``hierarchical_grad_sync`` over qwen3's gradients
   with and without int8, and runs the launcher twice on one dir under
   the group (the second resumes through ``restore(shardings=)``);
10. holds the dry run's estimator against the card (``dryrun_phase``):
   the train steps of qwen3-0.6b and granite-moe-1b-a400m (B4 x S1024,
   one card) traced on meta tensors under ``launch/cost_analysis.py``'s
   counter and run for real under it, FLOPs equal and the estimated peak
   memory within 10% of the measured one, the busy time beside the
   roofline; ``torch.library.opcheck`` on the four kernel operators; one
   production cell (qwen3-0.6b decode_32k on the fake (16, 16) mesh)
   through ``python -m repro_torch.launch.dryrun`` in a subprocess;
11. prints one JSON line describing every kernel of the path, then, as
   the last line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without CUDA, or outside a checkout, it
exits non-zero before doing anything.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bound;
# f64 on the tensor cores, for the wkv kernel's floor (it sums in f64)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
              "torch.float64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6

# (B, S, T, H, D) of the reference kernel tests' flash sweep
SWEEP = [(2, 512, 512, 4, 64), (1, 1024, 1024, 2, 128),
         (2, 256, 1024, 4, 64), (1, 512, 512, 3, 128)]
MODES = [(True, 0), (True, 128), (False, 0)]      # (causal, window)
# f32: summation order only; bf16: one rounding of the output (the
# reference kernel tests' tolerances, as atol = rtol)
TOL = {"torch.float32": 5e-5, "torch.bfloat16": 2e-2}
# grouped matmul, normalised by max |want| (tests/test_kernels.py): f32
# summation order only, bf16 one rounding of the f32 sum
GMM_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
# (E, C, D, F) of the reference kernel tests' gmm sweep
GMM_SWEEP = [(4, 128, 256, 128), (2, 256, 512, 256)]
# granite-moe-1b-a400m's expert buffers when serving 3 slots:
# (B, E, C, d_model, moe_d_ff); C = _capacity(1024 tokens) at prefill and
# _capacity(1 token) at decode
GMM_PREFILL = (3, 32, 320, 1024, 512)
GMM_DECODE = (3, 32, 8, 1024, 512)
# (B, C) whose B * C rows sit on each side of the narrow kernel's limit of
# 64 (64 and 72, twice), and its N at 8, 16, 24 and 64
GMM_ROWS = [(1, 64), (1, 72), (8, 8), (3, 24), (1, 8), (2, 8), (3, 8)]

# SSD scan: f32 atol = rtol (tests/test_kernels.py; the kernel's chunk of
# 64 against the plain version's 256 moves y by about 4e-5); bf16
# normalised by max |want|, one rounding of y to bf16 in both
SSD_TOL = {"torch.float32": 1e-3, "torch.bfloat16": 2e-2}
# (B, S, H, P, N) of the reference kernel tests' ssd sweep
SSD_SWEEP = [(2, 256, 4, 64, 64), (1, 512, 2, 64, 32), (2, 128, 8, 32, 64)]
# zamba2-2.7b's prefill scan when serving 3 slots: H = 5120 / 64 heads
SSD_PREFILL = (3, 1024, 80, 64, 64)
SSD_CHUNK = 256     # the reference model's chunk, for the bound's count

# WKV: atol = rtol (tests/test_kernels.py), y and the f32 state against
# the plain version's f32 result on the same inputs; a bf16 y adds its one
# rounding, at most half a bf16 ulp (2^-8 relative).  Both sum in f64, so
# a bf16 y should equal the plain version's bit for bit (counted).
WKV_TOL = 5e-3
# (B, S, H, P) of the reference kernel tests' wkv sweep
WKV_SWEEP = [(2, 64, 2, 32), (1, 128, 4, 64), (2, 32, 2, 16)]
# rwkv6-7b's prefill WKV when serving 3 slots: H = 4096 / 64 heads
WKV_PREFILL = (3, 1024, 64, 64)
WKV_CHUNK = 16      # the reference model's chunk, for the bound's count
# the served attention models' prefill attention heads: (arch, Hq, Hkv, D)
FLASH_SERVED = [("granite-moe-1b-a400m", 16, 8, 64), ("qwen3-0.6b", 16, 8, 128),
                ("zamba2-2.7b", 32, 32, 80)]
# the other dense configs' attention heads, all at head dim 128: MHA, a
# query-head group of 6 and a group of 4; held at one row of S = T = 1024
# in f32 and bf16 (forward, lse and the autograd op's gradients)
FLASH_DENSE = [("deepseek-7b", 32, 32, 128), ("internlm2-20b", 48, 8, 128),
               ("qwen3-8b", 32, 8, 128)]
# whisper-base's three attentions at its prefill and train shapes, all MHA
# 8/8 at head dim 64: (label, S, T, causal).  The encoder's self-attention
# over the 512 frames of a 1024-token prompt, the decoder's cross-attention
# from its 1024 positions over them (more queries than keys) and the
# decoder's self-attention.  internvl2-2b's attention is qwen3-0.6b's
# layout (16/8, D128), held above.
WHISPER_HEADS = (8, 8, 64)
FLASH_WHISPER = [("whisper-base encoder", 512, 512, False),
                 ("whisper-base cross", 1024, 512, False),
                 ("whisper-base decoder", 1024, 1024, True)]
# the kernel's log-sum-exp output (the backward's input) against the plain
# version's, atol = rtol: f32 summation order only (the output's TOL);
# bf16: both take the same exact products of the bf16 inputs and sum them
# in f32, the kernel keeps the row max in log2 units and sums the SFU's
# exp2 (about 2 ulp), so about 1e-5 of an LSE near 10 is expected
LSE_TOL = {"torch.float32": 5e-5, "torch.bfloat16": 2e-4}
# dq, dk, dv of the autograd op with the kernel forward against those with
# the plain forward (the same plain backward), normalised by max |want|:
# f32, the forwards' summation order; bf16, one or two ulps where the two
# outputs round apart (the output's TOL)
GRAD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
# the attention models whose prefill flash is timed, with their head dims;
# the kernels line's flash entry leads with the first
FLASH_TIMED = {"qwen3-0.6b": 128, "granite-moe-1b-a400m": 64,
               "zamba2-2.7b": 80}
# and the two non-causal whisper shapes, at its prefill's B
FLASH_TIMED_WHISPER = ("whisper-base encoder", "whisper-base cross")
# device-time runs of the kernel and of SDPA at each timed shape
TIMING_RUNS = 3
# the port's CUDA kernels, as the profiler names them
PORT_KERNELS = ("::flash_fwd_", "::gmm_", "::ssd_", "::wkv_")

# the train run: qwen3-0.6b at full width, (B, S) a step, 3 steps timed
# after one warm-up step
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen3-0.6b", 4, 1024, 3
# one train step's loss and gradients with the kernels against the same
# step with plain attention (impl="ref"), from the same weights and batch:
# in bf16 at full width, the loss and grad_norm within 1e-2 relative (the
# two forwards round the attention output apart by an ulp here and there,
# and 28 bf16 layers carry that on; each gradient leaf's relative L2
# difference is printed); the gradients are held in f32 at
# TRAIN_F32_LAYERS layers, where the kernel's forward differs from plain
# attention by summation order only: loss and every leaf within 1e-4
# relative (L2 for the leaves)
TRAIN_LOSS_RTOL = 1e-2
TRAIN_F32_RTOL = 1e-4
TRAIN_F32_LAYERS = 4
# the other decoder kinds, trained like TRAIN_ARCH (B, S, steps and
# tolerances above) at full width: (arch, layers, with None for the
# config's depth).  granite-moe-1b-a400m (1.39 B parameters) and
# zamba2-2.7b (2.42 B) at full depth; rwkv6-7b's 32 layers (7.53 B) would
# need about 90 GB for weights, f32 AdamW moments and gradients at 12
# bytes a parameter, more than the card holds: RWKV_TRAIN_LAYERS of them
# (2.28 B parameters)
RWKV_TRAIN_LAYERS = 8
KIND_TRAIN = [("granite-moe-1b-a400m", None), ("zamba2-2.7b", None),
              ("rwkv6-7b", RWKV_TRAIN_LAYERS)]
# the encoder-decoder and the vision frontend, trained the same way at
# full width and depth: whisper-base (about 110 M parameters, in f32 at
# its full depth too) and internvl2-2b (about 1.89 B, about 23 GB of
# weights, f32 AdamW moments and gradients at 12 bytes a parameter); each
# step's batch comes from SyntheticTokens, f32 frames or patches included
FRONTEND_TRAIN = [("whisper-base", None), ("internvl2-2b", None)]
# the launcher (launch/train.py's main): once at full width for
# LAUNCH_STEPS steps with only its final save (a full-width checkpoint
# holds 12 bytes a parameter on disk, bf16 widened to f32 and two f32
# moments, 9.0 GB for qwen3-0.6b: that run takes about 19 s on an H100,
# most of it the save, and the resume check below would write six);
# then the save, stop and resume check on the smoke config, on the card:
# a straight run of RESUME_STEPS steps, and the same run stopped when step
# RESUME_AT begins (its save at RESUME_AT started, --ckpt-every
# RESUME_EVERY) and resumed; the resumed run's losses equal the straight
# run's (1e-5 relative allows a last-bit difference from an order of
# atomic adds on the card)
LAUNCH_STEPS = 2
RESUME_STEPS, RESUME_AT, RESUME_EVERY, RESUME_RTOL = 6, 4, 2, 1e-5

# the serving runs: one GCR engine, more streams than slots
N_STREAMS, N_SLOTS, PROMPT_LEN, GEN_LEN = 8, 3, 1024, 16
# each served arch and the published widths its config must have
SERVED = [
    ("qwen3-0.6b", dict(n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
                        head_dim=128, vocab_size=151936,
                        block_pattern=("attn",))),
    ("granite-moe-1b-a400m", dict(
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        vocab_size=49155, block_pattern=("moe",), n_experts=32,
        n_experts_active=8)),
    ("zamba2-2.7b", dict(
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        vocab_size=32000, block_pattern=("mamba2",), d_inner=5120,
        ssm_heads=80, ssm_head_dim=64, ssm_state=64, shared_attn_every=6)),
    ("rwkv6-7b", dict(
        n_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
        block_pattern=("rwkv6",), rwkv_head_dim=64, rwkv_heads=64)),
]
# the encoder-decoder and frontend archs, which no engine serves (the
# reference's cannot: its prefill batch holds only tokens): prefilled and
# decoded through make_prefill and make_decode_step at full width and
# depth, N_SLOTS prompts of PROMPT_LEN positions (whisper: PROMPT_LEN
# tokens and PROMPT_LEN // 2 f32 frames; internvl2: 256 f32 patches and
# PROMPT_LEN - 256 tokens), GEN_LEN greedy decode steps; with the
# published widths their configs must have
FRONTEND = [
    ("whisper-base", dict(
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865, block_pattern=("attn",),
        frontend="audio_stub", frontend_dim=80, enc_seq_divisor=2)),
    ("internvl2-2b", dict(
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92553, block_pattern=("attn",),
        frontend="vision_stub", frontend_dim=1024, n_patches=256)),
]
# prefill logits, kernels vs plain versions, both in bf16: flash carries P
# as a bf16 hi + lo pair and sums in another order than plain attention
# before the output's one rounding, the gmm
# kernel sums in another order before its one rounding, the ssd kernel
# splits its f32 operands into bf16 pairs and scans in chunks of another
# size, and 24 to 63 blocks carry those one-ulp differences to the
# logits; in the MoE a routing near-tie may also send a token to another
# expert.  (The wkv kernel and its plain version both sum in f64 and
# agree bit for bit.)  Allowed: 5% of the largest logit (about 13 bf16
# ulps at that scale).
LOGIT_RTOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_time_us(torch, fn, calls: int = 20) -> float:
    """Host time of one call, in us: ``calls`` calls issued back to back
    after a synchronise, timed on the host clock before the card is
    waited for (few enough that the launch queue never fills)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call: the durations of the CUDA kernels
    ``iters`` calls launch, summed under torch.profiler, after one warm-up
    call.  Unlike back-to-back CUDA events it leaves out the host's launch
    gaps, which are longer than a small kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):     # the profiler now and then records no kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / iters
    raise SmokeFailure("the profiler saw no device time in 3 tries")


def kernel_names(torch, fn) -> list:
    """The names of the CUDA kernels one ``fn()`` runs, in order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:80] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def flash_kernel_phase(torch, fa, gen):
    """Every case: kernel vs plain on the same inputs.  Returns the max
    abs error at the served models' prefill shapes and the inputs of each
    of those shapes, by arch, and of whisper-base's non-causal prefill
    shapes, by label, for the timing."""
    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def compare(name, dtype, got, want):
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype)]
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        print(f"  {name:<58} max_abs_err={err:.3e} atol=rtol={tol:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with plain: {name}")
        return err

    def positional(name, dtype, q, k, v, q_pos, k_pos, window, causal):
        got = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, window=window,
                                     causal=causal)
        want = fa.flash_attention_fwd(q, k, v, q_pos, k_pos, window=window,
                                      causal=causal, impl="ref")
        return compare(name, dtype, got, want)

    def arange(n, off=0):
        return torch.arange(off, off + n, dtype=torch.int32, device="cuda")

    print("kernel phase: flash_attention_fwd vs attention_ref on the card")
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for (B, S, T, H, D) in SWEEP:
            q = rnd((B, S, H, D), dtype)
            k, v = rnd((B, T, H, D), dtype), rnd((B, T, H, D), dtype)
            for causal, window in MODES:
                got = fa.flash_attention(q, k, v, causal=causal,
                                         window=window)
                want = fa.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="ref")
                compare(f"sweep B{B} S{S} T{T} H{H} D{D} {short} "
                        f"causal={causal} window={window}", dtype, got, want)

        # GQA (qwen3's 16/8 heads), ragged lengths, the reduced head dim,
        # zamba2's head dim 80
        for (B, S, Hq, Hkv, D, window) in [(2, 256, 16, 8, 128, 0),
                                           (2, 12, 4, 2, 64, 0),
                                           (1, 1000, 4, 2, 128, 0),
                                           (1, 1000, 4, 2, 128, 100),
                                           (3, 12, 4, 2, 16, 0),
                                           (2, 256, 8, 4, 80, 0),
                                           (1, 1000, 4, 4, 80, 100),
                                           (3, 12, 4, 4, 80, 0)]:
            q = rnd((B, S, Hq, D), dtype)
            k, v = rnd((B, S, Hkv, D), dtype), rnd((B, S, Hkv, D), dtype)
            positional(f"gqa/ragged B{B} S=T={S} Hq{Hq} Hkv{Hkv} D{D} "
                       f"window={window} {short}", dtype, q, k, v,
                       arange(S), arange(S), window, True)

        # ring-buffer positions: shuffled slots, some never written (-1)
        T, S = 320, 128
        k_pos = torch.randperm(T, generator=gen, device="cuda").to(
            torch.int32)
        k_pos[torch.randperm(T, generator=gen, device="cuda")[:40]] = -1
        q = rnd((2, S, 8, 128), dtype)
        k, v = rnd((2, T, 4, 128), dtype), rnd((2, T, 4, 128), dtype)
        for window in (0, 64):
            positional(f"ring k_pos with -1 slots, window={window} {short}",
                       dtype, q, k, v, arange(S, T - S), k_pos, window, True)
        # the same with S and T not multiples of the 128-row tiles, T != S:
        # tiles the producer skips, tiles it finds fully visible and tiles
        # masked element by element, at the head dims split into regions
        T, S = 333, 200
        k_pos = torch.randperm(T, generator=gen, device="cuda").to(
            torch.int32)
        k_pos[torch.randperm(T, generator=gen, device="cuda")[:50]] = -1
        for Hq, Hkv, D in ((8, 4, 128), (4, 4, 80)):
            q = rnd((2, S, Hq, D), dtype)
            k, v = rnd((2, T, Hkv, D), dtype), rnd((2, T, Hkv, D), dtype)
            for window in (0, 100):
                positional(f"ring S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} -1 slots, "
                           f"window={window} {short}", dtype, q, k, v,
                           arange(S, T - S), k_pos, window, True)

        # the other dense configs' layouts at S = T = 1024
        for arch, Hq, Hkv, D in FLASH_DENSE:
            q = rnd((1, 1024, Hq, D), dtype)
            k, v = rnd((1, 1024, Hkv, D), dtype), rnd((1, 1024, Hkv, D), dtype)
            positional(f"{arch} B1 S=T=1024 Hq{Hq} Hkv{Hkv} D{D} {short}",
                       dtype, q, k, v, arange(1024), arange(1024), 0, True)

        # strided views: q, k, v sliced out of one fused projection
        qkv = rnd((2, 384, 16 + 8 + 8, 128), dtype)
        q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
        positional(f"strided q/k/v views of a fused qkv {short}", dtype,
                   q, k, v, arange(384), arange(384), 0, True)

    # whisper-base's encoder, cross and decoder attention at its prefill
    # shape (N_SLOTS prompts of PROMPT_LEN tokens, half as many frames)
    inputs = {}
    Hq, Hkv, D = WHISPER_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for label, S, T, causal in FLASH_WHISPER:
            B = N_SLOTS
            q = rnd((B, S, Hq, D), dtype)
            k, v = rnd((B, T, Hkv, D), dtype), rnd((B, T, Hkv, D), dtype)
            positional(f"{label} B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} "
                       f"causal={causal} {short}", dtype, q, k, v,
                       arange(S), arange(T), 0, causal)
            if dtype == torch.bfloat16 and label in FLASH_TIMED_WHISPER:
                inputs[label] = (q, k, v, arange(S), arange(T))

    # the served models' prefill shapes
    errs = []
    for arch, Hq, Hkv, D in FLASH_SERVED:
        B, S = N_SLOTS, PROMPT_LEN
        q = rnd((B, S, Hq, D), torch.bfloat16)
        k = rnd((B, S, Hkv, D), torch.bfloat16)
        v = rnd((B, S, Hkv, D), torch.bfloat16)
        errs.append(positional(
            f"{arch} prefill B{B} S=T={S} Hq{Hq} Hkv{Hkv} D{D} bfloat16",
            torch.bfloat16, q, k, v, arange(S), arange(S), 0, True))
        inputs[arch] = (q, k, v, arange(S), arange(S))
    return max(errs), inputs


def flash_train_phase(torch, fa, gen):
    """What training reads of the kernel: its log-sum-exp output against
    the plain version's at the served prefill shapes, qwen3-0.6b's train
    shape, the other dense layouts and whisper-base's three attentions
    (prefill and train shapes), f32 and bf16, with the output asked for
    with the LSE equal bit for bit to the output without (a null LSE
    pointer changes nothing else); then the autograd op's dq, dk, dv with
    the kernel forward against those with the plain forward, at the train
    shapes.  Returns the largest LSE error."""
    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device="cuda")

    print("kernel phase: the flash kernel's lse and gradients vs plain")
    S = PROMPT_LEN
    whisper = [(label, B, S_, T, *WHISPER_HEADS, causal)
               for B in (N_SLOTS, TRAIN_B)
               for label, S_, T, causal in FLASH_WHISPER]
    shapes = [(arch, N_SLOTS, S, S, Hq, Hkv, D, True) for arch, Hq, Hkv, D
              in FLASH_SERVED] + [(f"{TRAIN_ARCH} train", TRAIN_B, S, S, 16,
                                   8, 128, True)] + [
        (arch, 1, S, S, Hq, Hkv, D, True) for arch, Hq, Hkv, D
        in FLASH_DENSE] + whisper
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        tol = LSE_TOL[str(dtype)]
        for label, B, S, T, Hq, Hkv, D, causal in shapes:
            q = rnd((B, S, Hq, D), dtype)
            k, v = rnd((B, T, Hkv, D), dtype), rnd((B, T, Hkv, D), dtype)
            q_pos, k_pos = arange(S), arange(T)
            before = fa.launches
            out, lse = fa.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                              causal=causal, return_lse=True)
            bare = fa.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                          causal=causal)
            check(fa.launches == before + 2, "flash did not launch twice")
            _, want = fa.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                             causal=causal, impl="ref",
                                             return_lse=True)
            check(lse.shape == (B, Hq, S) and lse.dtype == torch.float32,
                  f"lse is {tuple(lse.shape)} {lse.dtype}")
            err = (lse - want).abs().max().item()
            ok = torch.allclose(lse, want, atol=tol, rtol=tol)
            same = torch.equal(out, bare)
            print(f"  lse {label} B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} "
                  f"causal={causal} {short}: max_abs_err={err:.3e} "
                  f"atol=rtol={tol:g} (max |lse| "
                  f"{want.abs().max().item():.3f}); output with lse equal "
                  f"to output without: {same} {'ok' if ok and same else 'FAIL'}")
            check(ok, f"flash lse disagrees with plain: {label} {short}")
            check(same, f"asking for the lse changed the output: {label}")
            worst = max(worst, err)

        tol = GRAD_TOL[str(dtype)]
        for label, B, S, T, Hq, Hkv, D, causal in [
                (f"{TRAIN_ARCH}'s train shape", TRAIN_B, TRAIN_S, TRAIN_S, 16,
                 8, 128, True)] + [
                (arch, 1, TRAIN_S, TRAIN_S, Hq, Hkv, D, True)
                for arch, Hq, Hkv, D in FLASH_DENSE] + [
                w for w in whisper if w[1] == TRAIN_B]:
            q = rnd((B, S, Hq, D), dtype)
            k, v = (rnd((B, T, Hkv, D), dtype) for _ in range(2))
            dout = rnd((B, S, Hq, D), dtype)
            grads = {}
            for impl in ("auto", "ref"):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = fa.flash_attention_fwd(*leaves, arange(S), arange(T),
                                             causal=causal, impl=impl)
                grads[impl] = torch.autograd.grad(out, leaves, dout)
            for name, got, want in zip(("dq", "dk", "dv"), grads["auto"],
                                       grads["ref"]):
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                ok = err <= tol * scale
                print(f"  autograd {name} at {label} B{B} S{S} T{T} Hq{Hq} "
                      f"Hkv{Hkv} D{D} causal={causal} {short}, kernel vs "
                      f"plain forward: max_abs_err={err:.3e} (normalised "
                      f"{err / scale:.2e}, tol {tol:g}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"flash autograd {name} disagrees: {label} {short}")
    return worst


def flash_timing_phase(torch, fa, arch, inputs, causal=True):
    """The kernel, the plain version and SDPA at one prefill shape (causal
    or not), beside the bound.  Times are device time (``device_ms``, mean
    of 20 calls; the kernel's and SDPA's the median of TIMING_RUNS such
    means, each printed, with the names of the kernels SDPA ran, so that a
    run that differs from the others shows, and which backend it took);
    the CUDA-event times of back-to-back calls (median of 5, host launch
    included) are printed and kept beside them: a call's host work takes
    longer than the kernel at these shapes, so events measure the host."""
    q, k, v, q_pos, k_pos = inputs
    B, S, Hq, D = q.shape
    T = k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return fa.flash_attention_fwd(q, k, v, q_pos, k_pos, causal=causal)

    def library():
        return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

    runs = [device_ms(torch, kernel) for _ in range(TIMING_RUNS)]
    library_runs = [device_ms(torch, library) for _ in range(TIMING_RUNS)]
    ms, library_ms = statistics.median(runs), statistics.median(library_runs)
    event_ms = time_ms(torch, kernel)
    plain_ms = device_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, q_pos, k_pos, causal=causal, impl="ref"), 5)
    library_event_ms = time_ms(torch, library)
    library_kernels = kernel_names(torch, library)

    # bound: the kernel's work (``fa.work``, which the dry run reads too):
    # the pairs the mask leaves visible, each costing a QK^T and a PV
    # product (2 FLOP per multiply-add); each input byte read once and the
    # output written once.  Its pairs are those this run's positions leave
    # visible, checked against ``fa.visible_pairs`` below.
    visible = (k_pos >= 0)[None, :].expand(S, T)
    if causal:
        visible = visible & (k_pos[None, :] <= q_pos[:, None])
    check(fa.visible_pairs(S, T, 0, causal) == int(visible.sum().item()),
          f"flash work at {arch}: the positions are not bottom-right")
    flops, nbytes = fa.work(B, S, T, Hq, k.shape[2], D, causal=causal,
                            itemsize=q.element_size())
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"flash timing at {arch}'s prefill shape B{B} S{S} T{T} Hq{Hq} "
          f"Hkv{k.shape[2]} D{D} {q.dtype} causal={causal} (device time, "
          "mean of 20 calls):")
    print(f"  flash kernel {ms:.4f} ms (events, launch included: "
          f"{event_ms:.4f} ms) | plain {plain_ms:.4f} ms | sdpa (yardstick) "
          f"{library_ms:.4f} ms (events {library_event_ms:.4f} ms) | bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    print(f"  runs: flash {[round(t, 4) for t in runs]} ms, sdpa "
          f"{[round(t, 4) for t in library_runs]} ms; sdpa ran "
          f"{library_kernels}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "event_ms": event_ms,
            "library_event_ms": library_event_ms, "runs_ms": runs,
            "library_runs_ms": library_runs,
            "library_kernels": library_kernels}


def gmm_kernel_phase(torch, gm, gen):
    """Every case: kernel vs plain on the same inputs, compared normalised
    by max |want|; each case also checks which kernel ran (bf16: the wide
    or the narrow one, by the rows an expert holds) and that the call
    counted one launch.  Returns the max abs error at granite's prefill
    shape (bf16, both products)."""
    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32) * scale).to(dtype)

    def compare(name, x, w):
        B, C = (x.shape[0] if x.dim() == 4 else 1), x.shape[-2]
        kernel = gm.choose_kernel(x.dtype, B, C)
        before = gm.launches
        got = gm.grouped_matmul(x, w)
        check(gm.launches == before + 1 and gm.last_kernel == kernel,
              f"gmm ran {gm.last_kernel} ({gm.launches - before} launches), "
              f"not one {kernel}: {name}")
        want = gm.grouped_matmul(x, w, impl="ref")
        check(got.shape == want.shape and got.dtype == x.dtype,
              f"gmm kernel gave {tuple(got.shape)} {got.dtype}: {name}")
        diff = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = GMM_TOL[str(x.dtype)]
        ok = diff <= tol * scale
        print(f"  {name:<58} {kernel:<6} max_abs_err={diff:.3e} "
              f"(normalised {diff / scale:.2e}, tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"gmm kernel disagrees with plain: {name}")
        return diff

    print("kernel phase: grouped_matmul vs gmm_ref on the card")
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for (E, C, D, F) in GMM_SWEEP:
            compare(f"sweep E{E} C{C} D{D} F{F} {short}",
                    rnd((E, C, D), dtype), rnd((E, D, F), dtype, 0.05))
        # ragged capacities: the model's C is a multiple of 8, not of 64
        for C in (8, 24, 320):
            compare(f"ragged E4 C{C} D512 F256 {short}",
                    rnd((4, C, 512), dtype), rnd((4, 512, 256), dtype, 0.05))
        # half-tiles of 64 rows that end inside a batch row (wide kernel)
        for C in (40, 200, 328):
            compare(f"ragged B3 E4 C{C} D256 F384 {short}",
                    rnd((3, 4, C, 256), dtype),
                    rnd((4, 256, 384), dtype, 0.05))
        # rows an expert holds on each side of the narrow kernel's limit,
        # and the narrow kernel's N at 8, 16, 24 and 64
        for B, C in GMM_ROWS:
            compare(f"rows B{B} C{C} ({B * C}) E8 D1024 F512 {short}",
                    rnd((B, 8, C, 1024), dtype),
                    rnd((8, 1024, 512), dtype, 1024 ** -0.5))
        # a (B,E,C,D) buffer read in place through its strides, by each
        # bf16 kernel
        big = rnd((3, 5, 48, 144), dtype)
        compare(f"strided 4-d x (3,4,40,128) of (3,5,48,144) {short}",
                big[:, 1:, 3:43, 8:136], rnd((4, 128, 96), dtype, 0.05))
        compare(f"strided 4-d x (3,4,8,128) of (3,5,48,144) {short}",
                big[:, 1:, 3:11, 8:136], rnd((4, 128, 96), dtype, 0.05))
        # granite's serving shapes: both products at prefill and decode
        for label, (B, E, C, D, F) in (("prefill", GMM_PREFILL),
                                       ("decode", GMM_DECODE)):
            x = rnd((B, E, C, D), dtype)
            wi = rnd((E, D, F), dtype, D ** -0.5)
            h = rnd((B, E, C, F), dtype)
            wo = rnd((E, F, D), dtype, F ** -0.5)
            e1 = compare(f"granite {label} x{(B, E, C, D)} @ wi{(E, D, F)} "
                         f"{short}", x, wi)
            e2 = compare(f"granite {label} h{(B, E, C, F)} @ wo{(E, F, D)} "
                         f"{short}", h, wo)
            if dtype == torch.bfloat16 and label == "prefill":
                err = max(e1, e2)
    return err


def gmm_timing_phase(torch, gm, gen):
    """Both products of granite's MoE layer, wi (x @ w_gate, D -> F) and
    wo (h @ wo, F -> D), at its prefill and decode shapes: kernel, plain
    version and torch.bmm (a yardstick, over an expert-major copy of x
    made outside the timed region) beside the bound.  Times are device
    time (``device_ms``); the kernel's CUDA-event time per call and the
    host's time per call (the wrapper and the launch, with the card
    running behind) are printed beside it.  Each call takes the next of
    several input sets that together exceed the L2 four times, so it reads
    its weights from device memory, as each layer of a serve step does.
    Returns one entry a product and shape; the first is prefill wi."""
    print("gmm timing, granite-moe-1b-a400m's expert products, bfloat16, "
          "cold L2 (device time, mean of 20 calls):")
    out = []
    for label, (B, E, C, Dm, Ff) in (("prefill", GMM_PREFILL),
                                     ("decode", GMM_DECODE)):
        for product, (D, F) in (("wi", (Dm, Ff)), ("wo", (Ff, Dm))):
            flops, nbytes = gm.work(B, E, C, D, F)
            sets = []
            for _ in range(max(2, -(-4 * int(L2_BYTES) // nbytes))):
                x = torch.randn((B, E, C, D), generator=gen,
                                device="cuda").to(torch.bfloat16)
                w = (torch.randn((E, D, F), generator=gen, device="cuda")
                     * D ** -0.5).to(torch.bfloat16)
                sets.append((x, w, x.transpose(0, 1).reshape(E, B * C, D)))

            def rotating(call, n=len(sets)):
                state = {"i": 0}

                def fn():
                    state["i"] = (state["i"] + 1) % n
                    return call(*sets[state["i"]])
                return fn

            kernel = rotating(lambda x, w, _: gm.grouped_matmul(x, w))
            ms = device_ms(torch, kernel)
            event_ms = time_ms(torch, kernel, iters=20)
            host_us = statistics.median(host_time_us(torch, kernel)
                                        for _ in range(5))
            plain_ms = device_ms(torch, rotating(
                lambda x, w, _: gm.grouped_matmul(x, w, impl="ref")), 5)
            library_ms = device_ms(torch, rotating(
                lambda _, w, x_em: torch.bmm(x_em, w)))
            # bound: the kernels' work (``gm.work``, which the dry run
            # reads too): 2 FLOP per multiply-add; x and w read once, out
            # written once
            t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            chosen = gm.choose_kernel(torch.bfloat16, B, C)
            print(f"  {label} {product} x{(B, E, C, D)} @ w{(E, D, F)}, "
                  f"{len(sets)} input sets: gmm {chosen} kernel {ms:.4f} ms "
                  f"(events, launch included: {event_ms:.4f} ms; host "
                  f"{host_us:.1f} us a call) | plain {plain_ms:.4f} ms | bmm "
                  f"(yardstick) {library_ms:.4f} ms | bound {bound_ms:.4f} "
                  f"ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB)")
            out.append({"shape": label, "product": product, "kernel": chosen,
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "event_ms": event_ms,
                        "host_us": host_us})
            del sets
    return out


def ssd_kernel_phase(torch, sd, gen):
    """Every case: kernel vs plain on the same inputs (y and the final
    state), the reference tests' laws for the inputs.  Returns the max abs
    error of y at zamba2's prefill shape (bf16)."""
    def inputs(B, S, H, P, N, dtype):
        def rnd(shape, scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        a = -rnd((B, S, H), 0.1).abs()
        return (rnd((B, S, H, P), 0.5).to(dtype), a,
                rnd((B, S, N), 0.5).to(dtype), rnd((B, S, N), 0.5).to(dtype))

    def compare(name, dtype, xdt, a, Bm, Cm, init=None):
        y, state = sd.ssd(xdt, a, Bm, Cm, init)
        want_y, want_state = sd.ssd(xdt, a, Bm, Cm, init, impl="ref")
        check(y.shape == want_y.shape and y.dtype == xdt.dtype
              and state.shape == want_state.shape
              and state.dtype == torch.float32,
              f"ssd kernel gave y {tuple(y.shape)} {y.dtype}, state "
              f"{tuple(state.shape)} {state.dtype}: {name}")
        tol = SSD_TOL[str(dtype)]
        errs, oks = [], []
        for got, want in ((y, want_y), (state, want_state)):
            got, want = got.float(), want.float()
            err = (got - want).abs().max().item()
            if dtype == torch.float32:
                ok = torch.allclose(got, want, atol=tol, rtol=tol)
            else:
                ok = err <= tol * want.abs().max().item()
            errs.append(err)
            oks.append(ok)
        rule = ("atol=rtol" if dtype == torch.float32
                else "normalised by max |want|,")
        print(f"  {name:<52} max_abs_err y={errs[0]:.3e} state="
              f"{errs[1]:.3e} ({rule} tol {tol:g}) "
              f"{'ok' if all(oks) else 'FAIL'}")
        check(all(oks), f"ssd kernel disagrees with plain: {name}")
        return errs[0]

    print("kernel phase: mamba2 ssd vs ssd_ref on the card")
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for (B, S, H, P, N) in SSD_SWEEP:
            compare(f"sweep B{B} S{S} H{H} P{P} N{N} {short}", dtype,
                    *inputs(B, S, H, P, N, dtype))
        # ragged lengths: the model's S is the prompt's, not a chunk multiple
        for S in (1000, 12):
            compare(f"ragged B2 S{S} H4 P64 N64 {short}", dtype,
                    *inputs(2, S, 4, 64, 64, dtype))
        # the prefill of a cache that already holds a state
        init = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
        compare(f"init_state B2 S300 H4 P64 N64 {short}", dtype,
                *inputs(2, 300, 4, 64, 64, dtype), init)
        # xdt, B and C as views of one wider projection, read in place
        B, S, H, P, N = 2, 256, 4, 64, 64
        proj = (torch.randn((B, S, H * P + 2 * N + 8), generator=gen,
                            device="cuda") * 0.5).to(dtype)
        a = -(torch.randn((B, S, H), generator=gen, device="cuda")
              * 0.1).abs()
        compare(f"strided views of one projection {short}", dtype,
                proj[..., 8:8 + H * P].view(B, S, H, P), a,
                proj[..., 8 + H * P:8 + H * P + N],
                proj[..., 8 + H * P + N:])
        e = compare(f"zamba2-2.7b prefill B{SSD_PREFILL[0]} "
                    f"S{SSD_PREFILL[1]} H{SSD_PREFILL[2]} P{SSD_PREFILL[3]} "
                    f"N{SSD_PREFILL[4]} {short}", dtype,
                    *inputs(*SSD_PREFILL, dtype))
        if dtype == torch.bfloat16:
            err = e
    print(f"  ssd bf16 max abs error of y at zamba2-2.7b's prefill shape: "
          f"{err:.3e}")
    return err


def ssd_timing_phase(torch, sd, gen):
    """The scan at zamba2's prefill shape, bf16, zero initial state: kernel
    and plain version beside the bound.  Times are device time
    (``device_ms``); the kernel's CUDA-event time per call, host launch
    included, is printed beside it.  Each call takes the next of several
    input sets that together exceed the L2 four times, as each layer of a
    prefill meets its inputs cold."""
    B, S, H, P, N = SSD_PREFILL
    # the kernel's work (``sd.work``, which the dry run reads too): each
    # input read once, each output written once (xdt and y bf16, a f32, B
    # and C bf16, shared by the heads, the f32 final state); the
    # operations of the reference algorithm at its chunk (SSD_CHUNK)
    flops, nbytes = sd.work(B, S, H, P, N)
    check(SSD_CHUNK == sd.CHUNK, "ssd: the bound's chunk is not the model's")
    sets = []
    for _ in range(max(2, -(-4 * int(L2_BYTES) // nbytes))):
        a = -(torch.randn((B, S, H), generator=gen, device="cuda")
              * 0.1).abs()
        sets.append([(torch.randn(shape, generator=gen, device="cuda")
                      * 0.5).to(torch.bfloat16)
                     for shape in ((B, S, H, P), (B, S, N), (B, S, N))])
        sets[-1].insert(1, a)

    def rotating(impl, sets=sets):
        state = {"i": 0}

        def fn():
            state["i"] = (state["i"] + 1) % len(sets)
            return sd.ssd(*sets[state["i"]], impl=impl)
        return fn

    ms = device_ms(torch, rotating("auto"))
    event_ms = time_ms(torch, rotating("auto"), iters=20)
    plain_ms = device_ms(torch, rotating("ref"), 5)
    # the first batch row alone: a third of the blocks.  A kernel bound by
    # its throughput takes a third of the time; one bound by the latency
    # of its chain of chunks about as long
    row0 = [[t[:1] for t in s] for s in sets]
    ms_row0 = device_ms(torch, rotating("auto", row0))
    t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"ssd timing at zamba2-2.7b's prefill shape B{B} S{S} H{H} P{P} "
          f"N{N} bfloat16, cold L2, {len(sets)} input sets (device time, "
          f"mean of 20 calls):")
    print(f"  ssd kernel {ms:.4f} ms (events, launch included: "
          f"{event_ms:.4f} ms) | plain {plain_ms:.4f} ms | no library call "
          f"| bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    print(f"  B1 alone: {ms_row0:.4f} ms, {ms_row0 / ms:.3f} of B{B}'s time")
    del sets, row0
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def wkv_kernel_phase(torch, wk, gen):
    """Every case: kernel vs plain on the same inputs (y and the final
    state), the reference tests' laws for the inputs.  Returns the max abs
    error of y at rwkv6-7b's prefill shape (bf16)."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(B, S, H, P, dtype, u_scale=0.1, rate_shift=-2.0):
        r, k, v = (rnd((B, S, H, P)).to(dtype) for _ in range(3))
        # w = exp(-rate), rate log-normal, capped as the model caps it
        rate = torch.exp(rnd((B, S, H, P)) * 0.5 + rate_shift)
        w = torch.exp(-torch.clamp(rate, max=5.0))
        return r, k, v, w, rnd((H, P)) * u_scale

    def compare(name, r, k, v, w, u, init=None):
        y, state = wk.wkv(r, k, v, w, u, init)
        # the plain version on the same values, y kept in f32 (two f32
        # sums that differ in the last bit can round to neighbouring bf16
        # values, up to 2^-7 apart)
        want_y, want_state = wk.wkv(r.float(), k.float(), v.float(), w, u,
                                    init, impl="ref")
        check(y.shape == want_y.shape and y.dtype == r.dtype
              and state.shape == want_state.shape
              and state.dtype == torch.float32,
              f"wkv kernel gave y {tuple(y.shape)} {y.dtype}, state "
              f"{tuple(state.shape)} {state.dtype}: {name}")
        errs, ok = [], True
        for got, want in ((y, want_y), (state, want_state)):
            got, want = got.float(), want.float()
            errs.append((got - want).abs().max().item())
            ok = ok and torch.allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL)
        same = (y == want_y.to(y.dtype)).float().mean().item()
        print(f"  {name:<52} max_abs_err y={errs[0]:.3e} state="
              f"{errs[1]:.3e} (atol=rtol={WKV_TOL:g}); share of y equal "
              f"to the plain version's: {same:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"wkv kernel disagrees with plain: {name}")
        return errs[0]

    print("kernel phase: rwkv6 wkv vs wkv_ref on the card")
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        short = str(dtype).replace("torch.", "")
        for (B, S, H, P) in WKV_SWEEP:
            compare(f"sweep B{B} S{S} H{H} P{P} {short}",
                    *inputs(B, S, H, P, dtype))
        compare(f"bonus u N(0, .25) B2 S128 H4 P64 {short}",
                *inputs(2, 128, 4, 64, dtype, 0.5))
        # ragged lengths: the model's S is the prompt's, not a chunk multiple
        for S in (1000, 12):
            compare(f"ragged B2 S{S} H4 P64 {short}",
                    *inputs(2, S, 4, 64, dtype, 0.5))
        # the prefill of a cache that already holds a state, P 16, 64, 128
        for P in (16, 64, 128):
            compare(f"init_state B2 S300 H4 P{P} {short}",
                    *inputs(2, 300, 4, P, dtype, 0.5),
                    rnd((2, 4, P, P)))
        # decay rates around 1.6, many at the cap of 5: k~ reaches e^80|k|
        compare(f"strong decays B2 S256 H4 P64 {short}",
                *inputs(2, 256, 4, 64, dtype, 0.5, rate_shift=0.5))
        # every decay at the cap
        r, k, v, w, u = inputs(2, 200, 4, 64, dtype, 0.5)
        compare(f"all decays at the cap B2 S200 H4 P64 {short}", r, k, v,
                torch.full_like(w, float(torch.exp(torch.tensor(-5.0)))), u,
                rnd((2, 4, 64, 64)))
        # the kernel's producer warps fill a ring of two chunks ahead of
        # its chain warps: S 40 ends inside a turn of the ring, 64 at a
        # turn's end; P 64 is one block a head, P 128 two
        for P in (64, 128):
            for S in (40, 64):
                compare(f"step edge B2 S{S} H3 P{P} {short}",
                        *inputs(2, S, 3, P, dtype, 0.5), rnd((2, 3, P, P)))
        # r, k, v as views of one fused projection, w of a wider tensor
        B, S, H, P = 2, 300, 4, 32
        proj = rnd((B, S, 3 * H * P + 8)).to(dtype)
        r, k, v = (proj[..., 8 + i * H * P:8 + (i + 1) * H * P].view(
            B, S, H, P) for i in range(3))
        w = torch.exp(-torch.exp(rnd((B, S, H, P + 16)) * 0.5 - 2))[..., 16:]
        compare(f"strided views of one projection {short}", r, k, v,
                w, rnd((H, P)) * 0.5, rnd((B, H, P, P)))
        # the model passes the cache's state: an initial state here too
        B, S, H, P = WKV_PREFILL
        e = compare(f"rwkv6-7b prefill B{B} S{S} H{H} P{P} {short}",
                    *inputs(B, S, H, P, dtype, 0.5), rnd((B, H, P, P)))
        if dtype == torch.bfloat16:
            err = e
    return err


def wkv_timing_phase(torch, wk, gen):
    """The WKV at rwkv6-7b's prefill shape, bf16 r, k, v, f32 w and an
    initial state (the model passes the cache's): kernel and plain version
    beside the bound.  Times are device time (``device_ms``); the kernel's
    CUDA-event time per call, host launch included, is printed beside it.
    Each call takes the next of several input sets that together exceed
    the L2 four times, as each layer of a prefill meets its inputs cold."""
    B, S, H, P = WKV_PREFILL
    # the kernel's work (``wk.work``, which the dry run reads too): each
    # input read once, each output written once (r, k, v and y bf16, w f32,
    # u f32, the initial and the final state f32); the operations of the
    # reference algorithm at its chunk (WKV_CHUNK)
    flops, nbytes = wk.work(B, S, H, P, init_state=True)
    check(WKV_CHUNK == wk.CHUNK, "wkv: the bound's chunk is not the model's")
    sets = []
    for _ in range(max(2, -(-4 * int(L2_BYTES) // nbytes))):
        def rnd(shape):
            return torch.randn(shape, generator=gen, device="cuda")
        sets.append([rnd((B, S, H, P)).to(torch.bfloat16) for _ in range(3)]
                    + [torch.exp(-torch.exp(rnd((B, S, H, P)) * 0.5 - 2)),
                       rnd((H, P)) * 0.5, rnd((B, H, P, P))])

    def rotating(impl, sets=sets):
        state = {"i": 0}

        def fn():
            state["i"] = (state["i"] + 1) % len(sets)
            return wk.wkv(*sets[state["i"]], impl=impl)
        return fn

    ms = device_ms(torch, rotating("auto"))
    event_ms = time_ms(torch, rotating("auto"), iters=20)
    plain_ms = device_ms(torch, rotating("ref"), 5)
    # the first batch row alone: one block an SM, where B3 puts two on
    # many SMs.  A kernel bound by its throughput takes a third of the
    # time; one bound by the latency of its chain of chunks about as long
    row0 = [[t[:1] if t.dim() == 4 else t for t in s] for s in sets]
    ms_row0 = device_ms(torch, rotating("auto", row0))
    t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
    t_f64 = flops / PEAK_FLOPS["torch.float64"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"wkv timing at rwkv6-7b's prefill shape B{B} S{S} H{H} P{P} "
          f"bfloat16 r, k, v, f32 w, an initial state, cold L2, {len(sets)} "
          "input sets (device time, mean of 20 calls):")
    print(f"  wkv kernel {ms:.4f} ms (events, launch included: "
          f"{event_ms:.4f} ms) | plain {plain_ms:.4f} ms | no library call "
          f"| bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) | the same FLOP at the f64 tensor-core "
          f"rate {t_f64:.4f} ms")
    print(f"  B1 alone ({H * -(-P // 64)} blocks, one an SM): "
          f"{ms_row0:.4f} ms, "
          f"{ms_row0 / ms:.3f} of B{B}'s time")
    del sets, row0
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def serve_phase(torch, np, kernels, arch, expect):
    """Serve ``arch`` at full width and check it.  ``kernels`` maps each
    kernel's name to its ops module.  Returns the launches of each kernel
    during the served run alone: {"flash": n, "gmm": n, "ssd": n,
    "wkv": n}."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, init_params, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import TorchServeEngine

    cfg = get_config(arch)
    got_widths = {k: getattr(cfg, k) for k in expect}
    check(got_widths == expect and cfg.dtype == "bfloat16",
          f"unexpected {arch} config {cfg}")
    kind = cfg.block_pattern[0]
    is_moe = kind == "moe"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve phase: {cfg.name} {n_params / 1e6:.1f}M params "
          f"initialised in {time.perf_counter() - t0:.2f} s")

    max_len = PROMPT_LEN + GEN_LEN
    eng = TorchServeEngine(cfg, params, n_slots=N_SLOTS, max_len=max_len,
                           admission_kind="gcr", device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (N_STREAMS, PROMPT_LEN)).astype(np.int32)

    prefill_ms, decode_ms, finite, first = [], [], [], {}
    run_prefill, run_decode = eng._prefill, eng._decode

    # the experts each MoE layer picks, recorded during one prefill
    routing = None
    router_topk = moe_mod.router_topk

    def recording_router_topk(router, x, top_k):
        out = router_topk(router, x, top_k)
        if routing is not None:
            routing.append(out[3].sort(dim=-1).values)
        return out

    def timed_prefill(p, batch):
        nonlocal routing
        if not first:
            routing = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = run_prefill(p, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        finite.append(torch.isfinite(logits).all())
        if not first:
            first["tokens"] = batch["tokens"].clone()
            first["logits"] = logits.clone()
            first["routing"], routing = routing, None
        return logits, cache

    def timed_decode(p, cache, tok):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = run_decode(p, cache, tok)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    eng._prefill, eng._decode = timed_prefill, timed_decode
    moe_mod.router_topk = recording_router_topk
    try:
        for mod in kernels.values():         # count the main path alone
            mod.launches = 0
        t0 = time.perf_counter()
        out = eng.generate(prompts, GEN_LEN)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in kernels.items()}
        with torch.no_grad():
            routing = []
            ref_logits, _ = prefill(cfg, params, {"tokens": first["tokens"]},
                                    max_len, impl="ref")
            ref_routing, routing = routing, None
            # the same wave in f32 on the plain versions: how far each bf16
            # run is from it says whether the kernels add to bf16's drift
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            params32 = Transformer(cfg32, "cuda")
            params32.load_state_dict(params.state_dict())
            f32_logits, _ = prefill(cfg32, params32,
                                    {"tokens": first["tokens"]}, max_len,
                                    impl="ref")
            del params32
    finally:
        moe_mod.router_topk = router_topk

    waves, steps = len(prefill_ms), len(decode_ms)
    want = {"flash": attention_blocks(cfg) * waves,
            "gmm": 3 * cfg.n_layers * (waves + steps) if is_moe else 0,
            "ssd": cfg.n_layers * waves if kind == "mamba2" else 0,
            "wkv": cfg.n_layers * waves if kind == "rwkv6" else 0}
    adm = eng.admission
    print(f"  waves={waves} decode steps={steps} launches={launches} "
          f"(want {want}) stat_fast={adm.stat_fast} "
          f"stat_parked={adm.stat_parked}")
    check(waves == 3, f"expected 3 prefill waves, got {waves}")
    check(launches == want, f"launches {launches} != {want}")
    check((adm.stat_fast, adm.stat_parked) == (8, 2),
          f"admission counts {adm.stat_fast}/{adm.stat_parked} != 8/2")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    check(out.shape == (N_STREAMS, GEN_LEN)
          and out.min() >= 0 and out.max() < cfg.vocab_padded,
          f"bad generated tokens: shape {out.shape}")

    got, ref = first["logits"].float(), ref_logits.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum().item())
    print(f"  first-wave prefill logits, kernels vs plain versions: "
          f"max_abs_err={err:.4e} tol={LOGIT_RTOL * scale:.4e} "
          f"(max |logit| {scale:.3f}); greedy tokens agree "
          f"{agree}/{got.shape[0]}")
    print(f"  against the same wave in f32 on the plain versions: plain bf16 "
          f"max_abs_err={(ref - f32_logits).abs().max().item():.4e}, "
          f"kernels bf16 {(got - f32_logits).abs().max().item():.4e}")
    if is_moe:
        check(len(first["routing"]) == len(ref_routing) == cfg.n_layers,
              "routing was not recorded once a layer")
        same = [int((a == b).all(-1).sum().item())
                for a, b in zip(first["routing"], ref_routing)]
        n = ref_routing[0].shape[0] * ref_routing[0].shape[1]
        print(f"  top-{cfg.n_experts_active} expert sets agree for "
              f"{sum(same)} of {n * len(same)} (token, layer) pairs of the "
              f"first wave; by layer: {same} of {n} each")
    check(err <= LOGIT_RTOL * scale, "prefill logits disagree")

    tokens = N_STREAMS * GEN_LEN
    print(f"  prefill ms per wave: {[round(t, 3) for t in prefill_ms]}")
    print(f"  decode ms per step: median {statistics.median(decode_ms):.3f} "
          f"over {steps} steps")
    print(f"  generated {tokens} tokens in {wall_s:.3f} s: "
          f"{tokens / wall_s:.1f} tokens/s (re-prefill per wave included)")
    print(f"  stream 0 tokens: {out[0].tolist()}")
    wave = {"tokens": first["tokens"]}
    profile_phase(torch, lambda: run_prefill(params, wave),
                  lambda c, t: run_decode(params, c, t))
    return launches


def frontend_phase(torch, np, kernels, arch, expect):
    """Prefill and decode ``arch`` (an encoder-decoder or a frontend arch)
    at full width and depth, random weights from seed 0, through
    ``make_prefill`` and ``make_decode_step``: one warm-up prefill, then
    with the launch counts at 0 one prefill (flash once an attention: each
    encoder layer's, each decoder layer's self- and cross-attention), and
    with them at 0 again GEN_LEN greedy decode steps (no flash: decode
    attention is plain); the prefill logits against the plain versions'
    (``impl="ref"``) within LOGIT_RTOL, and both against the same prefill
    in f32 on the plain versions; finite decode logits; then a profile of
    one prefill and a few decode steps.  Returns the launches of the
    prefill and of the decode steps, by kernel, and the figures."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, init_params
    from repro_torch.steps import make_decode_step, make_prefill

    cfg = get_config(arch)
    check({k: getattr(cfg, k) for k in expect} == expect
          and cfg.dtype == "bfloat16", f"unexpected {arch} config {cfg}")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(0)
    B = N_SLOTS
    n_patches = cfg.n_patches if cfg.frontend == "vision_stub" else 0

    def stub(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda")

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, PROMPT_LEN - n_patches)).astype(
            np.int32)).to("cuda")}
    if n_patches:
        batch["patches"] = stub(B, n_patches, cfg.frontend_dim)
    if cfg.frontend == "audio_stub":
        batch["frames"] = stub(B, PROMPT_LEN // cfg.enc_seq_divisor,
                               cfg.frontend_dim)
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    print(f"frontend phase: {cfg.name} {n_params / 1e6:.1f}M params, "
          f"prefill of {shapes}, {GEN_LEN} decode steps")
    max_len = PROMPT_LEN + GEN_LEN
    run_prefill = make_prefill(cfg, max_len)
    run_decode = make_decode_step(cfg)
    run_prefill(params, batch)                            # warm

    def counted(work):
        for mod in kernels.values():         # count the main path alone
            mod.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        return out, wall_ms, {name: mod.launches
                              for name, mod in kernels.items()}

    (logits, cache), prefill_ms, prefill_launches = counted(
        lambda: run_prefill(params, batch))
    first = logits.clone()

    def decode_steps():
        nonlocal logits, cache
        all_logits = []
        for _ in range(GEN_LEN):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = run_decode(params, cache, tok)
            all_logits.append(logits)
        return torch.cat(all_logits, dim=1)

    decoded, decode_ms, decode_launches = counted(decode_steps)
    want = dict.fromkeys(kernels, 0)
    want["flash"] = attention_blocks(cfg)
    print(f"  prefill launches {prefill_launches} (want {want}); "
          f"{GEN_LEN} decode steps' launches {decode_launches}; cache pos "
          f"{cache['pos']}")
    check(prefill_launches == want, f"{arch}: prefill launches "
          f"{prefill_launches} != {want}")
    check(not any(decode_launches.values()),
          f"{arch}: decode launched {decode_launches}")
    check(cache["pos"] == PROMPT_LEN + GEN_LEN,
          f"{arch}: cache pos {cache['pos']}")
    check(tuple(decoded.shape) == (B, GEN_LEN, cfg.vocab_padded)
          and bool(torch.isfinite(decoded.float()).all()),
          f"{arch}: decode logits not finite or misshapen")

    with torch.no_grad():
        ref, _ = make_prefill(cfg, max_len, impl="ref")(params, batch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = Transformer(cfg32, "cuda")
        params32.load_state_dict(params.state_dict())
        f32_logits, _ = make_prefill(cfg32, max_len, impl="ref")(params32,
                                                                 batch)
        del params32
    got, ref = first.float(), ref.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum().item())
    print(f"  prefill logits, kernels vs plain versions: max_abs_err="
          f"{err:.4e} tol={LOGIT_RTOL * scale:.4e} (max |logit| "
          f"{scale:.3f}); greedy tokens agree {agree}/{B}")
    print(f"  against the same prefill in f32 on the plain versions: plain "
          f"bf16 max_abs_err={(ref - f32_logits).abs().max().item():.4e}, "
          f"kernels bf16 {(got - f32_logits).abs().max().item():.4e}")
    check(err <= LOGIT_RTOL * scale, f"{arch}: prefill logits disagree")
    print(f"  prefill {prefill_ms:.3f} ms; decode {decode_ms / GEN_LEN:.3f} "
          f"ms a step (host clock, greedy pick included)")
    profile_phase(torch, lambda: run_prefill(params, batch),
                  lambda c, t: run_decode(params, c, t))
    figures = {"params": n_params, "prefill_ms": prefill_ms,
               "decode_ms_a_step": decode_ms / GEN_LEN,
               "prefill_logit_err": err, "prefill_logit_tol":
               LOGIT_RTOL * scale}
    return prefill_launches, decode_launches, figures


def loss_and_grads(torch, cfg, model, batch, impl):
    """One train forward and backward: (loss, {parameter name: grad})."""
    from repro_torch.models import forward_train

    loss, _ = forward_train(cfg, model, batch, impl=impl)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def kernels_vs_plain(torch, cfg, model, batch, replay=False):
    """One step's loss and gradients with the kernels (``impl="auto"``)
    against the plain versions (``impl="ref"``) from the same weights and
    batch: both losses, both global norms, the gradient leaf with the
    largest relative L2 difference, and the leaves equal bit for bit.
    With ``replay`` the plain step runs twice, and ``plain_equal`` counts
    the leaves on which it equals itself (an order of atomic adds on the
    card may move a last bit)."""
    from repro_torch.optim import global_norm

    loss_k, g_k = loss_and_grads(torch, cfg, model, batch, "auto")
    loss_r, g_r = loss_and_grads(torch, cfg, model, batch, "ref")
    rel = {name: ((g_k[name].float() - g_r[name].float()).norm()
                  / g_r[name].float().norm().clamp_min(1e-30)).item()
           for name in g_r}
    worst = max(rel, key=rel.get)
    out = {"loss": (loss_k.item(), loss_r.item()),
           "grad_norm": (global_norm(g_k).item(), global_norm(g_r).item()),
           "worst_leaf": (worst, rel[worst]),
           "equal": {name for name in g_r if torch.equal(g_k[name],
                                                          g_r[name])},
           "leaves": len(g_r)}
    del g_k
    if replay:
        loss_r2, g_r2 = loss_and_grads(torch, cfg, model, batch, "ref")
        out["plain_equal"] = {name for name in g_r
                              if torch.equal(g_r[name], g_r2[name])}
        out["plain_loss_equal"] = bool(torch.equal(loss_r, loss_r2))
        del g_r2
    del g_r
    return out


def rel_diff(pair):
    return abs(pair[0] - pair[1]) / abs(pair[1])


def train_phase(torch, fa):
    """Train qwen3-0.6b at full width through the port's step builder:
    one step's loss and gradients with the kernels against plain attention
    (bf16 at full width, then f32 at TRAIN_F32_LAYERS layers), then
    TRAIN_STEPS timed steps of ``make_train_step`` (flash launches counted,
    wall and peak memory), one of them under torch.profiler, and one step
    with plain attention for comparison.  Returns the flash launches of
    the timed steps and the train figures."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_update
    from repro_torch.steps import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    expect = dict(SERVED)[TRAIN_ARCH]
    check({k: getattr(cfg, k) for k in expect} == expect
          and cfg.dtype == "bfloat16", f"unexpected {TRAIN_ARCH} config")
    params, opt = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    src = SyntheticTokens(cfg, TRAIN_S, TRAIN_B, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in src.global_batch_at(i).items()}

    print(f"train phase: {cfg.name} {n_params / 1e6:.1f}M params, bf16 "
          f"weights, f32 AdamW moments, B{TRAIN_B} S{TRAIN_S}")
    batch = batch_at(0)
    cmp = kernels_vs_plain(torch, cfg, params, batch)
    print(f"  one step, kernels vs plain attention (bf16, {cfg.n_layers} "
          f"layers): loss {cmp['loss'][0]:.6f} vs {cmp['loss'][1]:.6f} "
          f"(rel {rel_diff(cmp['loss']):.2e}, tol {TRAIN_LOSS_RTOL:g}); "
          f"grad_norm {cmp['grad_norm'][0]:.6f} vs {cmp['grad_norm'][1]:.6f}"
          f" (rel {rel_diff(cmp['grad_norm']):.2e}, tol "
          f"{TRAIN_LOSS_RTOL:g}); largest relative L2 difference of a "
          f"gradient leaf {cmp['worst_leaf'][1]:.3e} ({cmp['worst_leaf'][0]})")
    check(rel_diff(cmp["loss"]) <= TRAIN_LOSS_RTOL, "bf16 train loss differs")
    check(rel_diff(cmp["grad_norm"]) <= TRAIN_LOSS_RTOL,
          "bf16 grad_norm differs")

    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                                dtype="float32")
    model32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                          "cuda").requires_grad_(True)
    cmp32 = kernels_vs_plain(torch, cfg32, model32, batch)
    del model32
    print(f"  one step, kernels vs plain attention (f32, {TRAIN_F32_LAYERS} "
          f"layers): loss rel {rel_diff(cmp32['loss']):.2e}, largest "
          f"relative L2 difference of a gradient leaf "
          f"{cmp32['worst_leaf'][1]:.3e} ({cmp32['worst_leaf'][0]}), tol "
          f"{TRAIN_F32_RTOL:g}")
    check(rel_diff(cmp32["loss"]) <= TRAIN_F32_RTOL
          and cmp32["worst_leaf"][1] <= TRAIN_F32_RTOL,
          "f32 train gradients differ")

    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=100)
    steps = {impl: make_train_step(cfg, opt_cfg, impl=impl)
             for impl in ("auto", "ref")}
    state = [params, opt]

    def step(i, impl="auto"):
        state[0], state[1], metrics = steps[impl](*state, batch_at(i), i)
        return metrics

    step(0)                                               # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0                          # count the main path alone
    walls, losses = [], []
    for i in range(1, 1 + TRAIN_STEPS):
        t = time.perf_counter()
        metrics = step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"].item())
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = train_launches(cfg, TRAIN_STEPS)["flash"]
    print(f"  {TRAIN_STEPS} steps: losses {[round(x, 6) for x in losses]}, "
          f"grad_norm {metrics['grad_norm'].item():.4f}, lr "
          f"{metrics['lr'].item():.3e}; flash launches {launches} (want "
          f"{want}: {cfg.n_layers} layers x 2 under remat x {TRAIN_STEPS} "
          "steps)")
    check(launches == want, f"flash launches {launches} != {want}")
    check(all(map(math.isfinite, losses)), "non-finite train loss")
    wall_ms = statistics.median(walls)
    print(f"  step wall ms {[round(w, 3) for w in walls]} (median "
          f"{wall_ms:.3f}); peak memory allocated {peak_gb:.2f} GB")

    figures = {"wall_ms": wall_ms, "peak_gb": peak_gb}
    for impl, n in (("auto", TRAIN_STEPS + 1), ("ref", TRAIN_STEPS + 2)):
        t = time.perf_counter()
        step(n, impl)
        torch.cuda.synchronize()
        impl_wall = (time.perf_counter() - t) * 1e3
        busy, n_kernels, port_ms = profiled_ms(torch, lambda: step(n + 2,
                                                                   impl))
        flash_ms = port_ms["flash"]
        label = "kernels" if impl == "auto" else "plain attention"
        print(f"  profile train step ({label}): wall {impl_wall:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share "
              f"{max(0.0, 1 - busy / impl_wall):.3f}, {n_kernels} kernels; "
              f"flash kernel {flash_ms:.3f} ms a step")
        figures[impl] = {"wall_ms": impl_wall, "busy_ms": busy,
                         "flash_ms": flash_ms}

    # the optimizer alone: AdamW over every leaf, as the step runs it
    zeros = {name: torch.zeros_like(p)
             for name, p in state[0].named_parameters()}

    def optimizer():
        adamw_update(zeros, state[1], state[0], opt_cfg)

    opt_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        optimizer()
        torch.cuda.synchronize()
        opt_walls.append((time.perf_counter() - t) * 1e3)
    opt_busy = device_ms(torch, optimizer, 3)
    print(f"  AdamW alone ({len(zeros)} leaves): wall "
          f"{statistics.median(opt_walls):.3f} ms, device busy "
          f"{opt_busy:.3f} ms")
    figures["adamw"] = {"wall_ms": statistics.median(opt_walls),
                        "busy_ms": opt_busy}
    del zeros

    # the attention backward alone (plain PyTorch), at the step's shape
    q = torch.randn((TRAIN_B, TRAIN_S, 16, 128), device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((TRAIN_B, TRAIN_S, 8, 128), device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(TRAIN_S, dtype=torch.int32, device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, pos, pos, return_lse=True)
    bwd_ms = device_ms(torch, lambda: flash_bwd_ref(q, k, v, pos, pos, out,
                                                    lse, out), 5)
    print(f"  flash backward (plain PyTorch) {bwd_ms:.3f} ms a layer, "
          f"{bwd_ms * cfg.n_layers:.3f} ms a step "
          f"({bwd_ms * cfg.n_layers / figures['auto']['busy_ms']:.1%} of "
          "the step's device busy)")
    figures["flash_bwd_ms"] = bwd_ms * cfg.n_layers
    del state, params, opt, steps
    return launches, figures


def attention_blocks(cfg) -> int:
    """Prompt attentions of one forward pass: every layer of an attention
    kind, plus the shared block's uses, plus an encoder-decoder's
    cross-attention in every decoder layer and its encoder's layers; none
    in an attention-free stack."""
    n = cfg.n_layers if cfg.block_pattern[0] in ("attn", "moe") else 0
    if cfg.shared_attn_every:
        n += cfg.n_layers // cfg.shared_attn_every
    if cfg.is_encdec:
        n += cfg.n_layers + cfg.n_enc_layers
    return n


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps of ``cfg``, every layer
    run twice under remat (the forward and its recomputation): flash once
    an attention block, gmm three times a MoE layer, ssd once a Mamba2
    layer, wkv once an RWKV6 layer."""
    kind = cfg.block_pattern[0]
    per_pass = {"flash": attention_blocks(cfg),
                "gmm": 3 * cfg.n_layers if kind == "moe" else 0,
                "ssd": cfg.n_layers if kind == "mamba2" else 0,
                "wkv": cfg.n_layers if kind == "rwkv6" else 0}
    return {name: 2 * n * steps for name, n in per_pass.items()}


def kind_train_phase(torch, kernels, arch, n_layers):
    """Train ``arch`` (MoE, Mamba2, RWKV6, the encoder-decoder or the
    vision frontend) at full width, with ``n_layers`` layers (None: its
    depth), through the port's step builder, as ``train_phase`` trains
    TRAIN_ARCH: one step's loss and gradients with the kernels against the
    plain versions (bf16 at the phase's depth, then f32 at
    TRAIN_F32_LAYERS layers; for rwkv6 the bf16 gradients equal, since its
    wkv kernel gives the plain version's y; zamba2 in f32 at 6 layers, so
    that its shared block runs; whisper in f32 at its full depth), then
    TRAIN_STEPS timed steps of ``make_train_step`` with every
    kernel's launches counted, wall and peak memory, one more step under
    torch.profiler, and the plain backward of the kind's autograd op
    alone at the step's shapes.  Returns the launches of the timed steps
    and the figures."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels._replay import replay_grads
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref
    from repro_torch.kernels.moe_gmm.ops import gmm_bwd_ref
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref
    from repro_torch.models import init_params
    from repro_torch.models.moe import _capacity
    from repro_torch.steps import init_train_state, make_train_step

    full = get_config(arch)
    expect = dict(SERVED + FRONTEND)[arch]
    check({k: getattr(full, k) for k in expect} == expect
          and full.dtype == "bfloat16", f"unexpected {arch} config")
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    kind = cfg.block_pattern[0]
    params, opt = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    src = SyntheticTokens(cfg, TRAIN_S, TRAIN_B, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in src.global_batch_at(i).items()}

    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"{cfg.n_layers} of {full.n_layers} layers")
    print(f"train phase: {cfg.name} {n_params / 1e6:.1f}M params ({depth}), "
          f"bf16 weights, f32 AdamW moments, B{TRAIN_B} S{TRAIN_S}")
    batch = batch_at(0)
    exact = kind == "rwkv6"
    cmp = kernels_vs_plain(torch, cfg, params, batch, replay=exact)
    print(f"  one step, kernels vs plain versions (bf16, {cfg.n_layers} "
          f"layers): loss {cmp['loss'][0]:.6f} vs {cmp['loss'][1]:.6f} "
          f"(rel {rel_diff(cmp['loss']):.2e}, tol {TRAIN_LOSS_RTOL:g}); "
          f"grad_norm {cmp['grad_norm'][0]:.6f} vs {cmp['grad_norm'][1]:.6f}"
          f" (rel {rel_diff(cmp['grad_norm']):.2e}, tol "
          f"{TRAIN_LOSS_RTOL:g}); largest relative L2 difference of a "
          f"gradient leaf {cmp['worst_leaf'][1]:.3e} ({cmp['worst_leaf'][0]})"
          f"; leaves equal bit for bit {len(cmp['equal'])} of "
          f"{cmp['leaves']}")
    check(rel_diff(cmp["loss"]) <= TRAIN_LOSS_RTOL,
          f"{arch}: bf16 train loss differs")
    check(rel_diff(cmp["grad_norm"]) <= TRAIN_LOSS_RTOL,
          f"{arch}: bf16 grad_norm differs")
    if exact:
        # equal wherever the plain step equals itself
        print(f"  the plain step run twice: loss equal "
              f"{cmp['plain_loss_equal']}, leaves equal bit for bit "
              f"{len(cmp['plain_equal'])} of {cmp['leaves']}; kernels vs "
              f"plain on those: {len(cmp['plain_equal'] & cmp['equal'])}")
        check(cmp["plain_equal"] <= cmp["equal"]
              and (cmp["loss"][0] == cmp["loss"][1]
                   or not cmp["plain_loss_equal"]),
              f"{arch}: the kernels' bf16 gradients differ from the plain "
              "versions'")

    # zamba2: enough layers that the shared block runs once; whisper: all
    n32 = (cfg.n_layers if cfg.is_encdec
           else max(TRAIN_F32_LAYERS, cfg.shared_attn_every))
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype="float32")
    model32 = init_params(cfg32, torch.Generator(device="cuda").manual_seed(1),
                          "cuda").requires_grad_(True)
    cmp32 = kernels_vs_plain(torch, cfg32, model32, batch)
    del model32
    print(f"  one step, kernels vs plain versions (f32, {n32} "
          f"layers): loss rel {rel_diff(cmp32['loss']):.2e}, largest "
          f"relative L2 difference of a gradient leaf "
          f"{cmp32['worst_leaf'][1]:.3e} ({cmp32['worst_leaf'][0]}), tol "
          f"{TRAIN_F32_RTOL:g}; leaves equal bit for bit "
          f"{len(cmp32['equal'])} of {cmp32['leaves']}")
    check(rel_diff(cmp32["loss"]) <= TRAIN_F32_RTOL
          and cmp32["worst_leaf"][1] <= TRAIN_F32_RTOL,
          f"{arch}: f32 train gradients differ")

    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=100)
    step_fn = make_train_step(cfg, opt_cfg)
    state = [params, opt]

    def step(i):
        state[0], state[1], metrics = step_fn(*state, batch_at(i), i)
        return metrics

    step(0)                                               # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():             # count the main path alone
        mod.launches = 0
    walls, losses = [], []
    for i in range(1, 1 + TRAIN_STEPS):
        t = time.perf_counter()
        metrics = step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"].item())
    launches = {name: mod.launches for name, mod in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = train_launches(cfg, TRAIN_STEPS)
    aux = {k: round(v.item(), 6) for k, v in metrics.items()
           if k.startswith("moe_")}
    print(f"  {TRAIN_STEPS} steps: losses {[round(x, 6) for x in losses]}, "
          f"grad_norm {metrics['grad_norm'].item():.4f}, lr "
          f"{metrics['lr'].item():.3e} {aux}; launches {launches} (want "
          f"{want}: each layer twice under remat x {TRAIN_STEPS} steps)")
    check(launches == want, f"{arch}: train launches {launches} != {want}")
    check(all(map(math.isfinite, losses)), f"{arch}: non-finite train loss")
    wall_ms = statistics.median(walls)
    print(f"  step wall ms {[round(w, 3) for w in walls]} (median "
          f"{wall_ms:.3f}); peak memory allocated {peak_gb:.2f} GB")

    t = time.perf_counter()
    step(TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t) * 1e3
    busy, n_kernels, port_ms = profiled_ms(torch,
                                           lambda: step(TRAIN_STEPS + 2))
    print(f"  profile train step: wall {step_wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / step_wall):.3f}, "
          f"{n_kernels} kernels; port kernels ms a step "
          f"{ {k: round(v, 3) for k, v in port_ms.items() if v} }")
    figures = {"layers": cfg.n_layers, "params": n_params,
               "wall_ms": wall_ms, "peak_gb": peak_gb,
               "profiled_wall_ms": step_wall, "busy_ms": busy,
               "kernels_ms": port_ms, "launches_a_step": {
                   k: v // TRAIN_STEPS for k, v in launches.items()}}
    del state, params, opt, step_fn

    # the kind's autograd op: its plain backward alone, at the step's
    # shapes, once for each call a step makes
    def rnd(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, device="cuda") * scale).to(dtype)

    B, S = TRAIN_B, TRAIN_S
    if kind == "attn":
        # a layer's attentions: the decoder's self-attention and, for an
        # encoder-decoder (as many encoder layers as decoder layers), the
        # encoder's and the cross-attention; each from the kernel's
        # forward and lse
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        calls = [(S, S, True)]
        if cfg.is_encdec:
            check(cfg.n_enc_layers == cfg.n_layers,
                  f"{arch}: a layer's attentions assume as many encoder "
                  "as decoder layers")
            T = S // cfg.enc_seq_divisor
            calls += [(T, T, False), (S, T, False)]
        saved = []
        for Sq, Tk, causal in calls:
            q = rnd((B, Sq, Hq, D))
            k, v = rnd((B, Tk, Hkv, D)), rnd((B, Tk, Hkv, D))
            qp, kp = (torch.arange(n, dtype=torch.int32, device="cuda")
                      for n in (Sq, Tk))
            out, lse = flash_attention_fwd(q, k, v, qp, kp, causal=causal,
                                           return_lse=True)
            saved.append((q, k, v, qp, kp, out, lse, causal))

        def backward():
            for q, k, v, qp, kp, out, lse, causal in saved:
                flash_bwd_ref(q, k, v, qp, kp, out, lse, out, 0, causal)
        op, what = "flash", (f"(B{B}, (S, T, causal) {calls}, Hq{Hq}, "
                             f"Hkv{Hkv}, D{D})")
    elif kind == "moe":
        E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        C = _capacity(S, E, cfg.n_experts_active, cfg.moe_capacity_factor)
        x, h = rnd((B, E, C, D)), rnd((B, E, C, F))
        wi, wo = rnd((E, D, F), scale=D ** -0.5), rnd((E, F, D),
                                                     scale=F ** -0.5)

        def backward():
            gmm_bwd_ref(x, wi, h)          # the gate and up products
            gmm_bwd_ref(x, wi, h)
            gmm_bwd_ref(h, wo, x)
        op, what = "gmm", f"3 products, x (B{B},E{E},C{C},D{D})"
    elif kind == "mamba2":
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ins = (rnd((B, S, H, P), scale=0.5),
               -(torch.randn((B, S, H), device="cuda") * 0.1).abs(),
               rnd((B, S, N), scale=0.5), rnd((B, S, N), scale=0.5), None)
        dy = rnd((B, S, H, P))

        def backward():
            replay_grads(ssd_ref, ins, (True,) * 4 + (False,), (dy, None))
        op, what = "ssd", f"(B{B},S{S},H{H},P{P},N{N})"
    else:
        H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
        ins = (rnd((B, S, H, P)), rnd((B, S, H, P)), rnd((B, S, H, P)),
               torch.exp(-torch.exp(torch.randn((B, S, H, P),
                                                device="cuda") * 0.5 - 2)),
               torch.randn((H, P), device="cuda") * 0.5, None)
        dy = rnd((B, S, H, P))

        def backward():
            replay_grads(wkv_ref, ins, (True,) * 5 + (False,), (dy, None))
        op, what = "wkv", f"(B{B},S{S},H{H},P{P}), f64"
    bwd_ms = device_ms(torch, backward, 3) * cfg.n_layers
    print(f"  {op} backward (plain PyTorch) at {what}: "
          f"{bwd_ms / cfg.n_layers:.3f} ms a layer, {bwd_ms:.3f} ms a step "
          f"({bwd_ms / busy:.1%} of the step's device busy)")
    figures[f"{op}_bwd_ms"] = bwd_ms
    return launches, figures


def profiled_ms(torch, work, cpu: bool = True):
    """(device busy ms, kernels, {port kernel: ms}) of one ``work()``
    under torch.profiler; prints the six heaviest kernels.  ``cpu=False``
    records the device's activity alone (a step of many host ops costs
    the profiler seconds to record)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        work()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler saw no device time")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:9.3f} ms {ms / busy:6.1%}  {kname[:90]}")
    port = {name: sum(ms for kname, ms in by_name.items() if key in kname)
            for name, key in zip(("flash", "gmm", "ssd", "wkv"),
                                 PORT_KERNELS)}
    return busy, len(kernels), port


def train_launcher_phase(torch):
    """``repro_torch.launch.train.main`` on the card: LAUNCH_STEPS steps at
    full width, which write one checkpoint; then, on the smoke config, a
    straight run of RESUME_STEPS steps; the same run stopped as step
    RESUME_AT begins, after its checkpoint at RESUME_AT was started; then
    resumed.  The resumed run must start at next_batch RESUME_AT and give
    the straight run's losses."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher

    base = ["--arch", TRAIN_ARCH, "--device", "cuda", "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S)]
    args = base + ["--smoke", "--steps", str(RESUME_STEPS), "--ckpt-every",
                   str(RESUME_EVERY)]

    class Stop(Exception):
        pass

    make_train_step = launcher.make_train_step

    def stopping_step_builder(*a, **kw):
        fn = make_train_step(*a, **kw)

        def train_step(params, opt, batch, i):
            if i == RESUME_AT:
                raise Stop
            return fn(params, opt, batch, i)
        return train_step

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        full = base + ["--steps", str(LAUNCH_STEPS), "--ckpt-every",
                       str(LAUNCH_STEPS + 1), "--ckpt-dir", f"{tmp}/full"]
        print(f"train launcher phase: {' '.join(full)}")
        t = time.perf_counter()
        losses = launcher.main(full)
        wall_s = time.perf_counter() - t
        _, state, extra = CheckpointManager(f"{tmp}/full").restore()
        print(f"  losses {losses}; {wall_s:.1f} s with its checkpoint at "
              f"step {extra['next_batch']}")
        check(len(losses) == LAUNCH_STEPS
              and all(map(math.isfinite, losses))
              and extra["next_batch"] == LAUNCH_STEPS
              and state["params"]["embed"].shape[0]
              == get_config(TRAIN_ARCH).vocab_padded,
              "the full-width launcher run went wrong")
        del state
        free_model(torch)

        print(f"train launcher phase: {' '.join(args)}")
        t = time.perf_counter()
        straight = launcher.main(args + ["--ckpt-dir", f"{tmp}/straight"])
        print(f"  straight run: losses {straight} "
              f"({time.perf_counter() - t:.1f} s)")
        free_model(torch)
        launcher.make_train_step = stopping_step_builder
        t = time.perf_counter()
        try:
            launcher.main(args + ["--ckpt-dir", f"{tmp}/resumed"])
            check(False, "the stopped run did not stop")
        except Stop:
            pass
        finally:
            launcher.make_train_step = make_train_step
        free_model(torch)
        mgr = CheckpointManager(f"{tmp}/resumed")
        latest = mgr.latest_step()
        _, _, extra = mgr.restore(latest)
        print(f"  stopped as step {RESUME_AT} began "
              f"({time.perf_counter() - t:.1f} s): latest checkpoint step "
              f"{latest}, next_batch {extra['next_batch']}")
        check(latest == RESUME_AT and extra["next_batch"] == RESUME_AT,
              "the stopped run's last checkpoint is not the expected one")
        t = time.perf_counter()
        resumed = launcher.main(args + ["--ckpt-dir", f"{tmp}/resumed"])
        free_model(torch)
        want = straight[RESUME_AT:]
        ok = len(resumed) == len(want) and all(
            abs(a - b) <= RESUME_RTOL * abs(b) for a, b in zip(resumed, want))
        print(f"  resumed run: losses {resumed} against the straight run's "
              f"{want} (rtol {RESUME_RTOL:g}) "
              f"({time.perf_counter() - t:.1f} s) {'ok' if ok else 'FAIL'}")
        check(ok, "the resumed run's losses differ from the straight run's")


def frontend_launcher_phase(torch):
    """``repro_torch.launch.train.main`` on the card for LAUNCH_STEPS steps
    on each frontend arch's smoke config, B TRAIN_B x S TRAIN_S: the
    prefetch pipeline's f32 frames and patches feed the bf16 models; the
    losses are finite and the final checkpoint holds the encoder's layers
    or the frontend's projection at the config's shape."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launcher

    (ROOT / "build").mkdir(exist_ok=True)
    for arch, _ in FRONTEND:
        cfg = get_smoke_config(arch)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            args = ["--arch", arch, "--smoke", "--device", "cuda", "--batch",
                    str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
                    str(LAUNCH_STEPS), "--ckpt-every", str(LAUNCH_STEPS + 1),
                    "--ckpt-dir", tmp]
            print(f"train launcher phase: {' '.join(args)}")
            t = time.perf_counter()
            losses = launcher.main(args)
            wall_s = time.perf_counter() - t
            _, state, extra = CheckpointManager(tmp).restore()
        params = state["params"]
        print(f"  losses {losses}; {wall_s:.1f} s with its checkpoint at "
              f"step {extra['next_batch']}")
        check(len(losses) == LAUNCH_STEPS
              and all(map(math.isfinite, losses))
              and extra["next_batch"] == LAUNCH_STEPS
              and params["frontend_proj"].shape == (cfg.frontend_dim,
                                                    cfg.d_model)
              and ("enc_layers" in params) == cfg.is_encdec,
              f"{arch}: the smoke launcher run went wrong")
        del state, params
        free_model(torch)


# the parallel phase: the sharded train step (make_train_step(rules=...))
# of each PARALLEL_ARCHS arch at full width and depth, B TRAIN_B x S
# TRAIN_S, against the plain step on a copy of the same weights, in one
# process a visible card (NCCL over a FileStore); each step's loss and
# every gathered leaf within TRAIN_LOSS_RTOL; then PARALLEL_TIMED steps of
# each way timed alone
PARALLEL_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
PARALLEL_STEPS, PARALLEL_TIMED = 2, 3
PARALLEL_TIMEOUT_S = 600


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def parallel_train(torch, arch, mesh, kernels, wide):
    """One arch of the parallel phase on this rank; returns its figures
    (rank 0 prints them)."""
    import copy

    from repro_torch.config import OptimizerConfig
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_tree
    from repro_torch.data import SyntheticTokens
    from repro_torch.parallel import ShardingRules
    from repro_torch.parallel.sharding import _flatten
    from repro_torch.steps import init_train_state, make_train_step

    say = print if torch.distributed.get_rank() == 0 else (lambda *a: None)
    cfg = get_config(arch)
    rules = ShardingRules(cfg, mesh)
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=100)
    src = SyntheticTokens(cfg, TRAIN_S, TRAIN_B, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in src.global_batch_at(i).items()}

    def fresh():
        return init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    def counts():
        return {"flash": kernels["flash"].launches,
                "gmm": kernels["gmm"].launches, "gmm_wide": wide[0]}

    def zero():
        kernels["flash"].launches = kernels["gmm"].launches = wide[0] = 0

    params, opt = fresh()
    plain_params, plain_opt = copy.deepcopy(params), copy.deepcopy(opt)
    rules.distribute_params(params)
    opt = rules.distribute_opt(opt, params)
    sharded = make_train_step(cfg, opt_cfg, rules)
    plain = make_train_step(cfg, opt_cfg)
    want = train_launches(cfg, 1)
    want = {"flash": want["flash"], "gmm": want["gmm"],
            "gmm_wide": want["gmm"]}
    out = {"sharded_launches": dict.fromkeys(want, 0), "losses": []}
    for i in range(PARALLEL_STEPS):
        zero()
        params, opt, m = sharded(params, opt, batch_at(i), i)
        torch.cuda.synchronize()
        got = counts()
        for key in got:
            out["sharded_launches"][key] += got[key]
        zero()
        plain_params, plain_opt, pm = plain(plain_params, plain_opt,
                                            batch_at(i), i)
        torch.cuda.synchronize()
        got_plain = counts()
        pair = (float(m["loss"]), float(pm["loss"]))
        out["losses"].append(pair)
        say(f"  {arch} step {i}: loss sharded {pair[0]:.6f} plain "
            f"{pair[1]:.6f} (rel {rel_diff(pair):.2e}, tol "
            f"{TRAIN_LOSS_RTOL:g}); launches sharded {got}, plain "
            f"{got_plain} (want {want})")
        check(rel_diff(pair) <= TRAIN_LOSS_RTOL,
              f"{arch}: the sharded step's loss differs")
        check(got == want and got_plain == want,
              f"{arch}: launches sharded {got} plain {got_plain} != {want}")
    got_tree = _flatten(params_to_tree(params))
    want_tree = _flatten(params_to_tree(plain_params))
    worst = max(((_rel_l2(got_tree[k], want_tree[k]), k) for k in want_tree))
    say(f"  {arch}: after {PARALLEL_STEPS} steps the largest relative L2 "
        f"difference of a gathered leaf is {worst[0]:.3e} ({worst[1]}), tol "
        f"{TRAIN_LOSS_RTOL:g}")
    check(worst[0] <= TRAIN_LOSS_RTOL,
          f"{arch}: a gathered leaf differs from the plain step's")
    out["worst_leaf"] = worst
    del got_tree, want_tree, plain_params, plain_opt

    def timed(label, step_fn, state):
        def one(i):
            state[0], state[1], _ = step_fn(state[0], state[1], batch_at(i),
                                            i)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(PARALLEL_TIMED):
            t = time.perf_counter()
            one(PARALLEL_STEPS + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        wall = statistics.median(walls)
        busy, n_kernels, _ = profiled_ms(torch, lambda: one(
            PARALLEL_STEPS + PARALLEL_TIMED), cpu=False)
        fig = {"wall_ms": wall, "walls_ms": walls, "busy_ms": busy,
               "idle": max(0.0, 1 - busy / wall), "kernels": n_kernels,
               "peak_gb": peak}
        say(f"  {arch} {label} step: wall ms {[round(w, 3) for w in walls]}"
            f" (median {wall:.3f}), device busy {busy:.3f} ms, idle share "
            f"{fig['idle']:.3f}, {n_kernels} kernels a step, peak memory "
            f"{peak:.2f} GB")
        return fig

    zero()
    out["sharded"] = timed("sharded", sharded, [params, opt])
    got = counts()
    for key in got:
        out["sharded_launches"][key] += got[key]
    del params, opt
    out["plain"] = timed("plain", plain, list(fresh()))
    return out


def parallel_grad_sync(torch, mesh):
    """hierarchical_grad_sync over qwen3-0.6b's gradient tree (one
    backward of the plain model), with and without int8."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.optim.compression import dequantize_int8, quantize_int8
    from repro_torch.parallel.collectives import hierarchical_grad_sync
    from repro_torch.steps import init_train_state

    cfg = get_config("qwen3-0.6b")
    params, _ = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             SyntheticTokens(cfg, TRAIN_S, TRAIN_B, seed=0)
             .global_batch_at(0).items()}
    loss, _ = T.forward_train(cfg, params, batch)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    del params, named, loss
    world = torch.distributed.get_world_size()
    out = {"leaves": len(grads), "mb": sum(g.numel() * g.element_size()
                                           for g in grads.values()) / 1e6}
    for compress in (False, True):
        hierarchical_grad_sync(grads, mesh, compress=compress)    # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = hierarchical_grad_sync(grads, mesh, compress=compress)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        # at one rank: g itself, and with int8 its dequantized int8 form
        # in g's dtype (the reference's cast)
        if compress:
            want = {k: (dequantize_int8(*quantize_int8(g)) * world)
                    .to(g.dtype).float() for k, g in grads.items()}
        else:
            want = {k: g.float() * world for k, g in grads.items()}
        diff = max(float((res[k].float() - want[k]).abs().max())
                   for k in grads)
        out[f"compress={compress}"] = {"ms": ms, "max_abs_diff": diff}
    return out


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the parallel phase (a spawned process, one card)."""
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.moe_gmm import ops as gm
        from repro_torch.launch import train as launcher
        from repro_torch.launch.mesh import make_host_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
            world_size=world, device_id=device)
        model = 2 if world > 1 and world % 2 == 0 else 1
        mesh = make_host_mesh(model)
        say = print if rank == 0 else (lambda *a: None)
        say(f"parallel phase: world size {world}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (NCCL)")
        wide = [0]
        launch = gm._launch

        def counting(x, w):
            y = launch(x, w)
            wide[0] += gm.last_kernel == "wide"
            return y
        gm._launch = counting
        kernels = {"flash": fa, "gmm": gm}
        result = {"world": world,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        for arch in PARALLEL_ARCHS:
            result[arch] = parallel_train(torch, arch, mesh, kernels, wide)
            gc.collect()
            torch.cuda.empty_cache()
        result["grad_sync"] = parallel_grad_sync(torch, mesh)
        say(f"  hierarchical_grad_sync over qwen3-0.6b's "
            f"{result['grad_sync']['leaves']} gradient leaves "
            f"({result['grad_sync']['mb']:.1f} MB): "
            + "; ".join(f"{k}: {v['ms']:.3f} ms, max |diff| "
                        f"{v['max_abs_diff']:.3e}" for k, v in
                        result["grad_sync"].items() if k.startswith("comp")))
        check(all(v["max_abs_diff"] == 0.0 for k, v in
                  result["grad_sync"].items() if k.startswith("comp"))
              or world > 1, "hierarchical_grad_sync changed the gradients")
        ckpt = f"{tmp}/launcher"
        argv = ["--arch", TRAIN_ARCH, "--smoke", "--device", "cuda",
                "--model-parallel", str(model), "--steps", "4",
                "--ckpt-every", "2", "--ckpt-dir", ckpt]
        say(f"  launcher under the group: {' '.join(argv)}, twice")
        first = launcher.main(argv)
        second = launcher.main(argv)
        say(f"  first run losses {first}; second run losses {second}")
        check(len(first) == 4 and all(map(math.isfinite, first))
              and second == [], "the sharded launcher did not resume")
        dist.barrier()
        if rank == 0:
            Path(f"{tmp}/result.json").write_text(json.dumps(result))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        raise


def parallel_phase(torch):
    """The sharded path on every visible card: one spawned process a card
    (NCCL, rendezvous through a FileStore in a temp dir), each running
    ``parallel_rank``.  A rank that fails fails the phase.  Returns rank
    0's figures."""
    import multiprocessing
    import tempfile

    world = torch.cuda.device_count()
    (ROOT / "build").mkdir(exist_ok=True)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=parallel_rank, args=(r, world, tmp))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.time() + PARALLEL_TIMEOUT_S
        for proc in procs:
            proc.join(max(1.0, deadline - time.time()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        check(all(code == 0 for code in codes),
              f"parallel phase: rank exit codes {codes}")
        result = json.loads(Path(f"{tmp}/result.json").read_text())
    print(f"  parallel phase: {time.perf_counter() - t:.1f} s")
    return result


DRYRUN_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_CELL = ("qwen3-0.6b", "decode_32k")
DRYRUN_TIMEOUT_S = 300


def _opcheck_cases(torch):
    """Each kernel operator's arguments at a small shape, bf16, on the
    card."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def t(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    pos = torch.arange(256, dtype=torch.int32, device="cuda")
    q, k, v = t(2, 256, 4, 64), t(2, 256, 2, 64), t(2, 256, 2, 64)
    f32 = torch.float32
    return {
        "flash_fwd": (q, k, v, pos, pos, 0, True, True),
        "gmm": (t(2, 4, 64, 128), t(4, 128, 64, scale=0.1)),
        "ssd": (t(2, 256, 4, 64), -t(2, 256, 4, dtype=f32).abs() * 0.1,
                t(2, 256, 64), t(2, 256, 64), None),
        "wkv": (t(2, 64, 4, 64), t(2, 64, 4, 64), t(2, 64, 4, 64),
                torch.sigmoid(t(2, 64, 4, 64, dtype=f32)) * 0.5 + 0.4,
                t(4, 64, dtype=f32, scale=0.5),
                t(2, 4, 64, 64, dtype=f32)),
    }


def dryrun_phase(torch):
    """The dry run's estimator (``launch/cost_analysis.py``) held against
    the card.  For each of DRYRUN_ARCHS, one train step (B{TRAIN_B} x
    S{TRAIN_S}, bf16, one card, no mesh) traced on meta tensors under the
    counter, then one real step from fresh weights under the same counter
    and the profiler, its peak memory measured from a reset: the FLOPs
    must be equal, the estimated peak within DRYRUN_PEAK_RTOL of the
    measured one (less what was allocated before the model), and the
    device busy is printed against the roofline max(compute_s, memory_s)
    of the card's data sheet.  Then ``torch.library.opcheck`` on each
    kernel operator at a small shape on the card, and one production cell
    (DRYRUN_CELL on the fake (16, 16) mesh) through
    ``python -m repro_torch.launch.dryrun`` in a subprocess (the fake
    group and NCCL cannot share a process)."""
    from repro_torch.config import H100, OptimizerConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.steps import (init_train_state, make_train_step,
                                   train_state_shapes)

    t0 = time.perf_counter()
    opt_cfg = OptimizerConfig(warmup_steps=1, total_steps=100)
    out = {}
    for arch in DRYRUN_ARCHS:
        free_model(torch)
        cfg = get_config(arch)
        step = make_train_step(cfg, opt_cfg)
        src = SyntheticTokens(cfg, TRAIN_S, TRAIN_B, seed=0)
        host = src.global_batch_at(0)

        params, opt = train_state_shapes(cfg)
        params.requires_grad_(True)
        batch = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
                 for k, v in host.items()}
        est = CostCounter()
        est.add_arguments(params, opt, batch)
        t = time.perf_counter()
        with est:
            step(params, opt, batch, 0)
        trace_s = time.perf_counter() - t
        del params, opt, batch

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, opt = init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
        torch.cuda.synchronize()
        real = CostCounter()
        real.add_arguments(params, opt, batch)

        def work():
            with real:
                step(params, opt, batch, 0)

        busy, n_kernels, _ = profiled_ms(torch, work, cpu=False)
        peak = torch.cuda.max_memory_allocated() - base
        del params, opt, batch
        est_peak = est.memory()["peak_bytes"]
        gap = est_peak / peak - 1
        roof = {"compute_ms": est.flops / H100.peak_flops * 1e3,
                "memory_ms": est.bytes / H100.hbm_bw * 1e3}
        print(f"dryrun phase, {arch} train step B{TRAIN_B} S{TRAIN_S}: "
              f"traced on meta in {trace_s:.2f} s: {est.flops / 1e12:.4f} "
              f"TFLOP, {est.bytes / 1e9:.3f} GB moved, peak "
              f"{est_peak / 1e9:.3f} GB (arguments "
              f"{est.argument_bytes / 1e9:.3f}), kernels {est.kernels}")
        print(f"  on the card: {real.flops / 1e12:.4f} TFLOP (equal: "
              f"{real.flops == est.flops}), peak allocated "
              f"{peak / 1e9:.3f} GB (estimate {gap:+.2%}, tol "
              f"{DRYRUN_PEAK_RTOL:.0%}), busy {busy:.3f} ms over "
              f"{n_kernels} kernels against the roofline "
              f"{max(roof.values()):.3f} ms (compute {roof['compute_ms']:.3f}"
              f", memory {roof['memory_ms']:.3f}; data sheet)")
        check(real.flops == est.flops,
              f"{arch}: meta and real FLOPs differ ({est.flops} vs "
              f"{real.flops})")
        check(abs(gap) <= DRYRUN_PEAK_RTOL,
              f"{arch}: estimated peak {est_peak} vs measured {peak}")
        out[arch] = {"flops": est.flops, "bytes": est.bytes,
                     "est_peak_bytes": est_peak, "peak_bytes": peak,
                     "peak_gap": gap, "busy_ms": busy,
                     "roofline_ms": max(roof.values()), **roof,
                     "trace_s": trace_s}
    free_model(torch)

    for name, args in _opcheck_cases(torch).items():
        op = getattr(torch.ops.repro_torch, name).default
        result = torch.library.opcheck(op, args)
        print(f"  opcheck repro_torch::{name}: {result}")
        check(all(v == "SUCCESS" for v in result.values()),
              f"opcheck repro_torch::{name}: {result}")

    arch, shape = DRYRUN_CELL
    out_dir = ROOT / "build" / "dryrun"
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out-dir", str(out_dir)], cwd=ROOT,
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0,
          f"dry run of {arch}/{shape} failed: {proc.stderr[-2000:]}")
    rec = json.loads((out_dir / "16x16" / f"{arch}__{shape}.json")
                     .read_text())
    print(f"  dry run {arch}/{shape} on the fake 16x16 mesh "
          f"({time.perf_counter() - t:.1f} s with the process): peak "
          f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB a device, "
          f"{rec['flops'] / 1e9:.3f} GFLOP, roofline {rec['roofline']}, "
          f"dominant {rec['dominant']}, fits {rec['fits']}")
    out["cell"] = {k: rec[k] for k in ("arch", "shape", "mesh", "memory",
                                       "flops", "roofline", "dominant")}
    print(f"  dryrun phase: {time.perf_counter() - t0:.1f} s")
    return out


def free_model(torch) -> None:
    """Give the last model's memory back before the next one loads."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
          "allocated")


def profile_phase(torch, do_prefill, do_decode, n_decode: int = 8):
    """Where the time goes: one prefill wave and ``n_decode`` decode steps,
    each run once on the host clock and once more under torch.profiler.
    Device busy time is the sum of the profiled kernels' durations (one
    stream, so they do not overlap); the idle share is the rest of the
    unprofiled wall time (the profiler slows the host, not the card)."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = do_prefill()                       # warm
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    def decode_steps():
        nonlocal cache
        for _ in range(n_decode):
            _, cache = do_decode(cache, tok)

    for name, work, n in (("prefill wave", do_prefill, 1),
                          ("decode", decode_steps, n_decode)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
        per = " per step" if n > 1 else ""
        if busy_ms == 0:
            print(f"profile {name}: wall {wall_ms:.3f} ms{per}; the "
                  "profiler saw no device time: busy and idle share not "
                  "measured")
            continue
        print(f"profile {name}: wall {wall_ms:.3f} ms{per}, device busy "
              f"{busy_ms:.3f} ms{per}, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, "
              f"{len(kernels) // n} kernels{per}")
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / n
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
        # the six heaviest, and the port's own kernels wherever they rank
        for kname, ms in [kv for i, kv in enumerate(ranked)
                          if i < 6 or any(k in kv[0] for k in PORT_KERNELS)]:
            print(f"    {ms:9.3f} ms{per} {ms / busy_ms:6.1%}  {kname[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba2_ssd import ops as sd
    from repro_torch.kernels.moe_gmm import ops as gm
    from repro_torch.kernels.rwkv6_wkv import ops as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line())
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    libs = {"flash_fwd": fa, "moe_gmm": gm, "mamba2_ssd": sd,
            "rwkv6_wkv": wk}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for job in [pool.submit(mod.build) for mod in libs.values()]:
            job.result()
    print(f"build: {', '.join(libs)} in {time.perf_counter() - t0:.2f} s")
    for lib, mod in libs.items():
        log = _build.library_path(lib, mod._SOURCES).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_err, inputs = flash_kernel_phase(torch, fa, gen)
    lse_err = flash_train_phase(torch, fa, gen)
    torch.cuda.synchronize()
    flash_times = {arch: flash_timing_phase(torch, fa, arch, inputs[arch])
                   for arch in FLASH_TIMED}
    for label in FLASH_TIMED_WHISPER:
        flash_times[label] = flash_timing_phase(torch, fa, label,
                                                inputs[label], causal=False)
    del inputs
    gmm_err = gmm_kernel_phase(torch, gm, gen)
    gmm_times = gmm_timing_phase(torch, gm, gen)
    ssd_err = ssd_kernel_phase(torch, sd, gen)
    ssd_times = ssd_timing_phase(torch, sd, gen)
    wkv_err = wkv_kernel_phase(torch, wk, gen)
    wkv_times = wkv_timing_phase(torch, wk, gen)
    kernels = {"flash": fa, "gmm": gm, "ssd": sd, "wkv": wk}
    launches = dict.fromkeys(kernels, 0)
    for arch, expect in SERVED:
        free_model(torch)
        for kernel, n in serve_phase(torch, np, kernels, arch,
                                     expect).items():
            launches[kernel] += n
    free_model(torch)
    print(f"launches over the {len(SERVED)} serve runs: {launches}")
    serve_launches = dict(launches)
    prefill_by_path, decode_by_path = (dict.fromkeys(kernels, 0)
                                       for _ in range(2))
    frontend = {}
    for arch, expect in FRONTEND:
        pre, dec, frontend[arch] = frontend_phase(torch, np, kernels, arch,
                                                  expect)
        for kernel in kernels:
            prefill_by_path[kernel] += pre[kernel]
            decode_by_path[kernel] += dec[kernel]
        free_model(torch)
    flash_train, train = train_phase(torch, fa)
    train_by_path = dict.fromkeys(kernels, 0)
    train_by_path["flash"] = flash_train
    frontend_train_by_path = dict.fromkeys(kernels, 0)
    kind_train = {}
    for arch, n_layers in KIND_TRAIN + FRONTEND_TRAIN:
        free_model(torch)
        got, kind_train[arch] = kind_train_phase(torch, kernels, arch,
                                                 n_layers)
        into = (frontend_train_by_path if (arch, n_layers) in FRONTEND_TRAIN
                else train_by_path)
        for kernel, n in got.items():
            into[kernel] += n
    free_model(torch)
    train_launcher_phase(torch)
    frontend_launcher_phase(torch)
    free_model(torch)
    parallel = parallel_phase(torch)
    dryrun = dryrun_phase(torch)
    sharded_by_path = dict.fromkeys(kernels, 0)
    for arch in PARALLEL_ARCHS:
        got = parallel[arch]["sharded_launches"]
        sharded_by_path["flash"] += got["flash"]
        sharded_by_path["gmm"] += got["gmm"]
    by_path = {kernel: {"serve": serve_launches[kernel],
                        "train": train_by_path[kernel],
                        "frontend_prefill": prefill_by_path[kernel],
                        "frontend_decode": decode_by_path[kernel],
                        "frontend_train": frontend_train_by_path[kernel],
                        "sharded_train": sharded_by_path[kernel]}
               for kernel in kernels}
    for kernel, paths in by_path.items():
        launches[kernel] = sum(paths.values())
    print(f"launches by path (serve runs; the timed train steps of "
          f"{TRAIN_ARCH} and of {', '.join(a for a, _ in KIND_TRAIN)}; the "
          f"prefill and decode steps of "
          f"{', '.join(a for a, _ in FRONTEND)}; their timed train steps; "
          f"the sharded train steps of {', '.join(PARALLEL_ARCHS)}): "
          f"{by_path}")

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": launches["flash"],
        "launches_by_path": by_path["flash"],
        "max_abs_err": flash_err,
        "lse_max_abs_err": lse_err,
        **flash_times["qwen3-0.6b"],
        # the same figures at every served head dim (granite 64, zamba2
        # 80) and at whisper-base's two non-causal shapes (head dim 64)
        "by_shape": [{"arch": arch, "head_dim": d, **flash_times[arch]}
                     for arch, d in FLASH_TIMED.items()] + [
            {"arch": label, "head_dim": WHISPER_HEADS[2], "causal": False,
             **flash_times[label]} for label in FLASH_TIMED_WHISPER],
        # the train step (host clock, profiler busy, flash ms a step) with
        # the kernels and with plain attention; the plain backward a step
        "train": train,
        # whisper-base's and internvl2-2b's prefill and decode, and their
        # train steps with the plain flash backward a step
        "frontend": frontend,
        "frontend_train": {arch: kind_train[arch]
                           for arch, _ in FRONTEND_TRAIN},
        # the parallel phase: the sharded and plain train steps of qwen3
        # (wall, busy, idle, kernels, peak), on the world's mesh
        "sharded_train": {"world": parallel["world"],
                          "mesh": parallel["mesh"],
                          "qwen3-0.6b": {
                              k: parallel["qwen3-0.6b"][k]
                              for k in ("sharded", "plain", "losses")},
                          "grad_sync": parallel["grad_sync"]},
        # the dry run's estimate of two train steps against the card, and
        # one production cell traced on the fake (16, 16) mesh
        "dryrun": dryrun,
    }, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:42",
        "launches": launches["gmm"],
        "launches_by_path": by_path["gmm"],
        "max_abs_err": gmm_err,
        **{k: gmm_times[0][k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")},
        # the same figures for wi and wo at prefill (wide kernel) and
        # decode (narrow kernel); the entry leads with prefill wi
        "by_shape": gmm_times,
        # granite-moe-1b-a400m's train step and the plain gmm backward
        "train": kind_train["granite-moe-1b-a400m"],
        # the parallel phase's sharded and plain granite train steps
        "sharded_train": {k: parallel["granite-moe-1b-a400m"][k]
                          for k in ("sharded", "plain", "losses")},
    }, {
        "name": "mamba2_ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:77",
        "launches": launches["ssd"],
        "launches_by_path": by_path["ssd"],
        "max_abs_err": ssd_err,
        **ssd_times,
        # zamba2-2.7b's train step and the plain ssd backward
        "train": kind_train["zamba2-2.7b"],
    }, {
        "name": "rwkv6_wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:80",
        "launches": launches["wkv"],
        "launches_by_path": by_path["wkv"],
        "max_abs_err": wkv_err,
        **wkv_times,
        # rwkv6-7b's train step (RWKV_TRAIN_LAYERS layers) and the plain
        # wkv backward
        "train": kind_train["rwkv6-7b"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

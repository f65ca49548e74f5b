#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-timing N     # only the served paths' times

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device: build the flash-attention forward and backward and the mLSTM
     forward and backward kernels from src/repro_torch/kernels/csrc into
     build/kernels/ (one nvcc each, in parallel), print their ptxas reports
     and the card's name and power limit;
  2. kernel: hold the kernel against its plain PyTorch version on the card
     (the cases of tests/test_kernels.py, ragged S, a query offset, G = 4; fp32
     and bf16), and the bf16 kernel on the edges of its tiles and TMA boxes
     (Sq and Sk of 1 to 4097, q_offset, non-causal Sq != Sk, G = 1/4/8, Dh =
     32/64/128, B > 1 with KH > 1); then time it at the qwen3-8b prefill shape
     beside the plain version, F.scaled_dot_product_attention, and the card's
     bound, and beside SDPA at S = 512-8192 and at the served batch;
  3. prefill: qwen3-8b at full width and depth (36 layers, bf16, seeded random
     weights), one forward over 4 prompts of 32 tokens through the kernel and
     through the plain version, logits compared; the eager prefill and decode
     step timed, with the device's busy time from torch.profiler; one forward
     of a 4096-token prompt timed, with the kernel's share of its device time;
  4. serve: 4 requests on the port's own log, served by ServeEngine (prefill
     through the kernel, 15 decode steps), the kernel launched once a layer;
  5. speculative, in fp32: the phase-3 comparison again on an fp32 qwen3-8b,
     at the tests' fp32 tolerance; then with a smollm-135m draft and k = 4,
     one request of 16 tokens decoded through log.speculate() sessions
     equals sequential greedy decode;
  6. mlstm kernel: hold the chunkwise-mLSTM kernel against its plain version
     (h and the final state C, n, m) on the cases of tests/test_kernels.py, a
     carried-in state, ragged S, Dh = 1024 at the served shape, and stress
     inputs (small forget gates, near-cancelling denominators, S = 4096 with
     a carried state); the same call twice gives the same bits; then time it
     at the xlstm-1.3b prefill and served shapes, each of its kernels by
     torch.profiler, beside the plain version and the bounds;
  7. xlstm prefill: xlstm-1.3b at full width and depth (48 layers, seeded
     random weights), one forward over 4 prompts of 256 tokens through the
     kernel (launched once an mLSTM layer), each layer's kernel call held
     against the plain version on the same inputs; the logits against a
     forward through the plain version, in bf16 and in fp32; the eager
     prefill and decode step timed, with the device's busy time;
  8. xlstm serve: 4 requests (prompts of 37-256 tokens, 16 new tokens each)
     served by ServeEngine in bf16 on the port's log, the kernel launched once
     an mLSTM layer; a restarted engine serves 0;
  9. train: (a) the flash backward kernel against autograd through the plain
     version on the phase-2 cases and edges and at the shape (d) gives it,
     in fp32 and bf16, a second call equal bit for bit, then timed at the
     qwen3-8b training shape beside the plain version, SDPA's backward, the
     bound and the two-pass design bound, pass by pass (delta, dK/dV, dQ,
     by torch.profiler) beside each pass's share of the bound, and at
     smollm-135m's shape beside SDPA's backward; (b) qwen3-8b at full width with 8 of its 36 layers trained 6
     steps by the launcher (repro_torch.launch.train.run: the token topic on
     the port's log, bf16, AdamW with fp32 master and moments, remat full,
     batch 2 x 4096 in 2 microbatches), with step time, tokens/s, peak
     memory, and the device's busy and idle shares of one more step of the
     shape; (c) one train step, kernels against plain, at full width with 2
     layers in fp32 and bf16; (d) smollm-135m at full size: a run of 2k
     steps against a run checkpointed to the log at step k and resumed by a
     fresh run(resume=True) on the same BoltSystem, the losses after k equal
     bit for bit. Every run of the launcher in (b) and (d) is a main path:
     the forward and backward kernels launched the counted number of times;
 10. train xlstm: (a) the mLSTM backward kernel, through MLSTMChunkFunction,
     against autograd of the plain version on phase 6's cases (carried
     states with the final state's gradient coming in) and on inputs where
     the floor exp(-m) wins, near-cancelling denominators against fp64, a
     second call equal bit for bit; then timed at xlstm-1.3b's training
     shape (B=2, H=4, S=2048, Dh=1024, chunk 64) beside the plain version,
     the bound and the design floor (the walks' split products at the bf16
     rate, their scratch bytes at the memory rate), each __global__ by
     torch.profiler (ms a call, mean of 3 calls); (b) xlstm-1.3b at full
     width and depth (48 layers, 42 mLSTM + 6 sLSTM) trained 2 steps by the
     launcher (bf16, AdamW with fp32 master and moments, remat full, batch
     2 x 2048), its first loss against the plain version's on the same
     weights and batch, with step time, tokens/s, peak memory, the busy and
     idle shares of one more step, the mLSTM kernels' and the sLSTM blocks'
     shares of busy time; (c) one step, kernels against plain, at full
     width with one pattern (8 layers) in fp32 and bf16 under remat none,
     full and dots, against the floor of two plain steps (chunk 64 and 32);
     (d) the same 8 layers at batch 2 x 512: 4 steps straight against 2, a
     checkpoint to the log and 2 resumed, equal bit for bit. Every launcher
     run counts the mLSTM and flash kernels (flash: 0).
The line before the last lists the kernels as JSON, each with its launches
on every main path (launches_by_path) and their sum (launches); the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 peak outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # kernel against plain
# Full-depth prefill logits, kernel against plain. fp32: the tests' fp32
# logit tolerance (tests/test_torch_lm.py); a fault of the kernel's indexing
# or masks shows as O(1). bf16: tests/test_arch_smoke.py:94 allows 0.15 at 3-4
# layers; two bf16 forwards that round P at different places drift apart by
# rounding noise that grows with depth, about 3x over 36 layers, so 0.5 at
# most, and 5e-2 relative RMS.
PREFILL_TOL = {torch.float32: {"max_abs": 1e-4, "rel_rms": 1e-5},
               torch.bfloat16: {"max_abs": 0.5, "rel_rms": 5e-2}}
# (B, H, KH, Sq, Sk, Dh, causal, q_offset)
KERNEL_CASES = [
    (1, 2, 2, 128, 128, 64, True, 0),          # tests/test_kernels.py FLASH_CASES
    (2, 4, 2, 256, 256, 64, True, 0),
    (2, 8, 2, 256, 256, 128, True, 0),
    (1, 3, 1, 384, 384, 64, True, 0),
    (2, 4, 4, 256, 256, 64, False, 0),
    (1, 2, 1, 512, 512, 32, True, 0),
    (2, 4, 2, 100, 100, 64, True, 0),          # S = 100
    (1, 32, 8, 1000, 1000, 128, True, 0),      # S = 1000, qwen3-8b heads
    (1, 8, 2, 64, 192, 128, True, 128),        # q_offset: a later chunk of a sequence
    (2, 16, 4, 256, 256, 128, True, 0),        # G = 4
    (4, 32, 8, 32, 32, 128, True, 0),          # the served qwen3-8b prefill batch
]
# bf16 kernel against plain on the edges of its 128-row q and kv tiles and
# of its TMA boxes: (B, H, KH, Sq, Sk, Dh, causal, q_offset)
EDGE_CASES = [
    *[(1, 4, 2, n, n, 128, True, 0) for n in (1, 63, 65, 127, 129, 4097)],
    *[(2, 4, 2, 129, n, 64, False, 0) for n in (1, 63, 65, 127, 4097)],  # non-causal
    (2, 8, 2, 129, 300, 128, True, 171),       # q_offset, Sq < Sk, B > 1, KH > 1
    (1, 8, 2, 63, 1000, 128, True, 937),       # the last 63 rows of a sequence
    (1, 8, 2, 65, 4097, 128, True, 100),       # keys past the last row unseen
    (2, 4, 4, 127, 129, 32, True, 2),          # G = 1, Dh = 32
    (1, 4, 2, 129, 4097, 32, False, 0),        # Dh = 32, non-causal, long Sk
    (2, 16, 4, 129, 129, 64, True, 0),         # G = 4, Dh = 64
    (2, 16, 2, 200, 200, 128, True, 0),        # G = 8
    (3, 8, 2, 65, 127, 128, False, 0),         # non-causal Sk != Sq, B = 3
    (1, 2, 1, 1, 129, 64, True, 128),          # one query at the end
]
PREFILL_SHAPE = (1, 32, 8, 4096, 128)          # qwen3-8b prefill: B, H, KH, S, Dh
# the prefill shape's heads at other lengths (B*S = 4096 to S = 4096), and
# the served qwen3-8b prefill batch
SWEEP = [(8, 512), (4, 1024), (2, 2048), (1, 4096), (1, 8192), (4, 32)]   # (B, S)
LONG_PROMPT = (1, 4096)                        # phase 3's long-prompt forward
SERVE_PROMPTS = (5, 13, 21, 32)                # phase 4's served qwen3-8b batch
# mLSTM kernel against plain, both fp32: tests/test_kernels.py's tolerance
# for the chunkwise form; the kernel's scans and products sum in another order
MLSTM_TOL = 3e-4
# (B, H, S, Dh, chunk, carried-in state, inputs: see mlstm_inputs)
MLSTM_CASES = [
    (1, 2, 64, 32, 16, False, None),           # tests/test_kernels.py MLSTM_CASES
    (2, 3, 128, 64, 32, False, None),
    (1, 4, 128, 128, 64, False, None),
    (2, 2, 96, 32, 32, False, None),
    (2, 2, 128, 64, 32, True, None),           # a carried-in state
    (1, 2, 100, 64, 32, False, None),          # ragged S
    (1, 2, 70, 1024, 64, True, None),          # Dh = 1024, ragged, carried
    (4, 4, 256, 1024, 64, False, None),        # the served xlstm-1.3b prefill
    (1, 4, 256, 1024, 64, True, "forget"),     # F in the hundreds within a chunk
    (1, 4, 256, 1024, 64, True, "cancel"),     # q nearly orthogonal to n
    (2, 2, 128, 64, 32, True, "cancel"),
    (1, 4, 4096, 1024, 64, True, None),        # the prefill shape, carried state
]
MLSTM_SHAPE = (1, 4, 4096, 1024, 64)           # xlstm-1.3b prefill: B, H, S, Dh, chunk
MLSTM_SERVED = (4, 4, 256, 1024, 64)           # the served xlstm-1.3b batch's calls
MLSTM_PIECES = 6       # bf16 products per fp32 product in the kernel's walk (3 pieces)
# xlstm-1.3b at full depth with random weights is ill-conditioned: where
# |q . n| nears 0 in some mLSTM layer, h jumps, and a rounding difference
# anywhere grows to O(1) in the logits (two plain forwards that differ only
# in the chunk length, i.e. the order of sums, differ by rel. RMS ~0.2 in
# fp32 and ~0.45 in bf16 over 48 layers). So the kernel is held layer by
# layer, on the inputs each layer sees in the full-depth forward: the state
# (C, n, m) at the tests' mLSTM tolerance, h against an fp64 plain version
# (see check_xlstm_prefill); and the logits, kernel against plain, to within
# XLSTM_FLOOR_FACTOR times that floor, measured in the same run.
XLSTM_FLOOR_FACTOR = 3.0
XLSTM_TAIL_FACTOR = 10.0
XLSTM_PROMPT = (4, 256)
XLSTM_SERVE_PROMPTS = (37, 100, 190, 256)


# flash backward against autograd through the plain version: the wrapper's
# BWD_TOL (kernels/flash_attention.py), on KERNEL_CASES, EDGE_CASES and the
# shape phase 9d's training gives the kernels (smollm-135m: G = 3, Dh = 64)
RESUME_CASES = [(4, 9, 3, 1024, 1024, 64, True, 0)]
TRAIN_SHAPE = (1, 32, 8, 4096, 128)            # qwen3-8b training: B, H, KH, S, Dh
SMOLLM_SHAPE = (4, 9, 3, 1024, 64)             # smollm-135m training, phase 9d's: G = 3
# the bf16 backward's two passes do seven products against the five of the
# bound: the dQ pass recomputes S and dP (dK/dV: 4 products, dQ: 3)
BWD_PASSES = {"dkdv": 4, "dq": 3}
# phase 9b: qwen3-8b at full width, depth cut to 8 of 36 layers (AdamW's fp32
# master and moments for 36 layers, 8.2 B x 16 bytes = 131 GB, do not fit one
# card; 8 layers, 2.8 B parameters, take ~45 GB); remat is the config's, full
TRAIN_RUN = dict(config="qwen3-8b", n_layers=8, batch=2, seq=4096, accum=2, steps=6)
# phase 9c: one step, kernels against plain, at train/step.py's STEP_TOL
# (fp32) and BF16_STEP_TOL. Adam's first update is g / (|g| + eps), so a
# weight whose gradient is within eps of 0 moves by lr / eps times its
# gradient's rounding error: at eps = 1e-8 a 7e-10 difference in an
# embedding row's gradient (the two attention paths sum in different orders)
# moved a weight by 7e-5. So the check runs at STEP_EPS = 1e-6, 100x less
# sensitive; at the optimizer's own eps (AdamWConfig's 1e-8) the step is run
# as well, and every parameter that differs beyond STEP_TOL there must have
# a (clipped) gradient within NEAR_ZERO_GRAD x eps of 0
STEP_LR = 1e-3
STEP_EPS = 1e-6
NEAR_ZERO_GRAD = 10.0
# the step's gradients, kernels against plain: fp32 as the backward kernel
# alone (1e-4 of each tensor's max); bf16 relative RMS per tensor, a guard
# against gross faults only, as bf16 rounds each layer's activations
STEP_GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}
RESUME_RUN = dict(config="smollm-135m", n_layers=30, batch=4, seq=1024)
RESUME_K = 3
# phase 10a: the mLSTM backward against autograd of the plain version at the
# wrapper's BWD_TOL; the "cancel" inputs (near-cancelling denominators) against
# an fp64 plain autograd, within BWD_FLOOR_FACTOR of the fp32 plain version's
# own error (kernels/mlstm_chunk.py). Phase 6's cases, a carried state with
# the final state's gradient (dC, dn, dm) coming in, and inputs where the
# floor exp(-m) wins
MLSTM_BWD_CASES = MLSTM_CASES + [(1, 2, 128, 96, 64, True, "floor")]
MLSTM_TRAIN_SHAPE = (2, 4, 2048, 1024, 64)     # xlstm-1.3b training: B, H, S, Dh, chunk
# phase 10b: xlstm-1.3b at full width and depth (1.3 B parameters x 16 bytes
# of bf16 weights, fp32 master and moments and bf16 gradients, ~21 GB, fit
# one card); 2 x 2048 tokens (xLSTM's published context for 1.3B), remat full.
# 2 steps, not 4: a step takes ~48 s on an H100, nearly all of it the eager
# sLSTM step loop (6 layers x 2048 steps, ~90 kernels a step with its remat
# and backward). Its tied embeddings start it far above ln V (the residual
# stream still holds the input token's embedding, whose logit is ~|e| sqrt(d);
# the JAX reference starts there too, tests/test_torch_xlstm_train.py), so
# its first loss is held against a forward of the initial weights on the
# first batch through the plain version, within XLSTM_FLOOR_FACTOR times the
# floor of two plain forwards (chunk 64 against 32) or BF16_STEP_TOL's loss
XLSTM_TRAIN_RUN = dict(config="xlstm-1.3b", n_layers=48, batch=2, seq=2048, accum=1, steps=2)
# phase 10c: one step, kernels against plain, full width with one whole
# pattern (7 mLSTM + 1 sLSTM), batch 2 x 512 (8 chunks); where random-weight
# ill-conditioning puts the floor of two plain steps (chunk 64 against 32)
# above the tolerance, the kernels are held to XLSTM_FLOOR_FACTOR times it
XLSTM_STEP_LAYERS = 8
XLSTM_STEP_BATCH = (2, 512)
# phase 10d: full width, one pattern, batch 2 x 512: 4 steps straight against
# 2, a checkpoint, and 2 resumed
XLSTM_RESUME_RUN = dict(config="xlstm-1.3b", n_layers=8, batch=2, seq=512)
XLSTM_RESUME_K = 2
MLSTM_FWD_KERNELS = ("mlstm_gates", "mlstm_prep", "mlstm_den", "mlstm_walk", "mlstm_out")


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, cpu: bool = True) -> list:
    """(name, device ms) of each kernel of one synchronised call of ``fn``
    under torch.profiler; empty where the profiler sees no device time.
    ``cpu=False`` records the device alone and reads the profiler's raw
    events: for a call of a million kernels torch's event tree takes
    minutes to build, the raw events seconds."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    if not cpu:
        return [(e.name(), e.duration_ns() / 1e6)
                for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == cuda]


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return name.removeprefix("void ")


def logit_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float())
    return {"max_abs": d.abs().max().item(),
            "rel_rms": (d.norm() / b.float().norm()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}


def randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_device():
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import BWD_SOURCES as FLASH_BWD_SOURCES
    from repro_torch.kernels.flash_attention import SOURCES as FLASH_SOURCES
    from repro_torch.kernels.mlstm_chunk import BWD_SOURCES as MLSTM_BWD_SOURCES
    from repro_torch.kernels.mlstm_chunk import SOURCES as MLSTM_SOURCES
    libs = {"flash_attention": FLASH_SOURCES, "flash_attention_bwd": FLASH_BWD_SOURCES,
            "mlstm_chunk": MLSTM_SOURCES, "mlstm_chunk_bwd": MLSTM_BWD_SOURCES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:       # one nvcc each, together
        built = dict(zip(libs, pool.map(build.build, libs, libs.values())))
    say(f"[device] built {', '.join(str(p.relative_to(ROOT)) for p in built.values())} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, sources in libs.items():
        for line in build.report(name, sources).splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill", "C75")):
                say(f"[device] {name} ptxas: {line.replace('ptxas info', '').strip(' :')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi.splitlines()[0])
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_kernel() -> dict:
    from repro_torch.kernels.flash_attention import _forward_kernel, flash_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for B, H, KH, Sq, Sk, Dh, causal, q_offset in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, Sq, Dh), dtype)
            k, v = randn(gen, (B, KH, Sk, Dh), dtype), randn(gen, (B, KH, Sk, Dh), dtype)
            out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
            ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            say(f"[kernel] B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} Dh={Dh} causal={causal} "
                f"q_offset={q_offset} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(tol {TOL[dtype]})")
            if not err <= TOL[dtype]:
                raise AssertionError(f"kernel disagrees with its plain version: {err}")
    for B, H, KH, Sq, Sk, Dh, causal, q_offset in EDGE_CASES:
        q = randn(gen, (B, H, Sq, Dh), torch.bfloat16)
        k = randn(gen, (B, KH, Sk, Dh), torch.bfloat16)
        v = randn(gen, (B, KH, Sk, Dh), torch.bfloat16)
        out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        say(f"[kernel] edge B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} Dh={Dh} causal={causal} "
            f"q_offset={q_offset} bfloat16: max_abs_err={err:.3e} (tol {TOL[torch.bfloat16]})")
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"kernel disagrees with its plain version at an edge: {err}")

    B, H, KH, S, Dh = PREFILL_SHAPE
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention(q, k, v, causal=True, impl="plain")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"kernel disagrees at the prefill shape: {err}")
    del out
    ke, ve = k.repeat_interleave(H // KH, 1), v.repeat_interleave(H // KH, 1)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, impl="plain"),
                       iters=3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                         iters=20)
    lse_ms = cuda_ms(lambda: _forward_kernel(q, k, v, True, 0, with_lse=True), iters=20)
    ms_again = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    flops = 2 * B * H * S * S * Dh              # 4*B*H*S^2*Dh, halved by the mask
    nbytes = 2 * (2 * B * H * S * Dh + 2 * B * KH * S * Dh)   # Q, O, K, V in bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    say(f"[kernel] prefill shape B={B} H={H} KH={KH} S={S} Dh={Dh} bf16 causal: "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"(ops {t_ops:.4f}, bytes {t_bytes:.4f}); max_abs_err {err:.3e}; with the lse "
        f"output {lse_ms:.4f} ms, without it again {ms_again:.4f} ms")
    del q, k, v, ke, ve, ref
    for B, S in SWEEP:
        q = randn(gen, (B, H, S, Dh), torch.bfloat16)
        k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
        ke, ve = k.repeat_interleave(H // KH, 1), v.repeat_interleave(H // KH, 1)
        k_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
        s_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                       iters=20)
        fl = 2 * B * H * S * S * Dh
        say(f"[kernel] sweep B={B} H={H} KH={KH} S={S} Dh={Dh} bf16 causal: kernel "
            f"{k_ms:.4f} ms ({fl / k_ms / 1e9:.1f} TFLOP/s), sdpa {s_ms:.4f} ms "
            f"({fl / s_ms / 1e9:.1f} TFLOP/s), kernel/sdpa {k_ms / s_ms:.3f}")
        del q, k, v, ke, ve
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def prefill_tokens(cfg, shape=(4, 32)) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return torch.randint(2, cfg.vocab_size, shape, generator=gen, device="cuda")


@torch.no_grad()
def check_prefill(cfg, model, tag: str) -> None:
    """One forward of 4 prompts x 32 tokens through the kernel (launched once
    a layer) and through the plain version; logits finite and close."""
    from repro_torch import forward
    from repro_torch.kernels.flash_attention import flash_attention
    tokens = prefill_tokens(cfg)
    before = flash_attention.launches
    logits, _, _, _ = forward(cfg, model, {"tokens": tokens})
    if flash_attention.launches - before != cfg.n_layers:
        raise AssertionError("the prefill did not launch the kernel once a layer")
    plain, _, _, _ = forward(cfg, model, {"tokens": tokens}, attn_impl="plain")
    if logits.shape != (*tokens.shape, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    d = logit_diff(logits, plain)
    tol = PREFILL_TOL[logits.dtype]
    say(f"[prefill] {tag} B=4 S=32: logits {tuple(logits.shape)} finite; kernel vs plain "
        f"max_abs {d['max_abs']:.3e}, rel_rms {d['rel_rms']:.3e} (tol {tol}), "
        f"argmax agree {d['argmax_agree']:.4f}")
    if not all(d[key] <= limit for key, limit in tol.items()):
        raise AssertionError(f"{tag} prefill logits disagree: {d}")


@torch.no_grad()
def time_prefill_and_decode(cfg, model, tag: str, tokens) -> None:
    """The eager prefill and one decode step, each timed and profiled."""
    from repro_torch import decode_step, forward
    S = tokens.shape[1]
    logits, _, caches, _ = forward(cfg, model, {"tokens": tokens}, want_caches=True,
                                   max_len=S + 1)
    nxt = logits[:, -1:, :cfg.vocab_size].argmax(-1)
    prefill = lambda: forward(cfg, model, {"tokens": tokens}, want_caches=True,  # noqa: E731
                              max_len=S + 1)
    decode = lambda: decode_step(cfg, model, caches, nxt, S)  # noqa: E731
    for name, fn in (("forward(want_caches)", prefill), ("decode_step", decode)):
        ms = cuda_ms(fn, iters=5, warmup=1)
        kernels = device_kernels(fn)
        busy = sum(t for _, t in kernels)
        share = "device time not measured" if not kernels else (
            f"device busy {busy:.2f} ms in {len(kernels)} kernels, idle share "
            f"{1 - busy / ms:.3f}")
        say(f"[{tag}] {name} B={tokens.shape[0]} S={S}: {ms:.2f} ms eager; {share}")


@torch.no_grad()
def time_long_prompt(cfg, model) -> None:
    """One forward of a LONG_PROMPT-token prompt through the kernel: its
    time and the kernel's share of its device time."""
    from repro_torch import forward
    from repro_torch.kernels.flash_attention import flash_attention
    tokens = prefill_tokens(cfg, LONG_PROMPT)
    fn = lambda: forward(cfg, model, {"tokens": tokens})  # noqa: E731
    before = flash_attention.launches
    logits, _, _, _ = fn()
    if flash_attention.launches - before != cfg.n_layers:
        raise AssertionError("the long prefill did not launch the kernel once a layer")
    if not torch.isfinite(logits).all():
        raise AssertionError("the long prefill's logits are not finite")
    del logits
    ms = cuda_ms(fn, iters=3, warmup=1)
    kernels = device_kernels(fn)
    busy = sum(t for _, t in kernels)
    mine = sum(t for name, t in kernels if "flash_fwd_bf16" in name)
    tail = "device time not measured" if not kernels else (
        f"device busy {busy:.2f} ms, flash kernel {mine / busy:.4f} of it "
        f"({mine:.2f} ms in {cfg.n_layers} launches)")
    say(f"[prefill] forward B={tokens.shape[0]} S={tokens.shape[1]}: {ms:.2f} ms eager; "
        f"{tail}")


def phase_prefill(cfg, model) -> None:
    check_prefill(cfg, model, "qwen3-8b bf16")
    time_prefill_and_decode(cfg, model, "prefill", prefill_tokens(cfg))
    time_long_prompt(cfg, model)
    say(f"[prefill] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_serve(cfg, model, kernel, n_launches: int, prompts, tag: str) -> tuple:
    """4 requests on the port's own log, 16 new tokens each; ``kernel`` is
    launched ``n_launches`` times in the served batch: its count is set to 0
    just before and read just after. Returns (launches, the batch's seconds)."""
    from repro_torch.core import BoltSystem
    from repro_torch.serve import ServeEngine, decode_response
    from repro_torch.streams import Producer, Topic
    system = BoltSystem(n_brokers=3)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    rng = np.random.default_rng(2)
    prod = Producer(req)
    for i, n in enumerate(prompts):
        prod.produce({"id": f"r{i}",
                      "prompt": [int(t) for t in rng.integers(2, cfg.vocab_size, n)]})
    prod.flush()
    gen_tokens = 16
    eng = ServeEngine(cfg, model, req, resp, batch_size=4)
    torch.cuda.synchronize()
    kernel.launches = 0                          # the main path starts here
    t0 = time.perf_counter()
    served = eng.poll_and_serve(gen_tokens=gen_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches                   # ... and ends here
    out = decode_response(resp.log.read(0, resp.log.visible_tail))
    if served != 4 or sorted(out) != ["r0", "r1", "r2", "r3"]:
        raise AssertionError(f"served {served}: {sorted(out)}")
    if not all(len(t) == gen_tokens and all(0 <= x < cfg.vocab_size for x in t)
               for t in out.values()):
        raise AssertionError(f"bad responses {out}")
    if launches != n_launches:
        raise AssertionError(f"{kernel.__name__} launched {launches} times, "
                             f"want {n_launches}")
    if ServeEngine(cfg, model, req, resp, batch_size=4).poll_and_serve() != 0:
        raise AssertionError("a restarted engine re-served committed requests")
    say(f"[{tag}] {cfg.name}: {served} requests (prompts {list(prompts)}) x {gen_tokens} "
        f"tokens in {dt:.3f} s: {served / dt:.2f} requests/s, "
        f"{served * gen_tokens / dt:.1f} tokens/s; {kernel.__name__} launches "
        f"{launches}; restarted engine served 0")
    return launches, dt


def phase_speculative() -> None:
    from repro_torch import get_config, init_params
    from repro_torch.core import BoltSystem
    from repro_torch.serve import (ModelDraft, ModelTarget, SpeculativeDecoder,
                                   decode_response, sequential_decode)
    # fp32: the speculative path reads draft positions from the decode step
    # and sequential decode from the prefill; in bf16 the two round at
    # different places and a near-tie of random weights can flip a token
    tcfg = get_config("qwen3-8b").with_(dtype="float32")
    # the draft must share the target's vocabulary: smollm-135m at its full
    # width and depth, with qwen3's vocabulary
    dcfg = get_config("smollm-135m").with_(dtype="float32", vocab_size=tcfg.vocab_size)
    system = BoltSystem(n_brokers=2)
    tmodel = init_params(tcfg, 3)
    check_prefill(tcfg, tmodel, "qwen3-8b fp32")
    target = ModelTarget(tcfg, tmodel, stats=system.serve_stats)
    draft = ModelDraft(dcfg, init_params(dcfg, 4), stats=system.serve_stats)
    prompt = [int(t) for t in np.random.default_rng(5).integers(2, tcfg.vocab_size, 12)]
    t0 = time.perf_counter()
    ref = sequential_decode(target, prompt, 16)
    t1 = time.perf_counter()
    log = system.create_log("resp")
    res = SpeculativeDecoder(target, draft, k=4, stats=system.serve_stats).decode_request(
        log, "spec0", prompt, 16)
    t2 = time.perf_counter()
    if res.tokens != ref or decode_response(log.read(0, log.visible_tail)) != {"spec0": ref}:
        raise AssertionError(f"speculative {res.tokens} != sequential {ref}")
    say(f"[speculative] qwen3-8b target, smollm-135m draft, fp32, k=4: 16 tokens equal "
        f"sequential decode; {len(res.rollouts)} rollouts, acceptance "
        f"{res.acceptance:.3f}; sequential {t1 - t0:.2f} s, speculative {t2 - t1:.2f} s")


def mlstm_inputs(gen: torch.Generator, B, H, S, Dh, kind=None):
    """Random mLSTM inputs. kind "forget": small forget gates (log f ~ -8 a
    step, so F reaches hundreds within a chunk); "floor": small input gates,
    so the floor exp(-m) is the denominator; "cancel": keys along one
    direction u and queries nearly orthogonal to it, so q . n cancels to a
    few percent of |q| |n| while staying above the floor exp(-m)."""
    q, k, v = (randn(gen, (B, H, S, Dh), torch.float32) for _ in range(3))
    li = randn(gen, (B, H, S), torch.float32)
    lf = F.logsigmoid(randn(gen, (B, H, S), torch.float32) + 2.0)
    k = k * Dh ** -0.5
    if kind == "forget":
        lf = 2.0 * F.logsigmoid(randn(gen, (B, H, S), torch.float32) - 4.0)
    elif kind == "floor":
        li = li - 8.0                      # exp(-m) ~ e^8 beats |q . n| on most rows
    elif kind == "cancel":
        u = randn(gen, (Dh,), torch.float32)
        u /= u.norm()
        k = (u + 0.05 * randn(gen, (B, H, S, Dh), torch.float32)) * 4 * Dh ** -0.5
        q = q - (q @ u)[..., None] * u + 0.05 * randn(gen, (B, H, S, 1), torch.float32) * u
        li = li + 3.0
    elif kind is not None:
        raise ValueError(kind)
    return q, k, v, li, lf


def mlstm_err(out, ref) -> tuple:
    """(max abs error, max of |out - ref| / (tol + tol |ref|)): <= 1 passes."""
    d = (out - ref).abs()
    return d.max().item(), (d / (MLSTM_TOL * (1 + ref.abs()))).max().item()


def mlstm_kernel_ms(args, chunk: int, iters: int = 10) -> tuple:
    """(ms a call, {kernel: ms a call} from torch.profiler) of mlstm_chunk."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    fn = lambda: mlstm_chunk(*args, chunk=chunk)  # noqa: E731
    ms = cuda_ms(fn, iters=iters)
    per = {}
    for name, t in device_kernels(fn):
        per[short_name(name)] = per.get(short_name(name), 0.0) + t
    return ms, per


def mlstm_bounds(B, H, S, Dh, chunk) -> dict:
    """Least times (ms) for the mLSTM call at these shapes on an H100 SXM:
    the bytes (q, k, v read and h written in fp32, li and lf read, the state
    written) and the function's operations once each at the bf16 tensor-core
    rate, the type the kernel multiplies in; the bound is the larger. Design
    figures beside it: the kernel's own work, its tensor-core products (Q
    C0, the update of C, (Q K^T .* W) V) MLSTM_PIECES times at the bf16 rate
    plus Q K^T and W K at the fp32 rate; and the operations once each at
    the fp32 rate (no tensor cores)."""
    n = (S // chunk) * B * H
    tc = (4 * chunk * Dh ** 2 + 2 * chunk ** 2 * Dh) * n      # on the tensor cores
    cc = 4 * chunk ** 2 * Dh * n                              # on CUDA cores
    nbytes = 4 * (4 * B * H * S * Dh + 2 * B * H * S + B * H * (Dh * Dh + Dh + 1))
    out = {"bytes": nbytes / PEAK_BYTES * 1e3,
           "ops": (tc + cc) / PEAK_BF16_FLOPS * 1e3,
           "split": (MLSTM_PIECES * tc / PEAK_BF16_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3,
           "fp32": (tc + cc) / PEAK_FP32_FLOPS * 1e3}
    out["bound"] = max(out["bytes"], out["ops"])
    return out


def phase_mlstm_kernel() -> dict:
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for B, H, S, Dh, chunk, carry, kind in MLSTM_CASES:
        args = mlstm_inputs(gen, B, H, S, Dh, kind)
        state = None
        if carry:
            _, state = mlstm_chunk(*mlstm_inputs(gen, B, H, 48, Dh, kind), chunk=chunk,
                                   impl="plain")
        h, st = mlstm_chunk(*args, chunk=chunk, state=state)
        hp, stp = mlstm_chunk(*args, chunk=chunk, state=state, impl="plain")
        torch.cuda.synchronize()
        errs = {"h": mlstm_err(h, hp), **{key: mlstm_err(st[key], stp[key])
                                          for key in ("C", "n", "m")}}
        say(f"[mlstm kernel] B={B} H={H} S={S} Dh={Dh} chunk={chunk} carried={carry} "
            f"inputs={kind or 'random'}: "
            + ", ".join(f"{key} max_abs_err={e[0]:.3e} (scaled {e[1]:.3f})"
                        for key, e in errs.items())
            + f" (tol {MLSTM_TOL} abs + rel: scaled <= 1)")
        if not all(e[1] <= 1 for e in errs.values()):
            raise AssertionError(f"mlstm kernel disagrees with its plain version: {errs}")
    del args, h, st, hp, stp, state

    B, H, S, Dh, chunk = MLSTM_SHAPE
    args = mlstm_inputs(gen, B, H, S, Dh)
    h, st = mlstm_chunk(*args, chunk=chunk)
    h2, st2 = mlstm_chunk(*args, chunk=chunk)
    hp, stp = mlstm_chunk(*args, chunk=chunk, impl="plain")
    err, scaled = mlstm_err(h, hp)
    if not scaled <= 1:
        raise AssertionError(f"mlstm kernel disagrees at the prefill shape: {err}")
    if not (torch.equal(h, h2) and all(torch.equal(st[x], st2[x]) for x in "Cnm")):
        raise AssertionError("two calls of the mlstm kernel on the same inputs differ")
    del h, st, h2, st2, hp, stp
    ms, per = mlstm_kernel_ms(args, chunk)
    plain_ms = cuda_ms(lambda: mlstm_chunk(*args, chunk=chunk, impl="plain"),
                       iters=3, warmup=1)
    bd = mlstm_bounds(B, H, S, Dh, chunk)
    flops = (6 * chunk ** 2 * Dh + 4 * chunk * Dh ** 2) * (S // chunk) * B * H
    split = ", ".join(f"{name} {t:.4f}" for name, t in per.items()) or "not measured"
    say(f"[mlstm kernel] prefill shape B={B} H={H} S={S} Dh={Dh} chunk={chunk} fp32: "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the reference's operations; "
        f"per kernel, ms: {split}), plain {plain_ms:.4f} ms, bound {bd['bound']:.4f} ms "
        f"(bytes {bd['bytes']:.4f}; operations once at bf16 989 TFLOP/s {bd['ops']:.4f}); "
        f"design figures: the kernel's split products ({MLSTM_PIECES} bf16 products of "
        f"each tensor-core product at 989 TFLOP/s and Q K^T, W K at fp32 67 TFLOP/s) "
        f"{bd['split']:.4f} ms, the operations at fp32 67 TFLOP/s {bd['fp32']:.4f} ms; no "
        f"single PyTorch call computes it; max_abs_err {err:.3e}; two calls equal bit for "
        f"bit")
    del args
    B, H, S, Dh, chunk = MLSTM_SERVED
    args = mlstm_inputs(gen, B, H, S, Dh)
    served_ms, per = mlstm_kernel_ms(args, chunk)
    bs = mlstm_bounds(B, H, S, Dh, chunk)
    split = ", ".join(f"{name} {t:.4f}" for name, t in per.items()) or "not measured"
    say(f"[mlstm kernel] served shape B={B} H={H} S={S} Dh={Dh} chunk={chunk}: kernel "
        f"{served_ms:.4f} ms a call (per kernel, ms: {split}); bound {bs['bound']:.4f} ms "
        f"(bytes {bs['bytes']:.4f}, operations at bf16 {bs['ops']:.4f}; split products "
        f"{bs['split']:.4f}, fp32 {bs['fp32']:.4f})")
    del args
    torch.cuda.empty_cache()
    return {"name": "mlstm_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
            "replaces": "src/repro/kernels/mlstm_chunk.py:22",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bd["bound"],
            "bound_by": "operations" if bd["ops"] >= bd["bytes"] else "bytes",
            "library_ms": None}


@contextmanager
def mlstm_calls(fn):
    """Route the model's mLSTM scans (``xlstm.mlstm_sequence``) through
    ``fn(scan, *args)``, where ``scan`` is the real one."""
    from repro_torch.models import xlstm
    scan = xlstm.mlstm_sequence
    xlstm.mlstm_sequence = lambda *args: fn(scan, *args)
    try:
        yield
    finally:
        xlstm.mlstm_sequence = scan


@torch.no_grad()
def check_xlstm_prefill(cfg, model, tag: str, n_mlstm: int) -> None:
    """One full-depth forward through the kernel, each mLSTM layer's kernel
    call held against the plain version on the same inputs (h and state);
    then the logits against a forward through the plain version, judged
    against the floor between two plain forwards of chunk 64 and 32."""
    from repro_torch import forward
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    tokens = prefill_tokens(cfg, XLSTM_PROMPT)
    worst, h_err = {}, []

    def held(scan, q, k, v, li, lf, state, chunk, impl):
        h, st = scan(q, k, v, li, lf, state, chunk, impl)
        hp, stp = scan(q, k, v, li, lf, state, chunk, "plain")
        h64, _ = scan(q.double(), k.double(), v.double(), li.double(), lf.double(),
                      state, chunk, "plain")
        for key, (a, b) in {"h": (h, hp), **{x: (st[x], stp[x]) for x in "Cnm"}}.items():
            err = mlstm_err(a, b)
            worst[key] = max(worst.get(key, (0.0, 0.0)), err, key=lambda e: e[1])
        rel = lambda x: ((x.double() - h64).norm() / h64.norm()).item()  # noqa: E731
        h_err.append((rel(h), rel(hp)))
        return h, st

    before = mlstm_chunk.launches
    with mlstm_calls(held):
        logits, _, _, _ = forward(cfg, model, {"tokens": tokens})
    if mlstm_chunk.launches - before != n_mlstm:
        raise AssertionError(f"the prefill launched the kernel "
                             f"{mlstm_chunk.launches - before} times, want {n_mlstm}")
    k_med, p_med = (statistics.median(e[i] for e in h_err) for i in (0, 1))
    k_worst, p_worst = (max(e[i] for e in h_err) for i in (0, 1))
    say(f"[xlstm prefill] {tag}: {n_mlstm} mLSTM layers, kernel vs plain on each "
        f"layer's inputs: " + ", ".join(f"{key} max_abs_err={e[0]:.3e} (scaled {e[1]:.3f})"
                                         for key, e in worst.items())
        + f" (tol {MLSTM_TOL} abs + rel: scaled <= 1); h against fp64, relative RMS: "
        f"median layer kernel {k_med:.3e}, plain {p_med:.3e} (tol {XLSTM_FLOOR_FACTOR}x); "
        f"worst layer kernel {k_worst:.3e}, plain {p_worst:.3e} (tol {XLSTM_TAIL_FACTOR}x)")
    # h where |q . n| nears 0 is ill-conditioned: there no two fp32 orders of
    # the sums agree elementwise, and a layer's error swings with where the
    # rounding falls. So h is held against fp64 in RMS: a fault of the kernel
    # moves every layer, and the median layer is held to XLSTM_FLOOR_FACTOR
    # times the plain version's; the worst layer, one draw of that swing, to
    # XLSTM_TAIL_FACTOR times the plain version's worst
    ok_h = worst["h"][1] <= 1 or (k_med <= XLSTM_FLOOR_FACTOR * p_med
                                  and k_worst <= XLSTM_TAIL_FACTOR * p_worst)
    if not (ok_h and all(worst[x][1] <= 1 for x in "Cnm")):
        raise AssertionError(f"{tag}: a layer's kernel call disagrees: {worst}, {h_err}")
    plain, _, _, _ = forward(cfg, model, {"tokens": tokens}, mlstm_impl="plain")
    with mlstm_calls(lambda scan, *args: scan(*args[:6], 32, "plain")):
        plain32, _, _, _ = forward(cfg, model, {"tokens": tokens})
    if logits.shape != (*tokens.shape, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    d, floor = logit_diff(logits, plain), logit_diff(plain32, plain)
    say(f"[xlstm prefill] {tag} B={tokens.shape[0]} S={tokens.shape[1]}: logits "
        f"{tuple(logits.shape)} finite; kernel vs plain max_abs {d['max_abs']:.3e}, "
        f"rel_rms {d['rel_rms']:.3e}, argmax agree {d['argmax_agree']:.4f}; plain chunk 32 "
        f"vs 64 (floor) max_abs {floor['max_abs']:.3e}, rel_rms {floor['rel_rms']:.3e}, "
        f"argmax agree {floor['argmax_agree']:.4f} (tol {XLSTM_FLOOR_FACTOR}x floor)")
    tol = PREFILL_TOL[logits.dtype]
    for key in ("max_abs", "rel_rms"):
        if not d[key] <= max(XLSTM_FLOOR_FACTOR * floor[key], tol[key]):
            raise AssertionError(f"{tag} prefill logits disagree beyond the floor: "
                                 f"{d} against {floor}")


def phase_xlstm() -> int:
    """xlstm-1.3b at full width and depth: prefill checked and timed in bf16
    and checked in fp32, then one batch served in bf16. Returns the served
    batch's kernel launches."""
    from repro_torch import get_config, init_params
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.models.lm import layer_kinds
    cfg = get_config("xlstm-1.3b")
    n_mlstm = layer_kinds(cfg).count("mlstm")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[xlstm prefill] xlstm-1.3b: {cfg.n_layers} layers ({n_mlstm} mLSTM), "
        f"{n_params / 1e9:.3f} B parameters made in {time.perf_counter() - t0:.1f} s")
    check_xlstm_prefill(cfg, model, "xlstm-1.3b bf16", n_mlstm)
    time_prefill_and_decode(cfg, model, "xlstm prefill", prefill_tokens(cfg, XLSTM_PROMPT))
    say(f"[xlstm prefill] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cfg32 = cfg.with_(dtype="float32")
    model32 = init_params(cfg32, seed=0)
    check_xlstm_prefill(cfg32, model32, "xlstm-1.3b fp32", n_mlstm)
    del model32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, _ = phase_serve(cfg, model, mlstm_chunk, n_mlstm, XLSTM_SERVE_PROMPTS,
                              "xlstm serve")
    say(f"[xlstm serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def backward_bounds(B, H, KH, S, Dh) -> tuple:
    """(operations, bytes) bounds in ms of the causal backward: five products
    of 2 S^2 Dh a head, halved by the mask, against q o do dq, k v dk dv in
    bf16 and lse."""
    flops = 5 * B * H * S * S * Dh
    nbytes = 2 * 4 * (B * H + B * KH) * S * Dh + 4 * B * H * S
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def sdpa_backward_ms(q, k, v, do, iters: int) -> float:
    """SDPA's backward (``enable_gqa``) through ``torch.autograd.grad``."""
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True),
                   iters=iters)


def backward_passes(fn, calls: int = 3) -> dict:
    """Mean device ms of each pass (delta, dkdv, dq) of the backward kernel
    over ``calls`` calls of ``fn`` under torch.profiler; empty where the
    profiler sees no device time."""
    sums = {}
    for name, t in device_kernels(lambda: [fn() for _ in range(calls)]):
        if "flash_bwd_" in name:
            key = name.split("flash_bwd_")[1].split("<")[0].removesuffix("_bf16")
            n, total = sums.get(key, (0, 0.0))
            sums[key] = (n + 1, total + t)
    return {key: total / n for key, (n, total) in sums.items()}


def check_backward() -> dict:
    """(a): the backward kernel against autograd through the plain version on
    every case, repeatable bit for bit; then timed at the training shape, as
    a whole and pass by pass, and at smollm-135m's shape."""
    from repro_torch.kernels.flash_attention import (BWD_TOL, _forward_kernel,
                                                     backward_errors, flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_backward_plain)
    worst = lambda got, ref: max(backward_errors(got, ref), key=lambda e: e[1])  # noqa: E731
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    n = 0
    for B, H, KH, Sq, Sk, Dh, causal, q_offset in KERNEL_CASES + EDGE_CASES + RESUME_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, Sq, Dh), dtype)
            k, v = randn(gen, (B, KH, Sk, Dh), dtype), randn(gen, (B, KH, Sk, Dh), dtype)
            do = randn(gen, (B, H, Sq, Dh), dtype)
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(flash_attention(*qkv, causal=causal, q_offset=q_offset),
                                      qkv, do)
            again = torch.autograd.grad(
                flash_attention(*qkv, causal=causal, q_offset=q_offset), qkv, do)
            ref = flash_attention_backward_plain(q, k, v, do, causal=causal, q_offset=q_offset)
            torch.cuda.synchronize()
            err, scaled = worst(got, ref)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            say(f"[train] backward B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} Dh={Dh} "
                f"causal={causal} q_offset={q_offset} {str(dtype)[6:]}: "
                f"{'max_abs/max' if dtype == torch.float32 else 'rel_rms'} {err:.3e} "
                f"(tol {BWD_TOL[dtype]}); second call equal: {same}")
            if not (scaled <= 1 and same):
                raise AssertionError(f"backward kernel disagrees or repeats unequally: {err}")
            n += 1
    del q, k, v, do, qkv, got, again, ref

    B, H, KH, S, Dh = TRAIN_SHAPE
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    do = randn(gen, (B, H, S, Dh), torch.bfloat16)
    o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
    got = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    again = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    ref = flash_attention_backward_plain(q, k, v, do, causal=True)
    err, scaled = worst(got, ref)
    max_abs = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    if not (scaled <= 1 and all(torch.equal(a, b) for a, b in zip(got, again))):
        raise AssertionError(f"backward kernel disagrees at the training shape: {err}")
    del got, again, ref
    ms = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True), iters=10)
    plain_ms = cuda_ms(lambda: flash_attention_backward_plain(q, k, v, do, causal=True),
                       iters=3, warmup=1)
    library_ms = sdpa_backward_ms(q, k, v, do, iters=10)
    t_ops, t_bytes = backward_bounds(B, H, KH, S, Dh)
    flops = t_ops * PEAK_BF16_FLOPS / 1e3
    design = t_ops * sum(BWD_PASSES.values()) / 5
    say(f"[train] backward held on {n} cases; training shape B={B} H={H} KH={KH} S={S} "
        f"Dh={Dh} bf16 causal: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, "
        f"bound {max(t_ops, t_bytes):.4f} ms (ops {t_ops:.4f}, bytes {t_bytes:.4f}), "
        f"two-pass design bound {design:.4f} ms (seven products); kernel/sdpa "
        f"{ms / library_ms:.3f}; rel_rms {err:.3e}, max_abs_err {max_abs:.3e}; two calls "
        f"equal bit for bit")
    passes = backward_passes(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True))
    delta_bound = (4 * B * H * S * Dh + 4 * B * H * S) / PEAK_BYTES * 1e3   # o, do; delta
    shares = {key: t_ops * n_products / 5 for key, n_products in BWD_PASSES.items()}
    say("[train] backward by pass at the training shape (torch.profiler, mean of 3 calls): "
        + ("device time not measured" if not passes else
           f"delta {passes.get('delta', float('nan')):.4f} ms (bytes bound {delta_bound:.4f}), "
           + ", ".join(f"{key} {passes.get(key, float('nan')):.4f} ms (its {n}/5 of the "
                       f"bound {shares[key]:.4f}, {shares[key] / passes.get(key, float('nan')):.3f} "
                       f"of it)" for key, n in BWD_PASSES.items())
           + f"; sum {sum(passes.values()):.4f} ms"))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    B, H, KH, S, Dh = SMOLLM_SHAPE
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    do = randn(gen, (B, H, S, Dh), torch.bfloat16)
    o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
    s_ms = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True), iters=50)
    s_lib = sdpa_backward_ms(q, k, v, do, iters=50)
    s_ops, s_bytes = backward_bounds(B, H, KH, S, Dh)
    s_passes = backward_passes(lambda: flash_attention_backward(q, k, v, o, do, lse,
                                                                causal=True))
    say(f"[train] backward at smollm-135m's shape B={B} H={H} KH={KH} S={S} Dh={Dh} bf16 "
        f"causal: kernel {s_ms:.4f} ms, sdpa backward {s_lib:.4f} ms, kernel/sdpa "
        f"{s_ms / s_lib:.3f}, bound {max(s_ops, s_bytes):.4f} ms (ops {s_ops:.4f}, bytes "
        f"{s_bytes:.4f}); by pass "
        + (", ".join(f"{key} {t:.4f}" for key, t in s_passes.items()) or "not measured"))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return {"name": "flash_attention_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:70",
            "launches": None, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def counted_run(**kw) -> tuple:
    """One ``launch.train.run`` as a main path: every kernel's count is set
    to 0 just before it and read just after. Per attention layer, and per
    mLSTM layer, each microbatch launches its forward kernel once (twice under
    remat full, which recomputes it in the backward) and its backward kernel
    once; the other kernel family not at all. Returns run's result and the
    counts ((flash forward, backward), (mLSTM forward, backward))."""
    from repro_torch import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.launch.train import run
    from repro_torch.models.lm import layer_kinds
    cfg = get_config(kw["config"]).with_(n_layers=kw["n_layers"])
    kinds = layer_kinds(cfg)
    flash_attention.launches = flash_attention.backward_launches = 0   # main path starts
    mlstm_chunk.launches = mlstm_chunk.backward_launches = 0
    out = run(**kw)
    torch.cuda.synchronize()
    got = ((flash_attention.launches, flash_attention.backward_launches),  # ... and ends
           (mlstm_chunk.launches, mlstm_chunk.backward_launches))
    calls = kw.get("accum", 1) * len(out[0])
    remat = {"none": 1, "full": 2}[cfg.remat]
    want = tuple((remat * n * calls, n * calls)
                 for n in (kinds.count("attn+mlp"), kinds.count("mlstm")))
    say(f"[train] {cfg.name} {cfg.n_layers} layers, {len(out[0])} steps: flash forward "
        f"launches {got[0][0]} (want {want[0][0]}), backward {got[0][1]} (want "
        f"{want[0][1]}); mLSTM forward {got[1][0]} (want {want[1][0]}), backward "
        f"{got[1][1]} (want {want[1][1]})")
    if got != want:
        raise AssertionError(f"{cfg.name}: kernels launched {got} times, want {want}")
    return out, got[0], got[1]


def train_qwen() -> tuple:
    """(b): the launcher trains qwen3-8b at full width with 8 layers, the
    kernels' launches counted; then one more step of the same shape timed
    and profiled for the device's busy and idle shares."""
    from repro_torch import get_config
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = get_config(TRAIN_RUN["config"]).with_(n_layers=TRAIN_RUN["n_layers"])
    run_kw = dict(TRAIN_RUN)
    steps, accum = run_kw["steps"], run_kw["accum"]
    torch.cuda.reset_peak_memory_stats()
    (losses, model, _, seconds), (fwd, bwd), _ = counted_run(
        **run_kw, ckpt_every=10 ** 9, log_every=1, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ln_v = math.log(cfg.vocab_size)
    say(f"[train] qwen3-8b {cfg.n_layers} of 36 layers, batch {run_kw['batch']} x "
        f"{run_kw['seq']} in {accum} microbatches, remat {cfg.remat}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (ln V = {ln_v:.4f})")
    # that the path runs: finite losses, the first near ln V. That it trains
    # right is 9c's check and the CPU tests' (the step against the reference)
    if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) <= 1.0):
        raise AssertionError(f"training losses off: {losses}")
    tokens = run_kw["batch"] * run_kw["seq"]
    step_s = statistics.median(seconds[1:])
    # one more step of the same shape (fresh AdamW state, random tokens, no
    # data pipeline), not on the counted path: its wall time, unprofiled, and
    # the device's busy time in a profiled repeat of it
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = adamw_init(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, accum=accum)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (run_kw["batch"], run_kw["seq"] + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fn():
        float(step_fn(model, state, batch)[2]["loss"])     # the loss read back, as run's

    fn()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    kernels = device_kernels(fn)
    busy = sum(t for _, t in kernels) / 1e3
    fwd_s = sum(t for name, t in kernels if "flash_fwd" in name) / 1e3
    bwd_s = sum(t for name, t in kernels if "flash_bwd" in name) / 1e3
    gemm = sum(t for name, t in kernels if "gemm" in name.lower() or "nvjet" in name) / 1e3
    share = "device time not measured" if not kernels else (
        f"one more step of the shape: {wall:.3f} s unprofiled, device busy {busy:.3f} s in "
        f"{len(kernels)} kernels in a profiled repeat, idle share {1 - busy / wall:.3f} of "
        f"that step; of busy: flash forward {fwd_s / busy:.4f} ({fwd_s:.3f} s), flash "
        f"backward {bwd_s / busy:.4f} ({bwd_s:.3f} s), matrix products {gemm / busy:.4f}")
    say(f"[train] qwen3-8b step times " + ", ".join(f"{t:.3f}" for t in seconds)
        + f" s; median after the first {step_s:.3f} s, {tokens / step_s:.0f} tokens/s; "
        f"peak memory {peak:.2f} GiB; {share}")
    per = {}
    for name, t in kernels:
        per[short_name(name)] = per.get(short_name(name), 0.0) + t
    top = sorted(per.items(), key=lambda x: -x[1])[:10]
    calls = cfg.n_layers * accum
    say(f"[train] profiled step, device ms by kernel (top 10): "
        + "; ".join(f"{name[:60]} {t:.1f}" for name, t in top)
        + "; flash backward per call by pass, ms: "
        + ", ".join(f"{name} {t / calls:.4f}" for name, t in per.items() if "flash_bwd" in name))
    del model, state, step_fn
    torch.cuda.empty_cache()
    return fwd, bwd


def one_step(cfg, impl, eps: float, batch) -> tuple:
    """One AdamW step from the seeded parameters: (loss, grad norm, model);
    ``impl`` for attention and the mLSTM scan alike."""
    from repro_torch import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    opt_cfg = AdamWConfig(lr=STEP_LR, weight_decay=0.01, eps=eps)
    model = init_params(cfg, seed=5, trainable=True)
    step = make_train_step(cfg, opt_cfg, accum=1, grad_dtype=cfg.dtype, attn_impl=impl,
                           mlstm_impl=impl)
    _, state, m = step(model, adamw_init(model, opt_cfg), batch)
    del state, step
    torch.cuda.empty_cache()
    return float(m["loss"]), float(m["grad_norm"]), model


def step_kernel_vs_plain() -> None:
    """(c): one step at full width with 2 layers, S = 1024, through the
    kernels and through the plain version, from the same parameters and
    batch: every gradient, then the loss, grad norm and every updated
    parameter compared; in fp32 also at the optimizer's own eps, where the
    parameters that differ must be those of near-zero gradients."""
    from repro_torch import get_config, init_params, loss_fn
    from repro_torch.train import AdamWConfig
    from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("qwen3-8b").with_(n_layers=2, dtype=dtype)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        toks = torch.randint(0, cfg.vocab_size, (2, 1025), generator=gen, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        grads = {}
        for impl in (None, "plain"):
            model = init_params(cfg, seed=5, trainable=True)
            loss, _ = loss_fn(cfg, model, batch, attn_impl=impl)
            grads[impl] = torch.autograd.grad(loss, list(model.parameters()))
            del model, loss
        size = (lambda t: t.abs().max()) if dtype == "float32" else torch.linalg.norm
        g_err = max((size(a.float() - b.float()) / size(b.float()).clamp_min(1e-30)).item()
                    for a, b in zip(grads[None], grads["plain"]))
        plain_grads = grads["plain"]
        del grads
        torch.cuda.empty_cache()
        if not g_err <= STEP_GRAD_TOL[dtype]:
            raise AssertionError(f"{dtype} gradients, kernels against plain: {g_err}")
        (lk, gk, mk), (lp, gp, mp) = (one_step(cfg, impl, STEP_EPS, batch)
                                      for impl in (None, "plain"))
        old = init_params(cfg, seed=5)
        d2 = w2 = 0.0
        worst_abs, worst_agree = 0.0, 1.0
        for (name, pk), (_, pp), (_, po) in zip(mk.named_parameters(), mp.named_parameters(),
                                                old.named_parameters()):
            pk, pp, po = pk.detach().float(), pp.detach().float(), po.float()
            if dtype == "float32":
                bad = (pk - pp).abs() > STEP_TOL + STEP_TOL * pp.abs()
                worst_abs = max(worst_abs, (pk - pp).abs().max().item())
                if bad.any():
                    raise AssertionError(f"fp32 step: {name} differs by {worst_abs}")
            else:
                agree = ((pk - po) - (pp - po)).abs().le(STEP_LR / 2).float().mean().item()
                worst_agree = min(worst_agree, agree)
                d2 += (pk - pp).square().sum().item()
                w2 += pp.square().sum().item()
        del mk, mp, old
        torch.cuda.empty_cache()
        if dtype == "float32":
            ok = (abs(lk - lp) <= STEP_TOL * abs(lp) and abs(gk - gp) <= STEP_TOL * abs(gp))
            detail = f"params max abs diff {worst_abs:.3e} (tol {STEP_TOL} abs + rel)"
            eps = AdamWConfig().eps
            (_, _, mk), (_, gp8, mp) = (one_step(cfg, impl, eps, batch)
                                        for impl in (None, "plain"))
            clip = min(1.0, AdamWConfig().clip_norm / gp8)   # the update sees g * clip
            n_bad = n_all = 0
            worst_g = 0.0
            for (_, pk), (_, pp), g in zip(mk.named_parameters(), mp.named_parameters(),
                                           plain_grads):
                pk, pp = pk.detach(), pp.detach()
                bad = (pk - pp).abs() > STEP_TOL + STEP_TOL * pp.abs()
                n_bad += int(bad.sum())
                n_all += bad.numel()
                if bad.any():
                    worst_g = max(worst_g, (g[bad].abs().max() * clip / eps).item())
            del mk, mp
            torch.cuda.empty_cache()
            detail += (f"; at eps {eps:g}: {n_bad} of {n_all} params differ beyond the "
                       f"tolerance, their clipped |g| at most {worst_g:.3f} eps (tol "
                       f"{NEAR_ZERO_GRAD} eps)")
            ok = ok and worst_g <= NEAR_ZERO_GRAD
        else:
            tol = BF16_STEP_TOL
            rel = (d2 / w2) ** 0.5
            ok = (abs(lk - lp) <= tol["loss"] and abs(gk - gp) <= tol["grad_norm"] * abs(gp)
                  and worst_agree >= tol["update_agree"] and rel <= tol["params_rel_rms"])
            detail = (f"updates within lr/2 on >= {worst_agree:.4f} of each tensor, params "
                      f"rel_rms {rel:.3e} (tol {tol})")
        del plain_grads
        torch.cuda.empty_cache()
        say(f"[train] step kernels vs plain, qwen3-8b 2 layers S=1024 {dtype}: gradients "
            f"{'max |diff| / max |g|' if dtype == 'float32' else 'rel_rms'} {g_err:.3e} at "
            f"the worst tensor (tol {STEP_GRAD_TOL[dtype]}); "
            f"loss {lk:.6f} / {lp:.6f}, grad norm {gk:.6f} / {gp:.6f}; {detail}")
        if not ok:
            raise AssertionError(f"{dtype} train step: kernels against plain differ")


def resume_exactly() -> tuple:
    """(d): smollm-135m at full size, 2k steps straight against k steps,
    a checkpoint to the log, and a fresh resumed run on the same system:
    the losses after k equal bit for bit. Each of the three runs is a main
    path with its launches counted; returns their sums (forward, backward)."""
    from repro_torch.core import BoltSystem
    from repro_torch.train import CheckpointManager
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(RESUME_RUN, log_every=1, device="cuda")
        t0 = time.perf_counter()
        (straight, model, _, _), (f0, b0), _ = counted_run(
            steps=2 * RESUME_K, system=BoltSystem(n_brokers=2), ckpt_every=10 ** 9, **kw)
        del model
        t1 = time.perf_counter()
        system = BoltSystem(n_brokers=2)
        (first, model, _, _), (f1, b1), _ = counted_run(
            steps=RESUME_K, system=system, ckpt_every=RESUME_K, **kw)
        del model                                    # the trainer is dropped
        t2 = time.perf_counter()
        (resumed, model, _, _), (f2, b2), _ = counted_run(
            steps=2 * RESUME_K, system=system, ckpt_every=10 ** 9, resume=True, **kw)
        t3 = time.perf_counter()
        del model
    finally:
        torch.use_deterministic_algorithms(False)
    steps = CheckpointManager(system).steps()
    say(f"[train] resume smollm-135m (30 layers, G=3, Dh=64), batch {RESUME_RUN['batch']} x "
        f"{RESUME_RUN['seq']}: straight " + ", ".join(f"{x:.6f}" for x in straight)
        + "; resumed after step " + f"{RESUME_K} " + ", ".join(f"{x:.6f}" for x in resumed)
        + f"; checkpoints {steps}; {t1 - t0:.1f} s straight, {t2 - t1:.1f} s to the "
        f"checkpoint, {t3 - t2:.1f} s resumed")
    if first != straight[:RESUME_K] or resumed != straight[RESUME_K:] or steps != [RESUME_K]:
        raise AssertionError(f"the resumed losses differ: {straight} against {first} + "
                             f"{resumed}")
    torch.cuda.empty_cache()
    return f0 + f1 + f2, b0 + b1 + b2


def phase_train() -> tuple:
    """Phase 9: returns the backward kernel's entry and the forward's and the
    backward's launches on each training path."""
    bwd = check_backward()
    qwen = train_qwen()
    step_kernel_vs_plain()
    smollm = resume_exactly()
    paths = {"train qwen3-8b": qwen, "train smollm-135m": smollm}
    return (bwd, {path: n[0] for path, n in paths.items()},
            {path: n[1] for path, n in paths.items()})


def mlstm_backward_bounds(B, H, S, Dh, chunk) -> dict:
    """Least times (ms) of the mLSTM backward on an H100 SXM: its operations,
    twice the forward's (each product's gradient is two products of its
    size: 2 (4 L Dh^2 + 6 L^2 Dh) a chunk), once each at the bf16 rate,
    against its bytes (q, k, v, dh, li, lf read, dq, dk, dv, dli, dlf written,
    fp32); the bound is the larger. Beside it, the operations at the fp32
    rate (no tensor cores), and the kernel's design floor: its three walks'
    products (a state term and an update of 2 L Dh^2 operations each, a
    chunk and head) MLSTM_PIECES times at the bf16 rate, and its scratch
    bytes (the chunk-start states in fp32, written and read; the walks'
    partial sums over their column blocks of 256; the five operands' bf16
    pieces, written and read once) at the memory rate."""
    n = (S // chunk) * B * H
    flops = 2 * (4 * chunk * Dh ** 2 + 6 * chunk ** 2 * Dh) * n
    nbytes = 4 * (7 * B * H * S * Dh + 4 * B * H * S)
    nc, ds, dp = -(-S // chunk), -(-Dh // 256), -(-Dh // 64) * 64
    scratch = (2 * 4 * Dh * Dh * nc * B * H + 2 * 3 * 4 * ds * B * H * S * Dh
               + 2 * 5 * 3 * 2 * B * H * S * dp)
    out = {"ops": flops / PEAK_BF16_FLOPS * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
           "fp32": flops / PEAK_FP32_FLOPS * 1e3, "flops": flops,
           "split": MLSTM_PIECES * 3 * 4 * chunk * Dh ** 2 * n / PEAK_BF16_FLOPS * 1e3,
           "scratch": scratch / PEAK_BYTES * 1e3, "scratch_bytes": scratch}
    out["bound"] = max(out["ops"], out["bytes"])
    return out


def function_grads(args, state, dh, dstate, chunk: int) -> tuple:
    """The gradients through ``mlstm_chunk`` under grad (MLSTMChunkFunction
    on the card: the forward kernel, then the backward kernel), in the
    order of ``GRAD_NAMES``; the final state's gradient comes in where
    ``dstate`` is given, else only h's."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    ins = [t.clone().requires_grad_() for t in args]
    st = None if state is None else {key: t.clone().requires_grad_()
                                     for key, t in state.items()}
    h, out = mlstm_chunk(*ins, chunk=chunk, state=st)
    outs, grads = [h], [dh]
    if dstate is not None:
        outs += [out[key] for key in "Cnm"]
        grads += list(dstate)
    wrt = ins + ([] if st is None else [st[key] for key in "Cnm"])
    got = torch.autograd.grad(outs, wrt, grads)
    return tuple(got) + ((None,) * 3 if st is None else ())


def check_mlstm_backward() -> dict:
    """(a): the backward kernel, through MLSTMChunkFunction, against autograd
    of the plain version on every case, a second call equal bit for bit;
    then timed at xlstm-1.3b's training shape, pass by pass."""
    from repro_torch.kernels.mlstm_chunk import (BWD_FLOOR_FACTOR, BWD_TOL, backward_errors,
                                                 mlstm_chunk, mlstm_chunk_backward,
                                                 mlstm_chunk_backward_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    for B, H, S, Dh, chunk, carry, kind in MLSTM_BWD_CASES:
        args = mlstm_inputs(gen, B, H, S, Dh, kind)
        state = dstate = None
        if carry:
            _, state = mlstm_chunk(*mlstm_inputs(gen, B, H, 48, Dh, kind), chunk=chunk,
                                   impl="plain")
            dstate = (randn(gen, (B, H, Dh, Dh), torch.float32),
                      randn(gen, (B, H, Dh), torch.float32), randn(gen, (B, H), torch.float32))
        dh = randn(gen, (B, H, S, Dh), torch.float32)
        before = mlstm_chunk.backward_launches
        got = function_grads(args, state, dh, dstate, chunk)
        again = function_grads(args, state, dh, dstate, chunk)
        torch.cuda.synchronize()
        launched = mlstm_chunk.backward_launches - before
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        ds = dict(zip(("dC", "dn", "dm"), dstate or (None,) * 3))
        ref = mlstm_chunk_backward_plain(*args, dh, chunk=chunk, state=state, **ds)
        if kind == "cancel":
            # h's denominator nears 0: held against fp64, beside fp32 plain's error
            f64 = lambda t: None if t is None else t.double()  # noqa: E731
            ref64 = mlstm_chunk_backward_plain(
                *map(f64, args), f64(dh), chunk=chunk,
                state=None if state is None else {key: f64(t) for key, t in state.items()},
                **{key: f64(t) for key, t in ds.items()})
            errs, floor = backward_errors(got, ref64), backward_errors(ref, ref64)
            limit = {key: max(BWD_TOL, BWD_FLOOR_FACTOR * floor[key]) for key in errs}
            detail = ", ".join(f"{key} {e:.2e} (plain fp32 {floor[key]:.2e})"
                               for key, e in errs.items())
            against = (f"fp64 plain autograd (tol max({BWD_TOL}, {BWD_FLOOR_FACTOR}x plain "
                       f"fp32's))")
        else:
            errs = backward_errors(got, ref)
            limit = {key: BWD_TOL for key in errs}
            detail = ", ".join(f"{key} {e:.2e}" for key, e in errs.items())
            against = f"fp32 plain autograd (tol {BWD_TOL})"
        say(f"[train xlstm] backward B={B} H={H} S={S} Dh={Dh} chunk={chunk} carried={carry} "
            f"inputs={kind or 'random'}: max |diff| / max |g| against {against}: {detail}; "
            f"kernel launched {launched}x in 2 calls, second call equal: {same}")
        if not (launched == 2 and same and all(errs[key] <= limit[key] for key in errs)):
            raise AssertionError(f"mlstm backward kernel disagrees or repeats unequally: {errs}")
    del args, state, dstate, dh, got, again, ref

    B, H, S, Dh, chunk = MLSTM_TRAIN_SHAPE
    args = mlstm_inputs(gen, B, H, S, Dh)
    dh = randn(gen, (B, H, S, Dh), torch.float32)
    h, _ = mlstm_chunk(*args, chunk=chunk)
    got = mlstm_chunk_backward(*args, h, dh, chunk=chunk)
    again = mlstm_chunk_backward(*args, h, dh, chunk=chunk)
    ref = mlstm_chunk_backward_plain(*args, dh, chunk=chunk)
    errs = backward_errors(got, ref)
    max_abs = max((a - b).abs().max().item() for a, b in zip(got[:5], ref[:5]))
    if not (all(e <= BWD_TOL for e in errs.values())
            and all(torch.equal(a, b) for a, b in zip(got[:5], again[:5]))):
        raise AssertionError(f"mlstm backward kernel disagrees at the training shape: {errs}")
    del got, again, ref
    fn = lambda: mlstm_chunk_backward(*args, h, dh, chunk=chunk)  # noqa: E731
    ms = cuda_ms(fn, iters=5)
    plain_ms = cuda_ms(lambda: mlstm_chunk_backward_plain(*args, dh, chunk=chunk),
                       iters=2, warmup=1)
    fwd_ms = cuda_ms(lambda: mlstm_chunk(*args, chunk=chunk), iters=5)
    per = {}                  # each __global__'s ms a call, over 3 profiled calls
    for name, t in device_kernels(lambda: [fn() for _ in range(3)]):
        per[short_name(name)] = per.get(short_name(name), 0.0) + t / 3
    bd = mlstm_backward_bounds(B, H, S, Dh, chunk)
    split = ", ".join(f"{name} {t:.4f}" for name, t in per.items())
    say(f"[train xlstm] backward held on {len(MLSTM_BWD_CASES)} cases; training shape B={B} "
        f"H={H} S={S} Dh={Dh} chunk={chunk} fp32: kernel {ms:.4f} ms "
        f"({bd['flops'] / ms / 1e9:.1f} TFLOP/s of the function's operations; per kernel, "
        f"ms a call, torch.profiler, mean of 3 calls: {split or 'not measured'}); design "
        f"floor: the walks' split products at bf16 989 TFLOP/s {bd['split']:.4f} ms, their "
        f"scratch {bd['scratch_bytes'] / 1e9:.3f} GB at 3.35 TB/s {bd['scratch']:.4f} ms; "
        f"plain (autograd "
        f"of the plain version, its forward included) "
        f"{plain_ms:.4f} ms, bound {bd['bound']:.4f} ms (operations at bf16 989 TFLOP/s "
        f"{bd['ops']:.4f}, bytes {bd['bytes']:.4f}); the operations at fp32 67 TFLOP/s "
        f"{bd['fp32']:.4f} ms; the forward kernel {fwd_ms:.4f} ms; no single PyTorch call "
        f"computes it; " + ", ".join(f"{key} {e:.2e}" for key, e in errs.items())
        + f" of max |g|, max_abs_err {max_abs:.3e}; two calls equal bit for bit")
    del args, dh, h
    torch.cuda.empty_cache()
    return {"name": "mlstm_chunk_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
            "replaces": "src/repro/models/xlstm.py:59",
            "launches": None, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bd["bound"],
            "bound_by": "operations" if bd["ops"] >= bd["bytes"] else "bytes",
            "library_ms": None}


def slstm_layer_ms(cfg, blk, batch: int, seq: int) -> tuple:
    """Device ms (all kernels, elementwise kernels) of one sLSTM block's work
    in a training step at this shape: its forward, again under remat full,
    and its backward, as lm.forward runs it (torch.profiler, device only)."""
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    x = randn(gen, (batch, seq, cfg.d_model), torch.bfloat16).requires_grad_()
    dy = randn(gen, (batch, seq, cfg.d_model), torch.bfloat16)
    params = list(blk.parameters())

    def fn():
        y = lm._remat(lambda x: lm._apply_block(blk, x, cfg)[0], cfg)(x)
        torch.autograd.grad(y, [x] + params, dy)

    fn()
    kernels = device_kernels(fn, cpu=False)
    return (sum(t for _, t in kernels),
            sum(t for name, t in kernels if "elementwise" in name), len(kernels))


@torch.no_grad()
def initial_losses(cfg, system, run_kw) -> tuple:
    """The loss of the launcher's initial weights (seed 0) on its first
    batch (a fresh pipeline over the run's token topic) through the plain
    version at chunk 64 and at chunk 32."""
    from repro_torch import init_params, loss_fn
    from repro_torch.data import LogDataPipeline
    from repro_torch.streams import Topic
    topic = Topic("train-tokens", system.find_log("train-tokens"))
    block = torch.from_numpy(next(LogDataPipeline(topic, batch_size=run_kw["batch"],
                                                  seq_len=run_kw["seq"]))).long().cuda()
    batch = {"tokens": block[:, :-1], "labels": block[:, 1:]}
    model = init_params(cfg, seed=0)
    plain64 = float(loss_fn(cfg, model, batch, mlstm_impl="plain")[0])
    with mlstm_calls(lambda scan, *args: scan(*args[:6], 32, "plain")):
        plain32 = float(loss_fn(cfg, model, batch)[0])
    del model
    torch.cuda.empty_cache()
    return plain64, plain32


def train_xlstm() -> tuple:
    """(b): the launcher trains xlstm-1.3b at full width and depth, every
    kernel's launches counted, its first loss held against the plain
    version's on the same weights and batch; then one more step of the
    shape profiled (device only) for the busy and idle shares and the mLSTM
    kernels' shares, and one sLSTM block's work profiled alone."""
    from repro_torch import get_config
    from repro_torch.models.lm import SLSTMBlock, layer_kinds
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.step import BF16_STEP_TOL
    run_kw = dict(XLSTM_TRAIN_RUN)
    cfg = get_config(run_kw["config"]).with_(n_layers=run_kw["n_layers"])
    kinds = layer_kinds(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (losses, model, system, seconds), flash, mlstm = counted_run(
        **run_kw, ckpt_every=10 ** 9, log_every=1, device="cuda")
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    tokens = run_kw["batch"] * run_kw["seq"]
    step_s = statistics.median(seconds[1:])
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = adamw_init(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, accum=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (run_kw["batch"], run_kw["seq"] + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fn():
        float(step_fn(model, state, batch)[2]["loss"])     # the loss read back, as run's

    t0 = time.perf_counter()
    kernels = device_kernels(fn, cpu=False)
    prof_s = time.perf_counter() - t0
    busy = sum(t for _, t in kernels) / 1e3
    fwd_s = sum(t for name, t in kernels if short_name(name) in MLSTM_FWD_KERNELS) / 1e3
    bwd_s = sum(t for name, t in kernels if short_name(name).startswith("bwd_")) / 1e3
    elt = sum(t for name, t in kernels if "elementwise" in name) / 1e3
    gemm = sum(t for name, t in kernels if "gemm" in name.lower() or "nvjet" in name) / 1e3
    blk = next(b for b in model.blocks if isinstance(b, SLSTMBlock))
    s_ms, s_elt, s_n = slstm_layer_ms(cfg, blk, run_kw["batch"], run_kw["seq"])
    n_s = kinds.count("slstm")
    per = {}
    for name, t in kernels:
        per[short_name(name)] = per.get(short_name(name), 0.0) + t
    del model, state, step_fn, blk
    torch.cuda.empty_cache()
    plain64, plain32 = initial_losses(cfg, system, run_kw)
    floor = abs(plain32 - plain64)
    limit = max(BF16_STEP_TOL["loss"], XLSTM_FLOOR_FACTOR * floor)
    say(f"[train xlstm] xlstm-1.3b {cfg.n_layers} layers ({kinds.count('mlstm')} mLSTM, "
        f"{n_s} sLSTM), {n_params / 1e9:.3f} B parameters, batch {run_kw['batch']} x "
        f"{run_kw['seq']}, remat {cfg.remat}, bf16, AdamW fp32 master and moments: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; the run {run_s:.1f} s. Step 1 against "
        f"the initial weights' loss on the first batch through the plain version: "
        f"{plain64:.4f} (chunk 32: {plain32:.4f}, floor {floor:.4f}); |diff| "
        f"{abs(losses[0] - plain64):.4f} (limit {limit:.4f}); ln V = "
        f"{math.log(cfg.vocab_size):.4f} (tied embeddings start above it)")
    # that the path runs: finite losses, the first the plain version's. That
    # it trains right is (c)'s check and the CPU tests' (the step against JAX)
    if not (len(losses) == run_kw["steps"] and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - plain64) <= limit):
        raise AssertionError(f"xlstm training losses off: {losses}, plain {plain64}")
    share = "device time not measured" if not kernels else (
        f"one more step of the shape, profiled (device only, {prof_s:.1f} s with the "
        f"profiler): device busy {busy:.3f} s in {len(kernels)} kernels, idle share "
        f"{1 - busy / step_s:.3f} of the run's unprofiled step; of busy: mLSTM forward "
        f"kernel {fwd_s / busy:.4f} ({fwd_s:.3f} s), mLSTM backward kernel "
        f"{bwd_s / busy:.4f} ({bwd_s:.3f} s), elementwise kernels {elt / busy:.4f}, matrix "
        f"products {gemm / busy:.4f}; one sLSTM block's work alone (forward twice, "
        f"backward) {s_ms:.1f} ms device in {s_n} kernels, {s_elt:.1f} ms of it "
        f"elementwise: {n_s} blocks' elementwise kernels {n_s * s_elt / 1e3 / busy:.4f} of "
        f"busy, all their kernels {n_s * s_ms / 1e3 / busy:.4f}")
    say(f"[train xlstm] step times " + ", ".join(f"{t:.3f}" for t in seconds)
        + f" s; after the first {step_s:.3f} s, {tokens / step_s:.0f} tokens/s; "
        f"peak memory {peak:.2f} GiB; {share}")
    top = sorted(per.items(), key=lambda x: -x[1])[:10]
    say(f"[train xlstm] profiled step, device ms by kernel (top 10): "
        + "; ".join(f"{name[:60]} {t:.1f}" for name, t in top))
    return flash, mlstm


def step_diffs(dtype: str, a, b, old) -> dict:
    """How far step a lies from step b (each (loss, grad norm, model)), in
    the terms of STEP_TOL (fp32: relative loss and grad norm, and the worst
    parameter's |diff| / (1 + |p|)) or BF16_STEP_TOL (bf16: loss, relative
    grad norm, the share of each tensor's updates that differ beyond lr / 2
    at the worst tensor, the parameters' relative RMS)."""
    (la, ga, ma), (lb, gb, mb) = a, b
    out = {"grad_norm": abs(ga - gb) / abs(gb)}
    if dtype == "float32":
        out["loss"] = abs(la - lb) / abs(lb)
        out["params"] = max(((pa.detach() - pb.detach()).abs() / (1 + pb.detach().abs()))
                            .max().item() for pa, pb in zip(ma.parameters(), mb.parameters()))
        return out
    out["loss"] = abs(la - lb)
    d2 = w2 = 0.0
    worst = 0.0
    for pa, pb, po in zip(ma.parameters(), mb.parameters(), old.parameters()):
        pa, pb, po = pa.detach().float(), pb.detach().float(), po.float()
        worst = max(worst, ((pa - po) - (pb - po)).abs().gt(STEP_LR / 2).float().mean().item())
        d2 += (pa - pb).square().sum().item()
        w2 += pb.square().sum().item()
    out["update_disagree"] = worst
    out["params_rel_rms"] = (d2 / w2) ** 0.5
    return out


def step_xlstm_kernel_vs_plain() -> None:
    """(c): one step at full width with one whole pattern (7 mLSTM + 1
    sLSTM) through the kernels and through the plain version, from the same
    parameters and batch, for each remat mode, in fp32 and bf16; beside the
    floor of two plain steps that differ only in the chunk (64 against 32)."""
    from repro_torch import get_config, init_params
    from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL
    B, S = XLSTM_STEP_BATCH
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("xlstm-1.3b").with_(n_layers=XLSTM_STEP_LAYERS, dtype=dtype)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        tol = ({"loss": STEP_TOL, "grad_norm": STEP_TOL, "params": STEP_TOL}
               if dtype == "float32" else
               {"loss": BF16_STEP_TOL["loss"], "grad_norm": BF16_STEP_TOL["grad_norm"],
                "update_disagree": 1 - BF16_STEP_TOL["update_agree"],
                "params_rel_rms": BF16_STEP_TOL["params_rel_rms"]})
        old = init_params(cfg, seed=5)
        plain64 = one_step(cfg.with_(remat="none"), "plain", STEP_EPS, batch)
        with mlstm_calls(lambda scan, *args: scan(*args[:6], 32, "plain")):
            plain32 = one_step(cfg.with_(remat="none"), "plain", STEP_EPS, batch)
        floor = step_diffs(dtype, plain32, plain64, old)
        del plain32
        torch.cuda.empty_cache()
        for remat in ("none", "full", "dots"):
            c = cfg.with_(remat=remat)
            kern = one_step(c, None, STEP_EPS, batch)
            plain = plain64 if remat == "none" else one_step(c, "plain", STEP_EPS, batch)
            d = step_diffs(dtype, kern, plain, old)
            limit = {key: max(tol[key], XLSTM_FLOOR_FACTOR * floor[key]) for key in d}
            say(f"[train xlstm] step kernels vs plain, xlstm-1.3b {XLSTM_STEP_LAYERS} layers "
                f"B={B} S={S} {dtype} remat {remat}: loss {kern[0]:.6f} / {plain[0]:.6f}, "
                f"grad norm {kern[1]:.6f} / {plain[1]:.6f}; "
                + ", ".join(f"{key} {d[key]:.3e} (floor {floor[key]:.3e}, limit "
                            f"{limit[key]:.3e})" for key in d)
                + f" (tol {tol} or {XLSTM_FLOOR_FACTOR}x the floor)")
            if not all(d[key] <= limit[key] for key in d):
                raise AssertionError(f"{dtype} xlstm train step, remat {remat}: kernels "
                                     f"against plain differ: {d} against {limit}")
            del kern, plain
            torch.cuda.empty_cache()
        del plain64, old
        torch.cuda.empty_cache()


def resume_xlstm() -> tuple:
    """(d): xlstm-1.3b at full width with one pattern: 2k steps straight
    against k steps, a checkpoint to the log, and a fresh resumed run on the
    same system; the losses after k equal bit for bit. Each run is a main
    path with its launches counted; returns the mLSTM kernels' sums."""
    from repro_torch.core import BoltSystem
    from repro_torch.train import CheckpointManager
    k = XLSTM_RESUME_K
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(XLSTM_RESUME_RUN, log_every=1, device="cuda")
        t0 = time.perf_counter()
        (straight, model, _, _), _, (f0, b0) = counted_run(
            steps=2 * k, system=BoltSystem(n_brokers=2), ckpt_every=10 ** 9, **kw)
        del model
        system = BoltSystem(n_brokers=2)
        (first, model, _, _), _, (f1, b1) = counted_run(
            steps=k, system=system, ckpt_every=k, **kw)
        del model                                    # the trainer is dropped
        (resumed, model, _, _), _, (f2, b2) = counted_run(
            steps=2 * k, system=system, ckpt_every=10 ** 9, resume=True, **kw)
        t1 = time.perf_counter()
        del model
    finally:
        torch.use_deterministic_algorithms(False)
    steps = CheckpointManager(system).steps()
    say(f"[train xlstm] resume xlstm-1.3b ({XLSTM_RESUME_RUN['n_layers']} layers), batch "
        f"{XLSTM_RESUME_RUN['batch']} x {XLSTM_RESUME_RUN['seq']}: straight "
        + ", ".join(f"{x:.6f}" for x in straight) + f"; resumed after step {k} "
        + ", ".join(f"{x:.6f}" for x in resumed) + f"; checkpoints {steps}; "
        f"{t1 - t0:.1f} s for the three runs")
    if first != straight[:k] or resumed != straight[k:] or steps != [k]:
        raise AssertionError(f"the resumed xlstm losses differ: {straight} against "
                             f"{first} + {resumed}")
    torch.cuda.empty_cache()
    return f0 + f1 + f2, b0 + b1 + b2


def phase_train_xlstm() -> tuple:
    """Phase 10: returns the mLSTM backward kernel's entry and the mLSTM
    forward's and backward's launches on each training path."""
    t0 = time.perf_counter()
    bwd = check_mlstm_backward()
    t1 = time.perf_counter()
    _, trained = train_xlstm()
    t2 = time.perf_counter()
    step_xlstm_kernel_vs_plain()
    t3 = time.perf_counter()
    resumed = resume_xlstm()
    say(f"[train xlstm] phase times: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    paths = {"train xlstm-1.3b": trained, "train xlstm-1.3b 8 layers (resume)": resumed}
    return (bwd, {path: n[0] for path, n in paths.items()},
            {path: n[1] for path, n in paths.items()})


def serve_timing(repeats: int) -> None:
    """``--serve-timing N``: only the served paths' times, N times each, to
    compare two commits' packages in alternating processes (this script
    copied beside each; no kernel checks and no "ok" line). For qwen3-8b
    (phases 3-4) and xlstm-1.3b (phases 7-8): the eager prefill and decode
    step of the timed prompts, and one served batch, as the phases time them;
    prints each series and a JSON line of them."""
    from repro_torch import decode_step, forward, get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.models.lm import layer_kinds
    result = {}
    for name, kernel, prompts, shape in (
            ("qwen3-8b", flash_attention, SERVE_PROMPTS, (4, 32)),
            ("xlstm-1.3b", mlstm_chunk, XLSTM_SERVE_PROMPTS, XLSTM_PROMPT)):
        cfg = get_config(name)
        model = init_params(cfg, seed=0)
        n_launches = (cfg.n_layers if kernel is flash_attention
                      else layer_kinds(cfg).count("mlstm"))
        tokens = prefill_tokens(cfg, shape)
        S = tokens.shape[1]
        rec = result[name] = {"prefill_ms": [], "decode_ms": [], "serve_s": []}
        with torch.no_grad():
            logits, _, caches, _ = forward(cfg, model, {"tokens": tokens}, want_caches=True,
                                           max_len=S + 1)
            nxt = logits[:, -1:, :cfg.vocab_size].argmax(-1)
            for _ in range(repeats):
                rec["prefill_ms"].append(cuda_ms(
                    lambda: forward(cfg, model, {"tokens": tokens}, want_caches=True,
                                    max_len=S + 1), iters=5, warmup=1))
                rec["decode_ms"].append(cuda_ms(
                    lambda: decode_step(cfg, model, caches, nxt, S), iters=5, warmup=1))
            del logits, caches
        for _ in range(repeats):
            rec["serve_s"].append(phase_serve(cfg, model, kernel, n_launches, prompts,
                                              f"{name} serve timing")[1])
        say(f"[serve timing] {name}: " + "; ".join(
            f"{key} " + ", ".join(f"{x:.4f}" for x in xs) for key, xs in rec.items()))
        del model
        torch.cuda.empty_cache()
    say(json.dumps({"serve_timing": result}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # before the first cuBLAS call: deterministic cuBLAS for phase 9's resume
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--serve-timing"]:
        serve_timing(int(sys.argv[2]))
        return 0
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention

    phase_device()
    kernel = phase_kernel()
    mlstm = phase_mlstm_kernel()
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[prefill] qwen3-8b: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB bf16) made in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_prefill(cfg, model)
    served, _ = phase_serve(cfg, model, flash_attention, cfg.n_layers, SERVE_PROMPTS, "serve")
    del model
    torch.cuda.empty_cache()
    phase_speculative()
    torch.cuda.empty_cache()
    mlstm["launches_by_path"] = {"serve xlstm-1.3b": phase_xlstm()}
    torch.cuda.empty_cache()
    backward, trained_fwd, trained_bwd = phase_train()
    torch.cuda.empty_cache()
    mlstm_bwd, xlstm_fwd, xlstm_bwd = phase_train_xlstm()
    kernel["launches_by_path"] = {"serve qwen3-8b": served, **trained_fwd}
    backward["launches_by_path"] = trained_bwd
    mlstm["launches_by_path"].update(xlstm_fwd)
    mlstm_bwd["launches_by_path"] = xlstm_bwd
    kernels = [kernel, backward, mlstm, mlstm_bwd]
    for entry in kernels:                            # every path that launched it
        entry["launches"] = sum(entry["launches_by_path"].values())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

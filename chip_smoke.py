#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device: build the flash-attention and mLSTM kernels from
     src/repro_torch/kernels/csrc into build/kernels/ (one nvcc each, in
     parallel), print their ptxas reports and the card's name and power limit;
  2. kernel: hold the kernel against its plain PyTorch version on the card
     (the cases of tests/test_kernels.py, ragged S, a query offset, G = 4; fp32
     and bf16), then time it at the qwen3-8b prefill shape beside the plain
     version, F.scaled_dot_product_attention, and the card's bound;
  3. prefill: qwen3-8b at full width and depth (36 layers, bf16, seeded random
     weights), one forward over 4 prompts of 32 tokens through the kernel and
     through the plain version, logits compared; the eager prefill and decode
     step timed, with the device's busy time from torch.profiler;
  4. serve: 4 requests on the port's own log, served by ServeEngine (prefill
     through the kernel, 15 decode steps), the kernel launched once a layer;
  5. speculative, in fp32: the phase-3 comparison again on an fp32 qwen3-8b,
     at the tests' fp32 tolerance; then with a smollm-135m draft and k = 4,
     one request of 16 tokens decoded through log.speculate() sessions
     equals sequential greedy decode;
  6. mlstm kernel: hold the chunkwise-mLSTM kernel against its plain version
     (h and the final state C, n, m) on the cases of tests/test_kernels.py, a
     carried-in state, ragged S and Dh = 1024 at the served shape; then time
     it at the xlstm-1.3b prefill shape beside the plain version and the bound;
  7. xlstm prefill: xlstm-1.3b at full width and depth (48 layers, seeded
     random weights), one forward over 4 prompts of 256 tokens through the
     kernel (launched once an mLSTM layer), each layer's kernel call held
     against the plain version on the same inputs; the logits against a
     forward through the plain version, in bf16 and in fp32; the eager
     prefill and decode step timed, with the device's busy time;
  8. xlstm serve: 4 requests (prompts of 37-256 tokens, 16 new tokens each)
     served by ServeEngine in bf16 on the port's log, the kernel launched once
     an mLSTM layer; a restarted engine serves 0.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
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
PREFILL_SHAPE = (1, 32, 8, 4096, 128)          # qwen3-8b prefill: B, H, KH, S, Dh
# mLSTM kernel against plain, both fp32: tests/test_kernels.py's tolerance
# for the chunkwise form; the kernel's scans and products sum in another order
MLSTM_TOL = 3e-4
# (B, H, S, Dh, chunk, carried-in state)
MLSTM_CASES = [
    (1, 2, 64, 32, 16, False),                 # tests/test_kernels.py MLSTM_CASES
    (2, 3, 128, 64, 32, False),
    (1, 4, 128, 128, 64, False),
    (2, 2, 96, 32, 32, False),
    (2, 2, 128, 64, 32, True),                 # a carried-in state
    (1, 2, 100, 64, 32, False),                # ragged S
    (1, 2, 70, 1024, 64, True),                # Dh = 1024, ragged, carried
    (4, 4, 256, 1024, 64, False),              # the served xlstm-1.3b prefill
]
MLSTM_SHAPE = (1, 4, 4096, 1024, 64)           # xlstm-1.3b prefill: B, H, S, Dh, chunk
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


def device_busy(fn):
    """(device ms, kernels) of one synchronised call of ``fn`` under
    torch.profiler, or (None, 0) where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def logit_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float())
    return {"max_abs": d.abs().max().item(),
            "rel_rms": (d.norm() / b.float().norm()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}


def randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_device():
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import SOURCES as FLASH_SOURCES
    from repro_torch.kernels.mlstm_chunk import SOURCES as MLSTM_SOURCES
    libs = {"flash_attention": FLASH_SOURCES, "mlstm_chunk": MLSTM_SOURCES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:       # one nvcc each, together
        built = dict(zip(libs, pool.map(build.build, libs, libs.values())))
    say(f"[device] built {', '.join(str(p.relative_to(ROOT)) for p in built.values())} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, sources in libs.items():
        for line in build.report(name, sources).splitlines():
            if any(key in line for key in ("Compiling entry", "Used", "spill")):
                say(f"[device] {name} ptxas: {line.replace('ptxas info', '').strip(' :')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    say(smi.splitlines()[0])
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_kernel() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
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

    B, H, KH, S, Dh = PREFILL_SHAPE
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention(q, k, v, causal=True, impl="plain")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"kernel disagrees at the prefill shape: {err}")
    del out, ref
    ke, ve = k.repeat_interleave(H // KH, 1), v.repeat_interleave(H // KH, 1)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, impl="plain"),
                       iters=3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                         iters=20)
    flops = 2 * B * H * S * S * Dh              # 4*B*H*S^2*Dh, halved by the mask
    nbytes = 2 * (2 * B * H * S * Dh + 2 * B * KH * S * Dh)   # Q, O, K, V in bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    say(f"[kernel] prefill shape B={B} H={H} KH={KH} S={S} Dh={Dh} bf16 causal: "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
        f"(ops {t_ops:.4f}, bytes {t_bytes:.4f}); max_abs_err {err:.3e}")
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
        busy, n = device_busy(fn)
        share = "device time not measured" if busy is None else (
            f"device busy {busy:.2f} ms in {n} kernels, idle share {1 - busy / ms:.3f}")
        say(f"[{tag}] {name} B={tokens.shape[0]} S={S}: {ms:.2f} ms eager; {share}")


def phase_prefill(cfg, model) -> None:
    check_prefill(cfg, model, "qwen3-8b bf16")
    time_prefill_and_decode(cfg, model, "prefill", prefill_tokens(cfg))
    say(f"[prefill] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_serve(cfg, model, kernel, n_launches: int, prompts, tag: str) -> int:
    """4 requests on the port's own log, 16 new tokens each; ``kernel`` is
    launched ``n_launches`` times in the served batch: its count is set to 0
    just before and read just after."""
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
    return launches


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


def mlstm_inputs(gen: torch.Generator, B, H, S, Dh):
    q, k, v = (randn(gen, (B, H, S, Dh), torch.float32) for _ in range(3))
    li = randn(gen, (B, H, S), torch.float32)
    lf = F.logsigmoid(randn(gen, (B, H, S), torch.float32) + 2.0)
    return q, k * Dh ** -0.5, v, li, lf


def mlstm_err(out, ref) -> tuple:
    """(max abs error, max of |out - ref| / (tol + tol |ref|)): <= 1 passes."""
    d = (out - ref).abs()
    return d.max().item(), (d / (MLSTM_TOL * (1 + ref.abs()))).max().item()


def phase_mlstm_kernel() -> dict:
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for B, H, S, Dh, chunk, carry in MLSTM_CASES:
        args = mlstm_inputs(gen, B, H, S, Dh)
        state = None
        if carry:
            _, state = mlstm_chunk(*mlstm_inputs(gen, B, H, 48, Dh), chunk=chunk,
                                   impl="plain")
        h, st = mlstm_chunk(*args, chunk=chunk, state=state)
        hp, stp = mlstm_chunk(*args, chunk=chunk, state=state, impl="plain")
        torch.cuda.synchronize()
        errs = {"h": mlstm_err(h, hp), **{key: mlstm_err(st[key], stp[key])
                                          for key in ("C", "n", "m")}}
        say(f"[mlstm kernel] B={B} H={H} S={S} Dh={Dh} chunk={chunk} carried={carry}: "
            + ", ".join(f"{key} max_abs_err={e[0]:.3e}" for key, e in errs.items())
            + f" (tol {MLSTM_TOL} abs + rel)")
        if not all(e[1] <= 1 for e in errs.values()):
            raise AssertionError(f"mlstm kernel disagrees with its plain version: {errs}")

    B, H, S, Dh, chunk = MLSTM_SHAPE
    args = mlstm_inputs(gen, B, H, S, Dh)
    h, st = mlstm_chunk(*args, chunk=chunk)
    hp, stp = mlstm_chunk(*args, chunk=chunk, impl="plain")
    err, scaled = mlstm_err(h, hp)
    if not scaled <= 1:
        raise AssertionError(f"mlstm kernel disagrees at the prefill shape: {err}")
    del h, st, hp, stp
    ms = cuda_ms(lambda: mlstm_chunk(*args, chunk=chunk), iters=10)
    plain_ms = cuda_ms(lambda: mlstm_chunk(*args, chunk=chunk, impl="plain"),
                       iters=3, warmup=1)
    # the reference's operations per chunk: Q K^T, (Q K^T .* W) V and W K on
    # L x L x Dh, Q C0 and the update of C on L x Dh x Dh
    flops = (6 * chunk ** 2 * Dh + 4 * chunk * Dh ** 2) * (S // chunk) * B * H
    # q, k, v read and h written (fp32), li and lf read, the state written
    nbytes = 4 * (4 * B * H * S * Dh + 2 * B * H * S + B * H * (Dh * Dh + Dh + 1))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    say(f"[mlstm kernel] prefill shape B={B} H={H} S={S} Dh={Dh} chunk={chunk} fp32: "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"bound {max(t_ops, t_bytes):.4f} ms (ops {t_ops:.4f} at fp32 67 TFLOP/s, bytes "
        f"{t_bytes:.4f}); no single PyTorch call computes it; max_abs_err {err:.3e}")
    del args
    B, H, S, Dh, chunk = MLSTM_CASES[-1][:5]
    args = mlstm_inputs(gen, B, H, S, Dh)
    served_ms = cuda_ms(lambda: mlstm_chunk(*args, chunk=chunk), iters=10)
    say(f"[mlstm kernel] served shape B={B} H={H} S={S} Dh={Dh} chunk={chunk}: kernel "
        f"{served_ms:.4f} ms a call")
    del args
    torch.cuda.empty_cache()
    return {"name": "mlstm_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
            "replaces": "src/repro/kernels/mlstm_chunk.py:22",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
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
    launches = phase_serve(cfg, model, mlstm_chunk, n_mlstm, XLSTM_SERVE_PROMPTS,
                           "xlstm serve")
    say(f"[xlstm serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
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
    kernel["launches"] = phase_serve(cfg, model, flash_attention, cfg.n_layers,
                                     (5, 13, 21, 32), "serve")
    del model
    torch.cuda.empty_cache()
    phase_speculative()
    torch.cuda.empty_cache()
    mlstm["launches"] = phase_xlstm()
    say(json.dumps({"kernels": [kernel, mlstm]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

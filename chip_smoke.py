#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device: build the flash-attention kernel from src/repro_torch/kernels/csrc
     into build/kernels/ and print the card's name and power limit;
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
     equals sequential greedy decode.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
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
    from repro_torch.kernels.flash_attention import SOURCES
    t0 = time.perf_counter()
    lib = build.build("flash_attention", SOURCES)
    say(f"[device] built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
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


def prefill_tokens(cfg) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return torch.randint(2, cfg.vocab_size, (4, 32), generator=gen, device="cuda")


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


def phase_prefill(cfg, model) -> None:
    from repro_torch import decode_step, forward
    check_prefill(cfg, model, "qwen3-8b bf16")
    tokens = prefill_tokens(cfg)
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
        say(f"[prefill] {name} B=4 S={S}: {ms:.2f} ms eager; {share}")
    say(f"[prefill] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_serve(cfg, model) -> int:
    from repro_torch.core import BoltSystem
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve import ServeEngine, decode_response
    from repro_torch.streams import Producer, Topic
    system = BoltSystem(n_brokers=3)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    rng = np.random.default_rng(2)
    prod = Producer(req)
    for i, n in enumerate((5, 13, 21, 32)):
        prod.produce({"id": f"r{i}",
                      "prompt": [int(t) for t in rng.integers(2, cfg.vocab_size, n)]})
    prod.flush()
    gen_tokens = 16
    eng = ServeEngine(cfg, model, req, resp, batch_size=4)
    torch.cuda.synchronize()
    flash_attention.launches = 0                 # the main path starts here
    t0 = time.perf_counter()
    served = eng.poll_and_serve(gen_tokens=gen_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention.launches          # ... and ends here
    out = decode_response(resp.log.read(0, resp.log.visible_tail))
    if served != 4 or sorted(out) != ["r0", "r1", "r2", "r3"]:
        raise AssertionError(f"served {served}: {sorted(out)}")
    if not all(len(t) == gen_tokens and all(0 <= x < cfg.vocab_size for x in t)
               for t in out.values()):
        raise AssertionError(f"bad responses {out}")
    if launches != cfg.n_layers:
        raise AssertionError(f"kernel launched {launches} times, want {cfg.n_layers}")
    if ServeEngine(cfg, model, req, resp, batch_size=4).poll_and_serve() != 0:
        raise AssertionError("a restarted engine re-served committed requests")
    say(f"[serve] {served} requests x {gen_tokens} tokens in {dt:.3f} s: "
        f"{served / dt:.2f} requests/s, {served * gen_tokens / dt:.1f} tokens/s; "
        f"kernel launches {launches}; restarted engine served 0")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import get_config, init_params

    phase_device()
    kernel = phase_kernel()
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[prefill] qwen3-8b: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB bf16) made in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_prefill(cfg, model)
    kernel["launches"] = phase_serve(cfg, model)
    del model
    torch.cuda.empty_cache()
    phase_speculative()
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

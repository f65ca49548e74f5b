#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-timing N     # only the served paths' times
    python3 chip_smoke.py --tp-rank R W DIR    # one rank of phase 20 (it starts them)

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device: build the flash-attention forward and backward and the mLSTM
     forward and backward kernels from src/repro_torch/kernels/csrc into
     build/kernels/ (one nvcc each, in parallel), print their ptxas reports
     and the card's name and power limit;
  2. kernel: hold the kernel against its plain PyTorch version on the card
     (the cases of tests/test_kernels.py, ragged S, a query offset, G = 4,
     the examples' and smoke configs' shapes, head dims 16 and the padded
     8, 12 and (24, 16); fp32 and bf16; a second call equal bit for bit),
     and the bf16 kernel on the edges of its tiles and TMA boxes
     (Sq and Sk of 1 to 4097, q_offset, non-causal Sq != Sk, G = 1/4/8, Dh =
     32/64/128, B > 1 with KH > 1), jamba's G = 8 (64 q heads over 8 kv);
     then time it at the qwen3-8b prefill shape beside the plain version,
     F.scaled_dot_product_attention, and the card's bound, beside SDPA at S =
     512-8192 and at the served batch, and at jamba's long-prompt shape (B=1,
     H=64, KH=8, S=4096, Dh=128) beside the plain version, SDPA with
     enable_gqa and the bound; and the (16, 16) forward and backward at
     B=1, H=32, KH=8, S=4096 beside the plain versions, SDPA, the bounds
     and the exponentials' floor;
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
     width and 24 of its 48 layers (21 mLSTM + 3 sLSTM) trained 2 steps by the
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
 11. moe: granite-moe-3b-a800m at full width (bf16, seeded random weights;
     24 q heads padded to 32, 8 kv heads, Dh 64; 40 experts padded to 48,
     top 8). The flash forward and backward at its training shape, against
     the plain version and timed beside SDPA and the bounds; (a) at full
     depth (32 layers): one forward of 4 prompts x 32 tokens, each layer's
     flash call held against the plain version on its inputs, the logits
     against a plain forward within 3x the floor of two plain forwards that
     differ in the order of one sum, and against a plain forward routed as
     the kernel's was, the (token, layer) expert choices that differ
     counted; the eager prefill and decode step timed; 4 requests served by
     ServeEngine on the port's log; (b) trained 6 steps by the launcher at
     full depth (batch 2 x 4096 in 2 microbatches, AdamW fp32 master and
     moments, remat full), with step time, tokens/s, peak memory, the busy
     and idle shares of one more step, the flash kernels' shares and, from
     one MoE layer's work alone, the expert products' and the dispatch's;
     (c) one step, kernels against plain (routed as the kernels), 2 layers,
     fp32 and bf16, at train/step.py's tolerances; (d) 2 layers at batch 2 x
     512: 4 steps straight against 2, a checkpoint and 2 resumed, bit for
     bit. Every launcher run counts the flash kernels.
 12. mla: deepseek-v2-lite-16b at full width (bf16, seeded random weights;
     Multi-head Latent Attention with 16 heads, keys of 128 + 64 rope dims
     over values of 128, kv_lora_rank 512; a dense first layer and 26 MoE
     layers of 64 experts, top 6, 2 shared). (k) The flash forward and
     backward at head dims (192, 128) against the plain version in fp32
     and bf16 on the edges of their tiles (Sq and Sk of 1 to 4097, a
     q_offset, non-causal Sq != Sk, B > 1), a second call equal bit for
     bit; timed at its training shape (B=1, H=KH=16, S=4096) beside the
     plain version, SDPA (its backend named, and each backend's time) and
     the bounds, the backward pass by pass; ptxas's registers and spills of
     the (192, 128) instantiations; (a)-(d) as phase 11: (a) at full depth
     (27 layers), each layer's flash call against plain, the logits
     against plain within 3x the floor and routed alike, flips counted,
     prefill and decode timed, 4 requests served; (b) the launcher trains
     7 of its 27 layers (the dense one and 6 MoE; full depth's AdamW state
     does not fit the card) 6 steps at 2 x 4096 in 2 microbatches; (c) one
     step, kernels against plain, 2 layers, fp32 and bf16; (d) 2 layers at
     2 x 512: 4 steps against 2, a checkpoint and 2 resumed, bit for bit.
 13. jamba: jamba-1.5-large-398b at full width (bf16, seeded random weights;
     Mamba mixers of d_inner 16384 and d_state 16, 64 q heads over 8 kv, 16
     experts of 24576, top 2), depth cut to 5 of 72 layers (mamba+moe,
     mamba+mlp, mamba+moe, mamba+mlp, attn+moe: 33.11 B parameters, 61.66
     GiB), served only. (a) the build's parameters, time and peak memory;
     (b) one forward of 4 prompts x 32 tokens, the flash kernel launched
     once (its one attention layer) and held against plain on its inputs,
     the logits against plain within 3x the floor and routed alike, flips
     counted; (d) the eager prefill and decode step timed, one of each
     profiled into the Mamba mixers', the MoE's, the matrix products' and
     the flash kernel's shares of busy time, 4 requests served on the
     port's log; (c) one full-width Mamba layer alone: the log-depth scan's
     prefill against the recurrence in fp32 and bf16, its prefill at 1 x
     2048 and a decode step timed.
 14. whisper: whisper-small at full size (bf16, seeded random weights and
     frames; 12 encoder layers non-causal over 1500 frames, 12 decoder
     layers of self and cross attention, Dh 64). (e) The flash forward and
     backward at its encoder shape (B=4, H=12, S=1500, non-causal) and its
     cross shape (32 queries over 1500 keys), against the plain version,
     timed beside it, SDPA and the bounds; (a) parameters and bytes; (b)
     one forward of 4 prompts x 32 tokens with their frames, the kernel
     launched 36 times (12 encoder, 12 self, 12 cross), each call held
     against plain and the logits within 3x the floor or PREFILL_TOL; (c)
     the served batch on the model's own entry points (forward with the
     frames, then 15 greedy decode_steps), its stream against the plain
     prefill's; the eager prefill and decode step timed; (d) 4 steps of
     make_train_step at 4 x 448 tokens with 1500 frames each (the kernels'
     launches counted), a step profiled; one step at full size, kernels
     against plain, fp32 and bf16, the backward launched 36 times.
 15. llava: llava-next-34b at full width and depth (bf16, seeded random
     weights; 60 layers, 56 q heads padded to 64 over 8 kv, Dh 128, 35.321
     B parameters with the padded slots, 65.79 GiB). (a) parameters, bytes
     and the peak while made; (b) one forward of 4 x (576 patches + 32
     tokens) under one causal mask, the kernel launched 60 times, each call
     against plain, n_prefix and the argmax positions that differ; (c) the
     served batch with the image prefix (forward + 15 decode_steps), its
     stream against the plain prefill's, the prefill and decode step timed
     beside the decode's bytes bound; (d) 4 text requests served by
     ServeEngine on the port's log; (e) one step at 2 layers with the
     prefix (2 x (576 + 512)), kernels against plain, fp32 and bf16.
 16. mesh: (a) one rank started from an in-process HashStore (no TCP
     rendezvous) and make_host_mesh(), the (1, 1) (data, model) mesh of the
     card; (b) under use_mesh, qwen3-8b at full width with 2 layers: its
     parameters placed by param_shardings as DTensors, each whole on the
     card, and its AdamW state by opt_state_shardings (ZeRO-1); (c) one
     make_zero1_train_step through the flash forward and backward kernels
     (launches counted) against make_train_step without a mesh from the
     same parameters and batch: loss, grad norm, every parameter and every
     m, v and master tensor equal bit for bit; (d) the dry run
     (repro_torch.launch.dryrun) on the meta device for DRYRUN_CELLS on the
     16x16 and 2x16x16 meshes, a line a cell.
 17. examples: the examples' twins run on the card in this process, as
     `python examples/<name>` would run them (runpy, sys.argv set), each
     to the end of its own assertions: serve_torch.py (the engine serves 4
     requests on the log; speculative decoding through log.speculate()
     equals sequential greedy decode, in bf16 with the reference's draft of
     2 heads of 16) and train_e2e_torch.py (150
     steps, a crash at 75 and a resume from the log's checkpoint) are main
     paths of the flash kernels ("example serve_torch", "example
     train_e2e_torch"; the train twin launches forward and backward once a
     layer and step); then agents_on_streams_torch.py and quickstart_torch.py,
     host code over the log that launches no kernel. Each one's seconds,
     the served tokens/s and the logged losses it prints;
 18. costs: ServeCosts.for_models(qwen3-8b, smollm-135m) at phase 3's batch
     and context on the H100 roofline (repro_torch.serve.costs: reckoned,
     not measured): the prefill a token, the decode and draft steps and
     verify(k) for k = 0..4, beside phase 3's measured decode step, eager
     and device-busy; a busy step under the roofline's floor (its bytes
     less the untied embedding rows a step does not read), or no busy
     time, fails.
 19. smoke configs: each of the ten registered configs at its smoke config
     (get_smoke_config; the configurations the CPU tests hold against JAX,
     head dims 8, 12, 16 and MLA's (24, 16)), seeded: (a) the forward
     through the kernels against the plain path on the same weights, in
     bf16 and again in fp32 (each flash call at TOL, the logits within 3x
     the floor or PREFILL_TOL, MoE routed alike; xlstm by phase 7's
     checks); (b) 4 requests x 16 tokens, 4 new each, served by
     ServeEngine on the port's log, the streams equal to the plain
     prefill's (whisper on forward + decode_step, llava also with its image
     prefix); (c) one train step, kernels against plain, fp32 and bf16. A
     main path of all four kernels ("smoke configs").
 20. tp: tensor parallelism over 'model' on the one card, for each model of
     TP_RUNS at full width (seed 5; bf16 but xlstm): qwen3-8b and
     deepseek-v2-lite-16b at 2 layers (deepseek's dense mla+mlp first layer
     and one mla+moe), xlstm-1.3b at 8 of 48 layers (7 mLSTM + 1 sLSTM) in
     fp32,
     jamba-1.5-large-398b at 2 of 72 (mamba+moe, mamba+mlp), whisper-small
     whole over 1500 frames at its text context of 448, and llava-next-34b
     at 2 of 60 layers after a 576-patch prefix. (a) the one-rank port: a
     forward of the run's batch (2 x 1024 tokens; whisper's 2 x 448) through the kernels (its MoE expert choices
     recorded), through the plain versions and through the plain versions
     with one sum split (the floor: P V over the keys in two halves, the
     mLSTM at chunk 32), the kernels' logits within 3x the floor or
     PREFILL_TOL of the plain version's, the greedy stream of 4 prompts x
     32 tokens (and the model's frames or prefix) and 16 new, and one
     train step where the run steps (not jamba, not llava), written to
     build/tp and the card freed; (b) 2 ranks, this script with --tp-rank,
     gloo over a FileStore, both on cuda:0 (NCCL refuses two ranks on one
     device), joined within TP_TIMEOUT: each checks first that gloo's
     all_reduce of a CUDA tensor sums right (the transport: a rank fails
     where gloo refuses or garbles it), then for each model, made and split
     by one rank at a time (repro_torch.distributed.tp.split_model over the
     (1, 2) (data, model) mesh; its parameter bytes the rules'
     bytes_per_device), as a main path of its own (the four kernels'
     counts) runs the forward (logits made whole by gather_vocab, within 3x
     the floor or PREFILL_TOL of the one-rank port's; MoE expert choices
     that differ from the one-rank forward's counted, and where any do, a
     forward pinned to the one-rank choices held instead), the greedy
     stream (tp.greedy; equal to the one-rank stream, or parting only at a
     near-tie) and, where the run steps, one make_zero1_train_step from a
     state made in the rank's chunks (zero1_adamw_init; within
     BF16_STEP_TOL of the one-rank step; qwen3's of TP_ACCUM microbatches,
     after which it trains through a whole run: saved by both ranks to rank
     0's log, stepped again, restored onto fresh split weights and stepped
     again, bit for bit the straight step, its peak a rank below the whole
     AdamW state's bytes; xlstm's in fp32, AdamW's eps
     STEP_EPS, its loss within STEP_TOL and its gradient held layer by
     layer: each block's gradients on its input in the one-rank forward and
     a seeded cotangent within TP_LAYER_GRAD_TOL of each tensor's largest,
     the whole model's grad norm and parameters printed, not held, since
     random-weight xlstm-1.3b's whole gradient parts by percents between two
     orders of its sums; and the power check: with reduce_to_model made a
     plain reduce_from_model, every mLSTM layer must exceed that limit). A
     rank holds 16 of qwen3's 32 q
     heads and 4 of its 8 kv heads, 8 of deepseek's 16 MLA heads and 32 of
     its 64 experts, 2 of xlstm's 4 mLSTM heads (2048 of 4096 channels; the
     mLSTM kernel forward and backward at Dh 1024), 8192 of jamba's 16384
     Mamba channels and 8 of its 16 experts, 6 of whisper's 12 heads in the
     encoder, the decoder and the cross attention, and 32 of llava's 64
     padded q heads and 4 of its 8 kv heads; each flash and mLSTM shape the
     ranks launch is in KERNEL_CASES or MLSTM_CASES, held against plain by
     phases 1, 6, 9a and 10a. Each model's launches are summed over the
     ranks, a main path of each kernel it launches (jamba's 2 layers
     neither attend nor hold an mLSTM: it launches none). Their times are
     printed, but two ranks share one card: they are no measure of a
     split's speed.
Checkpoints cross between the packages both ways only on the CPU
(tests/test_torch_checkpoint.py): this machine has no JAX to read or write
the reference's side; phases 9d-12d resume through the reference's record.
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
# (B, H, KH, Sq, Sk, Dh, causal, q_offset); Dh is one head dim, or (Dhk, Dhv)
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
    (4, 64, 8, 32, 32, 128, True, 0),          # the served jamba prefill batch: G = 8
    (1, 64, 8, 1024, 1024, 128, True, 0),      # jamba's heads at S = 1024
    (4, 2, 1, 8, 8, 32, True, 0),              # examples/serve_torch.py (bf16): the engine's
    (1, 2, 1, 8, 8, 32, True, 0),              # batch, its first and its longest
    (1, 2, 1, 19, 19, 32, True, 0),            # speculative target calls,
    (1, 2, 1, 8, 8, 16, True, 0),              # and its draft's, 2 heads of 16
    (1, 2, 1, 17, 17, 16, True, 0),
    (4, 2, 1, 128, 128, 64, True, 0),          # examples/train_e2e_torch.py, bf16 there
    # phase 19's smoke configs: Dh 16 (the (16, 16) instantiation); 8, 12 and
    # MLA's (24, 16), zero-padded to (16, 16) and (32, 32) by the wrapper
    (4, 4, 2, 32, 32, 16, True, 0),            # qwen3-8b, smollm-135m, jamba, granite
    (4, 6, 2, 64, 64, 16, True, 0),            # starcoder2-15b (G = 3), train batch
    (4, 4, 4, 30, 30, 16, False, 0),           # whisper-small's encoder over 30 frames
    (4, 4, 4, 32, 30, 16, False, 0),           # and its cross attention
    (4, 8, 1, 32, 32, 8, True, 0),             # llava-next-34b (7 heads padded to 8), Dh 8
    (4, 8, 1, 48, 48, 8, True, 0),             # llava with its 16-patch prefix
    (4, 8, 2, 32, 32, 12, True, 0),            # deepseek-67b, Dh 12
    (4, 4, 4, 32, 32, (24, 16), True, 0),      # deepseek-v2-lite-16b's MLA
    (2, 4, 2, 129, 300, 16, True, 171),        # Dh 16 past a tile, q_offset
    (1, 4, 2, 4097, 4097, 16, True, 0),        # Dh 16, long S
    (2, 4, 4, 65, 300, (24, 16), False, 0),    # padded MLA, non-causal Sq != Sk
    (2, 16, 4, 1024, 1024, 128, True, 0),      # phase 20: a rank's half of qwen3-8b's
    (1, 16, 4, 1024, 1024, 128, True, 0),      # heads, MESH_STEP's batch, a microbatch
    (4, 16, 4, 32, 32, 128, True, 0),          # of its step and the prefill,
    (2, 8, 8, 1024, 1024, (192, 128), True, 0),   # and of deepseek-v2-lite-16b's MLA
    (4, 8, 8, 32, 32, (192, 128), True, 0),
    (2, 6, 6, 1500, 1500, 64, False, 0),       # whisper-small's 6 heads a rank: the
    (2, 6, 6, 448, 448, 64, True, 0),          # encoder, the decoder's self and cross
    (2, 6, 6, 448, 1500, 64, False, 0),        # attention at TP_RUNS' 2 x 448 (its step)
    (4, 6, 6, 1500, 1500, 64, False, 0),       # and at the stream's prefill of 4 x 32
    (4, 6, 6, 32, 32, 64, True, 0),
    (4, 6, 6, 32, 1500, 64, False, 0),
    (2, 32, 4, 1600, 1600, 128, True, 0),      # llava-next-34b's 32 of 64 q heads a rank:
    (4, 32, 4, 608, 608, 128, True, 0),        # 576 patches + 1024, and + 32 tokens
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
DH16_SHAPE = (1, 32, 8, 4096, 16)              # its heads at Dh 16: the (16, 16) kernels timed
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
    (2, 2, 1024, 1024, 64, False, None),       # phase 20: a rank's 2 of xlstm-1.3b's 4
    (4, 2, 32, 1024, 64, False, None),         # heads, TP_RUNS' batch and the prefill
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
PRELUDE = 3000          # kernels that open each by-pass profile (backward_passes)
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
# phase 10b: xlstm-1.3b at full width (at full depth, 1.3 B parameters x 16
# bytes of bf16 weights, fp32 master and moments and bf16 gradients, ~21 GB,
# fit one card); 2 x 2048 tokens (xLSTM's published context for 1.3B), remat
# full. 2 steps, not 4: a step took ~48 s on an H100 at 48 layers, nearly all
# of it the eager sLSTM step loop (6 layers x 2048 steps, ~90 kernels a step
# with its remat and backward). Cut to 16 of the 48 layers (two whole
# patterns: 14 mLSTM + 2 sLSTM), a third of that loop, to keep the script
# within its time limit beside phase 20's six models (at 24 layers the
# phase took 274.7 s of a 997.4 s run); PERF.md section 4 lists the cut.
# Its tied embeddings start it far above ln V (the residual stream still holds
# the input token's embedding, whose logit is ~|e| sqrt(d); the JAX reference
# starts there too, tests/test_torch_xlstm_train.py), so its first loss is
# held against a forward of the initial weights on the first batch through the
# plain version, within XLSTM_FLOOR_FACTOR times the floor of two plain
# forwards (chunk 64 against 32) or BF16_STEP_TOL's loss
XLSTM_TRAIN_RUN = dict(config="xlstm-1.3b", n_layers=24, batch=2, seq=2048, accum=1, steps=2)
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
# phase 11: granite-moe-3b-a800m at full width (24 q heads padded to 32, 8 kv
# heads: G = 4, Dh = 64; 40 experts padded to 48, top 8, d_expert 512), bf16
GRANITE_SHAPE = (1, 32, 8, 4096, 64)           # its training and long-prompt flash calls
# (a) a routing flip (a top-8 near-tie that rounding breaks the other way)
# moves a token by O(1) in the layers after it, so the full-depth logits,
# kernel against plain, are held to MOE_FLOOR_FACTOR times the floor of two
# plain forwards that differ only in the order of a sum (P V over the keys
# in two halves), or PREFILL_TOL; each layer's flash call against the plain
# version on that layer's inputs at TOL; and the logits against a plain
# forward routed as the kernel's was at PREFILL_TOL
MOE_FLOOR_FACTOR = 3.0
# (b) full depth: 4.03 B parameters (48 experts a layer, an untied 49408-row
# embedding and head) x 16 bytes (bf16 weights and gradient accumulator, fp32
# master and moments) = 64.5 GB, and a microbatch's own bf16 gradients 8.1
# GB: ~68 GiB of the card's 79, activations under remat full a few GiB more
MOE_TRAIN_RUN = dict(config="granite-moe-3b-a800m", n_layers=32, batch=2, seq=4096, accum=2,
                     steps=6)
# (d) full width, 2 layers, batch 2 x 512: 4 steps straight against 2, a
# checkpoint and 2 resumed
MOE_RESUME_RUN = dict(config="granite-moe-3b-a800m", n_layers=2, batch=2, seq=512)
MOE_RESUME_K = 2
# phase 12: deepseek-v2-lite-16b at full width: MLA's flash calls take head
# dims (Dhk, Dhv) = (128 + 64, 128), 16 q and 16 kv heads (G = 1)
MLA_DIMS = (192, 128)
MLA_SHAPE = (1, 16, 16, 4096)                  # its training flash calls: B, H, KH, S
# (k) against plain, fp32 and bf16, on the edges of the (192, 128) kernels'
# tiles (forward: 128-row q and kv tiles; backward: 32-row query steps and
# 128-key tiles, 128-row query tiles and 64-key steps) and TMA boxes:
# (B, H, KH, Sq, Sk, causal, q_offset)
MLA_CASES = [
    *[(1, 4, 4, n, n, True, 0) for n in (1, 63, 64, 65, 127, 128, 129, 4097)],
    *[(2, 4, 4, 129, n, False, 0) for n in (1, 63, 65, 127, 4097)],   # non-causal Sq != Sk
    (2, 8, 8, 129, 300, True, 171),            # q_offset, Sq < Sk, B > 1
    (1, 16, 16, 63, 1000, True, 937),          # the last 63 rows of a sequence
    (2, 8, 4, 100, 100, True, 0),              # G = 2
    (4, 16, 16, 32, 32, True, 0),              # the served deepseek prefill batch
]
# (b) full depth (15.71 B parameters x 16 bytes of bf16 weights and gradient
# accumulator, fp32 master and moments = 251 GB) does not fit one card: 7 of
# 27 layers (the dense first layer and 6 MoE, 4.01 B parameters). 6 layers
# peaked at 61.41 GiB on an H100 80GB HBM3 at 700 W (PERF.md, phase 12's probe);
# a 7th MoE layer adds 585 M x 16 bytes and a microbatch's bf16 gradients,
# ~9.8 GiB, for ~71 GiB of the card's 79
MLA_TRAIN_RUN = dict(config="deepseek-v2-lite-16b", n_layers=7, batch=2, seq=4096, accum=2,
                     steps=6)
# (d) full width, 2 layers (the dense one and one MoE), batch 2 x 512
MLA_RESUME_RUN = dict(config="deepseek-v2-lite-16b", n_layers=2, batch=2, seq=512)
MLA_RESUME_K = 2
# phase 13: jamba-1.5-large-398b at full width (d 8192; Mamba Di 16384, N 16,
# dt_rank 512, conv 4; 64 q heads over 8 kv heads, Dh 128: G = 8; 16 experts
# of 24576, top 2; vocab 65536, untied), depth cut to 5 of its 72 layers: the
# least depth that reaches its one attention layer in 8 (pattern index 4),
# 33.11 B parameters, 61.66 GiB in bf16; 8 layers would take 84.26 GiB. Its
# 16 x 8192 x 24576 expert tensors are drawn one fp32 temporary at a time
# (layers.dense_init), a 73.7 GiB peak. Served only: AdamW's 16 bytes a
# parameter put one full-width MoE layer (9.66 B) at 155 GB
JAMBA_LAYERS = 5
JAMBA_SHAPE = (1, 64, 8, 4096, 128)            # its long-prompt flash call: B, H, KH, S, Dh
# (c) one full-width Mamba layer: the log-depth scan's prefill against the
# recurrence's steps on MAMBA_CHECK, in fp32 to MAMBA_TOL of each tensor's
# largest entry (the same function, products in another order) and in bf16
# to PREFILL_TOL; then its prefill timed at MAMBA_TIMED, where dA, dBx and h
# are (1, 2048, 16384, 16) fp32, 2 GiB each
MAMBA_CHECK = (4, 32)
MAMBA_TOL = 1e-5
MAMBA_TIMED = (1, 2048)
# whisper-small (phase 14) at full size. A forward launches the flash kernel
# once an encoder layer (non-causal over T = 1500 frames), and twice a
# decoder layer: self attention (causal, without RoPE, as the reference's
# forward) and cross attention (Sq = the text, Sk = T, no mask)
WHISPER_PROMPT = (4, 32)                       # the served batch: B, S (text)
WHISPER_NEW = 16                               # new tokens a request
WHISPER_TRAIN = dict(batch=4, seq=448, steps=4)   # 448: whisper's text context
# the flash kernel at its encoder and cross shapes: (B, H, KH, Sq, Sk, Dh)
WHISPER_SHAPES = {"encoder": (4, 12, 12, 1500, 1500, 64),
                  "cross": (4, 12, 12, 32, 1500, 64)}
# llava-next-34b (phase 15) at full width and depth: 576 patch embeddings
# before 32 text tokens a prompt, one causal mask over both
LLAVA_PROMPT = (4, 32)
LLAVA_NEW = 16
LLAVA_STEP = (2, 512)                          # its 2-layer step against plain
# phase 16: the host mesh of one card, qwen3-8b at full width with 2 layers
# and step_kernel_vs_plain's batch; then the dry run's cells on the meta
# device that fit ~60 s of this host's CPU: every config's decode_32k, the
# sub-quadratic ones' long_500k, prefill_32k but xlstm-1.3b's (its sLSTM loop
# runs 32768 eager steps on the meta device, ~20 min) and smollm-135m's
# train_4k (xlstm-1.3b's takes ~20 min, jamba's ~2); the CLI runs them all
MESH_STEP = dict(config="qwen3-8b", n_layers=2, shape=(2, 1024))
# phase 19: each registered config's smoke config (get_smoke_config), the
# configurations the CPU tests hold against JAX: 4 requests of 16 prompt
# tokens and 4 new tokens served, and one train step of B x S
SMOKE_SERVE = (4, 16, 4)
SMOKE_STEP = (2, 64)
# phase 20: MESH_STEP's qwen3-8b (full width, 2 layers, bf16) split over
# 'model' by TP_WORLD gloo ranks, each a process on the one card, held
# against the one-rank port: MESH_STEP's batch forward and step, and a
# greedy stream of TP_NEW tokens after TP_PROMPT's prompts; the ranks end
# within TP_TIMEOUT seconds or fail the phase
TP_WORLD = 2
# qwen3-8b's split step takes TP_ACCUM microbatches (the one-rank reference
# too), then trains through a whole run: saved to rank 0's log after the
# step, a second step, and a restore onto fresh split objects whose second
# step must be the straight one's bit for bit; its state is made in the
# rank's chunks (zero1_adamw_init), so a rank's peak stays below the whole
# AdamW state's bytes (TP_STATE_BYTES: m, v and master, 12 bytes a parameter)
TP_ACCUM = 2
TP_STATE_BYTES = 12
TP_DIFF_BLOCK = 1 << 24    # elements a split step's check reads at a time
# the models split, in turn, each at full width: qwen3-8b (attn+mlp);
# deepseek-v2-lite-16b at 2 layers (its dense mla+mlp first layer and one
# mla+moe), MLA's 16 heads and the 64 experts split over the ranks;
# xlstm-1.3b at 8 of 48 layers (one whole pattern, 7 mLSTM + 1 sLSTM), 2 of
# its 4 heads a rank, in fp32 (its step held as tp_step_diffs and
# tp_layer_hold say); jamba-1.5-large-398b at 2 of 72 layers (mamba+moe,
# mamba+mlp: 12.2e9 parameters, 22.69 GiB whole, which the ranks make one
# at a time, made_in_turn), Mamba's 16384 channels and the 16 experts
# split, no step (jamba trains on the CPU only, PERF.md section 4);
# whisper-small at full size over 1500 frames, 6 of its 12 heads a rank,
# at its text context of 448 ("shape" in place of MESH_STEP's); and
# llava-next-34b at 2 of 60 layers after a 576-patch prefix, 32 of its 64
# padded q heads and 4 of 8 kv heads a rank, no step (its split step is the
# attn+mlp step qwen3-8b's run holds, and two ranks' whole AdamW state,
# ~34 GB each, leaves no room)
TP_RUNS = ({"config": MESH_STEP["config"], "n_layers": MESH_STEP["n_layers"], "accum": TP_ACCUM,
            "resume": True},
           {"config": "deepseek-v2-lite-16b", "n_layers": 2},
           {"config": "xlstm-1.3b", "n_layers": 8, "dtype": "float32"},
           {"config": "jamba-1.5-large-398b", "n_layers": 2, "step": False},
           {"config": "whisper-small", "shape": (2, 448)},
           {"config": "llava-next-34b", "n_layers": 2, "step": False})
TP_PROMPT = (4, 32)
TP_NEW = 16
TP_TIMEOUT = 600
TP_FLOOR_FACTOR = 3.0
TP_STEP_EPS = {"float32": STEP_EPS}    # AdamW's eps where the step is held at STEP_TOL
# an fp32 split step's gradients, held layer by layer (tp_layer_hold): each
# block's on its own input from the one-rank forward and one seeded
# cotangent, the worst tensor's max |diff| against its largest one-rank
# gradient. Random-weight xlstm-1.3b's whole-model gradient is no measure:
# where q . n nears 0 in an mLSTM layer, a rounding difference grows through
# the layers above (the logits, phase 7; the gradient norm parts by percents
# between two orders of the one-rank port's own sums, phase 10c), while one
# layer's stays near the rounding of its own sums. A rank left its own share
# of a summed gradient (reduce_from_model where reduce_to_model belongs)
# moves the gates' weights by a large fraction of their gradient, and each
# run shows that the hold catches it (the power check)
TP_LAYER_GRAD_TOL = 3e-3
# phase 17: the train twin at its default 150 steps (4 layers, 4 x 128)
EXAMPLE_TRAIN_ARGS = ("--steps", "150")
DRYRUN_CELLS = ([(a, "decode_32k") for a in ("smollm-135m", "deepseek-67b",
                                             "starcoder2-15b", "qwen3-8b",
                                             "llava-next-34b", "jamba-1.5-large-398b",
                                             "whisper-small", "granite-moe-3b-a800m",
                                             "deepseek-v2-lite-16b", "xlstm-1.3b")]
                + [("jamba-1.5-large-398b", "long_500k"), ("xlstm-1.3b", "long_500k")]
                + [(a, "prefill_32k") for a in ("smollm-135m", "deepseek-67b",
                                                "starcoder2-15b", "qwen3-8b",
                                                "llava-next-34b", "jamba-1.5-large-398b",
                                                "whisper-small", "granite-moe-3b-a800m",
                                                "deepseek-v2-lite-16b")]
                + [("smollm-135m", "train_4k")])


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


def busy_shares(fn, ranges) -> tuple:
    """One synchronised call of ``fn`` under torch.profiler (CPU and CUDA):
    (device busy ms, kernels, {range: device ms of the kernels launched
    inside each range of that name}, [(kernel, ms)]). The window opens with
    PRELUDE one-element kernels in a range of their own, which the sums skip
    (the card's profiler drops a session's first device events once earlier
    profiles have run; backward_passes)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")

    def launched(e) -> int:              # kernels of e's ops (not its own annotation)
        return sum(len(c.kernels) + launched(c) for c in e.cpu_children)

    def window():
        with torch.profiler.record_function("prelude"):
            for _ in range(PRELUDE):
                x.add_(1)
        fn()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = {"prelude", *ranges}
    events = prof.events()
    inside = {name: sum(e.device_time_total for e in events
                        if e.name == name and e.device_type != cuda) / 1e3 for name in names}
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
               if e.device_type == cuda and e.name not in names]
    n_prelude = sum(launched(e) for e in events
                    if e.name == "prelude" and e.device_type != cuda)
    busy = sum(t for _, t in kernels) - inside["prelude"]
    return busy, len(kernels) - n_prelude, {r: inside[r] for r in ranges}, kernels


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


def head_dims(Dh) -> tuple:
    """(Dhk, Dhv) of a case's Dh: one head dim, or the pair."""
    return Dh if isinstance(Dh, tuple) else (Dh, Dh)


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
        Dhk, Dhv = head_dims(Dh)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, Sq, Dhk), dtype)
            k, v = randn(gen, (B, KH, Sk, Dhk), dtype), randn(gen, (B, KH, Sk, Dhv), dtype)
            out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
            same = torch.equal(out, flash_attention(q, k, v, causal=causal, q_offset=q_offset))
            ref = flash_attention(q, k, v, causal=causal, q_offset=q_offset, impl="plain")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            say(f"[kernel] B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} Dh={Dh} causal={causal} "
                f"q_offset={q_offset} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                f"(tol {TOL[dtype]}); second call equal: {same}")
            if not (err <= TOL[dtype] and same):
                raise AssertionError(f"kernel disagrees with its plain version or repeats "
                                     f"unequally: {err}")
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
    flash_timed(gen, JAMBA_SHAPE, "jamba")
    flash_timed(gen, DH16_SHAPE, "Dh 16 (the (16, 16) instantiation)", backward=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def ex2_rate() -> float:
    """Exponentials a second the card's SFUs give: 16 an SM a clock, at the
    card's own SM count and maximum SM clock (``nvidia-smi
    --query-gpu=clocks.max.sm``)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * 16 * float(mhz) * 1e6


def flash_timed(gen: torch.Generator, shape: tuple, label: str,
                backward: bool = False) -> None:
    """The bf16 kernel at ``shape`` (B, H, KH, S, Dh), causal, against the
    plain version, timed beside it, SDPA with ``enable_gqa`` and the bound
    (2 B H S^2 Dh operations at the bf16 peak; Q, K, V and O once at the
    memory rate). With ``backward``, the backward kernel likewise (its
    bound by ``backward_bounds``), and the floor of the softmax's
    exponentials (B H S^2 / 2 of them, one an element the mask keeps, at
    ``ex2_rate()``), which a small Dh does not hide under the products."""
    from repro_torch.kernels.flash_attention import (_forward_kernel, backward_errors,
                                                     flash_attention, flash_attention_backward,
                                                     flash_attention_backward_plain)
    B, H, KH, S, Dh = shape
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    err = (flash_attention(q, k, v, causal=True).float()
           - flash_attention(q, k, v, causal=True, impl="plain").float()).abs().max().item()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"kernel disagrees at the {label} shape {shape}: {err}")
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, impl="plain"),
                       iters=3, warmup=1)
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True), iters=20)
    ms_again = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    flops = 2 * B * H * S * S * Dh
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (2 * B * H * S * Dh + 2 * B * KH * S * Dh) / PEAK_BYTES * 1e3
    line = (f"[kernel] {label} shape B={B} H={H} KH={KH} (G = {H // KH}) S={S} Dh={Dh} bf16 "
            f"causal: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; again "
            f"{ms_again:.4f}), plain {plain_ms:.4f} ms, sdpa (enable_gqa) {sdpa:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms (ops {t_ops:.4f}, bytes {t_bytes:.4f}); "
            f"max_abs_err {err:.3e}")
    if backward:
        do = randn(gen, (B, H, S, Dh), torch.bfloat16)
        o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
        got = flash_attention_backward(q, k, v, o, do, lse, causal=True)
        bwd_err = max(e[1] for e in backward_errors(
            got, flash_attention_backward_plain(q, k, v, do, causal=True)))
        if not bwd_err <= 1:
            raise AssertionError(f"the backward disagrees at the {label} shape {shape}: "
                                 f"{bwd_err} of BWD_TOL")
        bwd = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True),
                      iters=10)
        bwd_plain = cuda_ms(lambda: flash_attention_backward_plain(q, k, v, do, causal=True),
                            iters=3, warmup=1)
        bwd_sdpa = sdpa_backward_ms(q, k, v, do, iters=10)
        b_ops, b_bytes = backward_bounds(B, H, KH, S, Dh)
        rate = ex2_rate()
        line += (f"; backward kernel {bwd:.4f} ms, plain {bwd_plain:.4f} ms, sdpa backward "
                 f"{bwd_sdpa:.4f} ms, bound {max(b_ops, b_bytes):.4f} ms (ops {b_ops:.4f}, "
                 f"bytes {b_bytes:.4f}), worst gradient {bwd_err:.3f} of BWD_TOL; the "
                 f"exponentials' floor {B * H * S * S / 2 / rate * 1e3:.4f} ms a forward at "
                 f"{rate:.4e} a second (the backward recomputes them twice)")
        del do, o, lse, got
    say(line)
    del q, k, v
    torch.cuda.empty_cache()


def attention_layers(cfg) -> int:
    """The layers whose prefill calls the flash kernel: attention and MLA."""
    from repro_torch.models.lm import layer_kinds
    return sum(kind.partition("+")[0] in ("attn", "mla") for kind in layer_kinds(cfg))


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
def time_prefill_and_decode(cfg, model, tag: str, tokens, extra=None) -> dict:
    """The eager prefill and one decode step, each timed and profiled
    (``busy_shares``' window, so no dropped event shortens the busy time).
    ``extra``: more entries of the prefill's batch (frames, a vision
    prefix); decode continues after the prefix. Returns {"B", "S",
    "forward(want_caches)": (eager ms, busy ms or None), "decode_step": (...)}."""
    from repro_torch import decode_step, forward
    batch = {"tokens": tokens, **(extra or {})}
    S = tokens.shape[1] + (batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0)
    logits, _, caches, _ = forward(cfg, model, batch, want_caches=True, max_len=S + 1)
    nxt = logits[:, -1:, :cfg.vocab_size].argmax(-1)
    prefill = lambda: forward(cfg, model, batch, want_caches=True,  # noqa: E731
                              max_len=S + 1)
    decode = lambda: decode_step(cfg, model, caches, nxt, S)  # noqa: E731
    out = {"B": tokens.shape[0], "S": S}
    for name, fn in (("forward(want_caches)", prefill), ("decode_step", decode)):
        ms = cuda_ms(fn, iters=5, warmup=1)
        busy, n, _, kernels = busy_shares(fn, ())
        share = "device time not measured" if not kernels else (
            f"device busy {busy:.2f} ms in {n} kernels, idle share "
            f"{1 - busy / ms:.3f}")
        say(f"[{tag}] {name} B={tokens.shape[0]} S={S}: {ms:.2f} ms eager; {share}")
        out[name] = (ms, busy if kernels else None)
    return out


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


def phase_prefill(cfg, model) -> dict:
    """Phase 3; returns time_prefill_and_decode's measurements (phase 18
    reads the decode step)."""
    check_prefill(cfg, model, "qwen3-8b bf16")
    timed = time_prefill_and_decode(cfg, model, "prefill", prefill_tokens(cfg))
    time_long_prompt(cfg, model)
    say(f"[prefill] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return timed


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
    profiler sees no device time. Once earlier profiles have run, the
    profiler on the card drops the first device events of a session (5
    after phase 11 alone, all 9 of a 3-call window after phases 10 and
    11), so each window opens with PRELUDE one-element kernels, which the
    sums skip."""
    import re
    x = torch.zeros(1, device="cuda")

    def window():
        for _ in range(PRELUDE):
            x.add_(1)
        for _ in range(calls):
            fn()

    sums = {}
    for name, t in device_kernels(window):
        found = re.search(r"flash_bwd_(delta|dkdv|dq)", name)
        if found:
            n, total = sums.get(found.group(1), (0, 0.0))
            sums[found.group(1)] = (n + 1, total + t)
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
        Dhk, Dhv = head_dims(Dh)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, Sq, Dhk), dtype)
            k, v = randn(gen, (B, KH, Sk, Dhk), dtype), randn(gen, (B, KH, Sk, Dhv), dtype)
            do = randn(gen, (B, H, Sq, Dhv), dtype)
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
    to 0 just before it and read just after. Per attention layer (``attn+mlp``,
    ``attn+moe``, ``mla+mlp`` or ``mla+moe``), and per
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
    n_attn = sum(kind.partition("+")[0] in ("attn", "mla") for kind in kinds)
    want = tuple((remat * n * calls, n * calls) for n in (n_attn, kinds.count("mlstm")))
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
    wall, kernels = one_more_step(cfg, model, run_kw)
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
    del model
    torch.cuda.empty_cache()
    return fwd, bwd


def one_more_step(cfg, model, run_kw: dict, cpu: bool = True) -> tuple:
    """One more training step of the run's shape (fresh AdamW state, random
    tokens, no data pipeline), not on the counted path: its wall time
    unprofiled (the median of two, after a warm-up) and the device's
    kernels in a profiled repeat of it (``device_kernels``)."""
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = adamw_init(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, accum=run_kw["accum"])
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
    kernels = device_kernels(fn, cpu=cpu)
    del state, step_fn
    torch.cuda.empty_cache()
    return statistics.median(walls), kernels


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


def step_pair(cfg, eps: float, batch) -> tuple:
    """``one_step`` through the kernels, then through the plain version
    routed as the kernel step was (``moe_routes``); and how many (token,
    layer) expert choices the plain step's own top-k would have changed."""
    log = []
    with moe_routes(log):
        kern = one_step(cfg, None, eps, batch)
    with moe_routes(log, pin=True) as pinned:
        plain = one_step(cfg, "plain", eps, batch)
    return kern, plain, pinned["flips"]


def step_kernel_vs_plain(config="qwen3-8b", n_layers=2, shape=(2, 1024),
                         extra=None, want_bwd=None) -> None:
    """(c): one step of ``config`` (a registered name, or a ModelConfig such
    as a smoke config) with ``n_layers`` layers (None: the
    config's depth), batch ``shape`` (B, S), through the kernels and
    through the plain version, from the same parameters and batch: every
    gradient, then the loss, grad norm and every updated parameter
    compared; in fp32 also at the optimizer's own eps, where the
    parameters that differ must be those of near-zero gradients.
    ``extra(cfg, gen, B)`` gives more entries of the batch (frames, a
    vision prefix); ``want_bwd``, where given, is the backward kernel's
    launches in the kernels' gradient. An MoE
    model's plain step takes the kernel step's expert choices (its gates
    from its own probabilities): a near-tie that rounding flips moves a
    token by O(1), which would hold the routing's discontinuity, not the
    kernels; the choices it would have flipped are counted."""
    from repro_torch import get_config, init_params, loss_fn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train import AdamWConfig
    from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL
    B, S = shape
    base = get_config(config) if isinstance(config, str) else config
    config = base.name
    for dtype in ("float32", "bfloat16"):
        cfg = base.with_(dtype=dtype)
        cfg = cfg.with_(n_layers=n_layers or cfg.n_layers)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **(extra(cfg, gen, B) if extra else {})}
        grads, log = {}, []
        for impl in (None, "plain"):
            model = init_params(cfg, seed=5, trainable=True)
            before = flash_attention.backward_launches
            with moe_routes(log, pin=impl == "plain") as pinned:
                loss, _ = loss_fn(cfg, model, batch, attn_impl=impl)
                grads[impl] = torch.autograd.grad(loss, list(model.parameters()))
            if impl is None:
                n_bwd = flash_attention.backward_launches - before
            del model, loss
        if want_bwd is not None and n_bwd != want_bwd:
            raise AssertionError(f"{config}: the gradient launched the backward kernel "
                                 f"{n_bwd} times, want {want_bwd}")
        flips, routed = pinned["flips"], pinned["tokens"]
        size = (lambda t: t.abs().max()) if dtype == "float32" else torch.linalg.norm
        g_err = max((size(a.float() - b.float()) / size(b.float()).clamp_min(1e-30)).item()
                    for a, b in zip(grads[None], grads["plain"]))
        plain_grads = grads["plain"]
        del grads
        torch.cuda.empty_cache()
        if not g_err <= STEP_GRAD_TOL[dtype]:
            raise AssertionError(f"{dtype} gradients, kernels against plain: {g_err}")
        (lk, gk, mk), (lp, gp, mp), step_flips = step_pair(cfg, STEP_EPS, batch)
        flips = max(flips, step_flips)
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
            (_, _, mk), (_, gp8, mp), _ = step_pair(cfg, eps, batch)
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
        routed = "" if cfg.moe is None else (
            f"; plain routed as the kernels (unpinned its top-k would change {flips} of "
            f"{routed} tokens' choices, each layer routing twice under remat)")
        say(f"[train] step kernels vs plain, {config} {cfg.n_layers} layers B={B} S={S}"
            + ("" if extra is None else " (" + ", ".join(
                f"{key} {tuple(t.shape)}" for key, t in batch.items()
                if key not in ("tokens", "labels")) + ")")
            + f" {dtype}: backward kernel launches {n_bwd} in the gradient; gradients "
            f"{'max |diff| / max |g|' if dtype == 'float32' else 'rel_rms'} {g_err:.3e} at "
            f"the worst tensor (tol {STEP_GRAD_TOL[dtype]}); "
            f"loss {lk:.6f} / {lp:.6f}, grad norm {gk:.6f} / {gp:.6f}; {detail}{routed}")
        if not ok:
            raise AssertionError(f"{dtype} train step: kernels against plain differ")


def resume_exactly(run_kw: dict = RESUME_RUN, k: int = RESUME_K,
                   tag: str = "smollm-135m (30 layers, G=3, Dh=64)") -> tuple:
    """(d): ``run_kw`` (smollm-135m at full size), 2k steps straight against
    k steps, a checkpoint to the log, and a fresh resumed run on the same
    system: the losses after k equal bit for bit. Each of the three runs is
    a main path with its launches counted; returns their sums (forward,
    backward)."""
    from repro_torch.core import BoltSystem
    from repro_torch.train import CheckpointManager
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(run_kw, log_every=1, device="cuda")
        t0 = time.perf_counter()
        (straight, model, _, _), (f0, b0), _ = counted_run(
            steps=2 * k, system=BoltSystem(n_brokers=2), ckpt_every=10 ** 9, **kw)
        del model
        t1 = time.perf_counter()
        system = BoltSystem(n_brokers=2)
        (first, model, _, _), (f1, b1), _ = counted_run(
            steps=k, system=system, ckpt_every=k, **kw)
        del model                                    # the trainer is dropped
        t2 = time.perf_counter()
        (resumed, model, _, _), (f2, b2), _ = counted_run(
            steps=2 * k, system=system, ckpt_every=10 ** 9, resume=True, **kw)
        t3 = time.perf_counter()
        del model
    finally:
        torch.use_deterministic_algorithms(False)
    steps = CheckpointManager(system).steps()
    say(f"[train] resume {tag}, batch {run_kw['batch']} x {run_kw['seq']}: straight "
        + ", ".join(f"{x:.6f}" for x in straight)
        + f"; resumed after step {k} " + ", ".join(f"{x:.6f}" for x in resumed)
        + f"; checkpoints {steps}; {t1 - t0:.1f} s straight, {t2 - t1:.1f} s to the "
        f"checkpoint, {t3 - t2:.1f} s resumed")
    if first != straight[:k] or resumed != straight[k:] or steps != [k]:
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
    """(b): the launcher trains xlstm-1.3b at full width (XLSTM_TRAIN_RUN's
    depth), every
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


def step_xlstm_kernel_vs_plain(base=None, shape=XLSTM_STEP_BATCH,
                               remats=("none", "full", "dots")) -> None:
    """(c): one step at full width with one whole pattern (7 mLSTM + 1
    sLSTM) through the kernels and through the plain version, from the same
    parameters and batch, for each remat mode, in fp32 and bf16; beside the
    floor of two plain steps that differ only in the chunk (64 against 32).
    ``base``, ``shape`` and ``remats`` put another config (phase 19's smoke
    config), batch (B, S) and remat modes in their place."""
    from repro_torch import get_config, init_params
    from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL
    B, S = shape
    base = base or get_config("xlstm-1.3b").with_(n_layers=XLSTM_STEP_LAYERS)
    for dtype in ("float32", "bfloat16"):
        cfg = base.with_(dtype=dtype)
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
        for remat in remats:
            c = cfg.with_(remat=remat)
            kern = one_step(c, None, STEP_EPS, batch)
            plain = plain64 if remat == "none" else one_step(c, "plain", STEP_EPS, batch)
            d = step_diffs(dtype, kern, plain, old)
            limit = {key: max(tol[key], XLSTM_FLOOR_FACTOR * floor[key]) for key in d}
            say(f"[train xlstm] step kernels vs plain, {cfg.name} {cfg.n_layers} layers "
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


@contextmanager
def flash_calls(fn):
    """Route the model's flash calls (``attention.flash_attention``) through
    ``fn(flash, q, k, v, causal=..., impl=...)``, ``flash`` the real one."""
    from repro_torch.models import attention
    flash = attention.flash_attention
    attention.flash_attention = lambda *args, **kw: fn(flash, *args, **kw)
    try:
        yield
    finally:
        attention.flash_attention = flash


@contextmanager
def moe_routes(log: list, pin: bool = False):
    """Append each MoE routing's expert choices to ``log`` in call order; or,
    with ``pin``, give each call the choices ``log`` holds (its gates from
    its own probabilities, renormalised) and count in ``["flips"]`` the
    (token, layer) choices its own top-k would have changed, of
    ``["tokens"]`` routed. A model with no MoE layer never routes."""
    from repro_torch.models import moe
    route = moe._route
    state = {"calls": 0, "flips": 0, "tokens": 0}

    def routed(xt, p, cfg):
        probs, gate, eidx = route(xt, p, cfg)
        state["tokens"] += eidx.numel() // eidx.shape[-1]
        if not pin:
            log.append(eidx)
            return probs, gate, eidx
        want = log[state["calls"]]
        state["calls"] += 1
        state["flips"] += int((eidx.sort(-1).values != want.sort(-1).values).any(-1).sum())
        gate = probs.gather(-1, want)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), want

    moe._route = routed
    try:
        yield state
    finally:
        moe._route = route


def flips(a: list, b: list) -> int:
    """(token, layer) expert choices that differ between two routing logs."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b))


def attention_split_sum(q, k, v, *, causal: bool, impl=None) -> torch.Tensor:
    """``flash_attention_plain`` with its P V sum over the keys taken in two
    halves: the same function, one sum in another order (the floor of (a))."""
    B, H, S, Dh = q.shape
    KH, Dhv = k.shape[1], v.shape[-1]
    qg = q.reshape(B, KH, H // KH, S, Dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * Dh ** -0.5
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    h = S // 2
    out = (torch.einsum("bkgqs,bksd->bkgqd", p[..., :h], v[:, :, :h].float())
           + torch.einsum("bkgqs,bksd->bkgqd", p[..., h:], v[:, :, h:].float()))
    return out.reshape(B, H, S, Dhv).to(q.dtype)


def flash_at_granite() -> None:
    """The flash forward and backward kernels at granite's training shape
    (H = 32 of which 8 padded slots, KH = 8, Dh = 64, S = 4096), against
    the plain version, timed beside SDPA (forward and backward) and the
    bounds of phase 2 and 9a at H = 32 (the kernel does the padded heads'
    work, as the reference does)."""
    from repro_torch.kernels.flash_attention import (_forward_kernel, backward_errors,
                                                     flash_attention, flash_attention_backward,
                                                     flash_attention_backward_plain)
    B, H, KH, S, Dh = GRANITE_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q = randn(gen, (B, H, S, Dh), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dh), torch.bfloat16), randn(gen, (B, KH, S, Dh), torch.bfloat16)
    do = randn(gen, (B, H, S, Dh), torch.bfloat16)
    out = flash_attention(q, k, v, causal=True)
    err = (out.float() - flash_attention(q, k, v, causal=True, impl="plain").float()
           ).abs().max().item()
    o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
    got = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    again = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    b_err, b_scaled = max(backward_errors(got, flash_attention_backward_plain(
        q, k, v, do, causal=True)), key=lambda e: e[1])
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (err <= TOL[torch.bfloat16] and b_scaled <= 1 and same):
        raise AssertionError(f"flash at granite's shape: forward {err}, backward {b_err}, "
                             f"repeat equal {same}")
    del out, got, again
    ke, ve = k.repeat_interleave(H // KH, 1), v.repeat_interleave(H // KH, 1)
    fwd = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True), iters=20)
    bwd = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True), iters=10)
    sdpa_bwd = sdpa_backward_ms(q, k, v, do, iters=10)
    f_ops = 2 * B * H * S * S * Dh / PEAK_BF16_FLOPS * 1e3
    f_bytes = 2 * (2 * B * H * S * Dh + 2 * B * KH * S * Dh) / PEAK_BYTES * 1e3
    b_ops, b_bytes = backward_bounds(B, H, KH, S, Dh)
    say(f"[moe] flash at granite's shape B={B} H={H} (8 padded) KH={KH} S={S} Dh={Dh} bf16 "
        f"causal: forward kernel {fwd:.4f} ms, sdpa {sdpa:.4f} ms, bound "
        f"{max(f_ops, f_bytes):.4f} ms (ops {f_ops:.4f}, bytes {f_bytes:.4f}), max_abs_err "
        f"{err:.3e}; backward kernel {bwd:.4f} ms, sdpa backward {sdpa_bwd:.4f} ms, bound "
        f"{max(b_ops, b_bytes):.4f} ms (ops {b_ops:.4f}, bytes {b_bytes:.4f}), rel_rms "
        f"{b_err:.3e}, two calls equal")
    del q, k, v, do, o, lse, ke, ve
    torch.cuda.empty_cache()


@torch.no_grad()
def check_moe_prefill(cfg, model, tag: str, label: str = "moe prefill", batch=None,
                      n_flash=None) -> None:
    """(a): one full-depth forward of 4 prompts x 32 tokens through the
    kernel (launched once an attention or MLA layer), each layer's flash
    call held against the plain version on the inputs it sees at rtol =
    atol = TOL, as tests/test_torch_cuda.py holds the kernel (bf16 outputs
    past 2.56 in magnitude, as jamba's attention gives, are more than one
    ulp apart at 2e-2 absolute); the logits against a plain forward,
    within MOE_FLOOR_FACTOR of the floor of two plain forwards that differ
    in the order of one sum, and against a plain forward routed as the
    kernel's was; the (token, layer) expert choices that differ counted.
    ``batch`` (default 4 prompts x 32 tokens) may hold frames or a vision
    prefix; ``n_flash`` (default one an attention layer) is the kernel's
    launches a forward."""
    from repro_torch import forward
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import layer_kinds
    batch = batch or {"tokens": prefill_tokens(cfg)}
    tokens = batch["tokens"]
    n_flash = attention_layers(cfg) if n_flash is None else n_flash
    errs, scaled, routes = [], [], {key: [] for key in ("kernel", "plain", "split")}
    rtol = atol = TOL[model.embed.dtype]

    def held(flash, q, k, v, *, causal, impl=None):
        out = flash(q, k, v, causal=causal, impl=impl)
        ref = flash(q, k, v, causal=causal, impl="plain").float()
        d = (out.float() - ref).abs()
        errs.append(d.max().item())
        scaled.append((d / (atol + rtol * ref.abs())).max().item())
        return out

    before = flash_attention.launches
    with flash_calls(held), moe_routes(routes["kernel"]):
        logits, _, _, n_prefix = forward(cfg, model, batch)
    if flash_attention.launches - before != n_flash:
        raise AssertionError(f"the prefill launched the kernel "
                             f"{flash_attention.launches - before} times, want {n_flash}")
    with moe_routes(routes["plain"]):
        plain, _, _, _ = forward(cfg, model, batch, attn_impl="plain")
    with flash_calls(lambda flash, *args, **kw: attention_split_sum(*args, **kw)), \
            moe_routes(routes["split"]):
        split, _, _, _ = forward(cfg, model, batch)
    with moe_routes(routes["kernel"], pin=True):
        pinned, _, _, _ = forward(cfg, model, batch, attn_impl="plain")
    B, S = tokens.shape
    if (logits.shape != (B, n_prefix + S, cfg.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    d, floor, dp = logit_diff(logits, plain), logit_diff(split, plain), logit_diff(logits, pinned)
    n = tokens.numel() * sum(kind.endswith("+moe") for kind in layer_kinds(cfg))
    tol = PREFILL_TOL[logits.dtype]
    argmax_diff = int((logits.argmax(-1) != plain.argmax(-1)).sum())
    say(f"[{label}] {tag} B={B} S={S}" + (f" after a {n_prefix}-position prefix (n_prefix)"
                                          if n_prefix else "")
        + f": {cfg.n_layers} layers, {n_flash} flash calls, argmax differing at "
        f"{argmax_diff} of {B * (n_prefix + S)} positions; each attention call's vs "
        f"plain on its inputs max_abs_err {max(errs):.3e}, at most {max(scaled):.3f} of rtol "
        f"= atol = {TOL[logits.dtype]} (tests/test_torch_cuda.py's criterion); logits "
        f"{tuple(logits.shape)} finite; kernel vs plain max_abs {d['max_abs']:.3e}, rel_rms "
        f"{d['rel_rms']:.3e}, argmax agree {d['argmax_agree']:.4f}, expert choices differing "
        f"{flips(routes['kernel'], routes['plain'])} of {n} (token, layer); plain split sum vs "
        f"plain (floor) max_abs {floor['max_abs']:.3e}, rel_rms {floor['rel_rms']:.3e}, argmax "
        f"agree {floor['argmax_agree']:.4f}, choices differing "
        f"{flips(routes['split'], routes['plain'])} (tol {MOE_FLOOR_FACTOR}x floor or {tol}); "
        f"plain routed as the kernel: max_abs {dp['max_abs']:.3e}, rel_rms {dp['rel_rms']:.3e} "
        f"(tol {tol})")
    if not (max(scaled) <= 1 and all(dp[key] <= tol[key] for key in tol)
            and all(d[key] <= max(MOE_FLOOR_FACTOR * floor[key], tol[key]) for key in tol)):
        raise AssertionError(f"{tag} prefill disagrees: layers {errs}, logits {d} against "
                             f"floor {floor}, pinned {dp}")


def moe_layer_ms(cfg, blk, seq: int) -> tuple:
    """Device ms of one MoE layer's ``apply_moe`` in a training step at a
    microbatch of 1 x ``seq``: its forward, again under remat full, and its
    backward (torch.profiler, device only); (all kernels, the matrix
    products', kernel count)."""
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    x = randn(gen, (1, seq, cfg.d_model), torch.bfloat16).requires_grad_()
    dy = randn(gen, (1, seq, cfg.d_model), torch.bfloat16)
    params = list(blk.moe.parameters())

    def fn():
        for _ in range(2 if cfg.remat == "full" else 1):
            y, aux = moe.apply_moe(blk.moe, x, cfg)
        torch.autograd.grad([y, aux], [x] + params, [dy, torch.ones_like(aux)])

    fn()
    kernels = device_kernels(fn, cpu=False)
    return (sum(t for _, t in kernels),
            sum(t for name, t in kernels if "gemm" in name.lower() or "nvjet" in name),
            len(kernels))


def train_moe(run: dict = MOE_TRAIN_RUN, label: str = "moe train") -> tuple:
    """(b): the launcher trains ``run`` (granite-moe-3b-a800m at full width
    and depth, or deepseek-v2-lite-16b's depth cut), the flash kernels'
    launches counted; then one more step of the shape timed and profiled
    (device only) for the busy and idle shares, the flash kernels' shares,
    and from one MoE layer's work alone the expert products' and the
    dispatch's."""
    from repro_torch import get_config
    from repro_torch.models.lm import layer_kinds
    run_kw = dict(run)
    cfg = get_config(run_kw["config"]).with_(n_layers=run_kw["n_layers"])
    steps, accum = run_kw["steps"], run_kw["accum"]
    torch.cuda.reset_peak_memory_stats()
    (losses, model, _, seconds), (fwd, bwd), _ = counted_run(
        **run_kw, ckpt_every=10 ** 9, log_every=1, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    ln_v = math.log(cfg.vocab_size)
    say(f"[{label}] {cfg.name} {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, batch {run_kw['batch']} x {run_kw['seq']} in {accum} microbatches, "
        f"remat {cfg.remat}, bf16, AdamW fp32 master and moments: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (ln V = {ln_v:.4f}, plus the router's "
        f"aux loss over {cfg.n_layers} layers)")
    # that the path runs: finite losses, the first near ln V. That it trains
    # right is (c)'s check and the CPU tests' (the step against the reference)
    if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) <= 1.0):
        raise AssertionError(f"{cfg.name} training losses off: {losses}")
    tokens = run_kw["batch"] * run_kw["seq"]
    step_s = statistics.median(seconds[1:])
    wall, kernels = one_more_step(cfg, model, run_kw, cpu=False)
    busy = sum(t for _, t in kernels) / 1e3
    fwd_s = sum(t for name, t in kernels if "flash_fwd" in name) / 1e3
    bwd_s = sum(t for name, t in kernels if "flash_bwd" in name) / 1e3
    gemm = sum(t for name, t in kernels if "gemm" in name.lower() or "nvjet" in name) / 1e3
    n_moe = sum(kind.endswith("+moe") for kind in layer_kinds(cfg))
    m_ms, m_gemm, m_n = moe_layer_ms(cfg, next(b for b in model.blocks if hasattr(b, "moe")),
                                     run_kw["seq"])
    calls = n_moe * accum / 1e3
    per = {}
    for name, t in kernels:
        per[short_name(name)] = per.get(short_name(name), 0.0) + t
    del model
    torch.cuda.empty_cache()
    share = "device time not measured" if not kernels else (
        f"one more step of the shape: {wall:.3f} s unprofiled, device busy {busy:.3f} s in "
        f"{len(kernels)} kernels (profiled repeat, device only), idle share "
        f"{1 - busy / wall:.3f}; of busy: flash forward {fwd_s / busy:.4f} ({fwd_s:.3f} s), "
        f"flash backward {bwd_s / busy:.4f} ({bwd_s:.3f} s), all matrix products "
        f"{gemm / busy:.4f}; one MoE layer's apply_moe alone (forward twice, backward, 1 x "
        f"{run_kw['seq']}) {m_ms:.2f} ms device in {m_n} kernels, its matrix products "
        f"{m_gemm:.2f} ms: over {n_moe} layers x {accum} microbatches the expert products "
        f"{m_gemm * calls / busy:.4f} of busy, the routing, dispatch and combine "
        f"{(m_ms - m_gemm) * calls / busy:.4f}")
    say(f"[{label}] step times " + ", ".join(f"{t:.3f}" for t in seconds)
        + f" s; median after the first {step_s:.3f} s, {tokens / step_s:.0f} tokens/s; "
        f"peak memory {peak:.2f} GiB; {share}")
    top = sorted(per.items(), key=lambda x: -x[1])[:10]
    say(f"[{label}] profiled step, device ms by kernel (top 10): "
        + "; ".join(f"{name[:60]} {t:.1f}" for name, t in top))
    return fwd, bwd


def phase_moe() -> tuple:
    """Phase 11: granite-moe-3b-a800m. Returns the flash forward's and
    backward's launches on each granite path."""
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    t0 = time.perf_counter()
    flash_at_granite()
    cfg = get_config("granite-moe-3b-a800m")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[moe prefill] granite-moe-3b-a800m: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters ({cfg.n_experts_padded} experts a layer, {cfg.moe.n_experts} routed, top "
        f"{cfg.moe.top_k}; {cfg.n_heads_padded} q heads, {cfg.n_heads} real)")
    check_moe_prefill(cfg, model, "granite-moe-3b-a800m bf16")
    time_prefill_and_decode(cfg, model, "moe prefill", prefill_tokens(cfg))
    served, _ = phase_serve(cfg, model, flash_attention, cfg.n_layers, SERVE_PROMPTS,
                            "moe serve")
    say(f"[moe serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    trained = train_moe()
    t2 = time.perf_counter()
    step_kernel_vs_plain("granite-moe-3b-a800m")
    t3 = time.perf_counter()
    resumed = resume_exactly(MOE_RESUME_RUN, MOE_RESUME_K,
                             "granite-moe-3b-a800m (2 layers, full width)")
    say(f"[moe] phase times: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, "
        f"(d) {time.perf_counter() - t3:.1f} s")
    paths = {"train granite-moe-3b-a800m": trained,
             "train granite-moe-3b-a800m 2 layers (resume)": resumed}
    return ({"serve granite-moe-3b-a800m": served, **{path: n[0] for path, n in paths.items()}},
            {path: n[1] for path, n in paths.items()})


def ptxas_summary(name: str, sources, match: str) -> list:
    """(kernel, registers, spill stores, spill loads) of each entry of a
    built library whose mangled name holds ``match``, from ptxas's report."""
    import re
    from repro_torch.kernels import build
    out, entry, spills = [], None, None
    for line in build.report(name, sources).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        elif "Used" in line and "registers" in line and entry is not None:
            if match in entry:
                kernel = re.search(r"\d+(flash_\w+?)I", entry).group(1)
                out.append((kernel, int(re.search(r"Used (\d+) registers", line).group(1)),
                            *(spills or (0, 0))))
            entry, spills = None, None
    return out


def sdpa_ms(q, k, v, do, iters: int) -> dict:
    """SDPA (causal, H = KH) on these tensors: the default call's forward
    and backward ms and the backend it takes, and each backend's forward
    and backward ms or why it refused."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def times():
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        return (cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                        iters=2 * iters),
                cuda_ms(lambda: torch.autograd.grad(y, (qs, ks, vs), do, retain_graph=True),
                        iters=iters))

    names = {int(b.value): key for key, b in SDPBackend.__members__.items()}
    try:
        default = names.get(int(torch._fused_sdp_choice(q, k, v, is_causal=True)), "unknown")
    except (AttributeError, RuntimeError, TypeError):
        default = "not named"
    fwd, bwd = times()
    res = {"backend": default, "ms": fwd, "backward_ms": bwd, "backends": {}}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([be]):
                f, b = times()
            res["backends"][be.name] = f"{f:.4f} / {b:.4f} ms"
        except RuntimeError as e:
            res["backends"][be.name] = "refused (" + str(e).splitlines()[0][:60] + ")"
    return res


def mla_bounds(B, H, KH, S) -> dict:
    """Least times (ms) of the causal flash at MLA's head dims on an H100 SXM
    (bf16): the forward's two products, B H S^2 (Dhk + Dhv) operations,
    against q, k, v, o once each; the backward's five, B H S^2 (3 Dhk + 2
    Dhv), against q, k, v, o, dO, dQ, dK, dV and lse; the two-pass design's
    seven, B H S^2 (4 Dhk + 3 Dhv): its dK/dV pass four (2 Dhk + 2 Dhv), its
    dQ pass three (2 Dhk + Dhv)."""
    Dhk, Dhv = MLA_DIMS
    sq = B * H * S * S
    f_bytes = 2 * (B * H * S * (Dhk + Dhv) + B * KH * S * (Dhk + Dhv))
    b_bytes = 2 * 2 * (B * H * S * (Dhk + Dhv) + B * KH * S * (Dhk + Dhv)) + 4 * B * H * S
    ms = lambda flops: flops / PEAK_BF16_FLOPS * 1e3  # noqa: E731
    return {"fwd_ops": ms(sq * (Dhk + Dhv)), "fwd_bytes": f_bytes / PEAK_BYTES * 1e3,
            "bwd_ops": ms(sq * (3 * Dhk + 2 * Dhv)), "bwd_bytes": b_bytes / PEAK_BYTES * 1e3,
            "design": ms(sq * (4 * Dhk + 3 * Dhv)),
            "dkdv": ms(sq * (2 * Dhk + 2 * Dhv)), "dq": ms(sq * (2 * Dhk + Dhv))}


def flash_at_mla() -> None:
    """(k): the flash forward and backward at MLA's head dims (192, 128)
    against the plain version on MLA_CASES in fp32 and bf16, each twice and
    equal bit for bit; ptxas's registers and spills of the (192, 128)
    instantiations; then timed at deepseek-v2-lite's training shape beside
    the plain version, SDPA and the bounds, the backward pass by pass."""
    from repro_torch.kernels.flash_attention import (BWD_SOURCES, SOURCES, _forward_kernel,
                                                     backward_errors, flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_backward_plain)
    Dhk, Dhv = MLA_DIMS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    worst = {}
    for B, H, KH, Sq, Sk, causal, q_offset in MLA_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, do = randn(gen, (B, H, Sq, Dhk), dtype), randn(gen, (B, H, Sq, Dhv), dtype)
            k, v = randn(gen, (B, KH, Sk, Dhk), dtype), randn(gen, (B, KH, Sk, Dhv), dtype)
            kw = dict(causal=causal, q_offset=q_offset)
            out, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw)
            f_err = (out.float() - flash_attention(q, k, v, impl="plain", **kw).float()
                     ).abs().max().item()
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(flash_attention(*qkv, **kw), qkv, do)
            got2 = torch.autograd.grad(flash_attention(*qkv, **kw), qkv, do)
            b_err, b_scaled = max(backward_errors(
                got, flash_attention_backward_plain(q, k, v, do, **kw)), key=lambda e: e[1])
            torch.cuda.synchronize()
            same = torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(got, got2))
            say(f"[mla kernel] B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} ({Dhk}, {Dhv}) causal={causal} "
                f"q_offset={q_offset} {str(dtype)[6:]}: forward max_abs_err {f_err:.3e} (tol "
                f"{TOL[dtype]}), backward {'max_abs/max' if dtype == torch.float32 else 'rel_rms'}"
                f" {b_err:.3e} ({b_scaled:.3f} of its tolerance); second call equal: {same}")
            if not (f_err <= TOL[dtype] and b_scaled <= 1 and same):
                raise AssertionError(f"flash at (192, 128) disagrees or repeats unequally: "
                                     f"forward {f_err}, backward {b_err}")
            key = str(dtype)[6:]
            worst[key] = (max(worst.get(key, (0, 0))[0], f_err), max(worst.get(key, (0, 0))[1],
                                                                       b_err))
    del q, k, v, do, out, again, qkv, got, got2
    for name, sources in (("flash_attention", SOURCES), ("flash_attention_bwd", BWD_SOURCES)):
        for kernel, regs, st, ld in ptxas_summary(name, sources, f"ILi{Dhk}ELi{Dhv}E"):
            say(f"[mla kernel] ptxas {kernel}<{Dhk}, {Dhv}>: {regs} registers at launch, spill "
                f"stores {st} bytes, spill loads {ld} bytes")

    B, H, KH, S = MLA_SHAPE
    q, do = randn(gen, (B, H, S, Dhk), torch.bfloat16), randn(gen, (B, H, S, Dhv), torch.bfloat16)
    k, v = randn(gen, (B, KH, S, Dhk), torch.bfloat16), randn(gen, (B, KH, S, Dhv), torch.bfloat16)
    err = (flash_attention(q, k, v, causal=True).float()
           - flash_attention(q, k, v, causal=True, impl="plain").float()).abs().max().item()
    o, lse = _forward_kernel(q, k, v, True, 0, with_lse=True)
    got = flash_attention_backward(q, k, v, o, do, lse, causal=True)
    b_err, b_scaled = max(backward_errors(got, flash_attention_backward_plain(
        q, k, v, do, causal=True)), key=lambda e: e[1])
    same = all(torch.equal(a, b) for a, b in zip(
        got, flash_attention_backward(q, k, v, o, do, lse, causal=True)))
    if not (err <= TOL[torch.bfloat16] and b_scaled <= 1 and same):
        raise AssertionError(f"flash at deepseek's training shape: forward {err}, backward "
                             f"{b_err}, repeat equal {same}")
    del got
    fwd = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain = cuda_ms(lambda: flash_attention(q, k, v, causal=True, impl="plain"), iters=3,
                    warmup=1)
    bwd = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True), iters=10)
    b_plain = cuda_ms(lambda: flash_attention_backward_plain(q, k, v, do, causal=True),
                      iters=3, warmup=1)
    sdpa = sdpa_ms(q, k, v, do, iters=10)
    passes = backward_passes(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=True))
    bd = mla_bounds(B, H, KH, S)
    fwd_bound, bwd_bound = max(bd["fwd_ops"], bd["fwd_bytes"]), max(bd["bwd_ops"], bd["bwd_bytes"])
    say(f"[mla kernel] training shape B={B} H={H} KH={KH} S={S} ({Dhk}, {Dhv}) bf16 causal: "
        f"forward kernel {fwd:.4f} ms, plain {plain:.4f} ms, sdpa {sdpa['ms']:.4f} ms "
        f"(backend {sdpa['backend']}), bound {fwd_bound:.4f} ms (ops {bd['fwd_ops']:.4f}, bytes "
        f"{bd['fwd_bytes']:.4f}), kernel/sdpa {fwd / sdpa['ms']:.3f}, max_abs_err {err:.3e}; "
        f"backward kernel {bwd:.4f} ms, plain {b_plain:.4f} ms (autograd of the plain forward, "
        f"forward included), sdpa backward {sdpa['backward_ms']:.4f} ms, bound "
        f"{bwd_bound:.4f} ms (ops {bd['bwd_ops']:.4f}, bytes {bd['bwd_bytes']:.4f}), two-pass "
        f"design bound {bd['design']:.4f} ms (seven products), kernel/sdpa "
        f"{bwd / sdpa['backward_ms']:.3f}, rel_rms {b_err:.3e}, two calls equal; SDPA by "
        f"backend (forward / backward): {sdpa['backends']}")
    say("[mla kernel] backward by pass at the training shape (torch.profiler, mean of 3 calls): "
        + ("device time not measured" if not passes else
           f"delta {passes.get('delta', float('nan')):.4f} ms, "
           + ", ".join(f"{key} {passes.get(key, float('nan')):.4f} ms (its share of the design "
                       f"bound {bd[key]:.4f})" for key in ("dkdv", "dq"))
           + f"; sum {sum(passes.values()):.4f} ms")
        + f"; worst over the cases (forward max_abs, backward): {worst}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def phase_mla() -> tuple:
    """Phase 12: deepseek-v2-lite-16b. Returns the flash forward's and
    backward's launches on each deepseek path."""
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    t0 = time.perf_counter()
    flash_at_mla()
    tk = time.perf_counter()
    cfg = get_config("deepseek-v2-lite-16b")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[mla prefill] deepseek-v2-lite-16b: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters ({torch.cuda.memory_allocated() / 1e9:.1f} GB bf16; MLA {cfg.n_heads} "
        f"heads, kv_lora_rank {cfg.mla.kv_lora_rank}, head dims {MLA_DIMS}; "
        f"{cfg.moe.n_experts} experts a layer, top {cfg.moe.top_k}, {cfg.moe.n_shared} shared)")
    check_moe_prefill(cfg, model, "deepseek-v2-lite-16b bf16", label="mla prefill")
    time_prefill_and_decode(cfg, model, "mla prefill", prefill_tokens(cfg))
    served, _ = phase_serve(cfg, model, flash_attention, cfg.n_layers, SERVE_PROMPTS,
                            "mla serve")
    say(f"[mla serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    trained = train_moe(MLA_TRAIN_RUN, "mla train")
    t2 = time.perf_counter()
    step_kernel_vs_plain("deepseek-v2-lite-16b")
    t3 = time.perf_counter()
    resumed = resume_exactly(MLA_RESUME_RUN, MLA_RESUME_K,
                             "deepseek-v2-lite-16b (2 layers, full width)")
    say(f"[mla] phase times: (k) {tk - t0:.1f} s, (a) {t1 - tk:.1f} s, (b) {t2 - t1:.1f} s, "
        f"(c) {t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    paths = {"train deepseek-v2-lite-16b": trained,
             "train deepseek-v2-lite-16b 2 layers (resume)": resumed}
    return ({"serve deepseek-v2-lite-16b": served, **{path: n[0] for path, n in paths.items()}},
            {path: n[1] for path, n in paths.items()})


@contextmanager
def annotated(module, names):
    """Run each function ``module.<name>`` inside a torch.profiler range of
    that name, so a profile can sum the device time of the kernels each
    call launched."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def inner(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return inner

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@torch.no_grad()
def jamba_shares(cfg, model, tokens) -> None:
    """(d): one profiled prefill of ``tokens`` and one profiled decode step,
    each one's device busy time split into the Mamba mixers'
    (``apply_mamba``) and the MoE layers' (``apply_moe``) kernels, the
    matrix products (all layers) and the flash kernel."""
    from repro_torch import decode_step, forward
    from repro_torch.models import lm
    S = tokens.shape[1]
    logits, _, caches, _ = forward(cfg, model, {"tokens": tokens}, want_caches=True,
                                   max_len=S + 1)
    nxt = logits[:, -1:, :cfg.vocab_size].argmax(-1)
    calls = (("prefill", lambda: forward(cfg, model, {"tokens": tokens}, want_caches=True,
                                         max_len=S + 1)),
             ("decode step", lambda: decode_step(cfg, model, caches, nxt, S)))
    for name, fn in calls:
        with annotated(lm, ("apply_mamba", "apply_moe")):
            busy, _, inside, kernels = busy_shares(fn, ("apply_mamba", "apply_moe"))
        if not kernels:
            say(f"[jamba shares] {name}: device time not measured")
            continue
        gemm = sum(t for k, t in kernels if "gemm" in k.lower() or "nvjet" in k)
        flash = sum(t for k, t in kernels if "flash_fwd" in k)
        say(f"[jamba shares] {name} B={tokens.shape[0]} S={S}: device busy {busy:.2f} ms; of "
            f"busy: Mamba mixers {inside['apply_mamba'] / busy:.4f} "
            f"({inside['apply_mamba']:.2f} ms), MoE {inside['apply_moe'] / busy:.4f} "
            f"({inside['apply_moe']:.2f} ms), matrix products (all layers) {gemm / busy:.4f} "
            f"({gemm:.2f} ms), flash kernel {flash / busy:.4f} ({flash:.3f} ms)")


@torch.no_grad()
def mamba_alone() -> None:
    """(c): one full-width Mamba layer of jamba (Di 16384, N 16), seeded
    random weights. The log-depth scan's prefill of MAMBA_CHECK (output,
    final ssm and conv states) against as many steps of the recurrence from
    a zero state, in fp32 (MAMBA_TOL of each tensor's largest entry) and
    bf16 (PREFILL_TOL); then, in bf16, the prefill of MAMBA_TIMED timed
    (device ms, kernels, peak memory above the inputs, the scan's own time)
    and one decode step."""
    from repro_torch import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import pdtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    base = get_config("jamba-1.5-large-398b").with_(n_layers=JAMBA_LAYERS)
    B, S = MAMBA_CHECK
    for dtype in ("float32", "bfloat16"):
        cfg = base.with_(dtype=dtype)
        p = ssm.init_mamba(gen, cfg, "cuda")
        x = randn(gen, (B, S, cfg.d_model), pdtype(cfg))
        y, st = ssm.apply_mamba(p, x, cfg, want_state=True)
        state = ssm.init_mamba_state(cfg, B, "cuda")
        steps = torch.cat([ssm.apply_mamba(p, x[:, t:t + 1], cfg, state=state)[0]
                           for t in range(S)], dim=1)
        errs = {}
        for key, a, b in (("y", y, steps), ("ssm", st["ssm"], state["ssm"]),
                          ("conv", st["conv"], state["conv"])):
            d = (a.float() - b.float())
            errs[key] = {"rel_max": (d.abs().max() / b.float().abs().max()).item(),
                         "max_abs": d.abs().max().item(),
                         "rel_rms": (d.norm() / b.float().norm()).item()}
        if dtype == "float32":
            ok = all(e["rel_max"] <= MAMBA_TOL for e in errs.values())
            tol = f"rel_max {MAMBA_TOL}"
        else:
            tol = PREFILL_TOL[torch.bfloat16]
            ok = all(e[key] <= limit for e in errs.values() for key, limit in tol.items())
        n_params = sum(t.numel() for t in p.parameters())
        say(f"[jamba mamba] one full-width layer ({n_params / 1e9:.3f} B parameters) {dtype} "
            f"B={B} S={S}: scan prefill vs {S} recurrence steps "
            + "; ".join(f"{key} rel_max {e['rel_max']:.3e} max_abs {e['max_abs']:.3e} rel_rms "
                        f"{e['rel_rms']:.3e}" for key, e in errs.items()) + f" (tol {tol})")
        if not ok:
            raise AssertionError(f"Mamba's scan disagrees with its recurrence ({dtype}): {errs}")
        del p, x, y, st, state, steps
    torch.cuda.empty_cache()

    cfg = base
    p = ssm.init_mamba(gen, cfg, "cuda")
    B, S = MAMBA_TIMED
    x = randn(gen, (B, S, cfg.d_model), torch.bfloat16)
    prefill = lambda: ssm.apply_mamba(p, x, cfg, want_state=True)  # noqa: E731
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, state = prefill()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    ms = cuda_ms(prefill, iters=3, warmup=1)
    busy, n, _, kernels = busy_shares(prefill, ())
    Di, _, N = ssm._dims(cfg)
    dA = torch.rand((B, S, Di, N), generator=gen, device="cuda")
    dBx = torch.randn((B, S, Di, N), generator=gen, device="cuda")
    scan_ms = cuda_ms(lambda: ssm.selective_scan(dA, dBx), iters=3, warmup=1)
    del dA, dBx
    x1 = randn(gen, (B, 1, cfg.d_model), torch.bfloat16)
    decode = lambda: ssm.apply_mamba(p, x1, cfg, state=state)  # noqa: E731
    d_ms = cuda_ms(decode, iters=20)
    d_busy, d_n, _, d_kernels = busy_shares(decode, ())
    flops = 2 * B * S * sum(t.numel() for t in (p.m_in, p.m_xproj, p.m_dt, p.m_out))
    say(f"[jamba mamba] prefill B={B} S={S} bf16: {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
        f"in its projections, whose bound is {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms); "
        + ("device time not measured" if not kernels else
           f"device busy {busy:.2f} ms in {n} kernels")
        + f"; peak memory {peak:.2f} GiB above its inputs; the log-depth scan alone on "
        f"(1, {S}, {Di}, {N}) fp32 {scan_ms:.2f} ms ({math.ceil(math.log2(S))} steps); "
        f"one decode step {d_ms:.3f} ms, "
        + ("device time not measured" if not d_kernels else
           f"busy {d_busy:.3f} ms in {d_n} kernels"))
    del p, x, x1, state
    torch.cuda.empty_cache()


def phase_jamba() -> int:
    """Phase 13: jamba-1.5-large-398b at full width, 5 of 72 layers, served.
    Returns the flash forward's launches on its served path."""
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import layer_kinds
    cfg = get_config("jamba-1.5-large-398b").with_(n_layers=JAMBA_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[jamba] {cfg.name}: {cfg.n_layers} of 72 layers ({', '.join(layer_kinds(cfg))}), "
        f"{n_params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"bf16, made in {t_build:.1f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB while made (d_model {cfg.d_model}, Mamba d_inner "
        f"{cfg.mamba.expand * cfg.d_model} d_state {cfg.mamba.d_state}; {cfg.n_heads} q heads "
        f"over {cfg.n_kv_heads} kv; {cfg.moe.n_experts} experts of {cfg.moe.d_expert}, top "
        f"{cfg.moe.top_k})")
    check_moe_prefill(cfg, model, "jamba-1.5-large-398b bf16", label="jamba prefill")
    t1 = time.perf_counter()
    tokens = prefill_tokens(cfg)
    time_prefill_and_decode(cfg, model, "jamba prefill", tokens)
    jamba_shares(cfg, model, tokens)
    torch.cuda.reset_peak_memory_stats()
    served, _ = phase_serve(cfg, model, flash_attention, attention_layers(cfg), SERVE_PROMPTS,
                            "jamba serve")
    say(f"[jamba serve] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    mamba_alone()
    say(f"[jamba] phase times: (a, b) {t1 - t0:.1f} s, (d) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s")
    return served


def frames_for(cfg, gen: torch.Generator, B: int) -> torch.Tensor:
    """(B, enc_len, D) frame embeddings in the config's dtype, seeded."""
    from repro_torch.models.layers import pdtype
    return randn(gen, (B, cfg.encdec.enc_len, cfg.d_model), pdtype(cfg))


def patches_for(cfg, gen: torch.Generator, B: int) -> torch.Tensor:
    """(B, n_patches, D) patch embeddings in the config's dtype, seeded."""
    from repro_torch.models.layers import pdtype
    return randn(gen, (B, cfg.vlm.n_patches, cfg.d_model), pdtype(cfg))


@torch.no_grad()
def greedy_stream(cfg, model, batch, n_new: int, impl=None) -> tuple:
    """The model's own served path: ``forward(want_caches=True)`` over
    ``batch`` (``impl="plain"``: attention and the mLSTM both plain), then
    ``n_new - 1`` greedy ``decode_step``s after the prefix and the text.
    Returns (tokens (B, n_new), each step's top-2 margin (B, n_new), the
    prefill's logits)."""
    from repro_torch import decode_step, forward
    B, S = batch["tokens"].shape
    P = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
    logits, _, caches, n_prefix = forward(cfg, model, batch, want_caches=True,
                                          max_len=P + S + n_new, attn_impl=impl,
                                          mlstm_impl=impl)
    if n_prefix != P:
        raise AssertionError(f"n_prefix {n_prefix}, want {P}")
    first = logits
    outs, margins = [], []
    for t in range(n_new):
        top = logits[:, -1, :cfg.vocab_size].float().topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        outs.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
        if t + 1 < n_new:
            logits, caches = decode_step(cfg, model, caches, outs[-1][:, None], P + S + t)
    return torch.stack(outs, 1), torch.stack(margins, 1), first


def served_batch(cfg, model, batch, n_new: int, tag: str, main_path: bool = True) -> int:
    """The served batch on the model's own entry points, as a main path: the
    flash counts set to 0 just before the kernel run and read just after
    (without ``main_path``, inside a longer main path, they are left as
    they are and the run's launches read as a difference). Its stream
    against the plain prefill's: equal, or parting first at a near-tie,
    where the plain run's top-2 margin is within twice the two prefills'
    largest logit difference. Returns the kernel's launches in the run."""
    from repro_torch.kernels.flash_attention import flash_attention
    B = batch["tokens"].shape[0]
    greedy_stream(cfg, model, batch, 2)                 # warm-up
    torch.cuda.synchronize()
    if main_path:
        flash_attention.launches = flash_attention.backward_launches = 0    # main path
    f0, b0 = flash_attention.launches, flash_attention.backward_launches
    t0 = time.perf_counter()
    toks, _, logits = greedy_stream(cfg, model, batch, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_attention.launches - f0                            # ends
    bwd = flash_attention.backward_launches - b0
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or bwd:
        raise AssertionError(f"{tag}: bad tokens or a backward launch")
    say(f"[{tag}] served batch B={B} x {n_new} new tokens on forward + decode_step: "
        f"{dt:.3f} s, {B * n_new / dt:.1f} tokens/s; flash launches {launches}; the stream "
        + against_plain(cfg, model, batch, toks, logits, tag))
    return launches


def against_plain(cfg, model, batch, toks, logits, tag: str) -> str:
    """A served stream ``toks`` (B, n_new), its prefill's ``logits``, against
    the plain prefill's greedy stream: equal, or parting first at a
    near-tie, where the plain run's top-2 margin is within twice the two
    prefills' largest logit difference; otherwise it fails. Says which."""
    ptoks, pmargins, plogits = greedy_stream(cfg, model, batch, toks.shape[1], impl="plain")
    diff = (logits.float() - plogits.float()).abs().max().item()
    parted = (toks != ptoks).any(0).nonzero()
    if not len(parted):
        return "equals the plain prefill's"
    at = int(parted[0])
    rows = (toks[:, at] != ptoks[:, at]).nonzero()[:, 0]
    worst = pmargins[rows, at].max().item()
    if worst > 2 * diff:
        raise AssertionError(f"{tag}: the streams part at step {at}, the plain margin "
                             f"{worst} above twice the prefills' difference {diff}")
    return (f"parts from the plain prefill's at step {at} of {toks.shape[1]}, a near-tie "
            f"(plain top-2 margin {worst:.4f} within twice the prefills' logit difference "
            f"{diff:.4f})")


def flash_at_whisper() -> None:
    """(e): the flash forward and backward at whisper's encoder shape
    (non-causal over 1500 keys, no multiple of a tile) and its cross shape
    (32 queries over 1500 keys, no mask), bf16, against the plain version;
    each timed beside the plain version, SDPA and the bound: forward 4 B H
    Sq Sk Dh operations (no mask halves them), backward 10 B H Sq Sk Dh,
    against each tensor once at the memory rate."""
    from repro_torch.kernels.flash_attention import (_forward_kernel, backward_errors,
                                                     flash_attention, flash_attention_backward,
                                                     flash_attention_backward_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    for name, (B, H, KH, Sq, Sk, Dh) in WHISPER_SHAPES.items():
        q = randn(gen, (B, H, Sq, Dh), torch.bfloat16)
        k, v = randn(gen, (B, KH, Sk, Dh), torch.bfloat16), randn(gen, (B, KH, Sk, Dh), torch.bfloat16)
        do = randn(gen, (B, H, Sq, Dh), torch.bfloat16)
        err = (flash_attention(q, k, v, causal=False).float()
               - flash_attention(q, k, v, causal=False, impl="plain").float()).abs().max().item()
        o, lse = _forward_kernel(q, k, v, False, 0, with_lse=True)
        got = flash_attention_backward(q, k, v, o, do, lse, causal=False)
        again = flash_attention_backward(q, k, v, o, do, lse, causal=False)
        b_err, b_scaled = max(backward_errors(got, flash_attention_backward_plain(
            q, k, v, do, causal=False)), key=lambda e: e[1])
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not (err <= TOL[torch.bfloat16] and b_scaled <= 1 and same):
            raise AssertionError(f"flash at whisper's {name} shape: forward {err}, backward "
                                 f"{b_err}, repeat equal {same}")
        del got, again
        fwd = cuda_ms(lambda: flash_attention(q, k, v, causal=False), iters=20)
        plain = cuda_ms(lambda: flash_attention(q, k, v, causal=False, impl="plain"),
                        iters=3, warmup=1)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=20)
        bwd = cuda_ms(lambda: flash_attention_backward(q, k, v, o, do, lse, causal=False),
                      iters=10)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        plain_bwd = cuda_ms(lambda: torch.autograd.grad(
            flash_attention(qs, ks, vs, causal=False, impl="plain"), (qs, ks, vs), do),
            iters=3, warmup=1)
        y = F.scaled_dot_product_attention(qs, ks, vs)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(y, (qs, ks, vs), do, retain_graph=True),
                           iters=10)
        qkvo = B * H * Sq * Dh, B * KH * Sk * Dh
        f_ops = 4 * B * H * Sq * Sk * Dh / PEAK_BF16_FLOPS * 1e3
        f_bytes = 2 * 2 * sum(qkvo) / PEAK_BYTES * 1e3
        b_ops = 10 * B * H * Sq * Sk * Dh / PEAK_BF16_FLOPS * 1e3
        b_bytes = (2 * 4 * sum(qkvo) + 4 * B * H * Sq) / PEAK_BYTES * 1e3
        say(f"[whisper kernel] {name} shape B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} Dh={Dh} bf16 "
            f"non-causal: forward kernel {fwd:.4f} ms, plain {plain:.4f} ms, sdpa {sdpa:.4f} "
            f"ms, bound {max(f_ops, f_bytes):.4f} ms (ops {f_ops:.4f}, bytes {f_bytes:.4f}), "
            f"max_abs_err {err:.3e}; backward kernel {bwd:.4f} ms, plain (autograd, forward "
            f"included) {plain_bwd:.4f} ms, sdpa backward {sdpa_bwd:.4f} ms, bound "
            f"{max(b_ops, b_bytes):.4f} ms (ops {b_ops:.4f}, bytes {b_bytes:.4f}), rel_rms "
            f"{b_err:.3e}, two calls equal")
        del q, k, v, do, o, lse, qs, ks, vs, y
        torch.cuda.empty_cache()


def train_whisper(cfg) -> tuple:
    """(d): whisper-small at full size trained WHISPER_TRAIN["steps"] steps
    by ``make_train_step`` (bf16, AdamW with fp32 master and moments, remat
    full), a fresh batch of tokens and frames each step, as a main path:
    the flash kernels launched twice (remat full) and once backward an
    encoder layer, self and cross attention layer a step. The first loss
    is held against the plain version's on the same weights and batch
    (BF16_STEP_TOL's loss); with the head tied to the embedding it starts
    far above ln V, as xlstm-1.3b's does (ROADMAP Queue 3, item 7). Then
    one more step timed and profiled for the idle share. Returns the
    (forward, backward) launches."""
    from repro_torch import init_params, loss_fn
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.step import BF16_STEP_TOL
    B, S, steps = WHISPER_TRAIN["batch"], WHISPER_TRAIN["seq"], WHISPER_TRAIN["steps"]
    model = init_params(cfg, seed=0, trainable=True)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = adamw_init(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    batches = []
    for _ in range(steps + 1):
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "frames": frames_for(cfg, gen, B)})
    with torch.no_grad():
        plain0 = float(loss_fn(cfg, model, batches[0], attn_impl="plain")[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.backward_launches = 0    # main path
    losses, seconds = [], []
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        losses.append(float(step_fn(model, state, batch)[2]["loss"]))
        seconds.append(time.perf_counter() - t0)
    got = (flash_attention.launches, flash_attention.backward_launches)   # ... ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_attn = cfg.encdec.enc_layers + 2 * cfg.n_layers
    want = ({"none": 1, "full": 2}[cfg.remat] * n_attn * steps, n_attn * steps)
    ln_v = math.log(cfg.vocab_size)
    if got != want or not (all(math.isfinite(x) for x in losses)
                           and abs(losses[0] - plain0) <= BF16_STEP_TOL["loss"]):
        raise AssertionError(f"whisper training: launches {got} (want {want}), losses "
                             f"{losses}, the plain version's first {plain0}")
    fn = lambda: float(step_fn(model, state, batches[steps])[2]["loss"])  # noqa: E731
    fn()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    kernels = device_kernels(fn)
    busy = sum(t for _, t in kernels) / 1e3
    flash = sum(t for name, t in kernels if "flash_" in name) / 1e3
    step_s = statistics.median(seconds[1:])
    share = "device time not measured" if not kernels else (
        f"one more step {wall:.3f} s unprofiled, device busy {busy:.3f} s in {len(kernels)} "
        f"kernels, idle share {1 - busy / wall:.3f}, flash kernels {flash / busy:.4f} of busy")
    say(f"[whisper train] {cfg.name} full size, batch {B} x {S} tokens with {cfg.encdec.enc_len} "
        f"frames each, remat {cfg.remat}, bf16, AdamW fp32 master and moments: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (the plain version's first {plain0:.4f}; "
        f"ln V = {ln_v:.4f}, the tied head starts above it); step times "
        + ", ".join(f"{t:.3f}" for t in seconds) + f" s, median after the first {step_s:.3f} s, "
        f"{B * S / step_s:.0f} text tokens/s; peak memory {peak:.2f} GiB; flash launches "
        f"{got[0]} forward, {got[1]} backward (want {want}); {share}")
    del model, state, step_fn, batches
    torch.cuda.empty_cache()
    return got


def phase_whisper() -> tuple:
    """Phase 14: whisper-small at full size. Returns the flash forward's and
    backward's launches on each whisper path."""
    from repro_torch import get_config, init_params
    t0 = time.perf_counter()
    flash_at_whisper()
    cfg = get_config("whisper-small")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"[whisper] {cfg.name}: {cfg.n_layers} decoder layers (self and cross attention), "
        f"{cfg.encdec.enc_layers} encoder layers over {cfg.encdec.enc_len} frames, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, Dh {cfg.head_dim_}: {n_params / 1e9:.3f} B "
        f"parameters, {n_bytes / 2 ** 30:.3f} GiB bf16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(42)
    B, S = WHISPER_PROMPT
    tokens = prefill_tokens(cfg, WHISPER_PROMPT)
    frames = frames_for(cfg, gen, B)
    batch = {"tokens": tokens, "frames": frames}
    n_flash = cfg.encdec.enc_layers + 2 * cfg.n_layers
    check_moe_prefill(cfg, model, "whisper-small bf16", label="whisper prefill", batch=batch,
                      n_flash=n_flash)
    t1 = time.perf_counter()
    served = served_batch(cfg, model, batch, WHISPER_NEW, "whisper serve")
    if served != n_flash:
        raise AssertionError(f"whisper's served batch launched the kernel {served} times")
    time_prefill_and_decode(cfg, model, "whisper serve", tokens, extra={"frames": frames})
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    trained = train_whisper(cfg)
    step_kernel_vs_plain("whisper-small", n_layers=None, shape=(B, WHISPER_TRAIN["seq"]),
                         extra=lambda cfg, gen, B: {"frames": frames_for(cfg, gen, B)},
                         want_bwd=n_flash)
    say(f"[whisper] phase times: (a, b, e) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, (d) "
        f"{time.perf_counter() - t2:.1f} s")
    return {"serve whisper-small": served, "train whisper-small": trained[0]}, \
        {"train whisper-small": trained[1]}


def phase_llava() -> dict:
    """Phase 15: llava-next-34b at full width and depth (60 layers), served;
    its 2-layer train step with the vision prefix against plain. Returns the
    flash forward's launches on each llava path."""
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = get_config("llava-next-34b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"[llava] {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters "
        f"({cfg.n_heads_padded} q-head slots, {cfg.n_heads} real, over {cfg.n_kv_heads} kv, Dh "
        f"{cfg.head_dim_}; vision_proj {cfg.d_model} x {cfg.d_model}), {held / 2 ** 30:.2f} "
        f"GiB bf16, made in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB while made")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(44)
    B, S = LLAVA_PROMPT
    tokens = prefill_tokens(cfg, LLAVA_PROMPT)
    patches = patches_for(cfg, gen, B)
    batch = {"tokens": tokens, "vision_embeds": patches}
    check_moe_prefill(cfg, model, "llava-next-34b bf16", label="llava prefill", batch=batch)
    t1 = time.perf_counter()
    served = served_batch(cfg, model, batch, LLAVA_NEW, "llava serve")
    if served != cfg.n_layers:
        raise AssertionError(f"llava's served batch launched the kernel {served} times")
    time_prefill_and_decode(cfg, model, "llava serve", tokens, extra={"vision_embeds": patches})
    bound = held / PEAK_BYTES * 1e3
    say(f"[llava serve] a decode step reads the {held / 2 ** 30:.2f} GiB of weights: its bytes "
        f"bound is {bound:.2f} ms at {PEAK_BYTES / 1e12:.2f} TB/s")
    torch.cuda.reset_peak_memory_stats()
    text, _ = phase_serve(cfg, model, flash_attention, cfg.n_layers, SERVE_PROMPTS,
                          "llava serve")
    say(f"[llava serve] peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    step_kernel_vs_plain("llava-next-34b", n_layers=2, shape=LLAVA_STEP,
                         extra=lambda cfg, gen, B: {"vision_embeds": patches_for(cfg, gen, B)},
                         want_bwd=2)
    say(f"[llava] phase times: (a, b) {t1 - t0:.1f} s, (c, d) {t2 - t1:.1f} s, (e) "
        f"{time.perf_counter() - t2:.1f} s")
    return {"serve llava-next-34b image prefix": served, "serve llava-next-34b": text}


def mesh_step() -> tuple:
    """(a)-(c) of phase 16: one rank started from an in-process HashStore,
    the (1, 1) host mesh; under it qwen3-8b's parameters and ZeRO-1 AdamW
    state placed by the rules as DTensors and one ZeRO-1 step through the
    flash kernels (a main path, counted), held bit for bit against the step
    without a mesh from the same parameters and batch. Returns the flash
    forward's and backward's launches."""
    import torch.distributed as dist
    from repro_torch import get_config, init_params
    from repro_torch.distributed import distribute, param_shardings, use_mesh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import (AdamWConfig, adamw_init, local_batch, make_train_step,
                                   make_zero1_train_step, opt_state_shardings,
                                   zero1_adamw_init)
    cfg = get_config(MESH_STEP["config"]).with_(n_layers=MESH_STEP["n_layers"])
    B, S = MESH_STEP["shape"]
    opt_cfg = AdamWConfig(lr=STEP_LR, weight_decay=0.01)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    backend = dist.get_backend()
    say(f"[mesh] host mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
        f"{mesh.device_type}, {backend} group of {dist.get_world_size()} rank (HashStore "
        f"rendezvous) in {time.perf_counter() - t0:.2f} s")
    if tuple(mesh.mesh.shape) != (1, 1) or mesh.device_type != "cuda":
        raise AssertionError(f"the host mesh is {mesh}")
    torch.use_deterministic_algorithms(True)         # the embedding's gradient sums
    try:
        ref = init_params(cfg, seed=5, trainable=True)
        ref_state = adamw_init(ref, opt_cfg)
        _, ref_state, rm = make_train_step(cfg, opt_cfg)(ref, ref_state, batch)
        with use_mesh(mesh):
            model = init_params(cfg, seed=5, trainable=True)
            psh = param_shardings(cfg, model, mesh)
            shared = whole = 0
            for name, p in model.named_parameters():
                d = distribute(p.detach(), psh[name], mesh)
                whole += torch.equal(d.to_local(), p)
                shared += d.to_local().data_ptr() == p.data_ptr()
            n = len(psh)
            osh = opt_state_shardings(cfg, model, mesh, opt_cfg)
            state = zero1_adamw_init(cfg, model, opt_cfg, osh, mesh)
            step = make_zero1_train_step(cfg, opt_cfg, mesh, osh)
            flash_attention.launches = flash_attention.backward_launches = 0  # main path
            t0 = time.perf_counter()
            _, state, zm = step(model, state, local_batch(batch, mesh))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = (flash_attention.launches, flash_attention.backward_launches)  # ... ends
    finally:
        torch.use_deterministic_algorithms(False)
    want = (2 * cfg.n_layers, cfg.n_layers)        # remat full: forward twice a layer
    differ = [name for name, p in model.named_parameters()
              if not torch.equal(p, dict(ref.named_parameters())[name])]
    for key in ("m", "v", "master"):
        differ += [f"{key} {name}" for name, d in state[key].items()
                   if not torch.equal(d.to_local(), ref_state[key][name])]
    same = (float(zm["loss"]) == float(rm["loss"])
            and float(zm["grad_norm"]) == float(rm["grad_norm"]))
    say(f"[mesh] {cfg.name} {cfg.n_layers} layers under the mesh: {whole} of {n} "
        f"parameters placed whole by param_shardings ({shared} sharing the "
        f"parameter's storage); ZeRO-1 state m, v, master of {len(osh['m'])} tensors "
        f"each; one ZeRO-1 step B={B} S={S} in {seconds:.3f} s, flash forward launches "
        f"{got[0]} (want {want[0]}), backward {got[1]} (want {want[1]}); loss "
        f"{float(zm['loss']):.6f} / {float(rm['loss']):.6f} without a mesh, grad norm "
        f"{float(zm['grad_norm']):.6f} / {float(rm['grad_norm']):.6f}; "
        f"{len(differ)} tensors differ bit for bit")
    del ref, ref_state, model, state, step
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    if got != want:
        raise AssertionError(f"the mesh step launched the flash kernels {got} times, "
                             f"want {want}")
    if whole != n or differ or not same:
        raise AssertionError(f"the mesh step differs from the step without a mesh: "
                             f"{differ[:8]}")
    return got


def dryrun_cells() -> None:
    """(d) of phase 16: the dry run's DRYRUN_CELLS on both production meshes
    (the meta device: no card, no process group), a line a cell."""
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    for arch, shape in DRYRUN_CELLS:
        pair = [run_cell(arch, shape, mp) for mp in (False, True)]
        for r in pair:
            if r["status"] != "ok":
                raise AssertionError(f"dry run {arch} {shape}: {r}")
            gib = {k: round(v / 2 ** 30, 3) for k, v in r["memory"]["bytes_per_device"].items()}
            say(f"[dryrun] {arch} {shape} {r['mesh']}: {r['flops_per_device']:.4e} FLOPs a "
                f"device (counted in {r['count_s']:.2f} s), model_flops ratio "
                f"{r['useful_flops_ratio']:.4f}, GiB a device {gib}, compute "
                f"{r['roofline']['compute_s']:.4e} s, memory {r['roofline']['memory_s']:.4e} "
                f"s (H100 datasheet)")
            # a step multiplies each active parameter at least once a token
            # (three times in training), so the counted FLOPs are at least
            # model_flops: a count that missed a loop's trips falls below
            if not (r["flops_per_device"] > 0 and 0 < r["useful_flops_ratio"] <= 1
                    and all(v > 0 for v in r["memory"]["bytes_per_device"].values())):
                raise AssertionError(f"dry run {arch} {shape} {r['mesh']}: {r}")
    say(f"[dryrun] {2 * len(DRYRUN_CELLS)} cells in {time.perf_counter() - t0:.1f} s")


def phase_mesh() -> tuple:
    """Phase 16: the host-mesh ZeRO-1 step and the dry run's cells. Returns
    the step's flash launches (forward, backward)."""
    got = mesh_step()
    dryrun_cells()
    return got


def run_example(name: str, *args) -> tuple:
    """examples/<name> run in this process as ``python examples/<name>
    args`` would run it (runpy, sys.argv set): its own assertions hold or
    the run fails. Its output is echoed line by line, also when it fails;
    returns (output, seconds)."""
    import contextlib
    import io
    import runpy
    path = ROOT / "examples" / name
    argv, buf = sys.argv, io.StringIO()
    sys.argv = [str(path), *args]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:                        # echoed also when the example fails
        sys.argv = argv
        for line in buf.getvalue().splitlines():
            say(f"[examples] {name}: {line}")
    return buf.getvalue(), seconds


def phase_examples() -> tuple:
    """Phase 17: the examples' twins on the card, in this process. The serve
    and train twins are main paths: the flash kernels' counts are set to 0
    just before each and read just after. Returns ({path: forward launches},
    {path: backward launches})."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    fwd, bwd = {}, {}
    for name, args in (("serve_torch.py", ()), ("train_e2e_torch.py", EXAMPLE_TRAIN_ARGS)):
        path = f"example {name.removesuffix('.py')}"
        flash_attention.launches = flash_attention.backward_launches = 0   # main path starts
        mlstm_chunk.launches = mlstm_chunk.backward_launches = 0
        out, seconds = run_example(name, *args)
        fwd[path], bwd[path] = flash_attention.launches, flash_attention.backward_launches
        if mlstm_chunk.launches or mlstm_chunk.backward_launches or not fwd[path]:
            raise AssertionError(f"{path}: flash {fwd[path]}, mLSTM {mlstm_chunk.launches}")
        if name.startswith("train"):
            steps = int(EXAMPLE_TRAIN_ARGS[1])
            if (fwd[path], bwd[path]) != (4 * steps, 4 * steps):  # 4 layers, remat none
                raise AssertionError(f"{path}: flash launched {fwd[path]} forward, "
                                     f"{bwd[path]} backward, want {4 * steps} each")
            losses = [float(line.split()[3]) for line in out.splitlines()
                      if line.startswith("step ")]
            tail = f"logged mean losses {losses}"
        else:
            served = next(line for line in out.splitlines() if line.startswith("engine served"))
            tail = f"'{served}'"
        say(f"[examples] {path}: {seconds:.2f} s; flash forward launches {fwd[path]}, "
            f"backward {bwd[path]}; {tail}")
    for name in ("agents_on_streams_torch.py", "quickstart_torch.py"):
        before = flash_attention.launches + mlstm_chunk.launches
        _, seconds = run_example(name)
        if flash_attention.launches + mlstm_chunk.launches != before:
            raise AssertionError(f"{name} launched a kernel: the log is host code")
        say(f"[examples] {name.removesuffix('.py')}: {seconds:.2f} s")
    return fwd, bwd


def phase_costs(timed: dict) -> None:
    """Phase 18: ServeCosts.for_models(qwen3-8b, smollm-135m) at phase 3's
    batch and context, on the H100 roofline, beside phase 3's measured
    decode step. The printed figures are the reference's formulas; the
    gate's floor leaves out the rows of an untied embedding table that a
    decode step does not read (decode_cost charges the whole table), so it
    is a lower bound, and a busy step under it, or no busy time, fails."""
    from repro_torch import get_config
    from repro_torch.serve import ServeCosts
    from repro_torch.serve.costs import Cost, decode_cost, roofline_seconds
    B, S = timed["B"], timed["S"]
    target, draft = get_config("qwen3-8b"), get_config("smollm-135m")
    c = ServeCosts.for_models(target, draft, batch=B, context=S)
    cost = decode_cost(target, B, S)
    say(f"[costs] ServeCosts.for_models(qwen3-8b, smollm-135m, batch={B}, context={S}), "
        f"reckoned on the H100 roofline: prefill {c.prefill_per_token * 1e3:.6f} ms a token, "
        f"decode step {c.decode_step * 1e3:.6f} ms, draft step {c.draft_step * 1e3:.6f} ms, "
        f"verify(k) for k=0..4 "
        f"{[round(c.verify(k) * 1e3, 6) for k in range(5)]} ms")
    say(f"[costs] qwen3-8b decode step's cost: {cost.flops:.6e} FLOP "
        f"({cost.flops / PEAK_BF16_FLOPS * 1e3:.6f} ms), {cost.bytes:.6e} B "
        f"({cost.bytes / PEAK_BYTES * 1e3:.6f} ms): bound by "
        f"{'bytes' if cost.bytes / PEAK_BYTES > cost.flops / PEAK_BF16_FLOPS else 'operations'}")
    unread = 0 if target.tie_embeddings else (target.padded_vocab - B) * target.d_model * 2
    floor = roofline_seconds(Cost(flops=cost.flops, bytes=cost.bytes - unread)) * 1e3
    eager, busy = timed["decode_step"]
    if busy is None:
        raise AssertionError("phase 3's decode step has no device-busy time to hold "
                             "against the roofline")
    say(f"[costs] qwen3-8b decode step B={B} S={S} measured in phase 3: {eager:.4f} ms eager, "
        f"busy {busy:.4f} ms; busy / roofline {busy / (c.decode_step * 1e3):.4f}; the gate's "
        f"floor {floor:.6f} ms (the roofline less {unread:.6e} B of embedding rows a step "
        f"does not read), busy / floor {busy / floor:.4f}")
    if busy < floor:
        raise AssertionError(f"the measured decode step (busy {busy:.4f} ms) is under its "
                             f"floor ({floor:.4f} ms)")


def flash_per_forward(cfg) -> int:
    """The flash kernel's launches in one forward: one an attention or MLA
    layer, and an encoder-decoder's encoder and cross attention besides."""
    if cfg.is_encdec:
        return cfg.encdec.enc_layers + 2 * cfg.n_layers
    return attention_layers(cfg)


def smoke_extra(cfg, gen: torch.Generator, B: int) -> dict:
    """The batch entries a config needs beside its tokens: whisper's frames,
    llava's vision prefix."""
    if cfg.is_encdec:
        return {"frames": frames_for(cfg, gen, B)}
    if cfg.vlm is not None:
        return {"vision_embeds": patches_for(cfg, gen, B)}
    return {}


def engine_stream(cfg, model, tokens: torch.Tensor, n_new: int) -> torch.Tensor:
    """``tokens`` (B, S) as B requests on a fresh log, served in one batch by
    ServeEngine; the (B, n_new) tokens of the response stream."""
    from repro_torch.core import BoltSystem
    from repro_torch.serve import ServeEngine, decode_response
    from repro_torch.streams import Producer, Topic
    system = BoltSystem(n_brokers=2)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    prod = Producer(req)
    for i, row in enumerate(tokens.tolist()):
        prod.produce({"id": f"r{i}", "prompt": row})
    prod.flush()
    B = tokens.shape[0]
    served = ServeEngine(cfg, model, req, resp, batch_size=B).poll_and_serve(gen_tokens=n_new)
    out = decode_response(resp.log.read(0, resp.log.visible_tail))
    if served != B or sorted(out) != sorted(f"r{i}" for i in range(B)):
        raise AssertionError(f"{cfg.name}: the engine served {served}: {sorted(out)}")
    return torch.tensor([out[f"r{i}"] for i in range(B)], device=tokens.device)


def phase_smoke() -> tuple:
    """Phase 19: every registered config at its smoke config (the CPU
    tests' configurations; head dims 8, 12, 16 and MLA's (24, 16), run by
    the (16, 16) and (32, 32) instantiations), seeded. (a) The forward
    through the kernels against the plain path on the same weights, in the
    config's dtype (bf16) and again in fp32: each flash call against plain
    on its inputs at TOL, the logits within 3x the floor of two plain
    forwards or PREFILL_TOL, an MoE config also against a plain forward
    routed as the kernel's (xlstm: phase 7's mLSTM checks); (b) 4 requests
    of 16 tokens, 4 new each, served by ServeEngine on the port's log, the
    greedy streams equal to the plain prefill's (whisper through forward
    with its frames and decode_step, quirk 15; llava through the engine and
    with its image prefix); (c) one train step through the kernels against
    the plain step at train/step.py's tolerances, fp32 and bf16. A main
    path: the counts are set to 0 before the first config and read after
    the last, and nothing inside sets them again: each config's launches
    are read as differences, its served prefills' held to one launch a
    flash or mLSTM layer each, and their sum to the phase's count. Returns
    (flash forward, flash backward, mLSTM forward, mLSTM backward)
    launches."""
    from repro_torch import ARCHS, get_smoke_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.models.lm import layer_kinds
    n_req, prompt, n_new = SMOKE_SERVE
    counts = lambda: (flash_attention.launches, flash_attention.backward_launches,  # noqa
                      mlstm_chunk.launches, mlstm_chunk.backward_launches)
    summed = [0, 0, 0, 0]
    flash_attention.launches = flash_attention.backward_launches = 0     # main path starts
    mlstm_chunk.launches = mlstm_chunk.backward_launches = 0
    for arch in ARCHS:
        t0 = time.perf_counter()
        at_start = counts()
        base = get_smoke_config(arch)
        n_flash = flash_per_forward(base)
        n_mlstm = layer_kinds(base).count("mlstm")
        for dtype in (base.dtype, "float32"):
            cfg = base.with_(dtype=dtype)
            model = init_params(cfg, seed=19)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(19)
            tokens = prefill_tokens(cfg)
            batch = {"tokens": tokens, **smoke_extra(cfg, gen, tokens.shape[0])}
            tag = f"{arch} smoke {dtype}"
            if n_mlstm:
                check_xlstm_prefill(cfg, model, tag, n_mlstm)
            else:
                check_moe_prefill(cfg, model, tag, label="smoke prefill", batch=batch,
                                  n_flash=n_flash)
            if dtype != base.dtype:
                continue
            served, n_prefills = counts(), 0
            if not cfg.is_encdec:
                n_prefills += 2                 # the engine's and the greedy stream's
                # the engine's batch (equal prompts: no left pads) is the
                # model's forward and greedy decode_steps through the kernels
                text = {"tokens": tokens[:n_req, :prompt].contiguous()}
                got = engine_stream(cfg, model, text["tokens"], n_new)
                toks, _, logits = greedy_stream(cfg, model, text, n_new)
                if not torch.equal(got, toks):
                    raise AssertionError(f"{arch}: the engine served {got.tolist()}, its "
                                         f"forward and decode steps give {toks.tolist()}")
                say(f"[smoke serve] {arch} {dtype}: {n_req} requests x {prompt} tokens, "
                    f"{n_new} new each, served by ServeEngine on the log: {got.tolist()}; "
                    f"the stream " + against_plain(cfg, model, text, got, logits,
                                                  f"{arch} smoke serve"))
            if cfg.is_encdec or cfg.vlm is not None:
                n_prefills += 2                 # served_batch's warm-up and its run
                served_batch(cfg, model, batch, n_new, f"smoke serve {arch}",
                             main_path=False)
            launched = [now - then for now, then in zip(counts(), served)]
            want = [n_prefills * n_flash, 0, n_prefills * n_mlstm, 0]
            if launched != want:     # decode steps launch neither kernel
                raise AssertionError(f"{arch}: the served prefills launched {launched} "
                                     f"(flash, backward, mLSTM, backward), want {want}")
            del model
        if n_mlstm:
            step_xlstm_kernel_vs_plain(base, SMOKE_STEP, remats=(base.remat,))
        else:
            step_kernel_vs_plain(base, n_layers=None, shape=SMOKE_STEP,
                                 extra=lambda cfg, gen, B: smoke_extra(cfg, gen, B),
                                 want_bwd=n_flash)
        torch.cuda.empty_cache()
        mine = [now - then for now, then in zip(counts(), at_start)]
        summed = [a + b for a, b in zip(summed, mine)]
        if (n_flash and not all(mine[:2])) or (n_mlstm and not all(mine[2:])):
            raise AssertionError(f"{arch}: a kernel of its path was not launched: {mine}")
        say(f"[smoke] {arch}: {base.n_layers} layers, Dh {base.head_dim_}, {n_flash} flash "
            f"calls a forward, {n_mlstm} mLSTM: prefill in two dtypes, serve and train "
            f"step held in {time.perf_counter() - t0:.1f} s; launches: flash forward "
            f"{mine[0]}, backward {mine[1]}, mLSTM forward {mine[2]}, backward {mine[3]}")
    got = counts()                                                           # ... ends
    say(f"[smoke] {len(ARCHS)} smoke configs; launches: flash forward {got[0]}, backward "
        f"{got[1]}, mLSTM forward {got[2]}, backward {got[3]}")
    if list(got) != summed or not all(got):
        raise AssertionError(f"phase 19's launches {got}, its configs' sum {summed}: "
                             "a count was set again inside, or a kernel left unlaunched")
    return got


def tp_batch(cfg, run: dict, seed: int = 12) -> dict:
    """The run's batch (B, S) (MESH_STEP's unless it names a ``shape``),
    seeded: the same tokens in every process, and whisper's frames or
    llava's patch embeddings (``tp_extras``)."""
    B, S = run.get("shape", MESH_STEP["shape"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], **tp_extras(cfg, B, 13)}


def tp_extras(cfg, B: int, seed: int) -> dict:
    """The inputs beside the tokens, seeded alike in every process."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return smoke_extra(cfg, gen, B)


def tp_prompts(cfg) -> dict:
    """The stream's prompts: TP_PROMPT's tokens and the model's extras."""
    tokens = prefill_tokens(cfg, TP_PROMPT)
    return {"tokens": tokens, **tp_extras(cfg, tokens.shape[0], 14)}


def tp_config(run: dict):
    from repro_torch import get_config
    cfg = get_config(run["config"])
    return cfg.with_(n_layers=run.get("n_layers", cfg.n_layers),
                     dtype=run.get("dtype", cfg.dtype))


def tp_opt(cfg):
    """The step's AdamW settings: fp32 at STEP_EPS, so that Adam's first
    update g / (|g| + eps) is held at STEP_TOL as phase 9c holds it."""
    from repro_torch.train import AdamWConfig
    kw = {"eps": TP_STEP_EPS[cfg.dtype]} if cfg.dtype in TP_STEP_EPS else {}
    return AdamWConfig(lr=STEP_LR, weight_decay=0.01, **kw)


def tp_plain_split(scan, q, k, v, li, lf, state, chunk, impl):
    """The mLSTM's plain version at chunk 32: its sums in another order."""
    return scan(q, k, v, li, lf, state, 32, "plain")


@contextmanager
def block_inputs(log):
    """Record each block's input x (``lm._apply_block``) in ``log``; None
    records nothing."""
    from repro_torch.models import lm
    apply = lm._apply_block
    if log is not None:
        lm._apply_block = lambda blk, x, *args, **kw: (log.append(x.detach()),
                                                       apply(blk, x, *args, **kw))[1]
    try:
        yield
    finally:
        lm._apply_block = apply


def tp_layer_grads(cfg, blocks, xs) -> list:
    """Each block's gradients on its own input ``xs[l]`` and a cotangent
    seeded by ``l``: ``[{"x": the input's, name: each parameter's}]``."""
    from repro_torch.models import lm
    grads = []
    for l, (blk, x) in enumerate(zip(blocks, xs)):
        x = x.cuda().clone().requires_grad_(True)
        names, params = zip(*blk.named_parameters())
        for p in params:
            p.requires_grad_(True)
        y = lm._apply_block(blk, x, cfg)[0]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + l)
        dy = torch.randn(y.shape, generator=gen, device="cuda", dtype=y.dtype)
        g = torch.autograd.grad(y, (x,) + params, dy)
        grads.append({"x": g[0], **dict(zip(names, g[1:]))})
        del y, dy, g
    return grads


def tp_layer_hold(cfg, model, out: Path, rank: int) -> dict:
    """An fp32 split step's gradients, layer by layer: each block of the
    rank's ``model`` on the one-rank forward's input to it and its cotangent
    (``tp_layer_grads``), against the one-rank gradients' slices; per layer
    the worst tensor's max |diff| / max |one-rank gradient|, the worst over
    the ranks. Then the power check: the same with ``tp.reduce_to_model``
    made a plain ``reduce_from_model`` (a rank left its own share of the
    gates' or dt/B/C's gradient), which must exceed TP_LAYER_GRAD_TOL in
    every layer that reads it. Returns {"split": [...], "share": [...],
    "reads": [layers that read reduce_to_model]}."""
    import torch.distributed as dist
    from repro_torch.distributed import tp
    from repro_torch.models.lm import layer_kinds
    xs, ref = torch.load(out / "layer_inputs.pt"), torch.load(out / f"layers{rank}.pt")

    def worst() -> list:
        got = []
        for l, gl in enumerate(tp_layer_grads(cfg, model.blocks, xs)):
            got.append(max(((g - ref[l][n].cuda()).abs().max()
                            / ref[l][n].cuda().abs().max()).item() for n, g in gl.items()))
        w = torch.tensor(got, device="cuda")
        dist.all_reduce(w, op=dist.ReduceOp.MAX)
        return w.tolist()

    split = worst()
    reduce_to_model = tp.reduce_to_model
    tp.reduce_to_model = tp.reduce_from_model
    try:
        share = worst()
    finally:
        tp.reduce_to_model = reduce_to_model
    reads = [l for l, k in enumerate(layer_kinds(cfg)) if k == "mlstm" or k.startswith("mamba")]
    return {"split": split, "share": share, "reads": reads}


def tp_reference(cfg, run: dict, out: Path) -> dict:
    """(a) of phase 20 for one model: the one-rank port on the weights the
    ranks make (seed 5). The run's batch forward through the kernels (its
    MoE layers' expert choices recorded), through the plain versions and
    through the plain versions with one sum split (the floor: attention's
    P V over the keys in two halves, the mLSTM at chunk 32), the kernels'
    logits within TP_FLOOR_FACTOR times the floor or PREFILL_TOL of the
    plain version's (the ranks' rule; else it raises); the greedy stream of
    ``tp_prompts`` (``greedy_stream``); where the run steps, one
    ``make_train_step`` in the run's dtype and microbatches (the (1, 1)
    ZeRO-1 step's numbers bit for bit, by phase 16), and in fp32 each block's gradients on its
    input in the kernels' forward (``tp_layer_grads``). Written to ``out``
    for the ranks, the updated parameters and the gradients cut into each
    rank's slices; the card is freed after. Returns the one-rank times."""
    from repro_torch import forward, init_params
    from repro_torch.distributed import tp
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.train import adamw_init, make_train_step
    out.mkdir(parents=True)
    batch = tp_batch(cfg, run)
    inputs = {k: x for k, x in batch.items() if k != "labels"}
    model = init_params(cfg, seed=5)
    dims = tp.split_dims(cfg, MeshShape(("data", "model"), (1, TP_WORLD)))
    stepping = run.get("step", True)
    routes, xs = [], []
    with torch.no_grad():
        with moe_routes(routes), block_inputs(xs if stepping and cfg.dtype == "float32" else None):
            kern = forward(cfg, model, inputs)[0]
        plain = forward(cfg, model, inputs, attn_impl="plain", mlstm_impl="plain")[0]
        with flash_calls(lambda flash, *args, **kw: attention_split_sum(*args, **kw)), \
                mlstm_calls(tp_plain_split):
            split = forward(cfg, model, inputs)[0]
        floor, kvp = logit_diff(split, plain), logit_diff(kern, plain)
        del plain, split
        tol = PREFILL_TOL[getattr(torch, cfg.dtype)]
        if any(kvp[key] > max(TP_FLOOR_FACTOR * floor[key], tol[key]) for key in tol):
            raise AssertionError(f"the one-rank port's kernels against plain {kvp}, beyond "
                                 f"{TP_FLOOR_FACTOR}x the floor {floor} and {tol}")
        fwd_ms = cuda_ms(lambda: forward(cfg, model, inputs), iters=3, warmup=1)
    torch.save({"logits": kern.cpu(), "floor": floor, "routes": [r.cpu() for r in routes]},
               out / "forward.pt")
    del kern
    if xs:
        grads = tp_layer_grads(cfg, model.blocks, xs)
        torch.save([x.cpu() for x in xs], out / "layer_inputs.pt")
        for r in range(TP_WORLD):
            torch.save([{n: (g.chunk(TP_WORLD, dims[f"blocks.{l}.{n}"][0])[r]
                             if f"blocks.{l}.{n}" in dims else g).cpu() for n, g in gl.items()}
                        for l, gl in enumerate(grads)], out / f"layers{r}.pt")
        del grads, xs
    toks, margins, first = greedy_stream(cfg, model, tp_prompts(cfg), TP_NEW)
    torch.save({"tokens": toks.cpu(), "margins": margins.cpu(), "first": first.cpu()},
               out / "stream.pt")
    del model, first
    torch.cuda.empty_cache()
    step_s = None
    if stepping:
        opt = tp_opt(cfg)
        model = init_params(cfg, seed=5, trainable=True)
        state = adamw_init(model, opt)
        t0 = time.perf_counter()
        _, state, m = make_train_step(cfg, opt, accum=run.get("accum", 1),
                                      grad_dtype=cfg.dtype)(model, state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        del state
        for r in range(TP_WORLD):
            torch.save({n: (p.detach().chunk(TP_WORLD, dims[n][0])[r] if n in dims
                            else p.detach()).cpu() for n, p in model.named_parameters()},
                       out / f"step{r}.pt")
        (out / "step.json").write_text(json.dumps({"loss": loss, "grad_norm": gnorm}))
        del model
        torch.cuda.empty_cache()
    B, S = batch["tokens"].shape
    say(f"[tp] one-rank port, {cfg.name} {cfg.n_layers} layers {cfg.dtype}: forward B={B} "
        f"S={S}"
        f"{' and ' + ', '.join(inputs.keys() - {'tokens'}) if len(inputs) > 1 else ''} "
        f"{fwd_ms:.3f} ms, kernels vs plain max_abs {kvp['max_abs']:.3e} rel_rms "
        f"{kvp['rel_rms']:.3e}, floor (plain with a sum split vs plain) max_abs "
        f"{floor['max_abs']:.3e} rel_rms {floor['rel_rms']:.3e}; greedy stream "
        f"{tuple(toks.shape)}; "
        + (f"one step of {run.get('accum', 1)} microbatches {step_s:.3f} s"
           if step_s is not None else "no step"))
    return {"forward_ms": fwd_ms, "step_s": step_s}


def tp_stream(cfg, model, prompts: dict, mg) -> tuple:
    """``greedy_stream`` on the split model: the prefill of ``prompts``
    (tokens, and a VLM's prefix or an encoder-decoder's frames) and TP_NEW
    - 1 ``decode_step``s after the prefix and the text, each token
    ``tp.greedy`` over the ranks' vocabulary slices. Returns (tokens (B,
    TP_NEW), the prefill's logits made whole)."""
    from repro_torch import decode_step, forward
    from repro_torch.distributed import tp
    S = prompts["tokens"].shape[1]
    P = prompts["vision_embeds"].shape[1] if "vision_embeds" in prompts else 0
    logits, _, caches, n_prefix = forward(cfg, model, prompts, want_caches=True,
                                          max_len=P + S + TP_NEW)
    first = tp.gather_vocab(logits, mg)
    outs = []
    for t in range(TP_NEW):
        outs.append(tp.greedy(logits[:, -1], cfg.vocab_size, mg))
        if t + 1 < TP_NEW:
            logits, caches = decode_step(cfg, model, caches, outs[-1][:, None],
                                         n_prefix + S + t)
    return torch.stack(outs, 1), first


def tp_flash_heads(cfg, world: int) -> list:
    """[(q heads, kv heads, Dhk, Dhv)] of a rank's flash calls (none
    without attention): the rank's H/world q heads and their kv heads, its
    KH/world or, where ``wk`` stays whole, the one its q heads share; MLA's
    k is made per head, so its kv heads are its q heads."""
    if not flash_per_forward(cfg):
        return []
    H, KH, Dh = cfg.n_heads_padded // world, cfg.n_kv_heads, cfg.head_dim_
    if cfg.mla is not None:
        return [(H, H, Dh + cfg.mla.rope_head_dim, Dh)]
    return [(H, KH // world if KH % world == 0 else 1, Dh, Dh)]


def tp_want(cfg, step: bool, accum: int = 1) -> dict:
    """Each kernel's launches (forward, backward) a rank makes on one model:
    the forward, the stream's prefill, and with a step of ``accum``
    microbatches each one's forward twice (remat full) and its backward,
    once a flash or mLSTM layer each."""
    from repro_torch.models.lm import layer_kinds
    per = {"flash": flash_per_forward(cfg), "mlstm": layer_kinds(cfg).count("mlstm")}
    return {k: ((2 + 2 * accum if step else 2) * n, accum * n if step else 0)
            for k, n in per.items()}


def tp_counts(zero: bool = False) -> dict:
    """The four kernels' launch counts as ``{"flash": (forward, backward),
    "mlstm": (...)}``; ``zero`` sets them to 0 first (a main path's start)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    if zero:
        flash_attention.launches = flash_attention.backward_launches = 0
        mlstm_chunk.launches = mlstm_chunk.backward_launches = 0
    return {"flash": (flash_attention.launches, flash_attention.backward_launches),
            "mlstm": (mlstm_chunk.launches, mlstm_chunk.backward_launches)}


def made_in_turn(rank: int, world: int, make):
    """``make()`` on each rank in turn, the others waiting at an all-reduce
    of one number, the card's cache emptied after: one whole model is made
    at a time (jamba's 2 layers are 22.69 GiB whole, and drawing an expert
    tensor takes a 12 GiB fp32 temporary: two ranks at once would near the
    card's 79 GiB)."""
    import torch.distributed as dist
    made = None
    for r in range(world):
        if r == rank:
            made = make()
            torch.cuda.empty_cache()
        dist.all_reduce(torch.zeros(1, device="cuda"))
    return made


def tp_step_diffs(cfg, mesh, rank: int, model, m: dict, ref_step: dict, want_p: dict,
                  before: dict) -> tuple:
    """A rank's split step against the one-rank step's slices ``want_p``
    (``before``: the rank's parameters before the step, on the host):
    (the differences, the limits of those held, what else to report). bf16
    in BF16_STEP_TOL's terms (loss; relative grad norm; the share of each
    tensor's updates within lr / 2, at the worst tensor; the parameters'
    relative RMS, the replicated leaves' sums counted on rank 0 alone), all
    held at BF16_STEP_TOL; fp32 in ``step_diffs``' terms (relative loss and
    grad norm; the worst parameter's |diff| / (1 + |p|), over the ranks),
    the loss held at STEP_TOL and the gradient layer by layer
    (``tp_layer_hold``, TP_LAYER_GRAD_TOL's note): the whole model's grad
    norm and parameters are printed, not held."""
    import torch.distributed as dist
    from repro_torch.distributed import tp
    from repro_torch.launch.mesh import describe
    from repro_torch.train.step import BF16_STEP_TOL, STEP_TOL
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    d = {"grad_norm": abs(gnorm - ref_step["grad_norm"]) / ref_step["grad_norm"]}
    if cfg.dtype == "float32":
        worst = torch.zeros(1, device="cuda")
        for name, p in model.named_parameters():
            w = want_p[name].cuda()
            worst = torch.maximum(worst, ((p.detach() - w).abs() / (1 + w.abs())).max())
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        d.update(loss=abs(loss - ref_step["loss"]) / abs(ref_step["loss"]),
                 params=worst.item())
        return d, {"loss": STEP_TOL}, {}
    split = tp.split_dims(cfg, describe(mesh))
    sums = torch.zeros(2, dtype=torch.float64, device="cuda")
    worst_agree = 1.0
    for name, p in model.named_parameters():     # a block of elements at a time
        pf, wf, of = p.detach().reshape(-1), want_p[name].reshape(-1), before[name].reshape(-1)
        agree = 0
        for i in range(0, pf.numel(), TP_DIFF_BLOCK):
            sl = slice(i, i + TP_DIFF_BLOCK)
            w, q, o = wf[sl].cuda().float(), pf[sl].float(), of[sl].cuda().float()
            agree += int(((q - o) - (w - o)).abs().le(STEP_LR / 2).sum())
            if name in split or rank == 0:
                sums += torch.stack([(q - w).square().sum(), w.square().sum()]).double()
            del w, q, o
        worst_agree = min(worst_agree, agree / pf.numel())
    dist.all_reduce(sums)
    st = BF16_STEP_TOL
    d.update(loss=abs(loss - ref_step["loss"]), update_disagree=1 - worst_agree,
             params_rel_rms=(sums[0] / sums[1]).sqrt().item())
    limit = {"grad_norm": st["grad_norm"], "loss": st["loss"],
             "update_disagree": 1 - st["update_agree"], "params_rel_rms": st["params_rel_rms"]}
    return d, limit, {"update_agree": worst_agree}


def tp_model(rank: int, world: int, mesh, cfg, run: dict, out: Path) -> tuple:
    """One model of a rank of phase 20, as a main path (the four kernels'
    counts set to 0 before and read after): ``cfg`` split by
    ``tp.split_model`` (its bytes the rules' ``bytes_per_device``), its
    forward of the run's batch made whole by ``tp.gather_vocab``, the greedy
    stream and, where the run steps, one ``make_zero1_train_step``. Then
    held against the one-rank port in ``out``: the logits within
    TP_FLOOR_FACTOR times the floor or PREFILL_TOL (MoE expert choices that
    differ from the one-rank forward's counted, as phase 11 counts them;
    where any do, a forward pinned to the one-rank choices is held instead,
    outside the main path), the stream equal or parting only at a near-tie,
    the step as ``tp_step_diffs`` says (and in fp32 ``tp_layer_hold``, run
    outside the main path on the model as made), every flash call on the
    rank's heads and every mLSTM call on its heads. Returns (report, what
    failed)."""
    from repro_torch import forward, init_params
    from repro_torch.distributed import tp, use_mesh
    from repro_torch.launch.dryrun import param_bytes
    from repro_torch.train import (local_batch, make_zero1_train_step, opt_state_shardings,
                                   zero1_adamw_init)
    rep, stages = {}, {}
    stepping = run.get("step", True)
    accum = run.get("accum", 1)
    batch = tp_batch(cfg, run)
    inputs = {k: x for k, x in batch.items() if k != "labels"}
    prompts = tp_prompts(cfg)
    mg = tp.vocab_group
    torch.cuda.reset_peak_memory_stats()
    model = made_in_turn(rank, world,
                         lambda: tp.split_model(cfg, init_params(cfg, seed=5), mesh))
    rep["bytes"] = [sum(p.numel() * p.element_size() for p in model.parameters()),
                    param_bytes(cfg, mesh)]
    moe = next((blk.moe for blk in model.blocks if hasattr(blk, "moe")), None)
    if moe is not None:
        rep["experts"] = [moe.e_in.shape[0], cfg.n_experts_padded]
    inner = next((p for n, p in model.named_parameters() if n.endswith((".m_in", ".x_up"))),
                 None)                                   # Mamba's or the mLSTM's Di
    if inner is not None:
        rep["channels"] = [inner.shape[-1], 2 * cfg.d_model]
    heads, mheads, routes = set(), set(), []

    def seen(flash, q, k, v, **kw):
        heads.add((q.shape[1], k.shape[1], q.shape[-1], v.shape[-1]))
        return flash(q, k, v, **kw)

    def seen_mlstm(scan, q, *args):
        mheads.add((q.shape[1], q.shape[-1]))
        return scan(q, *args)

    ref = torch.load(out / "forward.pt")
    one = torch.load(out / "stream.pt")
    step_s = None
    with flash_calls(seen), mlstm_calls(seen_mlstm), use_mesh(mesh):
        torch.cuda.synchronize()
        tp_counts(zero=True)                                     # main path
        with torch.no_grad():
            t0 = time.perf_counter()
            with moe_routes(routes):
                logits = forward(cfg, model, inputs)[0]
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            local_vocab = logits.shape[-1]
            whole = tp.gather_vocab(logits, mg(cfg))
            del logits
            t0 = time.perf_counter()
            toks, first = tp_stream(cfg, model, prompts, mg(cfg))
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t0
        if stepping:            # the state made in the rank's chunks, never whole
            if run.get("resume"):   # the forward's model is read no more (no MoE, bf16)
                model = None
                torch.cuda.empty_cache()
                stage_peak(stages, "forward and stream")
            opt = tp_opt(cfg)
            osh = opt_state_shardings(cfg, init_params(cfg, None, device="meta"), mesh, opt)
            step_model = tp.split_model(cfg, init_params(cfg, seed=5, trainable=True), mesh)
            state = zero1_adamw_init(cfg, step_model, opt, osh, mesh)
            before = {n: p.detach().cpu() for n, p in step_model.named_parameters()}
            step = make_zero1_train_step(cfg, opt, mesh, osh, grad_dtype=cfg.dtype,
                                         accum=accum)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_model, state, m = step(step_model, state, local_batch(batch, mesh, accum))
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            if not run.get("resume"):
                del state, step
            else:
                stage_peak(stages, "state and step")
        got = tp_counts()                                        # ... ends
        peak = max([torch.cuda.max_memory_allocated(), *stages.values()])
        torch.cuda.empty_cache()
        n_flips = flips(routes, [r.cuda() for r in ref["routes"]])
        n_routed = sum(r.numel() // r.shape[-1] for r in routes)
        d = logit_diff(whole, ref["logits"].cuda())
        held = "the main path's forward"
        if n_flips:                 # outside the main path: routed as the one rank was
            with torch.no_grad(), moe_routes([r.cuda() for r in ref["routes"]], pin=True):
                pinned = tp.gather_vocab(forward(cfg, model, inputs)[0], mg(cfg))
            rep["logits_unpinned"] = d
            d = logit_diff(pinned, ref["logits"].cuda())
            held = "a forward pinned to the one-rank expert choices"
            del pinned
    layers = None
    if stepping and cfg.dtype == "float32":                     # outside the main path
        with use_mesh(mesh):
            layers = tp_layer_hold(cfg, model, out, rank)
    del model
    want = tp_want(cfg, stepping, accum)
    floor = ref["floor"]
    tol = PREFILL_TOL[getattr(torch, cfg.dtype)]
    logits_ok = all(d[key] <= max(TP_FLOOR_FACTOR * floor[key], tol[key]) for key in tol)
    del whole, ref
    parted = (toks.cpu() != one["tokens"]).any(0).nonzero()
    if not len(parted):
        stream = "equals the one-rank stream"
    else:
        at = int(parted[0])
        rows = (toks.cpu()[:, at] != one["tokens"][:, at]).nonzero()[:, 0]
        worst = one["margins"][rows, at].max().item()
        diff = (first.float().cpu() - one["first"].float()).abs().max().item()
        stream = (f"parts from the one-rank stream at step {at} of {TP_NEW}, one-rank top-2 "
                  f"margin {worst:.4f} (a near-tie within twice the prefills' logit "
                  f"difference {diff:.4f}: {worst <= 2 * diff})")
        if worst > 2 * diff:
            raise AssertionError(f"rank {rank}: {cfg.name}'s stream {stream}")
    step_rep, step_ok = None, True
    if stepping:
        ref_step = json.loads((out / "step.json").read_text())
        d_step, limit, extra = tp_step_diffs(cfg, mesh, rank, step_model, m, ref_step,
                                             torch.load(out / f"step{rank}.pt"), before)
        del before
        if run.get("resume"):                        # outside the main path
            stage_peak(stages, "the step's check")
            held = {"model": step_model, "state": state}
            del step_model, state
            rep["resume"] = tp_resume(cfg, mesh, run, held, step, stages)
            rep["resume"]["peaks"] = stages
        else:
            del step_model
        torch.cuda.empty_cache()
        peak = max([peak, torch.cuda.max_memory_allocated(), *stages.values()])
        if layers is not None:
            d_step["layer_grads"], limit["layer_grads"] = max(layers["split"]), TP_LAYER_GRAD_TOL
            extra["layers"] = layers
            step_ok = all(layers["share"][l] > TP_LAYER_GRAD_TOL for l in layers["reads"])
        step_ok = step_ok and all(d_step[k] <= limit[k] for k in limit)
        step_rep = {"loss": [float(m["loss"]), ref_step["loss"]],
                    "grad_norm": [float(m["grad_norm"]), ref_step["grad_norm"]],
                    "diffs": d_step, "limit": limit, **extra}
    want_mheads = ([(cfg.n_heads // world if cfg.n_heads % world == 0 else cfg.n_heads,
                     2 * cfg.d_model // cfg.n_heads)] if want["mlstm"][0] else [])
    rep.update({
        "launches": {k: list(v) for k, v in got.items()},
        "want": {k: list(v) for k, v in want.items()},
        "heads": sorted(heads), "mlstm_heads": sorted(mheads), "peak": peak,
        "local_vocab": local_vocab, "logits": d, "held": held, "floor": floor,
        "flips": [n_flips, n_routed], "stream": stream, "step": step_rep,
        "seconds": {"forward": fwd_s, "stream": stream_s, "step": step_s}})
    bad = []
    if rep["bytes"][0] != rep["bytes"][1]:
        bad.append(f"parameter bytes {rep['bytes']}")
    if moe is not None and rep["experts"][0] * world != rep["experts"][1]:
        bad.append(f"experts a rank {rep['experts']}")
    if "channels" in rep and rep["channels"][0] * world != rep["channels"][1]:
        bad.append(f"channels a rank {rep['channels']}")
    if got != want:
        bad.append(f"launches {got}, want {want}")
    if sorted(heads) != tp_flash_heads(cfg, world):
        bad.append(f"flash calls on (q, kv, Dhk, Dhv) {sorted(heads)}, want "
                   f"{tp_flash_heads(cfg, world)}")
    if sorted(mheads) != want_mheads:
        bad.append(f"mLSTM calls on (heads, Dh) {sorted(mheads)}, want {want_mheads}")
    if not logits_ok:
        bad.append(f"logits {d} against the floor {floor}")
    if not step_ok:
        bad.append(f"step {rep['step']}")
    if "resume" in rep:
        if not rep["resume"]["exact"]:
            bad.append(f"the resumed step is not the straight one: {rep['resume']}")
        if peak >= rep["resume"]["state_bytes"]:
            bad.append(f"peak {peak} B reaches the whole AdamW state's "
                       f"{rep['resume']['state_bytes']} B: the state was made whole")
    return rep, [f"{cfg.name}: {b}" for b in bad]


def stage_peak(stages: dict, name: str) -> None:
    """Book the card's peak since the last mark to ``stages[name]`` and
    start counting anew."""
    torch.cuda.synchronize()
    stages[name] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()


def tp_resume(cfg, mesh, run: dict, held: dict, step, stages: dict) -> dict:
    """A split model's whole run past its first step (outside the main
    path): ``held``'s model and its ZeRO-1 state (taken out of ``held``, so
    that they can be freed) saved by every rank to rank
    0's log (each leaf gathered whole, rank 0 writing the reference's
    record), a second step on another seeded batch, that step's parameters
    and state chunks copied to the host and freed from the card; then fresh
    split weights, a restore of the record onto the mesh (rank 0 reading and
    broadcasting a tensor at a time, each rank keeping its part) and the
    same second step, which must equal the straight one bit for bit (loss,
    grad norm, every parameter slice and state chunk). Both second steps
    run under ``torch.use_deterministic_algorithms``, as phase 9d's resume.
    Returns the record's bytes and leaves, the save's and the restore's
    seconds, whether the resumed step is exact, and the whole AdamW state's
    bytes (a rank's peak must stay below them). Each part's peak is booked
    to ``stages``."""
    from repro_torch import init_params
    from repro_torch.core import BoltSystem
    from repro_torch.distributed import tp
    from repro_torch.train import CheckpointManager, local_batch
    accum = run.get("accum", 1)
    rows = local_batch(tp_batch(cfg, run, seed=15), mesh, accum)
    n_params = sum(p.numel() for p in init_params(cfg, None, device="meta").parameters())
    ckpt = CheckpointManager(BoltSystem(n_brokers=2), keep=0)   # the other ranks' go unused
    model, state = held.pop("model"), held.pop("state")
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(1, model, state, extra={"mesh": list(mesh.mesh.shape)}, cfg=cfg, mesh=mesh)
        save_s = time.perf_counter() - t0
        stage_peak(stages, "save")
        record = None
        if ckpt.steps():                                          # rank 0's log
            rec = ckpt._replay()[1]
            record = {"leaves": len(rec["spans"]), "chunks": rec["spans"][-1][1],
                      "chunk_bytes": ckpt.chunk_bytes}
        model, state, m = step(model, state, rows)
        straight = ({n: p.detach().cpu() for n, p in model.named_parameters()},
                    {k: {n: d.to_local().cpu() for n, d in state[k].items()}
                     for k in ("m", "v", "master")})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        del model, state, m
        torch.cuda.empty_cache()
        stage_peak(stages, "second step")
        fresh = tp.split_model(cfg, init_params(cfg, seed=6, trainable=True), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        at, params, restored, extra = ckpt.restore(cfg=cfg, mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        with torch.no_grad():
            for n, p in fresh.named_parameters():
                p.copy_(params.pop(n))
        stage_peak(stages, "restore")
        fresh, restored, rm = step(fresh, restored, rows)
        stage_peak(stages, "resumed step")
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [n for n, p in fresh.named_parameters() if not torch.equal(p.cpu(), straight[0][n])]
    for k, chunks in straight[1].items():
        differ += [f"{k} {n}" for n, t in chunks.items()
                   if not torch.equal(restored[k][n].to_local().cpu(), t)]
    exact = (at == 1 and extra == {"mesh": list(mesh.mesh.shape)} and not differ
             and float(rm["loss"]) == loss and float(rm["grad_norm"]) == gnorm)
    del fresh, restored, straight
    torch.cuda.empty_cache()
    return {"exact": exact, "differ": differ[:8], "loss": [loss, float(rm["loss"])],
            "grad_norm": [gnorm, float(rm["grad_norm"])], "record": record,
            "seconds": {"save": save_s, "restore": restore_s}, "params": n_params,
            "state_bytes": TP_STATE_BYTES * n_params}


def tp_storage_probe(mesh) -> dict:
    """What a chunk of ``distribute_opt_state`` holds on this torch: a whole
    fp32 (4096, 1024) tensor laid out over 'model' on dim 0 and on dim 1
    (``distribute``), each chunk's bytes against its storage's bytes."""
    from repro_torch.distributed import distribute
    from repro_torch.distributed.context import P
    from repro_torch.distributed.sharding import Sharding
    out = {}
    for dim, spec in ((0, P("model", None)), (1, P(None, "model"))):
        local = distribute(torch.zeros(4096, 1024, device="cuda"), Sharding(spec),
                           mesh).to_local()
        out[f"dim {dim}"] = [local.numel() * local.element_size(),
                             local.untyped_storage().nbytes()]
    return out


def tp_rank(rank: int, world: int, out: Path) -> int:
    """One rank of phase 20 (``chip_smoke.py --tp-rank RANK WORLD DIR``):
    gloo over a FileStore in DIR, on cuda:0 beside the other ranks. First
    the transport: gloo's all_reduce of a CUDA tensor, summed right (the
    rank fails where gloo refuses or garbles it). Then on the (1, WORLD)
    (data, model) mesh each of TP_RUNS in turn (``tp_model``), the card
    freed between them. Writes DIR/rank{RANK}.json; any failure raises, so
    the rank exits non-zero."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    torch.cuda.set_device(0)
    probe = torch.full((1 << 20,), float(rank + 1), device="cuda")
    dist.all_reduce(probe)                  # raises where gloo takes no CUDA tensor
    if not bool((probe == world * (world + 1) / 2).all()):
        raise AssertionError(f"gloo's all_reduce of a CUDA tensor over {world} ranks "
                             f"gave {probe[:4]}")
    rep = {"transport": f"gloo takes a CUDA tensor for all_reduce: {probe.numel()} "
                        f"floats summed right over {world} ranks (torch {torch.__version__})"}
    del probe
    mesh = make_mesh((1, world), ("data", "model"))
    rep["storage"] = tp_storage_probe(mesh)
    bad = []
    for run in TP_RUNS:
        cfg = tp_config(run)
        rep[cfg.name], failed = tp_model(rank, world, mesh, cfg, run, out / cfg.name)
        bad += failed
        torch.cuda.empty_cache()
    (out / f"rank{rank}.json").write_text(json.dumps(rep))
    say(f"[tp rank {rank}] {json.dumps(rep)}")
    dist.destroy_process_group()
    if bad:
        raise AssertionError(f"rank {rank}: " + "; ".join(bad))
    return 0


def run_tp_ranks(out: Path) -> list:
    """(b) of phase 20: TP_WORLD ranks, each this script with ``--tp-rank``,
    started together and joined; a rank's failure, or TP_TIMEOUT passing,
    fails the phase (the ranks still running are killed). Returns each
    rank's report."""
    procs, logs = [], []
    for r in range(TP_WORLD):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
             str(TP_WORLD), str(out)], stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.perf_counter() + TP_TIMEOUT
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.perf_counter())))
    except subprocess.TimeoutExpired:
        rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if rcs != [0] * TP_WORLD:
        for r in range(TP_WORLD):
            for line in (out / f"rank{r}.log").read_text().splitlines()[-30:]:
                say(f"[tp rank {r} log] {line}")
        raise AssertionError(f"the tensor-parallel ranks ended {rcs}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(TP_WORLD)]


def phase_tp() -> dict:
    """Phase 20: tensor parallelism over 'model' on the one card. (a) the
    one-rank reference of each of TP_RUNS (``tp_reference``), the card
    freed after each; (b) TP_WORLD gloo ranks on cuda:0, each first checking
    that gloo's all_reduce takes a CUDA tensor, run the split of each model
    (``tp_rank``) and are joined. NCCL refuses two ranks on one device;
    gloo's all_reduce and broadcast, all the split needs, take CUDA tensors.
    Two ranks share one card, so their times are no measure of a split's
    speed. Returns ``{path: {"flash": (forward, backward), "mlstm": (...)}}``,
    each model a main path, its launches summed over the ranks."""
    import shutil
    t_phase = time.perf_counter()
    out = ROOT / "build" / "tp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    one, ref_s = {}, {}
    for run in TP_RUNS:
        cfg = tp_config(run)
        t0 = time.perf_counter()
        one[cfg.name] = tp_reference(cfg, run, out / cfg.name)
        ref_s[cfg.name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = run_tp_ranks(out)
    ranks_s = time.perf_counter() - t0
    say(f"[tp] distribute_opt_state's chunks on torch {torch.__version__} (rank 0, bytes, "
        f"storage bytes): {reports[0]['storage']} of a whole fp32 (4096, 1024) split over "
        f"'model' by {TP_WORLD}")
    paths = {}
    for run in TP_RUNS:
        cfg = tp_config(run)
        for r, rank_rep in enumerate(reports):
            rep, sec = rank_rep[cfg.name], rank_rep[cfg.name]["seconds"]
            experts = (f"{rep['experts'][0]} of {rep['experts'][1]} experts a layer, "
                       if "experts" in rep else "")
            channels = (f"{rep['channels'][0]} of {rep['channels'][1]} inner channels, "
                        if "channels" in rep else "")
            unpinned = (f" (unpinned: max_abs {rep['logits_unpinned']['max_abs']:.3e} rel_rms "
                        f"{rep['logits_unpinned']['rel_rms']:.3e})"
                        if "logits_unpinned" in rep else "")
            st = rep["step"]
            lay = st and st.get("layers")
            step = ("no step" if st is None else
                    f"ZeRO-1 step ({cfg.dtype}) loss {st['loss'][0]:.6f} / "
                    f"{st['loss'][1]:.6f}, grad norm {st['grad_norm'][0]:.6f} / "
                    f"{st['grad_norm'][1]:.6f}; against the one-rank step "
                    + ", ".join(f"{k} {v:.3e} "
                                + (f"(limit {st['limit'][k]:.3e})" if k in st["limit"]
                                   else "(not held)") for k, v in st["diffs"].items())
                    + (f", updates within lr/2 on >= {st['update_agree']:.4f} of each tensor"
                       if "update_agree" in st else "")
                    + (" (BF16_STEP_TOL)" if cfg.dtype == "bfloat16" else
                       f" (the loss at STEP_TOL; AdamW eps {TP_STEP_EPS[cfg.dtype]:g})")
                    + ("" if not lay else
                       "; each block's gradients on its own input, worst tensor's max |diff| / "
                       "max |g| by layer (over the ranks) "
                       + ", ".join(f"{x:.2e}" for x in lay["split"])
                       + f" (limit TP_LAYER_GRAD_TOL {TP_LAYER_GRAD_TOL:g}); with a rank left "
                       "its own share of reduce_to_model's gradient "
                       + ", ".join(f"{x:.2e}" for x in lay["share"])
                       + f" (must exceed the limit in layers {lay['reads']})"))
            say(f"[tp] {cfg.name} {cfg.n_layers} layers, rank {r} of {TP_WORLD} on the one "
                f"card ({rank_rep['transport']}): {rep['bytes'][0] / 2 ** 30:.3f} GiB of "
                f"parameters (the rules' bytes_per_device on (1, {TP_WORLD}): "
                f"{rep['bytes'][1] / 2 ** 30:.3f}), {experts}{channels}vocabulary slice "
                f"{rep['local_vocab']} of {cfg.padded_vocab}, "
                + (f"flash calls on (q, kv, Dhk, Dhv) {rep['heads']} of "
                   f"{cfg.n_heads_padded} heads, " if rep["heads"] else "")
                + (f"mLSTM calls on (heads, Dh) {rep['mlstm_heads']} of {cfg.n_heads} "
                   "heads, " if rep["mlstm_heads"] else "")
                + f"launches (forward, backward) "
                f"{rep['launches']} (want {rep['want']}); MoE expert choices differing from "
                f"the one-rank forward's {rep['flips'][0]} of {rep['flips'][1]} (token, "
                f"layer); logits of {rep['held']} vs the one-rank port max_abs "
                f"{rep['logits']['max_abs']:.3e} rel_rms {rep['logits']['rel_rms']:.3e}"
                f"{unpinned} (floor {rep['floor']['max_abs']:.3e} / "
                f"{rep['floor']['rel_rms']:.3e}, tol {TP_FLOOR_FACTOR}x floor or "
                f"{PREFILL_TOL[getattr(torch, cfg.dtype)]}); stream {rep['stream']}; {step}; peak "
                f"{rep['peak'] / 2 ** 30:.2f} GiB; forward {sec['forward']:.3f} s, stream "
                f"{sec['stream']:.3f} s"
                + (f", step {sec['step']:.3f} s" if sec["step"] is not None else "")
                + " (two ranks share one card: no measure of a split's speed)"
                + ("" if "resume" not in rep else tp_resume_line(rep)))
        got = {k: tuple(sum(rep[cfg.name]["launches"][k][i] for rep in reports)
                        for i in (0, 1)) for k in ("flash", "mlstm")}
        paths[f"{cfg.name} split over 'model' by {TP_WORLD} gloo ranks on one card"] = got
        step = one[cfg.name]["step_s"]
        say(f"[tp] {cfg.name}: the one-rank reference {ref_s[cfg.name]:.1f} s, its forward "
            f"{one[cfg.name]['forward_ms']:.3f} ms"
            + (f" and step {step:.3f} s" if step is not None else "")
            + f" alone on the card; launches over the ranks (forward, backward): flash "
            f"{got['flash']}, mLSTM {got['mlstm']}"
            + ("" if any(map(any, got.values())) else
               " (no layer of its runs attends or is an mLSTM: it launches no kernel)"))
    shutil.rmtree(out, ignore_errors=True)
    say(f"[tp] phase 20 {time.perf_counter() - t_phase:.1f} s: the ranks {ranks_s:.1f} s")
    return paths


def tp_resume_line(rep: dict) -> str:
    """The resume's part of a rank's line in phase 20."""
    res = rep["resume"]
    rec = res["record"]
    return (f"; resumed ({TP_ACCUM} microbatches a step): saved in {res['seconds']['save']:.1f} s"
            + ("" if rec is None else
               f" (rank 0's record: {rec['leaves']} leaves in {rec['chunks']} chunks of at most "
               f"{rec['chunk_bytes']} B; reckoned {res['params'] * 14 / 1e9:.2f} GB, bf16 "
               "parameters and fp32 m, v and master)")
            + f", restored onto fresh split weights in {res['seconds']['restore']:.1f} s, the "
            f"second step loss {res['loss'][1]:.6f} / {res['loss'][0]:.6f} straight, grad norm "
            f"{res['grad_norm'][1]:.6f} / {res['grad_norm'][0]:.6f}: "
            + ("bit for bit the straight step" if res["exact"] else
               f"NOT the straight step ({res['differ']})")
            + f"; peak {rep['peak'] / 2 ** 30:.2f} GiB against the whole AdamW state's "
            f"{res['state_bytes'] / 2 ** 30:.2f} GiB (by part: "
            + ", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in res["peaks"].items()) + " GiB)")


def serve_timing(repeats: int) -> None:
    """``--serve-timing N``: only the served paths' times, N times each, to
    compare two commits' packages in alternating processes (this script
    copied beside each; no kernel checks and no "ok" line). For qwen3-8b
    (phases 3-4), xlstm-1.3b (phases 7-8), granite-moe-3b-a800m (phase 11)
    and deepseek-v2-lite-16b (phase 12): the eager prefill and decode step
    of the timed prompts, and one served batch, as the phases time them;
    prints each series and a JSON line of them. jamba-1.5-large-398b (phase
    13) at its 5 layers."""
    from repro_torch import decode_step, forward, get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk
    from repro_torch.models.lm import layer_kinds
    result = {}
    for name, kernel, prompts, shape, cut in (
            ("qwen3-8b", flash_attention, SERVE_PROMPTS, (4, 32), {}),
            ("xlstm-1.3b", mlstm_chunk, XLSTM_SERVE_PROMPTS, XLSTM_PROMPT, {}),
            ("granite-moe-3b-a800m", flash_attention, SERVE_PROMPTS, (4, 32), {}),
            ("deepseek-v2-lite-16b", flash_attention, SERVE_PROMPTS, (4, 32), {}),
            ("jamba-1.5-large-398b", flash_attention, SERVE_PROMPTS, (4, 32),
             {"n_layers": JAMBA_LAYERS})):
        cfg = get_config(name).with_(**cut)
        model = init_params(cfg, seed=0)
        n_launches = (attention_layers(cfg) if kernel is flash_attention
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
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    from repro_torch import get_config, init_params
    from repro_torch.kernels.flash_attention import flash_attention
    seconds, then = {}, [time.perf_counter()]

    def lap(phases: str) -> None:
        """Book the seconds since the last lap to ``phases`` and free the card."""
        torch.cuda.empty_cache()
        now = time.perf_counter()
        seconds[phases] = round(now - then[0], 1)
        then[0] = now

    phase_device()
    lap("1")
    kernel = phase_kernel()
    lap("2")
    mlstm = phase_mlstm_kernel()
    lap("6")
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[prefill] qwen3-8b: {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB bf16) made in "
        f"{time.perf_counter() - t0:.1f} s")
    timed = phase_prefill(cfg, model)
    served, _ = phase_serve(cfg, model, flash_attention, cfg.n_layers, SERVE_PROMPTS, "serve")
    del model
    lap("3-4")
    phase_speculative()
    lap("5")
    mlstm["launches_by_path"] = {"serve xlstm-1.3b": phase_xlstm()}
    lap("7-8")
    backward, trained_fwd, trained_bwd = phase_train()
    lap("9")
    mlstm_bwd, xlstm_fwd, xlstm_bwd = phase_train_xlstm()
    lap("10")
    moe_fwd, moe_bwd = phase_moe()
    lap("11")
    mla_fwd, mla_bwd = phase_mla()
    lap("12")
    jamba = phase_jamba()
    lap("13")
    whisper_fwd, whisper_bwd = phase_whisper()
    lap("14")
    llava = phase_llava()
    lap("15")
    mesh_fwd, mesh_bwd = phase_mesh()
    lap("16")
    example_fwd, example_bwd = phase_examples()
    lap("17")
    phase_costs(timed)
    lap("18")
    smoke = phase_smoke()
    lap("19")
    tp_paths = phase_tp()
    lap("20")
    say(f"[time] seconds by phase: {json.dumps(seconds)}, {sum(seconds.values()):.1f} in all")
    mesh_path = "train qwen3-8b ZeRO-1 on the host mesh"
    kernel["launches_by_path"] = {"serve qwen3-8b": served, **trained_fwd, **moe_fwd, **mla_fwd,
                                  "serve jamba-1.5-large-398b": jamba, **whisper_fwd, **llava,
                                  mesh_path: mesh_fwd, **example_fwd, "smoke configs": smoke[0]}
    backward["launches_by_path"] = {**trained_bwd, **moe_bwd, **mla_bwd, **whisper_bwd,
                                    mesh_path: mesh_bwd, **example_bwd,
                                    "smoke configs": smoke[1]}
    mlstm["launches_by_path"].update(xlstm_fwd)
    mlstm["launches_by_path"]["smoke configs"] = smoke[2]
    mlstm_bwd["launches_by_path"] = {**xlstm_bwd, "smoke configs": smoke[3]}
    # phase 20's models: each a main path of the kernels it launches
    for path, got in tp_paths.items():
        for entry, n in ((kernel, got["flash"][0]), (backward, got["flash"][1]),
                         (mlstm, got["mlstm"][0]), (mlstm_bwd, got["mlstm"][1])):
            if n:
                entry["launches_by_path"][path] = n
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

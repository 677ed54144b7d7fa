#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmor_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles K1-K9, K5's piggyback-prefill rows (K5-pf) and its int8
   widths (K5-int8), and the microbenchmark kernels K10a-K10f from
   ``mmor_tpu_torch/csrc`` (one nvcc a source), and prints the registers,
   stack frame and spills of each kernel compiled from ``mega_decode.cu``,
   ``fused_mlp.cu``, ``flash_attention.cu`` and ``decode_attention.cu``, of
   K2's and K3's wgmma kernels, K8's stream kernel and K10f's product;
2. kernel vs plain: each kernel against its plain PyTorch version at the
   serving paths' shapes (K7-K10f at the microbenchmarks': K9 at the 7B
   decode tail at batch 8 and 14, beside the same tail unfused through
   three K2 W8A16 or three K10c launches; K2 also at
   ``bench_decode_parts``' batch 14 over the 7B shapes; K2, K8, K10c's
   mxu8 mode and K10d bit for bit, K10c's bf16 mode within one bf16 step
   at the largest output, the benches' spot-check rule; K7 with a control
   that must miss its bound, the kernel on bf16 copies of f32 scales),
   with the bound stated on each line, and its device time (each case's
   calls queued behind a spin kernel) beside its roofline bound, the plain
   version's time and, where one PyTorch call computes the
   same function, that call's time and the kernel's factor over it
   (``torch._int_mm`` on the int8 operands
   with the rescales for K2, K8 and K10e's int8 x-read, its rows padded to
   32 where fewer; ``torch._weight_int8pack_mm`` for the W8A16 kernels K10a,
   K10b's w8p, K10c's bf16 mode and K10e's bf16 x-read;
   ``torch._weight_int4pack_mm`` for K10b's w4p and K10e's nibble product,
   each first held to the dequantized product within LIBRARY_BOUND); K10e
   (x-read with int8 x bit for bit at both x layouts, with bf16 x within one
   bf16 step, tiny bit for bit, nibble within one bf16 step, the row probe's
   acc within PROBE_BOUND and its rows within one bf16 step) and K10f (copies
   bit for bit, products within PROBE_BOUND) at their scripts' shapes; K2's
   W8A16 branch within K2_A16_BOUND at phase 14's projections (M 8 and
   5664) and the lm_head (M 8), its library ``torch.matmul`` on the weight
   dequantized to bf16, and at ragged edges; K4 and K7 at the edges of
   their clusters' ranks (8 ranks, T off a rank's span, rows of one valid
   position or none, head dims 16 to 256); K5 at 7B
   widths and depth 2 at all four (weight, KV cache) width pairs; K5-pf and
   K5-int8-pf, at (4, 4) and (8, 8) (8 decode rows, a 128-row chunk, a
   768-column working cache), each layer alone, with the decode rows
   bit-identical to the same call without the chunk; K3's two branches at
   the 7B projections, W4A8 bit for bit at M 8 and 5664, W4A16 within
   K3_A16_BOUND at M 8, 14 and 5664 (its library ``torch.matmul`` on the
   weight dequantized to bf16), both at ragged edges;
3. int8 path: MM2SG-7B ``--quantize int8`` ``generate_stepwise`` (batch 8,
   prompt 128 with left padding, raw uint8 views at their native sizes, 300
   new tokens), timed twice after a warm run; the launch counts of K1, K2
   and K4 over those runs, a profiled window of decode steps (launches a
   step, the device's busy share, K4's device time a step), and the
   prefill's next-token logits with the kernels against the same prefill
   with the plain versions;
4. CLI: ``mmor_tpu_torch.cli.evaluate_sg`` on a synthetic dataset with
   ``--quantize int8`` (predictor, raw point clouds through PTv3, F1 report);
5. int4 path: the same inputs through MM2SG-7B ``--quantize int4`` (int4
   weights through K3, the int4 KV cache and decode megakernel K5): frames/s,
   prefill and decode times, launches per decode step, peak memory, the
   launch counts of K1, K2, K3 and K5; K5 on that cache against its plain
   version, each of the 32 layers alone within phase 2's bounds and the
   whole depth at once; and one decode step's logits with K5 against the
   same step with its plain version;
6. CLI: ``evaluate_sg --preset 7b --quantize int4``;
7. panoptic path: DVIS++ online (ResNet-50, the MSDeformAttn pixel decoder
   through K6, the Mask2Former video decoder, the referring tracker) at full
   widths in bf16 on a seeded 9-frame 736x1280 uint8 video, in 3-frame
   windows with the tracker's state carried, through the CLI's window step:
   frames/s, ms/frame, K6's launches, peak memory and the device's busy
   share; then K6 against its plain version on each encoder layer's
   sampler operands as one served window recorded them, within phase 2's
   bound, and, as a smoke check, one window with K6 against the same window
   with its plain version (the pixel decoder's outputs and the window's
   logits and masks, each within a measured rounding floor);
8. CLI: ``mmor_tpu_torch.cli.eval_panoptic --synthetic`` (512x512 f32, full
   widths): VPQ and STQ;
9. overlapped int4 path: phase 5's model and inputs through
   ``generate_overlapped`` (each later batch's prompt carried, 128 tokens a
   step, by the previous batch's K5 steps): steady and fill-inclusive
   frames/s over a stream of same-shape batches beside the serial path's,
   ms per plain and per pf step, launches per pf step, K5-pf's device time
   per step against its bound, peak memory and the launch counts of K1, K2,
   K3, K5 and K5-pf; batch 0's tokens against ``generate_stepwise``'s; one
   handed-off stream's cache against the same prompt token by token through
   K5 (the CPU test's bounds), and its first token's logits against that
   oracle's within a rounding floor measured in the run;
10. int8 megakernel path: phase 3's inputs through MM2SG-7B with int8
    weights and an int8 KV cache decoded by K5-int8, the JAX megakernel's
    default, built as ``bench.py``'s megakernel rung (cache capacity 1024,
    128-granular): what phase 5 reports, for K5-int8;
11. overlapped int8 path: phase 10's model (one model for both) through
    ``generate_overlapped`` as phase 9 runs it: what phase 9 reports, for
    K5-int8 and its pf rows;
12. perf tools: the port's ``tools/perf`` microbenchmarks at their default
    sizes (the JAX scripts'), each ``main`` as a user runs it:
    ``bench_stream`` (bf16, K8 W8A8, K10a W8A16 and K10b w8p weight streams
    at M 16 over 8 layers of 4096 x 11264), ``bench_w8a16``,
    ``bench_packed`` (K10b at int8 and int4), both parts of
    ``bench_decode_parts`` (a 7B decode step's weights through K2 at batch
    14, and K7 over 32 distinct 1024-position caches), ``bench_bitcast``
    (K10c's two modes on row-packed words, M 16 over 8 layers of 4096 x
    11264), ``bench_dma_gather`` (K10d, 2^18 windows of a (92, 160, 32)
    bf16 map) and ``bench_fused_mlp`` (K9 at the 7B decode tail at batch 8
    and 14, beside the unfused K2 and K10c chains and cuBLAS bf16, with its
    phase times), all four parts of ``bench_megakernel_probe`` (K10e: x held
    in shared memory against x read from L2, launch overhead with a CUDA
    graph, int4 nibbles against int8, the row probe) and
    ``probe_mosaic_reshape`` (K10f, whose all-ones sums must equal the JAX
    script's) and ``bench_prefill_matmul`` (K2's W8A8 and W8A16 and K3's
    W4A8 and W4A16 at M 7040 x 4096 x 11264, beside bf16 ``torch.matmul``
    and ``torch._int_mm``): their lines, their spot checks (each within its
    bound) and the launch counts of K2, K3, K7-K9 and K10a-K10f;
13. int4 at ``quant_int8_mxu=False``: phase 5's inputs and seeded weights
    through MM2SG-7B ``--quantize int4`` with the LlamaConfig field off (no
    CLI flag: ``dataclasses.replace`` before ``quantize_mega``): K3's W4A16
    branch at prefill, K2's W8A16 lm_head, K5 decoding 300 tokens; one warm
    and one timed call (prefill ms, decode ms/token, frames/s), K3's
    launches by branch, the prefill's last-position logits against the same
    model with K3's plain version (rel_l2 within a measured rounding floor,
    the first token on clear-margin rows), and, printed only, their top-1
    agreement with the same weights at ``quant_int8_mxu=True``;
14. int8 at ``quant_int8_mxu=False``: phase 3's inputs and seeded weights
    through MM2SG-7B ``--quantize int8`` with the LlamaConfig field off (set
    with ``dataclasses.replace`` before ``quantize_int8``): K2's W8A16
    branch at every projection (prefill and decode) and the lm_head, K4
    decoding 300 tokens, K1 at prefill; one warm and one timed call
    (prefill ms, decode ms/token, frames/s, peak memory), phase 3's decode
    profile, the launches of K2 by branch and of K4, the prefill's
    last-position logits against the same model with K2's plain version
    (rel_l2 within a measured rounding floor, the first token on
    clear-margin rows), and, printed only, their top-1 agreement with the
    W8A8 model (phase 3's).

Each phase prints its wall time. The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
``--phases`` runs a subset. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "K1 flash_attention": (
        "cuda", "mmor_tpu_torch/csrc/flash_attention.cu",
        "mmor_tpu/ops/attention.py:241"),
    "K2 int8_matmul_packed": (
        "cuda", "mmor_tpu_torch/csrc/int8_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:187"),
    # K2's two branches too: W8A16 (int8_mxu off) is a kernel a row range,
    # the wgmma one above 16 rows and stream_matmul.cu's row-word one below
    "K2-w8a16 int8_matmul_packed(w8a16)": (
        "cuda", "mmor_tpu_torch/csrc/int8_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:187"),
    # K3's two branches (int8_mxu on and off) are one kernel a branch
    "K3 int4_matmul_packed": (
        "cuda", "mmor_tpu_torch/csrc/int4_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:371"),
    "K3-w4a16 int4_matmul_packed(w4a16)": (
        "cuda", "mmor_tpu_torch/csrc/int4_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:371"),
    "K4 decode_attention_packed_stack": (
        "cuda", "mmor_tpu_torch/csrc/decode_attention.cu",
        "mmor_tpu/ops/attention.py:473"),
    "K5 mega_decode_layers": (
        "cuda", "mmor_tpu_torch/csrc/mega_decode.cu",
        "mmor_tpu/ops/mega_decode.py:1131"),
    "K5-pf mega_decode_layers(pf)": (
        "cuda", "mmor_tpu_torch/csrc/mega_decode.cu",
        "mmor_tpu/ops/mega_decode.py:853"),
    "K5-int8 mega_decode_layers(int8)": (
        "cuda", "mmor_tpu_torch/csrc/mega_decode.cu",
        "mmor_tpu/ops/mega_decode.py:663"),
    "K5-int8-pf mega_decode_layers(int8,pf)": (
        "cuda", "mmor_tpu_torch/csrc/mega_decode.cu",
        "mmor_tpu/ops/mega_decode.py:853"),
    "K6 ms_deform_attn": (
        "cuda", "mmor_tpu_torch/csrc/ms_deform_attn.cu",
        "mmor_tpu/ops/deformable_sampler.py:268"),
    "K7 decode_attention_packed": (
        "cuda", "mmor_tpu_torch/csrc/decode_attention.cu",
        "mmor_tpu/ops/attention.py:396"),
    "K8 int8_matmul": (
        "cuda", "mmor_tpu_torch/csrc/int8_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:59"),
    "K9 fused_o_mlp": (
        "cuda", "mmor_tpu_torch/csrc/fused_mlp.cu",
        "mmor_tpu/ops/fused_mlp.py:124"),
    "K10a w8a16_matmul": (
        "cuda", "mmor_tpu_torch/csrc/stream_matmul.cu",
        "tools/perf/bench_w8a16.py:57"),
    "K10b wp_matmul": (
        "cuda", "mmor_tpu_torch/csrc/stream_matmul.cu",
        "tools/perf/bench_packed.py:91"),
    # K10c's two modes run two existing kernels (a mode a source)
    "K10c w8b_matmul(bf16)": (
        "cuda", "mmor_tpu_torch/csrc/stream_matmul.cu",
        "tools/perf/bench_bitcast.py:72"),
    "K10c w8b_matmul(mxu8)": (
        "cuda", "mmor_tpu_torch/csrc/int8_matmul.cu",
        "tools/perf/bench_bitcast.py:72"),
    "K10d dma_gather": (
        "cuda", "mmor_tpu_torch/csrc/window_gather.cu",
        "tools/perf/bench_dma_gather.py:66"),
    # K10e: one kernel a pallas_call of the megakernel probe (x-read's two x
    # layouts are two of them)
    "K10e xread_matmul(stack)": (
        "cuda", "mmor_tpu_torch/csrc/megakernel_probe.cu",
        "tools/perf/bench_megakernel_probe.py:145"),
    "K10e xread_matmul(dslice)": (
        "cuda", "mmor_tpu_torch/csrc/megakernel_probe.cu",
        "tools/perf/bench_megakernel_probe.py:167"),
    "K10e tiny": (
        "cuda", "mmor_tpu_torch/csrc/megakernel_probe.cu",
        "tools/perf/bench_megakernel_probe.py:198"),
    "K10e nibble_matmul": (
        "cuda", "mmor_tpu_torch/csrc/megakernel_probe.cu",
        "tools/perf/bench_megakernel_probe.py:287"),
    "K10e rowrw": (
        "cuda", "mmor_tpu_torch/csrc/megakernel_probe.cu",
        "tools/perf/bench_megakernel_probe.py:358"),
    # K10f: the probe's one pallas_call runs five kernels: two copies (a, b)
    # and three products (c, d, e)
    "K10f reshape_copy": (
        "cuda", "mmor_tpu_torch/csrc/reshape_probe.cu",
        "tools/perf/probe_mosaic_reshape.py:30"),
    "K10f st_product": (
        "cuda", "mmor_tpu_torch/csrc/reshape_probe.cu",
        "tools/perf/probe_mosaic_reshape.py:30"),
}
# the kernels each path runs (phase 3: int8, phase 5: int4, phase 7:
# panoptic, phase 9: overlapped int4, phase 10: int8 megakernel, phase 11:
# overlapped int8 megakernel, phase 12: the perf tools, phase 13: int4 at
# quant_int8_mxu=False, phase 14: int8 at quant_int8_mxu=False)
PATH_KERNELS = {
    "int8": ("K1 flash_attention", "K2 int8_matmul_packed",
             "K4 decode_attention_packed_stack"),
    "int4": ("K1 flash_attention", "K2 int8_matmul_packed", "K3 int4_matmul_packed",
             "K5 mega_decode_layers"),
    "panoptic": ("K6 ms_deform_attn",),
    "overlap": ("K1 flash_attention", "K2 int8_matmul_packed", "K3 int4_matmul_packed",
                "K5 mega_decode_layers", "K5-pf mega_decode_layers(pf)"),
    "mega8": ("K1 flash_attention", "K2 int8_matmul_packed",
              "K5-int8 mega_decode_layers(int8)"),
    "overlap8": ("K1 flash_attention", "K2 int8_matmul_packed",
                 "K5-int8 mega_decode_layers(int8)",
                 "K5-int8-pf mega_decode_layers(int8,pf)"),
    "perf": ("K2 int8_matmul_packed", "K2-w8a16 int8_matmul_packed(w8a16)",
             "K7 decode_attention_packed", "K8 int8_matmul",
             "K9 fused_o_mlp", "K10a w8a16_matmul", "K10b wp_matmul",
             "K10c w8b_matmul(bf16)", "K10c w8b_matmul(mxu8)", "K10d dma_gather",
             "K10e xread_matmul(stack)", "K10e xread_matmul(dslice)", "K10e tiny",
             "K10e nibble_matmul", "K10e rowrw", "K10f reshape_copy", "K10f st_product",
             "K3 int4_matmul_packed", "K3-w4a16 int4_matmul_packed(w4a16)"),
    "int4a16": ("K1 flash_attention", "K2-w8a16 int8_matmul_packed(w8a16)",
                "K3-w4a16 int4_matmul_packed(w4a16)", "K5 mega_decode_layers"),
    "int8a16": ("K1 flash_attention", "K2-w8a16 int8_matmul_packed(w8a16)",
                "K4 decode_attention_packed_stack"),
}

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# device memory bytes/s, and operations/s by type ("cuda_core" is the f32
# rate outside the tensor cores, taken for the integer and f32 arithmetic
# the attention kernels do there)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "cuda_core": 67e12}

# main paths (phases 3 and 5): batch, prompt tokens, new tokens
BATCH, PROMPT_LEN, NEW_TOKENS = 8, 128, 300
# Kernels vs plain versions over the whole 7B prefill. K2 is bit-exact to its
# plain version, so the two prefills differ only by K1's roundings (rel_l2
# about 3e-3 a call in phase 2), which 23 CLIP, 2 pooler and 32 LLaMA layers
# of random N(0, 0.02) weights amplify, int8 activation roundings flipping
# with them. The scale of that amplification is measured in the run: the
# plain prefill against itself with each attention output perturbed by up to
# one bf16 rounding step (rel_l2 about 2e-3 a call). The kernels' logits
# must stay within this factor of that floor: 1.5x for the larger per-call
# error, and 2x headroom.
LOGITS_FLOOR_FACTOR = 3.0
PROFILE_STEPS = 16  # decode steps in the --profile window
LAUNCH_STEPS = 8  # decode steps profiled to count launches a step (phase 5)
# K5 against its plain version (phase 2: two 7B layers; phase 5: each of the
# served model's layers alone): the matmul phases share the plain version's
# fold order, so the two differ only where f32 sums in another order
# (softmax, rsqrt and exp) move an int8 activation bin by one. x_out bound:
# rel_l2 2e-3; the new K/V columns agree in >= 99.9% of entries and never
# differ by more than one.
K5_X_BOUND, K5_KV_AGREE = 2e-3, 0.999
# K6 against its plain version: both take the same f32 products and sums (in
# another order) and round once to the value's dtype, so bf16 outputs differ
# by one rounding step where the two f32 sums fall on either side of a
# rounding boundary, and f32 outputs by the sums' order alone. Measured on an
# H100: rel_l2 2.1e-5 to 2.5e-5 in bf16, 1.0e-7 to 1.4e-7 in f32; the bounds
# leave 40x and 7x of room.
K6_BOUND = {"bf16": 1e-3, "f32": 1e-6}
# K7 against its plain version: both keep the scales in their own dtype and
# the logits, softmax and weighted sum in f32, in another order, so they
# differ by the sums' order and the bf16 output's rounding. Measured on an
# H100 at B 14, H 32, T 1024: rel_l2 6.8e-5 (bf16 scales) and 8.2e-5 (f32).
# Casting f32 scales to bf16 moves each by up to 2^-9, about 1e-3 of the
# output, so the bound sits between the two, and a control run of the kernel
# on bf16 copies of the f32 scales must land above it.
K7_BOUND = 3e-4
# K3's 7B projections (qkv, o, gate_up with the ffn padded to 11264, down)
K3_SHAPES = ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096))
# K3's W4A16 branch against its plain version (the JAX CPU path: f32
# dequantization, then x @ w): the kernel sums exact bf16 products in f32
# on the tensor cores, a group at a time times its scale, and rounds once
# to bf16, so bf16 outputs differ where the two f32 sums fall on either side
# of a rounding boundary (measured on an H100: rel_l2 1.5e-7 to 4.7e-5);
# f32 x is rounded to bf16 first, as the TPU kernel does (measured 1.7e-3,
# 2^-9 relative a value)
K3_A16_BOUND = {"bf16": 1e-3, "f32": 5e-3}
# K2's W8A16 branch against its plain version (the JAX CPU path: f32
# dequantization, then x @ w): the kernels sum exact bf16 products of x and
# the int8 weights in f32 on the tensor cores and apply the column scale
# once, so bf16 outputs differ where the two f32 sums fall on either side of
# a rounding boundary, and f32 x is rounded to bf16 first, as the TPU branch
# does (2^-9 relative a value); K3's W4A16 bounds, for the same reasons
K2_A16_BOUND = K3_A16_BOUND
# K2's W8A16 branch at phase 14's projections: q, k, v and o; gate and up
# (the ffn padded to 11264); down
K2_SHAPES = ((4096, 4096), (4096, 11264), (11264, 4096))
# K9 against its plain version: both take the same bf16 operands and f32
# products, summed in another order, and round h and m to bf16 once, so an
# h or m entry at a near-tie can come out one bf16 step apart and carry that
# step into the output
K9_BOUND = 1e-3
# panoptic path (phase 7): frames at the JAX bench's 736x1280 in 3-frame
# windows, three windows a video
PANOPTIC_SIZE, PANOPTIC_FRAMES = (736, 1280), 9
# overlapped path (phase 9): prompt tokens a pf step (the JAX bench's
# chunk); the stream is warmed with 2 batches, then timed over 2 and over 4
# (bench.py's marginal rate, with 4 in place of its 6 to keep the phase
# near a minute)
OVERLAP_CHUNK, OVERLAP_WARM, OVERLAP_SHORT, OVERLAP_LONG = 128, 2, 2, 4
# the handed-off cache against its token-by-token oracle
# (tests/test_torch_overlap.py's bounds, JAX's test_pf_prefill_matches_
# tokenwise_decode_oracle's): layer 0's K/V bit-exact, later layers within
# one bin in more than ORACLE_BIN_SHARE of entries, scales within
# ORACLE_REL. The bin share is held wherever rounding alone keeps it, in
# each layer and overall: the floor is the oracle fed embeddings moved by
# one bf16 step. On an H100 the int4 floor stays above it (0.995 overall,
# 0.990 at layer 28), but the random 7B model spreads the int8 floor to
# 0.729 at layer 1, 0.300 at layer 28 and 0.409 overall (int8 bins are 18x
# finer); so every layer is also held to within ORACLE_FLOOR_MARGIN below
# its floor's share.
ORACLE_BIN_SHARE, ORACLE_REL, ORACLE_FLOOR_MARGIN = 0.9, 0.05, 0.05
# a weight-only library call (torch._weight_int8pack_mm, _weight_int4pack_mm)
# against the dequantized f32 product: it rounds the scales and its output
# to bf16 (each at most 2^-9 relative), so a right operand layout stays
# under this bound and a wrong one lands near 1
LIBRARY_BOUND = 1e-2
# K10e and K10f against their plain versions: the products' full f32 sums
# (the row probe's acc, K10f's c, d and e) differ only by the order of f32
# sums
PROBE_BOUND = 1e-6
# probe_mosaic_reshape's all-ones out_sums, as the JAX script prints them
# (its kernels in Pallas interpret mode on the CPU;
# tests/test_torch_megakernel_probe.py holds the port's CPU main to them)
RESHAPE_SUMS = (327680.0, 40960.0, 10485760.0, 10485760.0, 4096.0)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, iters: int) -> tuple[float, bool]:
    """Device ms of one call of ``fn``: ``iters`` back-to-back calls queued
    behind a spin kernel after a warm window (``tools.perf.timing.scan_ms``),
    so a kernel shorter than its wrapper's Python is timed on the card; and
    whether the host had queued all of them before the card began."""
    import torch

    from mmor_tpu_torch.tools.perf.timing import scan_ms

    def calls():
        for _ in range(iters):
            fn()

    ms, ahead = scan_ms(calls, 1, torch.device("cuda"))
    return ms / iters, bool(ahead)


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def kernel_modules():
    from mmor_tpu_torch.ops import attention as A
    from mmor_tpu_torch.ops import deformable_sampler as D
    from mmor_tpu_torch.ops import mega_decode as M
    from mmor_tpu_torch.ops import quantized_matmul as Q

    return A, Q, M, D


def perf_modules():
    from mmor_tpu_torch.tools.perf import (bench_bitcast, bench_dma_gather, bench_packed,
                                           bench_w8a16)

    return bench_w8a16, bench_packed, bench_bitcast, bench_dma_gather


def probe_modules():
    from mmor_tpu_torch.tools.perf import bench_megakernel_probe, probe_mosaic_reshape

    return bench_megakernel_probe, probe_mosaic_reshape


def _counters() -> dict:
    """Each kernel's launch count: (wrapper, attribute). K2's and K3's
    wrappers count their W8A16 and W4A16 launches apart from their W8A8 and
    W4A8 ones; K5's its launches with pf
    rows (K5-pf) apart from those without, and those at an int8 width
    (K5-int8) apart from the int4 ones; K10c's its mxu8 mode
    apart from its bf16 mode; K10e's x-read its 2-D x (line c) apart from its
    tile stack (line b)."""
    from mmor_tpu_torch.ops import fused_mlp

    A, Q, M, D = kernel_modules()
    W, P, BC, DG = perf_modules()
    MP, RP = probe_modules()
    return {"K1 flash_attention": (A.flash_attention, "launches"),
            "K2 int8_matmul_packed": (Q.int8_matmul_packed, "launches"),
            "K2-w8a16 int8_matmul_packed(w8a16)": (Q.int8_matmul_packed, "a16_launches"),
            "K3 int4_matmul_packed": (Q.int4_matmul_packed, "launches"),
            "K3-w4a16 int4_matmul_packed(w4a16)": (Q.int4_matmul_packed, "a16_launches"),
            "K4 decode_attention_packed_stack": (A.decode_attention_packed_stack,
                                                 "launches"),
            "K5 mega_decode_layers": (M.mega_decode_layers, "launches"),
            "K5-pf mega_decode_layers(pf)": (M.mega_decode_layers, "pf_launches"),
            "K5-int8 mega_decode_layers(int8)": (M.mega_decode_layers, "int8_launches"),
            "K5-int8-pf mega_decode_layers(int8,pf)": (M.mega_decode_layers,
                                                       "int8_pf_launches"),
            "K6 ms_deform_attn": (D.ms_deform_attn_sampler, "launches"),
            "K7 decode_attention_packed": (A.decode_attention_packed, "launches"),
            "K8 int8_matmul": (Q.int8_matmul, "launches"),
            "K9 fused_o_mlp": (fused_mlp.fused_o_mlp, "launches"),
            "K10a w8a16_matmul": (W.w8a16_matmul, "launches"),
            "K10b wp_matmul": (P.wp_matmul, "launches"),
            "K10c w8b_matmul(bf16)": (BC.w8b_matmul, "launches"),
            "K10c w8b_matmul(mxu8)": (BC.w8b_matmul, "mxu8_launches"),
            "K10d dma_gather": (DG.dma_gather, "launches"),
            "K10e xread_matmul(stack)": (MP.xread_matmul, "launches"),
            "K10e xread_matmul(dslice)": (MP.xread_matmul, "dslice_launches"),
            "K10e tiny": (MP.tiny, "launches"),
            "K10e nibble_matmul": (MP.nibble_matmul, "launches"),
            "K10e rowrw": (MP.rowrw, "launches"),
            "K10f reshape_copy": (RP.reshape_copy, "launches"),
            "K10f st_product": (RP.st_product, "launches")}


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def perturbed(out, gen):
    """``out`` times (1 + u * 2**-8), u uniform in [-1, 1] from ``gen``: a
    rounding-sized change of one call's output (``out`` itself without a
    generator)."""
    import torch

    if gen is None:
        return out
    u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
    return (out.float() * (1 + u * 2.0 ** -8)).to(out.dtype)


@contextlib.contextmanager
def plain_versions(perturb=None):
    """Route the models' kernel calls to the plain PyTorch versions (the
    models look the wrappers up on their modules at call time).

    With a ``torch.Generator`` as ``perturb``, every attention output (and
    every deformable attention sample) is also multiplied by
    (1 + u * 2**-8), u uniform in [-1, 1]: a rounding-sized change of each
    call, which measures how far such changes alone move the outputs of
    this randomly initialised model."""
    from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

    A, Q, M, D = kernel_modules()
    saved = (A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed,
             Q.int4_matmul_packed, M.mega_decode_layers, M._attention_plain,
             D.ms_deform_attn_sampler)
    reference, mega_attention = A.mha_reference, M._attention_plain

    def mega_plain(*args, scratch=None, pointer_table=None, **kwargs):
        return M.mega_decode_layers_plain(*args, **kwargs)

    A.flash_attention = lambda *a, **kw: perturbed(reference(*a, **kw), perturb)
    A.decode_attention_packed_stack = A.decode_attention_packed_stack_plain
    Q.int8_matmul_packed = Q.int8_matmul_packed_plain
    Q.int4_matmul_packed = Q.int4_matmul_packed_plain
    M.mega_decode_layers = mega_plain
    M._attention_plain = lambda *a: perturbed(mega_attention(*a), perturb)
    D.ms_deform_attn_sampler = lambda *a: perturbed(ms_deform_attn(*a), perturb)
    try:
        yield
    finally:
        (A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed,
         Q.int4_matmul_packed, M.mega_decode_layers, M._attention_plain,
         D.ms_deform_attn_sampler) = saved


@contextlib.contextmanager
def plain_qmm(name: str, perturb=None):
    """Route the models' calls of one quantized matmul wrapper of
    ``ops.quantized_matmul`` (``name``: "int8_matmul_packed" for K2,
    "int4_matmul_packed" for K3) to its plain version, the other kernels as
    they are; with a ``torch.Generator`` as ``perturb``, every output of it
    is also ``perturbed``."""
    Q = kernel_modules()[1]
    kernel, plain = getattr(Q, name), getattr(Q, name + "_plain")
    setattr(Q, name, lambda *a, **kw: perturbed(plain(*a, **kw), perturb))
    try:
        yield
    finally:
        setattr(Q, name, kernel)


@contextlib.contextmanager
def recording_sampler(records: list):
    """Route the models' K6 calls through a recorder: each call launches the
    kernel as before and appends (value, shapes, locations, weights, out).
    The wrapper counts its launches on the module's name, the recorder's
    while it is in place; the count is handed over both ways."""
    D = kernel_modules()[3]
    kernel = D.ms_deform_attn_sampler

    def record(value, shapes, loc, attn):
        out = kernel(value, shapes, loc, attn)
        records.append((value, shapes, loc, attn, out))
        return out

    record.launches = kernel.launches
    D.ms_deform_attn_sampler = record
    try:
        yield
    finally:
        D.ms_deform_attn_sampler = kernel
        kernel.launches = record.launches


def roofline_ms(nbytes: float, ops: dict) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 2
class Case:
    """One kernel-vs-plain case: ``fn`` and ``plain`` compute the same
    function on the same inputs; ``nbytes``/``ops`` give the roofline bound
    of that work; ``library`` is one PyTorch call computing it, if any;
    ``extra`` checks outputs beyond the first tensor (K5's tuple); with
    ``exact`` the kernel must equal its plain version bit for bit."""

    def __init__(self, kernel, name, fn, plain, bound, iters, on_path, nbytes, ops,
                 library=None, extra=None, exact=False):
        self.kernel, self.name, self.fn, self.plain = kernel, name, fn, plain
        self.bound, self.iters, self.on_path = bound, iters, on_path
        self.nbytes, self.ops, self.library, self.extra = nbytes, ops, library, extra
        self.exact = exact


def _attention_mask(b, sq, sk, causal, seg, dev):
    """K1's visibility as a boolean (B, 1, Sq, Sk) mask for the library call."""
    import torch

    mask = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    if seg is not None:
        mask &= seg[:, None, :, None] == seg[:, None, None, :]
    return mask


def int_mm_library(xq, rs, w8, scale, out_dtype):
    """One ``torch._int_mm`` on the int8 operands with the two rescales (the
    yardstick of the W8A8 kernels K2 and K8, timed only). ``_int_mm`` takes
    more than 16 rows, so fewer are zero-padded to 32; the weight is laid
    out column-major, as cuBLASLt's int8 product takes it. Returns (the call,
    the rows it multiplies)."""
    import torch

    m = xq.shape[0]
    rows = m if m > 16 else 32
    xp = torch.zeros(rows, xq.shape[1], dtype=torch.int8, device=xq.device)
    xp[:m] = xq
    w8 = w8.t().contiguous().t()

    def call():
        acc = torch._int_mm(xp, w8)[:m]
        return (acc.float() * scale[None, :] * rs[:, None]).to(out_dtype)

    return call, rows


def _library_checked(name, call, ref):
    """``call`` if this torch has a CUDA kernel for it and its result is
    within LIBRARY_BOUND of ``ref`` (the library's own scale rounding), else
    None, printing why."""
    try:
        out = call()
    except (RuntimeError, NotImplementedError) as e:
        reason = str(e).splitlines()[0][:120] if str(e) else type(e).__name__
        say("2 kernel-vs-plain", library=name, none=reason.replace(" ", "_"))
        return None
    err = rel_l2(out, ref)
    check(err <= LIBRARY_BOUND, f"library {name}: rel_l2 {err:.3e} to the dequantized "
                                f"product > {LIBRARY_BOUND:.0e} (a wrong operand layout)")
    return call


def weight_int8pack_library(x, w_q, scale):
    """One ``torch._weight_int8pack_mm`` (W8A16, per-channel scales; the
    yardstick of the W8A16 kernels K10a, K10b's w8p, K10c's bf16 mode and
    K10e's bf16 x-read, timed only): bf16 x times the (N, K) int8 weight,
    the scales in bf16. None where it has no CUDA kernel."""
    import torch

    xb, wt, sc = x.to(torch.bfloat16), w_q.t().contiguous(), scale.to(torch.bfloat16)
    return _library_checked("_weight_int8pack_mm", lambda: torch._weight_int8pack_mm(xb, wt, sc),
                            xb.float() @ (w_q.float() * scale[None, :]))


def weight_int4pack_library(x, w4, scale, group: int = 256):
    """One ``torch._weight_int4pack_mm`` (W4A16 in tinygemm's layout; the
    yardstick of K10b's w4p and K10e's nibble product, timed only): bf16 x
    times int4 values w4 (K, N) in [-8, 7], stored as q = w4 + 8, two a byte
    (even k high), repacked by ``_convert_weight_to_int4pack``; tinygemm's
    (q - 8) * scale + zero with the per-channel scale repeated over K /
    ``group`` groups and zero 0. None where it has no CUDA kernel."""
    import torch

    k, n = w4.shape
    qt = (w4.to(torch.int32) + 8).t().contiguous()
    try:
        packed = torch._convert_weight_to_int4pack((qt[:, ::2] << 4 | qt[:, 1::2]).to(
            torch.uint8), 8)
    except (RuntimeError, NotImplementedError) as e:
        say("2 kernel-vs-plain", library="_convert_weight_to_int4pack",
            none=str(e).splitlines()[0][:120].replace(" ", "_"))
        return None
    sz = torch.stack([scale[None, :].expand(k // group, n), torch.zeros(k // group, n,
                                                                       device=x.device)], -1)
    sz = sz.to(torch.bfloat16).contiguous()
    xb = x.to(torch.bfloat16)
    return _library_checked("_weight_int4pack_mm",
                            lambda: torch._weight_int4pack_mm(xb, packed, group, sz),
                            xb.float() @ (w4.float() * scale[None, :]))


def k5_names(widths) -> tuple[str, str]:
    """The kernel names of K5's variant at (wbits, kvbits): without and
    with pf rows."""
    if tuple(widths) == (4, 4):
        return "K5 mega_decode_layers", "K5-pf mega_decode_layers(pf)"
    return "K5-int8 mega_decode_layers(int8)", "K5-int8-pf mega_decode_layers(int8,pf)"


def _k5_cases(dev, g, wbits: int = 4, kvbits: int = 4, with_pf: bool = True,
              on_path: bool = True):
    """K5 at full 7B width and depth 2 at (wbits, kvbits): B=8, T=1024 with a
    partly masked cache, random hidden states, int4 weights in 1024-row
    groups or int8 weights with per-channel scales; then, ``with_pf``, the
    same call carrying a 128-row chunk against a 768-column working cache
    of which 384 columns are written (a stream's fourth chunk at the
    overlapped paths' shapes)."""
    import torch

    from mmor_tpu_torch.ops import mega_decode as M
    from mmor_tpu_torch.ops import quantized_matmul as Q

    L, B, H, T, dh, D, F, G = 2, 8, 32, 1024, 128, 4096, 11264, 1024
    C, T2, WP = 128, 768, 384
    k5, k5pf = k5_names((wbits, kvbits))
    shapes = ((D, 3 * D), (D, D), (D, 2 * F), (F, D))
    layers = [[] for _ in range(8)]
    for _ in range(L):
        for i, (k, n) in enumerate(shapes):
            w = torch.randn(k, n, generator=g, device=dev) * 0.02
            if wbits == 4:
                wq, sc = Q.quantize_weights_int4(w, G)
                layers[2 * i].append(Q.pack_int4_rows(wq, G))
            else:
                wq, sc = Q.quantize_weights(w)
                layers[2 * i].append(Q.pack_int8_rows(wq))
            layers[2 * i + 1].append(sc)
    norms = 1 + 0.1 * torch.randn(L, 2, D, generator=g, device=dev)
    weights = M.MegaWeights(layers, norms, G, F, H, wbits)

    def kv_cache(*lead):
        if kvbits == 8:
            cache = {name: torch.randint(-127, 128, (*lead, dh), generator=g, device=dev,
                                         dtype=torch.int32).to(torch.int8)
                     for name in ("k", "v")}
        else:
            cache = {name: torch.randint(0, 256, (*lead, dh // 2), generator=g, device=dev,
                                         dtype=torch.int32).to(torch.uint8)
                     for name in ("k", "v")}
        for name in ("k_s", "v_s"):
            cache[name] = (torch.rand(*lead, generator=g, device=dev) * 0.05 + 0.01
                           ).to(torch.bfloat16)
        return cache

    cache = kv_cache(L, B, H, T)
    mask = torch.zeros(B, T, dtype=torch.int32, device=dev)
    for r in range(B):
        mask[r, 8 * r: 708 + 37 * r] = 1
    cache.update(kv_mask=mask, write_pos=1000,
                 tok_pos=torch.arange(700, 700 + B, dtype=torch.int32, device=dev))
    x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = M.rope_tables(cache["tok_pos"], dh, 10000.0)
    table = weights.pointer_table()
    args = (x, weights, cache, cos, sin)
    valid = int(mask.sum())
    if wbits == 4:
        weight_bytes = L * sum(k * n // 2 + (k // G) * n * 4 for k, n in shapes)
    else:
        weight_bytes = L * sum(k * n + n * 4 for k, n in shapes)
    row = dh // 2 if kvbits == 4 else dh  # bytes of a cache row
    kv_bytes = L * H * valid * 2 * (row + 2)
    nbytes = weight_bytes + kv_bytes + B * T * 4 + 2 * B * D * 2 + L * B * H * (2 * dh + 8)
    weight_ops = 2.0 * L * sum(k * n for k, n in shapes)  # a row's int8 operations
    ops = {"int8": B * weight_ops, "cuda_core": 4.0 * L * H * valid * dh}

    def extra(out, ref):
        return {k: f"{v:.5f}" if k.endswith("agree") else f"{v:.3e}"
                for k, v in k5_columns(out, ref, k5.split()[0]).items()}

    scratch = M.alloc_scratch(weights, B, dev)
    plain_case = Case(
        k5, f"7B w{wbits}kv{kvbits} L={L} B={B} T={T} partly masked",
        lambda: M.mega_decode_layers(*args, scratch=scratch, pointer_table=table),
        lambda: M.mega_decode_layers_plain(*args), K5_X_BOUND, 10, on_path,
        nbytes, ops, extra=extra)
    if not with_pf:
        return [plain_case]

    # the chunk: row i at position WP + i of a stream whose first 5 columns
    # are left padding (masked in the working cache and, as keys, by amask)
    work = kv_cache(L, H, T2)
    amask = torch.ones(C, dtype=torch.int32, device=dev)
    amask[:5] = 0
    wmask = torch.zeros(T2, dtype=torch.int32, device=dev)
    wmask[5:WP] = 1
    pcos, psin = M.rope_tables(torch.arange(WP, WP + C, device=dev) - 5, dh, 10000.0)
    pf = dict(x=torch.randn(C, D, generator=g, device=dev).to(torch.bfloat16), cos=pcos,
              sin=psin, amask=amask, mask=wmask, **work)
    scratch_pf = M.alloc_scratch(weights, B + C, dev)
    base = M.mega_decode_layers(*args, scratch=scratch, pointer_table=table)
    w_valid = int(wmask.sum())
    # the decode call's bytes, the written working-cache columns, the chunk's
    # mask, embeddings in and out, RoPE tables and amask, and its new columns
    pf_bytes = (nbytes + L * H * w_valid * 2 * (row + 2) + T2 * 4 + 2 * C * D * 2
                + C * (2 * dh * 4 + 4) + L * C * H * (2 * dh + 8))
    inline_pairs = sum(min(i + 1, C) for i in range(C))  # causal (i, j <= i) pairs
    pf_ops = {"int8": (B + C) * weight_ops,
              "cuda_core": 4.0 * L * H * (valid + C * w_valid + inline_pairs) * dh}

    def extra_pf(out, ref):
        """The decode rows: phase 2's K5 checks, and bit-identical to the same
        call without the chunk. The chunk rows: each layer alone, fed the
        plain version's outputs of the layer before (as phase 5 holds K5),
        within K5_X_BOUND and K5_KV_AGREE; the whole depth is printed beside
        them, with the floor of each: the plain version against itself with
        the chunk's RoPE tables times (1 + 1e-7 u), u standard normal. One
        flipped int8 key of a chunk row moves every later row's causal
        attention, so the chunk rows' rounding floor is far above the
        decode rows'."""
        name = k5pf.split()[0]
        fields = {k: f"{v:.5f}" if k.endswith("agree") else f"{v:.3e}"
                  for k, v in k5_columns(out, ref, f"{name} decode rows").items()}
        same = all(torch.equal(a, b) for a, b in zip(out[:5], base))
        check(same, f"{name}: the decode rows differ from the same call without the chunk")
        check(bool(torch.isfinite(out[5]["x"].float()).all()), f"{name} chunk x non-finite")
        keys = ("x", "knew", "knew_s", "vnew", "vnew_s")
        gen = torch.Generator(device=dev).manual_seed(3)

        def nudged(p):  # the chunk's RoPE tables moved by about an f32 rounding
            return dict(p, **{k: p[k] * (1 + 1e-7 * torch.randn(p[k].shape, generator=gen,
                                                                device=dev))
                              for k in ("cos", "sin")})

        depth_floor = rel_l2(M.mega_decode_layers_plain(*args, pf=nudged(pf))[5]["x"],
                             ref[5]["x"])
        worst_err, worst_agree, worst_floor, x_in, pf_in = 0.0, 1.0, 0.0, x, pf
        for li in range(L):
            one = M.MegaWeights([[slot[li]] for slot in layers], norms[li:li + 1], G, F, H,
                                wbits)
            c1 = dict(cache, **{k: cache[k][li:li + 1] for k in ("k", "v", "k_s", "v_s")})
            p1 = dict(pf_in, **{k: pf[k][li:li + 1] for k in ("k", "v", "k_s", "v_s")})
            got1 = M.mega_decode_layers(x_in, one, c1, cos, sin, scratch=scratch_pf, pf=p1)
            ref1 = M.mega_decode_layers_plain(x_in, one, c1, cos, sin, pf=p1)
            err = rel_l2(got1[5]["x"], ref1[5]["x"])
            check(err <= K5_X_BOUND,
                  f"{name} layer {li}: chunk x rel_l2 {err:.3e} > {K5_X_BOUND:.0e}")
            cols = k5_columns([got1[5][k] for k in keys], [ref1[5][k] for k in keys],
                              f"{name} layer {li} chunk rows")
            floor = rel_l2(M.mega_decode_layers_plain(x_in, one, c1, cos, sin,
                                                      pf=nudged(p1))[5]["x"], ref1[5]["x"])
            worst_err = max(worst_err, err)
            worst_floor = max(worst_floor, floor)
            worst_agree = min(worst_agree, cols["knew_agree"], cols["vnew_agree"])
            x_in, pf_in = ref1[0], dict(pf_in, x=ref1[5]["x"])
        fields.update(decode_rows_bit_identical_to_no_pf=same,
                      chunk_by_layer_worst_x_rel_l2=f"{worst_err:.3e}",
                      chunk_by_layer_worst_kv_agree=f"{worst_agree:.5f}",
                      chunk_by_layer_worst_floor_rel_l2=f"{worst_floor:.3e}",
                      chunk_full_depth_x_rel_l2=f"{rel_l2(out[5]['x'], ref[5]['x']):.3e}",
                      chunk_full_depth_floor_rel_l2=f"{depth_floor:.3e}")
        return fields

    pf_case = Case(k5pf, f"7B w{wbits}kv{kvbits} L={L} B={B} T={T} + chunk {C} T2={T2} "
                         f"wp={WP}",
                   lambda: M.mega_decode_layers(*args, scratch=scratch_pf,
                                                pointer_table=table, pf=pf),
                   lambda: M.mega_decode_layers_plain(*args, pf=pf), K5_X_BOUND, 10, on_path,
                   pf_bytes, pf_ops, extra=extra_pf)
    return [plain_case, pf_case]


# the narrow phases' K split across a cluster of blocks a strip, each
# count timed beside the plan's choice at R = 8 (core_plan's ranks)
CORE_SPLITS = {"o": (1, 2, 4), "down": (1, 2, 3)}


def _core_cases(dev):
    """K5's weight core alone (``mega_project``) at the four 7B projections,
    R = 8 decode rows and R = 136 (a 128-row chunk riding along), int4
    weights in 1024-row groups and int8 weights, bit for bit against the
    plain version's fold (off the path: K5's calls run the same kernel),
    at ``core_plan``'s choice and, for the narrow phases at R = 8, at each
    count of ``CORE_SPLITS``; the bound is the weight bytes, the
    activations and the outputs (or the int8 operations at R = 136, int4)."""
    import torch

    from mmor_tpu_torch.ops import mega_decode as M
    from mmor_tpu_torch.ops import quantized_matmul as Q

    g = torch.Generator(device=dev).manual_seed(11)
    phases = (("qkv", 4096, 12288, "store", 1024), ("o", 4096, 4096, "resid", 128),
              ("gate_up", 4096, 22528, "swiglu", 1024), ("down", 11264, 4096, "resid", 1024))
    cases = []
    for wbits in (4, 8):
        for name, k, n, epi, chunk in phases:
            w = torch.randn(k, n, generator=g, device=dev) * 0.02
            if wbits == 4:
                w_q, sc = Q.quantize_weights_int4(w, 1024)
                w_p = Q.pack_int4_rows(w_q, 1024)
            else:
                w_q, sc = Q.quantize_weights(w)
                w_p = Q.pack_int8_rows(w_q)
            del w, w_q
            splits = [(8, r) for r in CORE_SPLITS.get(name, ())]
            for rows, ranks in [(8, None), (136, None)] + splits:
                x = torch.randn(rows, k // chunk, chunk, generator=g, device=dev)
                q, rs = M._quant_rows_f32(x)
                q, rs = q.reshape(rows, k).to(torch.int8), rs[..., 0].contiguous()
                resid = torch.randn(rows, n, generator=g, device=dev) if epi == "resid" else None
                kw = dict(wbits=wbits, chunk=chunk, group=1024, epi=epi, resid=resid)
                out_cols = n // 2 if epi == "swiglu" else n
                nbytes = (w_p.numel() * 4 + sc.numel() * 4 + q.numel() + rs.numel() * 4
                          + rows * out_cols * 4 + (rows * n * 4 if resid is not None else 0))
                cases.append(Case(
                    k5_names((wbits, wbits))[0],
                    f"core {name} w{wbits} R={rows} K={k} N={n}"
                    + (f" ranks={ranks}" if ranks else ""),
                    lambda q=q, rs=rs, w_p=w_p, sc=sc, kw=kw, r=ranks: M.mega_project(
                        q, rs, w_p, sc, ranks=r, **kw),
                    lambda q=q, rs=rs, w_p=w_p, sc=sc, kw=kw: M.mega_project_plain(q, rs, w_p, sc,
                                                                                   **kw),
                    0.0, 20, False, nbytes, {"int8": 2.0 * rows * k * n}, exact=True))
    return cases


def k5_columns(out, ref, what: str) -> dict:
    """K5's new K/V columns against the plain version's: at least
    ``K5_KV_AGREE`` of the entries equal and none more than one apart.
    Returns each column's agreement and its scales' rel_l2."""
    fields = {}
    for i, name in ((1, "knew"), (3, "vnew")):
        diff = (out[i].int() - ref[i].int()).abs()
        agree = float((diff == 0).float().mean())
        check(int(diff.max()) <= 1 and agree >= K5_KV_AGREE,
              f"{what} {name}: max diff {int(diff.max())}, agree {agree:.5f}")
        fields[f"{name}_agree"] = agree
        fields[f"{name}_s_rel_l2"] = rel_l2(out[i + 1], ref[i + 1])
    return fields


def kernel_cases(dev):
    """The phase-2 cases, at the shapes of the serving paths."""
    import torch
    import torch.nn.functional as F

    A, Q, M, _ = kernel_modules()
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf)

    cases = []

    def attn(name, b, h, s, d, causal=False, seg=None, iters=5):
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        kw = dict(causal=causal, segment_ids=seg)
        mask = _attention_mask(b, s, s, causal, seg, dev)
        pairs = float(mask.sum()) * h
        lib_mask = None if (seg is None and not causal) else mask
        cases.append(Case(
            "K1 flash_attention", name, lambda: A.flash_attention(q, k, v, **kw),
            lambda: A.mha_reference(q, k, v, **kw), 2e-2, iters, True,
            4 * b * h * s * d * 2 + (0 if seg is None else b * s * 4),
            {"bf16": 4.0 * pairs * d},
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask)))

    # CLIP ViT-L/14-336: 8 frames x 7 views, 16 heads, 577 tokens, no mask
    attn("clip(56,16,577,64)", 56, 16, 577, 64)
    # pooler: 7 views x 576 tokens, views 5 and 6 absent -> segment 0
    seg = torch.ones(8, 4032, dtype=torch.int32, device=dev)
    seg[:, 5 * 576:] = 0
    attn("pooler(8,8,4032,128)+2 views masked", 8, 8, 4032, 128, seg=seg, iters=3)
    # LLaMA prefill: causal + left padding (row r has 8r pad tokens)
    seg = torch.ones(8, 708, dtype=torch.int32, device=dev)
    for r in range(8):
        seg[r, : 8 * r] = 0
    attn("llama_prefill(8,32,708,128)causal+leftpad", 8, 32, 708, 128,
         causal=True, seg=seg)
    # PTv3 stage 0: 1024-point patches, invalid tail -> -1 (cut from 65536
    # points to 8192 so the plain version's logits fit)
    seg = (torch.arange(8192, device=dev, dtype=torch.int32) // 1024)[None].repeat(2, 1)
    seg[:, 7000:] = -1
    attn("ptv3(2,2,8192,16)patches", 2, 2, 8192, 16, seg=seg)

    # K2 at decode (M=8) and prefill (M=8x708) rows over the four weights
    for m in (8, 5664):
        for kdim, n in ((4096, 4096), (4096, 11264), (11264, 4096), (4096, 32000)):
            x = randn(m, kdim)
            w_q, scale = Q.quantize_weights(
                torch.randn(kdim, n, generator=g, device=dev) * 0.02)
            w_p = Q.pack_int8_rows(w_q)
            library, rows = int_mm_library(*Q.quantize_rows(x), w_q, scale, bf)
            # the served lm_head runs on the last position only
            # (models/llama.py's last_logit_only), so at M = 5664 the
            # 32000-column case is a valid K2 shape on no path
            cases.append(Case(
                "K2 int8_matmul_packed", f"w8a8 M={m} K={kdim} N={n} library_rows={rows}",
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed(x, w_p, s),
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(x, w_p, s),
                1e-3, 10 if m == 8 else 3, m == 8 or n != 32000,
                m * kdim * 2 + kdim * n + n * 4 + m * n * 2, {"int8": 2.0 * m * kdim * n},
                library=library, exact=True))
    # W8A16 (quant_int8_mxu=False): phase 14's decode rows at the q, k, v
    # and o projections (the branch's other shapes: _k2_a16_cases)
    x = randn(8, 4096)
    w_q, scale = Q.quantize_weights(torch.randn(4096, 4096, generator=g, device=dev) * 0.02)
    cases.append(k2_a16_case(x, w_q, scale, "w8a16 M=8 K=4096 N=4096", 10, True))
    cases.extend(_edge_cases(dev))

    # K3 at the int4 path's prefill rows (M=8x708) and at decode rows over
    # the fused projections: qkv, o, gate_up (ffn padded to 11264), down
    for m in (8, 5664):
        for kdim, n in K3_SHAPES:
            x = randn(m, kdim)
            w_q, scale = Q.quantize_weights_int4(
                torch.randn(kdim, n, generator=g, device=dev) * 0.02, 1024)
            w_p = Q.pack_int4_rows(w_q, 1024)
            cases.append(Case(
                "K3 int4_matmul_packed", f"w4a8 M={m} K={kdim} N={n}",
                lambda x=x, w_p=w_p, s=scale: Q.int4_matmul_packed(x, w_p, s),
                lambda x=x, w_p=w_p, s=scale: Q.int4_matmul_packed_plain(x, w_p, s),
                1e-3, 10 if m == 8 else 3, m == 5664,
                m * kdim * 2 + kdim * n // 2 + (kdim // 1024) * n * 4 + m * n * 2,
                {"int8": 2.0 * m * kdim * n}, exact=True))

    # K4: B=8, H=32, D=128, T=1008, a partly masked cache, layer 17 of 32
    L, B, H, T, D = 32, 8, 32, 1008, 128
    k_st = torch.randint(-127, 128, (L, B, H, T, D), generator=g, device=dev,
                         dtype=torch.int8)
    v_st = torch.randint(-127, 128, (L, B, H, T, D), generator=g, device=dev,
                         dtype=torch.int8)
    ks = (torch.rand(L, B, H, T, generator=g, device=dev) * 0.02 + 0.005).to(bf)
    vs = (torch.rand(L, B, H, T, generator=g, device=dev) * 0.02 + 0.005).to(bf)
    mask = torch.zeros(B, T, dtype=torch.int32, device=dev)
    for r in range(B):
        mask[r, 8 * r: 708 + 37 * r] = 1
    q = randn(B, H, 1, D)
    args = (q, k_st, v_st, ks, vs, mask, 17)
    valid = int(mask.sum())
    cases.append(Case(
        "K4 decode_attention_packed_stack", "B=8 H=32 T=1008 D=128 layer 17",
        lambda: A.decode_attention_packed_stack(*args),
        lambda: A.decode_attention_packed_stack_plain(*args), 1e-2, 20, True,
        H * valid * 2 * (D + 2) + B * T * 4 + 2 * B * H * D * 2,
        {"cuda_core": 4.0 * H * valid * D}))

    cases.extend(_k5_cases(dev, g))
    cases.extend(_k6_cases(dev, g))
    # K5-int8 at the other width pairs, from a generator of their own so
    # that the cases above keep their inputs: (8, 8) with and without pf
    # rows (phases 10 and 11), and the mixed pairs the JAX package tests
    g8 = torch.Generator(device=dev).manual_seed(8)
    cases.extend(_k5_cases(dev, g8, 8, 8))
    for wbits, kvbits in ((4, 8), (8, 4)):
        cases.extend(_k5_cases(dev, g8, wbits, kvbits, with_pf=False, on_path=False))
    cases.extend(_perf_cases(dev))
    cases.extend(_k3_a16_cases(dev))
    cases.extend(_k2_a16_cases(dev))
    cases.extend(_decode_attention_edge_cases(dev))
    cases.extend(_tail_gather_cases(dev))
    cases.extend(_probe_cases(dev))
    # last, so that every case before it meets the card as it did before
    # the weight core had cases of its own
    cases.extend(_core_cases(dev))
    return cases


def _edge_cases(dev):
    """K1 and K2 off the serving shapes, where their tiles and masks have
    edges (inputs from a generator of their own): K1 at each head dim with
    unsorted segment ids on separate keys and Sq != Sk, causal with Sq < Sk,
    and ragged lengths against the 64- and 128-row tiles with left padding;
    rows whose segment no key carries (held to 0, the plain version's rows
    zeroed to match); K2 bit for bit at M 17, 100 and 5667 with N 4100 and
    K 4160 (a multiple of 64, not of the 128-deep k tile), at N % 4 != 0 and
    with f32 x."""
    import torch

    A, Q, _, _ = kernel_modules()
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    cases = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def ids(b, s, hi):
        return torch.randint(0, hi, (b, s), generator=g, device=dev, dtype=torch.int32)

    for d in (16, 32, 64, 128):
        for what, b, h, sq, sk, causal, seg, kv_seg in (
                ("unsorted_kv_ids", 2, 3, 200, 333, False, ids(2, 200, 3), ids(2, 333, 3)),
                ("causal_sq<sk", 2, 2, 100, 260, True, None, None),
                ("ragged_leftpad_causal", 3, 2, 191, 191, True, None, None)):
            if what.startswith("ragged"):
                seg = torch.ones(b, sq, dtype=torch.int32, device=dev)
                for r in range(b):
                    seg[r, : 61 * r] = 0
            q, k, v = randn(b, h, sq, d), randn(b, h, sk, d), randn(b, h, sk, d)
            kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
            mask = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=dev)
            if causal:
                mask &= torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
            if seg is not None:
                kseg = seg if kv_seg is None else kv_seg
                mask &= seg[:, None, :, None] == kseg[:, None, None, :]
            cases.append(Case(
                "K1 flash_attention", f"edge_{what}({b},{h},{sq},{sk},{d})",
                lambda q=q, k=k, v=v, kw=kw: A.flash_attention(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: A.mha_reference(q, k, v, **kw), 2e-2, 3, False,
                2 * b * h * (sq + 2 * sk) * d, {"bf16": 4.0 * float(mask.sum()) * h * d}))
        # rows 150.. carry a segment no key has: the kernel stores 0 there
        q, k, v = randn(1, 2, 300, d), randn(1, 2, 300, d), randn(1, 2, 300, d)
        seg = torch.zeros(1, 300, dtype=torch.int32, device=dev)
        seg[:, 150:] = 5
        kw = dict(segment_ids=seg, kv_segment_ids=torch.zeros_like(seg))

        def extra(out, ref):
            zero = not bool(out[:, :, 150:].any())
            check(zero, "K1: a row with no visible key is not 0")
            return {"no_key_rows_zero": zero}

        def plain(q=q, k=k, v=v, kw=kw):
            ref = A.mha_reference(q, k, v, **kw)
            ref[:, :, 150:] = 0
            return ref

        cases.append(Case(
            "K1 flash_attention", f"edge_no_key_rows(1,2,300,300,{d})",
            lambda q=q, k=k, v=v, kw=kw: A.flash_attention(q, k, v, **kw), plain, 2e-2, 3,
            False, 2 * 2 * 900 * d, {"bf16": 4.0 * 150 * 300 * 2 * d}, extra=extra))

    for m, kdim, n, dtype in ((17, 4160, 4100, bf), (100, 4160, 4100, bf),
                              (5667, 4160, 4100, bf), (100, 256, 90, bf),
                              (70, 128, 64, torch.float32)):
        x = torch.randn(m, kdim, generator=g, device=dev).to(dtype)
        w_q, scale = Q.quantize_weights(torch.randn(kdim, n, generator=g, device=dev) * 0.02)
        w_p = Q.pack_int8_rows(w_q)
        cases.append(Case(
            "K2 int8_matmul_packed", f"edge w8a8 M={m} K={kdim} N={n} {str(dtype)[6:]}",
            lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed(x, w_p, s),
            lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(x, w_p, s),
            1e-3, 3, False, m * kdim * x.element_size() + kdim * n + n * 4
            + m * n * x.element_size(), {"int8": 2.0 * m * kdim * n}, exact=True))
    return cases


def k2_a16_case(x, w_q, scale, name: str, iters: int, on_path: bool):
    """One case of K2's W8A16 branch on x and the int8 weight ``w_q`` with
    its column scales: within K2_A16_BOUND of the plain version, the bound
    the larger of the bytes and the bf16 operations, the library one
    ``torch.matmul`` of x and the weight dequantized to x's dtype (the
    dequantization not timed)."""
    import torch

    Q = kernel_modules()[1]
    m, kdim = x.shape
    n = w_q.shape[1]
    w_p = Q.pack_int8_rows(w_q)
    w_deq = (w_q.float() * scale[None, :]).to(x.dtype)
    size = x.element_size()
    return Case(
        "K2-w8a16 int8_matmul_packed(w8a16)", f"{name} library=torch.matmul(x,dequantized_w)",
        lambda: Q.int8_matmul_packed(x, w_p, scale, int8_mxu=False),
        lambda: Q.int8_matmul_packed_plain(x, w_p, scale, int8_mxu=False),
        K2_A16_BOUND["bf16" if x.dtype == torch.bfloat16 else "f32"], iters, on_path,
        m * kdim * size + kdim * n + n * 4 + m * n * size, {"bf16": 2.0 * m * kdim * n},
        library=lambda: torch.matmul(x, w_deq))


def _k2_a16_cases(dev):
    """K2's W8A16 branch (``int8_mxu=False``) at phase 14's rows, decode (M
    8; M 8 x 4096 x 4096 is in ``kernel_cases``) and prefill (M 8 x 708),
    over K2_SHAPES, and at the lm_head (M 8 x 4096 x 32000: the decode steps
    of phases 13 and 14); then off the serving shapes: one row, 16 and 17
    rows (the edges of the two kernels), N % 4 != 0 (cp.async words) off
    the 128-column tiles, K % 128 != 0, more than one 256-row tile with the
    last ragged, and f32 x. Inputs from a generator of their own."""
    import torch

    g = torch.Generator(device=dev).manual_seed(13)
    cases = []
    serving = [(m, k, n) for m in (8, 5664) for k, n in K2_SHAPES if (m, k, n) != (8, 4096, 4096)]
    edges = [(1, 4096, 4096, torch.bfloat16), (16, 4096, 4100, torch.bfloat16),
             (17, 4160, 4100, torch.bfloat16), (300, 256, 90, torch.bfloat16),
             (5667, 4160, 4100, torch.bfloat16), (13, 192, 70, torch.float32),
             (100, 4160, 4100, torch.float32)]
    for m, kdim, n, dtype in ([(m, k, n, torch.bfloat16) for m, k, n in serving]
                              + [(8, 4096, 32000, torch.bfloat16)] + edges):
        x = torch.randn(m, kdim, generator=g, device=dev).to(dtype)
        w_q, scale = kernel_modules()[1].quantize_weights(
            torch.randn(kdim, n, generator=g, device=dev) * 0.02)
        edge = (m, kdim, n, dtype) in edges
        name = f"{'edge ' if edge else ''}w8a16 M={m} K={kdim} N={n}" + (
            f" {str(dtype)[6:]}" if edge else "")
        cases.append(k2_a16_case(x, w_q, scale, name, 3 if m > 16 or edge else 10, not edge))
    return cases


def _decode_attention_edge_cases(dev):
    """K4 and K7 off the serving shapes, where the cluster's ranks and the
    skipped positions have edges (inputs from a generator of their own): 8
    ranks of 128 positions at batch 1 with a row of one valid position; T
    not a multiple of a rank's span, with a left-padded row, a row whose one
    valid position is the last, and a row with no valid position (equal
    weights over all of T), at head dim 64 with f32 q; K4 on the last layer
    of a stack with a fully masked row; head dims 256 and 16. Bounds as on
    the serving shapes: K7_BOUND, and K4's 1e-2 (its plain version rounds
    the weights to bf16)."""
    import torch

    A = kernel_modules()[0]
    g = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16
    cases = []

    def inputs(lead, t, d, sdt):
        kv = [torch.randint(-127, 128, (*lead, t, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2)]
        sc = [(torch.rand(*lead, t, generator=g, device=dev) * 0.02 + 0.005).to(sdt)
              for _ in range(2)]
        return kv + sc

    def nbytes(h, mask, d, ssize):
        loaded = sum(int(r.sum()) if r.any() else r.numel() for r in mask)
        return h * loaded * 2 * (d + ssize) + mask.numel() * 4 + 2 * mask.shape[0] * h * d * 2

    for what, b, h, t, d, qdt, sdt, rows in (
            ("ranks=8 valid_len=1", 1, 32, 1024, 128, bf, torch.float32, ((500, 501),)),
            ("T=1000 leftpad,last_only,none", 3, 4, 1000, 64, torch.float32, bf,
             ((37, 1000), (999, 1000), (0, 0))),
            ("D=256", 2, 2, 300, 256, bf, bf, ((0, 300), (10, 150))),
            ("D=16", 2, 3, 130, 16, bf, torch.float32, ((0, 1), (64, 130)))):
        k8, v8, ks, vs = inputs((b, h), t, d, sdt)
        mask = torch.zeros(b, t, dtype=torch.int32, device=dev)
        for r, (lo, hi) in enumerate(rows):
            mask[r, lo:hi] = 1
        q = torch.randn(b, h, 1, d, generator=g, device=dev).to(qdt)
        args = (q, k8, v8, ks, vs, mask)
        cases.append(Case(
            "K7 decode_attention_packed", f"edge {what} B={b} H={h} T={t} D={d}",
            lambda a=args: A.decode_attention_packed(*a),
            lambda a=args: A.decode_attention_packed_plain(*a), K7_BOUND, 5, False,
            nbytes(h, mask, d, ks.element_size()), {"cuda_core": 4.0 * h * b * t * d}))
    L, b, h, t, d = 2, 2, 8, 333, 128
    k8, v8, ks, vs = inputs((L, b, h), t, d, bf)
    mask = torch.zeros(b, t, dtype=torch.int32, device=dev)
    mask[1, 5:200] = 1  # row 0: no valid position
    q = torch.randn(b, h, 1, d, generator=g, device=dev).to(bf)
    args = (q, k8, v8, ks, vs, mask, L - 1)
    cases.append(Case(
        "K4 decode_attention_packed_stack", f"edge last_layer masked_row B={b} H={h} T={t} D={d}",
        lambda: A.decode_attention_packed_stack(*args),
        lambda: A.decode_attention_packed_stack_plain(*args), 1e-2, 5, False,
        nbytes(h, mask, d, 2), {"cuda_core": 4.0 * h * b * t * d}))
    return cases


def _k3_a16_cases(dev):
    """K3's W4A16 branch (``int8_mxu=False``) at decode rows (M 8 and 14,
    off every path: phase 13 decodes through K5) and at phase 13's prefill
    rows (M 8 x 708) over the four 7B projections in 1024-row groups,
    within K3_A16_BOUND of its plain version (the JAX CPU path); the bound
    is the bf16 operations, the library one ``torch.matmul`` of x and the
    weight dequantized to bf16 (the dequantization not timed); then K3's
    two branches off the serving shapes: one row past the decode kernels
    with N % 4 != 0 (cp.async words), 8 groups of 256 with N off the
    128-column tiles, and f32 x. Inputs from a generator of their own."""
    import torch

    Q = kernel_modules()[1]
    g = torch.Generator(device=dev).manual_seed(12)
    cases = []
    for m in (8, 14, 5664):
        for kdim, n in K3_SHAPES:
            x = torch.randn(m, kdim, generator=g, device=dev).to(torch.bfloat16)
            w_q, scale = Q.quantize_weights_int4(
                torch.randn(kdim, n, generator=g, device=dev) * 0.02, 1024)
            w_p = Q.pack_int4_rows(w_q, 1024)
            w_bf = (w_q.float().reshape(kdim // 1024, 1024, n) * scale[:, None, :]).reshape(
                kdim, n).to(torch.bfloat16)
            cases.append(Case(
                "K3-w4a16 int4_matmul_packed(w4a16)",
                f"w4a16 M={m} K={kdim} N={n} library=torch.matmul(x,dequantized_bf16_w)",
                lambda x=x, w_p=w_p, s=scale: Q.int4_matmul_packed(x, w_p, s, int8_mxu=False),
                lambda x=x, w_p=w_p, s=scale: Q.int4_matmul_packed_plain(x, w_p, s,
                                                                         int8_mxu=False),
                K3_A16_BOUND["bf16"], 10 if m < 16 else 3, m == 5664,
                m * kdim * 2 + kdim * n // 2 + (kdim // 1024) * n * 4 + m * n * 2,
                {"bf16": 2.0 * m * kdim * n},
                library=lambda x=x, w_bf=w_bf: torch.matmul(x, w_bf)))
    for m, kdim, n, group, dtype in ((17, 512, 130, 256, torch.bfloat16),
                                     (300, 2048, 4100, 256, torch.bfloat16),
                                     (300, 1024, 256, 1024, torch.float32)):
        x = torch.randn(m, kdim, generator=g, device=dev).to(dtype)
        w_q, scale = Q.quantize_weights_int4(
            torch.randn(kdim, n, generator=g, device=dev) * 0.02, group)
        w_p = Q.pack_int4_rows(w_q, group)
        nbytes = (m * kdim * x.element_size() + kdim * n // 2 + (kdim // group) * n * 4
                  + m * n * x.element_size())
        what = f"M={m} K={kdim} N={n} group={group} {str(dtype)[6:]}"
        cases.append(Case(
            "K3 int4_matmul_packed", f"edge w4a8 {what}",
            lambda x=x, w_p=w_p, s=scale, gr=group: Q.int4_matmul_packed(x, w_p, s, group=gr),
            lambda x=x, w_p=w_p, s=scale, gr=group: Q.int4_matmul_packed_plain(x, w_p, s,
                                                                               group=gr),
            1e-3, 3, False, nbytes, {"int8": 2.0 * m * kdim * n}, exact=True))
        cases.append(Case(
            "K3-w4a16 int4_matmul_packed(w4a16)", f"edge w4a16 {what}",
            lambda x=x, w_p=w_p, s=scale, gr=group: Q.int4_matmul_packed(
                x, w_p, s, group=gr, int8_mxu=False),
            lambda x=x, w_p=w_p, s=scale, gr=group: Q.int4_matmul_packed_plain(
                x, w_p, s, group=gr, int8_mxu=False),
            K3_A16_BOUND["bf16" if dtype == torch.bfloat16 else "f32"], 3, False, nbytes,
            {"bf16": 2.0 * m * kdim * n}))
    return cases


def _perf_cases(dev):
    """K2, K7, K8, K10a and K10b at the perf tools' shapes (phase 12's path):
    one layer of each weight stream at M 16 and at both benches' widths
    (N 11264: ``bench_stream``, ``bench_packed``; N 11008: ``bench_w8a16``),
    K8 bit for bit, K10b at int8 and int4 (N 11264, as both benches run
    it); K7 on one layer of ``bench_decode_parts``' cache (B 14, H 32,
    T 1024, D 128) with left-padded rows, at f32 scales (the tool's, with
    the bf16-cast control) and bf16 ones; and K2 bit for bit at that
    tool's batch over the 7B projections' and the lm_head's shapes. Inputs
    come from a generator of their own, so the cases before keep theirs."""
    import torch

    from mmor_tpu_torch.config import LlamaConfig
    from mmor_tpu_torch.tools.perf import bench_decode_parts

    A, Q, _, _ = kernel_modules()
    W, P, _, _ = perf_modules()
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    cases = []
    m, kdim = 16, 4096
    x = torch.randn(m, kdim, generator=g, device=dev).to(bf)
    for n in (11264, 11008):
        w_q, scale = Q.quantize_weights(torch.randn(kdim, n, generator=g, device=dev) * 0.02)
        nbytes = m * kdim * 2 + kdim * n + n * 4 + m * n * 2
        library, rows = int_mm_library(*Q.quantize_rows_div(x), w_q, scale, bf)
        cases.append(Case(
            "K8 int8_matmul", f"w8a8 M={m} K={kdim} N={n} library_rows={rows}",
            lambda w_q=w_q, s=scale: Q.int8_matmul(x, w_q, s),
            lambda w_q=w_q, s=scale: Q.int8_matmul_plain(x, w_q, s), 1e-3, 20, True,
            nbytes, {"int8": 2.0 * m * kdim * n}, library=library, exact=True))
        int8pack = weight_int8pack_library(x, w_q, scale)
        cases.append(Case(
            "K10a w8a16_matmul", f"w8a16 M={m} K={kdim} N={n}",
            lambda w_q=w_q, s=scale: W.w8a16_matmul(x, w_q, s),
            lambda w_q=w_q, s=scale: W.w8a16_matmul_plain(x, w_q, s), 1e-3, 20, True,
            nbytes, {"bf16": 2.0 * m * kdim * n}, library=int8pack))
        if n != 11264:
            continue
        w4, s4 = P.quantize_int4_channels(
            torch.randn(1, kdim, n, generator=g, device=dev) * 0.02)
        for name, parts, bits, w_p, sc, library in (
                ("w8p", 4, 8, P.pack4_int8(w_q), scale, int8pack),
                ("w4p", 8, 4, P.pack8_int4(w4[0]), s4[0],
                 weight_int4pack_library(x, w4[0], s4[0]))):
            kw = dict(parts=parts, bits=bits)
            cases.append(Case(
                "K10b wp_matmul", f"{name} M={m} K={kdim} N={n}",
                lambda w_p=w_p, sc=sc, kw=kw: P.wp_matmul(x, w_p, sc, **kw),
                lambda w_p=w_p, sc=sc, kw=kw: P.wp_matmul_plain(x, w_p, sc, **kw),
                1e-3, 20, True, m * kdim * 2 + kdim * n * bits // 8 + n * 4 + m * n * 2,
                {"bf16": 2.0 * m * kdim * n}, library=library))

    B, H, T, D = 14, 32, 1024, 128
    k8, v8 = (torch.randint(-127, 128, (B, H, T, D), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    mask = torch.zeros(B, T, dtype=torch.int32, device=dev)
    for r in range(B):
        mask[r, 32 * r:] = 1  # row r left-padded by 32r positions
    q = torch.randn(B, H, 1, D, generator=g, device=dev).to(bf)
    valid = int(mask.sum())

    def bf16_cast_control(out, ref, ks, vs):
        """The kernel on bf16 copies of the f32 scales must miss K7_BOUND."""
        err = rel_l2(A.decode_attention_packed(q, k8, v8, ks.to(bf), vs.to(bf), mask), ref)
        check(err > K7_BOUND, f"K7 bf16-cast control at rel_l2 {err:.3e} <= {K7_BOUND:.0e}")
        return {"bf16_cast_control_rel_l2": f"{err:.3e}"}

    for sdt, on_path in ((torch.float32, True), (bf, False)):
        ks, vs = ((torch.rand(B, H, T, generator=g, device=dev) * 0.02 + 0.005).to(sdt)
                  for _ in range(2))
        args = (q, k8, v8, ks, vs, mask)
        control = (lambda out, ref, ks=ks, vs=vs: bf16_cast_control(out, ref, ks, vs)
                   ) if sdt == torch.float32 else None
        cases.append(Case(
            "K7 decode_attention_packed",
            f"B={B} H={H} T={T} D={D} leftpad {str(sdt).split('.')[-1]} scales",
            lambda a=args: A.decode_attention_packed(*a),
            lambda a=args: A.decode_attention_packed_plain(*a), K7_BOUND, 20, on_path,
            H * valid * 2 * (D + ks.element_size()) + B * T * 4 + 2 * B * H * D * 2,
            {"cuda_core": 4.0 * H * valid * D}, extra=control))

    cfg, mb = LlamaConfig(), bench_decode_parts.B
    for kdim, n in sorted({*bench_decode_parts.projection_shapes(cfg),
                           (cfg.dim, cfg.vocab_size)}):
        xb = torch.randn(mb, kdim, generator=g, device=dev).to(bf)
        w_q, scale = Q.quantize_weights(torch.randn(kdim, n, generator=g, device=dev) * 0.02)
        w_p = Q.pack_int8_rows(w_q)
        library, rows = int_mm_library(*Q.quantize_rows(xb), w_q, scale, bf)
        cases.append(Case(
            "K2 int8_matmul_packed", f"w8a8 M={mb} K={kdim} N={n} library_rows={rows}",
            lambda xb=xb, w_p=w_p, s=scale: Q.int8_matmul_packed(xb, w_p, s),
            lambda xb=xb, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(xb, w_p, s),
            1e-3, 10, True, mb * kdim * 2 + kdim * n + n * 4 + mb * n * 2,
            {"int8": 2.0 * mb * kdim * n}, library=library, exact=True))
    return cases


def one_bf16_step(out, ref) -> dict:
    """Every output within one bf16 rounding step, at the largest output,
    of its plain value (the benches' spot-check convention). Both versions
    round an f32 sum of the same exact products once, summed in another
    order, so an output that cancels to near zero may sit several of its
    own steps away; the count of those is reported."""
    import torch

    o, r = out.float(), ref.float()
    top = torch.exp2(torch.floor(torch.log2(r.abs().max())) - 7)
    steps = float((o - r).abs().max() / top)
    check(steps <= 1.0, f"outputs {steps:.3f} bf16 steps (at the largest output) from "
                        "their plain values")
    own = torch.exp2(torch.floor(torch.log2(torch.maximum(o.abs(), r.abs()).clamp_min(
        torch.finfo(torch.float32).tiny))) - 7)
    return {"max_abs_in_top_bf16_steps": f"{steps:.3f}",
            "beyond_own_bf16_step": int(((o - r).abs() > own).sum())}


def _tail_gather_cases(dev):
    """K9 at the 7B decode tail (D = Dq = 4096, F = 11008, batch 8 and 14,
    bf16 activations and residual), with the same tail unfused through three
    K2 W8A16 launches or three K10c bf16-mode launches and eager ops timed
    beside it (``k2_chain_ms``, ``k10c_chain_ms``) and cuBLAS bf16 on the
    dequantized weights as the library call, and at batch 14 with an f32
    residual (off the path: the error without the output's bf16 rounding); K10c in both
    modes at ``bench_bitcast``'s M 16 x 4096 x 11264 (mxu8 bit for bit, bf16
    within one bf16 step at the largest output); K10d at ``bench_dma_gather``'s 2^18
    windows, bit for bit, torch indexing of the same windows as the library
    call. Inputs from a generator of their own."""
    import torch

    from mmor_tpu_torch.config import LlamaConfig
    from mmor_tpu_torch.ops import fused_mlp
    from mmor_tpu_torch.tools.perf import bench_fused_mlp as FM

    _, Q, _, _ = kernel_modules()
    _, _, BC, DG = perf_modules()
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    cases = []
    cfg = LlamaConfig()
    dq, d, f = cfg.dim, cfg.dim, cfg.ffn_dim
    ops = FM.tail_operands(14, dq, d, f, dev, g)
    deq = [FM.dequantized(ops[i], ops[i + 1]) for i in (3, 5, 7)]
    wbytes = FM.weight_bytes(dq, d, f)
    for b in (8, 14):
        args = (ops[0][:b].contiguous(), ops[1][:b].contiguous(), *ops[2:])

        def chain(out, ref, args=args):
            return {f"{name}_ms": f"{time_ms(lambda: fn(*args), 10)[0]:.4f}"
                    for name, fn in (("k2_chain", FM.k2_chain), ("k10c_chain", FM.k10c_chain))}

        cases.append(Case(
            "K9 fused_o_mlp", f"7B tail B={b} D={d} F={f}",
            lambda a=args: fused_mlp.fused_o_mlp(*a),
            lambda a=args: fused_mlp.fused_o_mlp_plain(*a), K9_BOUND, 20, True,
            wbytes + (4 * d + 2 * f) * 4 + b * (dq + 2 * d) * 2, {"bf16": 2.0 * b * wbytes},
            library=lambda a=args: FM.library_tail(*a[:3], *deq), extra=chain))
    # the same tail with an f32 residual, so an f32 output: no rounding of
    # the output itself, which at bf16 turns the h and m roundings' small
    # moves into whole bf16 steps of some outputs (not on a path)
    args = (ops[0], ops[1].float(), *ops[2:])
    cases.append(Case(
        "K9 fused_o_mlp", f"7B tail B=14 D={d} F={f} f32 residual",
        lambda: fused_mlp.fused_o_mlp(*args), lambda: fused_mlp.fused_o_mlp_plain(*args),
        K9_BOUND, 20, False, wbytes + (4 * d + 2 * f) * 4 + 14 * (dq * 2 + 2 * d * 4),
        {"bf16": 2.0 * 14 * wbytes}))

    m, kdim, n = 16, 4096, 11264
    x = torch.randn(m, kdim, generator=g, device=dev).to(bf)
    w_q, scale = Q.quantize_weights(torch.randn(kdim, n, generator=g, device=dev) * 0.02)
    w_p = BC.pack_rows_int8(w_q)
    nbytes = m * kdim * 2 + kdim * n + n * 4 + m * n * 2
    library, rows = int_mm_library(*Q.quantize_rows_div(x), w_q, scale, bf)
    cases.append(Case(
        "K10c w8b_matmul(mxu8)", f"mxu8 M={m} K={kdim} N={n} library_rows={rows}",
        lambda: BC.w8b_matmul(x, w_p, scale, mode="mxu8"),
        lambda: BC.w8b_matmul_plain(x, w_p, scale, mode="mxu8"), 1e-3, 20, True, nbytes,
        {"int8": 2.0 * m * kdim * n}, library=library, exact=True))
    cases.append(Case(
        "K10c w8b_matmul(bf16)", f"bf16 M={m} K={kdim} N={n}",
        lambda: BC.w8b_matmul(x, w_p, scale), lambda: BC.w8b_matmul_plain(x, w_p, scale),
        1e-3, 20, True, nbytes, {"bf16": 2.0 * m * kdim * n},
        library=weight_int8pack_library(x, w_q, scale), extra=one_bf16_step))
    # mxu8 above one 16-row tile: K2's wgmma kernel with K8's activation rule
    x100 = torch.randn(100, kdim, generator=g, device=dev).to(bf)
    cases.append(Case(
        "K10c w8b_matmul(mxu8)", f"mxu8 M=100 K={kdim} N={n}",
        lambda: BC.w8b_matmul(x100, w_p, scale, mode="mxu8"),
        lambda: BC.w8b_matmul_plain(x100, w_p, scale, mode="mxu8"), 1e-3, 5, False,
        100 * kdim * 2 + kdim * n + n * 4 + 100 * n * 2, {"int8": 2.0 * 100 * kdim * n},
        exact=True))

    idx, fmap = DG.make_inputs(1 << 18, dev)
    nw = idx.shape[0]
    cases.append(Case(
        "K10d dma_gather", f"N={nw} map={DG.H}x{DG.W}x{DG.C}",
        lambda: DG.dma_gather(idx, fmap), lambda: DG.dma_gather_plain(idx, fmap), 0.0, 20,
        True, nw * 2 * 4 + fmap.numel() * 2 + nw * 2 * 16 * DG.C * 2, {},
        library=lambda: DG.torch_windows(idx, fmap), exact=True))
    return cases


def _probe_cases(dev):
    """K10e and K10f at ``bench_megakernel_probe``'s and
    ``probe_mosaic_reshape``'s shapes (phase 12's path), on seeded inputs
    from a generator of their own: the x-read product at M 24 x 4096 x
    11264 on int8 x (bit for bit, both x layouts; ``torch._int_mm`` with the
    rescale as the library call) and bf16 x (off the path; within one bf16
    step; ``torch._weight_int8pack_mm``); the tiny kernel on (16, 256) bf16
    (bit for bit; the eager ``x * 1.0`` is the library call); the nibble
    product at the same shape (one bf16 step; ``torch._weight_int4pack_mm``);
    the row probe over 48 (16 x 128, 1024) key blocks, static and dynamic
    (the full acc within PROBE_BOUND, the output rows within one bf16 step);
    K10f's copies (bit for bit; ``.clone()``) and products (PROBE_BOUND;
    ``torch.matmul``, none for e, whose S^T no one call builds)."""
    import torch

    _, Q, _, _ = kernel_modules()
    MP, RP = probe_modules()
    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    cases = []
    m, kdim, n, ck = MP.M, MP.K, MP.N, MP.CK
    w_q = torch.randint(-127, 128, (kdim, n), generator=g, device=dev, dtype=torch.int8)
    w_p = Q.pack_int8_rows(w_q)
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.005
    x = torch.randn(m, kdim, generator=g, device=dev).to(bf)
    for x8 in (True, False):
        mpad = MP.xread_mpad(m, x8)
        xr = torch.zeros(mpad, kdim, dtype=torch.int8 if x8 else bf, device=dev)
        xr[:m] = torch.clamp(torch.round(x.float() * 4.0), -127, 127).to(torch.int8) if x8 else x
        if x8:
            library = int_mm_library(xr, torch.ones(mpad, device=dev), w_q, scale, bf)[0]
        else:
            library = weight_int8pack_library(xr, w_q, scale)
        for layout, xx in (("stack", MP.tile_stack(xr, ck)), ("dslice", xr)):
            cases.append(Case(
                f"K10e xread_matmul({layout})",
                f"{'int8' if x8 else 'bf16'} M={m} mpad={mpad} K={kdim} N={n}",
                lambda xx=xx: MP.xread_matmul(xx, w_p, scale),
                lambda xx=xx: MP.xread_matmul_plain(xx, w_p, scale), 1e-3, 20, x8,
                xr.numel() * xr.element_size() + kdim * n + n * 4 + mpad * n * 2,
                {"int8" if x8 else "bf16": 2.0 * mpad * kdim * n}, library=library,
                extra=None if x8 else one_bf16_step, exact=x8))

    xs = torch.randn(16, 256, generator=g, device=dev).to(bf)
    cases.append(Case(
        "K10e tiny", "(16,256) bf16", lambda: MP.tiny(xs), lambda: MP.tiny_plain(xs), 0.0, 20,
        True, 2 * xs.numel() * 2, {}, library=lambda: xs * MP.TINY_BF16, exact=True))

    w4 = torch.randint(-8, 8, (kdim, n), generator=g, device=dev, dtype=torch.int8)
    w_p4 = MP.pack_nibble_words(w4)
    mpad = MP.xread_mpad(m, False)
    xi = MP.deinterleave_chunks(x, ck, mpad)
    xr = torch.zeros(mpad, kdim, dtype=bf, device=dev)
    xr[:m] = x
    cases.append(Case(
        "K10e nibble_matmul", f"w4a16 M={m} mpad={mpad} K={kdim} N={n}",
        lambda: MP.nibble_matmul(xi, w_p4, scale), lambda: MP.nibble_matmul_plain(xi, w_p4, scale),
        1e-3, 20, True, xi.numel() * 2 + kdim * n // 2 + n * 4 + mpad * n * 2,
        {"bf16": 2.0 * mpad * kdim * n}, library=weight_int4pack_library(xr, w4, scale),
        extra=one_bf16_step))

    b, hgn, heads, t = MP.ROWRW
    q = torch.randn(hgn, b, heads * 128, generator=g, device=dev).to(bf)
    kp = torch.randint(-2 ** 30, 2 ** 30, (hgn * b, heads, 32, t), generator=g, device=dev,
                       dtype=torch.int32)
    for dyn in (False, True):
        def rows_step(out, ref):
            return one_bf16_step(out[1], ref[1])

        cases.append(Case(
            "K10e rowrw", f"{'dyn' if dyn else 'static'} S={hgn * b} heads={heads} T={t}",
            lambda dyn=dyn: MP.rowrw(q, kp, dyn=dyn)[::-1],
            lambda dyn=dyn: MP.rowrw_plain(q, kp, dyn=dyn)[::-1], PROBE_BOUND, 20, True,
            q.numel() * 2 + kp.numel() * 4 + hgn * b * (heads * 128 + t) * 4,
            {"cuda_core": 2.0 * hgn * b * heads * 128 * t}, extra=rows_step))

    ones = dict(device=dev, dtype=torch.float32)
    tq, wh, ww, d, kk = RP.TQ, RP.WH, RP.WW, RP.D, RP.K
    s3, win = (torch.randn(tq, wh, ww, generator=g, **ones),
               torch.randn(wh, ww, d, generator=g, **ones))
    st = torch.randn(kk, tq, generator=g, **ones)
    for name, src, shape in (("a (TQ,WH,WW)->(TQ,K)", s3, (tq, kk)),
                             ("b (WH,WW,D)->(K,D)", win, (kk, d))):
        cases.append(Case(
            "K10f reshape_copy", name, lambda src=src, shape=shape: RP.reshape_copy(src, shape),
            lambda src=src, shape=shape: src.reshape(shape).clone(), 0.0, 20, True,
            2 * src.numel() * 4, {}, library=lambda src=src: src.clone(), exact=True))
    flops = {"cuda_core": 2.0 * tq * kk * d}
    for name, a, bb, mode, library in (
            ("c S^T (K,TQ) x (K,D)", st, win.reshape(kk, d), "transposed",
             lambda: torch.matmul(st.t(), win.reshape(kk, d))),
            ("d (TQ,WH,WW) x (WH,WW,D)", s3, win, "contracted",
             lambda: torch.matmul(s3.reshape(tq, kk), win.reshape(kk, d))),
            ("e one-hot S^T x (WH,WW,D)", None, win, "onehot", None)):
        nbytes = (0 if a is None else a.numel() * 4) + (kk * d + tq * d) * 4
        cases.append(Case(
            "K10f st_product", name,
            lambda a=a, bb=bb, mode=mode: RP.st_product(a, bb, mode=mode),
            lambda a=a, bb=bb, mode=mode: RP.st_product_plain(a, bb, mode=mode), PROBE_BOUND,
            20, True, nbytes, flops, library=library))
    return cases


def grid_sample_core(value, shapes, loc, attn):
    """The reference's ``ms_deform_attn_core_pytorch``: one ``grid_sample``
    a level (zero padding, ``align_corners=False``), then the weighted sum;
    K6's library yardstick (timed only). It samples in f32: a bf16 grid
    would place samples up to half a pixel off at these map widths."""
    import torch
    import torch.nn.functional as F

    n, _, m, d = value.shape
    _, lq, _, levels, points, _ = loc.shape
    values = value.float().split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    a = attn.transpose(1, 2).reshape(n * m, 1, lq, levels * points)
    out = (torch.stack(samples, dim=-2).flatten(-2) * a).sum(-1).view(n, m * d, lq)
    return out.transpose(1, 2).to(value.dtype).contiguous()


def k6_inputs(dev, g, shapes, n, m, d, dtype, spread_px=None):
    """K6's operands as the pixel decoder builds them: a query at every
    pixel centre of every level (Lq = S); offsets the reference's
    directional init (head h along angle 2 pi h / M, point p at p + 1
    pixels of the level) plus N(0, 0.3) pixels, or with ``spread_px``
    uniform in +-spread_px pixels (many samples off the map); weights
    softmaxed over L x P in the value's dtype; f32 locations."""
    import torch

    from mmor_tpu_torch.models.layers import offset_bias_grid

    levels, points = len(shapes), 4
    s = sum(h * w for h, w in shapes)
    refs = []
    for h, w in shapes:
        ys = (torch.arange(h, device=dev) + 0.5) / h
        xs = (torch.arange(w, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    refs = torch.cat(refs)  # (S, 2)
    if spread_px is None:
        off = offset_bias_grid(m, levels, points).to(dev).view(m, levels, points, 2)
        off = off + 0.3 * torch.randn(n, s, m, levels, points, 2, generator=g, device=dev)
    else:
        off = (torch.rand(n, s, m, levels, points, 2, generator=g, device=dev) * 2 - 1
               ) * spread_px
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    loc = refs[None, :, None, None, None, :] + off / norm[None, None, None, :, None, :]
    value = torch.randn(n, s, m, d, generator=g, device=dev).to(dtype)
    attn = torch.softmax(torch.randn(n, s, m, levels * points, generator=g, device=dev), -1)
    attn = attn.to(dtype).view(n, s, m, levels, points)
    return value, loc.float().contiguous(), attn


def _k6_cases(dev, g):
    """K6 at the panoptic serving shapes (3 frames of 736x1280 in bf16:
    levels 23x40, 46x80, 92x160, M=8, D=32), the same with offsets up to
    +-32 pixels, the CLI's 512x512 f32 shapes, and the tiny config's D=4."""
    import torch

    from mmor_tpu_torch.ops import deformable_sampler as D
    from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

    serving = ((23, 40), (46, 80), (92, 160))
    cases = []
    for name, shapes, d, dtype, spread, on_path in (
            ("serving N=3 736x1280 bf16 init offsets", serving, 32, torch.bfloat16, None, True),
            ("serving N=3 736x1280 bf16 offsets +-32px", serving, 32, torch.bfloat16, 32.0,
             False),
            ("cli N=3 512x512 f32", ((16, 16), (32, 32), (64, 64)), 32, torch.float32, None,
             False),
            ("tiny N=3 64x64 f32 D=4", ((2, 2), (4, 4), (8, 8)), 4, torch.float32, 3.0,
             False)):
        args = (*k6_inputs(dev, g, shapes, 3, 8, d, dtype, spread),)
        value, loc, attn = args
        nbytes = (value.numel() * value.element_size() * 2 + loc.numel() * 4
                  + attn.numel() * attn.element_size())  # value in, out, loc, attn
        ops = {"cuda_core": 8.0 * value.numel() * loc.shape[3] * loc.shape[4]}
        cases.append(Case(
            "K6 ms_deform_attn", name,
            lambda s=shapes, a=args: D.ms_deform_attn_sampler(a[0], s, a[1], a[2]),
            lambda s=shapes, a=args: ms_deform_attn(a[0], s, a[1], a[2]),
            K6_BOUND["bf16" if dtype == torch.bfloat16 else "f32"], 20, on_path,
            nbytes, ops,
            library=lambda s=shapes, a=args: grid_sample_core(a[0], s, a[1], a[2])))
    return cases


def phase_kernels(dev, summary: dict) -> None:
    """Per kernel: the largest max-abs error over its cases, and its, its
    bound's, the plain version's and the library call's times summed over
    the cases on a serving path."""
    import torch

    for case in kernel_cases(dev):
        out, ref = case.fn(), case.plain()
        torch.cuda.synchronize()
        extra = case.extra(out, ref) if case.extra else {}
        if isinstance(out, tuple):
            out, ref = out[0], ref[0]
        what = f"{case.kernel} {case.name}"
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{what}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite")
        err = rel_l2(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        exact = bool(torch.equal(out, ref))
        del out, ref
        ms, ahead = time_ms(case.fn, case.iters)
        plain_ms = time_ms(case.plain, max(1, case.iters // 3))[0]
        lib_ms = time_ms(case.library, case.iters)[0] if case.library else None
        bound_ms, bound_by = roofline_ms(case.nbytes, case.ops)
        say("2 kernel-vs-plain", kernel=case.kernel.split()[0],
            case=case.name.replace(" ", "_"), rel_l2=f"{err:.3e}", bound=f"{case.bound:.0e}",
            max_abs=f"{max_abs:.3e}", bit_exact=exact, ms=f"{ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, plain_ms=f"{plain_ms:.4f}",
            library_ms="none" if lib_ms is None else f"{lib_ms:.4f}",
            factor="none" if lib_ms is None else f"{ms / lib_ms:.3f}",
            host_ahead=ahead, main_path=case.on_path, **extra)
        check(err <= case.bound, f"{what}: rel_l2 {err:.3e} > {case.bound:.0e}")
        check(exact or not case.exact, f"{what}: not bit-exact to its plain version")
        entry = summary.setdefault(case.kernel, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bound_by={"bytes": 0.0, "operations": 0.0},
            library_ms=0.0 if case.library else None))
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if case.on_path:
            entry["ms"] += ms
            entry["plain_ms"] += plain_ms
            entry["bound_ms"] += bound_ms
            entry["bound_by"][bound_by] += bound_ms  # which limit binds the most time
            if lib_ms is not None:
                entry["library_ms"] = (entry["library_ms"] or 0.0) + lib_ms
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3
def left_padded_batch(cfg, batch: int, prompt_len: int, dev, seed: int = 0):
    """The seeded example batch at native view sizes, with row r left-padded
    by 8r tokens (so RoPE positions and cache slots differ by row)."""
    from mmor_tpu_torch.config import example_batch
    from mmor_tpu_torch.sg.prompts import IMAGE_TOKEN_INDEX

    data = example_batch(cfg, batch, prompt_len, seed=seed, device=dev, raw_views=True)
    ids, mask = data["input_ids"], data["attention_mask"]
    for r in range(batch):
        pad = min(8 * r, prompt_len - 8)
        ids[r, :pad] = 0
        mask[r, :pad] = 0
        ids[r, pad + 4] = IMAGE_TOKEN_INDEX
    return data


def phase_main_path(dev, preset_name: str = "7b", batch: int = BATCH,
                    prompt_len: int = PROMPT_LEN, new_tokens: int = NEW_TOKENS,
                    profile_dir: str | None = None) -> dict:
    """MM2SG int8 serving through ``generate_stepwise``; returns the launch
    counts of the timed window. With ``profile_dir``, also profiles one
    prefill and ``PROFILE_STEPS`` decode steps (``profile_window``)."""
    import torch

    from mmor_tpu_torch.cli.common import build_predictor
    from mmor_tpu_torch.inference import ByteTokenizer
    from mmor_tpu_torch.models.llama import make_decode_step
    from mmor_tpu_torch.models.mm2sg import generate_stepwise, make_prefill

    t0 = time.perf_counter()
    predictor = build_predictor(preset_name, ByteTokenizer(), None, quantize="int8",
                                device=dev, seed=0)
    model, cfg = predictor.model, predictor.model.cfg
    lc = cfg.llama
    data = left_padded_batch(cfg, batch, prompt_len, dev)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_packed = sum(b.numel() * b.element_size() for b in model.buffers())
    say("3 main-path", step="setup", preset=preset_name, seconds=f"{time.perf_counter() - t0:.2f}",
        float_params=n_params, packed_weight_bytes=n_packed, weight_quant=lc.weight_quant,
        kv_quant=lc.kv_quant, ffn_pad=lc.ffn_pad, quant_int8_mxu=lc.quant_int8_mxu)
    check(lc.weight_quant and lc.kv_quant and lc.quant_int8_mxu, "not the int8 config")

    cache_len = predictor._cache_len_for(prompt_len)
    cfg_run = dict(max_cache_len=cache_len, max_new_tokens=new_tokens, eos_token_id=-1)
    prefill = make_prefill(model, max_cache_len=cache_len)
    step = make_decode_step(model.language_model)
    prefill_s: list[float] = []

    def timed_prefill(b, bufs):
        sync(dev)
        t = time.perf_counter()
        out = prefill(b, bufs)
        sync(dev)
        prefill_s.append(time.perf_counter() - t)
        return out

    reset_launch_counts()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=step,
                                     **cfg_run)  # warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2):
        sync(dev)
        t = time.perf_counter()
        tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill,
                                         step_fn=step, cache_buffers=bufs, **cfg_run)
        sync(dev)
        total = time.perf_counter() - t
        runs.append(tokens)
        decode_ms = (total - prefill_s[-1]) * 1e3 / (new_tokens - 1)
        say("3 main-path", step=f"run{i + 1}", frames_per_s=f"{batch / total:.4f}",
            total_s=f"{total:.4f}", prefill_ms=f"{prefill_s[-1] * 1e3:.2f}",
            decode_ms_per_token=f"{decode_ms:.3f}", cache_len=cache_len)
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS["int8"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    say("3 main-path", step="launches", peak_mem_bytes=peak,
        tokens="x".join(map(str, tokens.shape)),
        **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(dev.type != "cuda" or n > 0, f"{name} was not launched on the main path")
    check(tokens.shape == (batch, new_tokens), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < lc.vocab_size)).all()), "token ids out of range")
    check(bool((runs[0] == runs[1]).all()), "two runs on the same inputs disagree")
    perop_decode_profile(dev, prefill, step, data, bufs, "3 main-path")

    # the prefill with the kernels against the same prefill with the plain
    # versions, same weights and inputs; and the plain prefill against itself
    # with every attention output perturbed by a rounding step, the spread
    # that rounding alone causes in this model (see LOGITS_FLOOR_FACTOR)
    logits_k, _ = prefill(data, bufs)
    with plain_versions():
        logits_p, _ = prefill(data, bufs)
    with plain_versions(perturb=torch.Generator(device=dev).manual_seed(1)):
        logits_n, _ = prefill(data, bufs)
    logits_k, logits_p = logits_k[:, -1].float(), logits_p[:, -1].float()
    err = rel_l2(logits_k, logits_p)
    floor = rel_l2(logits_n[:, -1].float(), logits_p)
    bound = LOGITS_FLOOR_FACTOR * floor
    diff = (logits_k - logits_p).abs().amax(dim=-1)
    top2 = logits_p.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff  # rows whose argmax cannot flip
    agree = logits_k.argmax(-1) == logits_p.argmax(-1)
    say("3 main-path", step="kernels-vs-plain-prefill", logits_rel_l2=f"{err:.3e}",
        rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}",
        first_token_agree=f"{int(agree.sum())}/{batch}",
        clear_margin_rows=int(clear.sum()),
        finite=bool(torch.isfinite(logits_k).all()))
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    check(err <= bound, f"prefill logits rel_l2 {err:.3e} > {bound:.3e}")
    check(bool(agree[clear].all()), "first token differs on a row with a clear margin")

    if profile_dir:
        logits, cache = prefill(data, bufs)
        first = logits[:, -1].argmax(dim=-1).to(torch.int32)

        n_steps = min(PROFILE_STEPS, new_tokens - 1)

        @torch.no_grad()
        def decode_steps():  # rewrites the same cache slots on every call
            tok, c = first, dict(cache)
            for _ in range(n_steps):
                tok, c = step(c, tok[:, None])

        profile_window(dev, f"decode_{n_steps}_steps", decode_steps, profile_dir)
        profile_window(dev, "prefill", lambda: prefill(data, bufs), profile_dir)
    return counts


def perop_decode_profile(dev, prefill, step, data, bufs, phase: str) -> None:
    """``LAUNCH_STEPS`` per-op decode steps from a fresh prefill under
    torch.profiler (phases 3 and 14): launches a step, the device's busy
    time a step (its kernels' durations summed) against the host's wall,
    the busy share, and K4's device time a step. The path is host-bound, so
    a faster decode kernel shows here, in the busy share, before it shows in
    frames/s."""
    import torch

    logits, cache = prefill(data, bufs)
    first = logits[:, -1].argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def decode_steps():  # rewrites the same cache slots on every call
        tok, c = first, dict(cache)
        for _ in range(LAUNCH_STEPS):
            tok, c = step(c, tok[:, None])

    decode_steps()  # warm
    n_ev, busy_us, wall_us, k4_us = device_window(dev, decode_steps, names=("decode_kernel",))
    say(phase, step="decode-profile", steps=LAUNCH_STEPS,
        launches_per_step=f"{n_ev / LAUNCH_STEPS:.1f}",
        device_busy_ms_per_step=f"{busy_us / 1e3 / LAUNCH_STEPS:.3f}",
        wall_ms_per_step=f"{wall_us / 1e3 / LAUNCH_STEPS:.3f}",
        busy_share=f"{busy_us / wall_us:.4f}",
        k4_device_ms_per_step=f"{k4_us / 1e3 / LAUNCH_STEPS:.3f}")


def profile_window(dev, name: str, fn, out_dir: str, phase: str = "3 profile") -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the window's host wall time. Writes the
    per-kernel table to ``out_dir/<name>.txt`` and prints the top five."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm, so the window holds no first-call work
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, count = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(t for t, _ in by_kernel.values())
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(f"wall_us={wall_us:.1f} device_busy_us={busy_us:.1f}\n")
        for kname, (us, n) in rows:
            f.write(f"{us:12.1f} us {n:7d} x  {kname}\n")
    if not by_kernel:
        say(phase, window=name, device_time="not_measured(no_device_events)")
        return
    say(phase, window=name, wall_ms=f"{wall_us / 1e3:.3f}",
        device_busy_ms=f"{busy_us / 1e3:.3f}",
        idle_share=f"{max(0.0, 1 - busy_us / wall_us):.4f}", kernels=len(rows))
    for kname, (us, n) in rows[:8]:
        say(phase, window=name, share=f"{us / busy_us:.4f}", ms=f"{us / 1e3:.3f}",
            launches=n, kernel=kname[:90].replace(" ", ""))


# ---------------------------------------------------------------- phase 4
def phase_cli(dev, preset_name: str = "7b", quantize: str = "int8", phase: str = "4 cli") -> dict:
    from mmor_tpu_torch.cli import evaluate_sg

    t = time.perf_counter()
    summary = evaluate_sg.main(["--synthetic", "2", "--preset", preset_name,
                                "--quantize", quantize, "--batch_size", "2",
                                "--device", dev.type])
    check({"macro_f1", "precision", "recall"} <= set(summary), "no report")
    say(phase, preset=preset_name, quantize=quantize,
        seconds=f"{time.perf_counter() - t:.2f}", macro_f1=summary["macro_f1"],
        datatypes=json.dumps(summary["datatypes"]).replace(" ", ""))
    return summary


# ---------------------------------------------------------------- phase 5
# the kernels of csrc/mega_decode.cu (K5), by name in a profiler trace
K5_KERNEL_NAMES = ("core_kernel", "attention_kernel", "norm_quant_kernel", "widen_kernel",
                   "narrow_kernel", "chunk_rope_quant_kernel")
# K5's step by part: its weight phases (the core) and its attention kernels
K5_PARTS = {"weights": ("core_kernel",), "attention": ("attention_kernel",)}


def union_us(ranges) -> float:
    """The time covered by (start, end) us ranges, overlaps counted once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(ranges):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_window(dev, fn, names=K5_KERNEL_NAMES, parts=None):
    """(device events, device busy us, host wall us, us in the kernels whose
    names contain one of ``names``) of one call of ``fn`` under
    torch.profiler, the busy and kernel us being the kernels' durations
    summed; with ``parts`` (name: name fragments) also a dict of unions of
    device intervals: "busy" of every kernel's, "named" of the named
    kernels', and each part's. A kernel launched with programmatic
    dependent launch starts while the one before it runs, so a sum counts
    that overlap twice and a union once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    named = [e for e in events if any(k in e.name for k in names)]
    out = (len(events), sum(e.time_range.elapsed_us() for e in events), wall_us,
           sum(e.time_range.elapsed_us() for e in named))
    if parts is None:
        return out

    def union(evs):
        return union_us((e.time_range.start, e.time_range.end) for e in evs)

    unions = {"busy": union(events), "named": union(named)}
    unions.update({k: union(e for e in events if any(f in e.name for f in v))
                   for k, v in parts.items()})
    return out + (unions,)


def build_mega_predictor(dev, widths, preset_name: str = "7b"):
    """The MM2SG predictor of a megakernel serving configuration at
    (wbits, kvbits), seeded weights: (4, 4) is ``--quantize int4``; any
    other pair is built as ``bench.py:386-393`` builds its megakernel rung
    (``quantize_mega``: fused qkv / gate_up, ``ffn_pad`` 256 at 7B, decode
    through K5)."""
    from mmor_tpu_torch.cli.common import build_predictor, quantize_mega
    from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor

    if tuple(widths) == (4, 4):
        return build_predictor(preset_name, ByteTokenizer(), None, quantize="int4",
                               device=dev, seed=0)
    float_model = build_predictor(preset_name, ByteTokenizer(), None, device=dev,
                                  seed=0).model
    model = quantize_mega(float_model, *widths).eval()
    return SceneGraphPredictor(cfg=model.cfg, model=model, tokenizer=ByteTokenizer(),
                               device=dev)


def phase_mega_path(dev, predictor=None, widths=(4, 4), phase: str = "5 int4-path",
                    path: str = "int4", batch: int = BATCH, prompt_len: int = PROMPT_LEN,
                    new_tokens: int = NEW_TOKENS, profile_dir: str | None = None) -> dict:
    """MM2SG megakernel serving at (wbits, kvbits) through
    ``generate_stepwise``, on phase 3's inputs (phase 5: ``--quantize int4``;
    phase 10: int8 weights and KV, ``predictor`` shared with phase 11);
    returns the launch counts of the warm and timed runs. With
    ``profile_dir``, also writes per-kernel device time tables of
    ``LAUNCH_STEPS`` decode steps and one prefill."""
    import torch

    from mmor_tpu_torch.models.mm2sg import generate_stepwise, make_prefill
    from mmor_tpu_torch.ops import mega_decode as M

    t0 = time.perf_counter()
    if predictor is None:
        predictor = build_mega_predictor(dev, widths)
    model, cfg = predictor.model, predictor.model.cfg
    lc, server = cfg.llama, predictor._step
    data = left_padded_batch(cfg, batch, prompt_len, dev)
    sync(dev)
    n_packed = sum(b.numel() * b.element_size() for b in model.language_model.buffers())
    say(phase, step="setup", preset="7b", seconds=f"{time.perf_counter() - t0:.2f}",
        lm_packed_bytes=n_packed, weight_bits=lc.weight_bits,
        weight_group=lc.weight_group, kv_bits=lc.kv_bits, mega_decode=lc.mega_decode,
        ffn_pad=lc.ffn_pad, quant_int8_mxu=lc.quant_int8_mxu)
    check(lc.mega_decode and (lc.weight_bits, lc.kv_bits) == tuple(widths) and lc.fused_qkv
          and lc.quant_int8_mxu and isinstance(server, M.MegaServer),
          f"not the w{widths[0]}kv{widths[1]} megakernel config")

    cache_len = predictor._cache_len_for(prompt_len)
    check(cache_len % M.mega_granule(lc) == 0, f"capacity {cache_len} off its granule")
    cfg_run = dict(max_cache_len=cache_len, max_new_tokens=new_tokens, eos_token_id=-1)
    prefill = make_prefill(model, max_cache_len=cache_len)
    prefill_s: list[float] = []

    def timed_prefill(b, bufs):
        sync(dev)
        t = time.perf_counter()
        out = prefill(b, bufs)
        sync(dev)
        prefill_s.append(time.perf_counter() - t)
        return out

    reset_launch_counts()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=server,
                                     **cfg_run)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2):
        sync(dev)
        t = time.perf_counter()
        tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill,
                                         step_fn=server, cache_buffers=bufs, **cfg_run)
        sync(dev)
        total = time.perf_counter() - t
        runs.append(tokens)
        decode_ms = (total - prefill_s[-1]) * 1e3 / (new_tokens - 1)
        say(phase, step=f"run{i + 1}", frames_per_s=f"{batch / total:.4f}",
            total_s=f"{total:.4f}", prefill_ms=f"{prefill_s[-1] * 1e3:.2f}",
            decode_ms_per_token=f"{decode_ms:.3f}", cache_len=cache_len)
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS[path]}
    peak = torch.cuda.max_memory_allocated(dev)
    say(phase, step="launches", peak_mem_bytes=peak,
        tokens="x".join(map(str, tokens.shape)),
        **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the {path} path")
    check(tokens.shape == (batch, new_tokens), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < lc.vocab_size)).all()), "token ids out of range")
    check(bool((runs[0] == runs[1]).all()), "two runs on the same inputs disagree")

    # decode steps from a fresh prefill: launches a step and the device's
    # idle share, then one step with K5 against one with its plain version
    logits, cache = prefill(data, bufs)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
    step = server.step_for(batch)
    observe = M.make_mega_decode_step(server, batch, return_logits=True, update_cache=False)

    def decode_steps():  # rewrites the same cache slot on every call
        t_, c_ = tok, dict(cache, kv_mask=cache["kv_mask"].clone())
        for _ in range(LAUNCH_STEPS):
            t_, c_ = step(c_, t_[:, None])

    decode_steps()  # warm
    n_ev, busy_us, wall_us, k5_us, part_us = device_window(dev, decode_steps, parts=K5_PARTS)
    # K5's roofline for one step at full depth: every layer's weights and
    # scales, and the valid K/V positions with their scales
    valid = int(cache["kv_mask"].sum())
    k5_bound_ms, k5_bound_by = k5_roofline(server.weights, lc, batch, valid)
    w_bytes = sum(t.numel() * t.element_size() for slot in server.weights.layers
                  for t in slot)
    say(phase, step="decode-profile", steps=LAUNCH_STEPS,
        launches_per_step=f"{n_ev / LAUNCH_STEPS:.1f}",
        device_busy_ms_per_step=f"{busy_us / 1e3 / LAUNCH_STEPS:.3f}",
        wall_ms_per_step=f"{wall_us / 1e3 / LAUNCH_STEPS:.3f}",
        idle_share=f"{max(0.0, 1 - busy_us / wall_us):.4f}",
        k5_device_ms_per_step=f"{k5_us / 1e3 / LAUNCH_STEPS:.3f}",
        device_busy_union_ms_per_step=f"{part_us['busy'] / 1e3 / LAUNCH_STEPS:.3f}",
        idle_share_union=f"{1 - part_us['busy'] / wall_us:.4f}",
        k5_union_ms_per_step=f"{part_us['named'] / 1e3 / LAUNCH_STEPS:.3f}",
        **{f"k5_{k}_union_ms_per_step": f"{part_us[k] / 1e3 / LAUNCH_STEPS:.3f}"
           for k in K5_PARTS},
        k5_bound_ms=f"{k5_bound_ms:.4f}", k5_bound_by=k5_bound_by,
        k5_weight_bytes=w_bytes, k5_kv_bytes=kv_bytes(lc, valid))
    if profile_dir:
        profile_window(dev, f"{path}_decode_{LAUNCH_STEPS}_steps", decode_steps,
                       profile_dir, phase=phase.split()[0] + " profile")
        profile_window(dev, f"{path}_prefill", lambda: prefill(data, bufs), profile_dir,
                       phase=phase.split()[0] + " profile")

    k5_full_depth(server, cache, tok, lc, phase)
    _, logits_k = observe(cache, tok[:, None])
    with plain_versions():
        _, logits_p = observe(cache, tok[:, None])
    with plain_versions(perturb=torch.Generator(device=dev).manual_seed(1)):
        _, logits_n = observe(cache, tok[:, None])
    err = rel_l2(logits_k, logits_p)
    floor = rel_l2(logits_n, logits_p)
    bound = LOGITS_FLOOR_FACTOR * floor
    diff = (logits_k - logits_p).abs().amax(dim=-1)
    top2 = logits_p.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff  # rows whose argmax cannot flip
    agree = logits_k.argmax(-1) == logits_p.argmax(-1)
    say(phase, step="k5-vs-plain-decode-step", logits_rel_l2=f"{err:.3e}",
        rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}",
        next_token_agree=f"{int(agree.sum())}/{batch}", clear_margin_rows=int(clear.sum()),
        finite=bool(torch.isfinite(logits_k).all()))
    check(bool(torch.isfinite(logits_k).all()), "non-finite decode logits")
    check(err <= bound, f"decode-step logits rel_l2 {err:.3e} > {bound:.3e}")
    check(bool(agree[clear].all()), "next token differs on a row with a clear margin")
    return counts


def k5_full_depth(server, cache: dict, tok, lc, phase: str) -> None:
    """K5 on the served model's cache at full depth against its plain
    version. Each layer alone, fed the plain version's output of the layer
    before, is held to phase 2's bounds (x_out rel_l2, the new K/V columns);
    the whole depth in one call is printed beside them: there the two
    versions' rounding differences compound over the layers, and the decode
    step's logits check bounds them."""
    import torch

    from mmor_tpu_torch.ops import mega_decode as M

    w = server.weights
    with torch.no_grad():
        x = server.lm.embed_tokens(tok.long()).to(torch.bfloat16)
    cos, sin = M.rope_tables(cache["tok_pos"], lc.head_dim, lc.rope_theta)
    kw = dict(eps=lc.norm_eps)
    out = M.mega_decode_layers(x, w, cache, cos, sin, pointer_table=server.pointer_table, **kw)
    ref = M.mega_decode_layers_plain(x, w, cache, cos, sin, **kw)
    check(bool(torch.isfinite(out[0].float()).all()), "K5 full depth: non-finite x_out")
    depth_err = rel_l2(out[0], ref[0])
    depth_agree = min(float((out[i] == ref[i]).float().mean()) for i in (1, 3))
    scratch = M.alloc_scratch(w, x.shape[0], x.device)
    worst_err, worst_agree = 0.0, 1.0
    for li in range(lc.n_layers):
        one = M.MegaWeights([[slot[li]] for slot in w.layers], w.norms[li:li + 1],
                            w.group, w.ffn, w.heads, w.wbits)
        c1 = dict(cache, **{k: cache[k][li:li + 1] for k in ("k", "v", "k_s", "v_s")})
        out = M.mega_decode_layers(x, one, c1, cos, sin, scratch=scratch, **kw)
        ref = M.mega_decode_layers_plain(x, one, c1, cos, sin, **kw)
        err = rel_l2(out[0], ref[0])
        check(err <= K5_X_BOUND, f"K5 layer {li}: x_out rel_l2 {err:.3e} > {K5_X_BOUND:.0e}")
        cols = k5_columns(out, ref, f"K5 layer {li}")
        worst_err = max(worst_err, err)
        worst_agree = min(worst_agree, cols["knew_agree"], cols["vnew_agree"])
        x = ref[0]
    say(phase, step="k5-vs-plain-by-layer", layers=lc.n_layers,
        worst_x_out_rel_l2=f"{worst_err:.3e}", bound=f"{K5_X_BOUND:.0e}",
        worst_kv_agree=f"{worst_agree:.5f}", kv_bound=K5_KV_AGREE,
        full_depth_x_out_rel_l2=f"{depth_err:.3e}", full_depth_kv_agree=f"{depth_agree:.5f}")


# ---------------------------------------------------------------- phase 7
def panoptic_config():
    """DVIS++ online at the JAX bench's full widths (``bench.py``'s
    ``panoptic_metric``): ResNet-50, 6 deformable encoder layers, 100
    queries, 9 decoder layers, 124 classes, a 6-layer tracker (inference
    takes no query-order noise); computed in bf16, parameters in f32."""
    import torch

    from mmor_tpu_torch.models.mask2former_decoder import MaskDecoderConfig
    from mmor_tpu_torch.models.meta_arch import DVISConfig
    from mmor_tpu_torch.models.segmenter import SegmenterConfig
    from mmor_tpu_torch.models.tracker import TrackerConfig

    bf = torch.bfloat16
    return DVISConfig(
        segmenter=SegmenterConfig(decoder=MaskDecoderConfig(dtype=bf), dtype=bf),
        tracker=TrackerConfig(dtype=bf))


def phase_panoptic(dev, profile_dir: str | None = None) -> dict:
    """DVIS++ online serving on a 9-frame 736x1280 video in 3-frame windows
    through the CLI's window step (the tracker's state carried across
    windows); returns K6's launch count over the warm and timed runs."""
    import numpy as np
    import torch

    from mmor_tpu_torch.cli.eval_panoptic import make_window_step
    from mmor_tpu_torch.eval.video_inference import run_window_inference
    from mmor_tpu_torch.models.meta_arch import DVISPlus, init_random
    from mmor_tpu_torch.models.segmenter import normalize_pixels
    from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

    t0 = time.perf_counter()
    cfg = panoptic_config()
    with torch.device(dev):
        model = DVISPlus(cfg)
    init_random(model, seed=0)
    model.eval()
    (h, w), t = PANOPTIC_SIZE, cfg.window_size
    video = np.random.default_rng(0).integers(0, 256, (PANOPTIC_FRAMES, h, w, 3),
                                              dtype=np.uint8)
    step = make_window_step(model, t)
    sync(dev)
    windows = -(-PANOPTIC_FRAMES // t)
    say("7 panoptic", step="setup", seconds=f"{time.perf_counter() - t0:.2f}",
        params=sum(p.numel() for p in model.parameters()), frames=PANOPTIC_FRAMES,
        size=f"{h}x{w}", window=t, dtype="bf16")

    reset_launch_counts()
    run_window_inference(step, video, t)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(2):
        sync(dev)
        t1 = time.perf_counter()
        out = run_window_inference(step, video, t)
        sync(dev)
        total = time.perf_counter() - t1
        runs.append(out)
        say("7 panoptic", step=f"run{i + 1}", frames_per_s=f"{PANOPTIC_FRAMES / total:.4f}",
            ms_per_frame=f"{total * 1e3 / PANOPTIC_FRAMES:.3f}", total_s=f"{total:.4f}")
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS["panoptic"]}
    peak = torch.cuda.max_memory_allocated(dev)
    n_layers = cfg.segmenter.pixel_decoder_layers
    say("7 panoptic", step="launches", peak_mem_bytes=peak, windows_per_run=windows,
        K6_per_window=f"{counts['K6 ms_deform_attn'] / (3 * windows):.1f}",
        **{k.split()[0]: v for k, v in counts.items()})
    check(counts["K6 ms_deform_attn"] == 3 * windows * n_layers,
          f"K6 launched {counts['K6 ms_deform_attn']} times, not {n_layers} a window")
    q, k1 = cfg.segmenter.decoder.num_queries, cfg.segmenter.decoder.num_classes + 1
    check(out["pred_logits"].shape == (PANOPTIC_FRAMES, q, k1)
          and out["pred_masks"].shape == (PANOPTIC_FRAMES, q, h // 4, w // 4),
          f"outputs {out['pred_logits'].shape} {out['pred_masks'].shape}")
    check(all(np.isfinite(v).all() for v in out.values()), "non-finite outputs")
    check(all(np.array_equal(runs[0][k], runs[1][k]) for k in out),
          "two runs on the same video disagree")

    frames = video[:t]
    n_ev, busy_us, wall_us, k6_us = device_window(dev, lambda: step(frames, None),
                                                  names=("ms_deform_attn",))
    say("7 panoptic", step="window-profile", launches=n_ev,
        device_busy_ms=f"{busy_us / 1e3:.3f}", wall_ms=f"{wall_us / 1e3:.3f}",
        busy_share=f"{busy_us / wall_us:.4f}",
        k6_device_ms=f"{k6_us / 1e3:.3f}", k6_share_of_busy=f"{k6_us / busy_us:.4f}")
    # one stream: the device events cannot overlap, so a share above 1 means
    # the device-time sum is wrong
    check(busy_us <= 1.01 * wall_us,
          f"device busy {busy_us:.0f} us > wall {wall_us:.0f} us: events overlap")
    if profile_dir:
        profile_window(dev, "panoptic_window", lambda: step(frames, None), profile_dir,
                       phase="7 profile")

    # K6 against its plain version on the served model's own operands: each
    # of the encoder layers' sampler calls in one window, recorded as the
    # kernel ran them, held at phase 2's bound
    records = []
    with recording_sampler(records):
        step(frames, None)
    check(len(records) == n_layers, f"{len(records)} K6 calls in a window, not {n_layers}")
    errs = []
    for i, (value, shapes, loc, attn, got) in enumerate(records):
        ref = ms_deform_attn(value, shapes, loc, attn)
        check(got.dtype == ref.dtype == attn.dtype == torch.bfloat16,
              f"K6 encoder layer {i}: {got.dtype}/{ref.dtype}/{attn.dtype}, not bf16")
        check(bool(torch.isfinite(got.float()).all()), f"K6 encoder layer {i}: non-finite")
        errs.append(rel_l2(got, ref))
        check(errs[-1] <= K6_BOUND["bf16"],
              f"K6 encoder layer {i}: rel_l2 {errs[-1]:.3e} > {K6_BOUND['bf16']:.0e}")
    say("7 panoptic", step="k6-vs-plain-by-layer", layers=len(records),
        worst_rel_l2=f"{max(errs):.3e}", bound=f"{K6_BOUND['bf16']:.0e}",
        rel_l2_by_layer=",".join(f"{e:.3e}" for e in errs),
        value=tuple(records[0][0].shape), loc=tuple(records[0][2].shape))
    del records

    # a smoke check of the whole: the pixel decoder's outputs and one
    # window's outputs against the spread that one rounding step of every
    # sampler output causes in this random model. The bf16 chain after the
    # sampler spreads any difference to about a rounding step of every
    # entry, so these sit near their floor whatever the sampler's error
    # below it: the per-layer check above is the one that bounds K6.
    with torch.no_grad():
        feats = model.segmenter.backbone(normalize_pixels(torch.from_numpy(frames).to(dev)))
        pd_k = model.segmenter.pixel_decoder(feats)
        with plain_versions():
            pd_p = model.segmenter.pixel_decoder(feats)
        with plain_versions(perturb=torch.Generator(device=dev).manual_seed(1)):
            pd_n = model.segmenter.pixel_decoder(feats)
    out_k, _ = step(frames, None)
    with plain_versions():
        out_p, _ = step(frames, None)
    with plain_versions(perturb=torch.Generator(device=dev).manual_seed(2)):
        out_n, _ = step(frames, None)
    pairs = [("mask_features", pd_k[0], pd_p[0], pd_n[0])]
    pairs += [(f"map{i}", a, b, c) for i, (a, b, c) in enumerate(zip(pd_k[1], pd_p[1], pd_n[1]))]
    pairs += [(key, torch.from_numpy(out_k[key]), torch.from_numpy(out_p[key]),
               torch.from_numpy(out_n[key])) for key in ("pred_logits", "pred_masks")]
    for name, got, ref, noisy in pairs:
        err, floor = rel_l2(got, ref), rel_l2(noisy, ref)
        bound = LOGITS_FLOOR_FACTOR * floor
        say("7 panoptic", step="k6-vs-plain-smoke", output=name, rel_l2=f"{err:.3e}",
            rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}")
        check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
        check(err <= bound, f"{name}: K6 vs plain rel_l2 {err:.3e} > {bound:.3e}")
    return counts


# ---------------------------------------------------------------- phase 8
def phase_panoptic_cli(dev) -> dict:
    import math

    from mmor_tpu_torch.cli import eval_panoptic

    t = time.perf_counter()
    summary = eval_panoptic.main(["--synthetic", "--device", dev.type])
    check({"vpq", "stq"} <= set(summary), "no report")
    check(all(math.isfinite(summary[k]) for k in ("vpq", "stq")), "non-finite VPQ/STQ")
    say("8 panoptic-cli", size="512x512", dtype="f32", seconds=f"{time.perf_counter() - t:.2f}",
        vpq=summary["vpq"], stq=summary["stq"],
        vpq_per_window=json.dumps(summary["vpq_per_window"]).replace(" ", ""))
    return summary


# ---------------------------------------------------------------- phase 9
def kv_bytes(lc, positions: int) -> int:
    """The bytes of ``positions`` K/V positions of every layer and head at
    the cache's width, with their bf16 scales."""
    row = lc.head_dim // 2 if lc.kv_bits == 4 else lc.head_dim
    return lc.n_layers * lc.n_heads * positions * 2 * (row + 2)


def k5_roofline(weights, lc, rows: int, kv_valid: int, work_valid: int = 0,
                chunk: int = 0) -> tuple[float, str]:
    """K5's bound for one step at full depth: every layer's weights and
    scales read once for ``rows`` activation rows, the valid K/V positions
    of the decode cache (and of the working cache) with their scales; the
    int8 matmul operations and the attention's dot products (with pf rows:
    the chunk's working-cache columns and its causal pairs)."""
    w_bytes = sum(t.numel() * t.element_size() for slot in weights.layers for t in slot)
    per_byte = 2 if weights.wbits == 4 else 1  # weight values a byte of the packed words
    n_weights = sum(per_byte * t.numel() * t.element_size() for slot in weights.layers[0::2]
                    for t in slot)
    pairs = kv_valid + chunk * work_valid + chunk * (chunk + 1) // 2
    return roofline_ms(w_bytes + kv_bytes(lc, kv_valid + work_valid),
                       {"int8": 2.0 * rows * n_weights,
                        "cuda_core": 4.0 * lc.n_layers * lc.n_heads * pairs * lc.head_dim})


def phase_overlap(dev, predictor=None, widths=(4, 4), phase: str = "9 overlap",
                  path: str = "overlap", batch: int = BATCH, prompt_len: int = PROMPT_LEN,
                  new_tokens: int = NEW_TOKENS, chunk: int = OVERLAP_CHUNK,
                  profile_dir: str | None = None) -> dict:
    """MM2SG megakernel serving at (wbits, kvbits) through
    ``generate_overlapped`` on phase 5's inputs (batches alternate between
    two seeded batches of that shape; phase 9: ``--quantize int4``; phase
    11: int8 weights and KV, ``predictor`` shared with phase 10); returns
    the launch counts of the warm and timed streams."""
    import torch

    from mmor_tpu_torch.models.llama import alloc_kv_buffers
    from mmor_tpu_torch.models.mm2sg import generate_overlapped, generate_stepwise
    from mmor_tpu_torch.ops import mega_decode as M
    from mmor_tpu_torch.ops import mega_overlap as O

    t0 = time.perf_counter()
    if predictor is None:
        predictor = build_mega_predictor(dev, widths)
    model, cfg = predictor.model, predictor.model.cfg
    lc = cfg.llama
    check((lc.weight_bits, lc.kv_bits) == tuple(widths) and lc.mega_decode,
          f"not the w{widths[0]}kv{widths[1]} megakernel config")
    data = [left_padded_batch(cfg, batch, prompt_len, dev, seed=s) for s in (0, 1)]
    cache_len = predictor._cache_len_for(prompt_len)
    t_out = prompt_len + cfg.num_multimodal_tokens - 1
    kw = dict(max_cache_len=cache_len, max_new_tokens=new_tokens, eos_token_id=-1,
              chunk=chunk)
    stream = lambda n: [data[i % 2] for i in range(n)]
    sync(dev)
    say(phase, step="setup", seconds=f"{time.perf_counter() - t0:.2f}", batch=batch,
        prompt=prompt_len, t_out=t_out, new_tokens=new_tokens, chunk=chunk,
        cache_len=cache_len)

    ec: dict = {}
    reset_launch_counts()
    generate_overlapped(model, stream(OVERLAP_WARM), engine_cache=ec, **kw)  # warm
    server = ec["server"]
    nc, t2 = server.t2 // chunk, server.t2
    handed = []  # each handoff's (hidden states, cache)
    handoff = server.handoff

    def recording_handoff(cache, full, amask, hidden):
        out = handoff(cache, full, amask, hidden)
        handed.append(hidden)
        return out

    server.handoff = recording_handoff
    torch.cuda.reset_peak_memory_stats(dev)
    secs = {}
    for n in (OVERLAP_SHORT, OVERLAP_LONG):
        sync(dev)
        t1 = time.perf_counter()
        outs = generate_overlapped(model, stream(n), engine_cache=ec, **kw)
        sync(dev)
        secs[n] = time.perf_counter() - t1
    server.handoff = handoff
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS[path]}
    peak = torch.cuda.max_memory_allocated(dev)
    steady = batch * (OVERLAP_LONG - OVERLAP_SHORT) / (secs[OVERLAP_LONG] - secs[OVERLAP_SHORT])
    check(len(outs) == OVERLAP_LONG and all(o.shape == (batch, new_tokens) for o in outs),
          "overlapped outputs of the wrong shape")
    check(all(((o >= 0) & (o < lc.vocab_size)).all() for o in outs), "token ids out of range")

    # the serial path on the same inputs: batch 0's tokens, and its frames/s
    server_serial = predictor._step
    serial_s = []
    for _ in range(2):
        sync(dev)
        t1 = time.perf_counter()
        serial, _ = generate_stepwise(model, data[0], max_cache_len=cache_len,
                                      max_new_tokens=new_tokens, eos_token_id=-1,
                                      step_fn=server_serial)
        sync(dev)
        serial_s.append(time.perf_counter() - t1)
    same0 = bool((outs[0] == serial).all())
    say(phase, step="stream", steady_frames_per_s=f"{steady:.4f}",
        fill_inclusive_frames_per_s=f"{batch * OVERLAP_LONG / secs[OVERLAP_LONG]:.4f}",
        serial_frames_per_s=f"{batch / serial_s[-1]:.4f}",
        serial_frames_per_s_first=f"{batch / serial_s[0]:.4f}",
        t_short_s=f"{secs[OVERLAP_SHORT]:.4f}", t_long_s=f"{secs[OVERLAP_LONG]:.4f}",
        batches=f"{OVERLAP_SHORT},{OVERLAP_LONG}", nc=nc, t2=t2,
        pf_steps_per_batch=batch * nc, peak_mem_bytes=peak,
        batch0_equals_serial=same0, **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the {path} path")
    check(same0, "batch 0's tokens differ from generate_stepwise's")

    # step times: plain and pf steps that leave the state as it is, from
    # batch 0's prefill and batch 1's first stream's fourth chunk
    prefill, encode = ec["prefill"], ec["encode"]
    bufs = alloc_kv_buffers(lc, batch, cache_len, dev)
    logits, cache = prefill(data[0], bufs)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    embeds, mask = encode(data[1])
    embeds = torch.nn.functional.pad(embeds, (0, 0, 0, t2 - t_out))
    mask = torch.nn.functional.pad(mask.to(torch.int32), (0, t2 - t_out))
    pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0).to(torch.int32)
    work = O.alloc_pf_work(lc, t2, dev)
    j = min(3, nc - 1)
    span = slice(j * chunk, (j + 1) * chunk)
    ck = dict(x=embeds[0, span], pos=pos[0, span], amask=mask[0, span],
              stream_amask=mask[0], wp=j * chunk)
    plain_step = M.make_mega_decode_step(server.mega, batch, update_cache=False)
    pf_step = O.make_overlap_step(server.mega, batch, chunk, t2, update_state=False)
    n_steps = LAUNCH_STEPS

    def plain_steps():
        for _ in range(n_steps):
            plain_step(cache, tok)

    def pf_steps():
        for _ in range(n_steps):
            pf_step(cache, tok, work, ck)

    plain_steps()
    pf_steps()
    ms = {}
    for name, fn in (("plain", plain_steps), ("pf", pf_steps), ("pf2", pf_steps),
                     ("plain2", plain_steps)):
        sync(dev)
        t1 = time.perf_counter()
        fn()
        sync(dev)
        ms[name] = (time.perf_counter() - t1) * 1e3 / n_steps
    n_ev, busy_us, wall_us, k5_us, part_us = device_window(dev, pf_steps, parts=K5_PARTS)
    kv_valid = int(cache["kv_mask"].sum())
    w_valid = int((mask[0] * (torch.arange(t2, device=dev) < j * chunk)).sum())
    pf_bound, pf_by = k5_roofline(server.mega.weights, lc, batch + chunk, kv_valid,
                                  w_valid, chunk)
    plain_bound, plain_by = k5_roofline(server.mega.weights, lc, batch, kv_valid)
    say(phase, step="step-times", steps=n_steps,
        plain_ms_per_step=f"{ms['plain']:.3f},{ms['plain2']:.3f}",
        pf_ms_per_step=f"{ms['pf']:.3f},{ms['pf2']:.3f}",
        pf_launches_per_step=f"{n_ev / n_steps:.1f}",
        pf_device_busy_ms_per_step=f"{busy_us / 1e3 / n_steps:.3f}",
        pf_idle_share=f"{max(0.0, 1 - busy_us / wall_us):.4f}",
        k5pf_device_ms_per_step=f"{k5_us / 1e3 / n_steps:.3f}",
        pf_device_busy_union_ms_per_step=f"{part_us['busy'] / 1e3 / n_steps:.3f}",
        pf_idle_share_union=f"{1 - part_us['busy'] / wall_us:.4f}",
        k5pf_union_ms_per_step=f"{part_us['named'] / 1e3 / n_steps:.3f}",
        **{f"k5pf_{k}_union_ms_per_step": f"{part_us[k] / 1e3 / n_steps:.3f}"
           for k in K5_PARTS},
        k5pf_bound_ms=f"{pf_bound:.4f}", k5pf_bound_by=pf_by,
        k5_plain_bound_ms=f"{plain_bound:.4f}", k5_plain_bound_by=plain_by)
    if profile_dir:
        profile_window(dev, f"{path}_pf_{n_steps}_steps", pf_steps, profile_dir,
                       phase=phase.split()[0] + " profile")
        profile_window(dev, f"{path}_plain_{n_steps}_steps", plain_steps, profile_dir,
                       phase=phase.split()[0] + " profile")

    # one stream of the last timed batch (seed 1's row 1, left-padded by 8):
    # its handed-off cache and first token against the same prompt's real
    # tokens one by one through K5 (row 0 of a 2-row oracle; row 1 takes
    # each embedding times (1 + u * 2**-8), a rounding step, for the floor)
    s_row = 1
    final = ec["bufs"]  # the last batch's cache: its prompt columns as handed off
    cols = torch.nonzero(mask[s_row, :t_out]).flatten()
    n = len(cols)
    gen = torch.Generator(device=dev).manual_seed(2)
    x_rows = embeds[s_row, cols]
    noisy = (x_rows.float() * (1 + (torch.rand(x_rows.shape, generator=gen, device=dev)
                                    * 2 - 1) * 2.0 ** -8)).to(torch.bfloat16)
    oc = dict(alloc_kv_buffers(lc, 2, cache_len, dev),
              kv_mask=torch.zeros(2, cache_len, dtype=torch.int32, device=dev), write_pos=0,
              tok_pos=torch.zeros(2, dtype=torch.int32, device=dev))
    scratch2 = M.alloc_scratch(server.mega.weights, 2, dev)
    for t in range(n):
        cos, sin = M.rope_tables(oc["tok_pos"], lc.head_dim, lc.rope_theta)
        xh, *new = M.mega_decode_layers(torch.stack([x_rows[t], noisy[t]]),
                                        server.mega.weights, oc, cos, sin, eps=lc.norm_eps,
                                        scratch=scratch2,
                                        pointer_table=server.mega.pointer_table)
        oc = M.apply_kv_update(oc, *new)
    pad = int(cols[0])
    shares, scale_errs, by_layer, floor_by_layer = [], [], [], []
    for name in ("k", "v"):
        got = M.kv_values(final[name][:, s_row, :, pad:t_out], lc.kv_bits).int()
        want = M.kv_values(oc[name][:, 0, :, :n], lc.kv_bits).int()
        noisy_kv = M.kv_values(oc[name][:, 1, :, :n], lc.kv_bits).int()
        check(torch.equal(got[0], want[0]), f"handed-off {name}: layer 0 not bit-exact")
        shares.append(float(((got - want).abs() <= 1).float().mean()))
        # each layer's share, and the same for the oracle fed the perturbed
        # embeddings: how far rounding alone spreads the K/V with depth
        by_layer.append(((got - want).abs() <= 1).float().mean(dim=(1, 2, 3)))
        floor_by_layer.append(((noisy_kv - want).abs() <= 1).float().mean(dim=(1, 2, 3)))
        scale_errs.append(rel_l2(final[name + "_s"][:, s_row, :, pad:t_out],
                                 oc[name + "_s"][:, 0, :, :n]))
    by_layer, floor_by_layer = torch.minimum(*by_layer), torch.minimum(*floor_by_layer)
    floor_share = float(floor_by_layer.mean())
    held = floor_by_layer > ORACLE_BIN_SHARE  # the layers the bound is above the floor in
    shown = [*range(min(4, lc.n_layers)), *range(4, lc.n_layers, 4)]
    say(phase, step="handoff-kv-by-layer", layers=",".join(map(str, shown)),
        kv_within_one_bin=",".join(f"{float(by_layer[i]):.3f}" for i in shown),
        floor_kv_within_one_bin=",".join(f"{float(floor_by_layer[i]):.3f}" for i in shown),
        floor_overall=f"{floor_share:.5f}", layers_held_to_bin_bound=int(held.sum()),
        worst_below_floor=f"{float((floor_by_layer - by_layer).max()):.4f}")
    # the last prompt token's hidden state, held through the first token's
    # logits: at full depth the random model spreads any difference (phase
    # 5's per-layer rounding of 3e-5 reaches 3e-2), so it is bounded by the
    # spread that a rounding step of the inputs causes, as phase 5 does
    hidden = handed[-1][s_row]
    logits = server.mega.head(torch.stack([hidden, xh[0], xh[1]])).float()
    err, floor = rel_l2(logits[0], logits[1]), rel_l2(logits[2], logits[1])
    bound = LOGITS_FLOOR_FACTOR * floor
    say(phase, step="handoff-vs-tokenwise-oracle", stream=s_row, pad=pad, tokens=n,
        layer0_kv_bit_exact=True, kv_within_one_bin=f"{min(shares):.5f}",
        bin_bound=ORACLE_BIN_SHARE, scale_rel_l2=f"{max(scale_errs):.3e}",
        scale_bound=ORACLE_REL, hidden_rel_l2=f"{rel_l2(hidden, xh[0]):.3e}",
        hidden_floor_rel_l2=f"{rel_l2(xh[1], xh[0]):.3e}",
        first_token_logits_rel_l2=f"{err:.3e}", rounding_floor_rel_l2=f"{floor:.3e}",
        bound=f"{bound:.3e}",
        first_token_agree=int(logits[0].argmax()) == int(logits[1].argmax()),
        phase_seconds=f"{time.perf_counter() - t0:.1f}")
    check(bool((by_layer[held] > ORACLE_BIN_SHARE).all()),
          f"handed-off K/V within one bin at or below {ORACLE_BIN_SHARE} in a layer whose "
          "floor is above it")
    check(float((floor_by_layer - by_layer).max()) <= ORACLE_FLOOR_MARGIN,
          "handed-off K/V within one bin below the floor's share by more than "
          f"{ORACLE_FLOOR_MARGIN} in a layer")
    if floor_share > ORACLE_BIN_SHARE:  # the bound is above the rounding floor
        check(min(shares) > ORACLE_BIN_SHARE, f"handed-off K/V within one bin {min(shares):.5f}")
    check(max(scale_errs) < ORACLE_REL, f"handed-off scales rel_l2 {max(scale_errs):.3e}")
    check(bool(torch.isfinite(logits).all()), "non-finite first-token logits")
    check(err <= bound, f"first-token logits rel_l2 {err:.3e} > {bound:.3e}")
    return counts


# --------------------------------------------------------------- phase 13
def phase_a16_path(dev, preset_name: str = "7b", batch: int = BATCH,
                   prompt_len: int = PROMPT_LEN, new_tokens: int = NEW_TOKENS,
                   phase: str = "13 int4-w4a16") -> dict:
    """MM2SG-7B ``--quantize int4`` at ``quant_int8_mxu=False`` (no CLI flag,
    in JAX or here: the LlamaConfig field, set with ``dataclasses.replace``
    before ``quantize_mega``, which keeps it) through ``generate_stepwise``
    on phase 5's inputs and seeded weights: K3's W4A16 branch at prefill,
    K2's W8A16 lm_head, K5 decoding (it quantizes its activations whatever
    the flag says, as JAX's does). One warm call and one timed call; the
    prefill's last-position logits against the same model with K3 swapped
    for its plain version, within LOGITS_FLOOR_FACTOR times the spread that
    a rounding step of each K3 output causes, and the first token on every
    row whose top-2 margin exceeds twice the largest logit difference; the
    top-1 agreement with the same weights at ``quant_int8_mxu=True`` (phase
    5's W4A8 model) is printed, not gated: the two numerics differ by
    design. Returns the path's launch counts."""
    import dataclasses

    import torch

    from mmor_tpu_torch.cli.common import build_predictor, quantize_mega
    from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
    from mmor_tpu_torch.models.llama import QuantDense
    from mmor_tpu_torch.models.mm2sg import generate_stepwise, make_prefill
    from mmor_tpu_torch.ops import mega_decode as M

    t0 = time.perf_counter()
    model = build_predictor(preset_name, ByteTokenizer(), None, device=dev, seed=0).model
    model.cfg = dataclasses.replace(
        model.cfg, llama=dataclasses.replace(model.cfg.llama, quant_int8_mxu=False))
    model = quantize_mega(model, 4, 4).eval()
    predictor = SceneGraphPredictor(cfg=model.cfg, model=model, tokenizer=ByteTokenizer(),
                                    device=dev)
    lc, server = model.cfg.llama, predictor._step
    data = left_padded_batch(model.cfg, batch, prompt_len, dev)
    sync(dev)
    say(phase, step="setup", preset=preset_name, seconds=f"{time.perf_counter() - t0:.2f}",
        weight_bits=lc.weight_bits, weight_group=lc.weight_group, kv_bits=lc.kv_bits,
        mega_decode=lc.mega_decode, quant_int8_mxu=lc.quant_int8_mxu, new_tokens=new_tokens)
    check(not lc.quant_int8_mxu and lc.mega_decode and (lc.weight_bits, lc.kv_bits) == (4, 4)
          and isinstance(server, M.MegaServer), "not the int4 W4A16 config")

    cache_len = predictor._cache_len_for(prompt_len)
    cfg_run = dict(max_cache_len=cache_len, max_new_tokens=new_tokens, eos_token_id=-1)
    prefill = make_prefill(model, max_cache_len=cache_len)
    prefill_s: list[float] = []

    def timed_prefill(b, bufs):
        sync(dev)
        t = time.perf_counter()
        out = prefill(b, bufs)
        sync(dev)
        prefill_s.append(time.perf_counter() - t)
        return out

    reset_launch_counts()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=server,
                                     **cfg_run)  # warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t = time.perf_counter()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=server,
                                     cache_buffers=bufs, **cfg_run)
    sync(dev)
    total = time.perf_counter() - t
    decode_ms = (total - prefill_s[-1]) * 1e3 / (new_tokens - 1)
    say(phase, step="run", frames_per_s=f"{batch / total:.4f}", total_s=f"{total:.4f}",
        prefill_ms=f"{prefill_s[-1] * 1e3:.2f}", decode_ms_per_token=f"{decode_ms:.3f}",
        cache_len=cache_len,
        peak_mem_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    all_counts = launch_counts()
    counts = {k: v for k, v in all_counts.items() if k in PATH_KERNELS["int4a16"]}
    say(phase, step="launches", tokens="x".join(map(str, tokens.shape)),
        k3_w4a8=all_counts["K3 int4_matmul_packed"],
        **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(dev.type != "cuda" or n > 0, f"{name} was not launched on the int4a16 path")
    check(all_counts["K3 int4_matmul_packed"] == 0, "K3's W4A8 branch ran at int8_mxu=False")
    check(tokens.shape == (batch, new_tokens), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < lc.vocab_size)).all()), "token ids out of range")

    # the prefill with K3 against the same prefill with K3's plain version,
    # and the plain one against itself with each K3 output moved by a
    # rounding step (the spread that rounding alone causes in this model)
    logits_k = prefill(data, bufs)[0][:, -1].float()
    with plain_qmm("int4_matmul_packed"):
        logits_p = prefill(data, bufs)[0][:, -1].float()
    with plain_qmm("int4_matmul_packed", perturb=torch.Generator(device=dev).manual_seed(1)):
        logits_n = prefill(data, bufs)[0][:, -1].float()
    err, floor = rel_l2(logits_k, logits_p), rel_l2(logits_n, logits_p)
    bound = LOGITS_FLOOR_FACTOR * floor
    diff = (logits_k - logits_p).abs().amax(dim=-1)
    top2 = logits_p.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff  # rows whose argmax cannot flip
    agree = logits_k.argmax(-1) == logits_p.argmax(-1)
    # the same weights at quant_int8_mxu=True: every QuantDense (K3's
    # projections, K2's lm_head) takes its int8-activation branch
    dense = [mod for mod in model.modules() if isinstance(mod, QuantDense)]
    for mod in dense:
        mod.int8_mxu = True
    try:
        logits_8 = prefill(data, bufs)[0][:, -1].float()
    finally:
        for mod in dense:
            mod.int8_mxu = False
    agree8 = logits_k.argmax(-1) == logits_8.argmax(-1)
    say(phase, step="k3-vs-plain-prefill", logits_rel_l2=f"{err:.3e}",
        rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}",
        first_token_agree=f"{int(agree.sum())}/{batch}", clear_margin_rows=int(clear.sum()),
        finite=bool(torch.isfinite(logits_k).all()),
        w4a8_first_token_agree=f"{int(agree8.sum())}/{batch}",
        w4a8_logits_rel_l2=f"{rel_l2(logits_k, logits_8):.3e}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    check(err <= bound, f"prefill logits rel_l2 {err:.3e} > {bound:.3e}")
    check(bool(agree[clear].all()), "first token differs on a row with a clear margin")
    return counts


# --------------------------------------------------------------- phase 12
def phase_perf_tools(dev) -> dict:
    """The port's ``tools/perf`` microbenchmarks at their default sizes, each
    ``main`` as ``python -m`` runs it; every line must be timed and every spot
    check within its bound (a bench raises otherwise). Returns the launch
    counts of the kernels they ran."""
    import functools

    import torch

    from mmor_tpu_torch.tools.perf import (bench_bitcast, bench_decode_parts, bench_dma_gather,
                                           bench_fused_mlp, bench_megakernel_probe,
                                           bench_packed, bench_prefill_matmul, bench_stream,
                                           bench_w8a16, probe_mosaic_reshape)

    reset_launch_counts()
    for name, main in (("bench_stream", bench_stream.main),
                       ("bench_w8a16", bench_w8a16.main),
                       ("bench_packed", bench_packed.main),
                       ("bench_decode_parts:weights",
                        functools.partial(bench_decode_parts.main, part="weights")),
                       ("bench_decode_parts:attn",
                        functools.partial(bench_decode_parts.main, part="attn")),
                       ("bench_bitcast", bench_bitcast.main),
                       ("bench_dma_gather", bench_dma_gather.main),
                       ("bench_fused_mlp", bench_fused_mlp.main),
                       *((f"bench_megakernel_probe:{part}",
                          functools.partial(bench_megakernel_probe.main, part=part))
                         for part in bench_megakernel_probe.PARTS),
                       ("probe_mosaic_reshape", probe_mosaic_reshape.main),
                       ("bench_prefill_matmul", bench_prefill_matmul.main)):
        t = time.perf_counter()
        try:
            result = main()
        except RuntimeError as e:  # a spot check over its bound, or a kernel fault
            raise Failed(f"{name}: {e}") from e
        sync(dev)
        say("12 perf-tools", bench=name, seconds=f"{time.perf_counter() - t:.1f}",
            **{f"{line.split()[0]}_ms": f"{ms:.4f}" for line, ms in result["ms"].items()
               if ms is not None},
            **{"spot_" + "_".join(c.split()[:2]): f"{e:.3e}" for c, e in result["spot"].items()})
        check(None not in result["ms"].values(), f"{name}: a line was not timed")
        if "sums" in result:  # the layout probe's all-ones sums, the JAX script's
            sums = tuple(result["sums"].values())
            check(sums == RESHAPE_SUMS, f"{name}: out_sums {sums} != {RESHAPE_SUMS}")
        gc.collect()
        torch.cuda.empty_cache()
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS["perf"]}
    say("12 perf-tools", step="launches", **{k.replace(" ", "_"): v for k, v in counts.items()})
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched by the perf tools")
    return counts


# --------------------------------------------------------------- phase 14
def phase_int8_a16_path(dev, preset_name: str = "7b", batch: int = BATCH,
                        prompt_len: int = PROMPT_LEN, new_tokens: int = NEW_TOKENS,
                        phase: str = "14 int8-w8a16") -> dict:
    """MM2SG-7B ``--quantize int8`` at ``quant_int8_mxu=False`` (no CLI flag,
    in JAX or here: the LlamaConfig field, set with ``dataclasses.replace``
    before ``quantize_int8``, which keeps it) through ``generate_stepwise``
    on phase 3's inputs and seeded weights: K2's W8A16 branch at every
    projection (the prefill's M 8 x 708 rows on its wgmma kernel, the
    decode's M 8 on its row-word kernel, the lm_head included), K4 at every
    decode layer, K1 at prefill; 300 new tokens, as phase 3. One warm call
    and one timed call (prefill ms, decode ms/token, frames/s, peak
    memory), ``perop_decode_profile`` (the device's busy share, K4's time),
    the launches of K2 by branch and of K4; the prefill's last-position
    logits against the same model with K2 swapped for its plain version,
    within LOGITS_FLOOR_FACTOR times the spread that a rounding step of each
    K2 output causes, and the first token on every row whose top-2 margin
    exceeds twice the largest logit difference; the top-1 agreement with the
    same weights at ``quant_int8_mxu=True`` (phase 3's W8A8 model) is
    printed, not gated: the two numerics differ by design. Returns the
    path's launch counts."""
    import dataclasses

    import torch

    from mmor_tpu_torch.cli.common import build_predictor, quantize_int8
    from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
    from mmor_tpu_torch.models.llama import QuantDense, make_decode_step
    from mmor_tpu_torch.models.mm2sg import generate_stepwise, make_prefill

    t0 = time.perf_counter()
    model = build_predictor(preset_name, ByteTokenizer(), None, device=dev, seed=0).model
    model.cfg = dataclasses.replace(
        model.cfg, llama=dataclasses.replace(model.cfg.llama, quant_int8_mxu=False))
    model = quantize_int8(model).eval()
    predictor = SceneGraphPredictor(cfg=model.cfg, model=model, tokenizer=ByteTokenizer(),
                                    device=dev)
    lc = model.cfg.llama
    data = left_padded_batch(model.cfg, batch, prompt_len, dev)
    sync(dev)
    say(phase, step="setup", preset=preset_name, seconds=f"{time.perf_counter() - t0:.2f}",
        weight_quant=lc.weight_quant, weight_bits=lc.weight_bits, kv_quant=lc.kv_quant,
        mega_decode=lc.mega_decode, ffn_pad=lc.ffn_pad, quant_int8_mxu=lc.quant_int8_mxu,
        new_tokens=new_tokens)
    check(not lc.quant_int8_mxu and lc.weight_quant and lc.weight_bits == 8 and lc.kv_quant
          and not lc.mega_decode, "not the int8 W8A16 config")

    cache_len = predictor._cache_len_for(prompt_len)
    cfg_run = dict(max_cache_len=cache_len, max_new_tokens=new_tokens, eos_token_id=-1)
    prefill = make_prefill(model, max_cache_len=cache_len)
    step = make_decode_step(model.language_model)
    prefill_s: list[float] = []

    def timed_prefill(b, bufs):
        sync(dev)
        t = time.perf_counter()
        out = prefill(b, bufs)
        sync(dev)
        prefill_s.append(time.perf_counter() - t)
        return out

    reset_launch_counts()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=step,
                                     **cfg_run)  # warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t = time.perf_counter()
    tokens, bufs = generate_stepwise(model, data, prefill_fn=timed_prefill, step_fn=step,
                                     cache_buffers=bufs, **cfg_run)
    sync(dev)
    total = time.perf_counter() - t
    decode_ms = (total - prefill_s[-1]) * 1e3 / (new_tokens - 1)
    say(phase, step="run", frames_per_s=f"{batch / total:.4f}", total_s=f"{total:.4f}",
        prefill_ms=f"{prefill_s[-1] * 1e3:.2f}", decode_ms_per_token=f"{decode_ms:.3f}",
        cache_len=cache_len,
        peak_mem_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    all_counts = launch_counts()
    counts = {k: v for k, v in all_counts.items() if k in PATH_KERNELS["int8a16"]}
    say(phase, step="launches", tokens="x".join(map(str, tokens.shape)),
        k2_w8a8=all_counts["K2 int8_matmul_packed"],
        **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(dev.type != "cuda" or n > 0, f"{name} was not launched on the int8a16 path")
    check(all_counts["K2 int8_matmul_packed"] == 0, "K2's W8A8 branch ran at int8_mxu=False")
    check(tokens.shape == (batch, new_tokens), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < lc.vocab_size)).all()), "token ids out of range")
    perop_decode_profile(dev, prefill, step, data, bufs, phase)

    # the prefill with K2 against the same prefill with K2's plain version,
    # and the plain one against itself with each K2 output moved by a
    # rounding step (the spread that rounding alone causes in this model)
    logits_k = prefill(data, bufs)[0][:, -1].float()
    with plain_qmm("int8_matmul_packed"):
        logits_p = prefill(data, bufs)[0][:, -1].float()
    with plain_qmm("int8_matmul_packed", perturb=torch.Generator(device=dev).manual_seed(1)):
        logits_n = prefill(data, bufs)[0][:, -1].float()
    err, floor = rel_l2(logits_k, logits_p), rel_l2(logits_n, logits_p)
    bound = LOGITS_FLOOR_FACTOR * floor
    diff = (logits_k - logits_p).abs().amax(dim=-1)
    top2 = logits_p.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * diff  # rows whose argmax cannot flip
    agree = logits_k.argmax(-1) == logits_p.argmax(-1)
    # the same weights at quant_int8_mxu=True: every QuantDense takes K2's
    # int8-activation branch
    dense = [mod for mod in model.modules() if isinstance(mod, QuantDense)]
    for mod in dense:
        mod.int8_mxu = True
    try:
        logits_8 = prefill(data, bufs)[0][:, -1].float()
    finally:
        for mod in dense:
            mod.int8_mxu = False
    agree8 = logits_k.argmax(-1) == logits_8.argmax(-1)
    say(phase, step="k2-vs-plain-prefill", logits_rel_l2=f"{err:.3e}",
        rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}",
        first_token_agree=f"{int(agree.sum())}/{batch}", clear_margin_rows=int(clear.sum()),
        finite=bool(torch.isfinite(logits_k).all()),
        w8a8_first_token_agree=f"{int(agree8.sum())}/{batch}",
        w8a8_logits_rel_l2=f"{rel_l2(logits_k, logits_8):.3e}")
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    check(err <= bound, f"prefill logits rel_l2 {err:.3e} > {bound:.3e}")
    check(bool(agree[clear].all()), "first token differs on a row with a clear margin")
    return counts


# ------------------------------------------------------------------- main
def _build_phase(build) -> None:
    path, secs = build.build()
    build.library()
    say("1 build", seconds=f"{secs:.2f}", library=os.path.relpath(path, ROOT))
    log = os.path.join(os.path.dirname(path), "nvcc.log")
    if os.path.exists(log):  # registers and spills of K1's, K2's, K5's, K8's, K9's, K10f's kernels
        for line in nvcc_report(open(log).read()):
            say("1 build", **line)


def nvcc_report(log: str) -> list[dict]:
    """``-Xptxas -v``'s registers, stack frame and spills of each kernel
    compiled from ``mega_decode.cu`` (its four (WBITS, KVBITS)
    instantiations and the W4A8/W8A8 cores), ``fused_mlp.cu`` (K9, whose
    registers set its cooperative grid), ``flash_attention.cu`` (K1, one
    kernel a head dim), ``decode_attention.cu`` (K4 and K7),
    ``int8_matmul.cu``'s wgmma and stream kernels (K2 at M > 16, both
    branches, K8 at M <= 16), ``int4_matmul.cu``'s wgmma kernels (K3 at M >
    16, both branches) and ``reshape_probe.cu``'s product (K10f), one dict
    a kernel, under the kernel's mangled name. K1's count is its
    12-warp launch's cap: its consumers' setmaxnreg does not raise what
    ptxas allocates."""
    import re

    out, name, frame, source = [], None, "", ""
    for line in log.splitlines():
        if " -c " in line:  # a source's nvcc command line
            source = line.split()[-1]
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line):
            frame = "/".join(m.groups())
        if (m := re.search(r"Used (\d+) registers", line)) and name:
            if (source.endswith(("mega_decode.cu", "fused_mlp.cu", "flash_attention.cu",
                                 "decode_attention.cu"))
                    or (source.endswith("int8_matmul.cu")
                        and ("wgmma" in name or "s8_stream" in name))
                    or (source.endswith("int4_matmul.cu") and "wgmma" in name)
                    or (source.endswith("reshape_probe.cu") and "product" in name)):
                out.append(dict(kernel=name, registers=int(m.group(1)),
                                stack_spill_st_ld_bytes=frame))
            name, frame = None, ""
    # readable names where the toolkit's demangler is at hand
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool and out:
        names = subprocess.run([tool], input="\n".join(d["kernel"] for d in out),
                               capture_output=True, text=True).stdout.splitlines()
        for d, readable in zip(out, names):
            for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)", "(bool)"):
                readable = readable.replace(noise, "")
            d["kernel"] = readable.removeprefix("void ").split("(")[0].replace(" ", "")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14",
                   help="comma-separated subset of phases to run")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="phases 3, 5, 7, 9, 10 and 11 also write per-kernel device time "
                        "tables to DIR")
    args = p.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from mmor_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the mmor_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    say("0 device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0).replace(" ", "_"),
        count=torch.cuda.device_count())
    print(card, flush=True)

    summary: dict = {}
    by_path: dict = {}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    prof = args.profile
    mega8: dict = {}  # the int8 megakernel predictor phases 10 and 11 share

    def int8_predictor():
        if "predictor" not in mega8:
            t = time.perf_counter()
            mega8["predictor"] = build_mega_predictor(dev, (8, 8))
            sync(dev)
            say("10 mega8", step="build", seconds=f"{time.perf_counter() - t:.2f}")
        return mega8["predictor"]

    # phase: (the path whose launch counts it returns, or None; the phase)
    runs = {
        1: (None, lambda: _build_phase(_build)),
        2: (None, lambda: phase_kernels(dev, summary)),
        3: ("int8", lambda: phase_main_path(dev, profile_dir=prof)),
        4: (None, lambda: phase_cli(dev)),
        5: ("int4", lambda: phase_mega_path(dev, profile_dir=prof)),
        6: (None, lambda: phase_cli(dev, quantize="int4", phase="6 cli")),
        7: ("panoptic", lambda: phase_panoptic(dev, profile_dir=prof)),
        8: (None, lambda: phase_panoptic_cli(dev)),
        9: ("overlap", lambda: phase_overlap(dev, profile_dir=prof)),
        10: ("mega8", lambda: phase_mega_path(dev, int8_predictor(), (8, 8), "10 mega8",
                                              "mega8", profile_dir=prof)),
        11: ("overlap8", lambda: phase_overlap(dev, int8_predictor(), (8, 8), "11 overlap8",
                                               "overlap8", profile_dir=prof)),
        12: ("perf", lambda: phase_perf_tools(dev)),
        13: ("int4a16", lambda: phase_a16_path(dev)),
        14: ("int8a16", lambda: phase_int8_a16_path(dev)),
    }
    t_start = time.perf_counter()
    try:
        for n in sorted(phases - {0}):
            t = time.perf_counter()
            path, run = runs[n]
            counts = run()
            if path:
                by_path[path] = counts
            if n == 11 or 11 not in phases:  # the int8 model's last phase is done
                mega8.clear()
            release()
            say(f"{n} phase-time", seconds=f"{time.perf_counter() - t:.1f}")
    except Failed as e:
        say("FAIL", reason=str(e).replace(" ", "_"))
        return 1
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        entry = summary.get(name, {})
        paths = {p: c[name] for p, c in by_path.items() if name in c}
        bound_by = entry.get("bound_by")
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=entry.get("max_abs_err"), ms=entry.get("ms"),
            plain_ms=entry.get("plain_ms"), bound_ms=entry.get("bound_ms"),
            bound_by=max(bound_by, key=bound_by.get) if bound_by else None,
            library_ms=entry.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

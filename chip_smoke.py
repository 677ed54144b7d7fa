#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmor_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles K1-K6 from ``mmor_tpu_torch/csrc`` (one nvcc a source);
2. kernel vs plain: each kernel against its plain PyTorch version at the
   serving paths' shapes, with the bound stated on each line, and its time
   beside its roofline bound, the plain version's time and, where one
   PyTorch call computes the same function, that call's time;
3. int8 path: MM2SG-7B ``--quantize int8`` ``generate_stepwise`` (batch 8,
   prompt 128 with left padding, raw uint8 views at their native sizes, 300
   new tokens), timed twice after a warm run; the launch counts of K1, K2
   and K4 over those runs, and the prefill's next-token logits with the
   kernels against the same prefill with the plain versions;
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
   widths): VPQ and STQ.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``--phases`` runs a subset.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
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
    "K3 int4_matmul_packed": (
        "cuda", "mmor_tpu_torch/csrc/int4_matmul.cu",
        "mmor_tpu/ops/quantized_matmul.py:371"),
    "K4 decode_attention_packed_stack": (
        "cuda", "mmor_tpu_torch/csrc/decode_attention.cu",
        "mmor_tpu/ops/attention.py:473"),
    "K5 mega_decode_layers": (
        "cuda", "mmor_tpu_torch/csrc/mega_decode.cu",
        "mmor_tpu/ops/mega_decode.py:1131"),
    "K6 ms_deform_attn": (
        "cuda", "mmor_tpu_torch/csrc/ms_deform_attn.cu",
        "mmor_tpu/ops/deformable_sampler.py:268"),
}
# the kernels each serving path runs (phase 3: int8, phase 5: int4,
# phase 7: panoptic)
PATH_KERNELS = {
    "int8": ("K1 flash_attention", "K2 int8_matmul_packed",
             "K4 decode_attention_packed_stack"),
    "int4": ("K1 flash_attention", "K2 int8_matmul_packed", "K3 int4_matmul_packed",
             "K5 mega_decode_layers"),
    "panoptic": ("K6 ms_deform_attn",),
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
# panoptic path (phase 7): frames at the JAX bench's 736x1280 in 3-frame
# windows, three windows a video
PANOPTIC_SIZE, PANOPTIC_FRAMES = (736, 1280), 9


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


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def _wrappers() -> dict:
    A, Q, M, D = kernel_modules()
    return {"K1 flash_attention": A.flash_attention,
            "K2 int8_matmul_packed": Q.int8_matmul_packed,
            "K3 int4_matmul_packed": Q.int4_matmul_packed,
            "K4 decode_attention_packed_stack": A.decode_attention_packed_stack,
            "K5 mega_decode_layers": M.mega_decode_layers,
            "K6 ms_deform_attn": D.ms_deform_attn_sampler}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


@contextlib.contextmanager
def plain_versions(perturb=None):
    """Route the models' kernel calls to the plain PyTorch versions (the
    models look the wrappers up on their modules at call time).

    With a ``torch.Generator`` as ``perturb``, every attention output (and
    every deformable attention sample) is also multiplied by
    (1 + u * 2**-8), u uniform in [-1, 1]: a rounding-sized change of each
    call, which measures how far such changes alone move the outputs of
    this randomly initialised model."""
    import torch

    from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

    A, Q, M, D = kernel_modules()
    saved = (A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed,
             Q.int4_matmul_packed, M.mega_decode_layers, M._attention_plain,
             D.ms_deform_attn_sampler)
    reference, mega_attention = A.mha_reference, M._attention_plain

    def perturbed(out):
        if perturb is None:
            return out
        u = torch.rand(out.shape, generator=perturb, device=out.device) * 2 - 1
        return (out.float() * (1 + u * 2.0 ** -8)).to(out.dtype)

    def mega_plain(*args, scratch=None, pointer_table=None, **kwargs):
        return M.mega_decode_layers_plain(*args, **kwargs)

    A.flash_attention = lambda *a, **kw: perturbed(reference(*a, **kw))
    A.decode_attention_packed_stack = A.decode_attention_packed_stack_plain
    Q.int8_matmul_packed = Q.int8_matmul_packed_plain
    Q.int4_matmul_packed = Q.int4_matmul_packed_plain
    M.mega_decode_layers = mega_plain
    M._attention_plain = lambda *a: perturbed(mega_attention(*a))
    D.ms_deform_attn_sampler = lambda *a: perturbed(ms_deform_attn(*a))
    try:
        yield
    finally:
        (A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed,
         Q.int4_matmul_packed, M.mega_decode_layers, M._attention_plain,
         D.ms_deform_attn_sampler) = saved


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
    ``extra`` checks outputs beyond the first tensor (K5's tuple)."""

    def __init__(self, kernel, name, fn, plain, bound, iters, on_path, nbytes, ops,
                 library=None, extra=None):
        self.kernel, self.name, self.fn, self.plain = kernel, name, fn, plain
        self.bound, self.iters, self.on_path = bound, iters, on_path
        self.nbytes, self.ops, self.library, self.extra = nbytes, ops, library, extra


def _attention_mask(b, sq, sk, causal, seg, dev):
    """K1's visibility as a boolean (B, 1, Sq, Sk) mask for the library call."""
    import torch

    mask = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    if seg is not None:
        mask &= seg[:, None, :, None] == seg[:, None, None, :]
    return mask


def _k5_case(dev, g):
    """K5 at full 7B width and depth 2: B=8, T=1024 with a partly masked
    int4 cache, random hidden states, int4 weights in 1024-row groups."""
    import torch

    from mmor_tpu_torch.ops import mega_decode as M
    from mmor_tpu_torch.ops import quantized_matmul as Q

    L, B, H, T, dh, D, F, G = 2, 8, 32, 1024, 128, 4096, 11264, 1024
    shapes = ((D, 3 * D), (D, D), (D, 2 * F), (F, D))
    layers = [[] for _ in range(8)]
    for _ in range(L):
        for i, (k, n) in enumerate(shapes):
            wq, sc = Q.quantize_weights_int4(
                torch.randn(k, n, generator=g, device=dev) * 0.02, G)
            layers[2 * i].append(Q.pack_int4_rows(wq, G))
            layers[2 * i + 1].append(sc)
    norms = 1 + 0.1 * torch.randn(L, 2, D, generator=g, device=dev)
    weights = M.MegaWeights(layers, norms, G, F, H)
    cache = {name: torch.randint(0, 256, (L, B, H, T, dh // 2), generator=g, device=dev,
                                 dtype=torch.int32).to(torch.uint8) for name in ("k", "v")}
    for name in ("k_s", "v_s"):
        cache[name] = (torch.rand(L, B, H, T, generator=g, device=dev) * 0.05 + 0.01
                       ).to(torch.bfloat16)
    mask = torch.zeros(B, T, dtype=torch.int32, device=dev)
    for r in range(B):
        mask[r, 8 * r: 708 + 37 * r] = 1
    cache.update(kv_mask=mask, write_pos=1000,
                 tok_pos=torch.arange(700, 700 + B, dtype=torch.int32, device=dev))
    x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = M.rope_tables(cache["tok_pos"], dh, 10000.0)
    scratch = M.alloc_scratch(weights, B, dev)
    table = weights.pointer_table()
    args = (x, weights, cache, cos, sin)
    valid = int(mask.sum())
    weight_bytes = L * sum(k * n // 2 + (k // G) * n * 4 for k, n in shapes)
    kv_bytes = L * H * valid * 2 * (dh // 2 + 2)
    nbytes = weight_bytes + kv_bytes + B * T * 4 + 2 * B * D * 2 + L * B * H * (2 * dh + 8)
    ops = {"int8": 2.0 * L * B * sum(k * n for k, n in shapes),
           "cuda_core": 4.0 * L * H * valid * dh}

    def extra(out, ref):
        return {k: f"{v:.5f}" if k.endswith("agree") else f"{v:.3e}"
                for k, v in k5_columns(out, ref, "K5").items()}

    return Case("K5 mega_decode_layers", f"7B L={L} B={B} T={T} partly masked",
                lambda: M.mega_decode_layers(*args, scratch=scratch, pointer_table=table),
                lambda: M.mega_decode_layers_plain(*args), K5_X_BOUND, 10, True,
                nbytes, ops, extra=extra)


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
            cases.append(Case(
                "K2 int8_matmul_packed", f"w8a8 M={m} K={kdim} N={n}",
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed(x, w_p, s),
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(x, w_p, s),
                1e-3, 10 if m == 8 else 3, True,
                m * kdim * 2 + kdim * n + n * 4 + m * n * 2, {"int8": 2.0 * m * kdim * n}))
    # W8A16 (quant_int8_mxu=False): not on a serving path
    x = randn(8, 4096)
    w_q, scale = Q.quantize_weights(torch.randn(4096, 4096, generator=g, device=dev) * 0.02)
    w_p = Q.pack_int8_rows(w_q)
    cases.append(Case(
        "K2 int8_matmul_packed", "w8a16 M=8 K=4096 N=4096",
        lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed(x, w_p, s, int8_mxu=False),
        lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(x, w_p, s, int8_mxu=False),
        1e-3, 10, False, 8 * 4096 * 2 + 4096 * 4096 + 4096 * 4 + 8 * 4096 * 2,
        {"bf16": 2.0 * 8 * 4096 * 4096}))

    # K3 at the int4 path's prefill rows (M=8x708) and at decode rows over
    # the fused projections: qkv, o, gate_up (ffn padded to 11264), down
    for m in (8, 5664):
        for kdim, n in ((4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)):
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
                {"int8": 2.0 * m * kdim * n}))

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

    cases.append(_k5_case(dev, g))
    cases.extend(_k6_cases(dev, g))
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
        ms = time_ms(case.fn, case.iters)
        plain_ms = time_ms(case.plain, max(1, case.iters // 3))
        lib_ms = time_ms(case.library, case.iters) if case.library else None
        bound_ms, bound_by = roofline_ms(case.nbytes, case.ops)
        say("2 kernel-vs-plain", kernel=case.kernel.split()[0],
            case=case.name.replace(" ", "_"), rel_l2=f"{err:.3e}", bound=f"{case.bound:.0e}",
            max_abs=f"{max_abs:.3e}", bit_exact=exact, ms=f"{ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, plain_ms=f"{plain_ms:.4f}",
            library_ms="none" if lib_ms is None else f"{lib_ms:.4f}",
            main_path=case.on_path, **extra)
        check(err <= case.bound, f"{what}: rel_l2 {err:.3e} > {case.bound:.0e}")
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
                entry["library_ms"] += lib_ms
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3
def left_padded_batch(cfg, batch: int, prompt_len: int, dev):
    """The seeded example batch at native view sizes, with row r left-padded
    by 8r tokens (so RoPE positions and cache slots differ by row)."""
    from mmor_tpu_torch.config import example_batch
    from mmor_tpu_torch.sg.prompts import IMAGE_TOKEN_INDEX

    data = example_batch(cfg, batch, prompt_len, seed=0, device=dev, raw_views=True)
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
K5_KERNEL_NAMES = ("w4a8::skinny_kernel", "attention_kernel", "norm_quant_kernel",
                   "widen_kernel", "narrow_kernel")


def device_window(dev, fn, names=K5_KERNEL_NAMES) -> tuple[int, float, float, float]:
    """(device events, device busy us, host wall us, us in the kernels whose
    names contain one of ``names``) of one call of ``fn`` under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k5_us = sum(e.time_range.elapsed_us() for e in events
                if any(k in e.name for k in names))
    return len(events), sum(e.time_range.elapsed_us() for e in events), wall_us, k5_us


def phase_int4_path(dev, preset_name: str = "7b", batch: int = BATCH,
                    prompt_len: int = PROMPT_LEN, new_tokens: int = NEW_TOKENS,
                    profile_dir: str | None = None) -> dict:
    """MM2SG ``--quantize int4`` serving through ``generate_stepwise`` with
    the decode megakernel, on phase 3's inputs; returns the launch counts of
    the warm and timed runs. With ``profile_dir``, also writes per-kernel
    device time tables of ``LAUNCH_STEPS`` decode steps and one prefill."""
    import torch

    from mmor_tpu_torch.cli.common import build_predictor
    from mmor_tpu_torch.inference import ByteTokenizer
    from mmor_tpu_torch.models.mm2sg import generate_stepwise, make_prefill
    from mmor_tpu_torch.ops import mega_decode as M

    t0 = time.perf_counter()
    predictor = build_predictor(preset_name, ByteTokenizer(), None, quantize="int4",
                                device=dev, seed=0)
    model, cfg = predictor.model, predictor.model.cfg
    lc, server = cfg.llama, predictor._step
    data = left_padded_batch(cfg, batch, prompt_len, dev)
    sync(dev)
    n_packed = sum(b.numel() * b.element_size() for b in model.language_model.buffers())
    say("5 int4-path", step="setup", preset=preset_name,
        seconds=f"{time.perf_counter() - t0:.2f}", lm_packed_bytes=n_packed,
        weight_bits=lc.weight_bits, weight_group=lc.weight_group, kv_bits=lc.kv_bits,
        mega_decode=lc.mega_decode, ffn_pad=lc.ffn_pad, quant_int8_mxu=lc.quant_int8_mxu)
    check(lc.mega_decode and lc.weight_bits == 4 and lc.kv_bits == 4 and lc.fused_qkv
          and lc.quant_int8_mxu and isinstance(server, M.MegaServer), "not the int4 config")

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
        say("5 int4-path", step=f"run{i + 1}", frames_per_s=f"{batch / total:.4f}",
            total_s=f"{total:.4f}", prefill_ms=f"{prefill_s[-1] * 1e3:.2f}",
            decode_ms_per_token=f"{decode_ms:.3f}", cache_len=cache_len)
    counts = {k: v for k, v in launch_counts().items() if k in PATH_KERNELS["int4"]}
    peak = torch.cuda.max_memory_allocated(dev)
    say("5 int4-path", step="launches", peak_mem_bytes=peak,
        tokens="x".join(map(str, tokens.shape)),
        **{k.split()[0]: v for k, v in counts.items()})
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the int4 path")
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
    n_ev, busy_us, wall_us, k5_us = device_window(dev, decode_steps)
    # K5's roofline for one step at full depth: every layer's int4 weights and
    # scales, and the valid int4 K/V positions with their scales
    weights = server.weights
    w_bytes = sum(t.numel() * t.element_size() for slot in weights.layers for t in slot)
    n_weights = sum(2 * t.numel() * t.element_size() for slot in weights.layers[0::2]
                    for t in slot)  # two int4 values a byte of the packed words
    valid = int(cache["kv_mask"].sum())
    kv_bytes = lc.n_layers * lc.n_heads * valid * 2 * (lc.head_dim // 2 + 2)
    k5_bound_ms, k5_bound_by = roofline_ms(
        w_bytes + kv_bytes, {"int8": 2.0 * batch * n_weights,
                             "cuda_core": 4.0 * lc.n_layers * lc.n_heads * valid * lc.head_dim})
    say("5 int4-path", step="decode-profile", steps=LAUNCH_STEPS,
        launches_per_step=f"{n_ev / LAUNCH_STEPS:.1f}",
        device_busy_ms_per_step=f"{busy_us / 1e3 / LAUNCH_STEPS:.3f}",
        wall_ms_per_step=f"{wall_us / 1e3 / LAUNCH_STEPS:.3f}",
        idle_share=f"{max(0.0, 1 - busy_us / wall_us):.4f}",
        k5_device_ms_per_step=f"{k5_us / 1e3 / LAUNCH_STEPS:.3f}",
        k5_bound_ms=f"{k5_bound_ms:.4f}", k5_bound_by=k5_bound_by,
        k5_weight_bytes=w_bytes, k5_kv_bytes=kv_bytes)
    if profile_dir:
        profile_window(dev, f"int4_decode_{LAUNCH_STEPS}_steps", decode_steps, profile_dir,
                       phase="5 profile")
        profile_window(dev, "int4_prefill", lambda: prefill(data, bufs), profile_dir,
                       phase="5 profile")

    k5_full_depth(server, cache, tok, lc)
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
    say("5 int4-path", step="k5-vs-plain-decode-step", logits_rel_l2=f"{err:.3e}",
        rounding_floor_rel_l2=f"{floor:.3e}", bound=f"{bound:.3e}",
        next_token_agree=f"{int(agree.sum())}/{batch}", clear_margin_rows=int(clear.sum()),
        finite=bool(torch.isfinite(logits_k).all()))
    check(bool(torch.isfinite(logits_k).all()), "non-finite decode logits")
    check(err <= bound, f"decode-step logits rel_l2 {err:.3e} > {bound:.3e}")
    check(bool(agree[clear].all()), "next token differs on a row with a clear margin")
    return counts


def k5_full_depth(server, cache: dict, tok, lc) -> None:
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
                            w.group, w.ffn, w.heads)
        c1 = dict(cache, **{k: cache[k][li:li + 1] for k in ("k", "v", "k_s", "v_s")})
        out = M.mega_decode_layers(x, one, c1, cos, sin, scratch=scratch, **kw)
        ref = M.mega_decode_layers_plain(x, one, c1, cos, sin, **kw)
        err = rel_l2(out[0], ref[0])
        check(err <= K5_X_BOUND, f"K5 layer {li}: x_out rel_l2 {err:.3e} > {K5_X_BOUND:.0e}")
        cols = k5_columns(out, ref, f"K5 layer {li}")
        worst_err = max(worst_err, err)
        worst_agree = min(worst_agree, cols["knew_agree"], cols["vnew_agree"])
        x = ref[0]
    say("5 int4-path", step="k5-vs-plain-by-layer", layers=lc.n_layers,
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


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="0,1,2,3,4,5,6,7,8",
                   help="comma-separated subset of phases to run")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="phases 3, 5 and 7 also write per-kernel device time tables to DIR")
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

    t_start = time.perf_counter()
    try:
        if 1 in phases:
            path, secs = _build.build()
            _build.library()
            say("1 build", seconds=f"{secs:.2f}", library=os.path.relpath(path, ROOT))
        if 2 in phases:
            phase_kernels(dev, summary)
            release()
        if 3 in phases:
            by_path["int8"] = phase_main_path(dev, profile_dir=args.profile)
            release()
        if 4 in phases:
            phase_cli(dev)
            release()
        if 5 in phases:
            by_path["int4"] = phase_int4_path(dev, profile_dir=args.profile)
            release()
        if 6 in phases:
            phase_cli(dev, quantize="int4", phase="6 cli")
            release()
        if 7 in phases:
            by_path["panoptic"] = phase_panoptic(dev, profile_dir=args.profile)
            release()
        if 8 in phases:
            phase_panoptic_cli(dev)
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

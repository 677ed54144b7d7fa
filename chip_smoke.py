#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmor_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles K1, K2 and K4 from ``mmor_tpu_torch/csrc``;
2. kernel vs plain: each kernel against its plain PyTorch version at the
   serving path's shapes, in bf16, with the bound stated on each line;
3. main path: MM2SG-7B int8 ``generate_stepwise`` (batch 8, prompt 128 with
   left padding, raw uint8 views at their native sizes, 300 new tokens),
   timed twice after a warm run; the launch counts of K1, K2 and K4 over
   those runs, and the prefill's next-token logits with the kernels against
   the same prefill with the plain versions;
4. CLI: ``mmor_tpu_torch.cli.evaluate_sg`` on a synthetic dataset at the
   7b preset with ``--quantize int8`` (predictor, raw point clouds through
   PTv3, F1 report).

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
    "K4 decode_attention_packed_stack": (
        "cuda", "mmor_tpu_torch/csrc/decode_attention.cu",
        "mmor_tpu/ops/attention.py:473"),
}

# main path (phase 3): batch, prompt tokens, new tokens
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
    from mmor_tpu_torch.ops import quantized_matmul as Q

    return A, Q


def launch_counts() -> dict:
    A, Q = kernel_modules()
    return {"K1 flash_attention": A.flash_attention.launches,
            "K2 int8_matmul_packed": Q.int8_matmul_packed.launches,
            "K4 decode_attention_packed_stack": A.decode_attention_packed_stack.launches}


def reset_launch_counts() -> None:
    A, Q = kernel_modules()
    A.flash_attention.launches = 0
    Q.int8_matmul_packed.launches = 0
    A.decode_attention_packed_stack.launches = 0


@contextlib.contextmanager
def plain_versions(perturb=None):
    """Route the models' kernel calls to the plain PyTorch versions (the
    models look the wrappers up on their modules at call time).

    With a ``torch.Generator`` as ``perturb``, every attention output is
    also multiplied by (1 + u * 2**-8), u uniform in [-1, 1]: a rounding-
    sized change of each attention call, which measures how far such
    changes alone move the logits of this randomly initialised model."""
    import torch

    A, Q = kernel_modules()
    saved = (A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed)
    reference = A.mha_reference

    def attention(*args, **kwargs):
        out = reference(*args, **kwargs)
        if perturb is None:
            return out
        u = torch.rand(out.shape, generator=perturb, device=out.device) * 2 - 1
        return (out.float() * (1 + u * 2.0 ** -8)).to(out.dtype)

    A.flash_attention = attention
    A.decode_attention_packed_stack = A.decode_attention_packed_stack_plain
    Q.int8_matmul_packed = Q.int8_matmul_packed_plain
    try:
        yield
    finally:
        A.flash_attention, A.decode_attention_packed_stack, Q.int8_matmul_packed = saved


# ---------------------------------------------------------------- phase 2
def kernel_cases(dev):
    """(kernel, case name, kernel fn, plain fn, rel_l2 bound, timing iters,
    on the main path)."""
    import torch

    A, Q = kernel_modules()
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf)

    cases = []

    def attn(name, b, h, s, d, causal=False, seg=None, iters=5):
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        kw = dict(causal=causal, segment_ids=seg)
        cases.append(("K1 flash_attention", name,
                      lambda: A.flash_attention(q, k, v, **kw),
                      lambda: A.mha_reference(q, k, v, **kw), 2e-2, iters, True))

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
            cases.append((
                "K2 int8_matmul_packed", f"w8a8 M={m} K={kdim} N={n}",
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed(x, w_p, s),
                lambda x=x, w_p=w_p, s=scale: Q.int8_matmul_packed_plain(x, w_p, s),
                1e-3, 10 if m == 8 else 3, True))
    # W8A16 (quant_int8_mxu=False): not on the int8 serving path
    x = randn(8, 4096)
    w_q, scale = Q.quantize_weights(torch.randn(4096, 4096, generator=g, device=dev) * 0.02)
    w_p = Q.pack_int8_rows(w_q)
    cases.append((
        "K2 int8_matmul_packed", "w8a16 M=8 K=4096 N=4096",
        lambda: Q.int8_matmul_packed(x, w_p, scale, int8_mxu=False),
        lambda: Q.int8_matmul_packed_plain(x, w_p, scale, int8_mxu=False),
        1e-3, 10, False))

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
    cases.append((
        "K4 decode_attention_packed_stack", "B=8 H=32 T=1008 D=128 layer 17",
        lambda: A.decode_attention_packed_stack(*args),
        lambda: A.decode_attention_packed_stack_plain(*args),
        1e-2, 20, True))
    return cases


def phase_kernels(dev, summary: dict) -> None:
    """Per kernel: the largest max-abs error over its cases, and its and the
    plain version's times summed over the cases on the main path."""
    import torch

    for kernel, name, fn, plain, bound, iters, on_path in kernel_cases(dev):
        out = fn()
        ref = plain()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{kernel} {name}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"{kernel} {name}: non-finite")
        err = rel_l2(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        ms = time_ms(fn, iters)
        plain_ms = time_ms(plain, max(1, iters // 3))
        say("2 kernel-vs-plain", kernel=kernel.split()[0], case=name.replace(" ", "_"),
            rel_l2=f"{err:.3e}", bound=f"{bound:.0e}", max_abs=f"{max_abs:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", main_path=on_path)
        check(err <= bound, f"{kernel} {name}: rel_l2 {err:.3e} > {bound:.0e}")
        entry = summary.setdefault(kernel, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        if on_path:
            entry["ms"] += ms
            entry["plain_ms"] += plain_ms
        del out, ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3
def left_padded_batch(cfg, batch: int, prompt_len: int, dev):
    """The seeded example batch at native view sizes, with row r left-padded
    by 8r tokens (so RoPE positions and cache slots differ by row)."""
    from mmor_tpu.sg.prompts import IMAGE_TOKEN_INDEX
    from mmor_tpu_torch.config import example_batch

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
    counts = launch_counts()
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


def profile_window(dev, name: str, fn, out_dir: str) -> None:
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
        say("3 profile", window=name, device_time="not_measured(no_device_events)")
        return
    say("3 profile", window=name, wall_ms=f"{wall_us / 1e3:.3f}",
        device_busy_ms=f"{busy_us / 1e3:.3f}",
        idle_share=f"{max(0.0, 1 - busy_us / wall_us):.4f}", kernels=len(rows))
    for kname, (us, n) in rows[:5]:
        say("3 profile", window=name, share=f"{us / busy_us:.4f}", ms=f"{us / 1e3:.3f}",
            launches=n, kernel=kname[:90].replace(" ", ""))


# ---------------------------------------------------------------- phase 4
def phase_cli(dev, preset_name: str = "7b") -> dict:
    from mmor_tpu_torch.cli import evaluate_sg

    t = time.perf_counter()
    summary = evaluate_sg.main(["--synthetic", "2", "--preset", preset_name,
                                "--quantize", "int8", "--batch_size", "2",
                                "--device", dev.type])
    check({"macro_f1", "precision", "recall"} <= set(summary), "no report")
    say("4 cli", preset=preset_name, seconds=f"{time.perf_counter() - t:.2f}",
        macro_f1=summary["macro_f1"], datatypes=json.dumps(summary["datatypes"]))
    return summary


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default="0,1,2,3,4",
                   help="comma-separated subset of phases to run")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="phase 3 also writes per-kernel device time tables to DIR")
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
    launches = {k: 0 for k in KERNELS}
    try:
        if 1 in phases:
            path, secs = _build.build()
            _build.library()
            say("1 build", seconds=f"{secs:.2f}", library=os.path.relpath(path, ROOT))
        if 2 in phases:
            phase_kernels(dev, summary)
        if 3 in phases:
            launches = phase_main_path(dev, profile_dir=args.profile)
            gc.collect()
            torch.cuda.empty_cache()
        if 4 in phases:
            phase_cli(dev)
    except Failed as e:
        say("FAIL", reason=str(e).replace(" ", "_"))
        return 1

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        entry = summary.get(name, {})
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=launches[name],
                            max_abs_err=entry.get("max_abs_err"),
                            ms=entry.get("ms"), plain_ms=entry.get("plain_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Microbenchmark: int8 weights streamed as W8A8 and as W8A16, on the H100.

Counterpart of ``tools/perf/bench_w8a16.py``. The question: at decode
shapes, how fast does the card stream int8 weights through a W8A8 kernel
(int8 activations, int8 tensor cores) and through a W8A16 one (the int8
weights converted to bf16 in registers, bf16 tensor cores), against a plain
bf16 product that moves twice the bytes.

Over L stacked (K, N) layers, every layer read once a scan (no reuse, as in
decode), it prints one line each:

- ``torch_bf16``: ``x @ w`` on bf16 weights (the anchor; bf16 bytes);
- ``w8a8``: K8, ``ops.quantized_matmul.int8_matmul``;
- ``w8a16``: K10a, ``w8a16_matmul`` (``csrc/stream_matmul.cu``);
- ``torch_mixed``: the int8 weight cast to bf16 times its scale, then the
  bf16 product: the dequantize-then-multiply baseline.

Each line gives ms a scan, GB/s of the weight bytes it moves, and the bound
of those bytes at the card's memory rate; then each quantized line's decode
speedup over bf16 (the time ratio per layer). Timing: ``timing.scan_ms``.
The TPU kernel's tiling arguments (``block_m/k/n``) are gone: the CUDA
kernel picks its own tile.

    python -m mmor_tpu_torch.tools.perf.bench_w8a16

(``BM_M`` rows, default 16; ``BM_REPEATS`` scans, default 30.)
"""

from __future__ import annotations

import os

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops.quantized_matmul import (int8_matmul, quantize_rows_div,
                                                 quantize_weights)
from mmor_tpu_torch.tools.perf.timing import card, device_for, run, spot

L = 8  # stacked layers, distinct weights
M = int(os.environ.get("BM_M", "16"))  # decode batch
K = 4096
N = 11008  # the 7B FFN width
REPEATS = int(os.environ.get("BM_REPEATS", "30"))
# one bf16 rounding step at the largest output: the kernels round their f32
# sums to bf16 once, the references keep f32
SPOT_BOUND = 2.0 ** -7


def w8a16_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10a: x rounded to bf16, times the int8 weight (exact in
    bf16), summed in f32, times the per-channel scale, cast to x.dtype."""
    acc = x.to(torch.bfloat16).float() @ w_q.float()
    return (acc * scale[None, :].float()).to(x.dtype)


def w8a16_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K10a: x (M, K) @ (w_q (K, N) int8 * scale (N,) f32) as W8A16 -> (M, N)
    in x.dtype (bf16 or f32).

    CPU: ``w8a16_matmul_plain``. CUDA: ``csrc/stream_matmul.cu``'s byte
    stream (K a multiple of 16), which reads x in its own (M, K) order and
    rounds f32 x to bf16 itself. It is launched with programmatic dependent
    launch and loads its first weight rows before the kernel ahead of it has
    finished: ``w_q`` and ``scale`` must not be that kernel's output. Counts
    its launches in ``w8a16_matmul.launches``."""
    m, k = x.shape
    if tuple(w_q.shape[:1]) != (k,) or tuple(scale.shape) != (w_q.shape[1],):
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    n = w_q.shape[1]
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, w_q, scale)
    if x.device.type != "cuda" or w_q.device != x.device or scale.device != x.device:
        raise ValueError("w8a16_matmul: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a16_matmul: x dtype {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("w8a16_matmul: w_q must be int8, scale f32")
    if k % 16:
        raise ValueError(f"w8a16_matmul: the kernel needs K % 16 == 0, K={k}")
    x, w_q, scale = _build.aligned(x), _build.aligned(w_q), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = _build.library().mmor_w8a16_bytes(
        _build.ptr(x), _build.ptr(w_q), _build.ptr(scale), _build.ptr(out), m, k, n,
        int(x.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "w8a16_matmul")
    w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0


def stacked_weights(layers: int, k: int, n: int, dev: torch.device, g: torch.Generator):
    """Seeded N(0, 0.02) weights (L, K, N) f32 and their per-layer int8
    quantization: (w, w_q (L, K, N) int8, scale (L, N) f32)."""
    w = torch.randn(layers, k, n, generator=g, device=dev) * 0.02
    qs = [quantize_weights(w[i]) for i in range(layers)]
    return w, torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])


def scanner(fn, x, *stacks):
    """One scan: ``fn(x, *layer)`` for each layer of the stacked operands."""
    def scan():
        for layer in zip(*stacks):
            fn(x, *layer)
    return scan


def main(device: str | torch.device = "cuda", *, m: int = M, k: int = K, n: int = N,
         layers: int = L, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if a spot check is over its bound."""
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w, w_q, scale = stacked_weights(layers, k, n, dev, g)
    w_bf = w.to(torch.bfloat16)
    del w
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"M={m} K={k} N={n} L={layers} REPEATS={repeats} device={dev.type}", flush=True)

    w0 = w_q[0].float() * scale[0][None, :]
    xq, rs = quantize_rows_div(x)
    errs = {name: spot(name, got, ref, SPOT_BOUND) for name, got, ref in (
        ("w8a16 rel err vs dequant ref", w8a16_matmul(x, w_q[0], scale[0]), x.float() @ w0),
        ("w8a8 rel err vs dequant W8A8 ref", int8_matmul(x, w_q[0], scale[0]),
         (xq.float() * rs[:, None]) @ w0))}

    def mixed(x, wl, sl):
        return x @ (wl.to(torch.bfloat16) * sl[None, :].to(torch.bfloat16))

    bf16_bytes, int8_bytes = layers * k * n * 2, layers * k * n
    ms = {
        "torch_bf16": run("torch_bf16", scanner(torch.matmul, x, w_bf), bf16_bytes, dev,
                          repeats, "bf16 weight bytes"),
        "w8a8": run("w8a8", scanner(int8_matmul, x, w_q, scale), int8_bytes, dev, repeats),
        "w8a16": run("w8a16", scanner(w8a16_matmul, x, w_q, scale), int8_bytes, dev,
                     repeats),
        "torch_mixed": run("torch_mixed", scanner(mixed, x, w_q, scale), int8_bytes, dev,
                           repeats),
    }
    if ms["torch_bf16"] is not None:
        for name in ("w8a8", "w8a16", "torch_mixed"):
            print(f"{name}: decode speedup vs bf16 = {ms['torch_bf16'] / ms[name]:.2f}x",
                  flush=True)
    return {"ms": ms, "spot": errs}


if __name__ == "__main__":
    main()

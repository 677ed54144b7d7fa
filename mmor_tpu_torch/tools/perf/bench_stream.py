"""Weight-stream rates at decode shapes on the H100: W8A8, W8A16 and packed
words against a bf16 anchor.

Counterpart of ``tools/perf/bench_stream.py``. Over L stacked (K, N) layers
at M decode rows it prints, in ms a scan and GB/s of the weight bytes moved:

- ``torch_bf16``: ``x @ w`` on bf16 weights (twice the bytes);
- ``w8a8``: K8 (``ops.quantized_matmul.int8_matmul``), int8 tensor cores;
- ``w8a16``: K10a (``bench_w8a16.w8a16_matmul``), unpacked int8 bytes
  converted to bf16;
- ``w8p``: K10b at int8 (``bench_packed.wp_matmul``), slab-packed words
  converted to bf16;

then each one's per-token speedup over bf16 (the time ratio of a scan).
Timing: ``timing.scan_ms`` (CUDA events over back-to-back scans, each queued
behind a spin kernel; eager PyTorch hoists nothing, so the TPU script's
perturbation of x between repeats is not needed).

    python -m mmor_tpu_torch.tools.perf.bench_stream

(``BM_M`` rows, default 16; ``BM_REPEATS`` scans, default 20.)
"""

from __future__ import annotations

import functools
import os

import torch

from mmor_tpu_torch.ops.quantized_matmul import int8_matmul
from mmor_tpu_torch.tools.perf.bench_packed import pack4_int8, wp_matmul
from mmor_tpu_torch.tools.perf.bench_w8a16 import scanner, stacked_weights, w8a16_matmul
from mmor_tpu_torch.tools.perf.timing import card, device_for, run

M = int(os.environ.get("BM_M", "16"))
K = 4096
N = 11264
L = 8
REPEATS = int(os.environ.get("BM_REPEATS", "20"))


def main(device: str | torch.device = "cuda", *, m: int = M, k: int = K, n: int = N,
         layers: int = L, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {}} (the
    kernels' spot checks are in ``bench_w8a16`` and ``bench_packed``)."""
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w, w_q, scale = stacked_weights(layers, k, n, dev, g)
    w_bf = w.to(torch.bfloat16)
    del w
    w_p8 = torch.stack([pack4_int8(q) for q in w_q])
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"M={m} K={k} N={n} L={layers} REPEATS={repeats} device={dev.type}", flush=True)

    bf16_bytes, int8_bytes = layers * k * n * 2, layers * k * n
    ms = {"torch_bf16": run("torch_bf16", scanner(torch.matmul, x, w_bf), bf16_bytes, dev,
                            repeats, "bf16 weight bytes"),
          "w8a8": run("w8a8", scanner(int8_matmul, x, w_q, scale), int8_bytes, dev, repeats),
          "w8a16": run("w8a16", scanner(w8a16_matmul, x, w_q, scale), int8_bytes, dev,
                       repeats),
          "w8p": run("w8p", scanner(functools.partial(wp_matmul, parts=4, bits=8), x, w_p8,
                                    scale), int8_bytes, dev, repeats)}
    if ms["torch_bf16"] is not None:
        print("per-token speedup vs bf16: " + " ".join(
            f"{name}={ms['torch_bf16'] / ms[name]:.2f}x" for name in ("w8a8", "w8a16", "w8p")),
            flush=True)
    return {"ms": ms, "spot": {}}


if __name__ == "__main__":
    main()

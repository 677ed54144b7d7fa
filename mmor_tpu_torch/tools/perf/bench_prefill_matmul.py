"""Microbenchmark: one prefill-shaped matmul through each packed weight path.

Counterpart of ``tools/perf/bench_prefill_matmul.py``. The question: at
prefill rows, which of the packed weight paths a ``QuantDense`` can take is
fastest on the card, and how each compares with a plain bf16 product. One
(M, K, N) product (default M 7040, a batch of 40 x 176-token chunks, K 4096,
N 11264) through:

- ``torch_bf16``: ``torch.matmul`` of bf16 x and the int4 weight dequantized
  to bf16 (the yardstick; the dequantization is not timed);
- ``k2_w8a8``, ``k2_w8a16``: K2, ``int8_matmul_packed`` with ``int8_mxu``
  on and off, on ``pack_int8_rows`` words with per-channel scales;
- ``k3_w4a8``, ``k3_w4a16``: K3, ``int4_matmul_packed`` with ``int8_mxu``
  on and off, on ``pack_int4_rows`` words in 1024-row groups;
- ``torch_int8``: ``torch._int_mm`` of int8 operands with no rescale (the
  JAX script's raw int8 dot: the int8 tensor cores' reach).

Each line gives ms a call (device time, ``timing.scan_ms``), TFLOP/s of
2 M K N operations, and the bound of those operations at the data sheet's
peak for the product's type (bf16 or int8). Each kernel is first held to its
plain version (``spot``).

    python -m mmor_tpu_torch.tools.perf.bench_prefill_matmul

(``BM_M``, ``BM_K``, ``BM_N``; ``BM_REPEATS`` calls, default 8.)
"""

from __future__ import annotations

import os
import time

import torch

from mmor_tpu_torch.ops.quantized_matmul import (int4_matmul_packed, int4_matmul_packed_plain,
                                                 int8_matmul_packed, int8_matmul_packed_plain,
                                                 pack_int4_rows, pack_int8_rows,
                                                 quantize_weights, quantize_weights_int4)
from mmor_tpu_torch.tools.perf.bench_w8a16 import SPOT_BOUND
from mmor_tpu_torch.tools.perf.timing import card, device_for, scan_ms, spot

M = int(os.environ.get("BM_M", "7040"))
K = int(os.environ.get("BM_K", "4096"))
N = int(os.environ.get("BM_N", "11264"))
REPEATS = int(os.environ.get("BM_REPEATS", "8"))
GROUP = 1024
# the data sheet's dense peaks of one H100 SXM at 700 W, operations/s
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def line(name: str, fn, ops: float, kind: str, dev: torch.device, repeats: int) -> float | None:
    """Time ``fn`` and print its line: ms a call, TFLOP/s of ``ops`` and
    their bound at ``kind``'s peak. Returns the ms (None on the CPU)."""
    t0 = time.perf_counter()
    ms, ahead = scan_ms(fn, repeats, dev)
    if ms is None:
        print(f"{name:12s} not measured (cpu, ran once)", flush=True)
        return None
    print(f"{name:12s} {ms:9.4f} ms {ops / ms / 1e9:7.1f} TFLOP/s bound "
          f"{ops / PEAK_OPS_PER_S[kind] * 1e3:.4f} ms ({kind} operations) "
          f"host_ahead={ahead}/{repeats} wall {time.perf_counter() - t0:.2f} s", flush=True)
    return ms


def main(device: str | torch.device = "cuda", *, m: int = M, k: int = K, n: int = N,
         group: int = GROUP, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if a spot check is over its bound."""
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    q8, s8 = quantize_weights(w)
    wp8 = pack_int8_rows(q8)
    q4, s4 = quantize_weights_int4(w, group)
    wp4 = pack_int4_rows(q4, group)
    w_bf = (q4.float().reshape(k // group, group, n) * s4[:, None, :]).reshape(k, n).to(
        torch.bfloat16)
    x8 = torch.clamp(torch.round(x.float() * 8), -127, 127).to(torch.int8)
    q8_cols = q8.t().contiguous().t()  # column-major, as cuBLASLt's int8 product takes it
    del w
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    ops = 2.0 * m * k * n
    print(f"M={m} K={k} N={n} group={group} REPEATS={repeats} device={dev.type} "
          f"({ops / 1e12:.2f} TFLOP a product)", flush=True)

    products = {
        "k2_w8a8": (lambda: int8_matmul_packed(x, wp8, s8),
                    lambda: int8_matmul_packed_plain(x, wp8, s8), "int8"),
        "k2_w8a16": (lambda: int8_matmul_packed(x, wp8, s8, int8_mxu=False),
                     lambda: int8_matmul_packed_plain(x, wp8, s8, int8_mxu=False), "bf16"),
        "k3_w4a8": (lambda: int4_matmul_packed(x, wp4, s4, group=group),
                    lambda: int4_matmul_packed_plain(x, wp4, s4, group=group), "int8"),
        "k3_w4a16": (lambda: int4_matmul_packed(x, wp4, s4, group=group, int8_mxu=False),
                     lambda: int4_matmul_packed_plain(x, wp4, s4, group=group,
                                                      int8_mxu=False), "bf16"),
    }
    errs = {f"{name} rel err vs plain": spot(f"{name} rel err vs plain", fn(), plain(),
                                             SPOT_BOUND)
            for name, (fn, plain, _) in products.items()}
    errs["torch_bf16 rel err vs k3_w4a16 plain"] = spot(
        "torch_bf16 rel err vs k3_w4a16 plain", x @ w_bf, products["k3_w4a16"][1](), SPOT_BOUND)
    ms = {"torch_bf16": line("torch_bf16", lambda: x @ w_bf, ops, "bf16", dev, repeats)}
    for name, (fn, _, kind) in products.items():
        ms[name] = line(name, fn, ops, kind, dev, repeats)
    ms["torch_int8"] = line("torch_int8", lambda: torch._int_mm(x8, q8_cols), ops, "int8", dev,
                            repeats)
    if ms["torch_bf16"] is not None:
        for name in products:
            print(f"{name}: speedup vs torch_bf16 = {ms['torch_bf16'] / ms[name]:.2f}x",
                  flush=True)
    return {"ms": ms, "spot": errs}


if __name__ == "__main__":
    main()

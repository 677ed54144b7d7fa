"""Microbenchmark: int8 weights streamed as row-packed int32 words, on the H100.

Counterpart of ``tools/perf/bench_bitcast.py``. The TPU version asked
whether loading int8 weights as 32-bit words (four K rows of one column a
word) and bitcasting them in registers streams them faster than int8 loads.
On the H100 the row-packed word is already a tensor-core operand: for the
int8 ``mma.sync`` one 32-bit register holds four consecutive k of one
column, and for the bf16 one the same word converts in registers to two
bf16x2 registers. So the two modes run kernels the port already has:

- ``w8b_bf16``: ``stream_matmul.cu``'s row-word kernel (K2's W8A16 at
  decode rows); x rounded to bf16, f32 sums, times the scale;
- ``w8b_mxu8``: ``int8_matmul.cu``'s W8A8 kernels (K2's, on its own packed
  words) with K8's activation rule, x / (amax / 127) per row in f32;
  int32 sums, times the scale, then the row scale.

Over L stacked (K, N) layers at M decode rows it prints ms a scan and GB/s of
the weight bytes moved (``torch_bf16``: ``x @ w`` on bf16 weights, the twin
of the JAX script's ``xla_bf16``, which moves twice the bytes), then each
mode's per-token speedup over bf16, after each mode's error against the
dequantized product. Timing: ``timing.scan_ms``. The TPU kernel's tiling
arguments (``block_m/k/n``) are gone.

    python -m mmor_tpu_torch.tools.perf.bench_bitcast

(``BM_M`` rows, default 16; ``BM_REPEATS`` scans, default 20.)
"""

from __future__ import annotations

import functools
import os

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops.quantized_matmul import (int8_matmul_plain, pack_int8_rows,
                                                 quantize_rows_div, unpack_int8_rows)
from mmor_tpu_torch.tools.perf.bench_w8a16 import SPOT_BOUND, scanner, stacked_weights
from mmor_tpu_torch.tools.perf.timing import card, device_for, run, spot

M = int(os.environ.get("BM_M", "16"))
K = 4096
N = 11264
L = 8
REPEATS = int(os.environ.get("BM_REPEATS", "20"))
MODES = ("bf16", "mxu8")

# the JAX script's pack_rows_int8 is K2's packing: byte b of word r is row 4r+b
pack_rows_int8 = pack_int8_rows


def w8b_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, *,
                     mode: str = "bf16") -> torch.Tensor:
    """Plain PyTorch K10c with the TPU kernel's numerics. ``bf16``: x rounded
    to bf16 times the int8 weight (exact in bf16), f32 sums, times the
    scale. ``mxu8``: ``quantize_rows_div``, the int8 product summed exactly,
    times the scale, then times the row scale, in f32. Cast to x.dtype."""
    w8 = unpack_int8_rows(w_packed)
    if mode == "mxu8":
        return int8_matmul_plain(x, w8, scale)
    return ((x.to(torch.bfloat16).float() @ w8.float()) * scale[None, :].float()).to(x.dtype)


def w8b_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, *,
               mode: str = "bf16") -> torch.Tensor:
    """K10c: x (M, K) @ (row-packed int8 w_packed (K/4, N) int32 * scale
    (N,) f32) -> (M, N) in x.dtype (bf16 or f32), in ``mode`` "bf16" or
    "mxu8".

    CPU: ``w8b_matmul_plain``. CUDA: ``csrc/stream_matmul.cu`` (bf16; K a
    multiple of 16) or ``csrc/int8_matmul.cu`` (mxu8; K a multiple of 64).
    Counts its launches in ``w8b_matmul.launches`` (bf16) and
    ``w8b_matmul.mxu8_launches``."""
    if mode not in MODES:
        raise ValueError(f"w8b_matmul: mode {mode!r}")
    m, k = x.shape
    kp, n = w_packed.shape
    if kp * 4 != k or tuple(scale.shape) != (n,):
        raise ValueError(f"w8b_matmul: x K={k}, packed K/4={kp}, scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return w8b_matmul_plain(x, w_packed, scale, mode=mode)
    if x.device.type != "cuda" or w_packed.device != x.device or scale.device != x.device:
        raise ValueError("w8b_matmul: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8b_matmul: x dtype {x.dtype}")
    if w_packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("w8b_matmul: w_packed must be int32, scale f32")
    if k % (64 if mode == "mxu8" else 16):
        raise ValueError(f"w8b_matmul: the {mode} kernel needs K % "
                         f"{64 if mode == 'mxu8' else 16} == 0, K={k}")
    lib = _build.library()
    w_packed, scale = _build.aligned(w_packed), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    if mode == "mxu8":
        xc = _build.aligned(x)
        xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
        rs = torch.empty(m, dtype=torch.float32, device=x.device)
        err = lib.mmor_int8_matmul_w8b(
            _build.ptr(xc), _build.ptr(xq), _build.ptr(rs), _build.ptr(w_packed),
            _build.ptr(scale), _build.ptr(out), m, k, n, is_bf16, _build.stream())
    else:  # the row-word stream kernel, K2's W8A16 at decode rows
        xb = _build.aligned(x.to(torch.bfloat16))
        err = lib.mmor_wp_matmul(_build.ptr(xb), _build.ptr(w_packed), _build.ptr(scale),
                                 _build.ptr(out), m, k, n, is_bf16, _build.stream())
    _build.check(err, f"w8b_matmul ({mode})")
    if mode == "mxu8":
        w8b_matmul.mxu8_launches += 1
    else:
        w8b_matmul.launches += 1
    return out


w8b_matmul.launches = w8b_matmul.mxu8_launches = 0


def main(device: str | torch.device = "cuda", *, m: int = M, k: int = K, n: int = N,
         layers: int = L, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if a spot check is over its bound."""
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w, w_q, scale = stacked_weights(layers, k, n, dev, g)
    w_pc = torch.stack([pack_rows_int8(q) for q in w_q])
    w_bf = w.to(torch.bfloat16)
    del w
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"M={m} K={k} N={n} L={layers} REPEATS={repeats} device={dev.type}", flush=True)

    w0 = w_q[0].float() * scale[0][None, :]
    xq, rs = quantize_rows_div(x)
    refs = {"bf16": x.float() @ w0, "mxu8": (xq.float() * rs[:, None]) @ w0}
    errs = {f"w8b_{mode} rel err vs dequant ref": spot(
        f"w8b_{mode} rel err vs dequant ref", w8b_matmul(x, w_pc[0], scale[0], mode=mode),
        refs[mode], SPOT_BOUND) for mode in MODES}
    del w_q, refs

    int8_bytes = layers * k * n
    ms = {"torch_bf16": run("torch_bf16", scanner(torch.matmul, x, w_bf), 2 * int8_bytes, dev,
                            repeats, "bf16 weight bytes")}
    for mode in MODES:
        ms[f"w8b_{mode}"] = run(f"w8b_{mode}",
                                scanner(functools.partial(w8b_matmul, mode=mode), x, w_pc, scale),
                                int8_bytes, dev, repeats)
    if ms["torch_bf16"] is not None:
        print("per-token speedup vs bf16: " + " ".join(
            f"w8b_{mode}={ms['torch_bf16'] / ms[f'w8b_{mode}']:.2f}x" for mode in MODES),
            flush=True)
    return {"ms": ms, "spot": errs}


if __name__ == "__main__":
    main()

"""Microbenchmark: int8 and int4 weights streamed as slab-packed int32 words.

Counterpart of ``tools/perf/bench_packed.py``. The TPU version asked whether
packing narrow weights into 32-bit words lifts their streaming rate; on the
H100 the same kernels answer how fast a W8A16 product streams int8 and int4
weights from words that hold 4 or 8 rows of one column.

The slab layout (neither K2's ``pack_int8_rows`` nor K3's ``pack_int4_rows``):

- int8 (``pack4_int8``): word (r, n) holds rows r + i*K/4 in byte i;
- int4 (``pack8_int4``): word (r, n) holds rows r + i*K/8 in nibble i,
  values in [-8, 7] with no bias, per-(layer, channel) scales amax / 7.

Lines, over L stacked (K, N) layers: ``w8p`` and ``w4p`` (K10b,
``wp_matmul``, ``csrc/stream_matmul.cu``) in GB/s of their logical weight
bytes, ``torch_bf16`` (``x @ w`` on bf16 weights), and the decode speedup of
each over bf16. Timing: ``timing.scan_ms``. The TPU kernel's tiling
arguments (``block_m``, ``block_kp``, ``block_n``) are gone.

    python -m mmor_tpu_torch.tools.perf.bench_packed

(``BM_M`` rows, default 16; ``BM_REPEATS`` scans, default 30.)
"""

from __future__ import annotations

import functools
import os

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.tools.perf.bench_w8a16 import SPOT_BOUND, scanner, stacked_weights
from mmor_tpu_torch.tools.perf.timing import card, device_for, run, spot

L = 8
M = int(os.environ.get("BM_M", "16"))
K = 4096
N = 11264  # the 7B FFN width rounded up to a multiple of 512
REPEATS = int(os.environ.get("BM_REPEATS", "30"))


def _pack(w_q: torch.Tensor, parts: int, bits: int) -> torch.Tensor:
    """(K, N) integers -> (K/parts, N) int32; field i of word (r, n) holds
    row r + i*K/parts, ``bits`` wide, two's complement."""
    k, n = w_q.shape
    if k % parts:
        raise ValueError(f"K={k} is not a multiple of {parts}")
    slabs = w_q.to(torch.int64).reshape(parts, k // parts, n) & ((1 << bits) - 1)
    word = torch.zeros(k // parts, n, dtype=torch.int64, device=w_q.device)
    for i in range(parts):
        word |= slabs[i] << (bits * i)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def pack4_int8(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (K/4, N) int32; byte i holds rows [i*K/4, (i+1)*K/4)."""
    return _pack(w_q, 4, 8)


def pack8_int4(w_q4: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued int8 -> (K/8, N) int32; nibble i holds rows
    [i*K/8, (i+1)*K/8)."""
    return _pack(w_q4, 8, 4)


def unpack_slabs(w_packed: torch.Tensor, parts: int, bits: int) -> torch.Tensor:
    """Inverse of the packing: (K/parts, N) int32 -> (K, N) int32, each field
    sign-extended as the TPU kernel's (w << (32 - bits*(i+1))) >> (32 - bits)."""
    w = w_packed.to(torch.int64)
    half, full = 1 << (bits - 1), 1 << bits
    slabs = [(w >> (bits * i)) & (full - 1) for i in range(parts)]
    return torch.cat([torch.where(s >= half, s - full, s) for s in slabs]).to(torch.int32)


def wp_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, *,
                    parts: int, bits: int) -> torch.Tensor:
    """Plain PyTorch K10b: x rounded to bf16, times the unpacked weight
    (exact in bf16), summed in f32, times the scale, cast to x.dtype."""
    w = unpack_slabs(w_packed, parts, bits).float()
    return ((x.to(torch.bfloat16).float() @ w) * scale[None, :].float()).to(x.dtype)


def wp_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, *,
              parts: int, bits: int) -> torch.Tensor:
    """K10b: x (M, K) @ (unpacked slabs of w_packed (K/parts, N) int32 *
    scale (N,) f32) -> (M, N) in x.dtype; ``parts=4, bits=8`` (w8p) or
    ``parts=8, bits=4`` (w4p).

    CPU: ``wp_matmul_plain``. CUDA: ``csrc/stream_matmul.cu``'s slab
    stream (K a multiple of 16 at int8, 32 at int4), which reads x in its
    own order (a copy only where a slab's run is not a multiple of 16
    bytes) and rounds f32 x to bf16 itself. It is launched with
    programmatic dependent launch and loads its first weight words before
    the kernel ahead of it has finished: ``w_packed`` and ``scale`` must not
    be that kernel's output. Counts its launches in ``wp_matmul.launches``."""
    if (parts, bits) not in ((4, 8), (8, 4)):
        raise ValueError(f"wp_matmul: parts={parts}, bits={bits}")
    m, k = x.shape
    kp, n = w_packed.shape
    if kp * parts != k or tuple(scale.shape) != (n,):
        raise ValueError(f"wp_matmul: x K={k}, packed K/{parts}={kp}, scale "
                         f"{tuple(scale.shape)}")
    if x.device.type == "cpu":
        return wp_matmul_plain(x, w_packed, scale, parts=parts, bits=bits)
    if x.device.type != "cuda" or w_packed.device != x.device or scale.device != x.device:
        raise ValueError("wp_matmul: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"wp_matmul: x dtype {x.dtype}")
    if w_packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("wp_matmul: w_packed must be int32, scale f32")
    if k % (4 * parts):
        raise ValueError(f"wp_matmul: the kernel needs K % {4 * parts} == 0, K={k}")
    # the kernel's TMA boxes of x start 16-byte aligned at each slab: where
    # K/parts values of a slab are not a multiple of 16 bytes (K % 32 at
    # int8, % 64 at int4, in bf16), the slabs are padded with zeros
    align = 16 // x.element_size()
    x_slab = -(-kp // align) * align
    if x_slab != kp:
        x = torch.nn.functional.pad(x.reshape(m, parts, kp), (0, x_slab - kp)).reshape(m, -1)
    x, w_packed, scale = _build.aligned(x), _build.aligned(w_packed), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = _build.library().mmor_slab_matmul(
        _build.ptr(x), _build.ptr(w_packed), _build.ptr(scale), _build.ptr(out), m, k, n, x_slab,
        bits, int(x.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "wp_matmul")
    wp_matmul.launches += 1
    return out


wp_matmul.launches = 0


def quantize_int4_channels(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, K, N) float -> (int4 values (L, K, N) int8 in [-8, 7], scales
    (L, N) f32 = amax / 7 per (layer, channel)), as the TPU script makes them."""
    amax = w.abs().amax(dim=1)
    s4 = torch.where(amax > 0, amax / torch.full_like(amax, 7.0), torch.ones_like(amax))
    return torch.clamp(torch.round(w / s4[:, None, :]), -8, 7).to(torch.int8), s4


def main(device: str | torch.device = "cuda", *, m: int = M, k: int = K, n: int = N,
         layers: int = L, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if a spot check is over its bound."""
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w, w_q, scale = stacked_weights(layers, k, n, dev, g)
    w_p8 = torch.stack([pack4_int8(q) for q in w_q])
    w_q4, s4 = quantize_int4_channels(w)
    w_p4 = torch.stack([pack8_int4(q) for q in w_q4])
    w_bf = w.to(torch.bfloat16)
    del w
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"M={m} K={k} N={n} L={layers} REPEATS={repeats} device={dev.type}", flush=True)

    w8p = functools.partial(wp_matmul, parts=4, bits=8)
    w4p = functools.partial(wp_matmul, parts=8, bits=4)
    errs = {}
    for name, fn, wp, q, s in (("w8p", w8p, w_p8, w_q, scale), ("w4p", w4p, w_p4, w_q4, s4)):
        ref = x.float() @ (q[0].float() * s[0][None, :])
        check = f"{name} rel err vs dequant ref"
        errs[check] = spot(check, fn(x, wp[0], s[0]), ref, SPOT_BOUND)
    del w_q, w_q4

    ms = {"w8p": run("w8p", scanner(w8p, x, w_p8, scale), layers * k * n, dev, repeats,
                     "logical weight bytes"),
          "w4p": run("w4p", scanner(w4p, x, w_p4, s4), layers * k * n // 2, dev, repeats,
                     "logical weight bytes"),
          "torch_bf16": run("torch_bf16", scanner(torch.matmul, x, w_bf), layers * k * n * 2,
                            dev, repeats, "bf16 weight bytes")}
    if ms["torch_bf16"] is not None:
        print(f"decode speedup vs bf16: w8p={ms['torch_bf16'] / ms['w8p']:.2f}x  "
              f"w4p={ms['torch_bf16'] / ms['w4p']:.2f}x", flush=True)
    return {"ms": ms, "spot": errs}


if __name__ == "__main__":
    main()

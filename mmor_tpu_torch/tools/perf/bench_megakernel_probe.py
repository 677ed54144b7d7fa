"""Microbenchmark: the megakernel design probes, on the H100.

Counterpart of ``tools/perf/bench_megakernel_probe.py``, whose four parts
asked what a fused multi-phase decode kernel (K5) could afford on a TPU. Here
they ask what K5's open Hopper form (one persistent kernel, or a CUDA graph
of the decode step) can afford (kernels: ``csrc/megakernel_probe.cu``):

- ``xread``: does it pay to hold x in shared memory, loaded once a block,
  against re-reading it from L2 at every K-tile? M rows (padded to mpad, a
  multiple of 32 for int8 x, 16 for bf16) times K2's packed int8 words,
  int8 x and W8A8 (``BM_MXU8=1``, x = clip(round(4x))) or bf16 x and W8A16
  (0). ``a_k2``: K2 (``int8_matmul_packed``) on the unpadded x; ``b_stack``:
  ``xread_matmul`` on the (n_k, mpad, CK) tile stack, as many blocks as fit
  on the card, each copying every K-tile of its rows into shared memory once
  (a tile at a time: bf16's 256 KB x is more than a block's 227 KB) and
  walking many 32-column units; ``c_dslice``: ``xread_matmul`` on the
  (mpad, K) array, a block a unit, its warps reading x from L2 at every
  k-step.
- ``overhead``: what a launch costs. Chains of 8 and 32 launches of the tiny
  identity kernel (``tiny`` on (16, 256) bf16), the 32-chain captured once
  as a CUDA graph and replayed, and 32 chained eager ``h * 1.0``
  (``tiny_plain``), each as device time a launch (the chain queued behind a
  spin kernel) and host wall time a launch (``perf_counter`` around
  synchronized chains): device time alone hides the host's cost.
- ``nibble``: does unpacking int4 eat the gain of half the bytes?
  ``nibble_w4a16``: W4A16 on ``pack_nibble_words`` (two signed nibbles a
  byte) with x deinterleaved a CK chunk at a time ([even rows | odd rows]);
  ``k2_w8a16``: K2's W8A16 on int8 words at the same logical size (the
  script's baseline); ``c_dslice_bf16``: ``xread_matmul`` (line c's
  kernel) in bf16 on those int8 words.
- ``rowrw``: what a decode-attention matvec over a KV block costs, with one
  output row written at a dynamic batch index: ``rowrw`` over 48 blocks of
  (16 heads x 128, 1024) int8 keys (100.7 MB), static (query and output row
  (0, 0)) and dynamic (row s). It also returns the full (48, 1024) acc (its
  plain version and the tests hold it), so it reads every key byte.

Each line gives device ms a call (``timing.scan_ms``), GB/s of the bytes a
call must move and their bound at the card's memory rate. The weights of
xread (46.1 MB) and nibble (23.1 MB) fit in the card's 50 MB L2, so a scan
rotates over distinct copies of them (4 for xread's and the int8
baseline's, 8 for nibble's), as ``bench_stream`` rotates 8 layers, and a
call's time is the scan's over the copies. The TPU kernels' weight tile
``BN`` is gone: the CUDA kernels work on 32-column units.

    BM_PART=xread python -m mmor_tpu_torch.tools.perf.bench_megakernel_probe

(``BM_PART`` xread | overhead | nibble | rowrw, default xread; ``BM_M`` rows,
default 24; ``BM_K`` 4096; ``BM_N`` 11264; ``BM_REPEATS`` scans, default 20;
``BM_MXU8`` 1 (int8 x) or 0 (bf16 x).)
"""

from __future__ import annotations

import os
import time

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops.quantized_matmul import (int8_matmul_packed, pack_int8_rows,
                                                 unpack_int8_rows)
from mmor_tpu_torch.tools.perf.bench_w8a16 import SPOT_BOUND
from mmor_tpu_torch.tools.perf.timing import HBM_BYTES_PER_S, card, device_for, scan_ms, spot

PART = os.environ.get("BM_PART", "xread")
M = int(os.environ.get("BM_M", "24"))
K = int(os.environ.get("BM_K", "4096"))
N = int(os.environ.get("BM_N", "11264"))
REPEATS = int(os.environ.get("BM_REPEATS", "20"))
MXU8 = os.environ.get("BM_MXU8", "1") == "1"
CK = 2048  # a K-tile (the TPU kernels' x chunk)
ROWRW = (24, 2, 16, 1024)  # the row probe's batch b, head groups, heads G, key positions T
XREAD_COPIES, NIBBLE_COPIES = 4, 8  # weight copies a scan rotates over (past the 50 MB L2)
# the tiny kernel's 1.0000001, a weakly typed constant that takes x's dtype:
# in bf16 it rounds to 1.0
TINY_BF16 = 1.0
PARTS = ("xread", "overhead", "nibble", "rowrw")
SMEM_PER_BLOCK = 232448  # the bytes of shared memory an H100 block can use
# bf16 x: a staged K-tile's row padding and the kernel's other shared memory,
# as csrc/megakernel_probe.cu's probe_kernel lays it out (warp partials, one
# unit's sums)
_PAD_BYTES, _FIXED_SMEM = 32, 8 * 32 * 33 * 4 + 32 * 32 * 4
# int8 x: the word stream's (xr::xread_stream_kernel) stages of three 16 KB
# word boxes (c: and four 4 KB x boxes of 128 k x 32 rows), b's K-tile of x
# in those 4 KB boxes, a 12 KB table of a tile's int32 sums, the barriers and
# the 1024-byte alignment; up to 4 stages, at least 2
_XR_WORDS, _XR_XBOX, _XR_TSUM, _XR_STAGES = 3 * 16384, 4096, 12288, 4


# ------------------------------------------------------------------ xread
def xread_mpad(m: int, x8: bool) -> int:
    """The script's padded rows: at least 32 and a multiple of 32 for int8
    x, at least 16 and a multiple of 16 for bf16."""
    return max(32, -(-m // 32) * 32) if x8 else max(16, -(-m // 16) * 16)


def xread_plan(ck: int, stack: bool) -> dict:
    """The int8 x-read kernel's plan for K-tiles of ``ck``: ``stage_rows``,
    the word rows a ring stage holds (the largest of 128, 64, 32, 16 dividing
    ck / 4, so that a stage never spans two tiles), ``stages`` (as many as
    fit, up to 4) and the block's shared-memory bytes ``smem``. Raises
    ValueError for a ck that is not a multiple of 64, or (the tile stack)
    whose 32-row K-tile and two stages do not fit a block: ck above 3712."""
    if ck < 64 or ck % 64:
        raise ValueError(f"xread_matmul: CK {ck} is not a multiple of 64")
    rows = 128
    while (ck // 4) % rows:
        rows //= 2
    stage = _XR_WORDS + (0 if stack else 4 * _XR_XBOX)
    fixed = 1024 + (-(-ck // 128) * _XR_XBOX if stack else 0) + _XR_TSUM + 16 * (_XR_STAGES + 1)
    fit = (SMEM_PER_BLOCK - fixed) // stage
    if fit < 2:
        raise ValueError(f"xread_matmul: a staged int8 K-tile of 32 x {ck} and two stages take "
                         f"{fixed + 2 * stage} bytes of shared memory, more than a block can use")
    stages = min(fit, _XR_STAGES)
    return {"stage_rows": rows, "stages": stages, "smem": fixed + stages * stage}


def tile_stack(x: torch.Tensor, ck: int) -> torch.Tensor:
    """(mpad, K) -> the (K / ck, mpad, ck) stack of its K-tiles."""
    mpad, k = x.shape
    return x.reshape(mpad, k // ck, ck).transpose(0, 1).contiguous()


def xread_matmul_plain(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor, *,
                       ck: int = CK) -> torch.Tensor:
    """Plain PyTorch K10e x-read: x int8 or bf16, the (K / ck, mpad, ck) tile
    stack or the (mpad, K) array; w_p (K/4, N) ``pack_int8_rows`` words;
    scale (N,) f32 -> (mpad, N) bf16 = (the sum over K-tiles, in order, of
    each tile's product as f32) * scale. int8: a tile's exact integer sum
    (float64 holds it) rounded to f32, the TPU's int32 dot cast to f32; bf16:
    the tile's product in f32."""
    stack = x if x.dim() == 3 else tile_stack(x, ck)
    ck = stack.shape[2]
    w8 = unpack_int8_rows(w_p)
    acc = torch.zeros(stack.shape[1], w8.shape[1], dtype=torch.float32, device=x.device)
    for kk in range(stack.shape[0]):
        wt, xt = w8[kk * ck:(kk + 1) * ck], stack[kk]
        if x.dtype == torch.int8:
            acc = acc + (xt.double() @ wt.double()).float()
        else:
            acc = acc + xt.float() @ wt.float()
    return (acc * scale[None, :].float()).to(torch.bfloat16)


def xread_matmul(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor, *,
                 ck: int = CK) -> torch.Tensor:
    """K10e x-read: ``xread_matmul_plain``'s function.

    CPU: ``xread_matmul_plain``. CUDA: ``csrc/megakernel_probe.cu``. A 3-D x
    (the tile stack) goes through shared memory a K-tile a block at a time
    (line b, counted in ``xread_matmul.launches``); a 2-D x (line c,
    ``xread_matmul.dslice_launches``) is read a stage at a time (int8 x)
    or at every k-step (bf16 x). int8 x takes the word stream
    (``xread_plan``: 96-column blocks over all of K, the words and x by TMA),
    launched with programmatic dependent launch: it loads its first words
    before the kernel ahead of it has finished, so ``w_p`` and ``scale`` must
    not be that kernel's output. bf16 x takes the first form's kernel. Both need CK %
    64 == 0 and N % 32 == 0; the stack's K-tile must fit a block's shared
    memory (int8: CK up to 3712, bf16: up to 2944)."""
    if x.dim() == 3:
        n_k, mpad, ck = x.shape
        k = n_k * ck
    elif x.dim() == 2:
        mpad, k = x.shape
    else:
        raise ValueError(f"xread_matmul: x {tuple(x.shape)} is neither a stack nor 2-D")
    kp, n = w_p.shape
    if kp * 4 != k or tuple(scale.shape) != (n,) or k % ck:
        raise ValueError(f"xread_matmul: x {tuple(x.shape)}, w_p {tuple(w_p.shape)}, "
                         f"scale {tuple(scale.shape)}, CK {ck}")
    if x.device.type == "cpu":
        return xread_matmul_plain(x, w_p, scale, ck=ck)
    if x.device.type != "cuda" or w_p.device != x.device or scale.device != x.device:
        raise ValueError("xread_matmul: operands must share one CUDA device")
    if x.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"xread_matmul: x dtype {x.dtype} (int8 or bf16)")
    if w_p.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("xread_matmul: w_p must be int32, scale f32")
    if ck % 64 or n % 32:
        raise ValueError(f"xread_matmul: the kernel needs CK % 64 == 0 and N % 32 == 0 "
                         f"(CK {ck}, N {n})")
    stack = x.dim() == 3
    if x.dtype == torch.int8:
        xread_plan(ck, stack)
    elif stack and 32 * (ck * 2 + _PAD_BYTES) + _FIXED_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"xread_matmul: a staged K-tile of 32 x {ck} {x.dtype} takes "
                         f"{32 * (ck * 2 + _PAD_BYTES)} bytes of shared memory, more than a "
                         "block can use")
    x, w_p, scale = _build.aligned(x), _build.aligned(w_p), _build.aligned(scale)
    out = torch.empty(mpad, n, dtype=torch.bfloat16, device=x.device)
    err = _build.library().mmor_xread_probe(
        _build.ptr(x), _build.ptr(w_p), _build.ptr(scale), _build.ptr(out), mpad, k, n, ck,
        int(x.dtype == torch.int8), int(stack), _build.stream())
    _build.check(err, "xread_matmul")
    if stack:
        xread_matmul.launches += 1
    else:
        xread_matmul.dslice_launches += 1
    return out


xread_matmul.launches = xread_matmul.dslice_launches = 0


# --------------------------------------------------------------- overhead
def tiny_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10e tiny kernel on bf16 x: x times 1.0000001 taken in
    bf16, the TPU kernel's weakly typed constant, which is 1.0: an
    identity."""
    return x * TINY_BF16


def tiny(x: torch.Tensor) -> torch.Tensor:
    """K10e tiny kernel: ``tiny_plain``'s function on bf16 x (numel a
    multiple of 8). CPU: ``tiny_plain``. CUDA: ``csrc/megakernel_probe.cu``;
    counts its launches in ``tiny.launches`` (a CUDA graph's replays do not
    pass through here and are not counted)."""
    if x.device.type == "cpu":
        return tiny_plain(x)
    if x.device.type != "cuda":
        raise ValueError("tiny: x must lie on a CUDA device")
    if x.dtype != torch.bfloat16 or x.numel() % 8:
        raise ValueError(f"tiny: bf16 x with numel % 8 == 0, got {x.dtype} {tuple(x.shape)}")
    x = _build.aligned(x)
    out = torch.empty_like(x)
    err = _build.library().mmor_tiny_probe(_build.ptr(x), _build.ptr(out), x.numel(),
                                           _build.stream())
    _build.check(err, "tiny")
    tiny.launches += 1
    return out


tiny.launches = 0


# ----------------------------------------------------------------- nibble
def pack_nibble_words(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued integers -> (K/8, N) int32: nibble i of word r
    holds row 8r + i in two's complement (byte b: rows 8r + 2b low, 8r + 2b +
    1 high). The JAX script's ``pack_int4_rows`` (its :227), not K3's biased,
    group-split ``ops.quantized_matmul.pack_int4_rows``."""
    k, n = w_q.shape
    if k % 8:
        raise ValueError(f"pack_nibble_words: K={k} is not a multiple of 8")
    w = w_q.to(torch.int64).reshape(k // 8, 8, n) & 0xF
    word = torch.zeros(k // 8, n, dtype=torch.int64, device=w_q.device)
    for i in range(8):
        word |= w[:, i] << (4 * i)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def unpack_nibble_words(w_p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_nibble_words``: (K/8, N) int32 -> (K, N) int8."""
    kp, n = w_p.shape
    parts = [((w_p << (28 - 4 * i)) >> 28).to(torch.int8) for i in range(8)]
    return torch.stack(parts, dim=1).reshape(kp * 8, n)


def deinterleave_chunks(x: torch.Tensor, ck: int, mpad: int) -> torch.Tensor:
    """(M, K) -> (K / ck, mpad, ck) in x's dtype: chunk c's columns are
    [x's even rows of the chunk | its odd rows], rows past M zero (the JAX
    script's nibble x, its :280-284)."""
    m, k = x.shape
    xc = x.reshape(m, k // ck, ck).transpose(0, 1)
    out = torch.zeros(k // ck, mpad, ck, dtype=x.dtype, device=x.device)
    out[:, :m] = torch.cat([xc[..., 0::2], xc[..., 1::2]], dim=-1)
    return out


def nibble_matmul_plain(xi: torch.Tensor, w_p: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10e nibble product: xi (K / ck, mpad, ck) bf16 from
    ``deinterleave_chunks``; w_p (K/8, N) ``pack_nibble_words``; scale (N,)
    f32 -> (mpad, N) bf16: per chunk xe . lo + xo . hi in f32 (lo the
    chunk's even rows' weights, hi its odd rows'), the chunks added in order,
    times the scale."""
    n_k, mpad, ck = xi.shape
    w = unpack_nibble_words(w_p).float()
    acc = torch.zeros(mpad, w.shape[1], dtype=torch.float32, device=xi.device)
    for kk in range(n_k):
        wt = w[kk * ck:(kk + 1) * ck]
        xe, xo = xi[kk, :, :ck // 2].float(), xi[kk, :, ck // 2:].float()
        acc = acc + (xe @ wt[0::2] + xo @ wt[1::2])
    return (acc * scale[None, :].float()).to(torch.bfloat16)


def nibble_matmul(xi: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K10e nibble product: ``nibble_matmul_plain``'s function.

    CPU: ``nibble_matmul_plain``. CUDA: ``csrc/megakernel_probe.cu``'s
    nibble stream (CK % 64 == 0, N % 32 == 0), which reads xi by TMA once a
    block. It is launched with programmatic dependent launch and loads its
    first words before the kernel ahead of it has finished: ``w_p`` and
    ``scale`` must not be that kernel's output. Counts its launches in
    ``nibble_matmul.launches``."""
    n_k, mpad, ck = xi.shape
    kp, n = w_p.shape
    if kp * 8 != n_k * ck or tuple(scale.shape) != (n,):
        raise ValueError(f"nibble_matmul: xi {tuple(xi.shape)}, w_p {tuple(w_p.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if xi.device.type == "cpu":
        return nibble_matmul_plain(xi, w_p, scale)
    if xi.device.type != "cuda" or w_p.device != xi.device or scale.device != xi.device:
        raise ValueError("nibble_matmul: operands must share one CUDA device")
    if xi.dtype != torch.bfloat16 or w_p.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("nibble_matmul: xi bf16, w_p int32, scale f32")
    if ck % 64 or n % 32:
        raise ValueError(f"nibble_matmul: the kernel needs CK % 64 == 0 and N % 32 == 0 "
                         f"(CK {ck}, N {n})")
    xi, w_p, scale = _build.aligned(xi), _build.aligned(w_p), _build.aligned(scale)
    out = torch.empty(mpad, n, dtype=torch.bfloat16, device=xi.device)
    err = _build.library().mmor_nibble_probe(
        _build.ptr(xi), _build.ptr(w_p), _build.ptr(scale), _build.ptr(out), mpad, n_k * ck, n,
        ck, _build.stream())
    _build.check(err, "nibble_matmul")
    nibble_matmul.launches += 1
    return out


nibble_matmul.launches = 0


# ------------------------------------------------------------------ rowrw
def key_rows(kp: torch.Tensor) -> torch.Tensor:
    """(S, G, 32, T) int32 -> (S, G, 128, T) int8: row 4r + b is byte b of
    word row r, the TPU's bitcast along the second-minor axis
    (``tools/perf/bench_bitcast.py:39-41``)."""
    s, g, r, t = kp.shape
    parts = [((kp << (24 - 8 * b)) >> 24).to(torch.int8) for b in range(4)]
    return torch.stack(parts, dim=3).reshape(s, g, 4 * r, t)


def rowrw_plain(q: torch.Tensor, kp: torch.Tensor, *, dyn: bool):
    """Plain PyTorch K10e row probe: q (hgn, b, G * 128) bf16, kp (hgn * b,
    G, 32, T) int32 -> (out (hgn, b, G * 128) f32, acc (hgn * b, T) f32).
    Program s = hg * b + bi takes query row (hg, bi) (dyn) or (0, 0)
    (static); acc[s] = the sum over heads g, in order, of q[g * 128:(g + 1)
    * 128] . key_rows(kp)[s, g] in f32 from bf16 operands. dyn: out row (hg,
    bi) is acc[s, 0] everywhere; static: row (0, 0) is acc[S - 1, 0], the
    last program's (the TPU grid runs in order), and every other row 0 (the
    TPU left them undefined)."""
    hgn, b, width = q.shape
    s, g, _, t = kp.shape
    k8 = key_rows(kp).float()
    rows = q.reshape(s, width).float()
    if not dyn:
        rows = rows[:1].expand(s, width)
    acc = torch.zeros(s, t, dtype=torch.float32, device=q.device)
    for gi in range(g):
        acc = acc + torch.bmm(rows[:, None, gi * 128:(gi + 1) * 128].contiguous(), k8[:, gi])[:, 0]
    out = torch.zeros(s, width, dtype=torch.float32, device=q.device)
    if dyn:
        out[:] = acc[:, :1]
    else:
        out[0] = acc[-1, 0]
    return out.reshape(hgn, b, width), acc


def rowrw(q: torch.Tensor, kp: torch.Tensor, *, dyn: bool):
    """K10e row probe: ``rowrw_plain``'s function (T % 128 == 0).

    CPU: ``rowrw_plain``. CUDA: ``csrc/megakernel_probe.cu``; counts its
    launches in ``rowrw.launches``."""
    hgn, b, width = q.shape
    s, g, r, t = kp.shape
    if s != hgn * b or r != 32 or width != g * 128:
        raise ValueError(f"rowrw: q {tuple(q.shape)}, kp {tuple(kp.shape)}")
    if q.device.type == "cpu":
        return rowrw_plain(q, kp, dyn=dyn)
    if q.device.type != "cuda" or kp.device != q.device:
        raise ValueError("rowrw: operands must share one CUDA device")
    if q.dtype != torch.bfloat16 or kp.dtype != torch.int32:
        raise TypeError(f"rowrw: q {q.dtype} (bf16), kp {kp.dtype} (int32)")
    if t % 128 or g * 128 * 4 > 48 * 1024:
        raise ValueError(f"rowrw: the kernel needs T % 128 == 0 and at most 96 heads "
                         f"(T {t}, heads {g})")
    q, kp = _build.aligned(q), _build.aligned(kp)
    out = torch.empty(hgn, b, width, dtype=torch.float32, device=q.device)
    acc = torch.empty(s, t, dtype=torch.float32, device=q.device)
    err = _build.library().mmor_rowrw_probe(_build.ptr(q), _build.ptr(kp), _build.ptr(out),
                                            _build.ptr(acc), s, g, t, int(dyn), _build.stream())
    _build.check(err, "rowrw")
    rowrw.launches += 1
    return out, acc


rowrw.launches = 0


# ------------------------------------------------------------------- main
def _line(name: str, call, copies: int, nbytes: float, dev: torch.device, repeats: int,
          what: str = "weight bytes") -> float | None:
    """Time a scan of ``call(i)`` over the ``copies`` rotated operands and
    print the line: device ms a call, GB/s of the ``nbytes`` a call must move
    and their bound. Returns ms a call (None on the CPU)."""
    ms, ahead = scan_ms(lambda: [call(i) for i in range(copies)], repeats, dev)
    if ms is None:
        print(f"{name:34s} not measured (cpu, ran once)", flush=True)
        return None
    ms /= copies
    print(f"{name:34s} {ms:9.4f} ms/call {nbytes / ms / 1e6:8.1f} GB/s ({what}) bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms host_ahead={ahead}/{repeats}", flush=True)
    return ms


def _exact(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Print and return max |got - ref|; raise unless 0."""
    err = float((got.double() - ref.double()).abs().max())
    print(f"{name}: max abs {err:.4e} (must be 0)", flush=True)
    if err != 0.0:
        raise RuntimeError(f"spot check {name}: max abs {err:.4e} != 0")
    return err


def xread_part(dev, g, m, k, n, repeats, mxu8, ck) -> dict:
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    wps = [pack_int8_rows(wq)]
    wps += [wps[0].clone() for _ in range(XREAD_COPIES - 1)]
    sc = torch.full((n,), 0.01, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    wbytes = k * n
    ms = {"a_k2": _line("a_k2 (K2, x unpadded)",
                        lambda i: int8_matmul_packed(x, wps[i], sc, int8_mxu=mxu8),
                        XREAD_COPIES, wbytes, dev, repeats)}
    if mxu8:  # the probe kernels take pre-quantized int8 x
        x = torch.clamp(torch.round(x.float() * 4.0), -127, 127).to(torch.int8)
    mpad = xread_mpad(m, mxu8)
    xr = torch.zeros(mpad, k, dtype=x.dtype, device=dev)
    xr[:m] = x
    xt = tile_stack(xr, ck)
    ref = (xr.double() @ wq.double()) * sc.double()
    spots = {}
    for key, desc, xx in (("b_stack", "x in smem, a K-tile once a block", xt),
                          ("c_dslice", "x from L2 at every k-step", xr)):
        spots[f"xread_{key} rel err vs f64 ref"] = spot(
            f"xread_{key} rel err vs f64 ref", xread_matmul(xx, wps[0], sc, ck=ck), ref,
            SPOT_BOUND)
        ms[key] = _line(f"{key} ({desc})", lambda i, xx=xx: xread_matmul(xx, wps[i], sc, ck=ck),
                        XREAD_COPIES, wbytes, dev, repeats)
    return {"ms": ms, "spot": spots}


def overhead_part(dev, g, repeats) -> dict:
    x = torch.randn(16, 256, generator=g, device=dev).to(torch.bfloat16)

    def chain(n: int, link):
        def run():
            h = x
            for _ in range(n):
                h = link(h)
            return h
        return run

    spots = {"tiny identity": _exact("tiny identity", tiny(x), x),
             "tiny 32-chain identity": _exact("tiny 32-chain identity", chain(32, tiny)(), x)}
    runs = {"tiny8": (chain(8, tiny), 8), "tiny32": (chain(32, tiny), 32),
            "eager32": (chain(32, tiny_plain), 32)}
    if dev.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain(32, tiny)()  # warm outside the capture, as capture asks
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            graph_out = chain(32, tiny)()
        graph.replay()
        spots["graph32 identity"] = _exact("graph32 identity", graph_out, x)
        runs["graph32"] = (graph.replay, 32)
    ms = {}
    for name, (run, n) in runs.items():
        dev_ms, ahead = scan_ms(run, repeats, dev)
        ms[f"{name}_device"] = None if dev_ms is None else dev_ms / n
        if dev_ms is None:
            ms[f"{name}_host"] = None
            print(f"{name:8s} not measured (cpu, ran once)", flush=True)
            continue
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            run()
        torch.cuda.synchronize(dev)
        ms[f"{name}_host"] = (time.perf_counter() - t0) * 1e3 / repeats / n
        print(f"{name:8s} {n:3d} launches: device {ms[f'{name}_device'] * 1e3:8.2f} us/launch "
              f"(host_ahead={ahead}/{repeats}), host wall {ms[f'{name}_host'] * 1e3:8.2f} "
              f"us/launch", flush=True)
    if dev.type != "cuda":
        ms["graph32_device"] = ms["graph32_host"] = None
        print("graph32  not measured (cpu: CUDA graphs need the card)", flush=True)
    return {"ms": ms, "spot": spots}


def nibble_part(dev, g, m, k, n, repeats, ck) -> dict:
    wq = torch.randint(-8, 8, (k, n), generator=g, device=dev, dtype=torch.int8)
    wp4 = [pack_nibble_words(wq)]
    wp4 += [wp4[0].clone() for _ in range(NIBBLE_COPIES - 1)]
    sc = torch.full((n,), 0.01, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    mpad = xread_mpad(m, False)
    xi = deinterleave_chunks(x, ck, mpad)
    ref = (x.double() @ wq.double()) * sc.double()
    spots = {"nibble rel err vs f64 ref": spot(
        "nibble rel err vs f64 ref", nibble_matmul(xi, wp4[0], sc)[:m], ref, SPOT_BOUND)}
    ms = {"nibble_w4a16": _line("nibble_w4a16 (int4 words)",
                                lambda i: nibble_matmul(xi, wp4[i], sc), NIBBLE_COPIES,
                                k * n // 2, dev, repeats)}
    del wp4
    wq8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    wp8 = [pack_int8_rows(wq8)]
    wp8 += [wp8[0].clone() for _ in range(XREAD_COPIES - 1)]
    xr = torch.zeros(mpad, k, dtype=x.dtype, device=dev)
    xr[:m] = x
    ms["k2_w8a16"] = _line("k2_w8a16 (K2, int8 words, 2x bytes)",
                           lambda i: int8_matmul_packed(x, wp8[i], sc, int8_mxu=False),
                           XREAD_COPIES, k * n, dev, repeats)
    ms["c_dslice_bf16"] = _line("c_dslice_bf16 (int8 words, 2x bytes)",
                                lambda i: xread_matmul(xr, wp8[i], sc, ck=ck), XREAD_COPIES,
                                k * n, dev, repeats)
    return {"ms": ms, "spot": spots}


def rowrw_part(dev, g, repeats, shape) -> dict:
    b, hgn, heads, t = shape
    q = torch.randn(hgn, b, heads * 128, generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randint(-2 ** 30, 2 ** 30, (hgn * b, heads, 32, t), generator=g, device=dev,
                       dtype=torch.int32)
    kv_bytes = hgn * b * heads * 128 * t
    k8 = key_rows(kp).double()
    spots, ms = {}, {}
    for dyn in (False, True):
        key = "rowrw_dyn" if dyn else "rowrw_static"
        out, acc = rowrw(q, kp, dyn=dyn)
        rows = q.reshape(hgn * b, -1).double()
        if not dyn:
            rows = rows[:1].expand_as(rows)
        ref = torch.einsum("sk,skt->st", rows, k8.flatten(1, 2))
        spots[f"{key} acc rel err vs f64 ref"] = spot(f"{key} acc rel err vs f64 ref", acc, ref,
                                                      SPOT_BOUND)
        want = torch.zeros_like(out).reshape(hgn * b, -1)
        if dyn:
            want[:] = acc[:, :1]
        else:
            want[0] = acc[-1, 0]
        spots[f"{key} rows"] = _exact(f"{key} rows", out.reshape(hgn * b, -1), want)
        desc = "row s, query s" if dyn else "row (0, 0), query (0, 0)"
        ms[key] = _line(f"{key} ({desc})", lambda i, dyn=dyn: rowrw(q, kp, dyn=dyn), 1,
                        kv_bytes, dev, repeats, "key bytes")
    return {"ms": ms, "spot": spots}


def main(device: str | torch.device = "cuda", *, part: str = PART, m: int = M, k: int = K,
         n: int = N, repeats: int = REPEATS, mxu8: bool = MXU8, ck: int = CK,
         rowrw_shape: tuple[int, int, int, int] = ROWRW, seed: int = 0) -> dict:
    """Print ``part``'s lines; return {"ms": {line: ms a call or launch, or
    None}, "spot": {check: error}}. Raises if a spot check is over its
    bound."""
    if part not in PARTS:
        raise ValueError(f"BM_PART {part!r}: one of {PARTS}")
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"M={m} K={k} N={n} part={part} CK={ck} MXU8={int(mxu8)} REPEATS={repeats} "
          f"device={dev.type}", flush=True)
    if part == "xread":
        return xread_part(dev, g, m, k, n, repeats, mxu8, ck)
    if part == "overhead":
        return overhead_part(dev, g, repeats)
    if part == "nibble":
        return nibble_part(dev, g, m, k, n, repeats, ck)
    return rowrw_part(dev, g, repeats, rowrw_shape)


if __name__ == "__main__":
    main()

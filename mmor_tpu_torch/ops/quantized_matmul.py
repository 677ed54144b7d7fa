"""Int8 weight matmul: K2 and the int8 weight format.

Counterpart of ``mmor_tpu/ops/quantized_matmul.py``. Weights are int8 with
per-output-channel f32 scales, packed 4 rows per int32 word along K
(``pack_int8_rows``) exactly as the JAX package stores them, so converted
checkpoints load as they are and the CUDA kernel reads the words as
tensor-core operands (``csrc/int8_matmul.cu``).
"""

from __future__ import annotations

import torch

from mmor_tpu_torch.ops import _build


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (int8 (K, N), scale (N,) f32), symmetric per-channel."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def pack_int8_rows(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (K/4, N) int32; byte b of word r = row 4r+b."""
    k, n = w_q.shape
    if k % 4:
        raise ValueError("pad K to a multiple of 4 before packing")
    w = w_q.reshape(k // 4, 4, n).to(torch.int32) & 0xFF
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


def unpack_int8_rows(w_p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int8_rows``: (K/4, N) int32 -> (K, N) int8."""
    kp, n = w_p.shape
    parts = [((w_p << (24 - 8 * b)) >> 24).to(torch.int8) for b in range(4)]
    return torch.stack(parts, dim=1).reshape(kp * 4, n)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations, as the TPU kernel's caller makes
    them (``mmor_tpu/ops/quantized_matmul.py:214-217``): row amax in f32,
    scale = amax / 127, its inverse cast to x.dtype, x * inv in x.dtype,
    rounded half to even and clipped to +-127.
    Returns (int8 (M, K), row scale (M,) f32)."""
    row_amax = x.abs().amax(dim=1, keepdim=True).float()
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can miss amax / 127 by one bit
    row_scale = torch.where(row_amax > 0, row_amax / torch.full_like(row_amax, 127.0),
                            torch.ones_like(row_amax))
    inv = (1.0 / row_scale).to(x.dtype)
    xq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return xq, row_scale[:, 0]


def int8_matmul_packed_plain(x: torch.Tensor, w_p: torch.Tensor,
                             scale: torch.Tensor, *,
                             int8_mxu: bool = True) -> torch.Tensor:
    """Plain PyTorch K2. ``int8_mxu``: int8 activations times int8 weights
    summed exactly (float64 holds every int32 sum), then
    acc * col_scale * row_scale in f32. Otherwise the JAX CPU path's
    f32 dequantization, x @ (w * scale)."""
    w8 = unpack_int8_rows(w_p)
    if not int8_mxu:
        w = w8.float() * scale[None, :].float()
        return (x.float() @ w).to(x.dtype)
    xq, rs = quantize_rows(x)
    acc = (xq.double() @ w8.double()).float()
    return (acc * scale[None, :].float() * rs[:, None]).to(x.dtype)


def int8_matmul_packed(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                       *, int8_mxu: bool = True) -> torch.Tensor:
    """K2: x (M, K) @ dequant(unpack(w_p (K/4, N) int32)) with per-channel
    ``scale`` (N,) f32 -> (M, N) in x.dtype.

    CPU: ``int8_matmul_packed_plain``. CUDA: the ``csrc/int8_matmul.cu``
    kernels — with ``int8_mxu`` a row-quantization kernel (``quantize_rows``'
    arithmetic) and W8A8 on the int8 tensor cores, else a W8A16 FMA kernel.
    Counts its launches in ``int8_matmul_packed.launches``."""
    m, k = x.shape
    kp, n = w_p.shape
    if kp * 4 != k:
        raise ValueError(f"int8_matmul_packed: x K={k} vs packed K/4={kp}")
    if x.device.type == "cpu":
        return int8_matmul_packed_plain(x, w_p, scale, int8_mxu=int8_mxu)
    if x.device.type != "cuda" or w_p.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul_packed: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul_packed: x dtype {x.dtype}")
    if w_p.dtype != torch.int32 or scale.dtype != torch.float32 or scale.shape != (n,):
        raise TypeError("int8_matmul_packed: w_p must be int32 (K/4, N), scale f32 (N,)")
    lib = _build.library()
    xc, w_p, scale = _build.aligned(x), _build.aligned(w_p), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    if int8_mxu:
        if k % 64:
            raise ValueError(f"int8_matmul_packed: W8A8 kernel needs K % 64 == 0, K={k}")
        # scratch for the activation quantization the kernel runs first
        xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
        rs = torch.empty(m, dtype=torch.float32, device=x.device)
        err = lib.mmor_int8_matmul_w8a8(
            _build.ptr(xc), _build.ptr(xq), _build.ptr(rs), _build.ptr(w_p),
            _build.ptr(scale), _build.ptr(out), m, k, n, is_bf16, _build.stream())
    else:
        err = lib.mmor_int8_matmul_w8a16(
            _build.ptr(xc), _build.ptr(w_p), _build.ptr(scale), _build.ptr(out), m, k, n,
            is_bf16, _build.stream())
    _build.check(err, "int8_matmul_packed")
    int8_matmul_packed.launches += 1
    return out


int8_matmul_packed.launches = 0

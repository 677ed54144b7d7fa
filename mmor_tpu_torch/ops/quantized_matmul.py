"""Int8- and int4-weight matmuls: K2 and K8 (int8 weights), K3 (int4).

Counterpart of ``mmor_tpu/ops/quantized_matmul.py``. The weight formats are
the JAX package's, so converted checkpoints load as they are and the CUDA
kernels read the words as tensor-core operands:

- int8: per-output-channel f32 scales, 4 rows per int32 word along K
  (``pack_int8_rows``); K2, ``csrc/int8_matmul.cu``;
- int8 unpacked: the same scales on a row-major (K, N) int8 weight; K8
  (``int8_matmul``), the same file, with its own activation rule;
- int4: values in [-7, 7] with per-(K-group, channel) f32 scales, 8 biased
  nibbles per int32 word (``pack_int4_rows``); K3, ``csrc/int4_matmul.cu``,
  W4A8 or W4A16.
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
    kernels (bf16 or f32 x; K a multiple of 64). With ``int8_mxu``, W8A8: a
    row-quantization kernel (``quantize_rows``' arithmetic), then the int8
    tensor cores (``mma.sync`` at up to 16 rows, ``wgmma`` fed by TMA
    above). Otherwise W8A16, the TPU branch's numerics: x in bf16 (f32 x
    rounded by a pre-pass), exact bf16 products summed in f32 on the
    tensor cores, the int8 weights converted in registers (``wgmma`` above
    16 rows, ``stream_matmul.cu``'s row-word ``mma.sync`` kernel at up to
    16). Counts its launches in ``int8_matmul_packed.launches`` (W8A8) and
    ``.a16_launches`` (W8A16)."""
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
    if k % 64:
        raise ValueError(f"int8_matmul_packed: the kernels need K % 64 == 0, K={k}")
    lib = _build.library()
    xc, w_p, scale = _build.aligned(x), _build.aligned(w_p), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    if int8_mxu:
        # scratch for the activation quantization the kernel runs first
        xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
        rs = torch.empty(m, dtype=torch.float32, device=x.device)
        err = lib.mmor_int8_matmul_w8a8(
            _build.ptr(xc), _build.ptr(xq), _build.ptr(rs), _build.ptr(w_p),
            _build.ptr(scale), _build.ptr(out), m, k, n, is_bf16, _build.stream())
    else:
        # scratch for the bf16 rounding of f32 x
        xs = None if is_bf16 else torch.empty(m, k, dtype=torch.bfloat16, device=x.device)
        err = lib.mmor_int8_matmul_w8a16(
            _build.ptr(xc), None if xs is None else _build.ptr(xs), _build.ptr(w_p),
            _build.ptr(scale), _build.ptr(out), m, k, n, is_bf16, _build.stream())
    _build.check(err, "int8_matmul_packed")
    if int8_mxu:
        int8_matmul_packed.launches += 1
    else:
        int8_matmul_packed.a16_launches += 1
    return out


int8_matmul_packed.launches = 0
int8_matmul_packed.a16_launches = 0


# ------------------------------------------------------------------ K8
def quantize_rows_div(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activations by K8's rule
    (``mmor_tpu/ops/quantized_matmul.py:81-84``), not K2's: x in f32, row
    amax, scale = amax / 127 (1 for a zero row), x / scale in f32, rounded
    half to even and clipped to +-127.
    Returns (int8 (M, K), row scale (M,) f32)."""
    xf = x.float()
    row_amax = xf.abs().amax(dim=1, keepdim=True)
    # tensor divisors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal
    row_scale = torch.where(row_amax > 0, row_amax / torch.full_like(row_amax, 127.0),
                            torch.ones_like(row_amax))
    xq = torch.clamp(torch.round(xf / row_scale), -127, 127).to(torch.int8)
    return xq, row_scale[:, 0]


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8, the TPU kernel's W8A8 numerics: ``quantize_rows_div``,
    the int8 product summed exactly (float64 holds every int32 sum), then
    acc * scale, times the row scale, in f32, cast to x.dtype
    (``quantized_matmul.py:54-56``, ``:118``)."""
    xq, rs = quantize_rows_div(x)
    acc = (xq.double() @ w_q.double()).float()
    return (acc * scale[None, :].float() * rs[:, None]).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K8: x (M, K) @ (w_q (K, N) int8 * scale (N,) f32) as W8A8 -> (M, N)
    in x.dtype.

    CPU: ``int8_matmul_plain``. CUDA: ``csrc/int8_matmul.cu`` (bf16 or f32
    x; K a multiple of 64): at M <= 16 a quantize kernel and, overlapping
    it, a product that streams 128-column strips of the weight by TMA;
    above, K2's quantize kernel with K8's activation rule and a tiled
    product. Counts its launches in ``int8_matmul.launches``."""
    m, k = x.shape
    kw, n = w_q.shape
    if kw != k or tuple(scale.shape) != (n,):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    if x.device.type != "cuda" or w_q.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul: x dtype {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul: w_q must be int8, scale f32")
    if k % 64:
        raise ValueError(f"int8_matmul: the kernel needs K % 64 == 0, K={k}")
    xc, w_q, scale = _build.aligned(x), _build.aligned(w_q), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    rs = torch.empty(m, dtype=torch.float32, device=x.device)
    err = _build.library().mmor_int8_matmul_bytes(
        _build.ptr(xc), _build.ptr(xq), _build.ptr(rs), _build.ptr(w_q), _build.ptr(scale),
        _build.ptr(out), m, k, n, int(x.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


# ------------------------------------------------------------------ int4
def quantize_weights_int4(w: torch.Tensor, group: int = 1024
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (int4 values in an int8 carrier (K, N), scales
    (K/group, N) f32): symmetric round-to-nearest per (K-group, output
    channel) on the [-7, 7] grid (``quantized_matmul.py:270-284``)."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of the group {group}")
    wf = w.float().reshape(k // group, group, n)
    amax = wf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
    return q.reshape(k, n).to(torch.int8), scale


def _pack_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 4, N) byte values 0..255 -> (..., N) int32, byte i at bits 8i."""
    b = b.to(torch.int64)
    word = b[..., 0, :] | (b[..., 1, :] << 8) | (b[..., 2, :] << 16) | (b[..., 3, :] << 24)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def pack_int4_rows(w_q: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """int4 values (K, N) -> (K/8, N) int32 of biased nibbles (q + 8).

    Within each K-``block`` (default: all of K), byte b of word r holds row
    4r+b of the block in its low nibble and row block/2 + 4r+b in its high
    nibble (``quantized_matmul.py:287-314``)."""
    k, n = w_q.shape
    block = k if block is None else block
    if k % block or block % 8:
        raise ValueError(f"K={k} must split into blocks of {block}, a multiple of 8")
    u = ((w_q.to(torch.int32) + 8) & 0xF).reshape(k // block, 2, block // 8, 4, n)
    return _pack_bytes(u[:, 0] | (u[:, 1] << 4)).reshape(k // 8, n)


def unpack_int4_rows(w_p: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """Inverse of ``pack_int4_rows``: (K/8, N) int32 -> int4 values (K, N) int8."""
    kp, n = w_p.shape
    block = kp * 8 if block is None else block
    wb = w_p.reshape(kp * 8 // block, 1, block // 8, 1, n)
    nib = torch.arange(2, device=w_p.device).reshape(1, 2, 1, 1, 1) * 4
    byte = torch.arange(4, device=w_p.device).reshape(1, 1, 1, 4, 1) * 8
    u = (wb >> (byte + nib)) & 0xF  # (K/block, half, word, byte, N)
    return (u - 8).to(torch.int8).reshape(kp * 8, n)


def int4_matmul_packed_plain(x: torch.Tensor, w_p: torch.Tensor,
                             scale: torch.Tensor, *, group: int = 1024,
                             int8_mxu: bool = True) -> torch.Tensor:
    """Plain PyTorch K3. ``int8_mxu``: the kernel's W4A8 numerics: per-row
    int8 activations (``quantize_rows``), each K-group's int32 dot summed
    exactly, folded in group order as acc += dot * scale[group] in f32, and
    acc * row_scale cast to x.dtype. Otherwise the JAX CPU path
    (``quantized_matmul.py:389-393``): f32 dequantization, then x @ w."""
    m, k = x.shape
    w4 = unpack_int4_rows(w_p, block=group)
    if not int8_mxu:
        w = (w4.float().reshape(k // group, group, -1) * scale[:, None, :].float())
        return (x.float() @ w.reshape(k, -1)).to(x.dtype)
    xq, rs = quantize_rows(x)
    acc = torch.zeros(m, w_p.shape[1], dtype=torch.float32, device=x.device)
    for kk in range(k // group):
        rows = slice(kk * group, (kk + 1) * group)
        dot = (xq[:, rows].double() @ w4[rows].double()).float()
        acc = acc + dot * scale[kk][None, :].float()
    return (acc * rs[:, None]).to(x.dtype)


def int4_matmul_packed(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                       *, group: int = 1024, int8_mxu: bool = True) -> torch.Tensor:
    """K3: x (M, K) @ dequant(unpack4(w_p (K/8, N) int32)) with per-(group,
    channel) ``scale`` (K/group, N) f32 -> (M, N) in x.dtype.

    CPU: ``int4_matmul_packed_plain``. CUDA: the ``csrc/int4_matmul.cu``
    kernels (bf16 or f32 x; K and group multiples of 256): with
    ``int8_mxu``, W4A8, K2's row quantization and then the int8 tensor cores
    (``mma.sync`` at up to 16 rows, ``wgmma`` fed by TMA above); otherwise
    W4A16, x in bf16 (f32 x rounded by a pre-pass) on the bf16 tensor cores
    with the nibbles converted in registers. Counts its launches in
    ``int4_matmul_packed.launches`` (W4A8) and ``.a16_launches`` (W4A16)."""
    m, k = x.shape
    kp, n = w_p.shape
    if kp * 8 != k or k % group or tuple(scale.shape) != (k // group, n):
        raise ValueError(f"int4_matmul_packed: x K={k}, packed K/8={kp}, group "
                         f"{group}, scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return int4_matmul_packed_plain(x, w_p, scale, group=group, int8_mxu=int8_mxu)
    if x.device.type != "cuda" or w_p.device != x.device or scale.device != x.device:
        raise ValueError("int4_matmul_packed: operands must share one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul_packed: x dtype {x.dtype}")
    if w_p.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError("int4_matmul_packed: w_p must be int32, scale f32")
    if group % 256:
        raise ValueError(f"int4_matmul_packed: the kernel needs group % 256 == 0, "
                         f"group={group}")
    lib = _build.library()
    xc, w_p, scale = _build.aligned(x), _build.aligned(w_p), _build.aligned(scale)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    # scratch: W4A8's quantized rows and row scales; W4A16's bf16 copy of f32 x
    xs = rs = None
    if int8_mxu:
        xs = torch.empty(m, k, dtype=torch.int8, device=x.device)
        rs = torch.empty(m, dtype=torch.float32, device=x.device)
    elif x.dtype == torch.float32:
        xs = torch.empty(m, k, dtype=torch.bfloat16, device=x.device)
    err = lib.mmor_int4_matmul(
        _build.ptr(xc), None if xs is None else _build.ptr(xs),
        None if rs is None else _build.ptr(rs), _build.ptr(w_p), _build.ptr(scale),
        _build.ptr(out), m, k, n, group, int(x.dtype == torch.bfloat16), int(int8_mxu),
        _build.stream())
    _build.check(err, "int4_matmul_packed")
    if int8_mxu:
        int4_matmul_packed.launches += 1
    else:
        int4_matmul_packed.a16_launches += 1
    return out


int4_matmul_packed.launches = 0
int4_matmul_packed.a16_launches = 0

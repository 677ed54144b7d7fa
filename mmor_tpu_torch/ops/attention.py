"""Attention ops: K1 flash attention, the plain reference, K4 decode
attention against an int8 KV cache stack and K7 against one layer's cache.

Counterpart of ``mmor_tpu/ops/attention.py``. Activations are
(batch, heads, seq, head_dim); segment ids are (batch, seq) int32 and
attention flows only between equal segments, which covers padding and
PTv3's patch windows.

Each kernel wrapper takes its plain PyTorch version for a tensor on the CPU
and launches its CUDA kernel (``csrc/``) for a tensor on a CUDA device; any
other device, dtype or shape the kernel does not take raises. A wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math

import torch

from mmor_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _require_cuda_inputs(name: str, tensors: dict, dtype: torch.dtype) -> None:
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not a CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain attention; the numerics oracle for K1 and its CPU path."""
    sq, head_dim = q.shape[-2:]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        ones = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=sk - sq)[None, None]
    if segment_ids is not None:
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg_mask = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """K1 flash attention (forward). q: (B, H, Sq, D); k/v: (B, H, Sk, D);
    ``segment_ids`` (B, Sq) int32 for the queries and, optionally, (B, Sk)
    for the keys. ``causal`` composes with segments; key j is visible to
    query i iff j <= i + Sk - Sq, as in ``mha_reference``.

    CPU: ``mha_reference``. CUDA: the ``csrc/flash_attention.cu`` kernel on
    bf16 inputs with head_dim 16, 32, 64 or 128. A query row whose every key
    is masked comes out 0 from the kernel (``mha_reference`` averages V
    there); no caller on the serving path produces such a row. The gradient
    comes with the training slice: the kernel path raises on inputs that
    require one.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids,
                             kv_segment_ids=kv_segment_ids, sm_scale=sm_scale)
    _require_cuda_inputs("flash_attention", {"q": q, "k": k, "v": v},
                         torch.bfloat16)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel yet (training slice)")
    batch, heads, sq, head_dim = q.shape
    sk = k.shape[-2]
    if k.shape != (batch, heads, sk, head_dim) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if head_dim not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: head_dim {head_dim} not in 16/32/64/128")
    q_seg = (segment_ids if segment_ids is not None
             else torch.zeros(batch, sq, dtype=torch.int32, device=q.device))
    if kv_segment_ids is not None:
        kv_seg = kv_segment_ids
    elif segment_ids is not None and sq == sk:
        kv_seg = q_seg
    else:
        kv_seg = torch.zeros(batch, sk, dtype=torch.int32, device=q.device)
    q_seg = _build.aligned(q_seg.to(torch.int32))
    kv_seg = _build.aligned(kv_seg.to(torch.int32))
    if q_seg.shape != (batch, sq) or kv_seg.shape != (batch, sk):
        raise ValueError("flash_attention: segment ids must be (B, Sq) / (B, Sk)")
    _require_cuda_inputs("flash_attention", {"segment_ids": q_seg,
                                             "kv_segment_ids": kv_seg}, torch.int32)
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    err = _build.library().mmor_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(q_seg), _build.ptr(kv_seg), _build.ptr(out),
        batch * heads, heads, sq, sk, head_dim, int(causal), float(sm_scale),
        _build.stream())
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_mask: torch.Tensor,
    *,
    sm_scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-position attention against a KV cache (plain PyTorch).

    q: (B, H, 1, D); caches: (B, H, T, D); kv_mask: (B, T) nonzero on valid
    slots. With ``k_scale``/``v_scale`` (B, H, T, 1) the caches are int8 and
    dequantize inside the contraction."""
    head_dim = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    kc = k_cache if k_scale is None else k_cache.to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale[..., 0][:, :, None, :].float()
    mask = kv_mask[:, None, None, :] != 0
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        weights = weights * v_scale[..., 0][:, :, None, :].float()
        vc = v_cache.to(q.dtype)
    else:
        vc = v_cache
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(vc.dtype), vc)


def pack_kv_heads(x_q: torch.Tensor) -> torch.Tensor:
    """int8 (..., T, D) -> the TPU cache's int32 words (..., D/4, T); word r
    packs head-dim indices 4r..4r+3, little-endian. The port's own cache is
    the int8 (..., T, D) layout; these two convert to and from the JAX one."""
    *lead, t, d = x_q.shape
    x = x_q.transpose(-1, -2).reshape(*lead, d // 4, 4, t).to(torch.int32) & 0xFF
    return (x[..., 0, :] | (x[..., 1, :] << 8)
            | (x[..., 2, :] << 16) | (x[..., 3, :] << 24))


def unpack_kv_heads(x_p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_kv_heads``: (..., D/4, T) int32 -> (..., T, D) int8."""
    *lead, d4, t = x_p.shape
    parts = [((x_p << (24 - 8 * b)) >> 24).to(torch.int8) for b in range(4)]
    return torch.stack(parts, dim=-2).reshape(*lead, d4 * 4, t).transpose(-1, -2)


def decode_attention_packed_stack_plain(q, k_stack, v_stack, ks_stack, vs_stack,
                                        kv_mask, layer_idx: int, *,
                                        sm_scale: float | None = None):
    """Plain PyTorch K4: ``decode_attention`` on layer ``layer_idx``."""
    return decode_attention(
        q, k_stack[layer_idx], v_stack[layer_idx], kv_mask, sm_scale=sm_scale,
        k_scale=ks_stack[layer_idx][..., None], v_scale=vs_stack[layer_idx][..., None])


def decode_attention_packed_stack(
    q: torch.Tensor,  # (B, H, 1, D)
    k_stack: torch.Tensor,  # (L, B, H, T, D) int8, the full layer stack
    v_stack: torch.Tensor,  # (L, B, H, T, D) int8
    ks_stack: torch.Tensor,  # (L, B, H, T) bf16 per-position scales
    vs_stack: torch.Tensor,  # (L, B, H, T) bf16
    kv_mask: torch.Tensor,  # (B, T)
    layer_idx: int,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """K4: decode attention reading layer ``layer_idx`` of the int8 cache
    stack in place. Returns (B, H, 1, D) in q.dtype.

    The cache layout is the port's own (see ``csrc/decode_attention.cu``):
    int8 rows of D channels, not the TPU's (D/4, T) int32 words.
    CPU: ``decode_attention_packed_stack_plain``. CUDA: the kernel, on bf16 q."""
    b, h, _, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_packed_stack_plain(
            q, k_stack, v_stack, ks_stack, vs_stack, kv_mask, layer_idx,
            sm_scale=scale)
    _require_cuda_inputs("decode_attention_packed_stack", {"q": q},
                         torch.bfloat16)
    _require_cuda_inputs("decode_attention_packed_stack",
                         {"k_stack": k_stack, "v_stack": v_stack}, torch.int8)
    _require_cuda_inputs("decode_attention_packed_stack",
                         {"ks_stack": ks_stack, "vs_stack": vs_stack},
                         torch.bfloat16)
    n_layers, _, _, t_cap, _ = k_stack.shape
    if (k_stack.shape != (n_layers, b, h, t_cap, d) or v_stack.shape != k_stack.shape
            or ks_stack.shape != (n_layers, b, h, t_cap)
            or vs_stack.shape != ks_stack.shape or q.shape[2] != 1):
        raise ValueError("decode_attention_packed_stack: inconsistent shapes")
    if not 0 <= layer_idx < n_layers:
        raise IndexError(f"layer_idx {layer_idx} outside [0, {n_layers})")
    if d % 16 or d > 256:
        raise ValueError(f"decode_attention_packed_stack: head_dim {d}")
    mask = _build.aligned(kv_mask.to(torch.int32))
    if mask.shape != (b, t_cap):
        raise ValueError("decode_attention_packed_stack: kv_mask must be (B, T)")
    _require_cuda_inputs("decode_attention_packed_stack", {"kv_mask": mask}, torch.int32)
    qc = _build.aligned(q)
    out = torch.empty_like(qc)
    err = _build.library().mmor_decode_attention(
        _build.ptr(qc), _build.ptr(k_stack), _build.ptr(v_stack), _build.ptr(ks_stack), _build.ptr(vs_stack),
        _build.ptr(mask), _build.ptr(out), int(layer_idx), b, h, t_cap, d, float(scale),
        _build.stream())
    _build.check(err, "decode_attention_packed_stack")
    decode_attention_packed_stack.launches += 1
    return out


decode_attention_packed_stack.launches = 0


def decode_attention_packed_plain(q, k, v, k_scale, v_scale, kv_mask, *,
                                  sm_scale: float | None = None):
    """Plain PyTorch K7, the TPU kernel's arithmetic
    (``mmor_tpu/ops/attention.py:376-393``): q rounded to bf16, logits
    q . k in f32 times sm_scale times the key scale, masked slots
    ``DEFAULT_MASK_VALUE``, softmax in f32, the weights times the value
    scale, out = sum_t w v in f32, cast to q.dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhtd->bhqt", q.to(torch.bfloat16).float(), k.float())
    logits = logits * scale * k_scale[:, :, None, :].float()
    logits = torch.where(kv_mask[:, None, None, :] != 0, logits, DEFAULT_MASK_VALUE)
    weights = torch.softmax(logits, dim=-1) * v_scale[:, :, None, :].float()
    return torch.einsum("bhqt,bhtd->bhqd", weights, v.float()).to(q.dtype)


def decode_attention_packed(
    q: torch.Tensor,  # (B, H, 1, D)
    k: torch.Tensor,  # (B, H, T, D) int8, one layer's cache
    v: torch.Tensor,  # (B, H, T, D) int8
    k_scale: torch.Tensor,  # (B, H, T) f32 or bf16 per-position scales
    v_scale: torch.Tensor,  # (B, H, T), the same dtype
    kv_mask: torch.Tensor,  # (B, T) nonzero on valid slots
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """K7: one query position against one layer's int8 cache. Returns
    (B, H, 1, D) in q.dtype.

    The cache is the port's (B, H, T, D) int8 layout (``unpack_kv_heads``
    converts the TPU's words). The scales stay in their dtype, f32 or bf16.
    CPU: ``decode_attention_packed_plain``. CUDA: K4's kernel on a one-layer
    cache (``csrc/decode_attention.cu``), q taken in bf16 as on the TPU,
    bf16 or f32 q."""
    b, h, _, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_packed_plain(q, k, v, k_scale, v_scale, kv_mask,
                                             sm_scale=scale)
    name = "decode_attention_packed"
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q dtype {q.dtype}")
    _require_cuda_inputs(name, {"q": q}, q.dtype)
    _require_cuda_inputs(name, {"k": k, "v": v}, torch.int8)
    if k_scale.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: scales must be f32 or bf16, got {k_scale.dtype}")
    _require_cuda_inputs(name, {"k_scale": k_scale, "v_scale": v_scale}, k_scale.dtype)
    t_cap = k.shape[2]
    if (k.shape != (b, h, t_cap, d) or v.shape != k.shape
            or k_scale.shape != (b, h, t_cap) or v_scale.shape != k_scale.shape
            or q.shape[2] != 1):
        raise ValueError(f"{name}: inconsistent shapes")
    if d % 16 or d > 256:
        raise ValueError(f"{name}: head_dim {d}")
    mask = _build.aligned(kv_mask.to(torch.int32))
    if mask.shape != (b, t_cap):
        raise ValueError(f"{name}: kv_mask must be (B, T)")
    _require_cuda_inputs(name, {"kv_mask": mask}, torch.int32)
    qc = _build.aligned(q.to(torch.bfloat16))
    k, v = _build.aligned(k), _build.aligned(v)
    k_scale, v_scale = _build.aligned(k_scale), _build.aligned(v_scale)
    out = torch.empty(b, h, 1, d, dtype=q.dtype, device=q.device)
    err = _build.library().mmor_decode_attention_layer(
        _build.ptr(qc), _build.ptr(k), _build.ptr(v), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(mask), _build.ptr(out), b, h, t_cap, d,
        float(scale), int(k_scale.dtype == torch.float32), int(q.dtype == torch.float32),
        _build.stream())
    _build.check(err, name)
    decode_attention_packed.launches += 1
    return out


decode_attention_packed.launches = 0

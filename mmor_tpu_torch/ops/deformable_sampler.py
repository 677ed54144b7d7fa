"""K6: the multi-scale deformable attention sampler.

Counterpart of ``mmor_tpu/ops/deformable_sampler.py::ms_deform_attn_pallas``.
The TPU kernel tiles the queries, contracts one-hot matrices over value
windows on the matrix unit and sends the samples that fall outside their
window through a gather residual; on the card the kernel is a direct gather
(``csrc/ms_deform_attn.cu``) that computes every sample exactly and needs no
residual: a lane a (query, head, 16-byte chunk of channels), the points'
coefficients computed once a (head, point) and shared across the head's
lanes, a level's corner loads issued together. Its templated form takes the
serving counts (3 levels, 4 points); a generic form takes every other shape,
in the same per-channel order, so both give the same bits
(``tests/test_torch_deform_sampler.py::k6_order_model``).

The wrapper takes the plain version (``ops/deformable_attention.py``) for
tensors on the CPU and launches the CUDA kernel for tensors on a CUDA
device; any other device, dtype or shape the kernel does not take raises.
It counts its launches in ``ms_deform_attn_sampler.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

MAX_LEVELS = 8  # kMaxLevels in csrc/ms_deform_attn.cu
_FLOATS = (torch.bfloat16, torch.float32)


def ms_deform_attn_sampler(
    value: torch.Tensor,  # (N, S, M, D) bf16 or f32
    spatial_shapes: tuple[tuple[int, int], ...],
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) f32
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P) in the value's dtype
    *,
    generic: bool = False,
) -> torch.Tensor:
    """K6: ``ms_deform_attn`` -> (N, Lq, M*D) in the value's dtype.

    CPU: the plain version. CUDA: one launch for all N frames; ``generic``
    takes the kernel's generic form where its templated one applies (for
    tests and timing: the two give the same bits). The kernel
    reads contiguous operands: a non-contiguous input is made contiguous
    here (a copy), as the model's own reshapes already give contiguous ones.
    The gradient comes with the training slice: the kernel path raises on
    inputs that require one."""
    if value.device.type == "cpu":
        return ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)
    n, s_len, m, d = value.shape
    _, lq, _, levels, points, _ = sampling_locations.shape
    for key, t in (("value", value), ("sampling_locations", sampling_locations),
                   ("attention_weights", attention_weights)):
        if t.device != value.device or t.device.type != "cuda":
            raise ValueError(f"ms_deform_attn_sampler: {key} is on {t.device}, "
                             "not the value's CUDA device")
    if value.dtype not in _FLOATS or attention_weights.dtype != value.dtype:
        raise TypeError("ms_deform_attn_sampler: value and attention_weights must be "
                        f"both bf16 or both f32, got {value.dtype} / {attention_weights.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("ms_deform_attn_sampler: sampling_locations must be f32, "
                        f"got {sampling_locations.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            value, sampling_locations, attention_weights)):
        raise NotImplementedError(
            "ms_deform_attn_sampler has no backward kernel yet (training slice)")
    if (sampling_locations.shape != (n, lq, m, levels, points, 2)
            or attention_weights.shape != (n, lq, m, levels, points)):
        raise ValueError("ms_deform_attn_sampler: shapes "
                         f"{value.shape} {sampling_locations.shape} {attention_weights.shape}")
    if not 1 <= levels <= MAX_LEVELS or levels != len(spatial_shapes):
        raise ValueError(f"ms_deform_attn_sampler: {levels} levels for "
                         f"{len(spatial_shapes)} shapes (at most {MAX_LEVELS})")
    if s_len != sum(h * w for h, w in spatial_shapes):
        raise ValueError("ms_deform_attn_sampler: flattened size mismatch")
    value = _build.aligned(value)
    loc = _build.aligned(sampling_locations)
    attn = _build.aligned(attention_weights)
    out = torch.empty(n, lq, m * d, dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * levels))(*[x for hw in spatial_shapes for x in hw])
    err = _build.library().mmor_ms_deform_attn(
        _build.ptr(value), _build.ptr(loc), _build.ptr(attn), _build.ptr(out),
        ctypes.cast(shapes, ctypes.c_void_p), levels, points, n, s_len, lq, m, d,
        int(value.dtype == torch.bfloat16), int(generic), _build.stream())
    _build.check(err, "ms_deform_attn_sampler")
    ms_deform_attn_sampler.launches += 1
    return out


ms_deform_attn_sampler.launches = 0

"""Multi-scale deformable attention sampling: the plain PyTorch version.

Counterpart of ``mmor_tpu/ops/deformable_attention.py::ms_deform_attn`` (its
windowed gather core, ``_sample_level``): bilinear sampling with zero
padding and ``align_corners=False`` over each feature level, weighted by the
per-point attention weights and summed over levels and points. It is the
plain version of K6 (``ops/deformable_sampler.py``) and that wrapper's CPU
path. The JAX package's ``ms_deform_attn_tiled`` is an XLA variant of the
same function, not a kernel, and has no counterpart here.

Semantics kept from the JAX gather core: each sample's 2x2 window starts at
``floor`` of its pixel coordinate clamped to [0, size - 2], and every corner
of the window gets the hat weight ``max(0, 1 - |coord - corner|)`` at its
actual coordinate, so a corner farther than one pixel from the sample (off
the map) weighs 0, which is zero padding; a 1-pixel level has a 1-wide
window. Products and sums are f32; the output takes the value's dtype.
"""

from __future__ import annotations

import torch


def level_corners(coord: torch.Tensor, size: int):
    """The window along one axis: [(corner index, hat weight), ...] for the
    1 or 2 corners of a level of ``size`` pixels. ``coord`` is the sampling
    location in [0, 1] units (f32)."""
    t = coord * size - 0.5
    start = torch.floor(t).clamp(0, max(size - 2, 0))
    corners = []
    for k in range(min(2, size)):
        c = start + k
        corners.append((c.long(), torch.clamp(1.0 - torch.abs(t - c), min=0.0)))
    return corners


def ms_deform_attn(
    value: torch.Tensor,  # (N, S, M, D) flattened multi-level features
    spatial_shapes: tuple[tuple[int, int], ...],  # ((H1, W1), ...)
    sampling_locations: torch.Tensor,  # (N, Lq, M, L, P, 2) in [0, 1], (x, y)
    attention_weights: torch.Tensor,  # (N, Lq, M, L, P)
) -> torch.Tensor:
    """Deformable attention core -> (N, Lq, M*D) in the value's dtype."""
    n, s, m, d = value.shape
    _, lq, _, levels, points, _ = sampling_locations.shape
    if levels != len(spatial_shapes):
        raise ValueError("level count mismatch")
    if s != sum(h * w for h, w in spatial_shapes):
        raise ValueError("flattened size mismatch")

    value_md = value.permute(0, 2, 1, 3)  # (N, M, S, D)
    # (N, M, Lq, L, P) per coordinate, f32
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)
    attn = attention_weights.float().permute(0, 2, 1, 3, 4)
    out = torch.zeros(n, m, lq, d, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = value_md[:, :, start:start + h * w]  # (N, M, H*W, D)
        start += h * w
        a = attn[:, :, :, lvl]  # (N, M, Lq, P)
        for yi, wy in level_corners(loc[:, :, :, lvl, :, 1], h):
            for xi, wx in level_corners(loc[:, :, :, lvl, :, 0], w):
                idx = (yi * w + xi).reshape(n, m, lq * points, 1).expand(-1, -1, -1, d)
                corner = torch.gather(value_l, 2, idx).float()
                weight = a * wy * wx  # the same product order as the kernel
                out += (corner.view(n, m, lq, points, d) * weight[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(n, lq, m * d).to(value.dtype)

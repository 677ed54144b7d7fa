"""Shared layers of the panoptic stack: sine positions, MLP, deformable attention.

Counterpart of ``mmor_tpu/models/layers.py``. Geometry and init follow the
reference modules (``PositionEmbeddingSine``; ``MSDeformAttn`` projections
and its directional offset-bias init, ``ms_deform_attn.py:34-80``).

The JAX module picks its sampling core with a ``sampler`` switch ("gather",
"pallas", "tiled"): three TPU implementations of one function. The port has
one, K6 (``ops/deformable_sampler.py``), which takes its plain version for
CPU tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.models.common import Dense
from mmor_tpu_torch.ops import deformable_sampler


@functools.lru_cache(maxsize=64)
def _sine_cached(h: int, w: int, dim: int, temperature: float, normalize: bool,
                 device: str) -> torch.Tensor:
    f32 = torch.float32
    half = dim // 2
    y = torch.arange(1, h + 1, dtype=f32)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=f32)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        scale = 2 * math.pi
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = temperature ** (2 * (torch.arange(half, dtype=f32) // 2) / half)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])], dim=-1)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])], dim=-1)
    pos = torch.cat([pos_y.reshape(h, w, -1), pos_x.reshape(h, w, -1)], dim=-1)
    return pos.reshape(h * w, dim).to(device)


def sine_position_embedding_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                               normalize: bool = True, device=None) -> torch.Tensor:
    """DETR sine position embedding -> (h*w, dim) f32 (cached per shape and
    device; treat it as read-only)."""
    return _sine_cached(h, w, dim, temperature, normalize, str(torch.device(device or "cpu")))


class MLP(nn.Module):
    """DETR-style MLP head: ``n_layers`` Dense (``fc0``..) with relu between."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, n_layers: int = 3, *,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"fc{i}", Dense(in_dim if i == 0 else hidden_dim,
                                          out_dim if i == n_layers - 1 else hidden_dim,
                                          dtype=dtype, param_dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.n_layers - 1}")(x)


def offset_bias_grid(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Directional grid init of the sampling-offset bias
    (``ms_deform_attn.py:66-74``): head h points along angle 2*pi*h/H, point
    p at (p + 1) pixels of the level."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return torch.from_numpy(grid.reshape(-1).copy())


class DeformableAttention(nn.Module):
    """Multi-scale deformable attention over flattened level features."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, *, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.value_proj = Dense(d_model, d_model, **kw)
        self.sampling_offsets = Dense(d_model, n_heads * n_levels * n_points * 2, **kw)
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points, **kw)
        self.output_proj = Dense(d_model, d_model, **kw)

    @torch.no_grad()
    def reset_offsets(self) -> None:
        """The reference's offset-bias init: the directional grid."""
        self.sampling_offsets.bias.copy_(
            offset_bias_grid(self.n_heads, self.n_levels, self.n_points))

    def forward(
        self,
        query: torch.Tensor,  # (N, Lq, C), position embeddings already added
        reference_points: torch.Tensor,  # (N, Lq, n_levels, 2) in [0, 1]
        value_flatten: torch.Tensor,  # (N, S, C)
        spatial_shapes: tuple[tuple[int, int], ...],
    ) -> torch.Tensor:
        n, lq, _ = query.shape
        heads, levels, points = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_flatten).reshape(n, -1, heads, self.d_model // heads)
        offsets = self.sampling_offsets(query).reshape(n, lq, heads, levels, points, 2)
        weights = self.attention_weights(query).reshape(n, lq, heads, levels * points)
        weights = torch.softmax(weights, dim=-1).reshape(n, lq, heads, levels, points)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device)  # (L, 2) in (x, y) order
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        out = deformable_sampler.ms_deform_attn_sampler(value, spatial_shapes, locations,
                                                        weights)
        return self.output_proj(out)

"""Layers shared by the port's models, with flax's dtype semantics.

A flax module keeps its parameters in ``param_dtype`` and computes in
``dtype``: inputs and parameters are cast to ``dtype`` before the product.
Normalisations take their statistics in f32. Parameter names follow the
flax ones (``weight`` is the transposed flax ``kernel``), so
``utils/convert_jax.py`` maps a JAX tree onto these modules key by key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``flax.linen.Dense``: y = x @ W^T + b computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: f32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


def init_params(module: nn.Module, generator: torch.Generator,
                std: float = 0.02) -> None:
    """Seeded random init in place: norm scales 1, biases 0, every other
    floating parameter N(0, std); integer buffers (packed weights) stay."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                noise = torch.randn(p.shape, generator=generator,
                                    device=generator.device, dtype=torch.float32)
                p.copy_(noise.mul_(std))


class Conv2d(nn.Module):
    """``flax.linen.Conv`` on NCHW tensors: ``weight`` (O, I, kh, kw) is the
    flax HWIO ``kernel`` transposed; computed in ``dtype``. ``padding`` is the
    symmetric padding of each spatial side (flax "SAME" at stride 1 is
    k // 2; the JAX package spells out the other cases)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel,
                                               dtype=param_dtype))
        self.bias = (nn.Parameter(torch.empty(out_channels, dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        stride=self.stride, padding=self.padding)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` on NCHW tensors: f32 statistics over each
    group's channels and pixels, output in ``dtype``."""

    def __init__(self, groups: int, channels: int, eps: float, *,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.scale = nn.Parameter(torch.empty(channels, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.scale.float(), self.bias.float(),
                         self.eps)
        return y.to(self.dtype)

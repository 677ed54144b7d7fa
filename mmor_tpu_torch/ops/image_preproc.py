"""On-device image preprocessing for the MM2SG serving path.

Counterpart of ``mmor_tpu/ops/image_preproc.py::preprocess_views``: raw
uint8 frames are padded to a square canvas with the CLIP-mean background
(kept uint8), resized to the CLIP input size in bf16, and normalized.

The JAX resize is ``jax.image.resize(method="cubic")``: Keys cubic with
a = -0.5, antialiased when it shrinks (the kernel widens by the scale
factor), with each output pixel's weights normalised to sum to 1. PyTorch's
``F.interpolate(mode="bicubic")`` uses a = -0.75 and no antialias, so the
separable (in, out) weight matrices are built here exactly as
``jax._src.image.scale.compute_weight_mat`` builds them, in f32, cast to
bf16, and applied as two matrix products (height, then width) in bf16.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of an antialiased Keys-cubic resize
    with half-pixel centres (``compute_weight_mat`` with translation 0)."""
    f32 = torch.float32
    # Python floats, like JAX's: each meets the f32 arrays as an f32 scalar
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def preprocess_views(frames: torch.Tensor, image_size: int = 336) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., S, S, 3) f32 CLIP-normalized pixels:
    pad to a square (CLIP-mean background), bicubic resize, normalize."""
    *lead, h, w, c = frames.shape
    x = frames.reshape(-1, h, w, c)
    side = max(h, w)
    if h != w:
        pad_y, pad_x = (side - h) // 2, (side - w) // 2
        bg = torch.round(torch.tensor(CLIP_MEAN) * 255.0).to(torch.uint8)
        canvas = bg.to(x.device).expand(x.shape[0], side, side, c).clone()
        canvas[:, pad_y:pad_y + h, pad_x:pad_x + w] = x
        x = canvas
    x = x.to(torch.bfloat16) / 255.0
    if side != image_size:
        wm = resize_weights(side, image_size, x.device).to(torch.bfloat16)
        # height: (N, W, C, H) @ (H, S) -> (N, W, C, S); width likewise
        x = torch.matmul(x.permute(0, 2, 3, 1), wm)  # (N, W, C, S_h)
        x = torch.matmul(x.permute(0, 3, 2, 1), wm)  # (N, S_h, C, S_w)
        x = x.permute(0, 1, 3, 2)  # (N, S_h, S_w, C)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    x = (x.float() - mean) / std
    return x.reshape(*lead, image_size, image_size, c)

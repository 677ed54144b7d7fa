"""PointTransformerV3 (cls_mode) point-cloud encoder, batched.

Counterpart of ``mmor_tpu/models/ptv3.py``. Clouds are padded to a static
capacity with a validity mask; points are serialized along the four
space-filling curves; patch attention is K1 with segment ids (points sorted
along the curve, windowed into ``patch_size`` chunks, invalid points in
segment -1); the xCPE stand-in is a depthwise k=3 convolution along the
curve; serialized pooling merges points that share a coarsened code with
``scatter_reduce`` (max for features, min for grid coords, sum for counts).
The JAX module encodes one cloud and is vmapped; here the batch dimension
is explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.config import PTv3Config
from mmor_tpu_torch.models.common import Dense, LayerNorm
from mmor_tpu_torch.ops import attention as attn_ops
from mmor_tpu_torch.ops.serialization import ORDERS, encode

_INVALID_CODE = 2 ** 30


def voxelize(points: torch.Tensor, valid: torch.Tensor, grid_size: float):
    """(B, N, 6) xyzrgb, (B, N) bool -> ((B, N, 3) int32 grid coords in
    [0, 1023], valid); coordinates shift to the valid points' minimum."""
    xyz = points[..., :3].float()
    mins = torch.where(valid[..., None], xyz, torch.full_like(xyz, 1e9)).amin(
        dim=1, keepdim=True)
    grid = torch.floor((xyz - mins) / grid_size)
    return torch.clamp(grid, 0, 1023).to(torch.int32), valid


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along dim 1 by idx (B, M)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, *x.shape[2:]))


def _segment_reduce(src: torch.Tensor, seg: torch.Tensor, n_seg: int,
                    reduce: str, init) -> torch.Tensor:
    """Per-batch segment reduction: src (B, N, C), seg (B, N) in [0, n_seg)
    -> (B, n_seg, C); empty segments keep ``init``."""
    out = torch.full((src.shape[0], n_seg, src.shape[2]), init, dtype=src.dtype,
                     device=src.device)
    idx = seg[..., None].expand(-1, -1, src.shape[2]).long()
    return out.scatter_reduce_(1, idx, src, reduce=reduce, include_self=True)


def _pool_serialized(code, feat, grid, valid, capacity: int, depth_shift: int = 3):
    """SerializedPooling: merge points sharing a coarsened code into
    ``capacity`` rows. Features reduce by max, grid coords by min (then
    coarsen 2x), codes are recomputed from the pooled grid."""
    coarse = torch.where(valid, code >> depth_shift,
                         torch.full_like(code, _INVALID_CODE))
    order = torch.argsort(coarse, dim=1, stable=True)
    coarse_s = torch.gather(coarse, 1, order)
    feat_s = _gather_rows(feat, order)
    grid_s = _gather_rows(grid, order)
    valid_s = torch.gather(valid, 1, order)

    first = torch.ones_like(coarse_s[:, :1], dtype=torch.bool)
    boundary = torch.cat([first, coarse_s[:, 1:] != coarse_s[:, :-1]], dim=1)
    seg_ids = torch.cumsum(boundary.to(torch.int32), dim=1) - 1
    # invalid points and segments past the capacity land in the dropped row
    seg_ids = torch.where(valid_s, torch.clamp(seg_ids, max=capacity),
                          torch.full_like(seg_ids, capacity))
    neg_inf = float("-inf")
    pooled_feat = _segment_reduce(
        torch.where(valid_s[..., None], feat_s, torch.full_like(feat_s, neg_inf)),
        seg_ids, capacity + 1, "amax", neg_inf)[:, :capacity]
    big = torch.iinfo(torch.int32).max
    pooled_grid = _segment_reduce(
        torch.where(valid_s[..., None], grid_s, torch.full_like(grid_s, _INVALID_CODE)),
        seg_ids, capacity + 1, "amin", big)[:, :capacity] >> 1
    counts = _segment_reduce(valid_s.to(torch.int32)[..., None], seg_ids,
                             capacity + 1, "sum", 0)[:, :capacity, 0]
    new_valid = counts > 0
    pooled_feat = torch.where(new_valid[..., None], pooled_feat,
                              torch.zeros_like(pooled_feat))
    pooled_grid = torch.where(new_valid[..., None], pooled_grid,
                              torch.zeros_like(pooled_grid))
    return encode(pooled_grid, "z"), pooled_feat, pooled_grid, new_valid


class PTv3Block(nn.Module):
    """Pre-norm serialized-attention block + MLP, with a depthwise
    neighbourhood mix along the curve standing in for xCPE."""

    def __init__(self, dim: int, n_heads: int, patch_size: int, dtype, param_dtype):
        super().__init__()
        self.n_heads = n_heads
        self.patch_size = patch_size
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.cpe = nn.Conv1d(dim, dim, 3, padding=1, groups=dim, dtype=param_dtype)
        self.attn_norm = LayerNorm(dim, 1e-6, **kw)
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.proj = Dense(dim, dim, **kw)
        self.mlp_norm = LayerNorm(dim, 1e-6, **kw)
        self.fc1 = Dense(dim, 4 * dim, **kw)
        self.fc2 = Dense(4 * dim, dim, **kw)

    def forward(self, feat, perm, inv_perm, valid):
        """feat (B, P, C); perm / inv_perm (B, P) serialization permutation."""
        b, p, c = feat.shape
        sorted_feat = _gather_rows(feat, perm)
        sorted_valid = torch.gather(valid, 1, perm)
        mixed = F.conv1d(sorted_feat.to(self.dtype).transpose(1, 2),
                         self.cpe.weight.to(self.dtype), self.cpe.bias.to(self.dtype),
                         padding=1, groups=c).transpose(1, 2)
        sorted_feat = sorted_feat + torch.where(sorted_valid[..., None], mixed,
                                                torch.zeros_like(mixed))
        qkv = self.qkv(self.attn_norm(sorted_feat)).reshape(
            b, p, 3, self.n_heads, c // self.n_heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        patch_ids = torch.arange(p, dtype=torch.int32, device=feat.device) // self.patch_size
        segments = torch.where(sorted_valid, patch_ids[None],
                               torch.full_like(sorted_valid, -1, dtype=torch.int32))
        attn = attn_ops.flash_attention(q, k, v, segment_ids=segments)
        sorted_feat = sorted_feat + self.proj(attn.transpose(1, 2).reshape(b, p, c))
        h = self.fc2(F.gelu(self.fc1(self.mlp_norm(sorted_feat))))
        return _gather_rows(sorted_feat + h, inv_perm)


class PointTransformerV3(nn.Module):
    """Encoder-only (cls_mode) PTv3: (B, P, 6) clouds -> (B, out_dim)."""

    def __init__(self, cfg: PTv3Config):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.stem = Dense(cfg.in_channels, cfg.enc_channels[0], **kw)
        self.stem_norm = LayerNorm(cfg.enc_channels[0], 1e-6, **kw)
        self.down = nn.ModuleDict()
        self.blocks = nn.ModuleDict()
        for stage, (ch, depth, heads) in enumerate(
                zip(cfg.enc_channels, cfg.enc_depths, cfg.enc_heads)):
            if stage > 0:
                self.down[f"down_{stage}"] = Dense(cfg.enc_channels[stage - 1], ch, **kw)
            for d in range(depth):
                self.blocks[f"stage{stage}_block{d}"] = PTv3Block(
                    ch, heads, cfg.patch_size, cfg.dtype, cfg.param_dtype)
        self.head = Dense(cfg.enc_channels[-1], cfg.out_dim, **kw)

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        valid = valid.bool()
        grid, valid = voxelize(points, valid, cfg.grid_size)
        feat = self.stem_norm(self.stem(points.to(cfg.dtype)))
        zero = lambda f, v: torch.where(v[..., None], f, torch.zeros_like(f))
        feat = zero(feat, valid)
        capacity = points.shape[1]
        code = encode(grid, "z")
        block_idx = 0
        for stage, depth in enumerate(cfg.enc_depths):
            if stage > 0:
                capacity = max(capacity // 2, cfg.patch_size)
                code, feat, grid, valid = _pool_serialized(code, feat, grid, valid,
                                                           capacity)
                feat = zero(self.down[f"down_{stage}"](feat), valid)
            for d in range(depth):
                blk_code = encode(grid, ORDERS[block_idx % len(ORDERS)])
                key = torch.where(valid, blk_code, torch.full_like(blk_code, _INVALID_CODE))
                perm = torch.argsort(key, dim=1, stable=True)
                inv_perm = torch.argsort(perm, dim=1, stable=True)
                feat = self.blocks[f"stage{stage}_block{d}"](feat, perm, inv_perm, valid)
                feat = zero(feat, valid)
                block_idx += 1
        denom = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        pooled = zero(feat, valid).sum(dim=1) / denom
        return self.head(pooled)

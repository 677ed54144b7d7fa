"""Referring tracker: ID-preserving query propagation across frames.

Counterpart of ``mmor_tpu/models/tracker.py`` (the reference's
``ReferringTracker_noiser``, `dvis_Plus/tracker.py:96-381`), for inference:

- per frame, the current queries are aligned to the previous frame's by
  cosine Hungarian matching (``match_embeddings``);
- L layers of [referring cross-attention (query = projected reference,
  value = current frame queries, residual = identity path) -> self-attention
  -> FFN];
- class head on concat(reference, output); masks from a 3-layer MLP dotted
  with the 1x1-projected mask features;
- ``state`` carries (last_output, last_frame_embeds) across windows, so
  window inference is a fold over windows.

The training-time query-order noise (rs / wa / cc) and its ``noise_mode``
setting wait for the training slice: at inference the current queries are
taken in the matched order unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from mmor_tpu_torch.models.common import Dense, LayerNorm
from mmor_tpu_torch.models.layers import MLP
from mmor_tpu_torch.models.mask2former_decoder import EPS, AttentionBlock, FFNBlock
from mmor_tpu_torch.ops.matching import hungarian_match

TrackerState = dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrackerConfig:
    hidden_dim: int = 256
    ffn_dim: int = 2048
    n_heads: int = 8
    n_layers: int = 6
    mask_dim: int = 256
    num_classes: int = 124
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw):
        base = dict(hidden_dim=32, ffn_dim=64, n_heads=4, n_layers=2, mask_dim=32,
                    num_classes=10)
        base.update(kw)
        return cls(**base)


def match_embeddings(ref: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Cosine Hungarian alignment. ref/cur: (B, Q, C) -> (B, Q) index into
    cur for every ref slot."""
    refn = ref / (torch.linalg.vector_norm(ref, dim=-1, keepdim=True) + 1e-6)
    curn = cur / (torch.linalg.vector_norm(cur, dim=-1, keepdim=True) + 1e-6)
    cost = 1.0 - torch.einsum("bqc,brc->bqr", curn, refn)  # (B, cur, ref)
    cost = torch.nan_to_num(cost, nan=0.0)
    valid = torch.ones(ref.shape[:2], dtype=torch.bool, device=ref.device)
    return hungarian_match(cost, valid)


def take_rows(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x (B, Q, C), indices (B, Q) -> x[b, indices[b, r]] for every r."""
    return torch.gather(x, 1, indices.long()[..., None].expand(-1, -1, x.shape[-1]))


class ReferringTracker(nn.Module):
    def __init__(self, cfg: TrackerConfig):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        c = cfg.hidden_dim
        for i in range(cfg.n_layers):
            setattr(self, f"cross_attn_{i}", AttentionBlock(c, cfg.n_heads, **kw))
            setattr(self, f"self_attn_{i}", AttentionBlock(c, cfg.n_heads, **kw))
            setattr(self, f"ffn_{i}", FFNBlock(c, cfg.ffn_dim, **kw))
        self.ref_proj = MLP(c, c, c, 3, **kw)
        self.decoder_norm = LayerNorm(c, EPS, **kw)
        self.class_embed = Dense(2 * c, cfg.num_classes + 1, **kw)
        self.mask_embed = MLP(c, c, cfg.mask_dim, 3, **kw)
        self.mask_feature_proj = Dense(cfg.mask_dim, cfg.mask_dim, **kw)

    def _layers(self, x, reference, memory, per_layer_reference: bool):
        """One frame's L-layer stack; returns the last layer's output."""
        for j in range(self.cfg.n_layers):
            ref = self.ref_proj(x) if (per_layer_reference and j > 0) else reference
            x = getattr(self, f"cross_attn_{j}")(x, ref, memory, memory)
            x = getattr(self, f"self_attn_{j}")(x, x, x, x)
            x = getattr(self, f"ffn_{j}")(x)
        return x

    def forward(self, frame_embeds: torch.Tensor,  # (B, T, Q, C) normalized queries
                frame_embeds_no_norm: torch.Tensor,  # (B, T, Q, C)
                mask_features: torch.Tensor,  # (B, T, H, W, mask_dim)
                state: TrackerState | None = None):  # None -> video start
        """Inference (the JAX module's ``train=False``): returns (outputs,
        new state). Outputs: pred_logits (B, T, Q, K+1), pred_masks
        (B, Q, T, H, W), pred_embds (B, T, Q, C), pred_references,
        ret_indices."""
        t = frame_embeds.shape[1]
        mask_features = self.mask_feature_proj(mask_features)
        last_output = None if state is None else state["last_output"]
        last_frame_embeds = None if state is None else state["last_frame_embeds"]

        outputs, references, ret_indices = [], [], []
        for i in range(t):
            cur, cur_nn = frame_embeds[:, i], frame_embeds_no_norm[:, i]
            first = i == 0 and state is None
            indices = match_embeddings(cur if first else last_frame_embeds, cur)
            init = take_rows(cur_nn, indices)
            ret_indices.append(indices)
            last_frame_embeds = take_rows(cur, indices)
            reference = self.ref_proj(cur_nn if first else last_output)
            last_output = self._layers(init, reference, cur_nn, per_layer_reference=first)
            references.append(reference)
            outputs.append(last_output)

        new_state = {"last_output": last_output, "last_frame_embeds": last_frame_embeds}
        x = self.decoder_norm(torch.stack(outputs, dim=1))  # (B, T, Q, C)
        refs = torch.stack(references, dim=1)
        pred_logits = self.class_embed(torch.cat([refs, x], dim=-1))
        mask_embed = self.mask_embed(x)
        pred_masks = torch.einsum("btqc,bthwc->bqthw", mask_embed, mask_features)
        out = {"pred_logits": pred_logits, "pred_masks": pred_masks, "pred_embds": x,
               "pred_references": refs, "aux_outputs": [], "ret_indices": ret_indices}
        return out, new_state

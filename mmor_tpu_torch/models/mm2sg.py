"""MM2SG: multimodal scene-graph generator (LLaVA-style).

Counterpart of ``mmor_tpu/models/mm2sg.py`` for serialized serving, per-op
or through the decode megakernel:

- all views are CLIP-encoded in one (B*V) call;
- the BERT pooler fuses the views and appends pc/audio/segmask tokens, so
  the multimodal block has a static length (``cfg.num_multimodal_tokens``);
- each prompt carries one ``IMAGE_TOKEN_INDEX`` sentinel, replaced by the
  multimodal tokens: the spliced length is always T + M - 1;
- ``make_prefill`` fills preallocated capacity cache buffers in place and
  ``generate_stepwise`` decodes greedily (per-op steps, or K5 steps under
  ``mega_decode``), handing the buffers back for the next batch of the same
  shape.
"""

from __future__ import annotations

import torch
from torch import nn

from mmor_tpu_torch.sg.prompts import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from mmor_tpu_torch.config import MM2SGConfig
from mmor_tpu_torch.models.clip_vit import ClipVisionTower
from mmor_tpu_torch.models.llama import (
    LlamaModel,
    alloc_kv_buffers,
    build_cache,
    greedy_decode_hostloop,
    make_decode_step,
)
from mmor_tpu_torch.models.pooler import ImagePooler, MMProjector, SegmaskEncoder
from mmor_tpu_torch.models.ptv3 import PointTransformerV3
from mmor_tpu_torch.ops.image_preproc import preprocess_views
from mmor_tpu_torch.ops.mega_decode import MegaServer, greedy_decode_hostloop_mega


def splice_multimodal(token_embeds, sentinel_pos, mm_embeds, attention_mask,
                      labels=None):
    """Replace each row's sentinel token with the M multimodal embeddings.

    token_embeds (B, T, D), sentinel_pos (B,), mm_embeds (B, M, D),
    attention_mask (B, T) -> (embeds (B, T+M-1, D), mask, labels or None)."""
    batch, t, dim = token_embeds.shape
    m = mm_embeds.shape[1]
    j = torch.arange(t + m - 1, device=token_embeds.device)[None, :]
    pos = sentinel_pos[:, None].long()
    is_mm = (j >= pos) & (j < pos + m)
    tok_idx = torch.where(j < pos, j, torch.clamp(j - m + 1, min=0))
    mm_idx = torch.clamp(j - pos, 0, m - 1)
    take = lambda x, idx: torch.gather(x, 1, idx[..., None].expand(-1, -1, dim))
    embeds = torch.where(is_mm[..., None], take(mm_embeds.to(token_embeds.dtype), mm_idx),
                         take(token_embeds, tok_idx))
    gathered_mask = torch.gather(attention_mask, 1, tok_idx)
    mask = torch.where(is_mm, torch.ones_like(gathered_mask), gathered_mask)
    out_labels = None
    if labels is not None:
        gathered = torch.gather(labels, 1, tok_idx)
        out_labels = torch.where(is_mm, torch.full_like(gathered, IGNORE_INDEX), gathered)
    return embeds, mask.to(attention_mask.dtype), out_labels


def find_sentinel(input_ids: torch.Tensor) -> torch.Tensor:
    """Index of the (single) IMAGE_TOKEN_INDEX sentinel per row."""
    return torch.argmax((input_ids == IMAGE_TOKEN_INDEX).to(torch.int32), dim=1)


class MM2SG(nn.Module):
    def __init__(self, cfg: MM2SGConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = ClipVisionTower(cfg.vision)
        self.image_pooler = ImagePooler(cfg.pooler)
        s = cfg.segmask
        self.segmask_encoder = SegmaskEncoder(s.num_classes, s.embed_dim, s.out_dim,
                                              s.dtype, s.param_dtype)
        self.mm_projector = MMProjector(cfg.pooler.hidden, cfg.llama.dim,
                                        cfg.llama.dtype, cfg.llama.param_dtype)
        self.language_model = LlamaModel(cfg.llama)
        self.point_encoder = PointTransformerV3(cfg.ptv3)

    def encode_pc(self, pc_points: torch.Tensor, pc_valid: torch.Tensor) -> torch.Tensor:
        """(B, P, 6) padded clouds -> (B, pc_feature_dim); clouds without a
        valid point give zero features."""
        feats = self.point_encoder(pc_points, pc_valid)
        has_points = pc_valid.bool().any(dim=1)
        return torch.where(has_points[:, None], feats, torch.zeros_like(feats))

    def encode_multimodal(self, images, view_mask, pc_feature=None,
                          audio_embedding=None, segmasks=None, pc_points=None,
                          pc_valid=None) -> torch.Tensor:
        """Images (B, V, S, S, 3) pixels, or raw uint8 frames (B, V, H, W, 3)
        preprocessed here, plus the extra modalities -> (B, M, lm_dim)."""
        cfg = self.cfg
        if images.dtype == torch.uint8:
            images = preprocess_views(images, cfg.vision.image_size)
        if pc_points is not None:
            pc_feature = self.encode_pc(pc_points, pc_valid)
        batch, views = images.shape[:2]
        tokens = self.vision_tower(images.reshape(batch * views, *images.shape[2:]))
        per_view = tokens.shape[1]
        tokens = tokens.reshape(batch, views * per_view, -1)
        token_mask = view_mask.repeat_interleave(per_view, dim=1)
        seg_features = None
        if segmasks is not None:
            n_seg = segmasks.shape[1]
            seg_features = self.segmask_encoder(
                segmasks.reshape(batch * n_seg, *segmasks.shape[2:])).reshape(batch, n_seg, -1)
        fused = self.image_pooler(tokens, token_mask, pc_feature=pc_feature,
                                  audio_embedding=audio_embedding,
                                  segmask_features=seg_features)
        return self.mm_projector(fused)

    def encode_prompt(self, input_ids, attention_mask, images, view_mask,
                      pc_feature=None, audio_embedding=None, segmasks=None,
                      pc_points=None, pc_valid=None, labels=None):
        """Multimodal encode + token embedding + splice: (embeds (B, T_out, D),
        mask (B, T_out), spliced labels or None) — the prefill's inputs."""
        mm = self.encode_multimodal(images, view_mask, pc_feature, audio_embedding,
                                    segmasks, pc_points=pc_points, pc_valid=pc_valid)
        sentinel = find_sentinel(input_ids)
        safe_ids = torch.where(input_ids == IMAGE_TOKEN_INDEX,
                               torch.zeros_like(input_ids), input_ids)
        token_embeds = self.language_model.embed(safe_ids)
        return splice_multimodal(token_embeds, sentinel, mm, attention_mask, labels)

    def forward(self, input_ids, attention_mask, images, view_mask, pc_feature=None,
                audio_embedding=None, segmasks=None, pc_points=None, pc_valid=None,
                labels=None, last_logit_only: bool = False,
                prefill_cache_buffers=None):
        """Prefill / scoring forward -> (logits, spliced labels, aux); ``aux``
        holds the spliced attention mask and, when ``prefill_cache_buffers``
        were given, the filled buffers under ``kv``."""
        embeds, mask, out_labels = self.encode_prompt(
            input_ids, attention_mask, images, view_mask, pc_feature,
            audio_embedding, segmasks, pc_points, pc_valid, labels)
        logits, kv = self.language_model(
            input_embeds=embeds, attention_mask=mask, last_logit_only=last_logit_only,
            prefill_cache_buffers=prefill_cache_buffers)
        return logits, out_labels, {"attention_mask": mask, "kv": kv}


def alloc_cache_buffers(cfg: MM2SGConfig, batch: int, max_cache_len: int, device):
    """Capacity KV stacks for ``make_prefill`` to fill in place (int8, or
    int4 nibble pairs under ``kv_bits=4``, + bf16 scales with ``kv_quant``,
    else ``cfg.llama.dtype``)."""
    return alloc_kv_buffers(cfg.llama, batch, max_cache_len, device)


def _images_from_raw(model: MM2SG, batch: dict) -> dict:
    """Replace ``raw_views`` (V per-slot (B, h_v, w_v, 3) uint8 frames at
    their native sizes) with preprocessed (B, V, S, S, 3) ``images``."""
    if "raw_views" not in batch:
        return batch
    batch = dict(batch)
    size, dtype = model.cfg.vision.image_size, model.cfg.vision.dtype
    views = [preprocess_views(rv, size).to(dtype) for rv in batch.pop("raw_views")]
    batch["images"] = torch.stack(views, dim=1)
    return batch


def make_prefill(model: MM2SG, *, max_cache_len: int):
    """Multimodal prefill: prefill(batch, cache_buffers) -> (next-token
    logits (B, 1, V), decode cache). The buffers (from
    ``alloc_cache_buffers`` or a previous generation's recycled cache) are
    filled in place."""

    @torch.no_grad()
    def prefill(batch, cache_buffers):
        batch = _images_from_raw(model, batch)
        logits, _, aux = model(
            batch["input_ids"], batch["attention_mask"], batch["images"],
            batch["view_mask"], pc_feature=batch.get("pc_feature"),
            audio_embedding=batch.get("audio_embedding"),
            segmasks=batch.get("segmasks"), pc_points=batch.get("pc_points"),
            pc_valid=batch.get("pc_valid"), last_logit_only=True,
            prefill_cache_buffers=cache_buffers)
        if aux["attention_mask"].shape[1] > max_cache_len:
            raise ValueError(f"spliced prompt of {aux['attention_mask'].shape[1]} "
                             f"tokens exceeds the cache capacity {max_cache_len}")
        cache = build_cache(model.cfg.llama, aux["kv"], aux["attention_mask"],
                            max_cache_len)
        return logits, cache

    return prefill


@torch.no_grad()
def generate_stepwise(model: MM2SG, batch: dict, *, max_cache_len: int,
                      max_new_tokens: int, eos_token_id: int, prefill_fn=None,
                      step_fn=None, cache_buffers=None):
    """Greedy generation: prefill into capacity buffers, then host-driven
    decode steps: per-op steps (``step_fn`` from ``make_decode_step``), or
    under ``mega_decode`` one K5 step per token (``step_fn`` a
    ``MegaServer``, built here when not given). Returns ((B, max_new_tokens)
    int32 numpy tokens, the cache buffers to pass as ``cache_buffers`` for the
    next batch of the same shape, or None when EOS compaction shrank the
    megakernel cache's batch axis)."""
    lcfg = model.cfg.llama
    if lcfg.mega_decode and step_fn is not None and not isinstance(step_fn, MegaServer):
        raise TypeError("under mega_decode, step_fn must be a MegaServer, got "
                        f"{type(step_fn).__name__}")
    if prefill_fn is None:
        prefill_fn = make_prefill(model, max_cache_len=max_cache_len)
    if cache_buffers is None:
        cache_buffers = alloc_cache_buffers(
            model.cfg, batch["input_ids"].shape[0], max_cache_len,
            batch["input_ids"].device)
    logits, cache = prefill_fn(batch, cache_buffers)
    if lcfg.mega_decode:
        server = step_fn if step_fn is not None else MegaServer(lcfg, model.language_model)
        tokens, final = greedy_decode_hostloop_mega(
            server, logits, cache, max_new_tokens, eos_token_id=eos_token_id)
    else:
        if step_fn is None:
            step_fn = make_decode_step(model.language_model)
        tokens, final = greedy_decode_hostloop(
            model.language_model, logits, cache, max_new_tokens,
            eos_token_id=eos_token_id, step_fn=step_fn)
    if final["kv_mask"].shape[0] != batch["input_ids"].shape[0]:
        return tokens, None
    return tokens, {k: final[k] for k in cache_buffers}

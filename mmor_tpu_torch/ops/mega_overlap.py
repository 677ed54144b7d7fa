"""Piggyback-prefill serving glue: the next batch's LLaMA prefill rides the
current batch's decode steps, inside K5.

Counterpart of ``mmor_tpu/ops/mega_overlap.py`` (int8 or int4 weights, an int8
or int4 KV cache) in the port's cache layouts. Each decode step of batch N
carries ``chunk`` consecutive prompt tokens of one stream of batch N+1 as
extra rows of K5 (``mega_decode_layers(..., pf=...)``):

- the chunk's K/V accumulate in that stream's working cache, (L, H, T2, Dh)
  int8 or (L, H, T2, Dh/2) uint8 nibble pairs, with (L, H, T2) bf16 scales
  (``alloc_pf_work``, ``apply_pf_work_update``);
- after the stream's last chunk the working cache is copied into the full
  prefill buffer, (L, B, H, T2, ...) with (L, B, H, T2) scales, the decode
  cache's own order (``flush_pf_work``), and re-zeroed. The working cache is a
  buffer of its own, not a view of the full buffer's stream row: the kernel
  then reads one contiguous (L, H, T2) stack, and the copy costs one ~50 MB
  transfer a stream at 7B;
- at the batch boundary the full buffer becomes batch N+1's decode cache
  (``pf_full_to_decode_cache``): a copy of its T2 columns into the retiring
  batch's t_cap-capacity stacks, the columns past T2 zeroed and their scales
  set to 1.0. The TPU package re-pairs its T-halved nibble words here
  (``repack_k_int4`` / ``repack_v_int4``) and pads its packed int8 words; the
  port's layouts keep each position's row whole, so no relayout is needed.
"""

from __future__ import annotations

import torch

from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.ops import mega_decode as md


def _kv_stacks(cfg: LlamaConfig, lead: tuple, device) -> dict:
    """Zeroed K/V stacks (*lead, Dh) int8 or (*lead, Dh/2) uint8 at the
    cache width ``cfg.kv_bits``, with scales 1: the TPU package's zeroed
    int32 words (an int4 zero byte is the value -8, which the working-cache
    mask excludes)."""
    if cfg.kv_bits == 8:
        shape, dtype = (*lead, cfg.head_dim), torch.int8
    else:
        shape, dtype = (*lead, cfg.head_dim // 2), torch.uint8
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                k_s=torch.ones(lead, dtype=torch.bfloat16, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                v_s=torch.ones(lead, dtype=torch.bfloat16, device=device))


def alloc_pf_work(cfg: LlamaConfig, t2: int, device) -> dict:
    """A zeroed single-stream working cache, (L, H, T2, ...)."""
    return _kv_stacks(cfg, (cfg.n_layers, cfg.n_heads, t2), device)


def alloc_pf_full(cfg: LlamaConfig, batch: int, t2: int, device) -> dict:
    """The all-streams prefill buffer, flushed into once a stream: the
    decode cache's layout at T2 columns."""
    return _kv_stacks(cfg, (cfg.n_layers, batch, cfg.n_heads, t2), device)


def apply_pf_work_update(work: dict, pfout: dict, wp: int) -> dict:
    """Write a chunk's K/V columns [wp, wp + c) into the working cache in
    place (``mega_overlap.py:79-143``), as ``md.apply_kv_update`` writes a
    decode column. ``pfout`` is K5's sixth element: knew/vnew (L, c, H, dh)
    int8 and scales (L, c, H) f32. An int8 working cache stores them, the
    scales in bf16; an int4 one takes them requantized to the int4 grid as
    clip(round(k8 * f32(7/127)), +-7) with the scale times f32(127/7) stored
    in bf16."""
    c = pfout["knew"].shape[1]
    bits = md.kv_bits_of(work["k"], pfout["knew"].shape[-1])
    for name in ("k", "v"):
        if bits == 8:
            work[name][:, :, wp:wp + c] = pfout[name + "new"].transpose(1, 2)
            work[name + "_s"][:, :, wp:wp + c] = pfout[name + "new_s"].to(
                torch.bfloat16).transpose(1, 2)
            continue
        q4 = torch.clamp(torch.round(pfout[name + "new"].float() * (7.0 / 127.0)), -7, 7)
        work[name][:, :, wp:wp + c] = md.pack_kv_int4(
            (q4 + 8).to(torch.uint8)).transpose(1, 2)
        work[name + "_s"][:, :, wp:wp + c] = (
            pfout[name + "new_s"] * (127.0 / 7.0)).to(torch.bfloat16).transpose(1, 2)
    return work


def flush_pf_work(full: dict, work: dict, stream: int) -> tuple[dict, dict]:
    """Copy a finished stream's working cache into row ``stream`` of the full
    buffer and re-zero it for the next stream (``mega_overlap.py:146-165``);
    both are updated in place and returned."""
    for name in ("k", "k_s", "v", "v_s"):
        full[name][:, stream].copy_(work[name])
    work["k"].zero_()
    work["v"].zero_()
    work["k_s"].fill_(1.0)
    work["v_s"].fill_(1.0)
    return full, work


def pf_full_to_decode_cache(full: dict, amask: torch.Tensor, bufs: dict) -> dict:
    """The finished prefill buffer and the batch's (B, P) spliced attention
    mask -> its decode cache in ``bufs``' t_cap-capacity stacks, overwritten
    in place (``mega_overlap.py:344-372``): the T2 columns copied, the rest
    zeroed with scales 1.0; ``kv_mask`` the mask over the first P columns,
    ``write_pos`` P, ``tok_pos`` each row's count of real tokens. Chunks land
    at column multiples, so positions are column indices (left padding stays
    masked, as in ``build_cache``)."""
    t2 = full["k"].shape[3]
    b, p = amask.shape
    for name, fill in (("k", 0), ("v", 0), ("k_s", 1.0), ("v_s", 1.0)):
        bufs[name][:, :, :, :t2].copy_(full[name])
        bufs[name][:, :, :, t2:] = fill
    kv_mask = torch.zeros(b, bufs["k"].shape[3], dtype=torch.int32, device=amask.device)
    kv_mask[:, :p] = amask
    return dict(k=bufs["k"], k_s=bufs["k_s"], v=bufs["v"], v_s=bufs["v_s"],
                kv_mask=kv_mask, write_pos=p,
                tok_pos=amask.to(torch.int32).sum(dim=1).to(torch.int32))


def make_overlap_step(server: md.MegaServer, batch: int, chunk: int, t2: int, *,
                      return_logits: bool = False, return_kv: bool = False,
                      update_state: bool = True):
    """One greedy decode step with a piggybacked chunk
    (``mega_overlap.py:227-297``):

    step(cache, tok (B, 1), work, ck) -> nxt (B,) int32[, cache, work],
    x_pf (c, D) bf16[, logits (B, V) f32][, (knew, knew_s, vnew, vnew_s),
    pf_kv dict]

    ``ck``: x (c, D) bf16 embeddings, pos (c,) RoPE positions, amask (c,)
    int32, stream_amask (T2,) int32 (the stream's whole mask row), wp (the
    chunk's first column, an int). Embedding, K5 with the chunk's rows, the
    final RMSNorm, the int8 lm_head (K2) and the argmax; then, unless
    ``update_state`` is False, ``apply_kv_update`` and
    ``apply_pf_work_update`` in place. The chunk sees the working-cache
    columns below wp that its stream's mask keeps. The scratch is allocated
    once for B + c rows."""
    cfg, weights = server.cfg, server.weights
    device = weights.norms.device
    scratch = (md.alloc_scratch(weights, batch + chunk, device)
               if device.type == "cuda" else None)
    cols = torch.arange(t2, device=device)

    @torch.no_grad()
    def step(cache: dict, tok: torch.Tensor, work: dict, ck: dict):
        x = server.lm.embed_tokens(tok[:, 0].long()).to(torch.bfloat16)
        cos, sin = md.rope_tables(cache["tok_pos"], cfg.head_dim, cfg.rope_theta)
        pcos, psin = md.rope_tables(ck["pos"], cfg.head_dim, cfg.rope_theta)
        mask = ck["stream_amask"].to(torch.int32) * (cols < ck["wp"]).to(torch.int32)
        pf = dict(x=ck["x"], cos=pcos, sin=psin, amask=ck["amask"].to(torch.int32),
                  mask=mask, k=work["k"], k_s=work["k_s"], v=work["v"], v_s=work["v_s"])
        x, knew, knew_s, vnew, vnew_s, pfout = md.mega_decode_layers(
            x, weights, cache, cos, sin, eps=cfg.norm_eps, scratch=scratch,
            pointer_table=server.pointer_table, pf=pf)
        logits = server.head(x)
        outs = (logits.argmax(dim=-1).to(torch.int32),)
        if update_state:
            outs += (md.apply_kv_update(cache, knew, knew_s, vnew, vnew_s),
                     apply_pf_work_update(work, pfout, ck["wp"]))
        outs += (pfout["x"],)
        if return_logits:
            outs += (logits.float(),)
        if return_kv:
            outs += ((knew, knew_s, vnew, vnew_s),
                     {k: pfout[k] for k in ("knew", "knew_s", "vnew", "vnew_s")})
        return outs

    return step


class OverlapServer:
    """Serving bundle for piggybacked prefill and decode over same-shape
    batches (``mega_overlap.py:300-341``): the megakernel server (weights,
    head, plain steps), the overlap step with its B + c row scratch, and the
    handoff."""

    def __init__(self, cfg: LlamaConfig, lm, *, batch: int, t_cap: int, t2: int,
                 chunk: int = 128):
        granule = md.mega_granule(cfg)
        if chunk % 32 or t2 % granule or t2 % chunk or t2 > t_cap:
            # the TPU kernel's shape rules (``mega_decode.py:206-214``), kept
            # so that T2 and the step count equal the JAX package's
            # ((t2 // 2) % chunk, a rule of its T-halved int4 layout, is not
            # needed here)
            raise ValueError(f"chunk {chunk} must be a multiple of 32 and T2 {t2} a "
                             f"multiple of {granule} and of the chunk, at most t_cap "
                             f"{t_cap}")
        self.cfg, self.batch = cfg, batch
        self.t_cap, self.t2, self.chunk = t_cap, t2, chunk
        self.mega = md.MegaServer(cfg, lm)
        self.step_pf = make_overlap_step(self.mega, batch, chunk, t2)
        self.step_plain = self.mega.step_for(batch)

    def handoff(self, cache: dict, full: dict, amask: torch.Tensor,
                hidden: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """The retiring batch's cache stacks become the next batch's decode
        cache, and each stream's last-prompt hidden state (B, D) its first
        token. The full buffer is reused as it is: the next wave's flushes
        overwrite every row."""
        new = pf_full_to_decode_cache(full, amask, cache)
        tok0 = self.mega.head(hidden.to(torch.bfloat16)).argmax(dim=-1).to(torch.int32)
        return new, tok0

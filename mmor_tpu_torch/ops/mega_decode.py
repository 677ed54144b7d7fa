"""Decode megakernel: every decoder layer of one decode position in one call.

Counterpart of ``mmor_tpu/ops/mega_decode.py`` for int4 weights and an int4
KV cache (``wbits = kvbits = 4``), without the piggyback-prefill rows:

- ``mega_decode_layers`` is K5. On the card one C entry point
  (``csrc/mega_decode.cu``) runs all L layers, enqueueing a fixed sequence of
  hand-written kernels per layer; on the CPU ``mega_decode_layers_plain`` runs
  the same arithmetic chain, that of ``mega_decode_layers_reference``
  (``mega_decode.py:1386-1589``).
- The weights are the per-layer fused ``qkv_proj`` / ``o_proj`` /
  ``gate_up_proj`` / ``down_proj`` (K/8, N) packed stacks the prefill reads
  (``MegaWeights``), walked in place. The TPU package's tapes
  (``build_tapes``) and its tiling fields exist for Mosaic and have no
  counterpart here; the fused ``gate_up`` is ``[gate + pad | up + pad]``, so
  gate column j pairs with up column j.
- The int4 KV cache is the port's own layout: (L, B, H, T, Dh/2) uint8, two
  biased head-dim values a byte (low nibble = even channel), with (L, B, H,
  T) bf16 per-position scales. The decode write of a position is a plain
  store (``apply_kv_update``), where the TPU layout shares each nibble word
  with position t +- T/2.
- ``MegaServer``, ``make_mega_decode_step``, ``compact_cache`` and
  ``greedy_decode_hostloop_mega`` (EOS compaction into 8-multiple batch
  buckets every 64 steps) mirror the JAX serving loop.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops import quantized_matmul as qmm

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ------------------------------------------------------------ int4 KV cache
def quantize_kv_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, D) float -> (biased nibble values uint8 in [1, 15], scales
    (..., T) bf16): per-position symmetric int4, dividing by the f32 scale
    amax / 7 (``mega_decode.py:440-446``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -7, 7)
    return (q + 8).to(torch.uint8), scale[..., 0].to(torch.bfloat16)


def pack_kv_int4(u: torch.Tensor) -> torch.Tensor:
    """Biased nibbles (..., D) uint8 -> (..., D/2) uint8; byte j holds channel
    2j in its low nibble and 2j+1 in its high nibble."""
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_kv_int4(p: torch.Tensor) -> torch.Tensor:
    """(..., D/2) packed bytes -> signed int4 values (..., D) int8."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def dequantize_kv_int4(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Packed (..., T, D/2) bytes and (..., T) scales -> f32 (..., T, D)."""
    return unpack_kv_int4(p).float() * scale.float()[..., None]


def apply_kv_update(cache: dict, knew, knew_s, vnew, vnew_s) -> dict:
    """Write the step's new K/V column at ``write_pos`` and advance the
    masks (``mega_decode.py:1607-1677``, int4 branch). The kernel's int8
    column is requantized to the int4 grid as clip(round(k8 * f32(7/127)),
    +-7) with the scale times f32(127/7) stored in bf16. The cache stacks are
    updated in place; the returned dict carries the new positions."""
    wp = cache["write_pos"]
    for name, q8, s8 in (("k", knew, knew_s), ("v", vnew, vnew_s)):
        # an f32 tensor times a Python float multiplies by the f32 constant
        q4 = torch.clamp(torch.round(q8.float() * (7.0 / 127.0)), -7, 7)
        cache[name][:, :, :, wp] = pack_kv_int4((q4 + 8).to(torch.uint8))
        cache[name + "_s"][:, :, :, wp] = (s8 * (127.0 / 7.0)).to(torch.bfloat16)
    cache["kv_mask"][:, wp] = 1
    return dict(cache, write_pos=wp + 1, tok_pos=cache["tok_pos"] + 1)


def rope_tables(tok_pos: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) positions -> (cos (B, dh), sin (B, dh)) f32 in the HF half-rotation
    layout (``mega_decode.py:1680-1688``)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=tok_pos.device) / half
    inv = 1.0 / (theta ** exponent)
    ang = tok_pos.float()[:, None] * inv[None, :]
    return torch.cat([torch.cos(ang)] * 2, dim=-1), torch.cat([torch.sin(ang)] * 2, dim=-1)


# ------------------------------------------------------------------ weights
_SLOTS = (("qkv_proj", "w_p"), ("qkv_proj", "scale"), ("o_proj", "w_p"),
          ("o_proj", "scale"), ("gate_up_proj", "w_p"), ("gate_up_proj", "scale"),
          ("down_proj", "w_p"), ("down_proj", "scale"))


@dataclass
class MegaWeights:
    """The decoder weights K5 walks: ``layers[slot][l]`` are layer l's packed
    (K/8, N) int32 words or (K/group, N) f32 scales of the slots in
    ``_SLOTS`` order (the ``LlamaModel``'s own buffers, not copies);
    ``norms`` (L, 2, D) f32 are the attention and MLP RMSNorm scales;
    ``group`` is the int4 scale group, equal to the K-chunk ``pick_ck``;
    ``ffn`` the padded MLP width."""

    layers: list[list[torch.Tensor]]
    norms: torch.Tensor
    group: int
    ffn: int
    heads: int

    @classmethod
    def from_model(cls, lm) -> "MegaWeights":
        cfg = lm.cfg
        if not (cfg.fused_qkv and cfg.weight_quant and cfg.weight_bits == 4):
            raise ValueError("the megakernel walks fused int4 weights")
        layers = [[getattr(getattr(b, mod), leaf) for b in lm.blocks] for mod, leaf in _SLOTS]
        norms = torch.stack([torch.stack([b.attn_norm.scale, b.mlp_norm.scale])
                             for b in lm.blocks]).detach().float()
        return cls(layers, norms, cfg.weight_group, cfg.ffn_dim + cfg.ffn_pad,
                   cfg.n_heads)

    def pointer_table(self) -> ctypes.Array:
        """Host array of the device pointers, slot-major (slot * L + layer),
        after checking every tensor's device, dtype and shape."""
        n_layers, _, dim = self.norms.shape
        device, g = self.norms.device, self.group
        shapes = ((dim, 3 * dim), (dim, dim), (dim, 2 * self.ffn), (self.ffn, dim))
        if self.norms.dtype != torch.float32 or len(self.layers) != 2 * len(shapes):
            raise ValueError("MegaWeights: norms must be f32 (L, 2, D), with 8 weight slots")
        for i, (k, n) in enumerate(shapes):
            for want, dtype, slot in (((k // 8, n), torch.int32, self.layers[2 * i]),
                                      ((k // g, n), torch.float32, self.layers[2 * i + 1])):
                if len(slot) != n_layers or any(
                        t.device != device or t.dtype != dtype or tuple(t.shape) != want
                        for t in slot):
                    raise ValueError(f"MegaWeights: {_SLOTS[2 * i][0]} needs {n_layers} "
                                     f"{dtype} tensors of {want} on {device}")
        ptrs = [_build.ptr(t) for slot in self.layers for t in slot]
        return (ctypes.c_void_p * len(ptrs))(*ptrs)


# ------------------------------------------------------------ plain version
def _quant_rows_f32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization over the last axis, in f32:
    rs = amax / 127 (1 for a zero row), q = clip(round(x * (1 / rs)), +-127)
    kept in f32 (``mega_decode.py:1379-1383``)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, where the kernel divides
    rs = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(x * (1.0 / rs)), -127, 127), rs


def _w4a8_chunks(q: torch.Tensor, rs: torch.Tensor, w_p: torch.Tensor,
                 scale: torch.Tensor, group: int, chunk: int) -> torch.Tensor:
    """Int-valued activations q (rows, K) with per-(row, chunk) scales rs
    (rows, K/chunk) times one layer's int4 weights: each chunk's exact dot,
    folded in chunk order as acc += (dot * w_scale) * rs, the kernel's
    order (``csrc/w4a8.cuh``)."""
    w4 = qmm.unpack_int4_rows(w_p, block=group).double()
    acc = torch.zeros(q.shape[0], w_p.shape[1], dtype=torch.float32, device=q.device)
    for c in range(q.shape[1] // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        dot = (q[:, rows].double() @ w4[rows]).float()
        acc = acc + (dot * scale[c * chunk // group][None, :]) * rs[:, c:c + 1]
    return acc


def _rmsnorm(x: torch.Tensor, norm: torch.Tensor, eps: float) -> torch.Tensor:
    """x * r * norm with r = 1 / sqrt(mean(x^2) + eps) taken in double (as
    the kernel does), so the f32 result does not depend on the sum's order."""
    eps32 = float(torch.tensor(eps, dtype=torch.float32))  # the kernel's f32 eps
    r = torch.rsqrt((x.double() ** 2).mean(dim=-1, keepdim=True) + eps32).float()
    return x * r * norm


def _attention_plain(q8, qs, k8, ks_cur, vcur, k_int, ks, v_int, vs, mask):
    """One layer's attention, ``mega_decode.py:1522-1534``: int8 queries
    (B, H, dh) with scales qs (B, H, 1) against the int4 cache values
    (B, H, T, dh) with scales (B, H, T), and the current token's term inline:
    its logit is the exact int8 dot q8 . k8 times ks_cur and qs (the
    reference sums q8 * (k8 * ks_cur), equal up to f32 rounding), its value
    vcur dequantized. Returns (B, H, dh) f32."""
    logits = torch.einsum("bhd,bhtd->bht", q8.double(), k_int.double()).float()
    logits = logits * qs * ks
    logits = torch.where(mask[:, None, :] != 0, logits, NEG_INF)
    lcur = (q8 * k8).sum(dim=-1, keepdim=True) * ks_cur * qs
    mmax = torch.maximum(logits.amax(dim=-1, keepdim=True), lcur)
    w = torch.exp(logits - mmax)
    wc = torch.exp(lcur - mmax)
    denom = w.sum(dim=-1, keepdim=True) + wc
    w8, wrs = _quant_rows_f32(w * vs)
    ov = torch.einsum("bht,bhtd->bhd", w8.double(), v_int.double()).float() * wrs
    return (ov + wc * vcur) / denom


def mega_decode_layers_plain(x: torch.Tensor, weights: MegaWeights, cache: dict,
                             cos: torch.Tensor, sin: torch.Tensor, *,
                             eps: float = 1e-5, sm_scale: float | None = None):
    """Plain PyTorch K5: the arithmetic chain of
    ``mega_decode_layers_reference`` (``pf=None``, ``wbits = kvbits = 4``)
    with the kernel's fold order. Weights and the cache dequantize one layer
    at a time: the whole 7B stack in f32 would take ~26 GB
    (``mega_decode.py:1424-1427``). Returns (x_out (B, D) bf16, knew
    (L, B, H, dh) int8, knew_s (L, B, H) f32, vnew, vnew_s)."""
    b, dim = x.shape
    n_layers, _, heads, t_cap, _ = cache["k"].shape
    dh = dim // heads
    ck, half = weights.group, dh // 2
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    cosr, sinr = cos.float()[:, None, :], sin.float()[:, None, :]

    def rope(t):  # (B, H, dh)
        return t * cosr + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sinr

    def chunk_quant(h):
        q, rs = _quant_rows_f32(h.reshape(b, -1, ck))
        return q.reshape(b, -1), rs[..., 0]

    x = x.float()
    knews, knew_ss, vnews, vnew_ss = [], [], [], []
    for li in range(n_layers):
        wq, sq, wo, so, wg, sg, wd, sd = (slot[li] for slot in weights.layers)
        h = _rmsnorm(x, weights.norms[li, 0], eps)
        qkv = _w4a8_chunks(*chunk_quant(h), wq, sq, ck, ck).reshape(b, 3, heads, dh)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        q8, qs = _quant_rows_f32(q * sm_scale)
        k8, ks = _quant_rows_f32(k)
        v8, vs = _quant_rows_f32(v)
        knews.append(k8)
        knew_ss.append(ks[..., 0])
        vnews.append(v8)
        vnew_ss.append(vs[..., 0])
        attn = _attention_plain(
            q8, qs, k8, ks, v8 * vs,
            unpack_kv_int4(cache["k"][li]), cache["k_s"][li].float(),
            unpack_kv_int4(cache["v"][li]), cache["v_s"][li].float(), cache["kv_mask"])
        a8, ars = _quant_rows_f32(attn)  # per (row, head)
        x2 = x + _w4a8_chunks(a8.reshape(b, dim), ars[..., 0], wo, so, ck, dh)
        h2 = _rmsnorm(x2, weights.norms[li, 1], eps)
        gu = _w4a8_chunks(*chunk_quant(h2), wg, sg, ck, ck)
        gate, up = gu[:, :weights.ffn], gu[:, weights.ffn:]
        m = gate * torch.sigmoid(gate) * up
        x = x2 + _w4a8_chunks(*chunk_quant(m), wd, sd, ck, ck)
    return (x.to(torch.bfloat16), torch.stack(knews).to(torch.int8), torch.stack(knew_ss),
            torch.stack(vnews).to(torch.int8), torch.stack(vnew_ss))


# ------------------------------------------------------------------- kernel
def alloc_scratch(weights: MegaWeights, batch: int, device) -> dict:
    """The intermediate buffers K5's kernels pass between phases."""
    dim = weights.norms.shape[-1]
    width = max(dim, weights.ffn)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        x_res=torch.empty(batch, dim, **f32), x2=torch.empty(batch, dim, **f32),
        hq=torch.empty(batch, width, dtype=torch.int8, device=device),
        hrs=torch.empty(batch, width // weights.group, **f32),
        qkv=torch.empty(batch, 3 * dim, **f32),
        a8=torch.empty(batch, dim, dtype=torch.int8, device=device),
        ars=torch.empty(batch, weights.heads, **f32),
        mbuf=torch.empty(batch, weights.ffn, **f32))


def mega_decode_layers(x: torch.Tensor, weights: MegaWeights, cache: dict,
                       cos: torch.Tensor, sin: torch.Tensor, *, eps: float = 1e-5,
                       sm_scale: float | None = None, scratch: dict | None = None,
                       pointer_table: ctypes.Array | None = None):
    """K5: x (B, D) bf16 hidden states of one decode position through every
    decoder layer, against the int4 cache. Returns (x_out (B, D) bf16 before
    the final norm, knew (L, B, H, dh) int8, knew_s (L, B, H) f32, vnew,
    vnew_s); the caller owns the cache update (``apply_kv_update``).

    CPU: ``mega_decode_layers_plain``. CUDA: the ``csrc/mega_decode.cu``
    entry point (head_dim 128, K-chunk a multiple of 256 up to 1024, at
    most 8 chunks a model row), with ``scratch`` from ``alloc_scratch`` and
    the weights' ``pointer_table`` made here when not given. Counts its launches in ``mega_decode_layers.launches``."""
    if x.device.type == "cpu":
        return mega_decode_layers_plain(x, weights, cache, cos, sin, eps=eps,
                                        sm_scale=sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"mega_decode_layers: x is on {x.device}")
    b, dim = x.shape
    n_layers, cb, heads, t_cap, half_dh = cache["k"].shape
    dh = 2 * half_dh
    if (x.dtype != torch.bfloat16 or cb != b or dim != heads * dh
            or tuple(cos.shape) != (b, dh) or tuple(sin.shape) != (b, dh)
            or tuple(cache["kv_mask"].shape) != (b, t_cap)):
        raise ValueError(f"mega_decode_layers: x {tuple(x.shape)} {x.dtype}, cos/sin "
                         f"{tuple(cos.shape)} vs cache {tuple(cache['k'].shape)}")
    if (dh != 128 or weights.group % 256 or weights.group > 1024
            or dim > 8 * weights.group):
        raise ValueError(f"mega_decode_layers: the kernel takes head_dim 128, a "
                         f"K-chunk of 256..1024 in steps of 256 and at most 8 chunks "
                         f"a model row (dh={dh}, group={weights.group}, dim={dim})")
    for name, dtype in (("k", torch.uint8), ("v", torch.uint8), ("k_s", torch.bfloat16),
                        ("v_s", torch.bfloat16), ("kv_mask", torch.int32)):
        t = cache[name]
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"mega_decode_layers: cache[{name!r}] must be a contiguous "
                             f"{dtype} tensor on {x.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    if scratch is None:
        scratch = alloc_scratch(weights, b, x.device)
    if scratch["x_res"].shape != (b, dim) or scratch["hq"].device != x.device:
        raise ValueError(f"mega_decode_layers: scratch for batch {b} on {x.device} "
                         "expected (alloc_scratch)")
    if pointer_table is None:
        pointer_table = weights.pointer_table()
    x, cos, sin = _build.aligned(x), _build.aligned(cos.float()), _build.aligned(sin.float())
    dev = dict(device=x.device)
    x_out = torch.empty(b, dim, dtype=torch.bfloat16, **dev)
    knew = torch.empty(n_layers, b, heads, dh, dtype=torch.int8, **dev)
    vnew = torch.empty_like(knew)
    knew_s = torch.empty(n_layers, b, heads, dtype=torch.float32, **dev)
    vnew_s = torch.empty_like(knew_s)
    p = _build.ptr
    err = _build.library().mmor_mega_decode(
        p(x), ctypes.addressof(pointer_table), p(weights.norms), p(cache["k"]),
        p(cache["k_s"]), p(cache["v"]), p(cache["v_s"]), p(cache["kv_mask"]), p(cos),
        p(sin), *(p(scratch[k]) for k in ("x_res", "x2", "hq", "hrs", "qkv", "a8",
                                          "ars", "mbuf")),
        p(x_out), p(knew), p(knew_s), p(vnew), p(vnew_s), n_layers, b, dim, heads,
        weights.ffn, t_cap, weights.group, float(eps), float(sm_scale), _build.stream())
    _build.check(err, "mega_decode_layers")
    mega_decode_layers.launches += 1
    return x_out, knew, knew_s, vnew, vnew_s


mega_decode_layers.launches = 0


# ------------------------------------------------------------------ serving
class MegaServer:
    """Serving bundle for the megakernel decode path: the weights K5 walks
    and the head (embedding, final norm, int8 lm_head) taken once from the
    ``LlamaModel``, and one step with its own preallocated scratch per batch
    bucket (the scratch does not depend on the cache capacity)."""

    def __init__(self, cfg: LlamaConfig, lm):
        if not cfg.mega_decode:
            raise ValueError("MegaServer needs a mega_decode config")
        self.cfg = cfg
        self.lm = lm
        self.weights = MegaWeights.from_model(lm)
        device = self.weights.norms.device
        self.pointer_table = self.weights.pointer_table() if device.type == "cuda" else None
        self._steps: dict = {}

    def step_for(self, batch: int):
        if batch not in self._steps:
            self._steps[batch] = make_mega_decode_step(self, batch)
        return self._steps[batch]


def make_mega_decode_step(server: MegaServer, batch: int, *,
                          return_logits: bool = False, return_kv: bool = False,
                          update_cache: bool = True):
    """One greedy decode step through K5 (``mega_decode.py:1691-1748``):
    step(cache, tok (B, 1)) -> nxt (B,) int32[, cache][, logits (B, V) f32]
    [, (knew, knew_s, vnew, vnew_s)]. Embedding, K5, the final RMSNorm, the
    int8 lm_head (K2) and the argmax, then ``apply_kv_update`` in place
    unless ``update_cache`` is False."""
    cfg, lm, weights = server.cfg, server.lm, server.weights
    device = weights.norms.device
    scratch = alloc_scratch(weights, batch, device) if device.type == "cuda" else None
    final_norm = lm.final_norm.scale.detach().float()
    lm_head = lm.lm_head

    @torch.no_grad()
    def step(cache: dict, tok: torch.Tensor):
        x = lm.embed_tokens(tok[:, 0].long()).to(torch.bfloat16)
        cos, sin = rope_tables(cache["tok_pos"], cfg.head_dim, cfg.rope_theta)
        x, knew, knew_s, vnew, vnew_s = mega_decode_layers(
            x, weights, cache, cos, sin, eps=cfg.norm_eps, scratch=scratch,
            pointer_table=server.pointer_table)
        h = _rmsnorm(x.float(), final_norm, cfg.norm_eps).to(torch.bfloat16)
        logits = qmm.int8_matmul_packed(h, lm_head.w_p, lm_head.scale,
                                        int8_mxu=cfg.quant_int8_mxu)
        outs = (logits.argmax(dim=-1).to(torch.int32),)
        if update_cache:
            outs += (apply_kv_update(cache, knew, knew_s, vnew, vnew_s),)
        if return_logits:
            outs += (logits.float(),)
        if return_kv:
            outs += ((knew, knew_s, vnew, vnew_s),)
        return outs if len(outs) > 1 else outs[0]

    return step


_COMPACT_AXES = {"k": 1, "v": 1, "k_s": 1, "v_s": 1, "kv_mask": 0, "tok_pos": 0}


def compact_cache(cache: dict, lane_idx: torch.Tensor) -> dict:
    """Gather the live batch lanes (``lane_idx`` (new_batch,) into the
    current lane axis; pad entries may repeat a live lane) out of a decode
    cache (``mega_decode.py:1788-1803``). The gathered stacks are new
    tensors; the old ones are freed with the old cache."""
    return {k: (v.index_select(_COMPACT_AXES[k], lane_idx.to(v.device)).contiguous()
                if k in _COMPACT_AXES else v)
            for k, v in cache.items()}


def greedy_decode_hostloop_mega(server: MegaServer, prompt_logits: torch.Tensor,
                                cache: dict, max_new_tokens: int, *, eos_token_id: int,
                                compact_every: int = 64):
    """Greedy decode, one K5 step per token (``mega_decode.py:1806-1871``).

    Every ``compact_every`` steps (with an EOS id) the host reads the
    segment's tokens, drops the rows that emitted EOS and gathers the live
    lanes into the smallest 8-multiple batch bucket, whose step has its own
    scratch; rows are independent, so the surviving rows' tokens equal the
    uncompacted walk. Afterwards each row is EOS-filled from its first EOS.
    Returns ((B, max_new_tokens) int32 numpy tokens, final cache)."""
    batch = prompt_logits.shape[0]
    step = server.step_for(batch)
    tok = prompt_logits[:, -1].argmax(dim=-1).to(torch.int32)

    fill = eos_token_id if eos_token_id >= 0 else 0
    out = np.full((batch, max_new_tokens), fill, np.int32)
    cur_rows = np.arange(batch)  # original row of each live lane
    seg_start = 0
    toks_seg = [tok]
    for i in range(1, max_new_tokens + 1):
        if i < max_new_tokens:
            tok, cache = step(cache, tok[:, None])
            toks_seg.append(tok)
        boundary = eos_token_id >= 0 and i % compact_every == 0
        if i < max_new_tokens and not boundary:
            continue
        seg = torch.stack(toks_seg, dim=1).cpu().numpy()[: len(cur_rows)]
        out[cur_rows[:, None], seg_start + np.arange(seg.shape[1])[None]] = seg
        seg_start += seg.shape[1]
        toks_seg = []
        if i >= max_new_tokens:
            break
        done = (out[:, :seg_start] == eos_token_id).any(axis=1)
        if done.all():
            break
        lane_live = np.nonzero(~done[cur_rows])[0]
        bucket = max(8, -(-len(lane_live) // 8) * 8)
        if bucket < len(cur_rows):
            pad = np.full(bucket - len(lane_live), lane_live[0])
            gidx = torch.as_tensor(np.concatenate([lane_live, pad]), dtype=torch.long,
                                   device=tok.device)
            cache = compact_cache(cache, gidx)
            tok = tok.index_select(0, gidx)
            cur_rows = cur_rows[lane_live]
            step = server.step_for(bucket)
    for b in range(batch):
        hits = np.nonzero(out[b] == eos_token_id)[0]
        if hits.size:
            out[b, hits[0]:] = eos_token_id
    return out, cache

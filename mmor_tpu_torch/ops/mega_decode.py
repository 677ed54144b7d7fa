"""Decode megakernel: every decoder layer of one decode position in one call.

Counterpart of ``mmor_tpu/ops/mega_decode.py`` for int8 or int4 weights
(``wbits``) and an int8 or int4 KV cache (``kvbits``), all four pairs, with
its piggyback-prefill (``pf``) rows:

- ``mega_decode_layers`` is K5. On the card one C entry point
  (``csrc/mega_decode.cu``) runs all L layers, enqueueing a fixed sequence of
  hand-written kernels per layer; on the CPU ``mega_decode_layers_plain`` runs
  the same arithmetic chain, that of ``mega_decode_layers_reference``
  (``mega_decode.py:1386-1589``).
- ``pf`` carries c prompt rows of one stream of the next batch through every
  matmul of the step, after the B decode rows (the TPU layout's gap rows
  exist for its sublane tiling and have no counterpart here), plus a causal
  attention of the chunk against that stream's working cache
  (``ops/mega_overlap.py``). The chunk width and the working cache's
  capacity T2 are the shapes of the ``pf`` tensors; the TPU tiling
  (``MegaGeometry``) has no counterpart.
- The weights are the per-layer fused ``qkv_proj`` / ``o_proj`` /
  ``gate_up_proj`` / ``down_proj`` packed stacks the prefill reads
  (``MegaWeights``), walked in place: int4 (K/8, N) words with (K/ck, N)
  scales, or int8 (K/4, N) words with (N,) per-channel scales, which apply
  after the chunk folds (W8A8). The TPU package's tapes (``build_tapes``)
  and its tiling fields exist for Mosaic and have no counterpart here; the
  fused ``gate_up`` is ``[gate + pad | up + pad]``, so gate column j pairs
  with up column j.
- The KV caches are the port's own layouts, with (L, B, H, T) bf16
  per-position scales: int8 (L, B, H, T, Dh), the per-op path's cache, where
  the TPU package D-packs keys and T-packs values; int4 (L, B, H, T, Dh/2)
  uint8, two biased head-dim values a byte (low nibble = even channel). The
  cache's last axis tells the widths apart (``kv_bits_of``). The decode
  write of a position is a plain store (``apply_kv_update``), where the TPU
  layouts share each word with other positions.
- ``MegaServer``, ``make_mega_decode_step``, ``compact_cache`` and
  ``greedy_decode_hostloop_mega`` (EOS compaction into 8-multiple batch
  buckets every 64 steps) mirror the JAX serving loop.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from mmor_tpu_torch.config import LlamaConfig, pick_ck
from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops import quantized_matmul as qmm

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mega_granule(cfg: LlamaConfig) -> int:
    """The column granule of the megakernel's caches (the decode cache's
    capacity and the pf working cache's T2): 256 for an int4 KV cache, 128
    for an int8 one. Constraints of the TPU kernel's lane tiling
    (``mega_decode.py:200-215``, ``inference.py:101-105``, ``mm2sg.py:506``),
    kept so that capacities and step counts equal the JAX package's; the
    CUDA kernels need neither."""
    return 256 if cfg.kv_bits == 4 else 128


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


def kv_bits_of(k: torch.Tensor, head_dim: int) -> int:
    """The width of a K/V stack from its last axis: Dh int8 values, or Dh/2
    bytes of int4 nibble pairs (the JAX package tells its widths apart by
    the packed axis, ``mega_decode.py:1621``)."""
    if k.shape[-1] == head_dim:
        return 8
    if 2 * k.shape[-1] == head_dim:
        return 4
    raise ValueError(f"a K/V stack's last axis {k.shape[-1]} is neither the head "
                     f"dim {head_dim} (int8) nor half of it (int4)")


def kv_values(k: torch.Tensor, bits: int) -> torch.Tensor:
    """A K/V stack's signed values (..., Dh): the int8 stack itself, or the
    unpacked int4 nibble pairs."""
    return k if bits == 8 else unpack_kv_int4(k)


def apply_kv_update(cache: dict, knew, knew_s, vnew, vnew_s) -> dict:
    """Write the step's new K/V column at ``write_pos`` and advance the
    masks (``mega_decode.py:1607-1677``). An int8 cache stores the kernel's
    int8 column and its scale in bf16. An int4 cache takes the column
    requantized to the int4 grid as clip(round(k8 * f32(7/127)), +-7) with
    the scale times f32(127/7) stored in bf16. The cache stacks are updated
    in place; the returned dict carries the new positions."""
    wp = cache["write_pos"]
    bits = kv_bits_of(cache["k"], knew.shape[-1])
    for name, q8, s8 in (("k", knew, knew_s), ("v", vnew, vnew_s)):
        if bits == 8:
            cache[name][:, :, :, wp] = q8
            cache[name + "_s"][:, :, :, wp] = s8.to(torch.bfloat16)
            continue
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
    words and scales of the slots in ``_SLOTS`` order (the ``LlamaModel``'s
    own buffers, not copies): at ``wbits`` 4, (K/8, N) int32 words and
    (K/group, N) f32 scales; at ``wbits`` 8, (K/4, N) int32 words and (N,)
    f32 per-channel scales. ``norms`` (L, 2, D) f32 are the attention and
    MLP RMSNorm scales; ``group`` is the activation K-chunk ``pick_ck``,
    which is also the int4 scale group; ``ffn`` the padded MLP width."""

    layers: list[list[torch.Tensor]]
    norms: torch.Tensor
    group: int
    ffn: int
    heads: int
    wbits: int = 4

    @classmethod
    def from_model(cls, lm) -> "MegaWeights":
        cfg = lm.cfg
        if not (cfg.fused_qkv and cfg.weight_quant):
            raise ValueError("the megakernel walks fused int8 or int4 weights")
        layers = [[getattr(getattr(b, mod), leaf) for b in lm.blocks] for mod, leaf in _SLOTS]
        norms = torch.stack([torch.stack([b.attn_norm.scale, b.mlp_norm.scale])
                             for b in lm.blocks]).detach().float()
        group = cfg.weight_group if cfg.weight_bits == 4 else pick_ck(cfg)
        return cls(layers, norms, group, cfg.ffn_dim + cfg.ffn_pad, cfg.n_heads,
                   cfg.weight_bits)

    def pointer_table(self) -> ctypes.Array:
        """Host array of the device pointers, slot-major (slot * L + layer),
        after checking every tensor's device, dtype and shape."""
        n_layers, _, dim = self.norms.shape
        device, g = self.norms.device, self.group
        shapes = ((dim, 3 * dim), (dim, dim), (dim, 2 * self.ffn), (self.ffn, dim))
        if self.norms.dtype != torch.float32 or len(self.layers) != 2 * len(shapes):
            raise ValueError("MegaWeights: norms must be f32 (L, 2, D), with 8 weight slots")
        if self.wbits not in (4, 8):
            raise ValueError(f"MegaWeights: wbits {self.wbits}, not 4 or 8")
        for i, (k, n) in enumerate(shapes):
            words = (k // 8, n) if self.wbits == 4 else (k // 4, n)
            scales = (k // g, n) if self.wbits == 4 else (n,)
            for want, dtype, slot in ((words, torch.int32, self.layers[2 * i]),
                                      (scales, torch.float32, self.layers[2 * i + 1])):
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


def _w8a8_chunks(q: torch.Tensor, rs: torch.Tensor, w_p: torch.Tensor,
                 scale: torch.Tensor, chunk: int) -> torch.Tensor:
    """Int-valued activations q (rows, K) with per-(row, chunk) scales rs
    (rows, K/chunk) times one layer's int8 weights: each chunk's exact dot
    times its row scale, folded in chunk order as acc += dot * rs, then the
    per-channel scale (``mega_decode.py:1442-1444``, the kernel's order in
    ``csrc/w8a8.cuh``)."""
    w8 = qmm.unpack_int8_rows(w_p).double()
    acc = torch.zeros(q.shape[0], w_p.shape[1], dtype=torch.float32, device=q.device)
    for c in range(q.shape[1] // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        dot = (q[:, rows].double() @ w8[rows]).float()
        acc = acc + dot * rs[:, c:c + 1]
    return acc * scale[None, :]


# --------------------------------------------------------- the weight core
# csrc/mega_core.cuh's constants: its epilogues in order, a TMA box's word
# columns, a stage's word rows, consumer warps a block, ring stages, a
# block's shared memory; the H100's SMs, an SM's shared memory and what it
# reserves a block
CORE_EPILOGUES = ("store", "resid", "swiglu")
CORE_BOX_COLS, CORE_STAGE_WORDS, CORE_WARPS, CORE_MAX_STAGES = 32, 32, 9, 24
CORE_UNIT_WARPS, CORE_MAX_RANKS = 4, 8
CORE_SMEM, CORE_SMS, SM_SMEM, SM_BLOCK_RESERVE = 232448, 132, 233472, 1024


@dataclass(frozen=True)
class CorePlan:
    """The tiling of one launch of K5's weight core (``csrc/mega_core.cuh``).
    A block owns a strip of ``boxes`` 32-column word boxes (the SwiGLU
    phase: 32 gate columns and the 32 up columns that pair with them) and
    walks all of K once for the
    ``slab_rows`` rows of its slab. K falls into units of ``unit_k`` rows, a
    weight group at int4 and whole chunks at int8, which one warp folds at
    once. The block's consumer warps form ``wr`` row sets of ``gw`` 8-row
    groups, and each row set ``wu`` warps that take its units in turn (the
    ring carries a stage of each of a round's ``wu`` units in turn, each
    unit warp's into a sub-ring of ``stages / wu`` slots of its own); a row
    set's units fold in unit order. A ring stage is ``stage_rows`` word rows
    of each box and their activation bytes, taken in 32-k steps of 32 word
    rows; ``slots`` is the number of chunk dots a warp keeps in its table
    until its unit folds. With ``ranks`` > 1 a cluster of that many blocks
    takes each strip, rank r the r-th of ``ranks`` runs of units in K order,
    and rank 0 adds every rank's chunk terms in chunk order. The C entry
    points take ``c_args``."""

    n: int
    k: int
    chunk: int
    rows: int
    wbits: int
    epi: str
    group: int
    boxes: int
    strips: int
    gw: int
    wr: int
    wu: int
    slab_rows: int
    slabs: int
    stages: int
    stage_rows: int
    unit_k: int
    slots: int
    smem: int
    ranks: int

    @property
    def c_args(self) -> tuple[int, ...]:
        return (self.gw, self.wr, self.wu, self.slab_rows, self.stages, self.stage_rows,
                self.unit_k, self.ranks)


@functools.lru_cache(maxsize=None)
def core_plan(n: int, k: int, chunk: int, rows: int, wbits: int, epi: str,
              group: int | None = None, ranks: int | None = None) -> CorePlan:
    """The launch of K5's weight core for R = ``rows`` activation rows times
    a (K, N) weight, chunk-quantized activations, epilogue ``epi``
    ("store", "resid" or "swiglu"). Raises ValueError for what the kernel
    does not take: at int4 K % 256, group % 256, K % group, chunk % 128,
    and chunk == group or, with "resid", (group / 2) % chunk; at int8 K %
    128, chunk % 128, K % chunk; an odd N for SwiGLU; ``ranks`` (the
    blocks of a cluster that split K) outside 1-8 or above the units.
    ``ranks`` None: 2 for the int4 down projection at up to 8 rows, 1
    elsewhere (see below).

    The o and down phases take one 32-column box a block (N = 4096 still
    gives 128 blocks), qkv two and gate_up a gate and an up box. Up to 16
    rows are one row set (8-row groups gw = 1 or 2) whose four warps take
    the units in turn; up to 32 rows two sets whose two warps each take
    their units in turn; more rows sets of two groups, up to 144 rows
    (nine sets) a slab, past which the grid's slabs each stream the weights
    again. A stage is 16 KB of words (128 word rows of one box, 64 of two)
    up to 32 rows and 32 word rows past that (the activations fill the
    stage), fewer where a unit holds fewer; an int8 unit is the least
    multiple of the chunk that fills whole stages and divides K. The ring
    takes the shared memory that the blocks resident on an SM leave each
    other (an SM holds the grid in ceil(blocks / 132) rounds, at most 4
    blocks of up to 4 row groups, else 1; an SM has 228 KB and reserves 1
    KB a block): the most unit warps whose sub-rings fit it, 1 to 24
    stages a unit warp's sub-ring (2 at least where one warp takes every
    unit), at most 24 in all. Its shared memory also stages the slab's
    chunk scales and the block's weight scales, which the folds read."""
    if epi not in CORE_EPILOGUES:
        raise ValueError(f"core_plan: epilogue {epi!r}, not one of {CORE_EPILOGUES}")
    if wbits == 4:
        if group is None or k % 256 or group % 256 or k % group or chunk % 128:
            raise ValueError(f"core_plan: int4 needs K % 256, group % 256, K % group and "
                             f"chunk % 128 (K={k}, group={group}, chunk={chunk})")
        if chunk != group and (epi != "resid" or (group // 2) % chunk):
            raise ValueError(f"core_plan: an int4 chunk ({chunk}) is the group ({group}), or "
                             "divides its half with the residual epilogue")
    elif wbits == 8:
        if k % 128 or chunk % 128 or k % chunk:
            raise ValueError(f"core_plan: int8 needs K % 128, chunk % 128 and K % chunk "
                             f"(K={k}, chunk={chunk})")
        group = chunk  # not read: the scales are per channel
    else:
        raise ValueError(f"core_plan: wbits {wbits}, not 4 or 8")
    if rows < 1 or n < 1 or (epi == "swiglu" and n % 2):
        raise ValueError(f"core_plan: {rows} rows, N {n} ({epi})")
    groups = -(-rows // 8)
    gw = min(groups, 2)
    slab_groups = min(groups, gw * CORE_WARPS)
    slabs = -(-groups // slab_groups)
    wr = -(-slab_groups // gw)
    boxes = 1 if epi == "resid" else 2
    out_cols = n // 2 if epi == "swiglu" else n
    strips = -(-out_cols // (CORE_BOX_COLS if epi == "swiglu" else boxes * CORE_BOX_COLS))
    stage_rows = 128 // boxes if slab_groups <= 4 else CORE_STAGE_WORDS
    if wbits == 4:
        while (group // 8) % stage_rows:
            stage_rows //= 2
        unit_k = group
    else:
        unit_k = math.lcm(chunk, 4 * stage_rows)
        while k % unit_k:
            stage_rows //= 2
            unit_k = math.lcm(chunk, 4 * stage_rows)
    units = k // unit_k
    if ranks is None:
        # K split across a cluster against one block a strip, the narrow
        # phases at R = 8 (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3 at
        # 700 W, ms): int4 down 0.0139 / 2 ranks 0.0119 / 3 0.0188, int4 o
        # 0.0096 / 0.0105 / 4 ranks 0.0188, int8 down 0.0220 / 0.0225 /
        # 0.0217, int8 o 0.0121 / 0.0119 / 0.0216: only the int4 down phase
        # (whole-group chunks, the residual) gains beyond the timing's spread;
        # in the int4 K5 step (phase 5, one call) 2 ranks there took K5's
        # kernels from 3.907-3.909 ms a step to 3.830-3.835
        ranks = 2 if wbits == 4 and epi == "resid" and chunk == group and rows <= 8 else 1
    if not 1 <= ranks <= min(CORE_MAX_RANKS, units):
        raise ValueError(f"core_plan: {ranks} ranks for {units} units of K")
    frag = boxes * 2 * gw * 4 * 32 * 4  # a warp's accumulators, in bytes
    scales = 8 * slab_groups * (k // chunk) + boxes * CORE_BOX_COLS * (k // group if wbits == 4 else 1)
    stage = (boxes * stage_rows * CORE_BOX_COLS * 4
             + (2 if wbits == 4 else 1) * (stage_rows // CORE_STAGE_WORDS) * 8 * slab_groups * 128)
    lpu = unit_k // (stage_rows * (4 if wbits == 8 else 8))  # ring loads a unit
    resident = min(-(-strips * slabs * ranks // CORE_SMS), 4 if wr * gw <= 4 else 1)
    rank_units = -(-units // ranks)  # the most units a rank takes
    # Warps that split the units store the chunks' terms and fill sub-rings
    # of their own: the most unit warps (4, 2, then 1) whose sub-rings
    # fit the share of an SM's shared memory that lets every resident block
    # run at once (one stage a warp; two where one warp takes every unit,
    # its rows' every stage, so that a load overlaps the products)
    for wu in sorted({w for w in (4, 2, 1)
                      if w <= min(CORE_WARPS // wr, CORE_UNIT_WARPS, units // ranks)} | {1},
                     reverse=True):
        lazy = wu > 1 or ranks > 1  # chunk terms, added in order at the end
        slots = group // 2 // chunk if (wbits == 4 and chunk != group and not lazy) else 0
        fixed = (1024 + wr * wu * slots * frag
                 + (wr * (k // chunk) * frag if lazy else 0) + 4 * scales)
        budget = min(CORE_SMEM, SM_SMEM // resident - SM_BLOCK_RESERVE) - fixed
        per_warp = -(-rank_units // wu) * lpu
        least = min(per_warp, 2 if wu == 1 else 1)
        if budget // (stage + 16) // wu >= least:
            break
    stages = wu * min(CORE_MAX_STAGES // wu, per_warp, max(least, budget // (stage + 16) // wu))
    smem = fixed + stages * (stage + 16)
    if smem > CORE_SMEM:
        raise ValueError(f"core_plan: {smem} bytes of shared memory at {rows} rows")
    return CorePlan(n, k, chunk, rows, wbits, epi, group, boxes, strips, gw, wr, wu,
                    8 * slab_groups, slabs, stages, stage_rows, unit_k, slots, smem, ranks)


def _core_epilogue(acc: torch.Tensor, epi: str, resid: torch.Tensor | None) -> torch.Tensor:
    """The weight core's epilogues on the folded f32 sums (K5's phases)."""
    if epi == "store":
        return acc
    if epi == "resid":
        return resid + acc
    f = acc.shape[1] // 2
    gate, up = acc[:, :f], acc[:, f:]
    return gate * torch.sigmoid(gate) * up


def mega_project_plain(q: torch.Tensor, rs: torch.Tensor, w_p: torch.Tensor,
                       scale: torch.Tensor, *, wbits: int, chunk: int, group: int | None = None,
                       epi: str = "store", resid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K5 weight phase: ``_w4a8_chunks`` or ``_w8a8_chunks``
    (the chain ``mega_decode_layers_plain`` runs), then the epilogue."""
    if wbits == 4:
        acc = _w4a8_chunks(q, rs, w_p, scale, group, chunk)
    else:
        acc = _w8a8_chunks(q, rs, w_p, scale, chunk)
    return _core_epilogue(acc, epi, resid)


def mega_project(q: torch.Tensor, rs: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                 *, wbits: int, chunk: int, group: int | None = None, epi: str = "store",
                 resid: torch.Tensor | None = None, ranks: int | None = None) -> torch.Tensor:
    """K5's weight core alone, one matmul phase of the megakernel: int8
    activations q (R, K) with per-(row, chunk) f32 scales rs (R, K/chunk)
    times one layer's int4 words (K/8, N) with (K/group, N) scales, or int8
    words (K/4, N) with (N,) scales; ``epi`` "store" returns the (R, N) f32
    sums, "resid" adds ``resid`` (R, N) f32, "swiglu" returns (R, N/2)
    silu(gate) * up of the paired columns. CPU: ``mega_project_plain``.
    CUDA: the ``mmor_mega_project`` entry point at ``core_plan``'s tiling
    (``ranks``: the blocks of a cluster that split K, None for the plan's
    choice), bit for bit the plain
    version's; counts ``mega_project.launches``."""
    if q.device.type == "cpu":
        return mega_project_plain(q, rs, w_p, scale, wbits=wbits, chunk=chunk, group=group,
                                  epi=epi, resid=resid)
    if q.device.type != "cuda":
        raise ValueError(f"mega_project: q is on {q.device}")
    m, k = q.shape
    n = w_p.shape[-1]
    plan = core_plan(n, k, chunk, m, wbits, epi, group, ranks)
    words = (k // 8, n) if wbits == 4 else (k // 4, n)
    scales = (k // plan.group, n) if wbits == 4 else (n,)
    operands = [("q", q, torch.int8, (m, k)), ("rs", rs, torch.float32, (m, k // chunk)),
                ("w_p", w_p, torch.int32, words), ("scale", scale, torch.float32, scales)]
    if epi == "resid":
        if resid is None:
            raise ValueError("mega_project: the residual epilogue needs resid")
        operands.append(("resid", resid, torch.float32, (m, n)))
    _check_operands("mega_project", q.device, operands)
    out = torch.empty(m, n // 2 if epi == "swiglu" else n, dtype=torch.float32,
                      device=q.device)
    p = _build.ptr
    err = _build.library().mmor_mega_project(
        p(q), p(rs), p(w_p), p(scale), p(resid) if epi == "resid" else None, p(out), m, k, n,
        plan.group, chunk, wbits, CORE_EPILOGUES.index(epi), *plan.c_args, _build.stream())
    _build.check(err, "mega_project")
    mega_project.launches += 1
    return out


mega_project.launches = 0


def core_plans(weights: "MegaWeights", rows: int) -> tuple[CorePlan, ...]:
    """The four weight phases' plans of a K5 call over ``rows`` rows: qkv
    (f32 store), o (per-head chunks, residual), gate_up (SwiGLU) and down
    (residual)."""
    return _core_plans(weights.norms.shape[-1], weights.ffn, weights.heads, weights.group,
                       weights.wbits, rows)


@functools.lru_cache(maxsize=None)
def _core_plans(dim: int, f: int, heads: int, ck: int, wbits: int,
                rows: int) -> tuple[CorePlan, ...]:
    phases = ((3 * dim, dim, ck, "store"), (dim, dim, dim // heads, "resid"),
              (2 * f, dim, ck, "swiglu"), (dim, f, ck, "resid"))
    return tuple(core_plan(n, k, c, rows, wbits, epi, ck) for n, k, c, epi in phases)


@functools.lru_cache(maxsize=None)
def _plan_array(dim: int, f: int, heads: int, ck: int, wbits: int, rows: int) -> ctypes.Array:
    """The four plans' ``c_args`` as the C entry point's 32 ints (read only)."""
    plans = _core_plans(dim, f, heads, ck, wbits, rows)
    return (ctypes.c_int * 32)(*(v for plan in plans for v in plan.c_args))


def _rmsnorm(x: torch.Tensor, norm: torch.Tensor, eps: float) -> torch.Tensor:
    """x * r * norm with r = 1 / sqrt(mean(x^2) + eps) taken in double (as
    the kernel does), so the f32 result does not depend on the sum's order."""
    eps32 = float(torch.tensor(eps, dtype=torch.float32))  # the kernel's f32 eps
    r = torch.rsqrt((x.double() ** 2).mean(dim=-1, keepdim=True) + eps32).float()
    return x * r * norm


def _attention_plain(q8, qs, k8, ks_cur, vcur, k_int, ks, v_int, vs, mask, sums):
    """One layer's attention, ``mega_decode.py:1522-1534``: int8 queries
    (B, H, dh) with scales qs (B, H, 1) against the int8 or int4 cache values
    (B, H, T, dh) with scales (B, H, T), and the current token's term inline:
    its logit is the exact int8 dot q8 . k8 times ks_cur and qs (the
    reference sums q8 * (k8 * ks_cur), equal up to f32 rounding), its value
    vcur dequantized. The softmax's exps and its sum are taken in ``sums``
    (f32 at int4, double at int8, as the kernel does) and rounded to f32.
    Returns (B, H, dh) f32."""
    logits = torch.einsum("bhd,bhtd->bht", q8.double(), k_int.double()).float()
    logits = logits * qs * ks
    logits = torch.where(mask[:, None, :] != 0, logits, NEG_INF)
    lcur = (q8 * k8).sum(dim=-1, keepdim=True) * ks_cur * qs
    mmax = torch.maximum(logits.amax(dim=-1, keepdim=True), lcur)
    w = torch.exp((logits - mmax).to(sums)).float()
    wc = torch.exp((lcur - mmax).to(sums)).float()
    denom = (w.to(sums).sum(dim=-1, keepdim=True) + wc.to(sums)).float()
    w8, wrs = _quant_rows_f32(w * vs)
    ov = torch.einsum("bht,bhtd->bhd", w8.double(), v_int.double()).float() * wrs
    return (ov + wc * vcur) / denom


def _chunk_attention_plain(q8, qs, k8, ks, vcur, k_int, k_s, v_int, v_s, mask, amask,
                           sums):
    """The pf chunk's attention, ``mega_decode.py:1536-1560``: int8 queries
    (c, H, dh) with scales qs (c, H, 1) against the stream's working cache
    (int8 or int4 values (H, T2, dh), scales (H, T2)) where ``mask`` (T2,) is
    set, plus an inline causal block over the chunk's own columns j <= i
    with ``amask[j]`` set: its logits are the exact int8 dots q8_i . k8_j
    times ks_j and qs_i (as the decode rows' current-token term), its values
    the exact dequantized vcur (c, H, dh). One softmax over both parts, its
    exps and sums in ``sums`` (as ``_attention_plain``); the working-cache
    weights times the value scales quantize to int8 per (row, head), the
    inline weights stay f32 (their sum with the values in ``sums``).
    Returns (c, H, dh) f32."""
    c = q8.shape[0]
    lg = torch.einsum("chd,htd->cht", q8.double(), k_int.double()).float()
    lg = torch.where(mask[None, None, :] != 0, lg * qs * k_s[None], NEG_INF)
    dot = torch.einsum("ihd,jhd->ihj", q8.double(), k8.double()).float()
    li = dot * ks[:, :, 0].t()[None] * qs
    j = torch.arange(c, device=q8.device)
    visible = (j[None, :] <= j[:, None]) & (amask[None, :] != 0)  # (i, j)
    li = torch.where(visible[:, None, :], li, NEG_INF)
    mmax = torch.maximum(lg.amax(dim=-1, keepdim=True), li.amax(dim=-1, keepdim=True))
    w = torch.exp((lg - mmax).to(sums)).float()
    wi = torch.exp((li - mmax).to(sums)).float()
    denom = (w.to(sums).sum(dim=-1, keepdim=True)
             + wi.to(sums).sum(dim=-1, keepdim=True)).float()
    w8, wrs = _quant_rows_f32(w * v_s[None])
    ov = torch.einsum("cht,htd->chd", w8.double(), v_int.double()).float() * wrs
    ovi = torch.einsum("ihj,jhd->ihd", wi.to(sums), vcur.to(sums)).float()
    return (ov + ovi) / denom


def mega_decode_layers_plain(x: torch.Tensor, weights: MegaWeights, cache: dict,
                             cos: torch.Tensor, sin: torch.Tensor, *,
                             eps: float = 1e-5, sm_scale: float | None = None,
                             pf: dict | None = None):
    """Plain PyTorch K5: the arithmetic chain of
    ``mega_decode_layers_reference`` with the kernel's fold order, at the
    weights' width (``weights.wbits``) and the cache's (``kv_bits_of``); at
    an int8 cache the softmax's exps and sums are taken in double and
    rounded to f32, as the kernel takes them, so the two agree whatever the
    order of their sums.
    Weights and the cache dequantize one layer at a time: the whole 7B stack
    in f32 would take ~26 GB (``mega_decode.py:1424-1427``). Returns (x_out
    (B, D) bf16, knew (L, B, H, dh) int8, knew_s (L, B, H) f32, vnew,
    vnew_s).

    ``pf`` (the reference's dict): x (c, D) bf16 chunk embeddings, cos/sin
    (c, dh) at the chunk's positions, amask (c,) int32, mask (T2,) int32 (the
    working-cache columns the chunk sees), and the stream's working cache k/v
    (L, H, T2, dh) int8 or (L, H, T2, dh/2) uint8, the decode cache's width,
    with k_s/v_s (L, H, T2) bf16. The chunk rows ride
    the row-wise chain after the decode rows (``_chunk_attention_plain``), so
    the decode rows' outputs do not change; a sixth element
    dict(x (c, D) bf16, knew/vnew (L, c, H, dh) int8, knew_s/vnew_s (L, c, H)
    f32) carries the chunk's."""
    b, dim = x.shape
    n_layers, _, heads, t_cap, _ = cache["k"].shape
    dh = dim // heads
    ck, half = weights.group, dh // 2
    kvbits = kv_bits_of(cache["k"], dh)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    x, cos, sin = x.float(), cos.float(), sin.float()
    if pf is not None:
        x = torch.cat([x, pf["x"].float()])
        cos = torch.cat([cos, pf["cos"].float()])
        sin = torch.cat([sin, pf["sin"].float()])
    rows = x.shape[0]
    cosr, sinr = cos[:, None, :], sin[:, None, :]

    def rope(t):  # (rows, H, dh)
        return t * cosr + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sinr

    def chunk_quant(h):
        q, rs = _quant_rows_f32(h.reshape(rows, -1, ck))
        return q.reshape(rows, -1), rs[..., 0]

    def matmul(q, rs, w_p, scale, chunk=ck):
        if weights.wbits == 4:
            return _w4a8_chunks(q, rs, w_p, scale, ck, chunk)
        return _w8a8_chunks(q, rs, w_p, scale, chunk)

    def values(t):
        return kv_values(t, kvbits).float()

    sums = torch.float64 if kvbits == 8 else torch.float32  # the kernel's softmax sums

    knews, knew_ss, vnews, vnew_ss = [], [], [], []
    for li in range(n_layers):
        wq, sq, wo, so, wg, sg, wd, sd = (slot[li] for slot in weights.layers)
        h = _rmsnorm(x, weights.norms[li, 0], eps)
        qkv = matmul(*chunk_quant(h), wq, sq).reshape(rows, 3, heads, dh)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        q8, qs = _quant_rows_f32(q * sm_scale)
        k8, ks = _quant_rows_f32(k)
        v8, vs = _quant_rows_f32(v)
        vcur = v8 * vs
        knews.append(k8)
        knew_ss.append(ks[..., 0])
        vnews.append(v8)
        vnew_ss.append(vs[..., 0])
        attn = _attention_plain(
            q8[:b], qs[:b], k8[:b], ks[:b], vcur[:b],
            values(cache["k"][li]), cache["k_s"][li].float(),
            values(cache["v"][li]), cache["v_s"][li].float(), cache["kv_mask"], sums)
        if pf is not None:
            attn = torch.cat([attn, _chunk_attention_plain(
                q8[b:], qs[b:], k8[b:], ks[b:], vcur[b:],
                values(pf["k"][li]), pf["k_s"][li].float(),
                values(pf["v"][li]), pf["v_s"][li].float(), pf["mask"],
                pf["amask"], sums)])
        a8, ars = _quant_rows_f32(attn)  # per (row, head)
        x2 = x + matmul(a8.reshape(rows, dim), ars[..., 0], wo, so, dh)
        h2 = _rmsnorm(x2, weights.norms[li, 1], eps)
        gu = matmul(*chunk_quant(h2), wg, sg)
        gate, up = gu[:, :weights.ffn], gu[:, weights.ffn:]
        m = gate * torch.sigmoid(gate) * up
        x = x2 + matmul(*chunk_quant(m), wd, sd)
    cols = (torch.stack(knews).to(torch.int8), torch.stack(knew_ss),
            torch.stack(vnews).to(torch.int8), torch.stack(vnew_ss))
    out = (x[:b].to(torch.bfloat16), *(t[:, :b].contiguous() for t in cols))
    if pf is None:
        return out
    knew, knew_s, vnew, vnew_s = (t[:, b:].contiguous() for t in cols)
    return out + (dict(x=x[b:].to(torch.bfloat16), knew=knew, knew_s=knew_s, vnew=vnew,
                       vnew_s=vnew_s),)


# ------------------------------------------------------------------- kernel
def alloc_scratch(weights: MegaWeights, rows: int, device) -> dict:
    """The intermediate buffers K5's kernels pass between phases, for
    ``rows`` activation rows (the batch, plus the chunk with ``pf``), at
    either weight width (both quantize activations per (row, K-chunk))."""
    dim = weights.norms.shape[-1]
    width = max(dim, weights.ffn)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        x_res=torch.empty(rows, dim, **f32), x2=torch.empty(rows, dim, **f32),
        hq=torch.empty(rows, width, dtype=torch.int8, device=device),
        hrs=torch.empty(rows, width // weights.group, **f32),
        qkv=torch.empty(rows, 3 * dim, **f32),
        a8=torch.empty(rows, dim, dtype=torch.int8, device=device),
        ars=torch.empty(rows, weights.heads, **f32),
        mbuf=torch.empty(rows, weights.ffn, **f32))


def _check_operands(what: str, device, operands) -> None:
    """Each (name, tensor, dtype, shape) must be a contiguous tensor of that
    dtype and shape on ``device``."""
    for name, t, dtype, shape in operands:
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def mega_decode_layers(x: torch.Tensor, weights: MegaWeights, cache: dict,
                       cos: torch.Tensor, sin: torch.Tensor, *, eps: float = 1e-5,
                       sm_scale: float | None = None, scratch: dict | None = None,
                       pointer_table: ctypes.Array | None = None, pf: dict | None = None):
    """K5: x (B, D) bf16 hidden states of one decode position through every
    decoder layer, against the int8 or int4 cache. Returns (x_out (B, D)
    bf16 before the final norm, knew (L, B, H, dh) int8, knew_s (L, B, H)
    f32, vnew, vnew_s); the caller owns the cache update
    (``apply_kv_update``). With ``pf`` (``mega_decode_layers_plain``'s dict)
    the chunk's rows ride along and a sixth element carries their outputs.

    CPU: ``mega_decode_layers_plain``. CUDA: the ``csrc/mega_decode.cu``
    entry point at the weights' and the cache's widths (head_dim 128, a
    K-chunk of at most 1024 that is a multiple of 256 for int4 weights and of
    128 for int8 ones, at most 8 chunks a model row), with ``scratch`` from
    ``alloc_scratch`` for B (+ c) rows and the weights' ``pointer_table``
    made here when not given. The cache's dtype must match its width (int8,
    or uint8 nibble pairs). Counts its launches by variant: int4 weights and
    cache in ``mega_decode_layers.launches`` (K5) and, with pf rows,
    ``pf_launches`` (K5-pf); any int8 width in ``int8_launches`` (K5-int8)
    and ``int8_pf_launches`` (K5-int8 with pf rows)."""
    if x.device.type == "cpu":
        return mega_decode_layers_plain(x, weights, cache, cos, sin, eps=eps,
                                        sm_scale=sm_scale, pf=pf)
    if x.device.type != "cuda":
        raise ValueError(f"mega_decode_layers: x is on {x.device}")
    b, dim = x.shape
    n_layers, cb, heads, t_cap, kv_last = cache["k"].shape
    dh = dim // heads
    kvbits = kv_bits_of(cache["k"], dh)
    if (x.dtype != torch.bfloat16 or cb != b or dim != heads * dh
            or tuple(cos.shape) != (b, dh) or tuple(sin.shape) != (b, dh)
            or tuple(cache["kv_mask"].shape) != (b, t_cap)):
        raise ValueError(f"mega_decode_layers: x {tuple(x.shape)} {x.dtype}, cos/sin "
                         f"{tuple(cos.shape)} vs cache {tuple(cache['k'].shape)}")
    step = 256 if weights.wbits == 4 else 128
    if (dh != 128 or weights.group % step or weights.group > 1024
            or dim > 8 * weights.group):
        raise ValueError(f"mega_decode_layers: the kernel takes head_dim 128, a "
                         f"K-chunk of at most 1024 in steps of {step} and at most 8 "
                         f"chunks a model row (dh={dh}, group={weights.group}, dim={dim})")
    kv_dtype = torch.int8 if kvbits == 8 else torch.uint8
    for name, dtype in (("k", kv_dtype), ("v", kv_dtype), ("k_s", torch.bfloat16),
                        ("v_s", torch.bfloat16), ("kv_mask", torch.int32)):
        t = cache[name]
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"mega_decode_layers: cache[{name!r}] must be a contiguous "
                             f"{dtype} tensor on {x.device} (an int{kvbits} cache), got "
                             f"{t.dtype}")
    c = t2 = 0
    if pf is not None:
        c, t2 = pf["x"].shape[0], pf["mask"].shape[0]
        wshape = (n_layers, heads, t2, kv_last)
        _check_operands("mega_decode_layers pf", x.device, (
            ("x", pf["x"], torch.bfloat16, (c, dim)),
            ("cos", pf["cos"], torch.float32, (c, dh)),
            ("sin", pf["sin"], torch.float32, (c, dh)),
            ("amask", pf["amask"], torch.int32, (c,)),
            ("mask", pf["mask"], torch.int32, (t2,)),
            ("k", pf["k"], kv_dtype, wshape), ("v", pf["v"], kv_dtype, wshape),
            ("k_s", pf["k_s"], torch.bfloat16, wshape[:-1]),
            ("v_s", pf["v_s"], torch.bfloat16, wshape[:-1])))
        if c < 1 or t2 < 1:
            raise ValueError(f"mega_decode_layers: pf chunk {c} and working cache {t2} "
                             "must be non-empty")
    rows = b + c
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    if scratch is None:
        scratch = alloc_scratch(weights, rows, x.device)
    if scratch["x_res"].shape != (rows, dim) or scratch["hq"].device != x.device:
        raise ValueError(f"mega_decode_layers: scratch for {rows} rows on {x.device} "
                         "expected (alloc_scratch)")
    if pointer_table is None:
        pointer_table = weights.pointer_table()
    plans = _plan_array(weights.norms.shape[-1], weights.ffn, weights.heads, weights.group,
                        weights.wbits, rows)
    x, cos, sin = _build.aligned(x), _build.aligned(cos.float()), _build.aligned(sin.float())
    dev = dict(device=x.device)
    x_out = torch.empty(b, dim, dtype=torch.bfloat16, **dev)
    knew = torch.empty(n_layers, b, heads, dh, dtype=torch.int8, **dev)
    vnew = torch.empty_like(knew)
    knew_s = torch.empty(n_layers, b, heads, dtype=torch.float32, **dev)
    vnew_s = torch.empty_like(knew_s)
    p = _build.ptr
    pf_in, pf_out = (0,) * 9, (0,) * 5
    if pf is not None:
        out = dict(x=torch.empty(c, dim, dtype=torch.bfloat16, **dev),
                   knew=torch.empty(n_layers, c, heads, dh, dtype=torch.int8, **dev),
                   knew_s=torch.empty(n_layers, c, heads, dtype=torch.float32, **dev))
        out.update(vnew=torch.empty_like(out["knew"]), vnew_s=torch.empty_like(out["knew_s"]))
        pf_ops = [_build.aligned(pf[k]) for k in ("x", "cos", "sin", "amask", "k", "k_s",
                                                  "v", "v_s", "mask")]
        pf_in = tuple(p(t) for t in pf_ops)
        pf_out = tuple(p(out[k]) for k in ("x", "knew", "knew_s", "vnew", "vnew_s"))
    err = _build.library().mmor_mega_decode(
        p(x), ctypes.addressof(pointer_table), p(weights.norms), p(cache["k"]),
        p(cache["k_s"]), p(cache["v"]), p(cache["v_s"]), p(cache["kv_mask"]), p(cos),
        p(sin), *(p(scratch[k]) for k in ("x_res", "x2", "hq", "hrs", "qkv", "a8",
                                          "ars", "mbuf")),
        p(x_out), p(knew), p(knew_s), p(vnew), p(vnew_s), *pf_in, *pf_out,
        ctypes.addressof(plans), n_layers, b,
        dim, heads, weights.ffn, t_cap, weights.group, c, t2, weights.wbits, kvbits,
        float(eps), float(sm_scale), _build.stream())
    _build.check(err, "mega_decode_layers")
    int8 = "int8_" if (weights.wbits, kvbits) != (4, 4) else ""
    counter = int8 + ("launches" if pf is None else "pf_launches")
    setattr(mega_decode_layers, counter, getattr(mega_decode_layers, counter) + 1)
    if pf is None:
        return x_out, knew, knew_s, vnew, vnew_s
    return x_out, knew, knew_s, vnew, vnew_s, out


mega_decode_layers.launches = 0
mega_decode_layers.pf_launches = 0
mega_decode_layers.int8_launches = 0
mega_decode_layers.int8_pf_launches = 0


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
        self.final_norm = lm.final_norm.scale.detach().float()
        self._steps: dict = {}

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final RMSNorm and the int8 lm_head (K2): hidden states (B, D) bf16
        -> logits (B, V)."""
        h = _rmsnorm(x.float(), self.final_norm, self.cfg.norm_eps).to(torch.bfloat16)
        return qmm.int8_matmul_packed(h, self.lm.lm_head.w_p, self.lm.lm_head.scale,
                                      int8_mxu=self.cfg.quant_int8_mxu)

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

    @torch.no_grad()
    def step(cache: dict, tok: torch.Tensor):
        x = lm.embed_tokens(tok[:, 0].long()).to(torch.bfloat16)
        cos, sin = rope_tables(cache["tok_pos"], cfg.head_dim, cfg.rope_theta)
        x, knew, knew_s, vnew, vnew_s = mega_decode_layers(
            x, weights, cache, cos, sin, eps=cfg.norm_eps, scratch=scratch,
            pointer_table=server.pointer_table)
        logits = server.head(x)
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

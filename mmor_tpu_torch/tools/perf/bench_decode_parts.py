"""A 7B decode step's two streams on the H100, each alone: the weights and the
KV cache.

Counterpart of ``tools/perf/bench_decode_parts.py``. ``BM_PART`` picks one:

- ``weights``: the seven projections of each of the L layers (q, k, v, o,
  gate, up, down) and the lm_head, as packed int8 weights through K2
  (``ops.quantized_matmul.int8_matmul_packed``, W8A8) at batch B, every
  weight read once a pass. The shapes are the port's ``LlamaConfig``
  defaults (LLaVA-1.5-7B).
- ``attn``: K7 (``ops.attention.decode_attention_packed``) once for each of
  the L layers, B rows, H heads, T cache positions, int8 K and V with f32
  per-position scales. Unlike the TPU script, which reads one cache for
  every layer, each layer reads a cache of its own (L distinct single-layer
  caches, about 3.9 GB at the defaults): one layer's cache (about 121 MB)
  would otherwise be served in part by the card's 50 MB L2 cache.

Each prints ms a pass (all L layers), GB/s of the bytes a pass must move and
their bound at the card's memory rate. Timing: ``timing.scan_ms``.

    BM_PART=attn python -m mmor_tpu_torch.tools.perf.bench_decode_parts

(``BM_B`` rows, default 14; ``BM_T`` cache positions, default 1024;
``BM_REPEATS`` passes, default 20.)
"""

from __future__ import annotations

import os

import torch

from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.ops.attention import decode_attention, decode_attention_packed
from mmor_tpu_torch.ops.quantized_matmul import (int8_matmul_packed, pack_int8_rows,
                                                 quantize_rows, unpack_int8_rows)
from mmor_tpu_torch.tools.perf.bench_w8a16 import SPOT_BOUND
from mmor_tpu_torch.tools.perf.timing import card, device_for, run, spot

B = int(os.environ.get("BM_B", "14"))
T = int(os.environ.get("BM_T", "1024"))
REPEATS = int(os.environ.get("BM_REPEATS", "20"))
PART = os.environ.get("BM_PART", "weights")
# K7 against decode_attention, which rounds the softmax weights and the
# output to bf16 where K7 keeps f32 until its output
ATTN_SPOT_BOUND = 2.0 ** -6


def projection_shapes(cfg: LlamaConfig) -> list[tuple[int, int]]:
    """(K, N) of a layer's q, k, v, o, gate, up and down projections."""
    d, hd, kv = cfg.dim, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return [(d, hd), (d, kv), (d, kv), (hd, d), (d, cfg.ffn_dim), (d, cfg.ffn_dim),
            (cfg.ffn_dim, d)]


def _packed_int8(k: int, n: int, dev, g) -> torch.Tensor:
    """Seeded int8 weights in [-127, 127], packed by ``pack_int8_rows``."""
    return pack_int8_rows(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                        dtype=torch.int8))


def weights_part(cfg: LlamaConfig, batch: int, repeats: int, dev, g) -> dict:
    shapes = projection_shapes(cfg)
    layers = [[(_packed_int8(k, n, dev, g), torch.full((n,), 0.01, device=dev))
               for k, n in shapes] for _ in range(cfg.n_layers)]
    head = (_packed_int8(cfg.dim, cfg.vocab_size, dev, g),
            torch.full((cfg.vocab_size,), 0.01, device=dev))
    x_big = torch.randn(batch, max(k for k, _ in shapes), generator=g,
                        device=dev).to(torch.bfloat16)
    xs = {k: x_big[:, :k].contiguous() for k, _ in shapes}

    xq, rs = quantize_rows(xs[cfg.dim])
    ref = (xq.float() * rs[:, None]) @ (unpack_int8_rows(head[0]).float() * head[1])
    errs = {"lm_head rel err vs dequant W8A8 ref": spot(
        "lm_head rel err vs dequant W8A8 ref", int8_matmul_packed(xs[cfg.dim], *head), ref,
        SPOT_BOUND)}

    def scan():
        for layer in layers:
            for (k, _), (w_p, s) in zip(shapes, layer):
                int8_matmul_packed(xs[k], w_p, s)
        int8_matmul_packed(xs[cfg.dim], *head)

    nbytes = (cfg.n_layers * sum(k * n + n * 4 + batch * (k + n) * 2 for k, n in shapes)
              + cfg.dim * cfg.vocab_size + cfg.vocab_size * 4
              + batch * (cfg.dim + cfg.vocab_size) * 2)
    ms = run("weights only (packed)", scan, nbytes, dev, repeats, "weights, scales, x, out")
    return {"ms": {"weights": ms}, "spot": errs}


def attn_part(cfg: LlamaConfig, batch: int, t: int, repeats: int, dev, g) -> dict:
    h, d = cfg.n_heads, cfg.head_dim

    def cache():
        return torch.randint(-127, 128, (batch, h, t, d), generator=g, device=dev,
                             dtype=torch.int8)

    caches = [(cache(), cache(), torch.full((batch, h, t), 0.01, device=dev),
               torch.full((batch, h, t), 0.01, device=dev)) for _ in range(cfg.n_layers)]
    mask = torch.ones(batch, t, dtype=torch.int32, device=dev)
    q = torch.randn(batch, h, 1, d, generator=g, device=dev).to(torch.bfloat16)

    k0, v0, ks0, vs0 = caches[0]
    ref = decode_attention(q, k0, v0, mask, k_scale=ks0[..., None], v_scale=vs0[..., None])
    errs = {"attention rel err vs decode_attention": spot(
        "attention rel err vs decode_attention",
        decode_attention_packed(q, k0, v0, ks0, vs0, mask), ref, ATTN_SPOT_BOUND)}

    def scan():
        for k, v, ks, vs in caches:
            decode_attention_packed(q, k, v, ks, vs, mask)

    nbytes = cfg.n_layers * (batch * h * t * (2 * d + 2 * 4) + batch * t * 4
                             + 2 * batch * h * d * 2)
    ms = run(f"attention only ({cfg.n_layers} layers)", scan, nbytes, dev, repeats,
             "cache, scales, mask, q, out")
    return {"ms": {"attn": ms}, "spot": errs}


def main(device: str | torch.device = "cuda", *, part: str = PART, batch: int = B,
         t: int = T, repeats: int = REPEATS, cfg: LlamaConfig | None = None,
         seed: int = 0) -> dict:
    """Print the part's line; return {"ms": {part: ms or None}, "spot":
    {check: error}}. Raises if the spot check is over its bound."""
    if part not in ("weights", "attn"):
        raise ValueError(f"part {part!r}: weights or attn")
    cfg = cfg if cfg is not None else LlamaConfig()
    dev = device_for(device)
    g = torch.Generator(dev).manual_seed(seed)
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"B={batch} T={t} L={cfg.n_layers} part={part} REPEATS={repeats} "
          f"device={dev.type}", flush=True)
    if part == "attn":
        return attn_part(cfg, batch, t, repeats, dev, g)
    return weights_part(cfg, batch, repeats, dev, g)


if __name__ == "__main__":
    main()

"""Microbenchmark: a LLaMA-7B block's post-attention tail at decode, on the H100.

K9 (``ops.fused_mlp.fused_o_mlp``) runs o-projection, residual, RMSNorm,
SwiGLU MLP and residual with packed int8 weights as one cooperative launch.
The TPU kernel it replaces (``mmor_tpu/ops/fused_mlp.py``) existed to cut
launches; the question on the H100 is what one persistent launch with
grid-wide barriers buys over separate launches. At batch B it prints, in ms
a call and GB/s of the weight bytes moved:

- ``k9_fused``: K9, one launch;
- ``k2_chain``: the same tail unfused in the port's own kernels: three K2
  W8A16 products (``int8_matmul_packed(int8_mxu=False)``) with the
  residuals, norm and SiLU as eager torch ops between them;
- ``k10c_chain``: the same with K10c's bf16 mode
  (``bench_bitcast.w8b_matmul``) for the products: the weight-stream
  kernel on the same row-packed words, so that K9 is held against separate
  launches of a kernel that streams as fast as the port's best;
- ``torch_bf16``: three cuBLAS bf16 products on the dequantized weights
  (twice the bytes) with the same eager ops, the library yardstick.

and, from one more K9 call that records the card's clock at its barriers,
the microseconds of each of its phases, after the kernel's plan
(``tail_plan``: its work units and ring stages a phase). Shapes: the port's ``LlamaConfig``
(D = Dq = 4096, F = 11008): 152 MB of int8 weights a call. Timing:
``timing.scan_ms`` (every call reads more weight bytes than the 50 MB L2
holds).

    python -m mmor_tpu_torch.tools.perf.bench_fused_mlp

(``BM_B`` rows, default "8,14"; ``BM_REPEATS`` calls, default 20.)
"""

from __future__ import annotations

import os

import torch

from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.ops.fused_mlp import (fused_o_mlp, fused_o_mlp_plain, phase_times_us,
                                          tail_plan)
from mmor_tpu_torch.ops.quantized_matmul import (int8_matmul_packed, pack_int8_rows,
                                                 quantize_weights, unpack_int8_rows)
from mmor_tpu_torch.tools.perf.bench_bitcast import w8b_matmul
from mmor_tpu_torch.tools.perf.timing import card, device_for, run

BATCHES = tuple(int(b) for b in os.environ.get("BM_B", "8,14").split(","))
REPEATS = int(os.environ.get("BM_REPEATS", "20"))
# K9 against its plain version: the same bf16 operands and f32 sums in
# another order; h and m at near-ties round one bf16 step apart
SPOT_BOUND = 1e-3


def tail_operands(b: int, dq: int, d: int, f: int, dev: torch.device, g: torch.Generator,
                  res_dtype: torch.dtype = torch.bfloat16) -> tuple:
    """Seeded K9 operands: attn (B, Dq) and x_res (B, D) N(0, 1) in
    ``res_dtype``, norm_scale 1 + N(0, 0.1), and N(0, 0.02) weights quantized
    per channel and packed by ``pack_int8_rows``: (attn, x_res, norm_scale,
    wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s)."""
    attn = torch.randn(b, dq, generator=g, device=dev).to(res_dtype)
    x_res = torch.randn(b, d, generator=g, device=dev).to(res_dtype)
    ns = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    packed = []
    for k, n in ((dq, d), (d, 2 * f), (f, d)):
        w_q, s = quantize_weights(torch.randn(k, n, generator=g, device=dev) * 0.02)
        packed += [pack_int8_rows(w_q), s]
    return (attn, x_res, ns, *packed)


def weight_bytes(dq: int, d: int, f: int) -> int:
    """The int8 weight bytes of one tail (o, gate_up, down)."""
    return dq * d + d * 2 * f + f * d


def _swiglu_tail(x2, ns, gate_up, down, eps):
    """The eager steps between the products: h, then the MLP residual."""
    h = (x2 * torch.rsqrt((x2 * x2).mean(dim=-1, keepdim=True) + eps) * ns).to(torch.bfloat16)
    gu = gate_up(h).float()
    f = gu.shape[1] // 2
    m = (torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]).to(torch.bfloat16)
    return x2 + down(m).float()


def _chain(mm, attn, x_res, ns, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s, eps):
    x2 = x_res.float() + mm(attn.to(torch.bfloat16), wo_p, wo_s).float()
    out = _swiglu_tail(x2, ns.float(), lambda h: mm(h, wgu_p, wgu_s),
                       lambda m: mm(m, wd_p, wd_s), eps)
    return out.to(x_res.dtype)


def k2_chain(*args, eps: float = 1e-5):
    """The tail unfused: three K2 W8A16 launches and eager torch ops."""
    return _chain(lambda a, w_p, s: int8_matmul_packed(a, w_p, s, int8_mxu=False), *args,
                  eps=eps)


def k10c_chain(*args, eps: float = 1e-5):
    """The tail unfused: three K10c bf16-mode launches and eager torch ops."""
    return _chain(w8b_matmul, *args, eps=eps)


def library_tail(attn, x_res, ns, wo, wgu, wd, eps: float = 1e-5):
    """The tail as three cuBLAS bf16 products on dequantized (K, N) bf16
    weights and eager torch ops (K9's library yardstick, timed only)."""
    x2 = x_res.float() + (attn.to(torch.bfloat16) @ wo).float()
    out = _swiglu_tail(x2, ns.float(), lambda h: h @ wgu, lambda m: m @ wd, eps)
    return out.to(x_res.dtype)


def dequantized(w_p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(K/4, N) packed words and (N,) scales -> (K, N) bf16 weights."""
    return (unpack_int8_rows(w_p).float() * s[None, :]).to(torch.bfloat16)


def main(device: str | torch.device = "cuda", *, batches: tuple = BATCHES,
         cfg: LlamaConfig | None = None, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if K9 misses its plain version by more than SPOT_BOUND."""
    dev = device_for(device)
    cfg = cfg or LlamaConfig()
    dq, d, f = cfg.dim, cfg.dim, cfg.ffn_dim  # heads x head_dim = dim
    g = torch.Generator(dev).manual_seed(seed)
    ops = tail_operands(max(batches), dq, d, f, dev, g)
    wo, wgu, wd = (dequantized(ops[i], ops[i + 1]) for i in (3, 5, 7))
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"Dq={dq} D={d} F={f} B={','.join(map(str, batches))} REPEATS={repeats} "
          f"device={dev.type}", flush=True)

    nbytes = weight_bytes(dq, d, f)
    ms, errs = {}, {}
    for b in batches:
        print(f"k9 plan B={b} (units, stages a unit): " + " ".join(
            f"{k}={v}" for k, v in tail_plan(b, dq, d, f).items()), flush=True)
        args = (ops[0][:b].contiguous(), ops[1][:b].contiguous(), *ops[2:])
        got, ref = fused_o_mlp(*args).double(), fused_o_mlp_plain(*args).double()
        name = f"k9 B={b} rel_l2 vs plain"
        errs[name] = float((got - ref).norm() / ref.norm())
        print(f"{name}: {errs[name]:.4e} (bound {SPOT_BOUND:.0e})", flush=True)
        if not errs[name] <= SPOT_BOUND:
            raise RuntimeError(f"spot check {name}: {errs[name]:.4e} > {SPOT_BOUND:.0e}")
        ms[f"k9_fused_B{b}"] = run(f"k9_fused B={b}", lambda: fused_o_mlp(*args), nbytes, dev,
                                   repeats)
        ms[f"k2_chain_B{b}"] = run(f"k2_chain B={b}", lambda: k2_chain(*args), nbytes, dev,
                                   repeats)
        ms[f"k10c_chain_B{b}"] = run(f"k10c_chain B={b}", lambda: k10c_chain(*args), nbytes,
                                     dev, repeats)
        ms[f"torch_bf16_B{b}"] = run(f"torch_bf16 B={b}",
                                     lambda: library_tail(*args[:3], wo, wgu, wd), 2 * nbytes,
                                     dev, repeats, "bf16 weight bytes")
        if ms[f"k9_fused_B{b}"] is not None:
            stamps = torch.zeros(5, dtype=torch.int64, device=dev)
            fused_o_mlp(*args, phase_ns=stamps)
            print(f"k9 phases B={b} (us, block 0's clock): " + " ".join(
                f"{k}={v:.1f}" for k, v in phase_times_us(stamps).items()), flush=True)
            print(f"B={b}: k9_fused's speed over " + ", ".join(
                f"{line}'s {ms[f'{line}_B{b}'] / ms[f'k9_fused_B{b}']:.2f}x"
                for line in ("k2_chain", "k10c_chain", "torch_bf16")), flush=True)
    return {"ms": ms, "spot": errs}


if __name__ == "__main__":
    main()

"""K9: a LLaMA block's post-attention tail in one call.

Counterpart of ``mmor_tpu/ops/fused_mlp.py``: o-projection, attention
residual, RMSNorm, SwiGLU MLP and MLP residual with int8 weights packed four
to an int32 along K (``pack_int8_rows``) and f32 per-channel scales.

The JAX wrapper has two numerics (as K2 and K3 have): its TPU kernel takes
bf16 operands (``attn``, ``h``, ``m``) with f32 sums and the scales after
each sum; its CPU branch computes the tail in f32 throughout. The port's
plain version and kernel both take the TPU kernel's numerics.

Nothing in either package calls it; ``mmor_tpu_torch/tools/perf/
bench_fused_mlp.py`` times it at the 7B decode tail.
"""

from __future__ import annotations

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops.quantized_matmul import unpack_int8_rows


def _check_shapes(attn, x_res, norm_scale, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s) -> None:
    b, dq = attn.shape
    d = x_res.shape[1]
    f = wgu_p.shape[1] // 2
    want = {"x_res": (b, d), "norm_scale": (d,), "wo_p": (dq // 4, d), "wo_s": (d,),
            "wgu_p": (d // 4, 2 * f), "wgu_s": (2 * f,), "wd_p": (f // 4, d), "wd_s": (d,)}
    got = {"x_res": x_res, "norm_scale": norm_scale, "wo_p": wo_p, "wo_s": wo_s,
           "wgu_p": wgu_p, "wgu_s": wgu_s, "wd_p": wd_p, "wd_s": wd_s}
    bad = [f"{k} {tuple(got[k].shape)} (want {v})" for k, v in want.items()
           if tuple(got[k].shape) != v]
    if bad or dq % 4:
        raise ValueError(f"fused_o_mlp: attn {tuple(attn.shape)}, " + ", ".join(bad))


# csrc/fused_mlp.cu's shared memory: a block's ring of stages, up to 4,
# each two TMA boxes of 128 word rows x 32 columns (32 KB) and the x they
# meet (16 boxes of 64 k x 8 rows an n-tile), and its fold table of the
# eight consumer warps' partial tiles (n-tiles x 8 rows x 64 columns, f32),
# their row factors, the barriers passed, mbarriers and the 1024-byte
# alignment
_SMEM_PER_BLOCK, _WORD_BYTES, _MAX_STAGES, _CONSUMERS = 232448, 32768, 4, 8


def tail_plan(b: int, dq: int, d: int, f: int) -> dict:
    """The CUDA kernel's work at batch ``b``: ``n_tiles`` (8 batch rows
    each; 1 up to 8 rows, else 2) of a ``row_groups`` of 16 rows, the ring's
    ``stages`` and the block's shared-memory bytes ``smem``, and for each
    phase (``o``, ``gate_up``, ``down``) its (work units, ring stages a
    unit): units of 32 columns (gate_up: 32 gate and their 32 up columns)
    times the row groups, over all of K (a stage 256 word rows, gate_up's
    128 of both). The grid is one block an SM; phases o and down give unit
    u to block G - 1 - u % G, gate_up to u % G."""
    n_tiles = 1 if b <= 8 else 2
    groups = -(-b // 16)
    stage = _WORD_BYTES + 16 * 8 * n_tiles * 128
    fixed = 1024 + (_CONSUMERS * 8 * n_tiles * 64 + 2 * _CONSUMERS) * 4 + 16 * _MAX_STAGES
    stages = min(_MAX_STAGES, (_SMEM_PER_BLOCK - fixed) // stage)
    return {"n_tiles": n_tiles, "row_groups": groups, "stages": stages,
            "smem": fixed + stages * stage,
            "o": (d // 32 * groups, -(-(dq // 4) // 256)),
            "gate_up": (-(-f // 32) * groups, -(-(d // 4) // 128)),
            "down": (d // 32 * groups, -(-(f // 4) // 256))}


def fused_o_mlp_plain(attn, x_res, norm_scale, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s, *,
                      norm_eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch K9 with the TPU kernel's numerics
    (``mmor_tpu/ops/fused_mlp.py:36-121``): each product takes bf16
    activations and the int8 weights (exact in bf16), sums in f32 and applies
    the per-channel scale after the sum; x2 stays f32, h and m are rounded to
    bf16; the output takes x_res's dtype."""
    f = wgu_p.shape[1] // 2

    def mm(a, w_p):
        return a.to(torch.bfloat16).float() @ unpack_int8_rows(w_p).float()

    x2 = x_res.float() + mm(attn, wo_p) * wo_s.float()
    var = (x2 * x2).mean(dim=-1, keepdim=True)
    h = (x2 * torch.rsqrt(var + norm_eps) * norm_scale.float()).to(torch.bfloat16)
    gu = mm(h, wgu_p) * wgu_s.float()
    gate, up = gu[:, :f], gu[:, f:]
    m = (gate * torch.sigmoid(gate) * up).to(torch.bfloat16)
    return (x2 + mm(m, wd_p) * wd_s.float()).to(x_res.dtype)


def fused_o_mlp(attn, x_res, norm_scale, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s, *,
                norm_eps: float = 1e-5, phase_ns: torch.Tensor | None = None) -> torch.Tensor:
    """K9: attn (B, Dq) (heads flattened), x_res (B, D) the pre-attention
    residual, norm_scale (D,) the MLP norm's scale; o_proj ``wo_p`` (Dq/4, D)
    int32 with ``wo_s`` (D,) f32, gate_up ``wgu_p`` (D/4, 2F) with ``wgu_s``
    (2F,) (gate columns first), down ``wd_p`` (F/4, D) with ``wd_s`` (D,).
    Returns x2 + SwiGLU(rmsnorm(x2)) with x2 = x_res + attn @ Wo, (B, D) in
    x_res's dtype.

    CPU: ``fused_o_mlp_plain``. CUDA: ``csrc/fused_mlp.cu``, one cooperative
    launch of one block an SM (bf16 or f32 x_res; Dq and F multiples of 16,
    D of 32; ``tail_plan`` gives its work units and ring); a card that
    cannot co-schedule the grid raises. Its grid barriers share a counter
    in device memory, so calls must not overlap on two streams. With
    ``phase_ns``, a (5,) int64 CUDA tensor, the kernel also records the
    card's nanosecond clock at its start, after each of its three grid
    barriers and at its end (``phase_times_us`` reads them). Counts its
    launches in ``fused_o_mlp.launches``."""
    args = (attn, x_res, norm_scale, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s)
    _check_shapes(*args)
    if attn.device.type == "cpu":
        return fused_o_mlp_plain(*args, norm_eps=norm_eps)
    if attn.device.type != "cuda" or any(t.device != attn.device for t in args):
        raise ValueError("fused_o_mlp: operands must share one CUDA device")
    if x_res.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_o_mlp: x_res dtype {x_res.dtype}")
    if any(w.dtype != torch.int32 for w in (wo_p, wgu_p, wd_p)) or any(
            s.dtype != torch.float32 for s in (wo_s, wgu_s, wd_s)):
        raise TypeError("fused_o_mlp: packed weights must be int32, scales f32")
    b, dq = attn.shape
    d, f = x_res.shape[1], wgu_p.shape[1] // 2
    dev = attn.device
    if dq % 16 or d % 32 or f % 16:
        raise ValueError(f"fused_o_mlp: the kernel needs Dq % 16, D % 32, F % 16 == 0, got "
                         f"{dq}, {d}, {f}")
    if phase_ns is not None:
        if phase_ns.shape != (5,) or phase_ns.dtype != torch.int64 or phase_ns.device != dev:
            raise ValueError("fused_o_mlp: phase_ns must be a (5,) int64 tensor on the card")
        phase_ns.zero_()
    attn_b = _build.aligned(attn.to(torch.bfloat16))
    res = _build.aligned(x_res)
    ns = _build.aligned(norm_scale.float())
    wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s = (_build.aligned(t) for t in args[3:])
    out = torch.empty(b, d, dtype=x_res.dtype, device=dev)
    x2 = torch.empty(b, d, dtype=torch.float32, device=dev)
    # h and m hold each 4 k in the kernel's order [0, 2, 1, 3]
    h = torch.empty(b, d, dtype=torch.bfloat16, device=dev)
    m = torch.empty(b, f, dtype=torch.bfloat16, device=dev)
    ssq = torch.empty(d // 32, b, dtype=torch.float32, device=dev)
    err = _build.library().mmor_fused_o_mlp(
        *(_build.ptr(t) for t in (attn_b, res, ns, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s, out,
                                  x2, h, m, ssq)),
        None if phase_ns is None else _build.ptr(phase_ns), b, dq, d, f,
        int(x_res.dtype == torch.bfloat16), norm_eps, _build.stream())
    _build.check(err, "fused_o_mlp (one cooperative launch)")
    fused_o_mlp.launches += 1
    return out


fused_o_mlp.launches = 0


def phase_times_us(phase_ns: torch.Tensor) -> dict:
    """A ``phase_ns`` record as microseconds: phase 1 (o-projection), the
    norm, phase 2 (gate_up and SiLU), phase 3 (down and the residual) and
    the whole launch, on block 0's clock (the last to its barrier sets each
    phase's end; the last block's end closes phase 3). The weights of a
    phase start loading before its barrier, so a phase's time is the wait
    for its last block, not its stream's."""
    t = [int(v) for v in phase_ns.cpu()]
    names = ("phase1_o", "norm", "phase2_gate_up", "phase3_down")
    out = {n: (t[i + 1] - t[i]) / 1e3 for i, n in enumerate(names)}
    out["launch"] = (t[4] - t[0]) / 1e3
    return out

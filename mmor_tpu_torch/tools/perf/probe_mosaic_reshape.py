"""Microbenchmark: the layout probe of the TPU's deformable sampler, on the H100.

Counterpart of ``tools/perf/probe_mosaic_reshape.py``, which compiled five
kernels alone to find which Mosaic reshape or contraction the TPU's
deformable sampler (K6) could use: a TPU compiler question, and on the H100
each probe is a plain function with a plain kernel
(``csrc/reshape_probe.cu``). At the script's shapes (TQ 256 queries, a WH x
WW = 32 x 40 window, K = 1280, D 32) and on its all-ones inputs, ``main``
prints the script's ``[OK ] <name>: out_sum=...`` line for each probe, with
device ms a call, its bound and a PyTorch call's ms beside it:

- a. (TQ, WH, WW) -> (TQ, K) and b. (WH, WW, D) -> (K, D): ``reshape_copy``,
  the reshape written into a new buffer (library: ``.clone()``);
- c. (TQ, D) = S^T (K, TQ) contracted over K with (K, D), and d. the same
  over the two contracting dims of (TQ, WH, WW) and (WH, WW, D):
  ``st_product`` (library: ``torch.matmul``, TF32 off);
- e. S^T built in the kernel from probe e's one-hot (WH, 1, TQ) and (1, WW,
  TQ) factors (row 3 times column 5 at 0.5), then the transposed product:
  the one-hot formulation of the TPU's K6. Its time is also printed as the
  time of one query tile (TQ queries over one window), to set beside K6's
  direct gather.

The products are f32 on the CUDA cores, not TF32. Before the timed lines the
kernels are held to their plain versions on seeded random inputs (copies
exact, products rel_l2 <= 1e-6), and the all-ones sums to their exact
values.

    python -m mmor_tpu_torch.tools.perf.probe_mosaic_reshape

(``BM_REPEATS`` calls, default 20.)
"""

from __future__ import annotations

import os

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.tools.perf.timing import HBM_BYTES_PER_S, card, device_for, scan_ms

TQ, WH, WW, D = 256, 32, 40, 32
K = WH * WW
ONEHOT = (3, 5, 0.5)  # probe e's one-hot factors: window row, window column, weight
REPEATS = int(os.environ.get("BM_REPEATS", "20"))
F32_OPS_PER_S = 67e12  # one H100 SXM's f32 rate outside the tensor cores (data sheet)
PRODUCT_BOUND = 1e-6  # rel_l2 of a product against its plain version: f32 sums in another order
MODES = {"transposed": 0, "contracted": 1, "onehot": 2}  # csrc/reshape_probe.cu's A sources


def reshape_copy(t: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """K10f probes a and b: ``t`` reshaped to ``shape`` in a new buffer.

    CPU: ``t.reshape(shape).clone()``. CUDA: ``csrc/reshape_probe.cu``'s copy
    (a contiguous t of a multiple of 16 bytes); counts its launches in
    ``reshape_copy.launches``."""
    if t.device.type == "cpu":
        return t.reshape(shape).clone()
    if t.device.type != "cuda":
        raise ValueError("reshape_copy: t must lie on a CUDA device")
    nbytes = t.numel() * t.element_size()
    if nbytes % 16:
        raise ValueError(f"reshape_copy: {nbytes} bytes is not a multiple of 16")
    t = _build.aligned(t)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    if out.numel() != t.numel():
        raise ValueError(f"reshape_copy: {tuple(t.shape)} cannot take the shape {shape}")
    err = _build.library().mmor_probe_copy(_build.ptr(t), _build.ptr(out), nbytes,
                                           _build.stream())
    _build.check(err, "reshape_copy")
    reshape_copy.launches += 1
    return out


reshape_copy.launches = 0


def onehot_st(tq: int, wh: int, ww: int, onehot=ONEHOT, device=None) -> torch.Tensor:
    """Probe e's S^T (wh * ww, tq) f32: the (wh, 1, tq) factor, 1.0 at row
    iy, times the (1, ww, tq) factor, wx at column ix, with its leading dims
    collapsed."""
    iy, ix, wx = onehot
    wy = torch.where(torch.arange(wh, device=device) == iy, 1.0, 0.0)[:, None, None]
    wxf = torch.where(torch.arange(ww, device=device) == ix, wx, 0.0)[None, :, None]
    return (wy * wxf).expand(wh, ww, tq).reshape(wh * ww, tq)


def _operands(a, b, mode, tq):
    """(A (TQ, K), or None for ``onehot``, B (K, D), TQ) of a product in
    ``mode``; raises where the shapes do not meet."""
    if mode == "transposed":
        aa, bb = a.t(), b
    elif mode == "contracted":
        aa, bb = a.reshape(a.shape[0], -1), b.reshape(-1, b.shape[-1])
    elif mode == "onehot":
        if a is not None or b.dim() != 3:
            raise ValueError("st_product: onehot takes no a and a (WH, WW, D) b")
        aa, bb = None, b.reshape(-1, b.shape[-1])
    else:
        raise ValueError(f"st_product: mode {mode!r}")
    if aa is not None and aa.shape[1] != bb.shape[0]:
        raise ValueError(f"st_product: a {tuple(a.shape)}, b {tuple(b.shape)} ({mode})")
    return aa, bb, tq if aa is None else aa.shape[0]


def st_product_plain(a: torch.Tensor | None, b: torch.Tensor, *, mode: str = "transposed",
                     tq: int = TQ, onehot=ONEHOT) -> torch.Tensor:
    """Plain PyTorch K10f probes c, d, e: (TQ, D) f32 = A @ B. ``transposed``
    (c): a = S^T (K, TQ), b (K, D), A = a^T; ``contracted`` (d): a (TQ, WH,
    WW), b (WH, WW, D), contracted over both window dims; ``onehot`` (e): a
    None, b (WH, WW, D), A = ``onehot_st``'s S^T of ``tq`` queries,
    transposed."""
    aa, bb, tq = _operands(a, b, mode, tq)
    if aa is None:
        aa = onehot_st(tq, b.shape[0], b.shape[1], onehot, b.device).t()
    return aa.float() @ bb.float()


def st_product(a: torch.Tensor | None, b: torch.Tensor, *, mode: str = "transposed",
               tq: int = TQ, onehot=ONEHOT) -> torch.Tensor:
    """K10f probes c, d, e: ``st_product_plain``'s function on f32 operands.

    CPU: ``st_product_plain``. CUDA: ``csrc/reshape_probe.cu``'s product (f32
    FFMA over thread-block clusters that split K, A read transposed, in its
    natural order, or built from the one-hot factors); counts its launches
    in ``st_product.launches``."""
    _, bb, tq = _operands(a, b, mode, tq)
    if b.device.type == "cpu":
        return st_product_plain(a, b, mode=mode, tq=tq, onehot=onehot)
    if b.device.type != "cuda" or (a is not None and a.device != b.device):
        raise ValueError("st_product: operands must share one CUDA device")
    if b.dtype != torch.float32 or (a is not None and a.dtype != torch.float32):
        raise TypeError("st_product: f32 operands")
    kdim, d = bb.shape
    src = None if a is None else _build.aligned(a)  # S^T (K, TQ) or (TQ, K), as stored
    bb = _build.aligned(bb)
    out = torch.empty(tq, d, dtype=torch.float32, device=b.device)
    iy, ix, wx = onehot
    err = _build.library().mmor_probe_product(
        None if src is None else _build.ptr(src), _build.ptr(bb), _build.ptr(out), tq, kdim, d,
        MODES[mode], b.shape[1] if src is None else 0, iy, ix, float(wx), _build.stream())
    _build.check(err, "st_product")
    st_product.launches += 1
    return out


st_product.launches = 0


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main(device: str | torch.device = "cuda", *, repeats: int = REPEATS, seed: int = 0) -> dict:
    """Print the five probes' lines; return {"ms": {line: ms or None},
    "spot": {check: error}, "sums": {probe: all-ones out_sum}}. Raises if a
    kernel misses its plain version or an all-ones sum its exact value."""
    dev = device_for(device)
    tq, wh, ww, d, k = TQ, WH, WW, D, K
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"devices: {dev.type} TQ={tq} WH={wh} WW={ww} D={d} K={k} REPEATS={repeats}",
          flush=True)
    ones = dict(device=dev, dtype=torch.float32)
    s3, win = torch.ones(tq, wh, ww, **ones), torch.ones(wh, ww, d, **ones)
    st, v2 = torch.ones(k, tq, **ones), torch.ones(k, d, **ones)
    flops = 2.0 * tq * k * d
    # name, kernel call, plain call, library call, bytes, flops, all-ones sum
    probes = (
        ("a. (TQ,WH,WW)->(TQ,K) lane merge", lambda x: reshape_copy(x[0], (tq, k)),
         lambda x: x[0].reshape(tq, k).clone(), lambda x: x[0].clone(), (s3,),
         2 * tq * k * 4, 0.0, tq * k),
        ("b. (WH,WW,D)->(K,D) sublane merge", lambda x: reshape_copy(x[0], (k, d)),
         lambda x: x[0].reshape(k, d).clone(), lambda x: x[0].clone(), (win,),
         2 * k * d * 4, 0.0, k * d),
        ("c. dot_general lhs-transposed (K,TQ)x(K,D)",
         lambda x: st_product(x[0], x[1], mode="transposed"),
         lambda x: st_product_plain(x[0], x[1], mode="transposed"),
         lambda x: torch.matmul(x[0].t(), x[1]), (st, v2), (k * tq + k * d + tq * d) * 4, flops,
         tq * d * k),
        ("d. dot_general 2 contracting dims",
         lambda x: st_product(x[0], x[1], mode="contracted"),
         lambda x: st_product_plain(x[0], x[1], mode="contracted"),
         lambda x: torch.matmul(x[0].reshape(tq, k), x[1].reshape(k, d)), (s3, win),
         (tq * k + k * d + tq * d) * 4, flops, tq * d * k),
        ("e. full transposed-S build",
         lambda x: st_product(None, x[0], mode="onehot", tq=tq),
         lambda x: st_product_plain(None, x[0], mode="onehot", tq=tq), None, (win,),
         (k * d + tq * d) * 4, flops, tq * d * ONEHOT[2]),
    )
    g = torch.Generator(dev).manual_seed(seed)
    spots, sums, ms = {}, {}, {}
    for name, fn, plain, library, args, nbytes, nflops, want in probes:
        letter = name[0]
        rand = tuple(torch.randn(a.shape, generator=g, **ones) for a in args)
        got, ref = fn(rand), plain(rand)
        copy = nflops == 0.0
        err = float((got - ref).abs().max()) if copy else _rel_l2(got, ref)
        what = f"{letter} {'max abs' if copy else 'rel_l2'} vs plain"
        spots[what] = err
        print(f"{what}: {err:.4e} (bound {0.0 if copy else PRODUCT_BOUND:.0e})", flush=True)
        if err > (0.0 if copy else PRODUCT_BOUND):
            raise RuntimeError(f"spot check {name}: {err:.4e} over its bound")
        total = float(fn(args).double().sum())
        sums[name] = total
        if total != want:
            raise RuntimeError(f"{name}: all-ones out_sum {total} != {want}")
        bound, by = _bound_ms(nbytes, nflops)
        t, ahead = scan_ms(lambda fn=fn, args=args: fn(args), repeats, dev)
        ms[f"{letter}_kernel"] = t
        if t is None:
            print(f"[OK ] {name}: out_sum={total:.3f} not measured (cpu, ran once)", flush=True)
            continue
        lib = None
        if library is not None:
            lib = scan_ms(lambda library=library, args=args: library(args), repeats, dev)[0]
            ms[f"{letter}_library"] = lib
        print(f"[OK ] {name}: out_sum={total:.3f} {t:.4f} ms bound {bound:.4f} ms ({by}) "
              f"library {'none' if lib is None else f'{lib:.4f} ms'} "
              f"host_ahead={ahead}/{repeats}", flush=True)
        if letter == "e":
            print(f"e per query tile ({tq} queries x {d} channels over one {wh}x{ww} window): "
                  f"{t:.4f} ms", flush=True)
    return {"ms": ms, "spot": spots, "sums": sums}


if __name__ == "__main__":
    main()

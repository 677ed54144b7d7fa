"""Microbenchmark: how many map windows a second a gather can issue, on the H100.

Counterpart of ``tools/perf/bench_dma_gather.py``, which asked whether DMAs
issued one a window from a TPU kernel beat XLA's gather for the deformable
sampler's corner windows. For N index pairs (y, x) into a (H, W, C) bf16
map it prints, in ms a call, millions of windows (descriptors) a second and
GB/s of the (2, 2, C) corners each window serves (the JAX script's "useful"
bytes):

- ``torch_corners``: torch advanced indexing of the unaligned (2, 2, C)
  corners at (y, x), the twin of the JAX script's ``xla_gather``;
- ``torch_windows``: the same indexing of the (2, 16, C) windows the
  kernel copies;
- ``window_gather``: K10d, ``dma_gather`` (``csrc/window_gather.cu``), the
  window ``f[y:y+2, x8:x8+16, :]`` with x8 = (x // 8) * 8, the aligned
  window the TPU kernel's DMAs fetch (its W axis took only 8-aligned
  slices).

and beside each the bytes it writes and their bound at the card's memory
rate. Timing: ``timing.scan_ms``. The TPU kernel's ``CHUNK`` and ``NSEM``
(windows a grid step, DMAs in flight) are gone: a warp copies a window.

    python -m mmor_tpu_torch.tools.perf.bench_dma_gather

(``DG_N`` windows, default 2^18; ``BM_REPEATS`` calls, default 8.)
"""

from __future__ import annotations

import os

import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.tools.perf.timing import HBM_BYTES_PER_S, card, device_for, scan_ms

H, W, C = 92, 160, 32
N = int(os.environ.get("DG_N", str(1 << 18)))
REPEATS = int(os.environ.get("BM_REPEATS", "8"))


def _window_index(idx: torch.Tensor):
    """(rows (N, 2, 1), columns (N, 1, 16)) of each window's map entries."""
    x8 = torch.div(idx[:, 1], 8, rounding_mode="floor") * 8
    dy = torch.arange(2, device=idx.device)
    dx = torch.arange(16, device=idx.device)
    return idx[:, 0, None, None] + dy[None, :, None], x8[:, None, None] + dx[None, None, :]


def torch_windows(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The (N, 2, 16, C) windows by one torch indexing call (K10d's library
    yardstick; every window must lie inside the map)."""
    return f[_window_index(idx)]


def torch_corners(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The (N, 2, 2, C) corners at (y, x), as the JAX script's ``xla_gather``."""
    r = torch.arange(2, device=idx.device)
    return f[idx[:, 0, None, None] + r[None, :, None], idx[:, 1, None, None] + r[None, None, :]]


def dma_gather_plain(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10d: for each (y, x) of idx (N, 2) int32, the window
    f[y:y+2, x8:x8+16, :] of the (H, W, C) map, x8 = (x // 8) * 8, as
    (N, 2, 16, C); a window reaching outside the map is all zeros."""
    h, w, _ = f.shape
    rows, cols = _window_index(idx)
    inside = (rows[:, 0, 0] >= 0) & (rows[:, 1, 0] < h) & (cols[:, 0, 0] >= 0) & (
        cols[:, 0, 15] < w)
    keep = inside[:, None, None]
    win = f[torch.where(keep, rows, 0), torch.where(keep, cols, 0)]
    return torch.where(keep[..., None], win, torch.zeros((), dtype=f.dtype, device=f.device))


def dma_gather(idx: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """K10d: the (N, 2, 16, C) windows of ``dma_gather_plain``.

    CPU: ``dma_gather_plain``. CUDA: ``csrc/window_gather.cu`` (bf16 map, C
    a multiple of 8), an exact copy. Counts its launches in
    ``dma_gather.launches``."""
    if idx.dim() != 2 or idx.shape[1] != 2 or f.dim() != 3:
        raise ValueError(f"dma_gather: idx {tuple(idx.shape)}, map {tuple(f.shape)}")
    if idx.device.type == "cpu":
        return dma_gather_plain(idx, f)
    if idx.device.type != "cuda" or f.device != idx.device:
        raise ValueError("dma_gather: operands must share one CUDA device")
    if idx.dtype != torch.int32 or f.dtype != torch.bfloat16:
        raise TypeError(f"dma_gather: idx {idx.dtype} (int32), map {f.dtype} (bf16)")
    h, w, c = f.shape
    if c % 8:
        raise ValueError(f"dma_gather: the kernel needs C % 8 == 0, C={c}")
    idx, f = _build.aligned(idx), _build.aligned(f)
    out = torch.empty(idx.shape[0], 2, 16, c, dtype=f.dtype, device=f.device)
    err = _build.library().mmor_window_gather(_build.ptr(idx), _build.ptr(f), _build.ptr(out),
                                              idx.shape[0], h, w, c, _build.stream())
    _build.check(err, "dma_gather")
    dma_gather.launches += 1
    return out


dma_gather.launches = 0


def make_inputs(n: int, dev: torch.device, seed: int = 0):
    """The seeded (H, W, C) bf16 map and (N, 2) int32 pairs with y in
    [0, H - 2] and x in [0, W - 18], the JAX script's ranges."""
    g = torch.Generator(dev).manual_seed(seed)
    f = torch.randn(H, W, C, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randint(0, H - 1, (n,), generator=g, device=dev),
                       torch.randint(0, W - 17, (n,), generator=g, device=dev)], 1)
    return idx.to(torch.int32), f


def main(device: str | torch.device = "cuda", *, n: int = N, repeats: int = REPEATS,
         seed: int = 0) -> dict:
    """Print the lines; return {"ms": {line: ms or None}, "spot": {check:
    error}}. Raises if the kernel's windows are not exactly the indexed ones
    or the corners not inside them."""
    dev = device_for(device)
    idx, f = make_inputs(n, dev, seed)
    if dev.type == "cuda":
        print(f"card: {card()}", flush=True)
    print(f"N={n} map=({H},{W},{C}) bf16 REPEATS={repeats} device={dev.type}", flush=True)

    windows = dma_gather(idx, f)
    corners = torch_corners(idx, f)
    off = (idx[:, 1] % 8).long()  # each corner's column inside its window
    in_window = windows[torch.arange(n, device=dev)[:, None], :, off[:, None] + torch.arange(
        2, device=dev)[None, :]].transpose(1, 2)
    spot = {"window_gather exact vs torch indexing": float(
                (windows.float() - torch_windows(idx, f).float()).abs().max()),
            "corners exact inside their windows": float(
                (in_window.float() - corners.float()).abs().max())}
    for name, err in spot.items():
        print(f"{name}: max abs {err:.4e}", flush=True)
        if err != 0.0:
            raise RuntimeError(f"spot check {name}: max abs {err:.4e} != 0")
    del windows, corners, in_window

    ms = {}
    el = f.element_size()
    for name, fn, written in (("torch_corners", torch_corners, n * 2 * 2 * C * el),
                              ("torch_windows", torch_windows, n * 2 * 16 * C * el),
                              ("window_gather", dma_gather, n * 2 * 16 * C * el)):
        t, ahead = scan_ms(lambda fn=fn: fn(idx, f), repeats, dev)
        ms[name] = t
        if t is None:
            print(f"{name:14s} not measured (cpu, ran once)", flush=True)
            continue
        print(f"{name:14s} {t:9.4f} ms {n / t / 1e3:9.1f} M desc/s "
              f"{n * 2 * 2 * C * el / t / 1e6:8.1f} GB/s useful  writes {written / 1e6:.1f} MB, "
              f"bound {written / HBM_BYTES_PER_S * 1e3:.4f} ms host_ahead={ahead}/{repeats}",
              flush=True)
    return {"ms": ms, "spot": spot}


if __name__ == "__main__":
    main()

"""Device timing and the printed lines shared by the port's microbenchmarks.

A scan is one pass over the benchmark's stacked weights or caches (one
kernel call a layer). Its time is taken with CUDA events over ``repeats``
scans after one warm scan. Each scan is timed as a window of its own: a spin
kernel (``torch.cuda._sleep``) holds the card while the host enqueues the
whole scan behind it, so the events bracket the scan's kernels running back
to back and measure the card, not Python's launch rate. After enqueueing,
the host asks whether the start event has been reached yet; if it has, the
spin was too short and doubles, in unmeasured windows first, and each
measured window reports whether the host stayed ahead (``host_ahead``).

Eager PyTorch runs every call it is given, so a scan needs no data
dependency from one repeat to the next (the JAX scripts perturbed x by
``acc * 1e-38`` only so that XLA would not hoist the loop body).

On the CPU nothing is timed: each scan runs once, as a check of the code
path, and its line says "not measured".
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM at 700 W, NVIDIA's data sheet
SPIN_CYCLES, SPIN_CYCLES_MAX = 1 << 20, 1 << 30


def device_for(device: str | torch.device) -> torch.device:
    """The benchmark's device; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this benchmark times the card and needs a CUDA device; "
                           "device='cpu' runs each line once without timing")
    return dev


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def _window(scan: Callable[[], object], cycles: int) -> tuple[float, bool]:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    scan()
    stop.record()
    ahead = not start.query()  # the whole scan was queued before it began
    stop.synchronize()
    return start.elapsed_time(stop), ahead


def scan_ms(scan: Callable[[], object], repeats: int,
            dev: torch.device) -> tuple[float | None, int]:
    """(mean ms of one scan on the card, windows in which the host stayed
    ahead); (None, 0) on the CPU, where the scan runs once."""
    scan()
    if dev.type != "cuda":
        return None, 0
    torch.cuda.synchronize(dev)
    cycles = SPIN_CYCLES
    while cycles < SPIN_CYCLES_MAX and not _window(scan, cycles)[1]:
        cycles *= 2
    total, ahead = 0.0, 0
    for _ in range(repeats):
        ms, ok = _window(scan, 2 * cycles)
        total += ms
        ahead += ok
    return total / repeats, ahead


def run(name: str, scan: Callable[[], object], nbytes: float, dev: torch.device,
        repeats: int, what: str = "weight bytes") -> float | None:
    """Time ``scan`` and print its line: ms a scan, GB/s of ``nbytes`` (the
    bytes a scan must move) and their bound. Returns the ms (None on the
    CPU)."""
    t0 = time.perf_counter()
    ms, ahead = scan_ms(scan, repeats, dev)
    if ms is None:
        print(f"{name:14s} not measured (cpu, ran once)", flush=True)
        return None
    print(f"{name:14s} {ms:9.4f} ms/scan {nbytes / ms / 1e6:8.1f} GB/s ({what}) "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms host_ahead={ahead}/{repeats} "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    return ms


def spot(name: str, got: torch.Tensor, ref: torch.Tensor, bound: float) -> float:
    """Print and return max |got - ref| / max |ref|; raise above ``bound``."""
    got, ref = got.double(), ref.double()
    err = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    print(f"{name}: {err:.4e} (bound {bound:.1e})", flush=True)
    if not err <= bound:
        raise RuntimeError(f"spot check {name}: {err:.4e} > {bound:.1e}")
    return err

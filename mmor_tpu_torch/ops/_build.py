"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together) and the objects link into one shared library
with a plain C interface. The library lands in ``build/kernels/<hash>`` at the
root of the checkout (``.gitignore`` lists ``build/``), keyed by a hash of the
sources, their headers and the flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. A missing ``nvcc`` or a failed compile
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types; each returns a cudaError_t
SIGNATURES = {
    "mmor_flash_attention": (_P,) * 9 + (_I,) * 6 + (_F, _I, _I, _P),
    "mmor_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "mmor_decode_attention_layer": (_P,) * 7 + (_I,) * 4 + (_F, _I, _I, _P),
    "mmor_int8_matmul_w8a8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mmor_int8_matmul_bytes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mmor_int8_matmul_w8a16": (_P,) * 5 + (_I,) * 4 + (_P,),
    "mmor_int4_matmul": (_P,) * 6 + (_I,) * 6 + (_P,),
    "mmor_mega_decode": (_P,) * 38 + (_I,) * 11 + (_F, _F, _P),
    "mmor_mega_project": (_P,) * 6 + (_I,) * 15 + (_P,),
    "mmor_ms_deform_attn": (_P,) * 5 + (_I,) * 8 + (_P,),
    "mmor_w8a16_bytes": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mmor_wp_matmul": (_P,) * 4 + (_I,) * 5 + (_P,),
    "mmor_int8_matmul_w8b": (_P,) * 6 + (_I,) * 4 + (_P,),
    "mmor_fused_o_mlp": (_P,) * 15 + (_I,) * 5 + (_F, _P),
    "mmor_window_gather": (_P,) * 3 + (_I,) * 4 + (_P,),
    "mmor_xread_probe": (_P,) * 4 + (_I,) * 6 + (_P,),
    "mmor_nibble_probe": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mmor_tiny_probe": (_P, _P, _I, _P),
    "mmor_rowrw_probe": (_P,) * 4 + (_I,) * 4 + (_P,),
    "mmor_probe_copy": (_P, _P, _L, _P),
    "mmor_probe_product": (_P,) * 3 + (_I,) * 7 + (_F, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
                       ": the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libmmor_kernels.so"
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-8000:]}")
        tmp_lib = Path(tmp) / lib.name
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-8000:]}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or none
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call in a process)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    return t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")

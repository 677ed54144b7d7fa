"""The PyTorch port imports neither JAX, flax nor the JAX package.

Every module of ``mmor_tpu_torch``, and ``chip_smoke.py`` as a module, is
imported in a fresh interpreter (the test process itself has JAX loaded by
``conftest.py``); no ``jax``, ``jaxlib``, ``flax`` or ``mmor_tpu`` module
may be loaded afterwards."""

import os
import subprocess
import sys
from pathlib import Path

from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mmor_tpu")


def _port_modules() -> list[str]:
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "mmor_tpu_torch").rglob("*.py"))
    return [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in modules]


def _assert_imports_clean(modules: list[str]) -> None:
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "leaked = sorted(m for m in sys.modules\n"
            f"                if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(len(sys.modules), leaked)\n"
            "assert not leaked, leaked\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_no_jax():
    modules = _port_modules()
    assert "mmor_tpu_torch.models.mm2sg" in modules
    assert "mmor_tpu_torch.ops.mega_decode" in modules
    assert "mmor_tpu_torch.cli.eval_panoptic" in modules
    assert "mmor_tpu_torch.ops.deformable_sampler" in modules
    assert "mmor_tpu_torch.ops.mega_overlap" in modules
    assert "mmor_tpu_torch.tools.perf.bench_megakernel_probe" in modules
    assert "mmor_tpu_torch.tools.perf.probe_mosaic_reshape" in modules
    assert "mmor_tpu_torch.tools.perf.bench_prefill_matmul" in modules
    _assert_imports_clean(modules)


def test_chip_smoke_imports_no_jax():
    _assert_imports_clean(["chip_smoke"])

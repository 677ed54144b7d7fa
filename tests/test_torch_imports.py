"""The PyTorch port imports neither JAX nor flax.

Every module of ``mmor_tpu_torch`` is imported in a fresh interpreter (the
test process itself has JAX loaded by ``conftest.py``)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "mmor_tpu_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    assert "mmor_tpu_torch.models.mm2sg" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "print(len(sys.modules), leaked)\n"
            "assert not leaked, leaked\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

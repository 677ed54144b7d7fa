"""A JAX ops module's TPU branch on the CPU, for the port's parity tests.

The JAX package's quantized matmuls pick their Pallas kernel when
``jax.devices()`` reports a TPU and their plain XLA path otherwise.
``take_tpu_branch`` swaps the module's ``jax`` and ``pl`` names for views that
differ only in ``devices`` (a TPU) and ``pallas_call`` (interpret mode), so
the TPU kernel's body runs on the CPU; nothing in the JAX package changes.
"""

import functools
import types

import jax
from jax.experimental import pallas as pl


def take_tpu_branch(monkeypatch, module) -> None:
    fake_jax = types.SimpleNamespace(**{k: getattr(jax, k) for k in ("lax", "nn", "vmap")},
                                     ShapeDtypeStruct=jax.ShapeDtypeStruct,
                                     devices=lambda: [types.SimpleNamespace(platform="tpu")])
    fake_pl = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                       if not k.startswith("_")})
    fake_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(module, "jax", fake_jax)
    monkeypatch.setattr(module, "pl", fake_pl)

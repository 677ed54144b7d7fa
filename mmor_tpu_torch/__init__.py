"""mmor_tpu_torch — the PyTorch/CUDA port of ``mmor_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``ops``, ``models``, ``inference``, ``cli``, ``utils``). Plain
tensor code is PyTorch; each Pallas kernel on the ported path is a CUDA
kernel written for ``sm_90a`` under ``csrc/``, built at first use
(``ops/_build.py``). Host code that needs no JAX (scene-graph prompts and
parsing, the datasets, the F1 evaluator) is imported from ``mmor_tpu``.
This package never imports ``jax`` or ``flax``.
"""

__version__ = "0.1.0"

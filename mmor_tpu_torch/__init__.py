"""mmor_tpu_torch — the PyTorch/CUDA port of ``mmor_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``ops``, ``models``, ``inference``, ``cli``, ``utils``). Plain
tensor code is PyTorch; each Pallas kernel on the ported path is a CUDA
kernel written for ``sm_90a`` under ``csrc/``, built at first use
(``ops/_build.py``). The host code it needs (scene-graph prompts and
parsing, the datasets, the F1 evaluator) is copied into ``sg``, ``data``
and ``eval``. This package never imports ``jax``, ``flax`` or anything of
``mmor_tpu``.
"""

__version__ = "0.1.0"

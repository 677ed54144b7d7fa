"""Tensor ops and the kernel wrappers (K1 attention, K2/K3/K8 int8 and int4
weight matmuls, K4/K7 decode attention, K5 decode megakernel, K6 deformable
attention sampler; K10a/K10b live with their microbenchmarks in
``tools/perf``); see ``ops/_build.py`` for how the kernels are built."""

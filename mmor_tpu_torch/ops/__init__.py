"""Tensor ops and the kernel wrappers (K1 attention, K2/K3 packed matmuls,
K4 decode attention, K5 decode megakernel, K6 deformable attention sampler);
see ``ops/_build.py`` for how the kernels are built."""

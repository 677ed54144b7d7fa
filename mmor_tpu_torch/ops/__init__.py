"""Tensor ops and the kernel wrappers (K1 attention, K2 int8 matmul, K4
decode attention); see ``ops/_build.py`` for how the kernels are built."""

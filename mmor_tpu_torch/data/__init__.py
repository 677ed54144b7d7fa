"""Dataset layout, host preprocessing and the synthetic dataset (copies of ``mmor_tpu.data`` modules)."""

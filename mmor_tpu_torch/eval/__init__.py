"""Scene-graph evaluation (copies of ``mmor_tpu.eval`` modules)."""

"""MM2SG LoRA fine-tuning on the port (counterparts of ``mmor_tpu.train`` modules)."""

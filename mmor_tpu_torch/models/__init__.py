"""PyTorch modules of the MM2SG stack, one file per ``mmor_tpu.models`` file."""

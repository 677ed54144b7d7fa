"""H100 microbenchmarks, counterparts of ``tools/perf/`` in the repository root.

Each module runs with ``python -m mmor_tpu_torch.tools.perf.<name>`` on the card;
``main(device="cpu", ...)`` runs each line once without timing.
"""

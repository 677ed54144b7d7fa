"""Tools of the PyTorch port: the H100 microbenchmarks (``tools.perf``)."""

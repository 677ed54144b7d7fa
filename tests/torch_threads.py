"""Torch's intra-op thread count for the port's test files (``test_torch_*.py``)."""

import os

import torch


def share_cores() -> None:
    """Give this process its share of the cores: parallel test workers
    (pytest-xdist's ``-n``), each with torch's default pool of one thread a
    core, oversubscribe them, and thousands of tiny eager ops then wait on
    each other's spinning threads. A file run alone keeps every core."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, os.cpu_count() // workers))

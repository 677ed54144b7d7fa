"""Lightweight metrics logging: JSONL files + console.

Copy of ``mmor_tpu/utils/logging.py``: the port imports nothing of the JAX
package, so it keeps its own copy of the host code it uses.

Stands in for the reference's wandb surface (SURVEY.md §5 — WandbLoggingHook,
per-class VPQ logging, HF report_to): every ``log`` call appends one JSON
line to ``{run_dir}/metrics.jsonl`` so runs are greppable and plottable
offline; a wandb sink can subscribe via ``add_sink`` without code changes.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable


class MetricsLogger:
    def __init__(self, run_dir: str | Path | None = None, echo: bool = True):
        self.path = None
        if run_dir is not None:
            run_dir = Path(run_dir)
            run_dir.mkdir(parents=True, exist_ok=True)
            self.path = run_dir / "metrics.jsonl"
        self.echo = echo
        self._sinks: list[Callable[[dict], None]] = []

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        self._sinks.append(fn)

    def log(self, step: int, **metrics) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
            for k, v in metrics.items()
        })
        if self.path is not None:
            with self.path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            print(json.dumps(record))
        for sink in self._sinks:
            sink(record)

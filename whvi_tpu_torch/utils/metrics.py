"""Metrics logging: a JSONL scalar logger and a wall-clock throughput
meter.

The port's own copy of :mod:`whvi_tpu.utils.metrics` (framework-free, so
the same code): a persistent, machine-readable log in place of the
reference's progress bar. The trainer reads the device once per chunk of
epochs, so a logger sees host floats only.
"""

from __future__ import annotations

import json
import time

__all__ = ["JsonlLogger", "Throughput"]


class JsonlLogger:
    """Append-only JSONL metrics log; optionally echoes each line to
    stdout."""

    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._f = open(path, "a") if path else None

    def __call__(self, entry: dict) -> None:
        line = json.dumps(entry)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line, flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class Throughput:
    """Steps per second since the meter was made."""

    def __init__(self):
        self.t0 = time.time()
        self.n = 0

    def update(self, steps: int = 1) -> float:
        self.n += steps
        dt = time.time() - self.t0
        return self.n / dt if dt > 0 else float("inf")

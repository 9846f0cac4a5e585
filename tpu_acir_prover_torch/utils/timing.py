"""Per-phase prover timing — the observability the reference lacks
(SURVEY.md §5: no tracing/profiling anywhere; we make phase breakdown a
first-class API and a TPU_ACIR_TIMING=1 env switch on the CLI)."""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager


class PhaseTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases = []  # (name, seconds)

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.phases.append((name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(t for _, t in self.phases)

    def report(self, stream=None):
        stream = stream or sys.stderr
        for name, t in self.phases:
            print(f"  {name:<24s} {t * 1e3:10.2f} ms", file=stream)
        print(f"  {'total':<24s} {self.total() * 1e3:10.2f} ms", file=stream)


def env_timer() -> PhaseTimer:
    return PhaseTimer(enabled=os.environ.get("TPU_ACIR_TIMING") == "1")

"""A proof's trace: named host spans and counters, kept in memory.

``PhaseTimer.phase(name)`` times one span of the host.  Spans are one level
deep and disjoint, and ``phases`` holds them as ``(name, seconds)`` in
call order, a name once for each time it was entered (sum them by name).
``spans`` holds the same spans as ``(name, start_ns, end_ns)`` on
``time.perf_counter_ns()``; ``profiler_offset_ns`` puts them on the clock
``torch.profiler`` stamps its host events with (Unix time).  While a
profiler runs, each span is also marked with ``record_function(name)``.

``api.prove_file`` opens its proof with ``proof(timer)``: the call gets a
process-wide proof id, the collector's pauses are counted while it runs
(``gc_pause_s``, ``gc_collections`` by generation), and at its end one
record goes to the bounded log ``finished()``.  The
provers add the card's time by CUDA events: ``replay_device_s`` around the
fused graph's replay, ``phase_device_s[name]`` over each per-phase phase
(``device_phase``).  While a span is open its timer is ``open_timer()``,
so code deep inside it counts without being handed the timer: the witness
fill (``circuit/compile.py`` ``generate_witness``, in ``witness_fill``)
splits its time between the arithmetic segments (``fill_native_s``: the C
core, or numpy batches without it) and the python hint segments
(``fill_hint_s``).  The compressor counts its transcript replays
(``compress_replays``).  A disabled timer, or none, keeps nothing.

``python -m tpu_acir_prover_torch.cli prove`` with ``TPU_ACIR_TIMING=1``
prints the proof's spans and counters on standard error (``env_timer``).
"""

from __future__ import annotations

import gc
import itertools
import os
import sys
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar

import torch
from torch.autograd import profiler as _profiler

# the finished proofs' records, oldest first
_FINISHED: deque = deque(maxlen=4096)
_PROOF_IDS = itertools.count(1)
# the enabled timer whose span is open
_OPEN: ContextVar = ContextVar("open_timer", default=None)


def finished() -> deque:
    """The records of the last 4096 proofs ``prove_file`` made with an
    enabled timer, oldest first.  A record is a dict: ``proof_id``;
    ``start`` and ``end`` of the call on ``time.perf_counter()``; the
    call's ``spans``; ``profiler_offset_ns``, which added to a span's
    times puts them on the profiler's clock; and ``counters``."""
    return _FINISHED


class PhaseTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases = []  # (name, seconds)
        self.spans = []   # (name, start_ns, end_ns) on perf_counter_ns
        self.counters = {}
        self.proof_id = None
        self._first_span = 0
        self._gc_t0 = None

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        mark = _profiler.record_function(name, str(self.proof_id)) \
            if _profiler._is_profiler_enabled else nullcontext()
        t0 = time.perf_counter_ns()
        token = _OPEN.set(self)
        try:
            with mark:
                yield
        finally:
            _OPEN.reset(token)
        t1 = time.perf_counter_ns()
        self.phases.append((name, (t1 - t0) * 1e-9))
        self.spans.append((name, t0, t1))

    @contextmanager
    def device_phase(self, name: str, device: torch.device):
        """``phase(name)``, and on a CUDA device the card's time between
        two events recorded at its ends, added to
        ``counters["phase_device_s"][name]``.  The block ends in a copy to
        the host, so the end event is reached as soon as it is recorded."""
        with self.phase(name):
            if not (self.enabled and device.type == "cuda"):
                yield
                return
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            end.synchronize()
            by_phase = self.counters.setdefault("phase_device_s", {})
            by_phase[name] = by_phase.get(name, 0.0) + \
                start.elapsed_time(end) * 1e-3

    def count(self, name: str, value: float) -> None:
        """Add ``value`` to counter ``name`` (an enabled timer only)."""
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + value

    def _on_gc(self, phase: str, info: dict) -> None:
        now = time.perf_counter_ns()
        if phase == "start":
            self._gc_t0 = now
        elif self._gc_t0 is not None:
            self.counters["gc_pause_s"] += (now - self._gc_t0) * 1e-9
            self.counters["gc_collections"][info["generation"]] += 1
            self._gc_t0 = None

    def total(self) -> float:
        return sum(t for _, t in self.phases)

    def report(self, stream=None):
        stream = stream or sys.stderr
        for name, t in self.phases:
            print(f"  {name:<24s} {t * 1e3:10.2f} ms", file=stream)
        print(f"  {'total':<24s} {self.total() * 1e3:10.2f} ms", file=stream)

    def report_counters(self, stream=None):
        stream = stream or sys.stderr
        for name, v in self.counters.items():
            if isinstance(v, dict):
                for k, x in v.items():
                    print(f"  {f'{name}[{k}]':<24s} {_shown(x)}", file=stream)
            else:
                print(f"  {name:<24s} {_shown(v)}", file=stream)


def _shown(v) -> str:
    return f"{v * 1e3:10.2f} ms" if isinstance(v, float) else f"{v:10d}"


@contextmanager
def proof(timer):
    """One ``prove_file`` call under ``timer``: a new proof id, the
    collector's pauses counted while it runs, and its record appended to
    ``finished()`` at the end, whether it returned or raised.  With no
    timer, or a disabled one, it does nothing."""
    if timer is None or not timer.enabled:
        yield
        return
    timer.proof_id = next(_PROOF_IDS)
    timer.counters = {"gc_pause_s": 0.0,
                      "gc_collections": {0: 0, 1: 0, 2: 0}}
    timer._first_span = len(timer.spans)
    on_gc = timer._on_gc
    start = time.perf_counter()
    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)
        _FINISHED.append({
            "proof_id": timer.proof_id, "start": start,
            "end": time.perf_counter(),
            "spans": timer.spans[timer._first_span:],
            "profiler_offset_ns": time.time_ns() - time.perf_counter_ns(),
            "counters": timer.counters})


def open_timer():
    """The enabled timer whose span is open, or None."""
    return _OPEN.get()


def env_timer() -> PhaseTimer:
    return PhaseTimer(enabled=os.environ.get("TPU_ACIR_TIMING") == "1")

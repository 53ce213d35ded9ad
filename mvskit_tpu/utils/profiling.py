"""Tracing / profiling utilities.

The reference's observability is wall-clock prints (with a
CLOCKS_PER_SEC unit bug) and pass/fail counters (SURVEY.md §5,
reference propagate.cpp:55-63, filter.cpp:90-96, pmmvps.cpp:112-113).
This module provides the engine's equivalents: correct phase timers,
structured counters, and jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


class PhaseTimer:
    """Accumulating per-phase wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._log: List[tuple] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase. Pass sync=some_jax_output to block on device
        completion before stopping the clock (dispatch is
        asynchronous)."""
        t0 = time.time()
        box = {}
        try:
            yield box
        finally:
            out = box.get("sync", sync)
            if out is not None:
                import jax
                import numpy as np

                try:
                    jax.block_until_ready(out)
                except Exception:
                    pass
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._log.append((name, dt))

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:30s} {total:8.2f}s x{self.counts[name]}"
            for name, total in rows
        )

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


class Counters:
    """Structured accept/reject counters (the propagation stats of
    reference propagate.cpp:56-63 as data instead of prose)."""

    def __init__(self):
        self.values: Dict[str, int] = {}

    def add(self, **kw):
        for k, v in kw.items():
            self.values[k] = self.values.get(k, 0) + int(v)

    def as_json(self) -> str:
        return json.dumps(self.values, sort_keys=True)

    def rates(self, total_key: str = "total") -> Dict[str, float]:
        total = max(self.values.get(total_key, 0), 1)
        return {
            k: 100.0 * v / total
            for k, v in self.values.items()
            if k != total_key
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

"""Per-stage wall timers for the schedule round.

``stage(name)`` is a context manager that adds its wall time to a
process-wide table; ``snapshot()`` reads the table and ``reset()``
clears it.  The JAX package routes the same call sites through its span
tracer; the port keeps only the aggregate table.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

_LOCK = threading.Lock()
_TOTALS: Dict[str, Tuple[float, int]] = {}


@contextmanager
def stage(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            tot, n = _TOTALS.get(name, (0.0, 0))
            _TOTALS[name] = (tot + dt, n + 1)


def snapshot() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, calls)} accumulated since the last reset."""
    with _LOCK:
        return dict(_TOTALS)


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()

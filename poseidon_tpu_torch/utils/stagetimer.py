"""Per-stage wall timers for the schedule round.

``stage(name)`` is a context manager that adds its wall time to a
process-wide table; ``snapshot()`` reads the table and ``reset()``
clears it.  The JAX package routes the same call sites through its span
tracer; the port keeps only the aggregate table.

A stage given a CUDA ``device`` also records a pair of CUDA events on the
current stream while device timing is on (``set_device_timing``), so
``device_snapshot()`` can report the device time between the stage's
start and end beside its host (enqueue) time.  Off by default: two event
records per stage cost a few microseconds of host time each.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

_LOCK = threading.Lock()
_TOTALS: Dict[str, Tuple[float, int]] = {}
_EVENTS: Dict[str, List[tuple]] = {}
_DEVICE_TIMING = False


def set_device_timing(on: bool) -> None:
    global _DEVICE_TIMING
    _DEVICE_TIMING = bool(on)


@contextmanager
def stage(name: str, device=None) -> Iterator[None]:
    ev = None
    if _DEVICE_TIMING and device is not None and device.type == "cuda":
        import torch

        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
        with _LOCK:
            tot, n = _TOTALS.get(name, (0.0, 0))
            _TOTALS[name] = (tot + dt, n + 1)
            if ev is not None:
                _EVENTS.setdefault(name, []).append(ev)


def snapshot() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, calls)} accumulated since the last reset."""
    with _LOCK:
        return dict(_TOTALS)


def device_snapshot() -> Dict[str, Tuple[float, int]]:
    """{stage: (device_seconds, calls)} of the stages timed on the device
    since the last reset (waits for their end events)."""
    with _LOCK:
        events = {k: list(v) for k, v in _EVENTS.items()}
    out = {}
    for name, pairs in events.items():
        secs = 0.0
        for a, b in pairs:
            b.synchronize()
            secs += a.elapsed_time(b) / 1e3
        out[name] = (secs, len(pairs))
    return out


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()
        _EVENTS.clear()

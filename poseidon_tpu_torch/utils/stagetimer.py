"""Per-stage wall timers for the schedule round — a thin shim over the
``poseidon_tpu_torch.obs.trace`` span tracer, as the reference's is.

The tracer owns accumulation (locked, thread-safe, shared with the span
timeline), so ``snapshot()`` totals and an exported Perfetto trace are
two views of the same records.  ``stage``/``snapshot``/``report``/
``reset`` are gated by ``POSEIDON_STAGE_TIMERS=1`` with a zero-overhead
disabled path; with ``POSEIDON_TRACE=1`` the same call sites also record
full spans.  ``reset()`` clears the aggregate table only, leaving any
recorded spans for export.

The port adds device timing: a stage given a CUDA ``device`` also
records a pair of CUDA events on the current stream while device timing
is on (``set_device_timing``), so ``device_snapshot()`` can report the
device time between the stage's start and end beside its host (enqueue)
time.  Off by default: two event records per stage cost a few
microseconds of host time each.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Tuple

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.utils.hatches import hatch_bool

_LOCK = threading.Lock()
_EVENTS: Dict[str, List[tuple]] = {}
_DEVICE_TIMING = False


def enabled() -> bool:
    return hatch_bool("POSEIDON_STAGE_TIMERS")


def set_device_timing(on: bool) -> None:
    global _DEVICE_TIMING
    _DEVICE_TIMING = bool(on)


def stage(name: str, device=None):
    """Context manager timing one stage (a tracer span; no-op unless
    stage timers or tracing are enabled), plus a CUDA event pair when
    device timing is on and ``device`` is a CUDA device."""
    if _DEVICE_TIMING and device is not None and device.type == "cuda":
        return _device_stage(name)
    return _trace.span(name)


@contextmanager
def _device_stage(name: str) -> Iterator[None]:
    import torch

    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    with _trace.span(name):
        try:
            yield
        finally:
            ev[1].record()
            with _LOCK:
                _EVENTS.setdefault(name, []).append(ev)


def snapshot() -> Dict[str, Tuple[float, int]]:
    """{stage: (total_seconds, calls)} accumulated since last reset."""
    return _trace.snapshot_totals()


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
    _trace.reset_totals()
    with _LOCK:
        _EVENTS.clear()


def report() -> str:
    rows = sorted(snapshot().items(), key=lambda kv: -kv[1][0])
    width = max((len(k) for k, _ in rows), default=4)
    lines = [f"{'stage'.ljust(width)}  total_s   calls  per_call_ms"]
    for k, (tot, n) in rows:
        lines.append(
            f"{k.ljust(width)}  {tot:7.3f}  {n:6d}  "
            f"{1000 * tot / max(n, 1):10.2f}"
        )
    return "\n".join(lines)

"""Round-history introspection ring: the last N rounds, queryable live.

The flight recorder answers "what happened in that failed soak" —
offline, from a written trace.  This module answers "what has this LIVE
process been doing" without any recording having been armed: the
planner records every completed round's schema-versioned metrics dict
(``RoundMetrics.to_dict``) plus its solver convergence-curve digests
(``ops.transport.SolveTelemetry.digest``) into a bounded process-wide
ring, and ``obs.metrics.MetricsServer`` serves it as JSON:

- ``GET /debug/rounds``   — one summary line per retained round;
- ``GET /debug/round/<n>`` — the full record of round ``n`` (404 with
  the retained range when it fell off the ring).

Capacity comes from ``POSEIDON_ROUND_HISTORY`` (default 128, read at
record time through the hatch registry); 0 disables recording.

Determinism discipline: this module never reads a clock itself — the
per-record timestamp comes from ``obs.trace.monotime()`` (the telemetry
plane's one clock owner), and exists only so ``/debug/rounds`` can
report each record's age.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.utils.hatches import hatch_int
from poseidon_tpu_torch.utils.locks import TrackedLock

# The summary keys /debug/rounds lifts out of each record's metrics
# dict (missing ones are simply absent — the endpoint must tolerate
# schema drift in both directions).
_SUMMARY_KEYS = (
    "solve_tier", "num_tasks", "num_ecs", "num_machines", "placed",
    "unscheduled", "iterations", "bf_sweeps", "device_calls",
    "solve_seconds", "total_seconds", "gap_bound", "converged",
    "telem_samples", "telem_iters_to_90",
)


class RoundHistory:
    """Bounded ring of per-round records, keyed by round index."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = TrackedLock("obs.RoundHistory._lock")
        self._records: "OrderedDict[int, dict]" = OrderedDict()
        # None = read the hatch at record time (the process-wide
        # default history must honor env changes per the call-time
        # discipline); tests pass a fixed capacity.
        self._capacity = capacity

    def capacity(self) -> int:
        if self._capacity is not None:
            return self._capacity
        return max(0, hatch_int("POSEIDON_ROUND_HISTORY", 128))

    def record(self, metrics: dict, curves: Optional[List[dict]] = None,
               ) -> None:
        """Retain one round.  ``metrics`` is the RoundMetrics wire dict
        (anything with a ``round_index`` key works); ``curves`` the
        per-band convergence digests (JSON-safe dicts)."""
        cap = self.capacity()
        if cap <= 0:
            return
        metrics = dict(metrics)
        idx = int(metrics.get("round_index", -1))
        rec = {
            "round": idx,
            "ts": _trace.monotime(),
            "metrics": metrics,
            "curves": list(curves or ()),
        }
        with self._lock:
            self._records.pop(idx, None)
            self._records[idx] = rec
            while len(self._records) > cap:
                self._records.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def summaries(self) -> List[dict]:
        """The /debug/rounds payload: newest last, one small dict per
        retained round (age in seconds, headline metrics)."""
        now = _trace.monotime()
        with self._lock:
            records = list(self._records.values())
        out = []
        for rec in records:
            m = rec["metrics"]
            s: Dict[str, object] = {
                "round": rec["round"],
                "age_s": round(now - rec["ts"], 3),
                "curves": len(rec["curves"]),
            }
            for key in _SUMMARY_KEYS:
                if key in m:
                    s[key] = m[key]
            out.append(s)
        return out

    def get(self, round_index: int) -> Optional[dict]:
        """The full record of one round (metrics + curve digests), or
        None when it was never recorded / fell off the ring."""
        now = _trace.monotime()
        with self._lock:
            rec = self._records.get(int(round_index))
            if rec is None:
                return None
            rec = dict(rec)
        rec["age_s"] = round(now - rec.pop("ts"), 3)
        return rec

    def retained_range(self) -> Optional[tuple]:
        """(oldest, newest) retained round indices, or None when empty."""
        with self._lock:
            if not self._records:
                return None
            keys = list(self._records)
        return (min(keys), max(keys))

    def latest(self) -> Optional[tuple]:
        """(round_index, monotime ts) of the newest record, or None —
        the /healthz fallback liveness signal for processes that drive
        the planner directly (bench, tools) and never feed
        ``observe_round``."""
        with self._lock:
            if not self._records:
                return None
            rec = next(reversed(self._records.values()))
        return (rec["round"], rec["ts"])


_HISTORY = RoundHistory()


def default_history() -> RoundHistory:
    return _HISTORY

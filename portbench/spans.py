"""Helpers of the readers of the program's own spans: ``rec["spans"]``,
each recorded span of a traced run as (name, start, end) on the host
clock.  A reader returns None in an untraced run or where the program
recorded no span of the name it reads."""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.readers import rounds


def named(rec: dict, name: str) -> List[Tuple[float, float]]:
    """The intervals of the spans called ``name``, by start."""
    if not rec.get("trace"):
        return []
    return sorted((a, b) for n, a, b in rec.get("spans", ()) if n == name)


def mean_in_window_ms(rec: dict, name: str) -> Optional[float]:
    """Mean milliseconds of the spans called ``name`` that start in the
    window."""
    w0, w1 = rec["window"]
    d = [b - a for a, b in named(rec, name) if w0 <= a < w1]
    return 1e3 * sum(d) / len(d) if d else None


def overlap(intervals, walls) -> float:
    """Seconds of ``intervals`` that lie inside the intervals ``walls``."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in intervals for lo, hi in walls)


def server_walls(rec: dict, kind: str) -> List[Tuple[float, float]]:
    """Each round of ``kind`` that took a snapshot, on the server: from
    the harness's start of the planner's round to the end of its
    bookkeeping, [t0, t2]."""
    return [(r["server"]["t0"], r["server"]["t2"])
            for r in rounds(rec, kind, with_view=True)]

"""Seconds the collector paused this process inside burst rounds (on the
server), per burst round; timed by ``gc.callbacks``."""

from portbench.readers import rounds


def read(rec):
    rs = rounds(rec, "burst")
    if not rec.get("trace") or not rs:
        return None
    total = 0.0
    for r in rs:
        lo, hi = r["server"]["t0"], r["server"]["t1"]
        for t, d, *_ in rec.get("gc", []):
            total += max(0.0, min(t + d, hi) - max(t, lo))
    return total / len(rs)

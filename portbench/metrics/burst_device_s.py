"""Device seconds per burst round: the time in which some device
operation (kernel, copy or fill, from the profiler's trace) ran within
the bursts' client walls, over the window's bursts."""

from portbench import tracing
from portbench.readers import client_spans


def read(rec):
    spans = client_spans(rec, "burst")
    if not spans or not rec.get("ops"):
        return None
    covered, _ = tracing.busy(rec["ops"], spans)
    return covered / len(spans) if covered > 0 else None

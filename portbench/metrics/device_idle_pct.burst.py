"""Share of the burst rounds' client walls in which no device operation
ran (profiler trace), in percent."""

from portbench.readers import client_spans, idle_pct


def read(rec):
    return idle_pct(rec, client_spans(rec, "burst"))

"""Share of the traced window in which no device operation ran
(profiler trace), in percent."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, [tuple(rec["window"])])

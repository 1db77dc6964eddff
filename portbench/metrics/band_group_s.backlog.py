"""Seconds a band group takes to solve in the backlog's window rounds:
the program's ``round.band_group`` spans that start inside a window
round's server interval, averaged per span.  None untraced or where the
program records no such span."""

from portbench.readers import mean
from portbench.spans import named, server_walls


def read(rec):
    walls = server_walls(rec, "burst")
    return mean(b - a for a, b in named(rec, "round.band_group")
                if any(lo <= a < hi for lo, hi in walls))

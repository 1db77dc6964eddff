"""Client wall seconds of a burst round's ``Schedule()``, averaged over
the window's bursts: the served round as the client sees it."""

from portbench.readers import client_spans, mean


def read(rec):
    return mean(b - a for a, b in client_spans(rec, "burst"))

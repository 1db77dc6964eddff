"""Seconds the collector paused the server inside stream rounds (the
program's ``runtime.gc`` spans within each round's [t0, t2]), per
stream round that took a snapshot."""

from portbench.spans import named, overlap, server_walls


def read(rec):
    pauses = named(rec, "runtime.gc")
    walls = server_walls(rec, "stream")
    if not pauses or not walls:
        return None
    return overlap(pauses, walls) / len(walls)

"""Pods placed by a stream round that were accepted during an earlier
round, after its snapshot (the program's ``pod.missed_cut``, which ends
at the placing round's commit), per stream round that took a snapshot."""

from portbench.spans import named, server_walls


def read(rec):
    ends = [b for _, b in named(rec, "pod.missed_cut")]
    walls = server_walls(rec, "stream")
    if not ends or not walls:
        return None
    return sum(1 for t in ends
               if any(lo <= t <= hi for lo, hi in walls)) / len(walls)

"""Seconds ``Schedule()`` spends turning a burst round's deltas into
protobuf (the program's ``service.deltas_to_proto``, which runs after the
harness's wrap of the planner's round ends, inside the client's wall),
per burst round."""

from portbench.readers import client_spans
from portbench.spans import named, overlap


def read(rec):
    spans = named(rec, "service.deltas_to_proto")
    walls = client_spans(rec, "burst")
    if not spans or not walls:
        return None
    return overlap(spans, walls) / len(walls)

"""The share of the backlog's window rounds' B1 launches
(``fused_ladder.cu``, ``fused_ladder_columns.cu``) that ran as a column
cluster, in percent: the program's launch counters
``fused_ladder_columns`` over ``fused_ladder`` (every B1 launch), summed
over the traced window rounds (labelled ``burst``).  None untraced, where
no round launched B1, and where the program has no column counter."""

from portbench.readers import rounds


def read(rec):
    if not rec.get("trace"):
        return None
    launched = columns = 0
    for r in rounds(rec, "burst"):
        counts = r["server"].get("launches") or {}
        if "fused_ladder_columns" not in counts:
            continue
        launched += counts.get("fused_ladder", 0)
        columns += counts["fused_ladder_columns"]
    if launched == 0:
        return None
    return 100.0 * columns / launched

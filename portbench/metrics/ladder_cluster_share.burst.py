"""The share of the burst rounds' B1 launches (``fused_ladder.cu``) that
ran as a thread-block cluster, in percent: the program's launch counters
``fused_ladder_cluster`` over ``fused_ladder`` (every B1 launch), summed
over the traced burst rounds.  None untraced, where no round launched B1,
and where the program has no cluster counter."""

from portbench.readers import rounds


def read(rec):
    if not rec.get("trace"):
        return None
    launched = clustered = 0
    for r in rounds(rec, "burst"):
        counts = r["server"].get("launches") or {}
        if "fused_ladder_cluster" not in counts:
            continue
        launched += counts.get("fused_ladder", 0)
        clustered += counts["fused_ladder_cluster"]
    if launched == 0:
        return None
    return 100.0 * clustered / launched

"""Band groups the planner solved per window round of the backlog
(``RoundMetrics.band_groups``): 2 where the merge gate keeps the size
bands apart, 1 where it merges them.  None where the program has no such
count."""

from portbench.readers import mean, rounds


def read(rec):
    values = [(r.get("planner") or {}).get("band_groups")
              for r in rounds(rec, "burst")]
    return mean(v for v in values if v is not None)

"""EC rows per window round of the backlog whose members have waited a
round or more, so that their unscheduled cost has risen
(``RoundMetrics.escalated_ecs``).  None where the program has no such
count."""

from portbench.readers import mean, rounds


def read(rec):
    values = [(r.get("planner") or {}).get("escalated_ecs")
              for r in rounds(rec, "burst")]
    return mean(v for v in values if v is not None)

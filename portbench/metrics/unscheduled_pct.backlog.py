"""How contended the backlog's window rounds are: the pods they left
unscheduled over the pods they saw (``RoundMetrics.unscheduled`` and
``num_tasks``, summed over the rounds), in percent."""

from portbench.readers import rounds


def read(rec):
    left = seen = 0
    for r in rounds(rec, "burst"):
        p = r.get("planner") or {}
        if p.get("unscheduled") is None or p.get("num_tasks") is None:
            continue
        left += p["unscheduled"]
        seen += p["num_tasks"]
    return 100.0 * left / seen if seen else None

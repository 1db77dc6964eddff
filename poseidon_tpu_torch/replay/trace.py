"""Synthetic cluster-trace generation (Google-trace-shaped).

Statistical shape follows the published Google cluster-trace analyses the
Firmament work replays (reference README.md:4): heavy-tailed job sizes
(most jobs are small, a few are very large), heterogeneous machine
classes, task durations spanning minutes to hours, and a steady arrival
process.  Events are (time, kind, payload) tuples replayed in order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TraceEvent:
    time: float
    kind: str  # "machine_add" | "machine_remove" | "job_submit" | "task_end"
    # machine_add:    (machine_id, cpu_millicores, ram_kb)
    # machine_remove: (machine_id,)
    # job_submit:  (job_id, num_tasks, cpu_millicores, ram_kb, duration_s)
    # task_end:    (job_id, task_index)
    payload: Tuple


# Machine classes loosely after the Google trace's platform mix:
# (weight, cpu millicores, ram KB).
MACHINE_CLASSES = [
    (0.53, 16_000, 32 << 20),
    (0.31, 32_000, 64 << 20),
    (0.16, 64_000, 128 << 20),
]


def synthesize_trace(
    num_machines: int,
    num_jobs: int,
    *,
    horizon_s: float = 3600.0,
    seed: int = 0,
    mean_tasks_per_job: float = 8.0,
    max_tasks_per_job: int = 512,
    remove_frac: float = 0.0,
) -> List[TraceEvent]:
    """Machines join at t<0 (initial fleet); jobs arrive Poisson over the
    horizon with Zipf-ish task counts and lognormal durations.

    ``remove_frac`` > 0 injects capacity pressure: that fraction of the
    fleet is REMOVED at random times in the middle half of the horizon
    (the Google trace's machine-churn events; resource_desc.proto's
    trace_machine_id exists for exactly this replay path).  Tasks running
    there are evicted and re-placed; under a rebalancing planner
    (reschedule_running) the shrunken capacity also forces PREEMPT /
    MIGRATE deltas on the survivors."""
    rng = np.random.default_rng(seed)
    events: List[TraceEvent] = []

    weights = np.array([w for w, _, _ in MACHINE_CLASSES])
    classes = rng.choice(len(MACHINE_CLASSES), size=num_machines,
                         p=weights / weights.sum())
    for i in range(num_machines):
        _, cpu, ram = MACHINE_CLASSES[int(classes[i])]
        events.append(TraceEvent(0.0, "machine_add", (i, cpu, ram)))

    arrivals = np.sort(rng.uniform(0.0, horizon_s, size=num_jobs))
    # Heavy-tailed task counts: geometric body + occasional big jobs.
    sizes = np.minimum(
        rng.geometric(1.0 / mean_tasks_per_job, size=num_jobs),
        max_tasks_per_job,
    )
    big = rng.random(num_jobs) < 0.02
    sizes[big] = rng.integers(64, max_tasks_per_job, size=int(big.sum()))
    cpus = rng.choice([100, 250, 500, 1000, 2000, 4000], size=num_jobs,
                      p=[0.35, 0.25, 0.18, 0.12, 0.07, 0.03])
    rams = (rng.choice([1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22],
                       size=num_jobs,
                       p=[0.3, 0.3, 0.25, 0.1, 0.05]))
    durations = np.minimum(rng.lognormal(5.5, 1.2, size=num_jobs), 6 * 3600)

    for j in range(num_jobs):
        t = float(arrivals[j])
        events.append(
            TraceEvent(
                t, "job_submit",
                (j, int(sizes[j]), int(cpus[j]), int(rams[j]),
                 float(durations[j])),
            )
        )

    if remove_frac > 0.0:
        n_remove = int(num_machines * remove_frac)
        victims = rng.choice(num_machines, size=n_remove, replace=False)
        times = rng.uniform(0.25 * horizon_s, 0.75 * horizon_s,
                            size=n_remove)
        for mid, t in zip(victims.tolist(), times.tolist()):
            events.append(TraceEvent(float(t), "machine_remove", (mid,)))

    events.sort(key=lambda e: (e.time, e.kind))
    return events

"""The general traffic generator: clusters, burst batches and the
open loop's plan of timed events, all made from a configuration file, a
traffic file and the run's seed.  NumPy only; the same seed gives the
same inputs.

Every seed gets the same work in another order: machine classes come in
exact proportions, task shapes are drawn by stratified quantiles (one
draw in each of N equal slices of the range) and then shuffled, and
each stretch of an open loop holds a fixed number of arrivals and
completions.  So seeds differ in which pod has which shape and when it
arrives, not in how much there is to place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference import Machines

# An open loop's arriving pods' uids start here; burst batch b's (and an
# open loop's running set, batch 0) at (b + 1) << 32.
START_WINDOW = 1 << 40
# The kinds of a plan's events (the client's plan format).
SUBMIT, COMPLETE, SCHEDULE = 0, 1, 2


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one part of the inputs: the seed (any integer up
    to 64 bits) and the part's keys."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *keys])


def _stratified(rng, n: int) -> np.ndarray:
    """n uniforms, one in each slice [k/n, (k+1)/n), shuffled."""
    u = (np.arange(n) + rng.random(n)) / max(n, 1)
    return rng.permutation(u)


def _exact_counts(weights, n: int) -> np.ndarray:
    """Integer counts in proportion to ``weights`` that sum to n
    (largest remainders)."""
    w = np.asarray(weights, np.float64)
    raw = w / w.sum() * n
    counts = np.floor(raw).astype(np.int64)
    short = n - int(counts.sum())
    order = np.argsort(-(raw - counts), kind="stable")
    counts[order[:short]] += 1
    return counts


def _categorical(rng, values, probs, n: int) -> np.ndarray:
    """n draws in exact proportion to ``probs``, shuffled."""
    counts = _exact_counts(probs, n)
    return rng.permutation(np.repeat(np.asarray(values), counts))


# --------------------------------------------------------------- machines

def machines(config: dict, seed: int) -> Machines:
    """The fleet of ``config["machines"]``: ``count`` machines from
    ``classes`` (cpu millicores, ram KB, slots), in turn
    (``layout: round_robin``) or in exact proportion to each class's
    ``weight`` in a seeded order (``layout: weighted``)."""
    spec = config["machines"]
    n = int(spec["count"])
    classes = spec["classes"]
    if spec["layout"] == "round_robin":
        cls = np.arange(n) % len(classes)
    elif spec["layout"] == "weighted":
        cls = _categorical(rng_for(seed, 1), np.arange(len(classes)),
                           [c["weight"] for c in classes], n)
    else:
        raise ValueError(f"unknown machine layout {spec['layout']!r}")
    cpu = np.array([classes[k]["cpu"] for k in cls], np.int64)
    ram = np.array([classes[k]["ram_kb"] for k in cls], np.int64)
    slots = np.array([classes[k]["slots"] for k in cls], np.int64)
    return Machines([f"node-{i:05d}" for i in range(n)], cpu, ram, slots)


# ------------------------------------------------------------------ burst

@dataclass
class Batch:
    """One batch job: its id and per pod uid, cpu (millicores), ram (KB)."""

    job: str
    uid: np.ndarray
    cpu: np.ndarray
    ram: np.ndarray


def burst_batch(config: dict, seed: int, step: int) -> Batch:
    """Batch ``step``: ``pods.count`` pods over ``pods.shapes`` task
    shapes drawn afresh for (seed, step), cpu in [cpu[0], cpu[1]) and
    ram in [ram_kb[0], ram_kb[1]), each shape held by an equal share of
    the pods."""
    spec = config["pods"]
    n, s = int(spec["count"]), int(spec["shapes"])
    rng = rng_for(seed, 2, step)
    lo, hi = spec["cpu"]
    cpu_s = (lo + np.floor(_stratified(rng, s) * (hi - lo))).astype(np.int64)
    lo, hi = spec["ram_kb"]
    ram_s = (lo + np.floor(_stratified(rng, s) * (hi - lo))).astype(np.int64)
    shape = rng.permutation(np.arange(n) % s)
    uid = ((step + 1) << 32) + np.arange(n, dtype=np.int64)
    return Batch(f"batch-{step}", uid.astype(np.uint64), cpu_s[shape],
                 ram_s[shape])


# -------------------------------------------------------------- open loop

@dataclass
class Plan:
    """An open loop's inputs.

    ``running``: the pods placed in set-up (one in-process
    ``Schedule()``), running when the loop starts.  ``t``, ``kind``,
    ``uid``, ``job``, ``cpu``, ``ram``, ``dur``: the loop's events in
    time order, in wall seconds from the loop's start: SUBMIT a pod
    (``job`` names its job; ``dur``, where not NaN, completes it that
    long after its placement reaches the client), COMPLETE a pod, or
    SCHEDULE (one ``Schedule()`` call).  A plan with no SCHEDULE event
    calls ``Schedule()`` in a loop that waits ``gap_s`` after each
    reply.  The window is [``warm_s``, ``warm_s`` + seconds)."""

    running: Batch
    t: np.ndarray
    kind: np.ndarray
    uid: np.ndarray
    job: np.ndarray
    cpu: np.ndarray
    ram: np.ndarray
    dur: np.ndarray
    gap_s: float
    warm_s: float

    def submits(self) -> np.ndarray:
        return np.flatnonzero(self.kind == SUBMIT)


def plan(uid, t, kind, job=None, cpu=None, ram=None, dur=None, *,
         running: Batch, gap_s: float, warm_s: float) -> Plan:
    """A plan from per-event arrays (payloads default to 0, ``dur`` to
    NaN), sorted by time; equal times keep their given order."""
    n = len(t)

    def col(a, fill, dtype):
        return (np.full(n, fill, dtype) if a is None
                else np.asarray(a, dtype))

    order = np.argsort(np.asarray(t, np.float64), kind="stable")
    return Plan(running, np.asarray(t, np.float64)[order],
                np.asarray(kind, np.int8)[order],
                np.asarray(uid, np.uint64)[order],
                col(job, 0, np.int64)[order], col(cpu, 0, np.int64)[order],
                col(ram, 0, np.int64)[order],
                col(dur, np.nan, np.float64)[order], float(gap_s),
                float(warm_s))


def churn(config: dict, traffic: dict, seed: int, seconds: float,
          rate: float) -> Plan:
    """The churn of a running cluster: set-up places the configuration's
    batch (``burst_batch`` step 0); then pods of the same task shapes
    arrive at ``rate`` a second, each of its shape's job, and for each
    arrival ``completions_per_arrival`` of the running batch's pods,
    drawn at random, complete, at times of their own.  The warm-up
    (``warm_s``), the window (``seconds``) and the tail (``tail_s``)
    each hold their share of both exactly, at uniform times within it.
    ``Schedule()`` runs in a loop that waits ``schedule_gap_s`` after
    each reply."""
    running = burst_batch(config, seed, 0)
    # The batch's task shapes.
    shapes = np.unique(np.stack([running.cpu, running.ram]), axis=1)
    rng = rng_for(seed, 4)
    segs = [float(traffic["warm_s"]), float(seconds),
            float(traffic["tail_s"])]
    per = float(traffic["completions_per_arrival"])
    n_arr = [int(round(rate * length)) for length in segs]
    n_comp = [int(round(per * n)) for n in n_arr]
    if sum(n_comp) > running.uid.size:
        raise ValueError(f"{sum(n_comp)} completions of "
                         f"{running.uid.size} running pods")
    t_a, t_c, t0 = [], [], 0.0
    for length, na, nc in zip(segs, n_arr, n_comp):
        t_a.append(t0 + np.sort(rng.random(na)) * length)
        t_c.append(t0 + rng.random(nc) * length)
        t0 += length
    t_a, t_c = np.concatenate(t_a), np.concatenate(t_c)
    # Every shape takes an equal share of the arrivals.
    n = t_a.size
    shape = rng.permutation(np.arange(n) % shapes.shape[1])
    comp = running.uid[rng.choice(running.uid.size, size=t_c.size,
                                  replace=False)]
    nc = t_c.size
    uid = np.concatenate([START_WINDOW + np.arange(n, dtype=np.int64),
                          comp.astype(np.int64)])
    kind = np.concatenate([np.full(n, SUBMIT), np.full(nc, COMPLETE)])
    job = np.concatenate([shape, np.zeros(nc, np.int64)])
    cpu = np.concatenate([shapes[0, shape], np.zeros(nc, np.int64)])
    ram = np.concatenate([shapes[1, shape], np.zeros(nc, np.int64)])
    return plan(uid, np.concatenate([t_a, t_c]), kind, job, cpu, ram,
                running=running, gap_s=float(traffic["schedule_gap_s"]),
                warm_s=segs[0])

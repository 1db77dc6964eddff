"""Declarative, seed-reproducible scenario plans.

A ``ScenarioPlan`` is the workload twin of the chaos ``FaultPlan``
(chaos/plan.py): a frozen per-round schedule — pod arrivals, departures,
node churn — generated from a seeded RNG, so the same (name, seed,
machines, rounds) always yields the same plan bit-for-bit.  The flight
recorder stores both the generation inputs AND the materialized plan, so
a recorded scenario trace stays re-drivable even if generator logic
evolves.

Vocabulary (the scenario driver, ``scenario/drive.py``, executes it
against the full glue stack):

===============  =========================================================
field            meaning
===============  =========================================================
arrivals         pods created this round (name, shape, owner, labels,
                 selectors, affinity) — the production-shaped demand
completions      N oldest Running pods transition to Succeeded (job
                 completion / autoscale-down of the workload)
deletions        N oldest Succeeded pods are deleted (GC lifecycle)
drain_nodes      nodes drained this round: every Running pod on them is
                 completed, then the node is cordoned (unschedulable —
                 the node watcher lowers that to a machine removal), in
                 that order inside one round so the scheduler never holds
                 placements on a vanished machine
add_nodes        nodes added this round (autoscaler scale-up)
===============  =========================================================

Label-ish fields are sorted ``(key, value)`` tuples — plans are frozen
and hashable; the driver lowers them back to dicts at the kube boundary.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

KVPairs = Tuple[Tuple[str, str], ...]


def kv(d: Dict[str, str]) -> KVPairs:
    """Dict -> canonical (sorted) tuple form for frozen plan fields."""
    return tuple(sorted((str(k), str(v)) for k, v in d.items()))


@dataclass(frozen=True)
class PodArrival:
    """One pod creation: the scheduling-relevant slice only (the driver
    fills in namespace/scheduler defaults at the kube boundary)."""

    name: str
    cpu: int                      # millicores
    ram: int                      # KB
    owner: str = ""               # owner UID: groups pods into jobs
    labels: KVPairs = ()
    node_selector: KVPairs = ()
    pod_affinity: KVPairs = ()
    pod_anti_affinity: KVPairs = ()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "cpu": self.cpu, "ram": self.ram,
            "owner": self.owner, "labels": [list(p) for p in self.labels],
            "node_selector": [list(p) for p in self.node_selector],
            "pod_affinity": [list(p) for p in self.pod_affinity],
            "pod_anti_affinity": [
                list(p) for p in self.pod_anti_affinity
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PodArrival":
        def pairs(key: str) -> KVPairs:
            return tuple(
                (str(k), str(v)) for k, v in d.get(key) or []
            )
        return cls(
            name=str(d["name"]), cpu=int(d["cpu"]), ram=int(d["ram"]),
            owner=str(d.get("owner", "")),
            labels=pairs("labels"),
            node_selector=pairs("node_selector"),
            pod_affinity=pairs("pod_affinity"),
            pod_anti_affinity=pairs("pod_anti_affinity"),
        )

    def ec_key(self) -> tuple:
        """The equivalence-class-shaping slice: pods identical here
        aggregate into one EC on the service side (request + selector
        terms + labels; gang jobs additionally split per owner because
        each gang solves as its own atomic row)."""
        gang = dict(self.labels).get("gangScheduling", "") == "true"
        return (
            self.cpu, self.ram, self.labels, self.node_selector,
            self.pod_affinity, self.pod_anti_affinity,
            self.owner if gang else "",
        )


@dataclass(frozen=True)
class ScenarioRound:
    """One round's workload mutations (see module docstring table)."""

    round_index: int
    arrivals: Tuple[PodArrival, ...] = ()
    completions: int = 0
    deletions: int = 0
    drain_nodes: Tuple[str, ...] = ()
    add_nodes: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {
            "round": self.round_index,
            "arrivals": [a.to_dict() for a in self.arrivals],
            "completions": self.completions,
            "deletions": self.deletions,
            "drain_nodes": list(self.drain_nodes),
            "add_nodes": list(self.add_nodes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioRound":
        return cls(
            round_index=int(d["round"]),
            arrivals=tuple(
                PodArrival.from_dict(a) for a in d.get("arrivals") or []
            ),
            completions=int(d.get("completions", 0)),
            deletions=int(d.get("deletions", 0)),
            drain_nodes=tuple(
                str(n) for n in d.get("drain_nodes") or []
            ),
            add_nodes=tuple(str(n) for n in d.get("add_nodes") or []),
        )


@dataclass(frozen=True)
class ScenarioPlan:
    """A named, seeded workload schedule over a drive's rounds.

    ``node_labels`` assigns labels to the INITIAL fleet (and to nodes a
    round adds later) — the multi-tenant scenario zones its machines
    this way so nodeSelector terms resolve."""

    name: str
    seed: int
    machines: int
    rounds: Tuple[ScenarioRound, ...]
    node_labels: Tuple[Tuple[str, KVPairs], ...] = field(default=())

    def __post_init__(self) -> None:
        for i, rnd in enumerate(self.rounds):
            if rnd.round_index != i:
                raise ValueError(
                    f"plan {self.name!r}: round {i} carries "
                    f"round_index {rnd.round_index} — rounds must be "
                    "contiguous from 0"
                )

    @property
    def total_rounds(self) -> int:
        return len(self.rounds)

    def for_round(self, round_index: int) -> ScenarioRound:
        return self.rounds[round_index]

    def node_label_map(self) -> Dict[str, Dict[str, str]]:
        return {name: dict(pairs) for name, pairs in self.node_labels}

    def total_arrivals(self) -> int:
        return sum(len(r.arrivals) for r in self.rounds)

    def max_window_ec_keys(self, window: int = 3) -> int:
        """Upper bound on distinct ECs pending in any round: the union
        of arrival EC keys across a sliding window (unplaced work from
        round r-1/r-2 can still be pending alongside round r's).  The
        driver sizes the service's ``max_ecs`` bucket from this."""
        best = 1
        for r in range(self.total_rounds):
            keys = set()
            for rnd in self.rounds[max(r - window + 1, 0):r + 1]:
                keys.update(a.ec_key() for a in rnd.arrivals)
            best = max(best, len(keys))
        return best

    # ------------------------------------------------------------- wire form

    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed,
            "machines": self.machines,
            "rounds": [r.to_dict() for r in self.rounds],
            "node_labels": [
                [name, [list(p) for p in pairs]]
                for name, pairs in self.node_labels
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioPlan":
        return cls(
            name=str(d["name"]), seed=int(d["seed"]),
            machines=int(d["machines"]),
            rounds=tuple(
                ScenarioRound.from_dict(r) for r in d["rounds"]
            ),
            node_labels=tuple(
                (str(name), tuple((str(k), str(v)) for k, v in pairs))
                for name, pairs in d.get("node_labels") or []
            ),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioPlan":
        return cls.from_dict(json.loads(text))

    def digest(self) -> str:
        """Content digest of the materialized plan: the determinism
        tests pin that two same-seed generations are bit-identical."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


def workload_events(plan: ScenarioPlan):
    """Lower a scenario plan onto the replay harness's ``TraceEvent``
    vocabulary (machines at t=0, arrivals grouped by shape as
    job_submits at 10 s round boundaries, node churn as machine
    add/remove) — the planner-only offline view of the population."""
    from poseidon_tpu_torch.chaos.harness import NODE_CPU, NODE_RAM
    from poseidon_tpu_torch.replay.trace import TraceEvent

    node_index: Dict[str, int] = {}
    events: List[TraceEvent] = []
    for i in range(plan.machines):
        node_index[f"m{i:04d}"] = i
        events.append(TraceEvent(0.0, "machine_add", (i, NODE_CPU, NODE_RAM)))
    horizon = 10.0 * (plan.total_rounds + 1)
    for rnd in plan.rounds:
        t = rnd.round_index * 10.0
        for name in rnd.add_nodes:
            idx = node_index.setdefault(name, len(node_index))
            events.append(TraceEvent(t, "machine_add", (idx, NODE_CPU, NODE_RAM)))
        for name in rnd.drain_nodes:
            if name in node_index:
                events.append(
                    TraceEvent(t, "machine_remove", (node_index[name],))
                )
        by_shape: Dict[tuple, int] = {}
        for a in rnd.arrivals:
            by_shape[(a.cpu, a.ram)] = by_shape.get((a.cpu, a.ram), 0) + 1
        for j, (shape, count) in enumerate(sorted(by_shape.items())):
            events.append(TraceEvent(
                t, "job_submit",
                (rnd.round_index * 100 + j, count, shape[0], shape[1],
                 horizon),
            ))
    events.sort(key=lambda e: (e.time, e.kind))
    return events

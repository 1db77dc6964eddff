"""Declarative, seed-reproducible fault plans.

A ``FaultPlan`` is a frozen per-round schedule of ``Fault``s drawn from a
seeded RNG: the same (name, seed, rounds) always yields the same plan, so
a soak failure is re-runnable bit-for-bit and the flight recorder only
needs to store the generation inputs, not the faults themselves (though
it stores both — a trace must stay loadable if generation logic evolves).

Fault taxonomy (the JAX package's docs/CHAOS.md has the full
semantics; this module is its numpy-only copy):

==========  ====================  ==========================================
family      kinds                 injected where
==========  ====================  ==========================================
watch       disconnect            the kube watch stream: buffered events are
                                  dropped and an ERROR (stale
                                  resourceVersion) is delivered; the watcher
                                  must resync (re-list + re-watch).
events      stall / dup /         the kube watch stream: delivery pauses for
            reorder               the rest of the round (events land one
                                  round late), an event is delivered twice,
                                  or two adjacent events for *different*
                                  objects swap (per-object order is the
                                  informer contract and is never broken).
rpc         unavailable /         the Firmament client's RPC stubs: the
            deadline /            named RPC raises UNAVAILABLE (pre-commit;
            schedule_partial /    client retry must absorb it),
            schedule_lost         DEADLINE_EXCEEDED pre-commit, a Schedule()
                                  round that only places a fraction of the
                                  pending work (service-side partial
                                  response), or — the nastiest — a
                                  Schedule() whose response is lost AFTER
                                  the service committed (post-commit
                                  deadline; heals via the glue's suspect
                                  reconciler, so it is NOT in the smoke plan
                                  whose per-round divergence gate is
                                  zero-tolerance).
binding     bind_fail             ``KubeAPI.bind_pod``: the next ``value``
                                  PLACE enactments raise; the glue must
                                  requeue the pod and roll the scheduler
                                  view back.
solver      uncertified           the planner's solve path: certification is
                                  forced to fail, escalating the round to
                                  the host-greedy degraded tier.
==========  ====================  ==========================================
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAMILIES: Tuple[str, ...] = ("watch", "events", "rpc", "binding", "solver")

# kind -> family (the vocabulary the injector dispatches on).
KINDS: Dict[str, str] = {
    "disconnect_pods": "watch",
    "disconnect_nodes": "watch",
    "stall_pods": "events",
    "stall_nodes": "events",
    "dup_pods": "events",
    "dup_nodes": "events",
    "reorder_pods": "events",
    "reorder_nodes": "events",
    "rpc_unavailable": "rpc",
    "rpc_deadline": "rpc",
    "schedule_partial": "rpc",
    "schedule_lost": "rpc",
    "bind_fail": "binding",
    "solver_uncertified": "solver",
}

# RPCs eligible for rpc_unavailable/rpc_deadline targeting.  Kept to the
# calls every soak round is guaranteed to make (Schedule from the loop,
# TaskSubmitted from the churn pods' watcher path), so an armed rpc
# fault always actually FIRES — the acceptance gate requires every
# family to fire, not merely to be scheduled.
_RPC_TARGETS: Tuple[str, ...] = ("Schedule", "TaskSubmitted")


@dataclass(frozen=True)
class Fault:
    """One armed fault: fires in ``round_index``, parameterized by
    ``value`` (stall length in polls, bind-failure count, partial-round
    placement fraction in percent) and ``target`` (RPC name for the rpc
    family; empty otherwise)."""

    round_index: int
    kind: str
    value: int = 0
    target: str = ""

    @property
    def family(self) -> str:
        return KINDS[self.kind]

    def to_dict(self) -> dict:
        return {
            "round": self.round_index, "kind": self.kind,
            "value": self.value, "target": self.target,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(
            round_index=int(d["round"]), kind=str(d["kind"]),
            value=int(d.get("value", 0)), target=str(d.get("target", "")),
        )


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded schedule of faults over a soak's rounds."""

    name: str
    seed: int
    rounds: int
    faults: Tuple[Fault, ...]

    @classmethod
    def generate(
        cls,
        name: str,
        seed: int,
        rounds: int,
        *,
        kinds: Optional[Sequence[str]] = None,
        faults_per_round: float = 0.75,
        quiet_head: int = 1,
    ) -> "FaultPlan":
        """Seeded schedule: on average ``faults_per_round`` faults per
        round, cycling kind coverage so every requested kind fires at
        least once when ``rounds`` allows.  Round indices below
        ``quiet_head`` stay fault-free (round 0 pays cold compiles and
        the initial sync; perturbing it tests nothing extra and makes
        warm-compile accounting ambiguous)."""
        rng = np.random.default_rng(seed)
        pool = tuple(kinds) if kinds is not None else tuple(KINDS)
        for k in pool:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        usable = max(rounds - quiet_head, 1)
        n = max(int(round(usable * faults_per_round)), len(pool))
        faults: List[Fault] = []
        for i in range(n):
            # Cycle the pool first (coverage), then draw randomly.
            kind = (
                pool[i] if i < len(pool)
                else pool[int(rng.integers(len(pool)))]
            )
            r = quiet_head + int(rng.integers(usable))
            value = 0
            target = ""
            if kind.startswith("stall"):
                value = int(rng.integers(2, 6))
            elif kind == "bind_fail":
                value = int(rng.integers(1, 3))
            elif kind == "schedule_partial":
                value = int(rng.integers(30, 80))  # percent placed
            elif kind in ("rpc_unavailable", "rpc_deadline"):
                target = _RPC_TARGETS[int(rng.integers(len(_RPC_TARGETS)))]
            faults.append(Fault(r, kind, value, target))
        # Sorted by (round, kind, target): the schedule is a pure function
        # of the inputs, not of generation order.
        faults.sort(key=lambda f: (f.round_index, f.kind, f.target, f.value))
        return cls(name=name, seed=seed, rounds=rounds, faults=tuple(faults))

    def for_round(self, round_index: int) -> List[Fault]:
        return [f for f in self.faults if f.round_index == round_index]

    def families_covered(self) -> Tuple[str, ...]:
        return tuple(sorted({f.family for f in self.faults}))

    # ------------------------------------------------------------- wire form

    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed, "rounds": self.rounds,
            "faults": [f.to_dict() for f in self.faults],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            name=str(d["name"]), seed=int(d["seed"]),
            rounds=int(d["rounds"]),
            faults=tuple(Fault.from_dict(x) for x in d["faults"]),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))


# Kinds safe for the zero-divergence smoke gate: every fault here either
# fails pre-commit or keeps both views consistent by construction, so the
# soak's per-round byte-identical check holds on every round.
# ``schedule_lost`` (post-commit response loss) is deliberately absent —
# it diverges for one round by design and is exercised by its own test
# (the suspect reconciler heals it).
SMOKE_KINDS: Tuple[str, ...] = (
    "disconnect_pods", "disconnect_nodes",
    "stall_pods", "dup_pods", "reorder_pods", "stall_nodes",
    "rpc_unavailable", "rpc_deadline", "schedule_partial",
    "bind_fail", "solver_uncertified",
)


def named_plan(name: str, rounds: int, seed: int = 0) -> FaultPlan:
    """The committed plan registry (the soak's named plans)."""
    if name == "none":
        return FaultPlan(name=name, seed=seed, rounds=rounds, faults=())
    if name == "smoke":
        # At least one fault from every family, zero-divergence kinds
        # only: the plan the acceptance gate runs.
        return FaultPlan.generate(
            name, seed, rounds, kinds=SMOKE_KINDS, faults_per_round=1.0
        )
    if name == "all":
        return FaultPlan.generate(
            name, seed, rounds, kinds=tuple(KINDS), faults_per_round=1.25
        )
    raise KeyError(f"unknown fault plan {name!r}; known: none, smoke, all")

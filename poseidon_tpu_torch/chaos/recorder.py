"""Flight recorder: every soak round's inputs and outcomes, replayable.

The recorder rides the soak harness and keeps, per round: the faults
that fired, the enacted deltas, the round metrics, and the
placement-state digest (the byte-identity check's value).  On a failure
— a round that raises, a divergence, or a fatally-stopped loop — it
writes a ``FlightTrace`` JSON under ``out/soak/`` containing everything
needed to re-drive the soak offline to the identical failing round:

- the workload spec (machines, pod population, churn — all seeded),
- the fault plan (both the generation inputs AND the materialized
  faults, so the trace outlives plan-generation changes),
- the per-round record stream, and
- the failure (round index, kind, repr).

``poseidon_tpu_torch/replay/flight.py`` loads these traces and re-drives
them to the same round digests, and
``FlightTrace.to_trace_events()`` lowers the workload onto the replay
harness's ``TraceEvent`` vocabulary for planner-only offline analysis.

The scenario harness (``poseidon_tpu_torch/scenario``) records through the
same recorder with ``spec["kind"] == "scenario"`` and the full
``ScenarioPlan`` dict embedded at ``spec["plan"]`` — trace lowering and
redrive dispatch on that kind; everything else is shared.

Deliberately wall-clock-free: rounds are the only time axis a
reproducible trace can carry.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from poseidon_tpu_torch.chaos.plan import FaultPlan

TRACE_FORMAT = 1


@dataclass
class FlightTrace:
    """The on-disk artifact (one JSON object)."""

    spec: dict                       # run_soak kwargs (seeded workload)
    plan: dict                       # FaultPlan.to_dict()
    rounds: List[dict] = field(default_factory=list)
    failure: Optional[dict] = None   # {round, kind, error} once failed
    format: int = TRACE_FORMAT

    def to_dict(self) -> dict:
        return {
            "format": self.format,
            "spec": self.spec,
            "plan": self.plan,
            "rounds": self.rounds,
            "failure": self.failure,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FlightTrace":
        if int(d.get("format", 0)) != TRACE_FORMAT:
            raise ValueError(
                f"flight trace format {d.get('format')!r} != {TRACE_FORMAT}"
            )
        return cls(
            spec=dict(d["spec"]),
            plan=dict(d["plan"]),
            rounds=list(d["rounds"]),
            failure=d.get("failure"),
        )

    @classmethod
    def load(cls, path: str) -> "FlightTrace":
        with open(path, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    def fault_plan(self) -> FaultPlan:
        return FaultPlan.from_dict(self.plan)

    def to_trace_events(self):
        """Lower the workload spec onto the replay harness's
        ``TraceEvent`` vocabulary (machines join at t<0-equivalent time
        0, each round's pod batch becomes a ``job_submit`` at the round
        boundary), so ``replay.ReplayDriver`` can re-drive the same
        population planner-only — the offline triage path when the full
        glue stack is not wanted.  Dispatches on ``spec["kind"]``:
        scenario traces lower through the ScenarioPlan embedded in the
        spec, everything else through the soak workload generator."""
        if self.spec.get("kind") == "scenario":
            from poseidon_tpu_torch.scenario.plan import (
                ScenarioPlan,
                workload_events,
            )

            return workload_events(ScenarioPlan.from_dict(self.spec["plan"]))
        from poseidon_tpu_torch.chaos.soak import workload_events

        return workload_events(self.spec)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, sort_keys=True, indent=1)
            fh.write("\n")
        os.replace(tmp, path)
        return path


class FlightRecorder:
    """Accumulates round records; writes the trace on failure."""

    def __init__(self, spec: dict, plan: FaultPlan,
                 out_dir: str = "out/soak") -> None:
        self.trace = FlightTrace(spec=dict(spec), plan=plan.to_dict())
        self.out_dir = out_dir
        self.path: Optional[str] = None

    def record_round(
        self,
        round_index: int,
        *,
        faults: List[dict],
        deltas: List[dict],
        metrics: dict,
        digest: str,
        placements: int,
        spans: Optional[List[dict]] = None,
        counters: Optional[List[dict]] = None,
    ) -> None:
        record = {
            "round": round_index,
            "faults": faults,
            "deltas": deltas,
            "metrics": metrics,
            "digest": digest,
            "placements": placements,
        }
        if spans:
            # The round's obs.trace span window (telemetry payload, not
            # replay input: redrive compares digests only).  Offline,
            # ``replay/flight.flight_timeline`` lowers these back to a
            # Perfetto-loadable Chrome trace of the failing round.
            record["spans"] = spans
        if counters:
            # Convergence counter samples (obs.trace counter tracks):
            # flight_timeline re-renders them next to the spans.
            record["counters"] = counters
        self.trace.rounds.append(record)

    def record_failure(self, round_index: int, kind: str,
                       error: str) -> str:
        """Mark the failing round and write the trace; returns the
        path.  Idempotent per recorder (one failure per soak)."""
        self.trace.failure = {
            "round": round_index, "kind": kind, "error": error,
        }
        name = self.trace.spec.get("name", "soak")
        seed = self.trace.spec.get("seed", 0)
        self.path = os.path.join(
            self.out_dir, f"flight_{name}_s{seed}_r{round_index}.json"
        )
        return self.trace.save(self.path)

"""Flight-trace loading + offline re-drive.

A soak failure (poseidon_tpu_torch/chaos) leaves a ``FlightTrace`` JSON under
``out/soak/``; a scenario failure (poseidon_tpu_torch/scenario) leaves one
under ``out/scenario/`` with ``spec["kind"] == "scenario"``.  This
module is the replay-side consumer:

- ``load_flight(path)`` parses the trace;
- ``redrive_flight(path)`` reconstructs the SAME run — seeded soak
  workload + fault plan, or the embedded ScenarioPlan — and re-drives
  it round by round up to the recorded failing round, checking each
  round's placement digest against the recorded one.  A clean re-drive
  (``reproduced=True``) means the failure's entire input state is on
  disk and the failing round can be studied offline at will;
- ``flight_trace_events(path)`` lowers the workload onto the replay
  harness's ``TraceEvent`` vocabulary for planner-only analysis
  (``ReplayDriver`` accepts the result directly — no glue stack, no
  faults, just the population);
- ``flight_timeline(path)`` re-renders a recorded round's span window
  (the obs.trace spans the soak drained into each round record) as
  Chrome trace-event JSON — the failing round's Perfetto timeline,
  reconstructed offline from the trace alone.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from poseidon_tpu_torch.replay.trace import TraceEvent


def load_flight(path: str):
    """Parse a flight trace written by the chaos recorder."""
    from poseidon_tpu_torch.chaos.recorder import FlightTrace

    return FlightTrace.load(path)


def flight_trace_events(path: str) -> List[TraceEvent]:
    """The trace's workload as replay TraceEvents."""
    return load_flight(path).to_trace_events()


def flight_timeline(path: str, round_index: Optional[int] = None,
                    out_path: Optional[str] = None) -> dict:
    """Re-render a recorded round's span timeline from a flight trace.

    ``round_index`` defaults to the recorded failing round (falling back
    to the last recorded round — a soak that failed before its first
    record has no timeline to render, which raises).  Returns the
    Chrome trace-event JSON object (``obs.trace.chrome_trace``); with
    ``out_path`` it is also written to disk, ready for
    https://ui.perfetto.dev."""
    from poseidon_tpu_torch.obs.trace import chrome_trace

    trace = load_flight(path)
    explicit = round_index is not None
    if round_index is None:
        failure = trace.failure or {}
        round_index = int(failure.get("round", len(trace.rounds) - 1))
    by_round = {int(r["round"]): r for r in trace.rounds}
    record = by_round.get(round_index)
    if record is None and explicit:
        # An explicitly requested round must exist: silently rendering
        # a different round would have the caller debugging the wrong
        # timeline.  The fallback below is for the DEFAULT path only.
        raise ValueError(
            f"{path}: round {round_index} has no recorded span window "
            f"(recorded rounds: {sorted(by_round)})"
        )
    if record is None and trace.rounds:
        # The failing round often never completed (its record is the
        # failure itself): the last COMPLETED round's timeline is the
        # closest recorded view of the run's final state.
        record = trace.rounds[-1]
        round_index = int(record["round"])
    if record is None:
        raise ValueError(f"{path}: no recorded rounds to render")
    spans = record.get("spans") or []
    counters = record.get("counters") or []
    obj = chrome_trace(spans, counters)
    obj["flightMeta"] = {
        "trace": os.path.basename(path),
        "round": round_index,
        "spans": len(spans),
        "counters": len(counters),
    }
    if out_path is not None:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(obj, fh)
            fh.write("\n")
    return obj


def redrive_flight(path: str, *, device: Optional[str] = None) -> dict:
    """Re-drive a recorded soak or scenario to its failing round.

    Returns the re-drive's result plus ``reproduced``: True when
    every re-driven round's placement digest matches the recording —
    i.e. the trace deterministically reconstructs the exact pre-failure
    state.  The failure itself (a killed service, a divergence) is an
    environmental event the re-drive does NOT repeat; what it proves is
    that the recorded inputs land you on the identical failing round.

    Dispatches on ``spec["kind"]``: scenario traces re-drive the
    embedded ``ScenarioPlan`` through ``scenario.drive_scenario`` in the
    recorded loop mode (and with the recorded cost-perturbation seed,
    if any); everything else re-drives through ``chaos.soak.run_soak``.
    ``device`` is the re-drive's server device (the card unless
    ``"cpu"``)."""
    trace = load_flight(path)
    spec = trace.spec
    failure = trace.failure or {}
    failing_round = int(failure.get("round", len(trace.rounds)))
    expect = [r["digest"] for r in trace.rounds]
    if spec.get("kind") == "scenario":
        from poseidon_tpu_torch.scenario.drive import drive_scenario
        from poseidon_tpu_torch.scenario.plan import ScenarioPlan

        result = drive_scenario(
            ScenarioPlan.from_dict(spec["plan"]),
            streaming=bool(spec.get("streaming")),
            perturb_seed=spec.get("perturb_seed"),
            amplitude=spec.get("amplitude"),
            until_round=failing_round,
            expect_digests=expect,
            device=device,
        )
        result["failing_round"] = failing_round
        result["reproduced"] = (
            result.get("reproduced", False)
            and result["rounds_run"] == failing_round
        )
        return result
    from poseidon_tpu_torch.chaos.soak import run_soak

    result = run_soak(
        machines=int(spec["machines"]),
        rounds=int(spec["rounds"]),
        plan=str(spec["name"]),
        seed=int(spec["seed"]),
        pods_per_machine=int(spec["pods_per_machine"]),
        churn=int(spec["churn"]),
        settle_rounds=int(spec["settle_rounds"]),
        until_round=failing_round,
        expect_digests=expect,
        device=device,
    )
    result["failing_round"] = failing_round
    result["reproduced"] = (
        result.get("reproduced", False)
        and result["rounds_run"] == failing_round
    )
    return result

"""The soak harness: N rounds of the FULL stack under a fault plan.

One soak = FakeKube (wrapped in ``ChaoticKube``) + the real pod/node
watchers + the real gRPC firmament-tpu service + the real
``FirmamentClient`` (fault-wrapped stubs) + the production schedule-loop
failure policy (``Poseidon.try_round``), driven round by round with a
seeded workload while the armed faults fire.  The stack itself — build,
node-sync barrier, per-round drive/retry policy, quiesce, ledger
windows, teardown — is the shared ``chaos/harness.py`` ``DriveStack``
(also consumed by the scenario driver, ``scenario/drive.py``), so after
EVERY round the soak asserts the single-sourced gates:

- **zero state divergence**: the fake-kube truth (bound Running pods)
  and the scheduler's view (RUNNING tasks' placements), joined through
  the glue's id maps, are byte-identical;
- **zero compile events on warm rounds** (the compile ledger,
  check/ledger.py: no kernel load and no solve key's first sight), and
  zero implicit transfers, numeric anomalies and new lock-order edges;
- progress: the workload keeps placing (checked at the end: after the
  fault window plus a short settle, every pod is Running).

Determinism is the third gate: the whole soak — workload, fault plan,
retry jitter — is seeded, so a re-run with the same spec produces the
same per-round placement digests (``run_soak`` returns them; the smoke
test compares two runs).

On any failure the ``FlightRecorder`` writes a trace under ``out_dir``
(``out/soak/`` by default) that ``replay/flight.py`` re-drives offline
to the identical failing round.  The port of the JAX package's
``chaos/soak.py``: the server solves on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from poseidon_tpu_torch.chaos.harness import (
    NODE_CPU,
    NODE_RAM,
    POD_SHAPES,
    DriveFailure,
    DriveStack,
    LedgerWindow,
    await_effect,
    metrics_wire,
    view_digest,
)
from poseidon_tpu_torch.chaos.inject import FaultInjector
from poseidon_tpu_torch.chaos.plan import FaultPlan, named_plan
from poseidon_tpu_torch.chaos.recorder import FlightRecorder
from poseidon_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("poseidon.chaos.soak")

def _spec(name: str, seed: int, machines: int, rounds: int,
          pods_per_machine: int, churn: int, settle_rounds: int) -> dict:
    return {
        "name": name, "seed": seed, "machines": machines,
        "rounds": rounds, "pods_per_machine": pods_per_machine,
        "churn": churn, "settle_rounds": settle_rounds,
    }


def _pod_batches(spec: dict) -> List[List[dict]]:
    """Per-round pod creation batches, a pure function of the spec.

    Round 0 carries the initial population; every later round (settle
    rounds included — churn does not stop while the system recovers)
    adds ``churn`` pods.  A slice of each batch is owner-grouped to
    exercise the job/owner-uid paths."""
    rng = np.random.default_rng(spec["seed"])
    total_rounds = spec["rounds"] + spec["settle_rounds"]
    batches: List[List[dict]] = []
    for r in range(total_rounds):
        n = (
            spec["machines"] * spec["pods_per_machine"] if r == 0
            else spec["churn"]
        )
        batch = []
        for i in range(n):
            cpu, ram = POD_SHAPES[int(rng.integers(len(POD_SHAPES)))]
            batch.append({
                "name": f"soak-r{r}-{i}",
                "cpu": cpu,
                "ram": ram,
                "owner": f"soak-job-r{r}-{i % 4}" if i % 3 == 0 else "",
            })
        batches.append(batch)
    return batches


def workload_events(spec: dict):
    """Lower the soak workload onto the replay harness's ``TraceEvent``
    vocabulary (machines at t=0, each round's batch as job_submits at
    10 s round boundaries) — the planner-only offline view of the same
    population."""
    from poseidon_tpu_torch.replay.trace import TraceEvent

    events = [
        TraceEvent(0.0, "machine_add", (i, NODE_CPU, NODE_RAM))
        for i in range(spec["machines"])
    ]
    horizon = 10.0 * (spec["rounds"] + spec["settle_rounds"] + 1)
    for r, batch in enumerate(_pod_batches(spec)):
        by_shape: Dict[tuple, int] = {}
        for pod in batch:
            by_shape[(pod["cpu"], pod["ram"])] = (
                by_shape.get((pod["cpu"], pod["ram"]), 0) + 1
            )
        for j, (shape, count) in enumerate(sorted(by_shape.items())):
            events.append(TraceEvent(
                r * 10.0, "job_submit",
                (r * 100 + j, count, shape[0], shape[1], horizon),
            ))
    events.sort(key=lambda e: (e.time, e.kind))
    return events


def run_soak(
    machines: int = 200,
    rounds: int = 10,
    plan: str = "smoke",
    seed: int = 0,
    *,
    pods_per_machine: int = 4,
    churn: Optional[int] = None,
    settle_rounds: int = 2,
    out_dir: str = "out/soak",
    until_round: Optional[int] = None,
    expect_digests: Optional[Sequence[str]] = None,
    on_round: Optional[Callable[[int, dict], None]] = None,
    device: Optional[str] = None,
) -> dict:
    """Run one soak; returns the result artifact (never raises for soak
    failures — they come back as ``ok=False`` plus a written flight
    trace).

    ``until_round``/``expect_digests`` are the re-drive interface
    (replay/flight.py): stop after that many rounds and compare each
    round's digest against the recorded one.  ``on_round(r, ctx)`` is a
    test hook fired after the round is armed but before its workload
    mutations; ``ctx`` exposes the live pieces (server, kube, poseidon,
    injector) so a test can, e.g., kill the Firmament stub mid-soak.
    ``device`` is the server's solve device (the card unless ``"cpu"``;
    the result's ``device`` names the one the planner used).
    """
    from poseidon_tpu_torch.glue.fake_kube import Pod

    churn = churn if churn is not None else max(machines // 20, 4)
    spec = _spec(plan, seed, machines, rounds, pods_per_machine, churn,
                 settle_rounds)
    fault_plan: FaultPlan = named_plan(plan, rounds, seed)
    injector = FaultInjector(fault_plan)
    recorder = FlightRecorder(spec, fault_plan, out_dir=out_dir)
    batches = _pod_batches(spec)
    total_rounds = rounds + settle_rounds
    if until_round is not None:
        total_rounds = min(total_rounds, until_round)

    result: dict = {
        "ok": False, "plan": plan, "seed": seed, "machines": machines,
        "rounds_requested": rounds, "rounds_run": 0,
        "families_covered": list(fault_plan.families_covered()),
        "digests": [], "warm_fresh_compiles": 0,
        "warm_implicit_transfers": 0, "warm_numeric_anomalies": 0,
        "warm_lock_order_edges": [],
        "lock_contention_ns": 0, "tiers": [],
        "divergent_rounds": 0, "cost_delta_hits": 0,
    }
    if expect_digests is not None:
        result["digest_mismatches"] = []

    stack = DriveStack(
        machines, seed=seed, injector=injector, ledger_label="chaos soak",
        device=device,
    ).start(health_timeout=30.0)
    result["device"] = str(stack.server.servicer.planner.device)
    kube, poseidon = stack.kube, stack.poseidon
    ctx = {
        "server": stack.server, "kube": kube, "poseidon": poseidon,
        "injector": injector,
    }

    def _round_faults(r: int) -> List[dict]:
        return [e for e in injector.fired if e["round"] == r]

    try:
        stack.arm(sync_timeout=30.0)

        for r in range(total_rounds):
            injector.begin_round(r)
            if on_round is not None:
                on_round(r, ctx)
            # Workload churn: this round's creations, plus completion +
            # deletion of earlier cohorts (completions two rounds back,
            # deletions of the completed cohort one round later) so the
            # finished/removed lifecycle paths run under fault too.
            for podspec in batches[r]:
                kube.create_pod(Pod(
                    name=podspec["name"], cpu_request=podspec["cpu"],
                    ram_request=podspec["ram"],
                    owner_uid=podspec["owner"],
                ))
            completed: List[str] = []
            deleted: List[str] = []
            if r >= 3:
                inner = kube.inner
                for podspec in batches[r - 2][:max(churn // 4, 1)]:
                    key = f"default/{podspec['name']}"
                    pod = inner.pods.get(key)
                    if pod is not None and pod.phase == "Running":
                        kube.set_pod_phase(key, "Succeeded")
                        completed.append(key)
                for podspec in batches[r - 3][:max(churn // 4, 1)]:
                    key = f"default/{podspec['name']}"
                    pod = inner.pods.get(key)
                    if pod is not None and pod.phase == "Succeeded":
                        kube.delete_pod("default", podspec["name"])
                        deleted.append(key)
            # Delivery barrier (skipped while the pod stream is chaos-
            # held — those events land a round late by design): created
            # pods must resolve to tasks, completed pods must finish
            # (uid stops resolving), deleted pods must untrack; then the
            # queue drain proves the RPCs behind them completed.
            if not injector.is_stalled("pods"):
                created = [f"default/{p['name']}" for p in batches[r]]
                await_effect(
                    lambda: all(
                        poseidon.shared.uid_for_pod(k) is not None
                        for k in created
                    ) and all(
                        poseidon.shared.uid_for_pod(k) is None
                        for k in completed + deleted
                    ),
                    20.0,
                )
            poseidon.drain_watchers(timeout=30.0)

            window = LedgerWindow()
            stack.drive_round(r, drain_timeout=60.0)
            window.close()
            if r >= 1:
                result["warm_fresh_compiles"] += window.fresh_compiles
                # The transfer budget-0 window rides NEXT to the compile
                # one: a warm soak round doing implicit device->host
                # syncs is the same silent-latency bug class
                # (TransferLedger).
                result["warm_implicit_transfers"] += (
                    window.implicit_transfers
                )
                # Fourth budget-0 gate (NumericsLedger): the soak-wide
                # window validates every fetched value, so a warm-round
                # anomaly means a solve handed the planner a non-finite
                # or rail-riding number — silent corruption, the
                # numeric twin of a fresh compile in a warm round.
                result["warm_numeric_anomalies"] += (
                    window.numeric_anomalies
                )
                # Third budget-0 gate (LockLedger): round 0 latches the
                # steady-state lock-acquisition-order graph; a WARM
                # round growing it means a thread explored a nesting no
                # earlier round did — a latent ordering (deadlock-
                # candidate) path, the dynamic twin of posecheck's
                # lock-order rule.
                result["warm_lock_order_edges"].extend(
                    window.new_lock_order_edges
                )

            kube_truth, sched_view = stack.quiesce(heal_timeout=10.0)
            metrics = stack.server.servicer.planner.last_metrics
            metrics_d = window.stamp(metrics_wire(metrics), prefix="soak")
            result["lock_contention_ns"] += window.lock_contention_ns
            result["tiers"].append(stack.check_tier(metrics, r))
            result["cost_delta_hits"] += metrics.cost_delta_hits
            digest = view_digest(kube_truth)
            result["digests"].append(digest)
            result["rounds_run"] = r + 1
            recorder.record_round(
                r,
                faults=_round_faults(r),
                deltas=[
                    {"type": int(d.type), "task": int(d.task_id),
                     "resource": d.resource_id}
                    for d in poseidon.last_deltas
                ],
                metrics=metrics_d,
                digest=digest,
                placements=len(kube_truth),
                spans=obs_trace.drain_spans(),
                # Convergence counter samples ride next to the spans so
                # flight_timeline re-renders the curves offline too.
                counters=obs_trace.drain_counter_samples(),
            )
            if kube_truth != sched_view:
                only_kube = sorted(
                    set(kube_truth.items()) - set(sched_view.items())
                )[:5]
                only_sched = sorted(
                    set(sched_view.items()) - set(kube_truth.items())
                )[:5]
                result["divergent_rounds"] += 1
                raise DriveFailure(
                    "divergence",
                    f"kube-only={only_kube} scheduler-only={only_sched}",
                    r,
                )
            if expect_digests is not None and r < len(expect_digests) \
                    and digest != expect_digests[r]:
                result["digest_mismatches"].append(
                    {"round": r, "expected": expect_digests[r],
                     "got": digest}
                )

        if until_round is None:
            pending = stack.pending_pods()
            if pending:
                raise DriveFailure(
                    "unplaced",
                    f"{len(pending)} pods still Pending after settle: "
                    f"{pending[:5]}",
                    total_rounds,
                )
            if result["warm_fresh_compiles"]:
                raise DriveFailure(
                    "fresh-compiles",
                    f"{result['warm_fresh_compiles']} compile events "
                    "in warm rounds (budget 0)",
                    total_rounds,
                )
            if result["warm_implicit_transfers"]:
                raise DriveFailure(
                    "implicit-transfers",
                    f"{result['warm_implicit_transfers']} implicit "
                    "device->host sync(s) in warm rounds (budget 0)",
                    total_rounds,
                )
            if result["warm_numeric_anomalies"]:
                raise DriveFailure(
                    "numeric-anomalies",
                    f"{result['warm_numeric_anomalies']} numeric "
                    "anomaly(ies) in warm rounds (budget 0): a fetched "
                    "value was non-finite or rode the int32 rails — see "
                    "the NumericsLedger offenders in the flight trace",
                    total_rounds,
                )
            if result["warm_lock_order_edges"]:
                raise DriveFailure(
                    "lock-order-edges",
                    f"{len(result['warm_lock_order_edges'])} new lock-"
                    "acquisition-order edge(s) in warm rounds (budget "
                    f"0): {result['warm_lock_order_edges'][:5]}",
                    total_rounds,
                )
        result["ok"] = True
        if expect_digests is not None:
            result["reproduced"] = not result["digest_mismatches"]
            result["ok"] = result["ok"] and result["reproduced"]
    except DriveFailure as e:
        result["failure"] = {"kind": e.kind, "detail": e.detail,
                             "round": e.round_index}
        result["trace_path"] = recorder.record_failure(
            e.round_index, e.kind, e.detail
        )
        result["failing_round"] = e.round_index
        log.error("soak failed (%s); flight trace: %s",
                  e, result["trace_path"])
    finally:
        stack.stop()

    result["fired"] = list(injector.fired)
    result["resyncs"] = stack.resyncs
    result["loop_stats"] = stack.loop_stats_dict()
    return result

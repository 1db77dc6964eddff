"""The scenario driver: a ScenarioPlan through the FULL glue stack.

One drive = the shared ``chaos/harness.py`` ``DriveStack`` (FakeKube +
the real pod/node watchers + the real gRPC firmament-tpu service + the
production ``Poseidon.try_round`` loop) executing a declarative
``ScenarioPlan`` round by round, in EITHER loop mode — the
``streaming`` flag flips ``POSEIDON_STREAMING`` for the drive and
restores it, exactly like the throughput rung, so synchronous and
streaming drives of the same plan are drain-equivalent and must place
identically.

Per-round gates (single-sourced in the harness, same as the chaos
soak): kube-truth/scheduler byte-identity, the warm-window budget-0
ledger quartet (Compile/Transfer/Lock/Numerics), solve-tier vocabulary,
and seeded determinism (per-round placement digests + per-round delta
digests; ``scenario_digest`` folds them all).  Every round records to
the flight recorder; on failure the trace lands under the scenario out
dir (``POSEIDON_SCENARIO_OUT``) and ``replay/flight.redrive_flight``
re-drives it offline to the identical round.

Robustness scoring (``scenario/score.py``) re-enters here with
``perturb_seed`` set: the planner's cost model is swapped for a
chaos-seeded ``PerturbedCostModel`` before the first round, and every
correctness gate stays armed — only placements/objective may move.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Callable, List, Optional, Sequence, Union

from poseidon_tpu_torch.chaos.harness import (
    DriveFailure,
    DriveStack,
    LedgerWindow,
    await_effect,
    metrics_wire,
    view_digest,
)
from poseidon_tpu_torch.chaos.plan import named_plan
from poseidon_tpu_torch.chaos.recorder import FlightRecorder
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.scenario.generate import named_scenario
from poseidon_tpu_torch.scenario.plan import ScenarioPlan
from poseidon_tpu_torch.utils.hatches import hatch_str

log = logging.getLogger("poseidon.scenario.drive")


def scenario_out_dir() -> str:
    """Flight-trace output dir for scenario drives (hatch-controlled)."""
    return hatch_str("POSEIDON_SCENARIO_OUT")


def _delta_digest(deltas: List[dict]) -> str:
    """Digest of one round's enacted delta stream (the generator-
    determinism suite compares these bit-for-bit across runs/modes)."""
    return hashlib.sha256(
        json.dumps(deltas, sort_keys=True).encode()
    ).hexdigest()[:16]


def scenario_digest(plan: ScenarioPlan, digests: Sequence[str],
                    delta_digests: Sequence[str]) -> str:
    """One digest for the whole drive: the plan content plus every
    round's placement digest and delta-stream digest."""
    h = hashlib.sha256()
    h.update(plan.digest().encode())
    for d in digests:
        h.update(d.encode())
    for d in delta_digests:
        h.update(d.encode())
    return h.hexdigest()[:16]


def drive_scenario(
    plan: Union[ScenarioPlan, str],
    *,
    streaming: bool = False,
    machines: Optional[int] = None,
    rounds: Optional[int] = None,
    seed: int = 0,
    perturb_seed: Optional[int] = None,
    amplitude: Optional[float] = None,
    out_dir: Optional[str] = None,
    until_round: Optional[int] = None,
    expect_digests: Optional[Sequence[str]] = None,
    on_round: Optional[Callable[[int, dict], None]] = None,
    device: Optional[str] = None,
) -> dict:
    """Drive one scenario plan; returns the result artifact (never
    raises for drive failures — they come back as ``ok=False`` plus a
    written flight trace).

    ``plan`` is a materialized ``ScenarioPlan`` or a registry name
    (``machines``/``rounds``/``seed`` parameterize generation then).
    ``until_round``/``expect_digests`` are the re-drive interface
    (replay/flight.py).  ``perturb_seed`` installs a chaos-seeded
    ``PerturbedCostModel`` (scenario/score.py) over the planner's cost
    model before the first round.  ``on_round(r, ctx)`` is a test hook
    fired before the round's workload mutations; ``ctx`` exposes the
    live pieces (server, kube, poseidon, stack).  ``device`` is the
    server's solve device (the card unless ``"cpu"``; the result's
    ``device`` names the one the planner used)."""
    from poseidon_tpu_torch.glue.fake_kube import Node, Pod
    from poseidon_tpu_torch.ops.transport import bucket_size

    if isinstance(plan, str):
        plan = named_scenario(
            plan, machines=machines or 32, rounds=rounds or 8, seed=seed
        )
    out_dir = out_dir if out_dir is not None else scenario_out_dir()
    mode = "streaming" if streaming else "synchronous"
    spec = {
        "kind": "scenario",
        "name": plan.name,
        "seed": plan.seed,
        "machines": plan.machines,
        "rounds": plan.total_rounds,
        "streaming": streaming,
        "perturb_seed": perturb_seed,
        "amplitude": amplitude,
        # The materialized plan rides in the spec: a recorded trace
        # stays re-drivable bit-for-bit even if generator logic evolves
        # (the FaultPlan trace makes the same promise for faults).
        "plan": plan.to_dict(),
    }
    # Scenario drives are fault-free (chaos belongs to the soak); the
    # recorder still wants a plan object for the trace.
    recorder = FlightRecorder(
        spec, named_plan("none", plan.total_rounds, plan.seed),
        out_dir=out_dir,
    )
    total_rounds = plan.total_rounds
    if until_round is not None:
        total_rounds = min(total_rounds, until_round)

    result: dict = {
        "ok": False, "scenario": plan.name, "seed": plan.seed,
        "machines": plan.machines, "mode": mode,
        "perturb_seed": perturb_seed,
        "rounds_requested": plan.total_rounds, "rounds_run": 0,
        "digests": [], "delta_digests": [], "tiers": [],
        "objective": 0, "objectives": [],
        "placements_per_sec": 0.0, "round_placements_per_sec": [],
        "admission_staleness_p50_s": 0.0,
        "admission_staleness_p99_s": 0.0,
        "warm_fresh_compiles": 0, "warm_implicit_transfers": 0,
        "warm_numeric_anomalies": 0, "warm_lock_order_edges": [],
        "lock_contention_ns": 0, "divergent_rounds": 0,
    }
    if expect_digests is not None:
        result["digest_mismatches"] = []

    # Size the EC bucket from the plan itself: the multi-tenant mix
    # (per-gang and per-app ECs) needs more rows than the four shared
    # shapes the soak budgets for.
    max_ecs = bucket_size(
        max(plan.max_window_ec_keys() * 2, 16), lo=8
    )

    # Save/restore of the raw env slot, not a semantic read — the
    # engine itself reads the flag through the hatch registry.
    prev = os.environ.get("POSEIDON_STREAMING")
    os.environ["POSEIDON_STREAMING"] = "1" if streaming else "0"
    stack = DriveStack(
        plan.machines, seed=plan.seed, injector=None, max_ecs=max_ecs,
        node_labels=plan.node_label_map(),
        ledger_label=f"scenario {plan.name}", device=device,
    ).start(health_timeout=30.0)
    result["device"] = str(stack.server.servicer.planner.device)
    kube, poseidon = stack.kube, stack.poseidon
    if perturb_seed is not None:
        from poseidon_tpu_torch.scenario.score import (
            PerturbedCostModel,
            perturb_amplitude,
        )

        amplitude = (
            amplitude if amplitude is not None else perturb_amplitude()
        )
        planner = stack.server.servicer.planner
        planner.set_cost_model(PerturbedCostModel(
            planner.cost_model, seed=perturb_seed, amplitude=amplitude,
        ))
        result["amplitude"] = amplitude
    ctx = {
        "server": stack.server, "kube": kube, "poseidon": poseidon,
        "stack": stack,
    }

    staleness: List[float] = []
    solve_seconds = 0.0
    placed_total = 0
    created_order: List[str] = []  # pod keys, creation order

    def _oldest(phase: str, n: int) -> List[str]:
        """The N oldest (by creation order) pods currently in
        ``phase`` — the deterministic completion/GC policy."""
        out: List[str] = []
        for key in created_order:
            if len(out) >= n:
                break
            pod = kube.pods.get(key)
            if pod is not None and pod.phase == phase:
                out.append(key)
        return out

    try:
        stack.arm(sync_timeout=30.0)

        for r in range(total_rounds):
            rnd = plan.for_round(r)
            if on_round is not None:
                on_round(r, ctx)
            # Node churn first: scale-ups join before this round's
            # demand, drains complete their residents and cordon the
            # node inside the SAME round (order matters — the watchers
            # see the evictions before the machine removal, so the
            # scheduler never holds placements on a vanished machine).
            for name in rnd.add_nodes:
                kube.add_node(Node(
                    name=name, cpu_capacity=stack.node_cpu,
                    ram_capacity=stack.node_ram,
                    labels=dict(plan.node_label_map().get(name, {})),
                ))
            drained_off: List[str] = []
            for name in rnd.drain_nodes:
                residents = sorted(
                    pod.key for pod in kube.pods.values()
                    if pod.phase == "Running" and pod.node_name == name
                )
                for key in residents:
                    kube.set_pod_phase(key, "Succeeded")
                drained_off.extend(residents)
                kube.update_node(
                    name, lambda n: setattr(n, "unschedulable", True)
                )
            # Workload mutations: arrivals, then the oldest-first
            # completion/GC policy (deterministic given deterministic
            # placements — which the digest gates themselves pin).
            created: List[str] = []
            for a in rnd.arrivals:
                kube.create_pod(Pod(
                    name=a.name, cpu_request=a.cpu, ram_request=a.ram,
                    owner_uid=a.owner,
                    labels=dict(a.labels),
                    node_selector=dict(a.node_selector),
                    pod_affinity=dict(a.pod_affinity),
                    pod_anti_affinity=dict(a.pod_anti_affinity),
                ))
                key = f"default/{a.name}"
                created.append(key)
                created_order.append(key)
            completed = _oldest("Running", rnd.completions)
            for key in completed:
                kube.set_pod_phase(key, "Succeeded")
            deleted = _oldest("Succeeded", rnd.deletions)
            for key in deleted:
                ns, name = key.split("/", 1)
                kube.delete_pod(ns, name)
                created_order.remove(key)
            # Delivery barrier: created pods resolve to tasks, finished
            # and deleted pods stop resolving, added nodes register,
            # cordoned nodes drop out of the shared map; then the queue
            # drain proves the RPCs behind them completed.
            gone = completed + deleted + drained_off
            await_effect(
                lambda: all(
                    poseidon.shared.uid_for_pod(k) is not None
                    for k in created
                ) and all(
                    poseidon.shared.uid_for_pod(k) is None for k in gone
                ) and all(
                    poseidon.shared.get_node(n) is not None
                    for n in rnd.add_nodes
                ) and all(
                    poseidon.shared.get_node(n) is None
                    for n in rnd.drain_nodes
                ),
                20.0,
            )
            poseidon.drain_watchers(timeout=30.0)

            window = LedgerWindow()
            stack.drive_round(r, drain_timeout=60.0)
            window.close()
            if r >= 1:
                result["warm_fresh_compiles"] += window.fresh_compiles
                result["warm_implicit_transfers"] += (
                    window.implicit_transfers
                )
                result["warm_numeric_anomalies"] += (
                    window.numeric_anomalies
                )
                result["warm_lock_order_edges"].extend(
                    window.new_lock_order_edges
                )

            kube_truth, sched_view = stack.quiesce(heal_timeout=10.0)
            metrics = stack.server.servicer.planner.last_metrics
            metrics_d = window.stamp(
                metrics_wire(metrics), prefix="scenario"
            )
            result["lock_contention_ns"] += window.lock_contention_ns
            result["tiers"].append(stack.check_tier(metrics, r))
            result["objective"] += int(metrics.objective)
            result["objectives"].append(int(metrics.objective))
            result["round_placements_per_sec"].append(
                float(metrics.placements_per_sec)
            )
            staleness.append(float(metrics.admission_staleness_s))
            solve_seconds += float(metrics.total_seconds)
            placed_total += int(metrics.placed)
            digest = view_digest(kube_truth)
            deltas = [
                {"type": int(d.type), "task": int(d.task_id),
                 "resource": d.resource_id}
                for d in poseidon.last_deltas
            ]
            delta_digest = _delta_digest(deltas)
            result["digests"].append(digest)
            result["delta_digests"].append(delta_digest)
            result["rounds_run"] = r + 1
            recorder.record_round(
                r,
                faults=[],
                deltas=deltas,
                metrics=metrics_d,
                digest=digest,
                placements=len(kube_truth),
                spans=obs_trace.drain_spans(),
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
                    "anomaly(ies) in warm rounds (budget 0)",
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
        log.error("scenario %s failed (%s); flight trace: %s",
                  plan.name, e, result["trace_path"])
    finally:
        stack.stop()
        if prev is None:
            os.environ.pop("POSEIDON_STREAMING", None)
        else:
            os.environ["POSEIDON_STREAMING"] = prev

    result["scenario_digest"] = scenario_digest(
        plan, result["digests"], result["delta_digests"]
    )
    result["placements_per_sec"] = (
        round(placed_total / solve_seconds, 2) if solve_seconds > 0
        else 0.0
    )
    if staleness:
        import numpy as np

        result["admission_staleness_p50_s"] = round(
            float(np.percentile(staleness, 50)), 6
        )
        result["admission_staleness_p99_s"] = round(
            float(np.percentile(staleness, 99)), 6
        )
    result["resyncs"] = stack.resyncs
    result["loop_stats"] = stack.loop_stats_dict()
    return result

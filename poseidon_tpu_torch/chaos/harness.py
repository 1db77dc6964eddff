"""Shared full-stack drive harness: one stack, one set of gates.

Both the chaos soak (``chaos/soak.py``) and the scenario driver
(``scenario/drive.py``) drive the SAME production stack — FakeKube
(optionally wrapped in ``ChaoticKube``) + the real pod/node watchers +
the real gRPC firmament-tpu service + the production schedule-loop
failure policy (``Poseidon.try_round``) — and assert the same per-round
gates.  This module single-sources that machinery so the byte-identity
comparison, the warm-window budget-0 ledger quartet
(Compile/Transfer/Lock/Numerics), and the teardown order cannot drift
between the two harnesses:

- ``DriveStack``: build/arm/drive/quiesce/stop for the full stack,
  including the node-sync barrier, synchronous precompile, forced span
  recording, and the soak-wide ``NumericsLedger`` window;
- ``LedgerWindow``: the per-round-attempt counter diff across all four
  ledgers plus lock contention;
- ``placement_views`` / ``view_digest``: the byte-identity gate's two
  sides and the digest the determinism gates compare;
- ``DriveFailure``: the typed failure both harnesses route through
  their flight recorder.

The port of the JAX package's ``chaos/harness.py``: the service is the
port's server, solving on the CUDA card unless the drive passes
``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from poseidon_tpu_torch.chaos.inject import ChaoticKube, chaotic_client
from poseidon_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("poseidon.chaos.harness")

# Pod request shapes: a narrow factor range so every round's pending set
# falls into the same solver size bands (compile-shape stability is one
# of the harness gates, so workloads must not smuggle new compile keys
# in mid-run).
POD_SHAPES = (
    (200, 1 << 19), (400, 1 << 19), (400, 1 << 20), (800, 1 << 20),
)
NODE_CPU = 32_000
NODE_RAM = 128 << 20

# The solve-tier vocabulary the byte-identity gate accepts.  Every tier
# of the planner's degraded ladder is legitimate under chaos — including
# "sharded" (the mesh-split dense solve, certified and deterministic) —
# but a tier string outside the ladder means the planner and the
# harness disagree about what ran, which no digest comparison can vouch
# for.
KNOWN_TIERS = ("none", "quiet", "pruned", "dense", "sharded",
               "host_greedy")


def await_effect(cond: Callable[[], bool], timeout: float) -> bool:
    """Poll ``cond`` until true or deadline.  The watchers' drain
    barrier alone is racy against the watch->KeyedQueue pump (an event
    still in the watch queue is invisible to ``drain_watchers``), so the
    harness synchronizes on the EFFECT — ids resolving in the glue's
    shared maps — before trusting a drain."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def placement_views(kube, poseidon, server) -> Tuple[dict, dict]:
    """(kube_truth, scheduler_view): pod key -> node name on both sides,
    joined through the glue id maps.  Entries only the scheduler knows
    surface under a synthetic ``<uid:...>`` key so they diverge loudly
    instead of vanishing from the comparison."""
    from poseidon_tpu_torch.graph.state import TaskState

    inner = kube.inner if isinstance(kube, ChaoticKube) else kube
    kube_truth = {
        pod.key: pod.node_name
        for pod in inner.pods.values()
        if pod.phase == "Running" and pod.node_name
    }
    sched_view = {}
    st = server.servicer.state
    with st._lock:
        running = {
            uid: task.scheduled_to
            for uid, task in st.tasks.items()
            if task.state == TaskState.RUNNING and task.scheduled_to
        }
    for uid, machine_uuid in running.items():
        pod = poseidon.shared.task_for_uid(uid)
        node = poseidon.shared.node_for_resource(machine_uuid)
        key = pod.key if pod is not None else f"<uid:{uid}>"
        sched_view[key] = node if node is not None else f"<res:{machine_uuid}>"
    return kube_truth, sched_view


def view_digest(view: Dict[str, str]) -> str:
    return hashlib.sha256(
        json.dumps(sorted(view.items())).encode()
    ).hexdigest()[:16]


def metrics_wire(metrics) -> dict:
    # One wire format for a round's metrics everywhere (flight traces,
    # the round-history ring, the Prometheus exporter): the schema-versioned
    # RoundMetrics.to_dict.
    return metrics.to_dict()


class DriveFailure(Exception):
    """A gate or drive failure at a specific round — both harnesses
    catch this type and route it through their flight recorder."""

    def __init__(self, kind: str, detail: str, round_index: int) -> None:
        super().__init__(f"{kind} (round {round_index}): {detail}")
        self.kind = kind
        self.detail = detail
        self.round_index = round_index


class LedgerWindow:
    """Counter marks across one round attempt, for all four budget-0
    ledgers (compile, transfer, lock-order, numerics) plus lock
    contention.  ``open()`` marks, ``close()`` diffs; the diff covers
    the WHOLE attempt window (retries, precompile straggle, watcher
    work), not just the planner's own solve span."""

    def __init__(self) -> None:
        from poseidon_tpu_torch.check.ledger import (
            fresh_compile_count,
            implicit_transfer_count,
            numeric_anomaly_count,
        )
        from poseidon_tpu_torch.utils.locks import (
            lock_contention_ns,
            lock_order_edge_count,
        )

        self._fresh0 = fresh_compile_count()
        self._transfers0 = implicit_transfer_count()
        self._anoms0 = numeric_anomaly_count()
        self._edges0 = lock_order_edge_count()
        self._contention0 = lock_contention_ns()
        self.fresh_compiles = 0
        self.implicit_transfers = 0
        self.numeric_anomalies = 0
        self.new_lock_order_edges: List[str] = []
        self.lock_contention_ns = 0

    def close(self) -> "LedgerWindow":
        from poseidon_tpu_torch.check.ledger import (
            fresh_compile_count,
            implicit_transfer_count,
            numeric_anomaly_count,
        )
        from poseidon_tpu_torch.utils.locks import (
            lock_contention_ns,
            lock_order_edges,
        )

        self.fresh_compiles = fresh_compile_count() - self._fresh0
        self.implicit_transfers = implicit_transfer_count() - self._transfers0
        self.numeric_anomalies = numeric_anomaly_count() - self._anoms0
        self.new_lock_order_edges = [
            f"{a} -> {b} ({site})"
            for a, b, site in lock_order_edges()[self._edges0:]
        ]
        self.lock_contention_ns = lock_contention_ns() - self._contention0
        return self

    def stamp(self, metrics_d: dict, prefix: str = "soak") -> dict:
        """Record the attempt-window diff next to the planner's own
        round metrics (the planner only sees its solve window; the
        harness window covers retries and watcher work too)."""
        metrics_d[f"{prefix}_fresh_compiles"] = self.fresh_compiles
        metrics_d[f"{prefix}_implicit_transfers"] = self.implicit_transfers
        metrics_d[f"{prefix}_numeric_anomalies"] = self.numeric_anomalies
        metrics_d[f"{prefix}_lock_order_edges"] = (
            len(self.new_lock_order_edges)
        )
        metrics_d[f"{prefix}_lock_contention_ns"] = self.lock_contention_ns
        return metrics_d


class DriveStack:
    """The full glue+service stack, built once per drive.

    Lifecycle: ``start()`` (construct server/kube/client/loop — hard
    exceptions propagate, nothing to record yet), ``arm()`` (forced span
    recording + numerics window + fleet registration + synchronous
    precompile — raises ``DriveFailure('setup', ...)``), per-round
    ``drive_round``/``quiesce``, then ``stop()`` in a ``finally``.
    ``stop()`` is safe whether or not ``arm()`` ever ran."""

    def __init__(
        self,
        machines: int,
        *,
        seed: int = 0,
        injector=None,
        max_ecs: Optional[int] = None,
        node_cpu: int = NODE_CPU,
        node_ram: int = NODE_RAM,
        node_names: Optional[List[str]] = None,
        node_labels: Optional[Dict[str, Dict[str, str]]] = None,
        ledger_label: str = "drive harness",
        device: Optional[str] = None,
    ) -> None:
        self.machines = machines
        self.device = device or "cuda"
        self.seed = seed
        self.injector = injector
        self.node_cpu = node_cpu
        self.node_ram = node_ram
        self.node_names = (
            list(node_names) if node_names is not None
            else [f"m{i:04d}" for i in range(machines)]
        )
        self.node_labels = dict(node_labels or {})
        self.ledger_label = ledger_label
        self._max_ecs = max_ecs
        self.server = None
        self.kube = None
        self.client = None
        self.poseidon = None
        self.cfg = None
        self._numled = None
        self._numled_entered = False
        self._tracer = None
        self._prev_force = None

    # ------------------------------------------------------------ build

    def start(self, health_timeout: float = 30.0) -> "DriveStack":
        from poseidon_tpu_torch.check.ledger import NumericsLedger
        from poseidon_tpu_torch.glue.fake_kube import FakeKube
        from poseidon_tpu_torch.glue.poseidon import Poseidon
        from poseidon_tpu_torch.ops.transport import bucket_size
        from poseidon_tpu_torch.service.server import FirmamentTPUServer
        from poseidon_tpu_torch.utils.config import (
            FirmamentTPUConfig,
            PoseidonConfig,
        )

        # Precompile the solver ladder at the drive's scale before the
        # first round, so round 0 pays every compile and the warm-round
        # budget-0 gate is unambiguous.
        server_cfg = FirmamentTPUConfig(
            precompile=True,
            max_ecs=(
                self._max_ecs if self._max_ecs is not None
                else bucket_size(len(POD_SHAPES) * 4, lo=8)
            ),
            max_machines=0,
            device=self.device,
        )
        self.server = FirmamentTPUServer(
            address="127.0.0.1:0", config=server_cfg
        ).start()
        if self.injector is not None:
            self.kube = ChaoticKube(FakeKube(), self.injector)
            self.client = chaotic_client(
                self.server.address, self.injector,
                rpc_timeout_s=10.0, rpc_retries=2, rpc_backoff_s=0.01,
                rpc_backoff_max_s=0.05, retry_seed=self.seed,
            )
        else:
            self.kube = FakeKube()
            self.client = None
        self.cfg = PoseidonConfig(
            firmament_address=self.server.address,
            scheduling_interval=3600,
            crash_loop_budget=4,
            crash_backoff_s=0.01,
            crash_backoff_max_s=0.05,
        )
        self.poseidon = Poseidon(
            self.kube, config=self.cfg, firmament=self.client,
            run_loop=False,
        ).start(health_timeout=health_timeout)
        self.server.servicer.planner.chaos = self.injector
        # Numerics-ledger window over the WHOLE drive: every host_fetch
        # is validated (finite floats, int32 fetch headroom) and every
        # saturation-certificate trip attributed.  Telemetry mode
        # (budget=None): the per-round counter diffs and the end-of-run
        # gates own the budget-0 assertion, so a numeric anomaly fails
        # through the flight-recorder path like every other gate
        # instead of as a bare exception out of a round body.
        self._numled = NumericsLedger(budget=None, label=self.ledger_label)
        # Span recording rides every drive (forced on without touching
        # the process environment): each round's spans are drained into
        # that round's flight record, so a failing round's timeline
        # re-renders offline.  The previous force flag is captured here
        # so ``stop()`` restores it even if ``arm()`` never runs.
        self._tracer = obs_trace.tracer()
        self._prev_force = self._tracer.force
        return self

    @property
    def inner_kube(self):
        return (
            self.kube.inner if isinstance(self.kube, ChaoticKube)
            else self.kube
        )

    def arm(self, sync_timeout: float = 30.0) -> None:
        """Force span recording, open the numerics window, register the
        fleet, and precompile — everything that must happen before
        round 0's ledger window opens."""
        from poseidon_tpu_torch.glue.fake_kube import Node

        self._tracer.force = True
        self._numled.__enter__()
        self._numled_entered = True
        obs_trace.drain_spans()  # a clean window: drop pre-drive spans
        obs_trace.drain_counter_samples()
        for name in self.node_names:
            self.kube.add_node(Node(
                name=name,
                cpu_capacity=self.node_cpu, ram_capacity=self.node_ram,
                labels=dict(self.node_labels.get(name, {})),
            ))
        # Barrier on the EFFECT, then the drain: every node must resolve
        # in the shared map (events left the watch queue) and the queues
        # must empty (the NodeAdded RPCs completed) before round 0 —
        # otherwise the service-side precompile sees a partial fleet.
        synced = await_effect(
            lambda: all(
                self.poseidon.shared.get_node(name) is not None
                for name in self.node_names
            ),
            sync_timeout,
        )
        if not (synced
                and self.poseidon.drain_watchers(timeout=sync_timeout)):
            raise DriveFailure("setup", "node sync never drained", 0)
        # Precompile SYNCHRONOUSLY, after the fleet registered (the
        # machine bucket derives from the live cluster) and before any
        # round's ledger window opens.  Left to the lazy first-Schedule
        # path, precompile keeps running in that handler thread after
        # the client's RPC deadline expires, and its compile-completion
        # events straggle into warm rounds' windows — a false budget-0
        # violation under load.
        self.server.servicer.ensure_precompiled()

    # ------------------------------------------------------------ drive

    def drive_round(self, r: int, drain_timeout: float = 60.0) -> None:
        """One production round through ``try_round``, retried under the
        crash-loop policy until it both schedules AND enacts cleanly."""
        for _attempt in range(2 * (self.cfg.crash_loop_budget + 1)):
            delay = self.poseidon.try_round()
            if delay is None:
                raise DriveFailure(
                    "fatal", self.poseidon.fatal or "loop stopped", r
                )
            # Streaming (POSEIDON_STREAMING=1): the round returns with
            # its enactment still in flight on the worker — join it
            # before the ledger diff and the divergence gate read
            # anything (a no-op in synchronous mode).  A failure parked
            # on the worker surfaces at the NEXT try_round's join, so
            # loop until a round both schedules AND enacts cleanly;
            # each parked failure burns one extra attempt, hence the
            # doubled bound (sync mode still exhausts the budget via
            # delay=None exactly as before).
            if not self.poseidon.drain_rounds(timeout=drain_timeout):
                raise DriveFailure(
                    "drain", "streaming enactment never drained", r
                )
            if (self.poseidon.loop_stats.consecutive_failures == 0
                    and not self.poseidon.enact_failed()):
                break
            # Failed round: the harness compresses the backoff delay
            # (the policy fired; sleeping it for real buys nothing).

    def quiesce(self, heal_timeout: float = 10.0) -> Tuple[dict, dict]:
        """Quiesce before the divergence gate: release chaos-held event
        streams (their damage — a round solved on stale knowledge — is
        done) and let the watchers drain, so the comparison sees the
        reconciled state, not delivery lag.  The gate itself then waits
        briefly for a match: delivery lag is transient and resolves
        under the wait, while a real divergence (a phantom placement, a
        missed rollback) is a fixed point no amount of waiting heals —
        THAT is what fails the drive."""
        if self.injector is not None:
            self.injector.flush_events()
        self.poseidon.drain_watchers(timeout=30.0)
        kube_truth, sched_view = placement_views(
            self.kube, self.poseidon, self.server
        )
        if kube_truth != sched_view:
            def _matches() -> bool:
                a, b = placement_views(
                    self.kube, self.poseidon, self.server
                )
                return a == b
            await_effect(_matches, heal_timeout)
            kube_truth, sched_view = placement_views(
                self.kube, self.poseidon, self.server
            )
        return kube_truth, sched_view

    def check_tier(self, metrics, r: int) -> str:
        if metrics.solve_tier not in KNOWN_TIERS:
            raise DriveFailure(
                "unknown-tier",
                f"solve_tier {metrics.solve_tier!r} outside the "
                f"ladder vocabulary {KNOWN_TIERS}",
                r,
            )
        return metrics.solve_tier

    def pending_pods(self) -> List[str]:
        return sorted(
            pod.key for pod in self.inner_kube.pods.values()
            if pod.phase == "Pending"
        )

    # ---------------------------------------------------------- results

    def loop_stats_dict(self) -> dict:
        stats = self.poseidon.loop_stats
        return {
            "rounds": stats.rounds, "placed": stats.placed,
            "preempted": stats.preempted, "migrated": stats.migrated,
            "failed_rounds": stats.failed_rounds,
            "bind_failures": stats.bind_failures,
            "requeued": stats.requeued,
        }

    @property
    def resyncs(self) -> int:
        return (
            self.poseidon.pod_watcher.resyncs
            + self.poseidon.node_watcher.resyncs
        )

    # --------------------------------------------------------- teardown

    def stop(self) -> None:
        if self._numled is not None:
            self._numled.__exit__(None, None, None)  # no-op if never entered
        if self._tracer is not None:
            self._tracer.force = self._prev_force
        if self.poseidon is not None:
            self.poseidon.stop()
        if self.server is not None:
            try:
                self.server.stop(grace=0.2)
            except Exception:  # noqa: BLE001 - a killed-mid-drive server is fine
                pass
        if self.client is not None:
            self.client.close()

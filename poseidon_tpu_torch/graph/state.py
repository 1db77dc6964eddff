"""Cluster state: the task/job/machine state machines behind the 13 RPCs.

Reply semantics are load-bearing: the Poseidon client ``glog.Fatalf``s on
NOT_FOUND / ALREADY_EXISTS / STATE_NOT_CREATED answers (reference
pkg/firmament/firmament_client.go:44-50 et al.), so this module answers
exactly as Firmament's state machine would:

- TaskSubmitted: known uid -> TASK_ALREADY_SUBMITTED; task in any state but
  CREATED cannot be (re)submitted -> TASK_STATE_NOT_CREATED; else OK.
- TaskCompleted/Failed/Removed/Updated on an unknown uid -> TASK_NOT_FOUND.
- NodeAdded on a known uuid -> NODE_ALREADY_EXISTS; Failed/Removed/Updated
  on an unknown uuid -> NODE_NOT_FOUND.

Machine bookkeeping: Poseidon emits a 2-level Machine -> PU#0 topology
(reference nodewatcher.go:292-339); we register every node of the subtree
in the uuid index (so stats addressed to either level resolve) but account
capacity at machine granularity, which is exactly the information content
of the reference's degenerate one-PU topology.
"""

from __future__ import annotations

import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from operator import attrgetter
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from poseidon_tpu_torch.graph.ecs import Selector, ec_signature
from poseidon_tpu_torch.obs import metrics as _metrics
from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.utils.ids import fnv64a
from poseidon_tpu_torch.utils.locks import TrackedLock
from poseidon_tpu_torch.graph.residency import (
    MachineLabelIndex,
    ResidentLabelIndex,
)

log = logging.getLogger("poseidon_tpu_torch.state")


class TaskReply(enum.IntEnum):
    """TaskReplyType wire values (firmament_scheduler.proto:110-120)."""

    COMPLETED_OK = 0
    SUBMITTED_OK = 1
    REMOVED_OK = 2
    FAILED_OK = 3
    UPDATED_OK = 4
    NOT_FOUND = 5
    JOB_NOT_FOUND = 6
    ALREADY_SUBMITTED = 7
    STATE_NOT_CREATED = 8


class NodeReply(enum.IntEnum):
    """NodeReplyType wire values (firmament_scheduler.proto:122-129)."""

    ADDED_OK = 0
    FAILED_OK = 1
    REMOVED_OK = 2
    UPDATED_OK = 3
    NOT_FOUND = 4
    ALREADY_EXISTS = 5


class TaskState(enum.IntEnum):
    """Task lifecycle (task_desc.proto:32-43 subset the service drives)."""

    CREATED = 0
    RUNNABLE = 2
    ASSIGNED = 3
    RUNNING = 4
    COMPLETED = 5
    FAILED = 6
    ABORTED = 7


# Default task slots per machine when the descriptor does not carry
# task_capacity.  Firmament's one-PU topology from Poseidon gives no slot
# count; bounding concurrent tasks per machine keeps the transport column
# capacities meaningful.
DEFAULT_TASK_SLOTS = 100

_STATS_WINDOW = 64  # knowledge-base ring-buffer depth per entity


@dataclass
class TaskInfo:
    uid: int
    job_id: str
    name: str = ""
    cpu_request: int = 0       # millicores
    ram_request: int = 0       # KB
    # Net receive bandwidth request (the `networkRequirement` label path,
    # reference podwatcher.go:467-476 -> ResourceVector.net_rx_bw).
    net_rx_request: int = 0
    priority: int = 0
    task_type: int = 0
    selectors: Tuple[Selector, ...] = ()
    # Pod-level (anti-)affinity: selectors evaluated against the labels of
    # tasks running on each machine (K8s podAffinity semantics, resolved
    # across rounds; BASELINE config 3).
    pod_affinity: Tuple[Selector, ...] = ()
    pod_anti_affinity: Tuple[Selector, ...] = ()
    labels: Dict[str, str] = field(default_factory=dict)
    state: TaskState = TaskState.RUNNABLE
    # Machine uuid this task is currently placed on (None = unscheduled).
    scheduled_to: Optional[str] = None
    submit_round: int = 0
    wait_rounds: int = 0
    # Gang scheduling: all of this job's tasks place atomically or not at
    # all (the `gangScheduling` pod label path; BASELINE config 4).
    gang: bool = False
    # Cluster-trace replay hooks (task_desc.proto:98-99).
    trace_job_id: int = 0
    trace_task_id: int = 0
    # Cached EC signature.  Computed once at construction and refreshed on
    # update (recomputing the FNV chain for 100k tasks every round would
    # dominate the round's host budget).
    ec_id: int = 0
    # ``obs.trace.monotime()`` at acceptance: the start of the pod's wait
    # for a placement, read only while the tracer times
    # (``apply_placements``).  Never checkpointed or sent.
    accepted_at: Optional[float] = field(default=None, repr=False,
                                         compare=False)

    def __post_init__(self) -> None:
        self.ec_id = self.compute_ec_id()

    def compute_ec_id(self) -> int:
        return ec_signature(
            self.cpu_request,
            self.ram_request,
            self.selectors + (
                # Pod-level selectors partition ECs the same way node
                # selectors do (different constraints => different row);
                # the key prefix keeps them distinct from node selectors.
                tuple((st, "pod-aff:" + k, v)
                      for st, k, v in self.pod_affinity)
                + tuple((st, "pod-anti:" + k, v)
                        for st, k, v in self.pod_anti_affinity)
            ),
            self.task_type,
            self.priority,
            self.net_rx_request,
            gang_job=self.job_id if self.gang else "",
        )


@dataclass
class MachineInfo:
    uuid: str
    hostname: str = ""
    cpu_capacity: int = 0      # millicores
    ram_capacity: int = 0      # KB
    net_rx_capacity: int = 0   # ResourceVector.net_rx_bw units
    task_slots: int = DEFAULT_TASK_SLOTS
    labels: Dict[str, str] = field(default_factory=dict)
    healthy: bool = True
    # uuids of every resource in this machine's topology subtree (PUs...).
    subtree_uuids: Set[str] = field(default_factory=set)
    # Measured utilization from the knowledge base (EMA over AddNodeStats).
    cpu_util: float = 0.0
    mem_util: float = 0.0
    # Cost-model stat hooks carried on the descriptor: Whare-Map
    # co-location census (whare_map_stats.proto:23-29) as
    # (idle, devils, rabbits, sheep, turtles), and CoCo interference
    # penalties (coco_interference_scores.proto:24-29) as
    # (devil, rabbit, sheep, turtle).
    whare_stats: Optional[Tuple[int, int, int, int, int]] = None
    coco_penalties: Optional[Tuple[int, int, int, int]] = None
    trace_machine_id: int = 0


@dataclass
class _KBEntry:
    samples: deque = field(default_factory=lambda: deque(maxlen=_STATS_WINDOW))
    # EMA of observed usage (AddTaskStats cpu_usage millicores / mem_usage
    # KB); -1 = no data yet.  This is what closes the knowledge-base loop:
    # build_round_view folds it into the machines' observed load and the
    # interference census (reference intent: task usage history informs
    # the cost models, pkg/stats/stats.go:77-159).
    cpu_usage: float = -1.0
    mem_usage: float = -1.0


def _observe_placed(placed: List[TaskInfo], waited: List[int],
                    cut: int) -> None:
    """The waits of the pods ``placed`` by round ``cut``'s commit, each
    after ``waited`` rounds that passed it over: each accepted pod's wait
    into the pod-wait histogram, and a ``pod.missed_cut`` span for each
    pod accepted in an earlier round, after that round's snapshot, and
    placed at its first snapshot since (``submit_round`` below the
    committing round's, no round passed it over)."""
    now = _trace.monotime()
    # A wave places 100,000 pods: one pass per attribute, in C.
    accepted = np.array(list(map(attrgetter("accepted_at"), placed)),
                        dtype=np.float64)  # None (a restored pod) -> nan
    known = ~np.isnan(accepted)
    if not known.any():
        return
    _metrics.observe_pod_waits(now - accepted[known])
    submitted = np.fromiter(map(attrgetter("submit_round"), placed),
                            np.int64, len(placed))
    missed = known & (submitted < cut) & (np.asarray(waited) == 0)
    for k in np.flatnonzero(missed).tolist():
        _trace.record("pod.missed_cut", float(accepted[k]), now,
                      pod=placed[k].uid, submitted_round=int(submitted[k]),
                      placed_round=cut)


@dataclass
class RoundView:
    """One round's schedulable world in columnar form.

    ``ecs``/``machines`` are the cost-model tables; ``member_*[i]`` are
    per-EC arrays aligned with ``ecs`` row ``i``, each sorted by task uid:
    uid (uint64), current machine column (int32, -1 = unscheduled), and
    wait rounds (int32).
    """

    ecs: object
    machines: object
    member_uids: list
    member_cur: list
    member_wait: list
    generation: int


class ClusterState:
    """The mutable cluster model; thread-safe (the gRPC server is
    multi-threaded, matching the reference's concurrent watcher RPCs).

    The numeric hot path, the O(N) per-round aggregation over every
    task, is mirrored into the native C++ graph core
    (``poseidon_tpu_torch/native``) as in the reference: every mutator
    updates the mirror under the same lock, and ``build_round_view``
    reads the columnar view from it.  ``use_native=False`` keeps the
    pure-Python pass; so does a core that cannot be built, with a
    warning.
    """

    def __init__(self, use_native: bool = True) -> None:
        self._lock = TrackedLock("graph.ClusterState._lock", reentrant=True)
        self._native = None
        self._machine_key: Dict[str, int] = {}  # uuid -> native key
        if use_native:
            from poseidon_tpu_torch.native import (
                NativeGraphCore,
                native_error,
            )

            try:
                self._native = NativeGraphCore()
            except RuntimeError:
                log.warning("native graph core unavailable (%s); the "
                            "round view is built in Python",
                            native_error())
        self.tasks: Dict[int, TaskInfo] = {}
        self.jobs: Dict[str, Set[int]] = {}
        self.machines: Dict[str, MachineInfo] = {}
        # Any-resource-uuid -> machine uuid (PUs resolve to their machine).
        self.resource_to_machine: Dict[str, str] = {}
        self.task_kb: Dict[int, _KBEntry] = {}
        self.node_kb: Dict[str, _KBEntry] = {}
        self.round_index = 0
        # Monotonic generation, bumped on every mutation; lets the planner
        # skip rebuild work on quiet rounds.  Writes route through the
        # property below: every externally-driven bump (the watcher RPCs)
        # also stamps the continuous-ingest log the streaming admission
        # batcher cuts.  ``apply_placements`` — the scheduler's own round
        # commit — bumps ``_generation`` directly; it is not ingest.
        self._generation = 0
        # Continuous-ingest accounting (POSEIDON_STREAMING): arrival
        # timestamps of mutations not yet admitted into a round (cleared
        # at each admission cut; bounded — see _INGEST_LOG_CAP), an
        # admitted-arrival counter, and dirty-hint sets (EC ids / machine uuids) feeding the cost-
        # plane cache's ingest seam.  All under self._lock.
        self._ingest_log: deque = deque()
        # The last arrival's monotonic timestamp (None before the first).
        self.last_ingest_ts: Optional[float] = None
        self._ingest_count = 0
        self._ingest_ecs: Set[int] = set()
        self._ingest_machines: Set[str] = set()
        # Live count of tasks carrying pod-level (anti-)affinity: the
        # resident-label machinery is inert while zero.
        self._pod_selector_tasks = 0
        # Incrementally-maintained resident-label count matrices (the
        # constraint-mask engine's state half).  Activated — one
        # O(tasks) rebuild — the first round that actually carries pod
        # selectors; from then on every placement/completion/PREEMPT
        # updates it by deltas, and build_round_view hands cost models
        # an O(M)-gather view instead of re-scanning every task.
        self._residency = ResidentLabelIndex()
        # Node-mutation generation + the machine-label interning cache
        # it keys: rounds with unchanged nodes reuse the interned
        # selector-admissibility index instead of re-interning labels.
        self._node_generation = 0
        self._label_cache: Optional[Tuple[int, MachineLabelIndex]] = None
        # Resubmission affinity: machine a REMOVED task was running on,
        # keyed by uid.  Steady-state churn removes and resubmits the
        # same work (reference controllers recreate pods; the bench's 1%
        # churn resubmits identical uids); seeding the solver from these
        # placements turns the churn round into a near-no-op instead of
        # a few hundred redistribution iterations.  Bounded FIFO
        # (insertion order) so dead uids cannot grow it without limit.
        self.prior_machine: Dict[int, str] = {}
        self._PRIOR_CAP = 1_000_000

    def _nkey(self, uuid: str) -> int:
        """Native machine key for a uuid (minted once; never 0)."""
        key = self._machine_key.get(uuid)
        if key is None:
            key = fnv64a(uuid) or 1
            self._machine_key[uuid] = key
        return key

    @property
    def native_loaded(self) -> bool:
        """Whether this state mirrors into the native graph core."""
        return self._native is not None

    # -------------------------------------------------- continuous ingest

    # Timestamp-log bound: past this many un-admitted arrivals the log
    # stops recording timestamps (the COUNT keeps counting) — staleness
    # needs only the oldest entry, which is preserved.
    _INGEST_LOG_CAP = 65536

    @property
    def generation(self) -> int:
        return self._generation

    @generation.setter
    def generation(self, value: int) -> None:
        # Mutators write ``self.generation += 1``; routing the write
        # here stamps the ingest log without touching every bump site.
        # Callers hold self._lock (the mutators' own critical sections).
        if value > self._generation:
            now = time.monotonic()
            if len(self._ingest_log) < self._INGEST_LOG_CAP:
                self._ingest_log.append(now)
            self._ingest_count += 1
            self.last_ingest_ts = now
        self._generation = value

    def _ingest_hint(self, ec: Optional[int] = None,
                     machine: Optional[str] = None) -> None:
        """Dirty-hint detail for the cost-plane cache's ingest seam
        (costmodel/delta.py): which EC row / machine column this
        mutation touched.  Caller holds the lock."""
        if ec is not None:
            self._ingest_ecs.add(int(ec))
        if machine is not None:
            self._ingest_machines.add(machine)

    def admission_cut(self) -> Tuple[int, float]:
        """Cut the streaming admission window (called at the round's
        view build): everything that arrived before the cut is admitted
        into this round, and the log resets so later arrivals count as
        deferred.  Returns ``(admitted, oldest_age_s)`` — the count of
        admitted arrivals and the age of the oldest one, i.e. the
        bounded-staleness bound this round actually realized."""
        with self._lock:
            now = time.monotonic()
            admitted = self._ingest_count
            age = (now - self._ingest_log[0]) if self._ingest_log else 0.0
            self._ingest_log.clear()
            self._ingest_count = 0
            return admitted, age

    def pending_ingest(self) -> int:
        """Arrivals since the last admission cut — read at round end,
        these are the deltas that rolled to round N+1
        (``admission_deferred``)."""
        with self._lock:
            return self._ingest_count

    def take_ingest_hints(self) -> Tuple[Set[int], Set[str]]:
        """Drain the accumulated dirty-hint sets (EC ids, machine
        uuids) for the cost-plane cache's continuous-ingest seam."""
        with self._lock:
            rows, cols = self._ingest_ecs, self._ingest_machines
            self._ingest_ecs, self._ingest_machines = set(), set()
            return rows, cols

    def ingest_age_s(self) -> Optional[float]:
        """Seconds since the last externally-driven mutation (None
        before the first) — the service-side ingest-liveness signal."""
        with self._lock:
            if self.last_ingest_ts is None:
                return None
            return time.monotonic() - self.last_ingest_ts

    # ------------------------------------------------------------------ tasks

    def task_submitted(self, task: TaskInfo) -> TaskReply:
        # Stamped whatever the tracer's gates: one clock read costs less
        # than reading them (two environment probes), once a pod.
        task.accepted_at = _trace.monotime()
        with self._lock:
            existing = self.tasks.get(task.uid)
            if existing is not None:
                if existing.state in (
                    TaskState.CREATED,
                    TaskState.RUNNABLE,
                    TaskState.ASSIGNED,
                    TaskState.RUNNING,
                ):
                    # Live task re-played (client restart re-list): the
                    # client wrapper tolerates this reply on submit.
                    return TaskReply.ALREADY_SUBMITTED
                # Terminal states cannot be re-submitted under this uid.
                return TaskReply.STATE_NOT_CREATED
            # A carried binding (scheduled_to_resource on the descriptor —
            # restart recovery) is adopted when it resolves to a known
            # machine; otherwise the task enters as runnable.
            carried = task.scheduled_to
            machine_uuid = (
                self.resource_to_machine.get(carried) if carried else None
            )
            if machine_uuid is not None:
                task.scheduled_to = machine_uuid
                task.state = TaskState.RUNNING
            else:
                task.scheduled_to = None
                task.state = TaskState.RUNNABLE
            task.submit_round = self.round_index
            self._ingest_hint(ec=task.ec_id, machine=task.scheduled_to)
            self.tasks[task.uid] = task
            self.jobs.setdefault(task.job_id, set()).add(task.uid)
            if task.pod_affinity or task.pod_anti_affinity:
                self._pod_selector_tasks += 1
            if self._residency.active and task.scheduled_to is not None:
                # Carried binding (restart recovery): resident on arrival.
                self._residency.add(task.scheduled_to, task.labels)
            if self._native is not None:
                self._native.task_submit(
                    task.uid, task.ec_id, task.cpu_request,
                    task.ram_request, task.net_rx_request, task.task_type,
                )
                if task.scheduled_to is not None:
                    self._native.task_place(
                        task.uid, self._nkey(task.scheduled_to)
                    )
            self.generation += 1
            return TaskReply.SUBMITTED_OK

    def _finish_task(self, uid: int, state: TaskState) -> Optional[TaskInfo]:
        task = self.tasks.get(uid)
        if task is None:
            return None
        self._ingest_hint(ec=task.ec_id, machine=task.scheduled_to)
        if self._residency.active and task.scheduled_to is not None:
            self._residency.remove(task.scheduled_to, task.labels)
        task.state = state
        task.scheduled_to = None
        if self._native is not None:
            self._native.task_set_state(uid, int(state))
        self.generation += 1
        return task

    def task_completed(self, uid: int) -> TaskReply:
        with self._lock:
            if self._finish_task(uid, TaskState.COMPLETED) is None:
                return TaskReply.NOT_FOUND
            return TaskReply.COMPLETED_OK

    def task_failed(self, uid: int) -> TaskReply:
        with self._lock:
            task = self.tasks.get(uid)
            if task is None:
                return TaskReply.NOT_FOUND
            self._ingest_hint(ec=task.ec_id, machine=task.scheduled_to)
            # FAILED is terminal for this uid: the replacement pod arrives
            # as a *new* task (the reference's controller recreates the pod
            # and the watcher derives a fresh uid, podwatcher.go:310-318);
            # the failed task itself is later TaskRemoved.
            if self._residency.active and task.scheduled_to is not None:
                self._residency.remove(task.scheduled_to, task.labels)
            task.state = TaskState.FAILED
            task.scheduled_to = None
            if self._native is not None:
                self._native.task_set_state(uid, int(TaskState.FAILED))
            self.generation += 1
            return TaskReply.FAILED_OK

    def task_removed(self, uid: int) -> TaskReply:
        with self._lock:
            task = self.tasks.pop(uid, None)
            if task is None:
                return TaskReply.NOT_FOUND
            self._ingest_hint(ec=task.ec_id, machine=task.scheduled_to)
            if task.scheduled_to is not None:
                self.prior_machine.pop(uid, None)  # refresh FIFO position
                self.prior_machine[uid] = task.scheduled_to
                while len(self.prior_machine) > self._PRIOR_CAP:
                    self.prior_machine.pop(
                        next(iter(self.prior_machine))
                    )
            if task.pod_affinity or task.pod_anti_affinity:
                self._pod_selector_tasks -= 1
            if self._residency.active:
                if task.scheduled_to is not None:
                    self._residency.remove(task.scheduled_to, task.labels)
                if self._pod_selector_tasks == 0:
                    # Last pod-selector task gone: stop paying the
                    # per-mutation maintenance (re-activation rebuilds).
                    self._residency.deactivate()
            members = self.jobs.get(task.job_id)
            if members is not None:
                members.discard(uid)
                if not members:
                    del self.jobs[task.job_id]  # job GC, podwatcher.go:288-309
            self.task_kb.pop(uid, None)
            if self._native is not None:
                self._native.task_remove(uid)
            self.generation += 1
            return TaskReply.REMOVED_OK

    def task_updated(self, task: TaskInfo) -> TaskReply:
        with self._lock:
            existing = self.tasks.get(task.uid)
            if existing is None:
                return TaskReply.NOT_FOUND
            self._ingest_hint(ec=existing.ec_id,
                              machine=existing.scheduled_to)
            # Update the mutable request/constraint attributes in place
            # (podwatcher.go:362-375 updates request + labels).
            existing.cpu_request = task.cpu_request
            existing.ram_request = task.ram_request
            existing.net_rx_request = task.net_rx_request
            existing.priority = task.priority
            existing.task_type = task.task_type
            had = bool(existing.pod_affinity or existing.pod_anti_affinity)
            if (
                self._residency.active
                and existing.scheduled_to is not None
                and task.labels != existing.labels
            ):
                # A resident's labels changed in place: the count
                # matrices must follow (the old per-round rebuild picked
                # this up for free; the incremental index needs the
                # delta).
                self._residency.relabel(
                    existing.scheduled_to, existing.labels, task.labels
                )
            existing.selectors = task.selectors
            existing.pod_affinity = task.pod_affinity
            existing.pod_anti_affinity = task.pod_anti_affinity
            existing.labels = task.labels
            existing.ec_id = existing.compute_ec_id()
            self._ingest_hint(ec=existing.ec_id)
            has = bool(existing.pod_affinity or existing.pod_anti_affinity)
            self._pod_selector_tasks += int(has) - int(had)
            if (
                self._residency.active and self._pod_selector_tasks == 0
            ):
                self._residency.deactivate()
            if self._native is not None:
                self._native.task_update(
                    existing.uid, existing.ec_id, existing.cpu_request,
                    existing.ram_request, existing.net_rx_request,
                    existing.task_type,
                )
            self.generation += 1
            return TaskReply.UPDATED_OK

    # ---------------------------------------------------------------- machines

    def node_added(self, machine: MachineInfo) -> NodeReply:
        with self._lock:
            if machine.uuid in self.machines:
                return NodeReply.ALREADY_EXISTS
            self.machines[machine.uuid] = machine
            self.resource_to_machine[machine.uuid] = machine.uuid
            # sorted(): dict insertion order is observable (snapshots,
            # debug dumps) and set order is not reproducible across runs.
            for sub in sorted(machine.subtree_uuids):
                self.resource_to_machine[sub] = machine.uuid
            if self._native is not None:
                self._native.machine_add(
                    self._nkey(machine.uuid), machine.cpu_capacity,
                    machine.ram_capacity, machine.net_rx_capacity,
                    machine.task_slots,
                )
            self._ingest_hint(machine=machine.uuid)
            self._node_generation += 1
            self.generation += 1
            return NodeReply.ADDED_OK

    def _evict_tasks_on(self, machine_uuid: str) -> List[int]:
        evicted = []
        res_active = self._residency.active
        for task in self.tasks.values():
            if task.scheduled_to == machine_uuid:
                if res_active:
                    self._residency.remove(machine_uuid, task.labels)
                task.scheduled_to = None
                task.state = TaskState.RUNNABLE
                if self._native is not None:
                    # RUNNABLE via set_state clears the binding without
                    # ticking the wait escalator (eviction, not a failed
                    # placement attempt).
                    self._native.task_set_state(
                        task.uid, int(TaskState.RUNNABLE)
                    )
                evicted.append(task.uid)
        return evicted

    def node_failed(self, uuid: str) -> NodeReply:
        with self._lock:
            machine_uuid = self.resource_to_machine.get(uuid)
            machine = self.machines.get(machine_uuid) if machine_uuid else None
            if machine is None:
                return NodeReply.NOT_FOUND
            machine.healthy = False
            # Tasks on a failed node go back to runnable; the next round
            # re-places them (failure propagation, nodewatcher.go:151-165).
            self._evict_tasks_on(machine.uuid)
            self._ingest_hint(machine=machine.uuid)
            self._node_generation += 1
            self.generation += 1
            return NodeReply.FAILED_OK

    def node_removed(self, uuid: str) -> NodeReply:
        with self._lock:
            machine_uuid = self.resource_to_machine.get(uuid)
            machine = (
                self.machines.pop(machine_uuid, None) if machine_uuid else None
            )
            if machine is None:
                return NodeReply.NOT_FOUND
            self.resource_to_machine.pop(machine.uuid, None)
            for sub in sorted(machine.subtree_uuids):
                self.resource_to_machine.pop(sub, None)
            self.node_kb.pop(machine.uuid, None)
            self._evict_tasks_on(machine.uuid)
            if self._residency.active:
                # Row recycled only after eviction drained its counts.
                self._residency.machine_removed(machine.uuid)
            if self._native is not None:
                self._native.machine_remove(self._nkey(machine.uuid))
            self._ingest_hint(machine=machine.uuid)
            self._node_generation += 1
            self.generation += 1
            return NodeReply.REMOVED_OK

    def node_updated(self, machine: MachineInfo) -> NodeReply:
        with self._lock:
            existing = self.machines.get(machine.uuid)
            if existing is None:
                return NodeReply.NOT_FOUND
            existing.cpu_capacity = machine.cpu_capacity
            existing.ram_capacity = machine.ram_capacity
            existing.net_rx_capacity = machine.net_rx_capacity
            existing.labels = machine.labels
            existing.hostname = machine.hostname or existing.hostname
            existing.healthy = True
            # Cost-model stat hooks refresh on update (NodeUpdated carries
            # the full descriptor; absent hooks keep their last value).
            if machine.whare_stats is not None:
                existing.whare_stats = machine.whare_stats
            if machine.coco_penalties is not None:
                existing.coco_penalties = machine.coco_penalties
            for sub in sorted(machine.subtree_uuids):
                existing.subtree_uuids.add(sub)
                self.resource_to_machine[sub] = existing.uuid
            if self._native is not None:
                self._native.machine_update(
                    self._nkey(existing.uuid), existing.cpu_capacity,
                    existing.ram_capacity, existing.net_rx_capacity,
                    existing.task_slots,
                )
            self._ingest_hint(machine=existing.uuid)
            self._node_generation += 1
            self.generation += 1
            return NodeReply.UPDATED_OK

    # ------------------------------------------------------------------ stats

    def add_task_stats(self, uid: int, sample: dict) -> TaskReply:
        with self._lock:
            if uid not in self.tasks:
                return TaskReply.NOT_FOUND
            entry = self.task_kb.setdefault(uid, _KBEntry())
            entry.samples.append(sample)
            alpha = 0.5
            for key in ("cpu_usage", "mem_usage"):
                v = sample.get(key)
                if v is None:
                    continue
                prev = getattr(entry, key)
                new = float(v) if prev < 0 else (
                    alpha * float(v) + (1 - alpha) * prev
                )
                setattr(entry, key, new)
            return TaskReply.SUBMITTED_OK

    def add_node_stats(self, resource_uuid: str, sample: dict) -> NodeReply:
        with self._lock:
            machine_uuid = self.resource_to_machine.get(resource_uuid)
            machine = self.machines.get(machine_uuid) if machine_uuid else None
            if machine is None:
                return NodeReply.NOT_FOUND
            self.node_kb.setdefault(machine.uuid, _KBEntry()).samples.append(
                sample
            )
            # EMA blend into the live utilization signal the cost model reads.
            alpha = 0.5
            cpu_u = sample.get("cpu_utilization")
            mem_u = sample.get("mem_utilization")
            if cpu_u is not None:
                machine.cpu_util = (
                    alpha * float(cpu_u) + (1 - alpha) * machine.cpu_util
                )
            if mem_u is not None:
                machine.mem_util = (
                    alpha * float(mem_u) + (1 - alpha) * machine.mem_util
                )
            self._ingest_hint(machine=machine.uuid)
            self.generation += 1
            return NodeReply.ADDED_OK

    # ------------------------------------------------------------- placements

    def apply_placement(self, uid: int, machine_uuid: Optional[str]) -> None:
        """Record the outcome of a round for one task."""
        self.apply_placements([(uid, machine_uuid)])

    def apply_placements(self, placements) -> None:
        """Batch `apply_placement` under one lock acquisition.

        ``placements``: iterable of (uid, machine_uuid_or_None).  The
        initial wave places 100k tasks in one round; per-task locking
        would dominate the round budget.
        """
        applied = False
        # Hot loop (100k tasks on the initial wave): bind attribute
        # lookups outside it.
        tasks_get = self.tasks.get
        runnable, running = TaskState.RUNNABLE, TaskState.RUNNING
        res_dec: List[int] = []
        res_inc: List[int] = []
        native_uids = []
        native_keys = []
        # While the tracer times: the pods this commit places that were
        # pending, and the rounds each had waited, for their waits after
        # the lock (_observe_placed).  Two lists, not a list of pairs: a
        # wave's 100,000 tuples would feed the collector.
        pending = [] if _trace.timing_enabled() else None
        waited: List[int] = []
        with self._lock:
            cut = self.round_index
            has_native = self._native is not None
            nkey = self._nkey
            uids_append = native_uids.append
            keys_append = native_keys.append
            # Residency deltas (None while the mask engine is inactive —
            # the common no-affinity wave pays one attribute check).
            # Label-less transitions batch into two scatter-adds;
            # labelled ones (the affinity workloads, a few thousand)
            # update inline.  Read under the lock: activation /
            # deactivation happen on other service threads.
            res = self._residency if self._residency.active else None
            for uid, machine_uuid in placements:
                task = tasks_get(uid)
                if task is None:
                    continue
                if res is not None:
                    old = task.scheduled_to
                    if old != machine_uuid:
                        if task.labels:
                            if old is not None:
                                res.remove(old, task.labels)
                            if machine_uuid is not None:
                                res.add(machine_uuid, task.labels)
                        else:
                            if old is not None:
                                res_dec.append(res.row(old))
                            if machine_uuid is not None:
                                res_inc.append(res.row(machine_uuid))
                task.scheduled_to = machine_uuid
                if machine_uuid is None:
                    task.state = runnable
                    task.wait_rounds += 1
                else:
                    if pending is not None and task.state != running:
                        pending.append(task)
                        waited.append(task.wait_rounds)
                    task.state = running
                    task.wait_rounds = 0
                if has_native:
                    uids_append(uid)
                    keys_append(nkey(machine_uuid) if machine_uuid else 0)
                applied = True
            if native_uids:
                # One C call for the whole round: a ctypes call per task
                # would cost more than the round's own placement loop.
                self._native.task_place_batch(
                    np.asarray(native_uids, dtype=np.uint64),
                    np.asarray(native_keys, dtype=np.uint64),
                )
            if res is not None:
                res.bump_totals(res_dec, res_inc)
            if applied:
                # No-op batches leave the generation untouched so quiet
                # rounds stay recognizable to the incremental fast path.
                # Direct bump: the round commit is the scheduler's own
                # write-back, not watcher ingest — it must not count
                # against the streaming admission window.
                self._generation += 1
        if pending:
            _observe_placed(pending, waited, cut)

    def mirror_wait_rounds(self) -> None:
        """Copy the pending tasks' ``wait_rounds`` into the native core,
        after a restore has set them directly.  The core counts a task's
        waits itself, one per unscheduled placement, so each count is
        replayed as that many: one batched call per level, the tasks
        still owed a tick at that level first in the batch."""
        if self._native is None:
            return
        with self._lock:
            pend = [(uid, t.wait_rounds) for uid, t in self.tasks.items()
                    if t.state == TaskState.RUNNABLE
                    and t.scheduled_to is None and t.wait_rounds > 0]
            if not pend:
                return
            pend.sort(key=lambda p: -p[1])
            uids = np.fromiter((p[0] for p in pend), np.uint64, len(pend))
            neg = np.fromiter((-p[1] for p in pend), np.int64, len(pend))
            unplaced = np.zeros(len(pend), dtype=np.uint64)
            for k in range(1, int(-neg[0]) + 1):
                n = int(np.searchsorted(neg, -k, side="right"))
                self._native.task_place_batch(uids[:n], unplaced[:n])

    # ------------------------------------------------- constraint-mask state

    def _round_residents(self, machines):
        """The round's ResidentCounts view (or None when no pending task
        carries pod selectors).  First use activates the incremental
        index with one O(tasks) rebuild; every later round is an O(M)
        row gather of the delta-maintained matrices.  Caller holds the
        lock."""
        if self._pod_selector_tasks <= 0:
            return None
        res = self._residency
        if not res.active:
            res.activate()
            for t in self.tasks.values():
                if t.scheduled_to is not None:
                    res.add(t.scheduled_to, t.labels)
        return res.view([m.uuid for m in machines])

    def _machine_label_index(self, machines) -> MachineLabelIndex:
        """Interned machine labels for selector admissibility, cached
        across rounds keyed on the node generation (any node add /
        remove / fail / update invalidates — those are the only
        mutations that can change the machine column set or its
        labels).  Caller holds the lock."""
        cached = self._label_cache
        if cached is not None and cached[0] == self._node_generation:
            return cached[1]
        index = MachineLabelIndex.build([m.labels for m in machines])
        self._label_cache = (self._node_generation, index)
        return index

    @staticmethod
    def _observed_class(task, entry) -> int:
        """Interference class refined by observed usage: a task whose
        measured CPU dwarfs its request behaves as a DEVIL whatever its
        label says; one far under it is a SHEEP (Whare-Map's 'observed
        interference' intent, whare_map_stats.proto:23-29)."""
        if entry.cpu_usage < 0 or task.cpu_request <= 0:
            return task.task_type & 3
        if entry.cpu_usage > 2.0 * task.cpu_request:
            return 2  # DEVIL
        if entry.cpu_usage < 0.25 * task.cpu_request:
            return 0  # SHEEP
        return task.task_type & 3

    def _kb_observed(self, uuid_to_col, census, cpu_used, ram_used,
                     include_running: bool):
        """Fold the task-usage knowledge base into the round view.

        O(|task_kb|): for every resident task with usage history, (a)
        shift the machine's observed load by (usage EMA - reservation)
        and (b) move its census entry to its observed interference class.
        Returns ``(cpu_obs, ram_obs)`` (int64 [M]) or ``(None, None)``
        when there is nothing to observe.  Caller holds the lock.
        """
        import numpy as np

        if include_running or not self.task_kb:
            return None, None
        cpu_obs = cpu_used.astype(np.float64)
        ram_obs = ram_used.astype(np.float64)
        touched = False
        for uid, entry in self.task_kb.items():
            t = self.tasks.get(uid)
            if t is None or t.state != TaskState.RUNNING:
                continue
            col = uuid_to_col.get(t.scheduled_to, -1) \
                if t.scheduled_to else -1
            if col < 0:
                continue
            touched = True
            if entry.cpu_usage >= 0:
                cpu_obs[col] += entry.cpu_usage - t.cpu_request
            if entry.mem_usage >= 0:
                ram_obs[col] += entry.mem_usage - t.ram_request
            obs_cls = self._observed_class(t, entry)
            labeled = t.task_type & 3
            if obs_cls != labeled:
                census[col, labeled] -= 1
                census[col, obs_cls] += 1
        if not touched:
            return None, None
        return (
            np.maximum(np.rint(cpu_obs), 0).astype(np.int64),
            np.maximum(np.rint(ram_obs), 0).astype(np.int64),
        )

    def build_round_view(self, include_running: bool = False) -> "RoundView":
        """Columnar tables for one round, built in a single pass under the
        lock (no per-task object copies: at 100k tasks a deep snapshot's
        per-object overhead would dominate the round's host budget).


        ``include_running=False`` (default, the reference's semantics):
        only RUNNABLE tasks enter the solve; RUNNING tasks hold their
        machines' resources as reservations (``cpu_used``/``ram_used``/
        ``net_rx_used``/``slots``).  ``include_running=True`` re-enters
        the whole workload for global re-optimization (the preemption /
        rebalancing mode); reservations are then zero and the banded
        ladder re-prices the whole workload from free capacity.

        Returns a ``RoundView`` (defined in costmodel.base's vocabulary):
        EC/machine structure-of-arrays tables plus per-EC member arrays
        (uid, current machine column, wait rounds) that the planner's
        vectorized assignment consumes.
        """
        import numpy as np

        from poseidon_tpu_torch.costmodel.base import ECTable, MachineTable

        if self._native is not None:
            return self._build_view_native(include_running)

        with self._lock:
            machines = [m for m in self.machines.values() if m.healthy]
            machines.sort(key=lambda m: m.uuid)
            uuid_to_col = {m.uuid: j for j, m in enumerate(machines)}

            # Resident-task census by interference type, committed
            # resources, and slot usage, accumulated in the same single
            # pass (inputs to the cost models and, in reservation mode,
            # the machines' free-capacity accounting).
            census = np.zeros((len(machines), 4), dtype=np.int64)
            net_used = np.zeros(len(machines), dtype=np.int64)
            cpu_used = np.zeros(len(machines), dtype=np.int64)
            ram_used = np.zeros(len(machines), dtype=np.int64)
            slots_used = np.zeros(len(machines), dtype=np.int32)
            # Resident-label aggregates for pod-level affinity: the
            # incrementally-maintained interned count matrices, gathered
            # into this round's machine-column order (None when no
            # pending task carries pod selectors).
            residents = self._round_residents(machines)

            schedulable = (
                (TaskState.RUNNABLE, TaskState.RUNNING)
                if include_running
                else (TaskState.RUNNABLE,)
            )
            groups: Dict[int, list] = {}
            reps: Dict[int, TaskInfo] = {}
            for t in self.tasks.values():
                if t.state not in (TaskState.RUNNABLE, TaskState.RUNNING):
                    continue
                cur = uuid_to_col.get(t.scheduled_to, -1) \
                    if t.scheduled_to else -1
                if cur >= 0:
                    census[cur, t.task_type & 3] += 1
                    net_used[cur] += t.net_rx_request
                    if not include_running:
                        cpu_used[cur] += t.cpu_request
                        ram_used[cur] += t.ram_request
                        slots_used[cur] += 1
                if t.state not in schedulable:
                    continue
                g = groups.get(t.ec_id)
                if g is None:
                    groups[t.ec_id] = g = []
                    reps[t.ec_id] = t
                g.append((t.uid, cur, t.wait_rounds))
            # Descriptor-carried Whare-Map census (devils, rabbits, sheep,
            # turtles order folded into SHEEP/RABBIT/DEVIL/TURTLE columns).
            for j, m in enumerate(machines):
                if m.whare_stats is not None:
                    _idle, dev, rab, shp, tur = m.whare_stats
                    census[j, 0] += shp
                    census[j, 1] += rab
                    census[j, 2] += dev
                    census[j, 3] += tur

            cpu_obs, ram_obs = self._kb_observed(
                uuid_to_col, census, cpu_used, ram_used, include_running
            )

            ec_ids = sorted(groups)
            member_uids, member_cur, member_wait = [], [], []
            supply = np.empty(len(ec_ids), dtype=np.int32)
            max_wait = np.empty(len(ec_ids), dtype=np.int32)
            running_by_machine = np.zeros(
                (len(ec_ids), len(machines)), dtype=np.int32
            )
            for i, e in enumerate(ec_ids):
                g = groups[e]
                k = len(g)
                uid_arr = np.fromiter(
                    (x[0] for x in g), dtype=np.uint64, count=k
                )
                cur_arr = np.fromiter(
                    (x[1] for x in g), dtype=np.int32, count=k
                )
                wait_arr = np.fromiter(
                    (x[2] for x in g), dtype=np.int32, count=k
                )
                order = np.argsort(uid_arr, kind="stable")
                member_uids.append(uid_arr[order])
                member_cur.append(cur_arr[order])
                member_wait.append(wait_arr[order])
                supply[i] = k
                max_wait[i] = wait_arr.max() if k else 0
                placed = cur_arr[cur_arr >= 0]
                if placed.size:
                    running_by_machine[i] = np.bincount(
                        placed, minlength=len(machines)
                    )

            rep_list = [reps[e] for e in ec_ids]
            ecs = ECTable(
                ec_ids=np.array(ec_ids, dtype=np.uint64),
                cpu_request=np.array(
                    [r.cpu_request for r in rep_list], dtype=np.int64
                ),
                ram_request=np.array(
                    [r.ram_request for r in rep_list], dtype=np.int64
                ),
                supply=supply,
                priority=np.array(
                    [r.priority for r in rep_list], dtype=np.int32
                ),
                task_type=np.array(
                    [r.task_type for r in rep_list], dtype=np.int32
                ),
                max_wait_rounds=max_wait,
                selectors=[r.selectors for r in rep_list],
                net_rx_request=np.array(
                    [r.net_rx_request for r in rep_list], dtype=np.int64
                ),
                running_by_machine=running_by_machine,
                is_gang=np.array([r.gang for r in rep_list], dtype=bool),
                pod_affinity=[r.pod_affinity for r in rep_list],
                pod_anti_affinity=[r.pod_anti_affinity for r in rep_list],
                labels=[r.labels for r in rep_list],
            )
            mt = MachineTable(
                uuids=[m.uuid for m in machines],
                cpu_capacity=np.array(
                    [m.cpu_capacity for m in machines], np.int64
                ),
                ram_capacity=np.array(
                    [m.ram_capacity for m in machines], np.int64
                ),
                cpu_used=cpu_used,
                ram_used=ram_used,
                cpu_util=np.array([m.cpu_util for m in machines], np.float32),
                mem_util=np.array([m.mem_util for m in machines], np.float32),
                slots_free=np.maximum(
                    np.array([m.task_slots for m in machines], np.int32)
                    - slots_used,
                    0,
                ),
                labels=[m.labels for m in machines],
                net_rx_capacity=np.array(
                    [m.net_rx_capacity for m in machines], np.int64
                ),
                net_rx_used=net_used,
                type_census=census,
                coco_penalties=np.array(
                    [
                        m.coco_penalties or (0, 0, 0, 0)
                        for m in machines
                    ],
                    dtype=np.int64,
                ),
                residents=residents,
                label_index=self._machine_label_index(machines),
                cpu_obs_used=cpu_obs,
                ram_obs_used=ram_obs,
            )
            return RoundView(
                ecs=ecs,
                machines=mt,
                member_uids=member_uids,
                member_cur=member_cur,
                member_wait=member_wait,
                generation=self.generation,
            )

    def _build_view_native(self, include_running: bool) -> "RoundView":
        """Round view via the C++ graph core: the O(N) aggregation,
        grouping and sorting run native; Python assembles the per-EC
        attribute tables from the (few) representative tasks."""
        import numpy as np

        from poseidon_tpu_torch.costmodel.base import ECTable, MachineTable

        with self._lock:
            machines = [m for m in self.machines.values() if m.healthy]
            machines.sort(key=lambda m: m.uuid)
            keys = np.fromiter(
                (self._nkey(m.uuid) for m in machines),
                dtype=np.uint64, count=len(machines),
            )
            (ec_ids, offsets, uids, cur, wait, census, cpu_used, ram_used,
             net_used, slots_used) = self._native.build_view(
                keys, include_running
            )
            E, M = ec_ids.shape[0], len(machines)

            member_uids, member_cur, member_wait = [], [], []
            supply = np.empty(E, dtype=np.int32)
            max_wait = np.empty(E, dtype=np.int32)
            running_by_machine = np.zeros((E, M), dtype=np.int32)
            rep_list = []
            for i in range(E):
                o, o2 = int(offsets[i]), int(offsets[i + 1])
                member_uids.append(uids[o:o2])
                member_cur.append(cur[o:o2])
                member_wait.append(wait[o:o2])
                supply[i] = o2 - o
                max_wait[i] = int(wait[o:o2].max()) if o2 > o else 0
                placed = cur[o:o2][cur[o:o2] >= 0]
                if placed.size:
                    running_by_machine[i] = np.bincount(
                        placed, minlength=M
                    )
                rep_list.append(self.tasks[int(uids[o])])

            # Resident-label aggregates (pod-level affinity): the same
            # incremental interned matrices as the Python path — labels
            # never cross the native boundary, and the O(tasks) label
            # re-scan this path used to pay per round is gone.
            residents = self._round_residents(machines)

            # Descriptor-carried Whare-Map census on top of the live one.
            for j, m in enumerate(machines):
                if m.whare_stats is not None:
                    _idle, dev, rab, shp, tur = m.whare_stats
                    census[j, 0] += shp
                    census[j, 1] += rab
                    census[j, 2] += dev
                    census[j, 3] += tur

            cpu_obs, ram_obs = self._kb_observed(
                {m.uuid: j for j, m in enumerate(machines)},
                census, cpu_used, ram_used, include_running,
            )

            ecs = ECTable(
                ec_ids=ec_ids,
                cpu_request=np.array(
                    [r.cpu_request for r in rep_list], dtype=np.int64
                ),
                ram_request=np.array(
                    [r.ram_request for r in rep_list], dtype=np.int64
                ),
                supply=supply,
                priority=np.array(
                    [r.priority for r in rep_list], dtype=np.int32
                ),
                task_type=np.array(
                    [r.task_type for r in rep_list], dtype=np.int32
                ),
                max_wait_rounds=max_wait,
                selectors=[r.selectors for r in rep_list],
                net_rx_request=np.array(
                    [r.net_rx_request for r in rep_list], dtype=np.int64
                ),
                running_by_machine=running_by_machine,
                is_gang=np.array([r.gang for r in rep_list], dtype=bool),
                pod_affinity=[r.pod_affinity for r in rep_list],
                pod_anti_affinity=[r.pod_anti_affinity for r in rep_list],
                labels=[r.labels for r in rep_list],
            )
            mt = MachineTable(
                uuids=[m.uuid for m in machines],
                cpu_capacity=np.array(
                    [m.cpu_capacity for m in machines], np.int64
                ),
                ram_capacity=np.array(
                    [m.ram_capacity for m in machines], np.int64
                ),
                cpu_used=cpu_used,
                ram_used=ram_used,
                cpu_util=np.array([m.cpu_util for m in machines], np.float32),
                mem_util=np.array([m.mem_util for m in machines], np.float32),
                slots_free=np.maximum(
                    np.array([m.task_slots for m in machines], np.int32)
                    - slots_used,
                    0,
                ),
                labels=[m.labels for m in machines],
                net_rx_capacity=np.array(
                    [m.net_rx_capacity for m in machines], np.int64
                ),
                net_rx_used=net_used,
                type_census=census,
                coco_penalties=np.array(
                    [
                        m.coco_penalties or (0, 0, 0, 0)
                        for m in machines
                    ],
                    dtype=np.int64,
                ),
                residents=residents,
                label_index=self._machine_label_index(machines),
                cpu_obs_used=cpu_obs,
                ram_obs_used=ram_obs,
            )
            return RoundView(
                ecs=ecs,
                machines=mt,
                member_uids=member_uids,
                member_cur=member_cur,
                member_wait=member_wait,
                generation=self.generation,
            )

"""Replay driver: trace events -> scheduler rounds -> report.

Replays a trace in virtual time against the in-process planner (the same
code path the gRPC service's ``Schedule()`` runs): between scheduling
rounds, due events mutate ClusterState exactly as the watcher RPCs would;
tasks that have been running for their duration complete.  Produces the
BASELINE metrics: per-round latency percentiles, placement totals, and the
cost objective — the driver for the 10k-node/100k-pod config 5.  The
port of the JAX package's ``replay/driver.py``: the planner solves on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import heapq
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.instance import RoundPlanner
from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo
from poseidon_tpu_torch.replay.trace import TraceEvent
from poseidon_tpu_torch.utils.hatches import hatch_flag
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid


@dataclass
class ReplayReport:
    rounds: int = 0
    tasks_submitted: int = 0
    tasks_completed: int = 0
    placed: int = 0
    preempted: int = 0
    migrated: int = 0
    round_seconds: List[float] = field(default_factory=list)
    solve_seconds: List[float] = field(default_factory=list)
    final_unscheduled: int = 0
    total_objective: int = 0
    # False when any replay round committed uncertified (budget-
    # exhausted) placements.
    converged: bool = True
    # One-time solver-ladder compile before the measured rounds.
    precompile_s: float = 0.0
    precompile_shapes: int = 0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.round_seconds, q)) \
            if self.round_seconds else 0.0

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "tasks_submitted": self.tasks_submitted,
            "tasks_completed": self.tasks_completed,
            "placed": self.placed,
            "preempted": self.preempted,
            "migrated": self.migrated,
            "round_p50_s": round(self.percentile(50), 4),
            "round_p99_s": round(self.percentile(99), 4),
            "solve_p50_s": (
                round(float(np.percentile(self.solve_seconds, 50)), 4)
                if self.solve_seconds else 0.0
            ),
            "final_unscheduled": self.final_unscheduled,
            "converged": self.converged,
            "precompile_s": round(self.precompile_s, 4),
            "precompile_shapes": self.precompile_shapes,
        }


class ReplayDriver:
    def __init__(
        self,
        events: List[TraceEvent],
        *,
        cost_model: str = "cpu_mem",
        round_interval_s: float = 10.0,
        gang_jobs: bool = False,
        precompile: bool = True,
        reschedule_running: bool = False,
        device=None,
    ) -> None:
        self.events = sorted(events, key=lambda e: (e.time, e.kind))
        self.state = ClusterState()
        # reschedule_running=True is the continuous-rebalancing replay:
        # the whole workload re-enters every round, so capacity pressure
        # (machine_remove events, load growth) surfaces as PREEMPT /
        # MIGRATE deltas from the solver — the two delta types the
        # reference client treats as first-class (poseidon.go:52-63) and
        # a steady-state replay never exercises.
        self.planner = RoundPlanner(
            self.state, get_cost_model(cost_model),
            reschedule_running=reschedule_running, device=device,
        )
        self.round_interval_s = round_interval_s
        self.gang_jobs = gang_jobs
        # Replay churns the pending EC subset every round, walking the
        # whole (E_bucket, reduced-width) solve-key ladder; the upfront
        # precompile puts every route's first launch and every key's
        # first sight outside the measured rounds.
        self.precompile = precompile
        # (end_time, task_uid) min-heap of running tasks.  Entries go
        # stale when a task is evicted (machine_remove) or preempted and
        # later re-placed with a NEW deadline: _deadline maps uid -> the
        # one currently-valid end time, and _complete_due drops any heap
        # entry that disagrees (completing an evicted task at its
        # original end time would silently drain the pending backlog the
        # pressure replay exists to create).
        self._ending: list = []
        self._durations: dict = {}
        self._deadline: dict = {}

    def _apply_event(self, ev: TraceEvent) -> int:
        if ev.kind == "machine_add":
            mid, cpu, ram = ev.payload
            self.state.node_added(
                MachineInfo(
                    uuid=generate_uuid(f"trace-m{mid}"),
                    cpu_capacity=cpu,
                    ram_capacity=ram,
                    trace_machine_id=mid,
                )
            )
            return 0
        if ev.kind == "machine_remove":
            (mid,) = ev.payload
            # Same id derivation as machine_add; running tasks are
            # evicted back to runnable (nodewatcher NodeRemoved path).
            self.state.node_removed(generate_uuid(f"trace-m{mid}"))
            return 0
        if ev.kind == "job_submit":
            job, n, cpu, ram, duration = ev.payload
            job_uuid = generate_uuid(f"trace-j{job}")
            for i in range(n):
                uid = task_uid(job_uuid, i)
                self.state.task_submitted(
                    TaskInfo(
                        uid=uid, job_id=job_uuid, cpu_request=cpu,
                        ram_request=ram, gang=self.gang_jobs,
                        trace_job_id=job, trace_task_id=i,
                    )
                )
                self._durations[uid] = duration
            return n
        raise ValueError(f"unknown trace event kind {ev.kind}")

    def _complete_due(self, now: float) -> int:
        done = 0
        while self._ending and self._ending[0][0] <= now:
            end, uid = heapq.heappop(self._ending)
            task = self.state.tasks.get(uid)
            if task is None:
                continue
            # Stale entry (task was evicted/preempted since this deadline
            # was set) or task is not on a machine right now: it has not
            # actually run its duration — skip; a fresh entry was / will
            # be pushed when it is re-placed.
            if self._deadline.get(uid) != end or task.scheduled_to is None:
                continue
            self._deadline.pop(uid, None)
            self.state.task_completed(uid)
            self.state.task_removed(uid)
            done += 1
        return done

    def run(self, max_rounds: Optional[int] = None) -> ReplayReport:
        report = ReplayReport()
        now = 0.0
        i = 0
        compiled = False
        n_events = len(self.events)
        while i < n_events or self._ending:
            # Apply everything due up to the end of this interval.
            horizon = now + self.round_interval_s
            while i < n_events and self.events[i].time <= horizon:
                report.tasks_submitted += self._apply_event(self.events[i])
                i += 1
            report.tasks_completed += self._complete_due(horizon)

            if self.precompile and not compiled:
                # The initial fleet is in state now (machines join at the
                # trace start); compile the solver ladder once, outside
                # the measured rounds.
                compiled = True
                t0 = time.perf_counter()
                shapes = self.planner.precompile(max_ecs=256)
                report.precompile_s = time.perf_counter() - t0
                report.precompile_shapes = shapes
                if hatch_flag("POSEIDON_REPLAY_PROGRESS"):
                    print(
                        f"# replay precompile: {shapes} shapes in "
                        f"{report.precompile_s:.1f}s",
                        file=sys.stderr, flush=True,
                    )

            deltas, metrics = self.planner.schedule_round()
            report.rounds += 1
            report.round_seconds.append(metrics.total_seconds)
            report.solve_seconds.append(metrics.solve_seconds)
            if hatch_flag("POSEIDON_REPLAY_PROGRESS"):
                # Per-round breadcrumbs: a long replay otherwise runs
                # with no observable output until its report.
                print(
                    f"# replay round {report.rounds}: "
                    f"{metrics.total_seconds:.3f}s "
                    f"solve={metrics.solve_seconds:.3f}s "
                    f"placed={metrics.placed} pre={metrics.preempted} "
                    f"mig={metrics.migrated}",
                    file=sys.stderr, flush=True,
                )
            report.placed += metrics.placed
            report.preempted += metrics.preempted
            report.migrated += metrics.migrated
            report.total_objective += metrics.objective
            report.converged = report.converged and metrics.converged

            # Newly placed tasks (re)start their duration clock; a
            # preempted task's standing deadline is invalidated (it will
            # get a fresh one when re-placed).  MIGRATEd tasks keep
            # running — their deadline stands.
            for d in deltas:
                if d.type == 1:  # PLACE
                    dur = self._durations.get(d.task_id)
                    if dur is not None:
                        end = horizon + dur
                        self._deadline[d.task_id] = end
                        heapq.heappush(self._ending, (end, d.task_id))
                elif d.type == 2:  # PREEMPT
                    self._deadline.pop(d.task_id, None)
            now = horizon
            if max_rounds is not None and report.rounds >= max_rounds:
                break
        report.final_unscheduled = self.planner.last_metrics.unscheduled
        return report

"""The system under test, as the harness holds it: the port's Firmament
server in this process, the in-process calls that build its cluster and
its backlog, and the records the harness keeps around it.

What the harness records here is its own: the order in which the
service took in submissions, completions and round snapshots (so the
reference can replay the inputs in that order), each round's start and
end on the host clock, the objective the planner reports, and, in a
traced run, the program's stage timers, counters and spans per round.
"""

from __future__ import annotations

import gc
import threading
import time
from array import array
from typing import List, Optional

import numpy as np

from portbench.reference import COMPLETE, SUBMIT, VIEW, Machines


class Intake:
    """The order in which the service's state took in submissions,
    completions and round snapshots, with each call's reply.

    Each of the three state methods is wrapped on the instance: the
    wrapper holds one lock across the call and the append, so the log's
    order is the order in which the calls took effect.  Arrays, not
    tuples, so the log adds nothing for the collector to walk."""

    def __init__(self, state) -> None:
        self.lock = threading.Lock()
        self.kind = array("b")
        self.uid = array("Q")
        self.reply = array("b")
        sub, comp, view = (state.task_submitted, state.task_completed,
                           state.build_round_view)

        def task_submitted(task):
            with self.lock:
                r = sub(task)
                self._add(SUBMIT, task.uid, int(r))
            return r

        def task_completed(uid):
            with self.lock:
                r = comp(uid)
                self._add(COMPLETE, uid, int(r))
            return r

        def build_round_view(*a, **kw):
            with self.lock:
                v = view(*a, **kw)
                self._add(VIEW, 0, 0)
            return v

        state.task_submitted = task_submitted
        state.task_completed = task_completed
        state.build_round_view = build_round_view

    def _add(self, kind: int, uid: int, reply: int) -> None:
        self.kind.append(kind)
        self.uid.append(uid)
        self.reply.append(reply)

    def views(self) -> int:
        return self.kind.count(VIEW)


class Rounds:
    """Wraps the planner's ``schedule_round`` on the instance: each round's
    host start and end, the objective and counts the planner reports, the
    intake log's snapshot count at its end, and with ``traced`` the
    program's stage timers, device stage times, host reads, kernel
    launches and solve routes of the round."""

    def __init__(self, planner, intake: Intake, traced: bool) -> None:
        self.records: List[dict] = []
        inner = planner.schedule_round
        if traced:
            import torch
            from poseidon_tpu_torch.ops import _kernels
            from poseidon_tpu_torch.ops import transport as T
            from poseidon_tpu_torch.utils import stagetimer

            stagetimer.set_device_timing(True)

        def schedule_round():
            pos = len(intake.kind)
            views0 = intake.views()
            if traced:
                stagetimer.reset()
                _kernels.reset_launches()
                reads0 = T.host_read_count()
                routes0 = dict(T._Telemetry.routes)
            t0 = time.perf_counter()
            if traced:
                with torch.profiler.record_function("portbench.round"):
                    deltas, m = inner()
            else:
                deltas, m = inner()
            t1 = time.perf_counter()
            views = intake.views()
            rec = {"t0": t0, "t1": t1, "pos": pos,
                   "view": views0 if views > views0 else None,
                   "objective": (int(m.objective) if m.num_ecs > 0
                                 and views > views0 else None),
                   "ecs": int(m.num_ecs), "placed": int(m.placed),
                   "tier": m.solve_tier, "gap_bound": float(m.gap_bound),
                   "device_calls": int(m.device_calls)}
            if traced:
                rec["stages"] = {k: v[0] for k, v in
                                 stagetimer.snapshot().items()}
                rec["device"] = {k: v[0] for k, v in
                                 stagetimer.device_snapshot().items()}
                rec["host_reads"] = T.host_read_count() - reads0
                rec["launches"] = dict(_kernels.LAUNCHES)
                rec["routes"] = [
                    [k[0], int(k[1]), int(k[2]), n - routes0.get(k, 0)]
                    for k, n in T._Telemetry.routes.items()
                    if n > routes0.get(k, 0)]
            rec["t2"] = time.perf_counter()
            self.records.append(rec)
            return deltas, m

        planner.schedule_round = schedule_round


class GcClock:
    """The collector's pauses in this process, as (start, seconds,
    generation)."""

    def __init__(self) -> None:
        self.pauses: List[tuple] = []
        self._t0: Optional[float] = None

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((self._t0, time.perf_counter() - self._t0,
                                info["generation"]))
            self._t0 = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


class Service:
    """The port's server on 127.0.0.1, on its default configuration with
    the config file's ``service`` settings, and the in-process calls the
    harness makes on its servicer."""

    def __init__(self, config: dict, device: str, traced: bool,
                 plant=None) -> None:
        from poseidon_tpu_torch.protos import firmament_pb2 as fpb
        from poseidon_tpu_torch.service.server import FirmamentTPUServer
        from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

        self.fpb = fpb
        cfg = FirmamentTPUConfig(device=device, **config.get("service", {}))
        self.server = FirmamentTPUServer(cfg, address="127.0.0.1:0")
        self.servicer = self.server.servicer
        if plant is not None:
            # Tests: a fault planted in the program, under the harness's
            # records.
            plant(self.servicer)
        self.intake = Intake(self.servicer.state)
        self.rounds = Rounds(self.servicer.planner, self.intake, traced)
        self.server.start()

    @property
    def address(self) -> str:
        return self.server.address

    def stop(self) -> None:
        self.server.stop(grace=1.0)

    # -- in-process calls, each reply checked by the caller
    def add_machines(self, m: Machines) -> List[int]:
        fpb = self.fpb
        out = []
        for uuid, cpu, ram, slots in zip(m.uuids, m.cpu.tolist(),
                                         m.ram.tolist(), m.slots.tolist()):
            rtnd = fpb.ResourceTopologyNodeDescriptor()
            rd = rtnd.resource_desc
            rd.uuid = uuid
            rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
            rd.resource_capacity.cpu_cores = float(cpu)
            rd.resource_capacity.ram_cap = int(ram)
            rd.task_capacity = int(slots)
            pu = rtnd.children.add()
            pu.resource_desc.uuid = uuid + "-pu0"
            pu.resource_desc.type = fpb.ResourceDescriptor.RESOURCE_PU
            pu.parent_id = uuid
            out.append(self.servicer.NodeAdded(rtnd, None).type)
        return out

    def submit(self, uids, jobs, cpus, rams) -> np.ndarray:
        fpb = self.fpb
        replies = np.empty(len(uids), np.int8)
        call = self.servicer.TaskSubmitted
        for k, (u, j, c, r) in enumerate(zip(uids, jobs, cpus, rams)):
            req = fpb.TaskDescription()
            td = req.task_descriptor
            td.uid = u
            td.job_id = j
            td.resource_request.cpu_cores = float(c)
            td.resource_request.ram_cap = r
            req.job_descriptor.uuid = j
            replies[k] = call(req, None).type
        return replies

    def complete(self, uids) -> np.ndarray:
        fpb = self.fpb
        replies = np.empty(len(uids), np.int8)
        call = self.servicer.TaskCompleted
        for k, u in enumerate(uids):
            replies[k] = call(fpb.TaskUID(task_uid=u), None).type
        return replies

    def schedule(self, col_of: dict):
        """One in-process ``Schedule()``: its deltas as arrays."""
        reply = self.servicer.Schedule(self.fpb.ScheduleRequest(), None)
        n = len(reply.deltas)
        uid = np.empty(n, np.uint64)
        col = np.empty(n, np.int32)
        typ = np.empty(n, np.int8)
        for k, d in enumerate(reply.deltas):
            uid[k] = d.task_id
            col[k] = col_of.get(d.resource_id, -1)
            typ[k] = d.type
        return uid, col, typ

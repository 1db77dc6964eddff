"""Closed loop: a pending backlog on an oversubscribed cluster.

Set-up (step 0) submits the configuration's ``pods.count`` pods, the
backlog, and makes one ``Schedule()``.  Each window step completes the
pods the previous round placed, tops the pending set back up to the
backlog with the first pods of a fresh batch (``workload.burst_batch``
for the step: fresh task shapes, while the pods left pending keep
theirs), both by in-process calls outside the timed call (``Ingest``),
and the client makes one ``Schedule()`` over gRPC.  After the window,
drain steps complete the placed pods, submit nothing and make one
``Schedule()`` each, until nothing is pending or the traffic's
``drain_rounds`` steps have run.  Every pod submitted in set-up or in
the window is expected to be placed by the run's end.

Each round also records the planner's contention counts
(``RoundMetrics``: band groups, escalated rows, the oldest wait, the
pods left unscheduled and the pods it saw), read with ``getattr`` so
that a program without them still runs the loop."""

import json
import sys
import time

import numpy as np

from portbench import drive, workload
from portbench.reference import PLACE, TASK_COMPLETED_OK, TASK_SUBMITTED_OK

# The planner's per-round fields each round records.
PLANNER_FIELDS = ("band_groups", "escalated_ecs", "max_wait_rounds",
                  "unscheduled", "num_tasks")


class Ingest:
    """The step's in-process submissions and completions, on the port's
    cluster state (under the harness's intake log) as the servicer's
    ``TaskSubmitted`` and ``TaskCompleted`` handlers make them, without
    a protobuf message a pod: the handler's converter makes one
    ``TaskInfo`` a shape from the request ``Service.submit`` sends, and
    each pod of the shape enters as a copy of it under its own uid.  A
    step turns over some 39,000 pods each way, and the window's count of
    rounds, over which ``burst_device_s`` is a mean, is set by the time
    this takes: about half the handlers'.  The copy sets each field on a
    bare instance, so that, like the converter's, it holds no
    ``__dict__`` object for the collector to walk."""

    def __init__(self, svc) -> None:
        from poseidon_tpu_torch.service import converters

        self.fpb, self.converter = svc.fpb, converters.task_info_from_proto
        self.state = svc.servicer.state
        self.shapes = {}

    def _task(self, job: str, cpu: int, ram: int):
        key = (job, cpu, ram)
        t = self.shapes.get(key)
        if t is None:
            req = self.fpb.TaskDescription()
            td = req.task_descriptor
            td.job_id = job
            td.resource_request.cpu_cores = float(cpu)
            td.resource_request.ram_cap = ram
            req.job_descriptor.uuid = job
            t = self.converter(td, job_id=req.job_descriptor.uuid)
            t = self.shapes[key] = (type(t), list(vars(t).items()))
        return t

    def submit(self, uids, job: str, cpus, rams) -> np.ndarray:
        sub, new = self.state.task_submitted, object.__new__
        replies = np.empty(len(uids), np.int8)
        for k, (u, c, r) in enumerate(zip(uids, cpus, rams)):
            cls, fields = self._task(job, c, r)
            task = new(cls)
            for f, v in fields:
                setattr(task, f, v)
            task.uid, task.labels = u, {}
            replies[k] = sub(task)
        return replies

    def complete(self, uids) -> np.ndarray:
        comp = self.state.task_completed
        return np.fromiter((comp(u) for u in uids), np.int8, len(uids))


def loop(ctx) -> dict:
    cfg, seed = ctx.config, ctx.seed
    backlog = int(cfg["pods"]["count"])
    m = workload.machines(cfg, seed)
    svc = ctx.service
    planner = svc.servicer.planner
    ingest = Ingest(svc)
    bad = drive.check(svc.add_machines(m), drive.NODE_ADDED_OK, "NodeAdded")
    shapes = {}
    rounds = []
    pending = set()
    placed_prev = np.zeros(0, np.uint64)
    work = drive.workdir(ctx)
    client = drive.Client("commands", svc.address, m, work)
    ctx.cleanup_client.append(client)
    attempted = 0
    expected = []

    def step(k: int, kind: str):
        nonlocal placed_prev, bad, attempted
        bad += drive.check(ingest.complete(placed_prev.tolist()),
                           TASK_COMPLETED_OK, "TaskCompleted")
        if kind != "after":
            n = max(0, backlog - len(pending))
            b = workload.burst_batch(cfg, seed, k)
            uids = b.uid[:n].tolist()
            cpus, rams = b.cpu[:n].tolist(), b.ram[:n].tolist()
            shapes.update(zip(uids, zip(cpus, rams)))
            bad += drive.check(ingest.submit(uids, b.job, cpus, rams),
                               TASK_SUBMITTED_OK, "TaskSubmitted")
            pending.update(uids)
            expected.extend(uids)
            if kind == "burst":
                attempted += n
        client.send(f"schedule {k}")
        info = json.loads(client.expect(""))
        d = np.load(work / f"round_{k}.npz")
        deltas = (d["uid"], d["col"], d["type"])
        placed_prev = np.unique(deltas[0][deltas[2] == PLACE])
        pending.difference_update(placed_prev.tolist())
        mt = planner.last_metrics
        rounds.append({"kind": kind, "client": [info["t0"], info["t1"]],
                       "deltas": deltas,
                       "planner": {f: getattr(mt, f, None)
                                   for f in PLANNER_FIELDS}})

    step(0, "setup")
    ctx.window_start()
    k = 1
    while time.perf_counter() - ctx.t_window[0] < ctx.seconds:
        step(k, "burst")
        k += 1
    ctx.window_end()
    for _ in range(int(ctx.traffic["drain_rounds"])):
        if not pending:
            break
        step(k, "after")
        k += 1
    client.close()
    report(rounds, svc.rounds.records)
    return {"machines": m, "shapes": shapes, "rounds": rounds,
            "bad_replies": bad, "attempted": attempted,
            "failed": len(pending), "expected": expected}


def report(rounds, server) -> None:
    """Each round's contention on standard error: the pods it placed and
    left unscheduled, its band groups, escalated rows and oldest wait;
    and in a traced run its solves by (route, rows, columns) and its
    kernel launches."""
    rows = []
    for r in rounds:
        p = r["planner"]
        rows.append([r["kind"][0], int(np.count_nonzero(r["deltas"][2]
                                                        == PLACE)),
                     p["unscheduled"], p["band_groups"], p["escalated_ecs"],
                     p["max_wait_rounds"]])
    print("portbench: backlog rounds [kind, placed, unscheduled, band "
          f"groups, escalated rows, max wait]: {rows}", file=sys.stderr)
    for i, s in enumerate(server):
        if "routes" in s:
            launches = {k: v for k, v in s["launches"].items() if v}
            print(f"portbench: round {i} routes {s['routes']} launches "
                  f"{launches}", file=sys.stderr)

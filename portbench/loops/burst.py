"""Closed loop: batch jobs placed one ``Schedule()`` at a time.

Each step: the previous batch's placed pods complete, a new batch job
arrives (both by in-process calls, outside the timed call), and the
client makes one ``Schedule()`` over gRPC.  Step 0 is set-up; steps run
until ``seconds`` have passed."""

import json
import time

import numpy as np

from portbench import drive, workload
from portbench.reference import PLACE, TASK_COMPLETED_OK, TASK_SUBMITTED_OK


def loop(ctx) -> dict:
    cfg, seed = ctx.config, ctx.seed
    m = workload.machines(cfg, seed)
    svc = ctx.service
    bad = drive.check(svc.add_machines(m), drive.NODE_ADDED_OK, "NodeAdded")
    shapes = {}
    rounds = []
    placed_prev = np.zeros(0, np.uint64)
    work = drive.workdir(ctx)
    client = drive.Client("commands", svc.address, m, work)
    ctx.cleanup_client.append(client)
    attempted = failed = 0
    expected = []

    def step(k: int, in_window: bool):
        nonlocal placed_prev, bad, attempted, failed
        bad += drive.check(svc.complete(placed_prev.tolist()),
                           TASK_COMPLETED_OK, "TaskCompleted")
        b = workload.burst_batch(cfg, seed, k)
        uids = b.uid.tolist()
        shapes.update(zip(uids, zip(b.cpu.tolist(), b.ram.tolist())))
        bad += drive.check(svc.submit(uids, [b.job] * len(uids),
                                      b.cpu.tolist(), b.ram.tolist()),
                           TASK_SUBMITTED_OK, "TaskSubmitted")
        client.send(f"schedule {k}")
        info = json.loads(client.expect(""))
        d = np.load(work / f"round_{k}.npz")
        deltas = (d["uid"], d["col"], d["type"])
        placed = np.unique(deltas[0][deltas[2] == PLACE])
        placed_prev = placed
        if in_window:
            expected.extend(uids)
            attempted += len(uids)
            failed += len(uids) - int(np.isin(b.uid, placed).sum())
        rounds.append({"kind": "burst" if in_window else "setup",
                       "client": [info["t0"], info["t1"]],
                       "deltas": deltas})

    step(0, False)
    ctx.window_start()
    k = 1
    while time.perf_counter() - ctx.t_window[0] < ctx.seconds:
        step(k, True)
        k += 1
    ctx.window_end()
    client.close()
    return {"machines": m, "shapes": shapes, "rounds": rounds,
            "bad_replies": bad, "attempted": attempted, "failed": failed,
            "expected": expected}

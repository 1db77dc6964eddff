"""The benchmark's client: a process of its own that speaks the Firmament
protocol over gRPC, as Poseidon's ``pkg/firmament`` client does
(``TaskSubmitted``, ``TaskCompleted``, ``Schedule``).  It imports grpc,
protobuf, NumPy and the frozen ``firmament_pb2`` beside it, and nothing
of the scheduler.  Every end-to-end time is read on its clock
(``time.perf_counter``, the host's monotonic clock, which the harness's
process shares).

Two modes:

``commands``
    Closed loop on commands: each ``schedule K`` line on standard input
    makes one ``Schedule()`` call; its deltas go to ``OUTDIR/round_K.npz``
    and one JSON line with the call's send and reply times to standard
    output.  ``quit`` ends it.

``plan``
    Open loop over a plan of timed events (``--plan``, written by the
    harness; ``workload.Plan`` describes it): each SUBMIT is sent at its
    time and each COMPLETE at its own, a pod whose SUBMIT carries a
    duration completes that long after its placement reached this
    client, and ``Schedule()`` is called at each SCHEDULE event's time
    or, in a plan without one, in a loop that waits the plan's gap after
    each reply, as Poseidon's loop sleeps its scheduling interval.  The
    loop runs on past the window's end until every pod due before it is
    placed, or the grace has passed.  Everything it saw goes to
    ``OUTDIR/plan_out.npz``.

Run: ``python3 portbench/client/client.py commands|plan --address
HOST:PORT --machines FILE --outdir DIR [...]``.
"""

from __future__ import annotations

import argparse
import gc
import heapq
import json
import sys
import threading
import time
from pathlib import Path

import grpc
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import firmament_pb2 as fpb  # noqa: E402

SERVICE = "/firmament.FirmamentScheduler/"
PLACE = fpb.SchedulingDelta.PLACE


def channel(address: str) -> grpc.Channel:
    # A 100k-pod round's SchedulingDeltas pass gRPC's 4 MB default.
    return grpc.insecure_channel(address, options=[
        ("grpc.max_receive_message_length", 256 << 20),
        ("grpc.max_send_message_length", 256 << 20),
    ])


class Stub:
    """The three calls of the Firmament service this client makes."""

    def __init__(self, ch: grpc.Channel) -> None:
        def call(name, req, resp):
            return ch.unary_unary(SERVICE + name,
                                  request_serializer=req.SerializeToString,
                                  response_deserializer=resp.FromString)

        self.Schedule = call("Schedule", fpb.ScheduleRequest,
                             fpb.SchedulingDeltas)
        self.TaskSubmitted = call("TaskSubmitted", fpb.TaskDescription,
                                  fpb.TaskSubmittedResponse)
        self.TaskCompleted = call("TaskCompleted", fpb.TaskUID,
                                  fpb.TaskCompletedResponse)


def deltas_arrays(reply, col_of):
    """A reply's deltas as (uid uint64, machine index or -1, type)."""
    n = len(reply.deltas)
    uid = np.empty(n, np.uint64)
    col = np.empty(n, np.int32)
    typ = np.empty(n, np.int8)
    for k, d in enumerate(reply.deltas):
        uid[k] = d.task_id
        col[k] = col_of.get(d.resource_id, -1)
        typ[k] = d.type
    return uid, col, typ


def task_request(uid, job, cpu, ram):
    req = fpb.TaskDescription()
    td = req.task_descriptor
    td.uid = int(uid)
    td.job_id = job
    td.resource_request.cpu_cores = float(cpu)
    td.resource_request.ram_cap = int(ram)
    req.job_descriptor.uuid = job
    return req


def wait_until(t: float) -> None:
    d = t - time.perf_counter()
    if d > 0:
        time.sleep(d)


# --------------------------------------------------------------- commands

def run_commands(stub: Stub, col_of: dict, outdir: Path) -> None:
    print("READY", flush=True)
    for line in sys.stdin:
        words = line.split()
        if not words or words[0] == "quit":
            break
        k = int(words[1])
        t0 = time.perf_counter()
        reply = stub.Schedule(fpb.ScheduleRequest())
        t1 = time.perf_counter()
        uid, col, typ = deltas_arrays(reply, col_of)
        np.savez(outdir / f"round_{k}.npz", uid=uid, col=col, type=typ)
        print(json.dumps({"k": k, "t0": t0, "t1": t1, "n": int(uid.size)}),
              flush=True)


# ------------------------------------------------------------------- plan

# The kinds of a plan's events.
SUBMIT, COMPLETE, SCHEDULE = 0, 1, 2


class PlanLoop:
    """The open loop: one thread each for submissions, completions and
    ``Schedule()`` calls."""

    def __init__(self, stub: Stub, plan, col_of: dict, warm: float,
                 seconds: float, grace: float) -> None:
        self.stub, self.col_of = stub, col_of
        self.warm, self.seconds, self.grace = warm, seconds, grace
        kind = plan["kind"]
        sub = np.flatnonzero(kind == SUBMIT)
        self.due = plan["t"][sub]
        self.uid = plan["uid"][sub]
        self.dur = plan["dur"][sub]
        comp = np.flatnonzero(kind == COMPLETE)
        self.comp_at = list(zip(plan["t"][comp].tolist(),
                                plan["uid"][comp].tolist()))
        self.sched_at = plan["t"][kind == SCHEDULE].tolist()
        self.gap = float(plan["gap"])
        n = self.due.size
        self.reqs = [task_request(u, f"job-{j}", c, r) for u, j, c, r in zip(
            self.uid.tolist(), plan["job"][sub].tolist(),
            plan["cpu"][sub].tolist(), plan["ram"][sub].tolist())]
        self.index = {u: i for i, u in enumerate(self.uid.tolist())}
        self.sent = np.full(n, np.nan)
        self.reply = np.full(n, np.nan)
        self.reply_type = np.full(n, -1, np.int32)
        self.placed = np.full(n, np.nan)
        self.n_sent = 0
        self.n_placed = 0
        self.backlog = []       # (time, pods submitted and not placed)
        self.cv = threading.Condition()
        self.comp = []          # (uid, sent, reply, type) per completion
        self.rounds = []        # (t0, t1, n_deltas)
        self.deltas = []        # per round: (uid, col, type)
        self.stop = threading.Event()
        self.errors = []

    # -- submissions
    def submit(self) -> None:
        try:
            for i in range(self.due.size):
                t = self.t0 + float(self.due[i])
                while not self.stop.is_set() and time.perf_counter() < t:
                    self.stop.wait(t - time.perf_counter())
                if self.stop.is_set():
                    break
                self.sent[i] = time.perf_counter()
                f = self.stub.TaskSubmitted.future(self.reqs[i])
                f.add_done_callback(self._submitted(i))
                self.n_sent = i + 1
        except Exception as e:  # noqa: BLE001 - reported by the harness
            self.errors.append(f"submit: {e!r}")

    def _submitted(self, i):
        def done(f):
            self.reply[i] = time.perf_counter()
            try:
                self.reply_type[i] = f.result().type
            except grpc.RpcError as e:
                self.errors.append(f"TaskSubmitted: {e.code()}")
        return done

    # -- completions, at their times or after their placements
    def complete(self) -> None:
        try:
            while True:
                with self.cv:
                    while True:
                        now = time.perf_counter()
                        if self.stop.is_set():
                            return
                        if self.heap and self.heap[0][0] <= now:
                            _, u = heapq.heappop(self.heap)
                            break
                        self.cv.wait(self.heap[0][0] - now if self.heap
                                     else None)
                rec = [u, time.perf_counter(), np.nan, -1]
                self.comp.append(rec)
                f = self.stub.TaskCompleted.future(fpb.TaskUID(task_uid=u))
                f.add_done_callback(self._completed(rec))
        except Exception as e:  # noqa: BLE001 - reported by the harness
            self.errors.append(f"complete: {e!r}")

    def _completed(self, rec):
        def done(f):
            rec[2] = time.perf_counter()
            try:
                rec[3] = f.result().type
            except grpc.RpcError as e:
                self.errors.append(f"TaskCompleted: {e.code()}")
        return done

    # -- rounds
    def _done(self) -> bool:
        """Past the window's end with every pod due in it placed, or past
        the grace."""
        now = time.perf_counter()
        if now < self.t_end:
            return False
        return (now >= self.t_end + self.grace
                or not np.isnan(self.placed[:self.n_due_in]).any())

    def schedule(self) -> None:
        try:
            wait_until(self.t0)
            k = 0
            while not self._done():
                if k < len(self.sched_at):
                    wait_until(self.t0 + self.sched_at[k])
                    k += 1
                t0 = time.perf_counter()
                reply = self.stub.Schedule(fpb.ScheduleRequest())
                t1 = time.perf_counter()
                self._placed(reply, t0, t1)
                if k >= len(self.sched_at):
                    # The scheduler's loop waits between rounds.
                    time.sleep(self.gap)
        except Exception as e:  # noqa: BLE001 - reported by the harness
            self.errors.append(f"schedule: {e!r}")
        finally:
            self.stop.set()
            with self.cv:
                self.cv.notify()

    def _placed(self, reply, t0: float, t1: float) -> None:
        uid, col, typ = deltas_arrays(reply, self.col_of)
        self.rounds.append((t0, t1, uid.size))
        self.deltas.append((uid, col, typ))
        pushes = []
        for u, c, ty in zip(uid.tolist(), col.tolist(), typ.tolist()):
            i = self.index.get(u)
            if i is None or ty != PLACE or c < 0:
                continue
            if np.isnan(self.placed[i]):
                self.placed[i] = t1
                self.n_placed += 1
                if not np.isnan(self.dur[i]):
                    pushes.append((t1 + float(self.dur[i]), u))
        # The backlog after each round: submitted, not placed.
        self.backlog.append((t1, self.n_sent - self.n_placed))
        if pushes:
            with self.cv:
                for p in pushes:
                    heapq.heappush(self.heap, p)
                self.cv.notify()

    def run(self, t0: float) -> None:
        """Run the loop from ``t0`` (a ``perf_counter`` time)."""
        self.t0 = t0
        self.t_end = t0 + self.warm + self.seconds
        self.n_due_in = int(np.searchsorted(self.due, self.warm
                                            + self.seconds))
        # Completions: (due time, uid).
        self.heap = [(t0 + t, int(u)) for t, u in self.comp_at]
        heapq.heapify(self.heap)
        threads = [threading.Thread(target=f, name=f.__name__)
                   for f in (self.submit, self.complete, self.schedule)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def save(self, path: Path) -> dict:
        # A reply still in flight is waited for (a minute at most).
        limit = time.perf_counter() + 60.0
        while time.perf_counter() < limit and (
                np.isnan(self.reply[:self.n_sent]).any()
                or any(np.isnan(r[2]) for r in self.comp)):
            time.sleep(0.01)
        comp = np.array([r[:1] for r in self.comp], np.uint64).reshape(-1)
        comp_t = np.array([r[1:] for r in self.comp],
                          np.float64).reshape(-1, 3)
        rounds = np.array(self.rounds, np.float64).reshape(-1, 3)
        if self.deltas:
            d_uid = np.concatenate([d[0] for d in self.deltas])
            d_col = np.concatenate([d[1] for d in self.deltas])
            d_typ = np.concatenate([d[2] for d in self.deltas])
            d_round = np.repeat(np.arange(len(self.deltas)),
                                [d[0].size for d in self.deltas])
        else:
            d_uid = np.zeros(0, np.uint64)
            d_col = np.zeros(0, np.int32)
            d_typ = np.zeros(0, np.int8)
            d_round = np.zeros(0, np.int64)
        np.savez(path, sent=self.sent, reply=self.reply,
                 reply_type=self.reply_type, placed=self.placed,
                 comp_uid=comp, comp_t=comp_t, rounds=rounds,
                 d_uid=d_uid, d_col=d_col, d_type=d_typ, d_round=d_round,
                 backlog=np.array(self.backlog, np.float64).reshape(-1, 2),
                 n_sent=np.array(self.n_sent))
        return {"sent": self.n_sent, "rounds": len(self.rounds),
                "completions": len(self.comp), "errors": self.errors[:20]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("commands", "plan"))
    ap.add_argument("--address", required=True)
    ap.add_argument("--machines", required=True,
                    help="file of machine uuids, one a line, in index order")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--plan", help="plan: the plan (.npz)")
    ap.add_argument("--warm", type=float, default=0.0)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--grace", type=float, default=60.0)
    a = ap.parse_args(argv)
    uuids = Path(a.machines).read_text().split()
    col_of = {u: i for i, u in enumerate(uuids)}
    outdir = Path(a.outdir)
    with channel(a.address) as ch:
        stub = Stub(ch)
        if a.mode == "commands":
            run_commands(stub, col_of, outdir)
            return 0
        plan = dict(np.load(a.plan))
        loop = PlanLoop(stub, plan, col_of, a.warm, a.seconds, a.grace)
        # The generator must keep its schedule: the plan's objects are
        # moved out of the collector's sight and the collector is off for
        # the loop, and a thread waiting to send gets the interpreter
        # within half a millisecond, not the default five.
        gc.freeze()
        gc.disable()
        sys.setswitchinterval(0.0005)
        print("READY", flush=True)
        # The harness answers with the loop's start: "start T0".
        loop.run(float(sys.stdin.readline().split()[1]))
        summary = loop.save(outdir / "plan_out.npz")
        print("DONE " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

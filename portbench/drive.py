"""What the loops (``loops/<name>.py``) share: the client process and the
open loop's driver.

A loop is a file ``loops/<name>.py`` with a function ``loop(ctx)``,
found by the name a traffic file's ``loop`` gives.  It builds the cell's
cluster and inputs from ``ctx.config``, ``ctx.traffic`` and ``ctx.seed``
and returns the run's record: the rounds the client received, what the
reference needs to judge them, and the client's timings.  An open loop
only has to build a ``workload.Plan`` and hand it to ``run_plan``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import workload
from portbench.reference import TASK_COMPLETED_OK, TASK_SUBMITTED_OK

CLIENT = Path(__file__).resolve().parent / "client" / "client.py"
NODE_ADDED_OK = 0


class Client:
    """The client process (``client/client.py``), which imports neither
    torch nor the port."""

    def __init__(self, mode: str, address: str, machines, workdir: Path,
                 *extra: str) -> None:
        (workdir / "machines.txt").write_text("\n".join(machines.uuids))
        self.proc = subprocess.Popen(
            [sys.executable, str(CLIENT), mode, "--address", address,
             "--machines", str(workdir / "machines.txt"),
             "--outdir", str(workdir), *extra],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.expect("READY")

    def expect(self, word: str) -> str:
        line = self.proc.stdout.readline()
        if not line.startswith(word):
            self.close()
            raise RuntimeError(f"client said {line!r}, not {word}")
        return line[len(word):].strip()

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send("quit")
            except (BrokenPipeError, OSError):
                pass
        try:
            self.proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def check(replies, ok, what: str) -> int:
    """The replies that are not ``ok``, counted and reported."""
    bad = int((np.asarray(replies) != ok).sum())
    if bad:
        print(f"portbench: {bad} {what} replies were not OK", file=sys.stderr)
    return bad


def workdir(ctx) -> Path:
    """A directory for the client's files, removed after the run."""
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    ctx.cleanup.append(work)
    return work


def run_plan(ctx, m, plan: workload.Plan) -> dict:
    """Drive an open loop: add the machines, place ``plan.running`` in
    set-up (in-process, one ``Schedule()``), then hand the plan to the
    client, which sends each event at its time from the loop's start.
    The window is [``warm_s``, ``warm_s`` + seconds) from the loop's
    start; the client runs on past it until every pod due before its end
    is placed, for the traffic's ``grace_s`` at most."""
    svc = ctx.service
    bad = check(svc.add_machines(m), NODE_ADDED_OK, "NodeAdded")
    run = plan.running
    shapes = dict(zip(run.uid.tolist(),
                      zip(run.cpu.tolist(), run.ram.tolist())))
    sub = plan.submits()
    shapes.update(zip(plan.uid[sub].tolist(),
                      zip(plan.cpu[sub].tolist(), plan.ram[sub].tolist())))
    bad += check(svc.submit(run.uid.tolist(), [run.job] * run.uid.size,
                            run.cpu.tolist(), run.ram.tolist()),
                 TASK_SUBMITTED_OK, "TaskSubmitted")
    rounds = [{"kind": "setup", "client": None,
               "deltas": svc.schedule(m.index)}]
    work = workdir(ctx)
    np.savez(work / "plan.npz", t=plan.t, kind=plan.kind, uid=plan.uid,
             job=plan.job, cpu=plan.cpu, ram=plan.ram, dur=plan.dur,
             gap=np.array(plan.gap_s))
    warm = plan.warm_s
    client = Client("plan", svc.address, m, work, "--plan",
                    str(work / "plan.npz"), "--warm", str(warm),
                    "--seconds", str(ctx.seconds),
                    "--grace", str(ctx.traffic["grace_s"]))
    ctx.cleanup_client.append(client)
    ctx.trace_early()
    t0 = time.perf_counter() + 0.5
    client.send(f"start {t0!r}")
    ctx.window_start(at=t0 + warm)
    ctx.window_end(at=t0 + warm + ctx.seconds)
    summary = json.loads(client.expect("DONE"))
    client.close()
    if summary["errors"]:
        print(f"portbench: client errors {summary['errors']}",
              file=sys.stderr)
        bad += len(summary["errors"])
    d = np.load(work / "plan_out.npz")
    n_sent = int(d["n_sent"])
    bad += check(d["reply_type"][:n_sent], TASK_SUBMITTED_OK,
                 "TaskSubmitted (client)")
    bad += check(d["comp_t"][:, 2], TASK_COMPLETED_OK,
                 "TaskCompleted (client)")
    w0, w1 = ctx.t_window
    for r, (c0, c1, _n) in enumerate(d["rounds"].tolist()):
        sel = d["d_round"] == r
        kind = ("warm" if c0 < w0 else "stream" if c0 < w1 else "after")
        rounds.append({"kind": kind, "client": [c0, c1],
                       "deltas": (d["d_uid"][sel], d["d_col"][sel],
                                  d["d_type"][sel])})
    # Per pod the loop submitted (the plan's SUBMIT events in order).
    due = t0 + plan.t[sub][:n_sent]
    in_win = (due >= w0) & (due < w1)
    expected = plan.uid[sub][:n_sent][due < w1].tolist()
    placed = d["placed"][:n_sent]
    lat = placed[in_win] - due[in_win]
    unplaced = np.isnan(lat)
    # A pod never placed waited at least until the client gave up.
    end = (float(d["rounds"][-1, 1]) if len(d["rounds"]) else w1)
    lat[unplaced] = end - due[in_win][unplaced]
    sent = d["sent"][:n_sent]
    rtt = (d["reply"][:n_sent] - sent)[(sent >= w0) & (sent < w1)]
    report(ctx, svc, d, (sent - due)[in_win], lat)
    return {"machines": m, "shapes": shapes, "rounds": rounds,
            "bad_replies": bad, "attempted": int(in_win.sum()),
            "failed": int(unplaced.sum()), "latency": lat,
            "submit_rtt": rtt, "expected": expected}


def report(ctx, svc, d, lateness, lat) -> None:
    """The open loop's own readings on standard error: the window's
    rounds on the server, the backlog after each round, how late the
    client sent, and the latency's upper quantiles."""
    w0, w1 = ctx.t_window
    work = [r for r in svc.rounds.records
            if r["view"] is not None and w0 <= r["t0"] < w1]
    if work:
        secs = np.array([r["t1"] - r["t0"] for r in work])
        tiers = {}
        for r in work:
            tiers[r["tier"]] = tiers.get(r["tier"], 0) + 1
        print(f"portbench: {len(work)} window rounds with a snapshot, "
              f"{secs.mean():.4f} s mean, {secs.max():.4f} s max, device "
              f"calls {sum(r['device_calls'] for r in work)}, tiers {tiers}",
              file=sys.stderr)
    bl = d["backlog"]
    inw = bl[(bl[:, 0] >= w0) & (bl[:, 0] < w1)]
    if inw.size and lat.size:
        print(f"portbench: backlog after the window's rounds "
              f"{inw[:, 1].astype(int).tolist()}; the client late by p50 "
              f"{np.percentile(lateness, 50):.4f} s, max "
              f"{lateness.max():.4f} s; latency p90 "
              f"{np.percentile(lat, 90):.4f} p95 "
              f"{np.percentile(lat, 95):.4f} s", file=sys.stderr)

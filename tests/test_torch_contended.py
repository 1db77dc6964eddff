"""The contended deployment: an oversubscribed cluster whose pending
backlog outlives every round (``contended-10k`` under the ``backlog``
traffic), on the CPU at a small size.

- the planner counts each round's band groups, its escalated EC rows and
  its oldest wait (``RoundMetrics``), exports them, and records one
  ``round.band_group`` interval per group, beside the stage spans, on a
  round whose bands the merge gate keeps apart and on one it merges;
- a whole run of the cell through the benchmark's harness: sound, it is
  ``correct`` with every check 0, holds the backlog in every window
  round, leaves pods unscheduled, escalates their rows and splits the
  bands, and drains after the window; the control, half of each round's
  answers dropped, and the same cluster driven by the burst loop (which
  submits a whole batch a step, so its backlog grows past what the
  drain can place) each read ``correct`` false;
- the loop's in-process ingest enters the same tasks, with the same
  replies and the same intake log, as the servicer's handlers.
"""

import json

import pytest

from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.instance import RoundPlanner
from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo
from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

GATES = ("POSEIDON_TRACE", "POSEIDON_STAGE_TIMERS")
CELL = "contended-10k.backlog"
MACHINES, BACKLOG = 60, 400


def _cluster(machines: int) -> ClusterState:
    """Machines of the contended class (4,000 mc, 16 GiB, 8 slots) and
    16 pods of 1,100 mc (band 0, three a machine) and 12 of 300 mc
    (band 1)."""
    st = ClusterState()
    for i in range(machines):
        st.node_added(MachineInfo(
            uuid=generate_uuid(f"ct-m{i}"), cpu_capacity=4000,
            ram_capacity=1 << 24, task_slots=8))
    for i in range(28):
        big = i < 16
        st.task_submitted(TaskInfo(
            uid=task_uid("ct", i), job_id="ct-big" if big else "ct-small",
            cpu_request=1100 if big else 300, ram_request=1 << 18))
    return st


@pytest.mark.parametrize("machines,groups", [(4, 2), (40, 1)],
                         ids=["split", "merged"])
def test_round_counts_contention(monkeypatch, machines, groups):
    """Four machines hold 12 of the 16 large pods and 8 of the small
    ones: the gate keeps the bands apart, and the next round sees both
    rows escalated.  Forty machines hold them all, and the gate merges
    the two bands into one group."""
    monkeypatch.setenv("POSEIDON_MERGE_BANDS", "1")
    tr = obs_trace.tracer()
    prev = tr.force
    tr.force = True
    try:
        obs_trace.drain_spans()
        planner = RoundPlanner(_cluster(machines),
                               get_cost_model("cpu_mem"), device="cpu")
        _, m = planner.schedule_round()
        spans = obs_trace.drain_spans()
        _, m2 = planner.schedule_round()
        obs_trace.drain_spans()
    finally:
        tr.force = prev
    assert m.band_groups == groups
    assert (m.escalated_ecs, m.max_wait_rounds) == (0, 0)
    (rnd,) = [s for s in spans if s["name"] == "round"]
    g = [s for s in spans if s["name"] == "round.band_group"]
    assert len(g) == groups
    assert all(s["parent"] == rnd["id"] for s in g)
    assert sum(s["attrs"]["rows"] for s in g) == m.num_ecs == 2
    assert sum(s["attrs"]["supply"] for s in g) == m.num_tasks == 28
    assert [(s["attrs"]["bands"], s["attrs"]["merged"]) for s in g] == (
        [(1, False)] * 2 if groups == 2 else [(2, True)])
    # The stage spans keep the round as their parent.
    for s in spans:
        if s["name"] in ("round.cost_build", "round.solve_band"):
            assert s["parent"] == rnd["id"]
    if groups == 2:
        assert (m.placed, m.unscheduled) == (20, 8)
        assert (m2.escalated_ecs, m2.max_wait_rounds) == (2, 1)
        assert (m2.num_tasks, m2.band_groups) == (8, 2)
    else:
        assert (m.placed, m.unscheduled) == (28, 0)
    reg = obs_metrics.Registry()
    obs_metrics.observe_round(m2 if groups == 2 else m, registry=reg)
    text = reg.expose()
    assert f"poseidon_round_band_groups {groups}" in text
    assert f"poseidon_rounds_band_groups_total {groups}" in text
    assert "poseidon_round_escalated_ecs" in text
    assert "poseidon_round_max_wait_rounds" in text


def _root(tmp_path):
    """The benchmark's files under a temporary root, the contended
    cluster cut to MACHINES machines and a BACKLOG-pod backlog, and the
    same configuration under the burst traffic as a cell of the root's
    own."""
    from portbench.tests.conftest import make_root

    root = make_root(tmp_path / "checkout")
    path = root / "portbench" / "configs" / "contended-10k.json"
    cfg = json.loads(path.read_text())
    cfg["machines"]["count"] = MACHINES
    cfg["pods"]["count"] = BACKLOG
    path.write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "contended-10k.burst",
                               "config": "contended-10k",
                               "traffic": "burst", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def root(tmp_path, monkeypatch):
    # run_cell sets the tracer's gates in a traced run: restored after.
    for g in GATES:
        monkeypatch.setenv(g, "0")
    obs_trace.reset()
    yield _root(tmp_path)
    obs_trace.reset()


def test_sound_backlog_run(root, monkeypatch):
    from portbench import harness

    runs = []
    real = harness.loop_of

    def spy(name, root):
        inner = real(name, root)

        def loop(ctx):
            runs.append(inner(ctx))
            return runs[-1]

        return loop

    monkeypatch.setattr(harness, "loop_of", spy)
    res = harness.run_cell(CELL, 3100000019, 2.0, True, device="cpu",
                           root=root)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["failed"] == 0 and res["attempted"] > 0
    (out,) = runs
    kinds = [r["kind"] for r in out["rounds"]]
    assert kinds[0] == "setup" and kinds[-1] == "after"
    assert kinds.count("burst") >= 2
    window = [r["planner"] for r in out["rounds"] if r["kind"] == "burst"]
    # The backlog is topped up to its size before every window round,
    # and every round leaves part of it.
    assert all(p["num_tasks"] == BACKLOG for p in window)
    assert all(0 < p["unscheduled"] < BACKLOG for p in window)
    assert all(p["band_groups"] >= 2 for p in window)
    assert any(p["max_wait_rounds"] > 0 for p in window)
    assert out["rounds"][-1]["planner"]["unscheduled"] == 0
    m = res["metrics"]
    assert m["band_groups.backlog"]["value"] >= 2
    assert m["escalated_ecs.backlog"]["value"] > 0
    assert m["band_group_s.backlog"]["value"] > 0
    assert 0 < m["unscheduled_pct.backlog"]["value"] < 100


def _half(servicer):
    """Half of each round's answers left out."""
    p = servicer.planner
    inner = p.schedule_round

    def f():
        d, m = inner()
        return d[: len(d) // 2], m

    p.schedule_round = f


@pytest.mark.parametrize("case", ["control", "half", "burst_loop"])
def test_backlog_fault_is_caught(root, case):
    from portbench import harness

    cell = "contended-10k.burst" if case == "burst_loop" else CELL
    res = harness.run_cell(cell, 3100000023, 2.0, False, device="cpu",
                           root=root, control=case == "control",
                           plant=_half if case == "half" else None)
    assert not res["correct"], res["checks"]
    checks = {k: c["value"] for k, c in res["checks"].items()}
    if case == "control":
        assert checks["neg_cycles"] > 0
    elif case == "burst_loop":
        # Every other check holds: only the growing backlog fails it.
        assert checks["never_placed"] > 0
        assert sum(checks.values()) == checks["never_placed"]


def test_backlog_ingest_matches_the_handlers():
    """Pods submitted by the backlog loop's ``Ingest`` equal, field for
    field but their uid and acceptance time, those the servicer's
    ``TaskSubmitted`` makes from the request the harness sends; both
    ways reply OK, complete alike, and log each call in the intake log
    the reference reads."""
    import dataclasses

    import numpy as np

    from portbench import harness, workload
    from portbench.reference import (COMPLETE, SUBMIT, TASK_COMPLETED_OK,
                                     TASK_SUBMITTED_OK)
    from portbench.service import Service
    from poseidon_tpu_torch.graph.state import TaskState

    spec = harness.cell_spec(CELL)
    cfg = json.loads(json.dumps(spec.config))
    cfg["machines"]["count"] = 4
    svc = Service(cfg, "cpu", False)
    try:
        ingest = harness._load("loops", "backlog", harness.ROOT).Ingest(svc)
        b = workload.burst_batch(cfg, 3100000029, 1)
        n = 48
        cpus, rams = b.cpu[:n].tolist(), b.ram[:n].tolist()
        mine = (b.uid[:n] + (1 << 31)).tolist()
        theirs = b.uid[:n].tolist()
        assert (svc.submit(theirs, [b.job] * n, cpus, rams)
                == TASK_SUBMITTED_OK).all()
        assert (ingest.submit(mine, b.job, cpus, rams)
                == TASK_SUBMITTED_OK).all()
        tasks = svc.servicer.state.tasks

        def fields(uid):
            d = dataclasses.asdict(tasks[uid])
            del d["uid"], d["accepted_at"]
            return d

        for u, v in zip(mine, theirs):
            assert fields(u) == fields(v)
            assert tasks[u].ec_id == tasks[v].ec_id
        assert len({tasks[u].ec_id for u in mine}) == len(set(cpus))
        assert (ingest.complete(mine[:10]) == TASK_COMPLETED_OK).all()
        assert (svc.complete(theirs[:10]) == TASK_COMPLETED_OK).all()
        assert all(tasks[u].state == TaskState.COMPLETED
                   for u in mine[:10] + theirs[:10])
        kind = np.asarray(svc.intake.kind)
        uid = np.asarray(svc.intake.uid)
        assert set(uid[kind == SUBMIT].tolist()) == set(mine + theirs)
        assert set(uid[kind == COMPLETE].tolist()) == set(
            mine[:10] + theirs[:10])
    finally:
        svc.stop()

"""The port's delta-maintained cost planes (``costmodel/delta.py``) and
cross-band pipeline (``graph/pipeline.py``) against the JAX package's.

Two clusters, one per package, are driven in lockstep through the same
seeded churn (task turnover, a node relabel, utilization samples, a
machine leaving and another arriving).  Every build, the port's
``CostPlaneCache`` must give the same planes as the JAX cache and as a
full ``model.build`` (the oracle), the same ``last_stats`` and the same
dirty ledgers.  ``CostPipeline`` must return the synchronous build's
planes, and the planner must place identically with the pipeline on and
off, and with the accepted-shortlist revival, as the JAX planner does.
"""

import threading
import time

import numpy as np
import pytest

from poseidon_tpu.costmodel import get_cost_model as j_cost_model
from poseidon_tpu.costmodel.delta import CostPlaneCache as JCache
from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
from poseidon_tpu.graph.state import ClusterState as JState
from poseidon_tpu.graph.state import MachineInfo as JMachine
from poseidon_tpu.graph.state import TaskInfo as JTask
from poseidon_tpu.utils.ids import generate_uuid, task_uid
from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.costmodel.delta import CostPlaneCache
from poseidon_tpu_torch.graph.instance import RoundPlanner
from poseidon_tpu_torch.graph.pipeline import CostPipeline
from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo

DELTA_ENV = {
    "POSEIDON_COST_DELTA_MIN_CELLS": "1",
    "POSEIDON_COST_DELTA_MIN_ROWS": "1",
}
STAT_KEYS = ("delta_hit", "rows_rebuilt", "cols_rebuilt", "path")


@pytest.fixture
def delta_env(monkeypatch):
    for k, v in DELTA_ENV.items():
        monkeypatch.setenv(k, v)


class Pair:
    """One cluster per package, mutated in lockstep."""

    def __init__(self, n_machines, labeled=True):
        self.sides = [(JState(), JMachine, JTask),
                      (ClusterState(), MachineInfo, TaskInfo)]
        for i in range(n_machines):
            self.node_added(f"cd-m{i}", 32000, 128 << 20,
                            {"zone": f"z{i % 3}"} if labeled else {})
        self.uid = 0

    @property
    def states(self):
        return [s for s, _, _ in self.sides]

    def node_added(self, name, cpu, ram, labels):
        for st, Machine, _ in self.sides:
            st.node_added(Machine(uuid=generate_uuid(name), cpu_capacity=cpu,
                                  ram_capacity=ram, task_slots=16,
                                  labels=dict(labels)))

    def submit(self, n, rng, shapes, labels=None, gang=False):
        for _ in range(n):
            i = self.uid
            self.uid += 1
            cpu, ram = shapes[int(rng.integers(len(shapes)))]
            for st, _, Task in self.sides:
                st.task_submitted(Task(
                    uid=task_uid("cd-t", i), job_id=f"cd-j{i % 9}",
                    cpu_request=cpu, ram_request=ram, gang=gang,
                    labels=dict(labels) if labels else {}))

    def remove_placed(self, k):
        js = self.states[0]
        live = [t.uid for t in js.tasks.values() if t.scheduled_to][:k]
        for st in self.states:
            for uid in live:
                st.task_removed(uid)

    def relabel(self, uuid, labels):
        for st, Machine, _ in self.sides:
            m = st.machines[uuid]
            st.node_updated(Machine(
                uuid=uuid, cpu_capacity=m.cpu_capacity,
                ram_capacity=m.ram_capacity, task_slots=m.task_slots,
                labels=dict(labels)))

    def node_stats(self, uuids, sample):
        for st in self.states:
            for u in uuids:
                st.add_node_stats(u, dict(sample))

    def views(self):
        return [st.build_round_view() for st in self.states]


def _same_planes(*cms):
    a = cms[0]
    for b in cms[1:]:
        np.testing.assert_array_equal(a.costs, b.costs)
        np.testing.assert_array_equal(a.unsched_cost, b.unsched_cost)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert (a.arc_capacity is None) == (b.arc_capacity is None)
        if a.arc_capacity is not None:
            np.testing.assert_array_equal(a.arc_capacity, b.arc_capacity)


def _same_stats(a, b):
    for k in STAT_KEYS:
        assert a[k] == b[k], k
    for k in ("dirty_rows", "dirty_cols"):
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            np.testing.assert_array_equal(a[k], b[k])


def _same_ledger(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.broken, a.rows, a.cols, a.present) == \
            (b.broken, b.rows, b.cols, b.present)


class _Caches:
    """A JAX cache and a port cache over the pair's cost models."""

    def __init__(self):
        self.models = [j_cost_model("cpu_mem"), get_cost_model("cpu_mem")]
        self.caches = [JCache(self.models[0]), CostPlaneCache(self.models[1])]

    def build(self, key, views):
        """Both caches' builds of ``key`` checked against each other and
        against the port's oracle; returns the port's stats."""
        got = [c.build(key, v.ecs, v.machines)
               for c, v in zip(self.caches, views)]
        want = self.models[1].build(views[1].ecs, views[1].machines)
        _same_planes(got[0], got[1], want)
        _same_stats(*(c.last_stats for c in self.caches))
        return self.caches[1].last_stats

    def take_ledgers(self, key):
        led = [c.take_ledger(key) for c in self.caches]
        _same_ledger(*led)
        return led[1]


def test_churn_planes_match_reference_and_oracle(delta_env):
    """Fourteen churn rounds through real cluster states, planners of
    both packages placing between builds: every build's planes, stats
    and ledgers are the JAX cache's and the oracle's, the incremental
    path serves the steady-state rounds, and the rounds' deltas match."""
    rng = np.random.default_rng(42)
    pair = Pair(40)
    shapes = [(200, 1 << 19), (400, 1 << 20), (800, 1 << 19)]
    # More tasks than slots: a persistent backlog keeps the same EC rows
    # pending round after round.
    pair.submit(900, rng, shapes, labels={"app": "seed"})
    caches = _Caches()
    planners = [JPlanner(pair.states[0], j_cost_model("cpu_mem")),
                RoundPlanner(pair.states[1], get_cost_model("cpu_mem"),
                             device="cpu")]
    delta_rounds = 0
    for rnd in range(14):
        views = pair.views()
        if views[1].ecs.num_ecs and views[1].machines.num_machines:
            stats = caches.build(0, views)
            delta_rounds += bool(stats["delta_hit"])
            caches.take_ledgers(0)
        (jd, jm), (td, tm) = (p.schedule_round() for p in planners)
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in ("cost_delta_hits", "cost_rows_rebuilt",
                     "cost_cols_rebuilt", "objective", "placed",
                     "telem_samples", "telem_iters_to_90"):
            assert getattr(jm, name) == getattr(tm, name), (rnd, name)
        pair.remove_placed(int(rng.integers(0, 6)))
        pair.submit(int(rng.integers(1, 6)), rng, shapes,
                    labels={"app": f"a{rnd % 4}"})
        uuids = list(pair.states[0].machines)
        if rnd == 5:
            pair.relabel(uuids[0], {"zone": "relabeled"})
        if rnd == 8:
            pair.node_stats(uuids[:7], {"cpu_utilization": 0.7,
                                        "mem_utilization": 0.5})
        if rnd == 10:
            for st in pair.states:
                st.node_removed(uuids[0])
            pair.node_added("cd-m-new", 16000, 64 << 20, {"zone": "z9"})
    assert delta_rounds >= 3


def _steady(n_machines, n_tasks, shapes, seed, labeled=True):
    rng = np.random.default_rng(seed)
    pair = Pair(n_machines, labeled=labeled)
    pair.submit(n_tasks, rng, shapes)
    caches = _Caches()
    views = pair.views()
    caches.build(0, views)
    return pair, caches, views


def test_relabel_dirties_only_that_column(delta_env):
    pair, caches, views = _steady(24, 40, [(300, 1 << 19)], 7)
    u = views[1].machines.uuids[3]
    pair.relabel(u, {"zone": "flipped"})
    views2 = pair.views()
    stats = caches.build(0, views2)
    assert stats["path"] == "delta"
    assert list(views2[1].machines.uuids).index(u) in \
        stats["dirty_cols"].tolist()
    assert stats["cols_rebuilt"] <= 2 and stats["rows_rebuilt"] == 0


def test_round_hints_force_hinted_cells_dirty(delta_env):
    """Installed hints union into the next build's dirty sets, unknown
    identities cost nothing, and an empty install clears them."""
    shapes = [(300 + 50 * i, (1 << 19) + (i << 12)) for i in range(8)]
    pair, caches, views = _steady(24, 40, shapes, 11)
    hint_ec = int(views[1].ecs.ec_ids[0])
    hint_uuid = views[1].machines.uuids[5]
    for c in caches.caches:
        c.ingest(ec_ids=[hint_ec])
        c.set_round_hints([hint_ec, 999_999_999],
                          [hint_uuid, "no-such-machine"])
    stats = caches.build(0, views)
    assert stats["path"] == "delta"
    assert caches.caches[0].ingest_hints_applied == \
        caches.caches[1].ingest_hints_applied >= 2
    assert 0 in stats["dirty_rows"].tolist()
    assert 5 in stats["dirty_cols"].tolist()
    for c in caches.caches:
        c.set_round_hints([], [])
    stats = caches.build(0, views)
    assert stats["rows_rebuilt"] == stats["cols_rebuilt"] == 0


def test_dirty_fraction_gate_escalates_to_full(delta_env):
    pair, caches, _ = _steady(20, 30, [(300, 1 << 19)], 11, labeled=False)
    pair.node_stats(list(pair.states[0].machines), {"cpu_utilization": 0.9})
    assert caches.build(0, pair.views())["path"] == "gate"


@pytest.mark.parametrize("path", ["disabled", "small"])
def test_declined_builds_match(monkeypatch, path):
    """The cache's declines (the hatch off, a plane under the gates) are
    full builds with a broken ledger, in both packages."""
    if path == "disabled":
        monkeypatch.setenv("POSEIDON_COST_DELTA", "0")
    pair, caches, views = _steady(20, 30, [(300, 1 << 19)], 3)
    assert caches.caches[1].last_stats["path"] == path
    assert caches.take_ledgers(0).broken
    assert caches.caches[1].enabled() == (path != "disabled")


def test_ledger_accumulates_across_builds(delta_env):
    """Two delta builds between takes: the ledger is the union of their
    dirty sets."""
    pair, caches, _ = _steady(20, 30, [(300, 1 << 19)], 5, labeled=False)
    caches.take_ledgers(0)
    dirty = set()
    for j, util in ((2, 0.8), (7, 0.6)):
        pair.node_stats([list(pair.states[0].machines)[j]],
                        {"cpu_utilization": util})
        views = pair.views()
        stats = caches.build(0, views)
        assert stats["path"] == "delta"
        dirty |= {views[1].machines.uuids[int(c)]
                  for c in stats["dirty_cols"]}
    led = caches.take_ledgers(0)
    assert not led.broken and dirty <= led.cols
    assert caches.take_ledgers(0) is None


def test_full_rebuild_breaks_ledger(delta_env):
    rng = np.random.default_rng(6)
    pair, caches, _ = _steady(16, 20, [(300, 1 << 19)], 6, labeled=False)
    caches.take_ledgers(0)
    for st in pair.states:
        for uid in list(st.tasks):
            st.task_removed(uid)
    pair.submit(20, rng, [(999, 1 << 20)])
    caches.build(0, pair.views())
    assert caches.take_ledgers(0).broken


# --------------------------------------------------------------- pipeline

class _SlowModel:
    """Cost-model stand-in whose build sleeps, so the overlap window is
    deterministic; records the threads its builds ran on."""

    delta_plane = False

    def __init__(self, dt=0.05):
        self.dt = dt
        self.threads = []
        self.fail_next = False

    def build(self, ecs, machines):
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("speculative failure")
        time.sleep(self.dt)
        self.threads.append(threading.current_thread().name)
        from poseidon_tpu_torch.costmodel.base import CostMatrices

        E, M = ecs.num_ecs, machines.num_machines
        return CostMatrices(
            costs=np.zeros((E, M), dtype=np.int32),
            unsched_cost=np.zeros(E, dtype=np.int32),
            capacity=machines.slots_free.astype(np.int32),
            arc_capacity=None,
        )


def _port_tables():
    rng = np.random.default_rng(1)
    st = ClusterState()
    for i in range(12):
        st.node_added(MachineInfo(uuid=generate_uuid(f"cp-m{i}"),
                                  cpu_capacity=32000,
                                  ram_capacity=128 << 20, task_slots=16))
    for i in range(10):
        st.task_submitted(TaskInfo(uid=task_uid("cp-t", i), job_id="cp-j",
                                   cpu_request=300,
                                   ram_request=int(rng.integers(1, 4)) << 19))
    v = st.build_round_view()
    return v.ecs, v.machines


def test_pipeline_overlap_window():
    model = _SlowModel(dt=0.08)
    pipe = CostPipeline(CostPlaneCache(model))
    ecs, mt = _port_tables()
    pipe.speculate(1, ecs, mt)
    t0 = time.perf_counter()
    time.sleep(0.02)  # "solving" while the worker builds
    cm, _ = pipe.build(1, ecs, mt)
    assert pipe.overlap_with(t0, time.perf_counter()) > 0.0
    assert cm.costs.shape == (ecs.num_ecs, mt.num_machines)
    assert model.threads[0].startswith("poseidon-costbuild")
    assert model.threads[1] == threading.current_thread().name


def test_pipeline_authoritative_build_runs_outside_its_lock():
    """The authoritative build joins the speculation under the pipeline's
    lock and builds with it released, so no thread takes the cache's
    locks inside it; the speculative build before it ran to its end."""
    model = _SlowModel(dt=0.02)
    pipe = CostPipeline(CostPlaneCache(model))
    ecs, mt = _port_tables()
    held = []
    build = model.build

    def spy(e, m):
        held.append(pipe._lock.locked())
        return build(e, m)

    model.build = spy
    pipe.speculate(1, ecs, mt)
    pipe.build(1, ecs, mt)
    assert len(model.threads) == 2
    assert held[1] is False
    pipe.drain()


def test_pipeline_speculative_error_swallowed_authoritative_raises():
    model = _SlowModel(dt=0.0)
    pipe = CostPipeline(CostPlaneCache(model))
    ecs, mt = _port_tables()
    model.fail_next = True
    pipe.speculate(1, ecs, mt)
    assert pipe.build(1, ecs, mt)[0] is not None
    model.fail_next = True
    with pytest.raises(RuntimeError):
        pipe.build(1, ecs, mt)
    pipe.drain()


def test_pipeline_build_matches_synchronous(delta_env):
    """A speculative build followed by the authoritative one returns the
    synchronous build's planes; its stats and the band's ledger (the
    union of both builds' dirty sets) are the JAX pipeline's."""
    from poseidon_tpu.graph.pipeline import CostPipeline as JPipeline

    rng = np.random.default_rng(9)
    pair = Pair(30)
    pair.submit(60, rng, [(200, 1 << 19), (700, 1 << 20)])
    caches = _Caches()
    pipes = [JPipeline(caches.caches[0]), CostPipeline(caches.caches[1])]
    for r in range(2):
        if r:
            pair.node_stats(list(pair.states[0].machines)[:3],
                            {"cpu_utilization": 0.4})
        views = pair.views()
        out = []
        for pipe, v in zip(pipes, views):
            pipe.speculate(3, v.ecs, v.machines)
            out.append(pipe.build(3, v.ecs, v.machines))
        (jcm, jstats), (cm, stats) = out
        _same_planes(jcm, cm,
                     caches.models[1].build(views[1].ecs, views[1].machines))
        _same_stats(jstats, stats)
        led = caches.take_ledgers(3)
    # The speculation patched the three dirty columns; the authoritative
    # build found nothing left, and the ledger kept them.
    assert stats["path"] == "delta" and stats["cols_rebuilt"] == 0
    assert not led.broken and len(led.cols) == 3


def _two_band_pair():
    rng = np.random.default_rng(4)
    pair = Pair(30, labeled=False)
    pair.submit(40, rng, [(200, 1 << 19)])
    for g in range(10):
        for i in range(8):
            for st, _, Task in pair.sides:
                st.task_submitted(Task(
                    uid=task_uid(f"cd-band2-{g}", i), job_id=f"cd-b2-{g}",
                    cpu_request=900 + g, ram_request=1 << 20))
    return pair, rng


@pytest.mark.parametrize("overlap_assign", ["1", "0"])
def test_planner_pipeline_on_off_matches_reference(delta_env, monkeypatch,
                                                   overlap_assign):
    """Multi-band churn rounds: the port with the pipeline on places as
    with it off, and as the JAX planner with it on."""
    monkeypatch.setenv("POSEIDON_OVERLAP_ASSIGN", overlap_assign)

    def run(pipeline_on):
        monkeypatch.setenv("POSEIDON_PIPELINE_BANDS",
                           "1" if pipeline_on else "0")
        pair, rng = _two_band_pair()
        planners = [JPlanner(pair.states[0], j_cost_model("cpu_mem")),
                    RoundPlanner(pair.states[1], get_cost_model("cpu_mem"),
                                 device="cpu")]
        out = []
        for _ in range(4):
            (jd, jm), (td, tm) = (p.schedule_round() for p in planners)
            ours = [(d.task_id, d.resource_id, int(d.type)) for d in td]
            assert ours == [(d.task_id, d.resource_id, int(d.type))
                            for d in jd]
            assert tm.cost_delta_hits == jm.cost_delta_hits
            out.append((ours, tm.objective, tm.cost_delta_hits))
            pair.remove_placed(4)
            pair.submit(4, rng, [(200, 1 << 19)])
        return out

    off, on = run(False), run(True)
    assert off == on
    assert sum(h for _, _, h in on) >= 1


def test_second_round_revives_accepted_union(monkeypatch):
    """Two rounds of the same pruned band, the second a delta-served
    build: round 2 revives round 1's accepted union instead of re-running
    the planner, in lockstep with the JAX planner."""
    from poseidon_tpu_torch.ops import transport_pruned as TP

    for k, v in DELTA_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("POSEIDON_PRUNE_MIN_ROWS", "8")
    monkeypatch.setenv("POSEIDON_PRUNE_MIN_COLS", "32")
    calls = []
    real_plan = TP.plan_shortlist

    def counting_plan(*a, **kw):
        calls.append(1)
        return real_plan(*a, **kw)

    monkeypatch.setattr(TP, "plan_shortlist", counting_plan)
    pair = Pair(200, labeled=False)
    shapes = [(100 + 13 * i, 1 << 19) for i in range(24)]
    planners = [JPlanner(pair.states[0], j_cost_model("cpu_mem")),
                RoundPlanner(pair.states[1], get_cost_model("cpu_mem"),
                             device="cpu")]
    metrics, n_calls = [], []
    for r in range(2):
        # One task per shape each round: the same 24 EC rows, few
        # machine columns touched between the rounds.
        for shape in shapes:
            pair.submit(1, np.random.default_rng(0), [shape])
        (jd, jm), (td, tm) = (p.schedule_round() for p in planners)
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in ("pruned_bands", "pruned_width", "cost_delta_hits",
                     "pruned_cert_accepts", "objective", "iterations",
                     "telem_samples", "telem_iters_to_90"):
            assert getattr(jm, name) == getattr(tm, name), (r, name)
        metrics.append(tm)
        n_calls.append(len(calls))
    assert metrics[0].pruned_bands >= 1 and n_calls[0] >= 1
    assert metrics[1].pruned_bands >= 1 and metrics[1].cost_delta_hits >= 1
    assert n_calls[1] == n_calls[0]


def test_revive_declines_on_machine_churn(monkeypatch):
    """More than ~3% of the saved union's machines gone: replan."""
    planner = RoundPlanner.__new__(RoundPlanner)
    planner._shortlist_bands = {5: ([f"u{j}" for j in range(100)], 7)}

    class _E:
        supply = np.full(200, 2, dtype=np.int32)

    monkeypatch.setenv("POSEIDON_PRUNE_MIN_ROWS", "1")
    monkeypatch.setenv("POSEIDON_PRUNE_MIN_COLS", "1")
    col_cap = np.full(500, 8, dtype=np.int32)
    uuids = [f"u{j}" for j in range(500)]
    plan = planner._revive_shortlist(5, _E, col_cap, None, uuids,
                                     fresh_ok=True)
    assert plan is not None and set(range(100)) <= set(plan.sel.tolist())
    uuids2 = [f"u{j}" for j in range(10, 510)]
    assert planner._revive_shortlist(5, _E, col_cap, None, uuids2,
                                     fresh_ok=True) is None
    assert planner._revive_shortlist(5, _E, col_cap, None, uuids,
                                     fresh_ok=False) is None


def test_set_cost_model_resets_the_cache(delta_env):
    """Swapping the cost model drops every plane, certificate and
    shortlist priced by the old one: the next build is a full one, and
    the planner goes on placing as the JAX planner does after the same
    swap."""
    rng = np.random.default_rng(2)
    pair = Pair(24)
    pair.submit(60, rng, [(300, 1 << 19), (900, 1 << 20)])
    planners = [JPlanner(pair.states[0], j_cost_model("cpu_mem")),
                RoundPlanner(pair.states[1], get_cost_model("cpu_mem"),
                             device="cpu")]
    for r in range(2):
        if r:
            planners[0].set_cost_model(j_cost_model("cpu_mem"))
            old = planners[1]._plane_cache
            planners[1].set_cost_model(get_cost_model("cpu_mem"))
            assert planners[1]._plane_cache is not old
            assert not planners[1]._cert_bands
            assert not planners[1]._shortlist_bands
            pair.remove_placed(3)
            pair.submit(3, rng, [(300, 1 << 19)])
        (jd, jm), (td, tm) = (p.schedule_round() for p in planners)
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        assert tm.cost_delta_hits == jm.cost_delta_hits == 0

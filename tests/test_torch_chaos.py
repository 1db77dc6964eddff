"""The port's chaos harness (``chaos/``) against the JAX package's.

- the named fault plans are equal in both packages;
- the planner's chaos seam: ``_solve_host_greedy`` with a
  ``partial_fraction`` gives the reference's solution, and the forced
  degraded tier and the partial round behave as the reference's;
- a tiny soak through both full stacks (the port's server on the CPU)
  gives equal placement digests and deltas, the same fault log and
  every gate passing, the ledger quartet at 0 in warm rounds; the streaming soak
  equals the synchronous one; a soak killed mid-run leaves a flight
  trace that ``replay/flight.py`` re-drives to the same digests;
- the port's keyed queue under the seeded preemption harness keeps the
  invariants ``tests/test_races.py`` holds for the reference's.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from poseidon_tpu.chaos import named_plan as j_named_plan
from poseidon_tpu.chaos.soak import run_soak as j_run_soak
from poseidon_tpu.costmodel import get_cost_model as j_get_cost_model
from poseidon_tpu.graph.instance import RoundPlanner as JRoundPlanner
from poseidon_tpu.graph.state import ClusterState as JClusterState
from poseidon_tpu_torch.chaos import FaultPlan, named_plan
from poseidon_tpu_torch.chaos.preempt import (
    InvariantTracker,
    PreemptPoints,
    race_seeds,
)
from poseidon_tpu_torch.chaos.soak import run_soak
from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.instance import RoundPlanner
from poseidon_tpu_torch.graph.state import (
    ClusterState,
    MachineInfo,
    TaskInfo,
)
from poseidon_tpu_torch.replay import (
    ReplayDriver,
    flight_trace_events,
    load_flight,
    redrive_flight,
)
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rounds", [4, 6, 10])
@pytest.mark.parametrize("name", ["none", "smoke", "all"])
def test_named_plans_equal(name, rounds, seed):
    got = named_plan(name, rounds, seed)
    assert got.to_json() == j_named_plan(name, rounds, seed).to_json()
    assert FaultPlan.from_json(got.to_json()) == got
    if name == "smoke":
        assert got.families_covered() == (
            "binding", "events", "rpc", "solver", "watch")


def _instance(seed, gang):
    rng = np.random.default_rng(seed)
    E, M = 6, 9
    costs = rng.integers(0, 2000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.2] = 1 << 28
    ecs_b = SimpleNamespace(
        supply=rng.integers(1, 7, size=E).astype(np.int32),
        is_gang=(np.arange(E) % 3 == 0) if gang else None,
    )
    cm = SimpleNamespace(
        costs=costs,
        arc_capacity=rng.integers(1, 4, size=(E, M)).astype(np.int32),
        unsched_cost=rng.integers(1000, 5000, size=E).astype(np.int32),
    )
    col_cap = rng.integers(0, 5, size=M).astype(np.int32)
    return ecs_b, cm, col_cap


@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("frac", [None, 0.0, 0.3, 0.55, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_greedy_partial_fraction_matches_the_reference(seed, frac,
                                                             gang):
    ecs_b, cm, col_cap = _instance(seed, gang)
    got = RoundPlanner(ClusterState(), get_cost_model("cpu_mem"),
                       device="cpu")._solve_host_greedy(
        ecs_b, cm, col_cap, frac)
    ref = JRoundPlanner(JClusterState(), j_get_cost_model("cpu_mem"))
    ref = ref._solve_host_greedy(ecs_b, cm, col_cap, frac)
    for f in ("flows", "unsched", "prices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert (got.objective, got.gap_bound, got.iterations) == (
        ref.objective, ref.gap_bound, ref.iterations)
    if frac is not None:
        assert int(got.flows.sum()) <= int(ecs_b.supply.sum()) * frac


class _SolverChaos:
    def __init__(self, forced=False, frac=None):
        self.forced, self.frac = forced, frac

    def solver_fault(self):
        return self.forced, self.frac


def _tiny_state(S, M, T, tasks=6):
    state = S()
    for i in range(4):
        state.node_added(M(
            uuid=generate_uuid(f"deg-m{i}"), cpu_capacity=32000,
            ram_capacity=128 << 20, task_slots=16))
    for i in range(tasks):
        state.task_submitted(T(
            uid=task_uid("deg", i), job_id="deg-j",
            cpu_request=400, ram_request=1 << 19))
    return state


def _degraded_rounds(P, S, M, T, gcm, **kw):
    """The reference's degraded-tier script: a forced-uncertified round,
    a clean round after one more task, then a partial round and its
    recovery on a fresh planner."""
    out = []
    state = _tiny_state(S, M, T)
    planner = P(state, gcm("cpu_mem"), **kw)
    planner.chaos = _SolverChaos(forced=True)
    for chaos in (_SolverChaos(forced=True), _SolverChaos()):
        planner.chaos = chaos
        deltas, m = planner.schedule_round()
        out.append(([(d.task_id, d.resource_id, int(d.type))
                     for d in deltas],
                    m.solve_tier, m.converged, m.placed, m.unscheduled))
        state.task_submitted(T(uid=task_uid("deg", 99), job_id="deg-j",
                               cpu_request=400, ram_request=1 << 19))
    state = _tiny_state(S, M, T, tasks=8)
    planner = P(state, gcm("cpu_mem"), **kw)
    for chaos in (_SolverChaos(frac=0.5), None):
        planner.chaos = chaos
        deltas, m = planner.schedule_round()
        out.append(([(d.task_id, d.resource_id, int(d.type))
                     for d in deltas],
                    m.solve_tier, m.converged, m.placed, m.unscheduled))
    return out


def test_degraded_tier_rounds_match_the_reference():
    from poseidon_tpu.graph.state import MachineInfo as JM
    from poseidon_tpu.graph.state import TaskInfo as JT

    got = _degraded_rounds(RoundPlanner, ClusterState, MachineInfo, TaskInfo,
                           get_cost_model, device="cpu")
    ref = _degraded_rounds(JRoundPlanner, JClusterState, JM, JT,
                           j_get_cost_model)
    assert got == ref
    (_, tier0, conv0, placed0, _), (_, tier1, conv1, _, _) = got[:2]
    assert (tier0, conv0, placed0) == ("host_greedy", False, 6)
    assert tier1 in ("pruned", "dense") and conv1
    assert got[2][1:] == ("host_greedy", False, 4, 4)
    assert got[3][2:] == (True, 4, 0)


SOAK_KEYS = ("ok", "digests", "tiers", "families_covered",
             "rounds_run", "divergent_rounds", "warm_fresh_compiles",
             "warm_implicit_transfers", "warm_numeric_anomalies",
             "warm_lock_order_edges", "cost_delta_hits", "loop_stats")


def _fault_log(result):
    """The faults that fired, but for the node watch's: a node-watch
    fault fires only if the node watcher happens to poll within its
    round (no node event is due then), so whether it fires is a matter of
    timing in either package, and so is the resync it causes."""
    return [e for e in result["fired"] if not e["kind"].endswith("_nodes")]


def _soak(run, **kw):
    """A soak's result and each round's enacted deltas, read from the
    glue before the next round's workload (``on_round``) and after the
    last round."""
    deltas, live = [], {}

    def on_round(r, ctx):
        live.update(ctx)
        if r > 0:
            deltas.append(_delta_rows(ctx["poseidon"].last_deltas))

    out = run(machines=12, rounds=6, plan="smoke", seed=0,
              on_round=on_round, **kw)
    deltas.append(_delta_rows(live["poseidon"].last_deltas))
    return out, deltas


def _delta_rows(deltas):
    return [(int(d.type), int(d.task_id), d.resource_id) for d in deltas]


def test_tiny_soak_matches_the_reference(tmp_path):
    """The reference's test_tiny_soak_all_families through both stacks:
    every family fires, no divergence, the ledger quartet at 0 in warm
    rounds, everything placed — and the same digests, deltas and fault
    log."""
    got, got_deltas = _soak(run_soak, out_dir=str(tmp_path), device="cpu")
    ref, ref_deltas = _soak(j_run_soak, out_dir=str(tmp_path))
    assert got["ok"], got.get("failure")
    assert got_deltas == ref_deltas and any(got_deltas)
    assert got["device"] == "cpu"
    assert {k: got[k] for k in SOAK_KEYS} == {k: ref[k] for k in SOAK_KEYS}
    assert _fault_log(got) == _fault_log(ref)
    fired = {e["kind"] for e in got["fired"]}
    families = {f.family for f in named_plan("smoke", 6, 0).faults
                if f.kind in fired}
    assert families == {"watch", "events", "rpc", "binding", "solver"}
    assert "host_greedy" in got["tiers"]
    assert got["warm_fresh_compiles"] == got["warm_implicit_transfers"] == 0


def test_streaming_soak_matches_synchronous(tmp_path, monkeypatch):
    monkeypatch.delenv("POSEIDON_STREAMING", raising=False)
    sync = run_soak(machines=12, rounds=6, plan="smoke", seed=0,
                    out_dir=str(tmp_path), device="cpu")
    monkeypatch.setenv("POSEIDON_STREAMING", "1")
    stream = run_soak(machines=12, rounds=6, plan="smoke", seed=0,
                      out_dir=str(tmp_path), device="cpu")
    assert sync["ok"] and stream["ok"], (sync.get("failure"),
                                         stream.get("failure"))
    assert stream["digests"] == sync["digests"]
    assert stream["warm_fresh_compiles"] == 0


def test_killed_soak_redrives_to_the_same_digests(tmp_path):
    """The reference's flight-recorder kill test on the port: the killed
    stub stops the loop fatally, the trace is written, and the re-drive
    lands on the failing round with the recorded digests."""
    kill_round = 3

    def kill(r, ctx):
        if r == kill_round:
            ctx["server"].stop(grace=0.1)

    out = run_soak(machines=12, rounds=6, plan="smoke", seed=1,
                   out_dir=str(tmp_path), on_round=kill, device="cpu")
    assert not out["ok"] and out["failure"]["kind"] == "fatal"
    assert out["failing_round"] == kill_round
    trace = load_flight(out["trace_path"])
    assert len(trace.rounds) == kill_round
    assert all(r["metrics"]["schema"] == 1 for r in trace.rounds)
    assert trace.rounds[0]["spans"], "the round's spans were not recorded"
    report = ReplayDriver(flight_trace_events(out["trace_path"]),
                          precompile=False, device="cpu").run(max_rounds=2)
    assert report.placed > 0
    redriven = redrive_flight(out["trace_path"], device="cpu")
    assert redriven["reproduced"], redriven.get("digest_mismatches")
    assert redriven["rounds_run"] == kill_round


@pytest.mark.parametrize("seed", list(race_seeds()))
def test_keyed_queue_under_preemption(seed):
    """The reference's KeyedQueue storm (tests/test_races.py) on the
    port's queue through the port's seeded harness: the tracked Condition
    makes every queue operation a preemption point."""
    from poseidon_tpu_torch.glue.keyed_queue import KeyedQueue

    q = KeyedQueue()
    tracker = InvariantTracker()
    done = []

    def producer():
        for i in range(40):
            for k in range(4):
                q.add(f"k{k}", i)

    def worker(name):
        while True:
            batch = q.get()
            if batch is None:
                return
            key, items = batch
            tracker.enter(key, name)
            tracker.exit(key, name)
            done.extend(items)
            q.done(key)

    with PreemptPoints(seed=seed) as pp:
        threads = [threading.Thread(target=producer)] + [
            threading.Thread(target=worker, args=(f"w{i}",))
            for i in range(4)
        ]
        for t in threads:
            t.start()
        threads[0].join(timeout=60)
        assert not threads[0].is_alive()
        deadline = threading.Event()
        for _ in range(30_000):
            if len(q) == 0:
                break
            deadline.wait(0.001)
        q.shut_down()
        for t in threads[1:]:
            t.join(timeout=60)
            assert not t.is_alive()
    assert tracker.violations == []
    assert len(done) == 160
    assert pp.decisions > 0


def test_preempt_points_refuse_nesting():
    with PreemptPoints(seed=0):
        with pytest.raises(RuntimeError, match="already installed"):
            PreemptPoints(seed=1).__enter__()
    from poseidon_tpu_torch.utils import locks

    assert locks._preempt_hook is None

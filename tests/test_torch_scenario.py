"""The port's scenario harness (``scenario/``) against the JAX package's.

- the five named plans, and their lowering to replay events, are equal
  in both packages;
- ``drive_scenario`` (8 machines, 6 rounds plus the settle rounds)
  through both full stacks (the port's server on the CPU) gives equal
  placement and delta digests, and the port's streaming drive equals its
  synchronous one;
- ``PerturbedCostModel`` prices every cell as the reference's does, and
  ``score_scenario`` gives the reference's numbers;
- a scenario killed mid-drive leaves a flight trace that
  ``replay/flight.py`` re-drives to the same digests;
- with the card's merged bands, a warm round's first delta build through
  the cost pipeline takes no new lock ordering in the port (the
  reference's does: a reference gap, ROADMAP §C).
"""

import numpy as np
import pytest

from poseidon_tpu.costmodel import get_cost_model as j_get_cost_model
from poseidon_tpu.graph.state import ClusterState as JClusterState
from poseidon_tpu.graph.state import MachineInfo as JMachineInfo
from poseidon_tpu.graph.state import TaskInfo as JTaskInfo
from poseidon_tpu.scenario import PerturbedCostModel as JPerturbed
from poseidon_tpu.scenario import drive_scenario as j_drive
from poseidon_tpu.scenario import named_scenario as j_named
from poseidon_tpu.scenario import score_scenario as j_score
from poseidon_tpu.scenario import workload_events as j_workload_events
from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo
from poseidon_tpu_torch.replay import (
    ReplayDriver,
    flight_trace_events,
    load_flight,
    redrive_flight,
)
from poseidon_tpu_torch.scenario import (
    SCENARIOS,
    PerturbedCostModel,
    ScenarioPlan,
    drive_scenario,
    named_scenario,
    score_scenario,
    workload_events,
)
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

MACHINES, ROUNDS, SEED = 8, 6, 0


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", SCENARIOS)
def test_plans_equal(name, seed):
    got = named_scenario(name, machines=MACHINES, rounds=ROUNDS, seed=seed)
    ref = j_named(name, machines=MACHINES, rounds=ROUNDS, seed=seed)
    assert got.to_json() == ref.to_json()
    assert got.digest() == ref.digest()
    assert ScenarioPlan.from_json(got.to_json()) == got
    assert got.max_window_ec_keys() == ref.max_window_ec_keys()
    events = [(e.time, e.kind, e.payload) for e in workload_events(got)]
    assert events == [(e.time, e.kind, e.payload)
                      for e in j_workload_events(ref)]


DRIVE_KEYS = ("ok", "digests", "delta_digests", "scenario_digest",
              "objective", "objectives", "tiers", "rounds_run",
              "warm_fresh_compiles", "warm_implicit_transfers",
              "warm_numeric_anomalies", "warm_lock_order_edges",
              "divergent_rounds")


@pytest.mark.parametrize("name", SCENARIOS)
def test_drive_matches_the_reference_in_both_loop_modes(name, tmp_path):
    plan = named_scenario(name, machines=MACHINES, rounds=ROUNDS, seed=SEED)
    got = drive_scenario(plan, out_dir=str(tmp_path), device="cpu")
    ref = j_drive(j_named(name, machines=MACHINES, rounds=ROUNDS, seed=SEED),
                  out_dir=str(tmp_path))
    assert got["ok"], got.get("failure")
    assert got["device"] == "cpu"
    assert {k: got[k] for k in DRIVE_KEYS} == {k: ref[k] for k in DRIVE_KEYS}
    stream = drive_scenario(plan, streaming=True, out_dir=str(tmp_path),
                            device="cpu")
    assert stream["ok"], stream.get("failure")
    assert stream["mode"] == "streaming"
    assert (stream["digests"], stream["delta_digests"]) == (
        got["digests"], got["delta_digests"])


def _view(S, M, T, machines=12, tasks=40):
    st = S()
    for i in range(machines):
        st.node_added(M(uuid=generate_uuid(f"pert-m{i}"),
                        cpu_capacity=16000 * (1 + i % 3),
                        ram_capacity=(32 << 20) * (1 + i % 2),
                        task_slots=16))
    for i in range(tasks):
        st.task_submitted(T(uid=task_uid(f"pert-j{i % 5}", i),
                            job_id=f"pert-j{i % 5}",
                            cpu_request=(200, 400, 800, 1600)[i % 4],
                            ram_request=(1 << 19, 1 << 20)[i % 2]))
    view = st.build_round_view()
    return view.ecs, view.machines


@pytest.mark.parametrize("amplitude", [0.15, 0.6])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_perturbed_cost_model_prices_like_the_reference(seed, amplitude):
    ecs, mt = _view(ClusterState, MachineInfo, TaskInfo)
    jecs, jmt = _view(JClusterState, JMachineInfo, JTaskInfo)
    got = PerturbedCostModel(get_cost_model("cpu_mem"), seed=seed,
                             amplitude=amplitude)
    ref = JPerturbed(j_get_cost_model("cpu_mem"), seed=seed,
                     amplitude=amplitude)
    assert got.name == ref.name and not got.delta_plane
    a, b = got.build(ecs, mt), ref.build(jecs, jmt)
    for f in ("costs", "unsched_cost", "capacity", "arc_capacity"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    plain = get_cost_model("cpu_mem").build(ecs, mt)
    moved = (a.costs != plain.costs) & (plain.costs < (1 << 28))
    assert moved.any()
    assert (a.costs[plain.costs >= (1 << 28)] >= (1 << 28)).all()


SCORE_KEYS = ("ok", "objective_base", "objectives", "regressions",
              "regression_p50", "regression_p90", "regression_max",
              "placement_divergence", "robustness_score", "perturb_seeds",
              "amplitude")


def test_score_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("POSEIDON_SCENARIO_OUT", str(tmp_path))
    plan = named_scenario("flash_crowd", machines=MACHINES, rounds=ROUNDS,
                          seed=SEED)
    got = score_scenario(plan, device="cpu")
    ref = j_score(j_named("flash_crowd", machines=MACHINES, rounds=ROUNDS,
                          seed=SEED))
    assert {k: got[k] for k in SCORE_KEYS} == {k: ref[k] for k in SCORE_KEYS}
    assert got["gates_ok"] and got["robustness_score"] > 0
    assert len(got["regressions"]) == 3


def test_killed_scenario_redrives_to_the_same_digests(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("POSEIDON_SCENARIO_OUT", str(tmp_path / "redrive"))
    kill_round = 3

    def kill(r, ctx):
        if r == kill_round:
            ctx["server"].stop(grace=0.1)

    plan = named_scenario("diurnal", machines=MACHINES, rounds=ROUNDS,
                          seed=SEED)
    out = drive_scenario(plan, out_dir=str(tmp_path), on_round=kill,
                         device="cpu")
    assert not out["ok"] and out["failure"]["kind"] == "fatal"
    assert out["failing_round"] == kill_round
    trace = load_flight(out["trace_path"])
    assert len(trace.rounds) == kill_round
    assert trace.spec["kind"] == "scenario"
    assert trace.spec["plan"] == plan.to_dict()
    report = ReplayDriver(flight_trace_events(out["trace_path"]),
                          precompile=False, device="cpu").run(max_rounds=2)
    assert report.placed > 0
    redriven = redrive_flight(out["trace_path"], device="cpu")
    assert redriven["reproduced"], redriven.get("digest_mismatches")
    assert redriven["rounds_run"] == kill_round
    assert redriven["digests"] == out["digests"]


def test_warm_pipelined_delta_build_takes_no_new_lock_order(tmp_path,
                                                            monkeypatch):
    """The card's merged bands with the delta planes' gates shrunk: the
    first delta build through the cross-band pipeline comes in a warm
    round.  The reference builds under the pipeline's lock there, so its
    warm-round lock-order gate fails (a reference gap); the port builds
    after releasing that lock, takes no new ordering, and places alike."""
    from poseidon_tpu.utils import locks as jlocks
    from poseidon_tpu_torch.utils import locks as tlocks

    for k, v in (("POSEIDON_MERGE_BANDS", "1"),
                 ("POSEIDON_COST_DELTA_MIN_CELLS", "1"),
                 ("POSEIDON_COST_DELTA_MIN_ROWS", "1")):
        monkeypatch.setenv(k, v)
    jlocks._reset_edges_for_tests()
    tlocks._reset_edges_for_tests()
    plan = named_scenario("multi_tenant", machines=16, rounds=ROUNDS,
                          seed=SEED)
    got = drive_scenario(plan, out_dir=str(tmp_path), device="cpu")
    ref = j_drive(j_named("multi_tenant", machines=16, rounds=ROUNDS,
                          seed=SEED), out_dir=str(tmp_path))
    assert got["ok"], got.get("failure")
    assert got["warm_lock_order_edges"] == []
    assert ref["failure"]["kind"] == "lock-order-edges"
    assert ref["warm_lock_order_edges"] == [
        e for e in ref["warm_lock_order_edges"]
        if e.startswith("graph.CostPipeline._lock -> "
                        "costmodel.CostPlaneCache._ingest_lock")]
    assert (got["digests"], got["delta_digests"]) == (
        ref["digests"], ref["delta_digests"])

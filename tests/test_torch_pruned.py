"""The port's pruned-plane path (``ops/transport_pruned.py``) against the
JAX package's, exactly.

Same seeded numpy planes into both packages: the shortlist planner's
selection and ``k`` (and its gate declines), the price-out violations,
the excluded-column certificate's verdicts, and ``solve_pruned``'s result
field for field with each package's own plain solve in its ``solve_on``
closure (the JAX side on its lax path, the port's on the CPU) — the
clean accept, a price-out round that adds columns, and budget exhaustion
escalating.  Then the planner: the port with tiny prune gates against the
port's dense path (same placements and objective) and against the JAX
planner with the same gates (same deltas and tier counts).
"""

import numpy as np
import pytest

from poseidon_tpu.ops import transport as J
from poseidon_tpu.ops import transport_pruned as JP
from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.ops import transport_pruned as TP

SOL_FIELDS = ("objective", "gap_bound", "iterations", "bf_sweeps",
              "eps_certified", "entry_phase")
STAT_FIELDS = ("width", "rounds", "escalated", "declined", "iterations",
               "bf_sweeps", "cert")
TIER_FIELDS = ("placed", "unscheduled", "preempted", "migrated",
               "objective", "iterations", "bf_sweeps", "gap_bound",
               "device_calls", "repair_firings", "pruned_bands",
               "pruned_width", "pruned_price_out_rounds",
               "pruned_escalations", "pruned_cert_accepts",
               "cost_delta_hits", "cost_rows_rebuilt", "cost_cols_rebuilt",
               "solve_tier", "ladder_entry_phase", "telem_samples",
               "telem_gu_firings", "telem_decay_half_life",
               "telem_iters_to_90")


@pytest.fixture(autouse=True)
def lax_path(monkeypatch):
    monkeypatch.setenv("POSEIDON_FUSED", "0")
    monkeypatch.setenv("POSEIDON_TILED", "0")


def _fuzz_instance(seed):
    """The JAX package's own fuzz recipe (tests/test_transport_pruned.py):
    slack-rich, so the shortlist fires and certificates usually accept."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(4, 11))
    M = int(rng.integers(192, 320))
    costs = rng.integers(1, 400, size=(E, M)).astype(np.int32)
    density = float(rng.choice([1.0, 0.9, 0.7]))
    if density < 1.0:
        knock = rng.random((E, M)) > density
        costs = np.where(knock, J.INF_COST, costs).astype(np.int32)
    supply = rng.integers(1, 9, size=E).astype(np.int32)
    capacity = rng.integers(1, 5, size=M).astype(np.int32)
    while int(capacity.sum()) < 6 * int(supply.sum()):
        capacity = (capacity * 2).astype(np.int32)
    arc = None
    if rng.random() < 0.5:
        arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    unsched = np.full(E, 600, dtype=np.int32)
    return costs, supply, capacity, unsched, arc


def _escalation_instance():
    """Every shortlisted column is arc-blocked, so the reduced optimum
    strands supply while cheaper open columns sit outside the union."""
    E, M = 4, 128
    costs = np.broadcast_to(np.arange(M, dtype=np.int32), (E, M)).copy()
    supply = np.full(E, 8, dtype=np.int32)
    capacity = np.full(M, 2, dtype=np.int32)
    unsched = np.full(E, 500, dtype=np.int32)
    arc = np.full((E, M), 8, dtype=np.int32)
    arc[:, :64] = 0
    return costs, supply, capacity, unsched, arc


def _same_plan(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a.sel, b.sel)
        assert a.k == b.k


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("must", [False, True])
def test_plan_shortlist_matches(seed, must):
    costs, supply, capacity, _, arc = _fuzz_instance(seed)
    mask = None
    if must:
        mask = np.zeros(costs.shape[1], dtype=bool)
        mask[np.random.default_rng(seed).choice(costs.shape[1], 5)] = True
    kw = dict(must_include=mask, min_rows=2, min_cols=16, dense_factor=100)
    a = JP.plan_shortlist(costs, supply, capacity, arc, **kw)
    b = TP.plan_shortlist(costs, supply, capacity, arc, **kw)
    _same_plan(a, b)
    assert b is not None
    if must:
        assert mask[b.sel].sum() == mask.sum()


def _decline_cases():
    rng = np.random.default_rng(0)
    costs = rng.integers(1, 100, size=(8, 256)).astype(np.int32)
    supply = np.full(8, 4, dtype=np.int32)
    capacity = np.full(256, 2, dtype=np.int32)
    sparse = np.full((8, 256), J.INF_COST, dtype=np.int32)
    sparse[:, :4] = 1
    small = dict(min_rows=2, min_cols=16)
    return {
        "default_gates": (costs, supply, capacity, {}),
        "slack": (costs, np.full(8, 256, dtype=np.int32), capacity, small),
        "density": (sparse, supply, capacity, small),
        "fires": (costs, supply, capacity, small),
    }


@pytest.mark.parametrize("case", ["default_gates", "slack", "density",
                                  "fires"])
def test_plan_shortlist_gates_match(case):
    costs, supply, capacity, kw = _decline_cases()[case]
    a = JP.plan_shortlist(costs, supply, capacity, **kw)
    b = TP.plan_shortlist(costs, supply, capacity, **kw)
    _same_plan(a, b)
    assert (b is not None) == (case == "fires")


@pytest.mark.parametrize("wave", ["1", "0"])
@pytest.mark.parametrize("shape", [(8, 8192), (16, 8192), (16, 8191),
                                   (192, 4096), (40, 100)])
def test_row_gate_matches(monkeypatch, wave, shape):
    monkeypatch.setenv("POSEIDON_PRUNE_WAVE", wave)
    assert JP.row_gate_ok(*shape, 192) == TP.row_gate_ok(*shape, 192)


def _lifted(seed, width):
    """A reduced solve's lifted full-plane prices on a fuzz plane."""
    costs, supply, capacity, unsched, arc = _fuzz_instance(seed)
    E, M = costs.shape
    scale, _ = T.derive_scale(costs, unsched, None, *T.padded_shape(E, M))
    sel = np.arange(width)
    sol = T.solve_transport(
        costs[:, sel], supply, capacity[sel], unsched,
        arc_capacity=None if arc is None else arc[:, sel], scale=scale,
        device="cpu")
    prices = TP.lift_prices(sel, sol.prices, costs=costs, capacity=capacity,
                            scale=scale)
    ref = JP.lift_prices(sel, sol.prices, costs=costs, capacity=capacity,
                         scale=scale)
    np.testing.assert_array_equal(prices, ref)
    mask = np.zeros(M, dtype=bool)
    mask[sel] = True
    return prices, costs, supply, capacity, arc, scale, mask


@pytest.mark.parametrize("seed,width", [(0, 8), (1, 16), (2, 4), (3, 32)])
def test_price_out_violations_match(seed, width):
    prices, costs, supply, capacity, arc, scale, mask = _lifted(seed, width)
    kw = dict(costs=costs, supply=supply, capacity=capacity,
              arc_capacity=arc, scale=scale, mask=mask, top_j=8)
    a_cols, a_worst = JP.price_out_violations(prices, **kw)
    b_cols, b_worst = TP.price_out_violations(prices, **kw)
    np.testing.assert_array_equal(a_cols, b_cols)
    assert a_worst == b_worst


def _run_pruned(mod, solve, costs, supply, capacity, unsched, arc,
                plan_kw=None, device_kw=None, **driver_kw):
    """``solve_pruned`` with a plain solve closure of the package under
    test, at the full plane's pinned scale."""
    E, M = costs.shape
    scale, _ = mod.derive_scale(costs, unsched, None,
                                *mod.padded_shape(E, M))

    def solve_on(sel, warm):
        p = f = u = eps = None
        if warm is not None and warm[0] is not None:
            p, f, u, eps = warm
        sol = solve(
            costs[:, sel], supply, capacity[sel], unsched, p,
            arc_capacity=arc[:, sel] if arc is not None else None,
            init_flows=f, init_unsched=u, eps_start=eps, scale=scale,
            **(device_kw or {}))
        return sol, costs[:, sel]

    kw = dict(min_rows=2, min_cols=16)
    kw.update(plan_kw or {})
    return mod.solve_pruned(
        costs, supply, capacity, unsched, arc_capacity=arc, scale=scale,
        solve_on=solve_on, plan_kw=kw, **driver_kw)


def _both_pruned(inst, **kw):
    a = _run_pruned(JP, J.solve_transport, *inst, **kw)
    b = _run_pruned(TP, T.solve_transport, *inst,
                    device_kw={"device": "cpu"}, **kw)
    (sa, ea, sta), (sb, eb, stb) = a, b
    assert (sa is None) == (sb is None)
    for name in STAT_FIELDS:
        assert sta[name] == stb[name], name
    for name in ("sel",):
        if sta[name] is None:
            assert stb[name] is None
        else:
            np.testing.assert_array_equal(sta[name], stb[name])
    assert (sta["carry"] is None) == (stb["carry"] is None)
    if sta["carry"] is not None:
        for x, y in zip(sta["carry"], stb["carry"]):
            np.testing.assert_array_equal(x, y)
    if sa is not None:
        np.testing.assert_array_equal(sa.flows, sb.flows)
        np.testing.assert_array_equal(sa.unsched, sb.unsched)
        np.testing.assert_array_equal(sa.prices, sb.prices)
        np.testing.assert_array_equal(ea, eb)
        for name in SOL_FIELDS:
            assert getattr(sa, name) == getattr(sb, name), name
        assert tuple(map(int, sa.phase_iters)) == \
            tuple(map(int, sb.phase_iters))
        assert (sa.telemetry is None) == (sb.telemetry is None)
        if sa.telemetry is not None:
            assert sa.telemetry.digest() == sb.telemetry.digest()
    return sb, eb, stb


@pytest.mark.parametrize("seed", range(6))
def test_solve_pruned_fuzz_matches(seed):
    inst = _fuzz_instance(seed)
    sol, _, stats = _both_pruned(inst, plan_kw=dict(dense_factor=100))
    assert sol is not None or stats["escalated"] or stats["declined"]
    if sol is not None:
        assert sol.gap_bound == 0.0 and stats["sel"] is not None


def test_solve_pruned_price_out_round_matches():
    sol, _, stats = _both_pruned(_escalation_instance())
    assert sol is not None and stats["rounds"] >= 1
    assert not sol.flows[:, :64].any() and sol.unsched.sum() == 0


def test_solve_pruned_budget_exhaustion_matches():
    sol, eff, stats = _both_pruned(_escalation_instance(), max_rounds=0)
    assert sol is None and eff is None and stats["escalated"]
    assert stats["carry"] is not None


def _cert_pair(E=12, M=40, scale=64, seed=0):
    """The same excluded-column certificate, refreshed on a hand-built
    plane, in both packages."""
    from poseidon_tpu.costmodel.delta import PlaneLedger as JLedger
    from poseidon_tpu_torch.costmodel.delta import PlaneLedger as TLedger

    rng = np.random.default_rng(seed)
    costs = rng.integers(10, 400, size=(E, M)).astype(np.int32)
    pe = rng.integers(-2000, 2000, size=E).astype(np.int64)
    ec_ids = np.arange(E, dtype=np.uint64)
    uuids = [f"u{j}" for j in range(M)]
    certs = []
    for mod, Ledger in ((JP, JLedger), (TP, TLedger)):
        cert = mod.ExcludedColumnCert()
        led = Ledger()
        led.present = set(range(E))
        cert.note_build(ec_ids, uuids, led)
        min_e = (costs.astype(np.int64) * scale + pe[:, None]).min(axis=0)
        cert.refresh(scale=scale, pe=pe, min_e=min_e)
        certs.append((cert, Ledger))
    return certs, costs, pe, ec_ids, uuids, scale


def _same_check(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scenario", ["unchanged", "dirty_drop",
                                      "unreported", "heavy_drift"])
def test_excluded_column_cert_matches(scenario):
    E, M = (32, 64) if scenario == "heavy_drift" else (12, 40)
    certs, costs, pe, ec_ids, uuids, scale = _cert_pair(
        E, M, seed=2 if scenario == "heavy_drift" else 0)
    supply = np.full(E, 2, dtype=np.int32)
    capacity = np.full(M, 4, dtype=np.int32)
    mask = np.zeros(M, dtype=bool)
    mask[:16 if scenario == "heavy_drift" else 8] = True
    base = costs.astype(np.int64) * scale + pe[:, None]
    eff, pe_now = costs, pe
    pt = int(base.min()) - 10
    out = []
    for cert, Ledger in certs:
        if scenario == "dirty_drop":
            pt = int(base[:, mask].min())
            eff = costs.copy()
            eff[:, 20] = 0
            led = Ledger()
            led.present = set(int(e) for e in ec_ids.tolist())
            led.cols = {uuids[20]}
            cert.note_build(ec_ids, uuids, led)
            assert cert.begin_attempt(eff, scale)
        elif scenario == "unreported":
            cert.note_build(ec_ids, uuids, None)
            assert not cert.begin_attempt(costs, scale)
        elif scenario == "heavy_drift":
            pe_now = pe.copy()
            pe_now[:3] -= 500_000
            eff = costs.copy()
            eff[:3] = J.INF_COST
        out.append(cert.check(
            eff_costs=eff, pe=pe_now, pt=pt, supply=supply,
            capacity=capacity, arc_capacity=None, scale=scale, mask=mask))
    _same_check(*out)
    want = {"unchanged": "certified", "unreported": "inconclusive",
            "heavy_drift": "certified", "dirty_drop": "violations"}
    assert out[1][0] == want[scenario]


# ---------------------------------------------------------------- planner

def _gang_mix(State, Machine, Task, task_uid, generate_uuid):
    """The JAX package's pruned-vs-dense planner cluster: 128 machines,
    six 8-task gangs and 20 single tasks."""
    st = State()
    for i in range(128):
        st.node_added(Machine(
            uuid=generate_uuid(f"pp{i}"), cpu_capacity=32000,
            ram_capacity=128 << 20, task_slots=4))
    for g in range(6):
        for i in range(8):
            st.task_submitted(Task(
                uid=task_uid(f"ppg{g}", i), job_id=f"ppg-{g}",
                cpu_request=1000 + 100 * g, ram_request=1 << 20,
                gang=True))
    for i in range(20):
        st.task_submitted(Task(
            uid=task_uid("pps", i), job_id=f"pps-{i % 4}",
            cpu_request=1200, ram_request=1 << 20))
    return st


def _port_round(pruned: bool, monkeypatch):
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import (
        ClusterState,
        MachineInfo,
        TaskInfo,
    )
    from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

    monkeypatch.setenv("POSEIDON_PRUNED", "1" if pruned else "0")
    st = _gang_mix(ClusterState, MachineInfo, TaskInfo, task_uid,
                   generate_uuid)
    planner = RoundPlanner(st, get_cost_model("cpu_mem"), device="cpu")
    deltas, m = planner.schedule_round()
    return st, deltas, m


@pytest.fixture()
def tiny_gates(monkeypatch):
    monkeypatch.setenv("POSEIDON_PRUNE_MIN_ROWS", "2")
    monkeypatch.setenv("POSEIDON_PRUNE_MIN_COLS", "32")


def test_planner_pruned_matches_dense(tiny_gates, monkeypatch):
    """The port's planner with the pruned path on (tiny gates) against
    its dense path: the same objective, counts and per-gang outcomes, and
    the same placement of every task."""
    from poseidon_tpu_torch.utils.ids import task_uid

    st_d, _, m_dense = _port_round(False, monkeypatch)
    st_p, _, m_pruned = _port_round(True, monkeypatch)
    assert m_pruned.pruned_bands >= 1 and m_dense.pruned_bands == 0
    assert m_pruned.solve_tier == "pruned"
    for name in ("objective", "placed", "unscheduled"):
        assert getattr(m_pruned, name) == getattr(m_dense, name), name
    assert m_pruned.gap_bound == m_dense.gap_bound == 0.0
    placements = {u: t.scheduled_to for u, t in st_p.tasks.items()}
    assert placements == {u: t.scheduled_to for u, t in st_d.tasks.items()}
    for g in range(6):
        placed = sum(placements[task_uid(f"ppg{g}", i)] is not None
                     for i in range(8))
        assert placed in (0, 8)


def test_planner_pruned_matches_reference(tiny_gates, monkeypatch):
    """The port's pruned planner against the JAX package's with the same
    gates: identical deltas, and equal counts including every tier
    field; then one churn round through the warm pruned path."""
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask
    from poseidon_tpu.utils.ids import generate_uuid, task_uid
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import (
        ClusterState,
        MachineInfo,
        TaskInfo,
    )

    js = _gang_mix(JState, JMachine, JTask, task_uid, generate_uuid)
    ts = _gang_mix(ClusterState, MachineInfo, TaskInfo, task_uid,
                   generate_uuid)
    jp = JPlanner(js, j_cost_model("cpu_mem"))
    tp = RoundPlanner(ts, get_cost_model("cpu_mem"), device="cpu")
    pruned = 0
    for r in range(2):
        if r:
            for state, Task in ((js, JTask), (ts, TaskInfo)):
                for i in range(0, 20, 4):
                    state.task_removed(task_uid("pps", i))
                    state.task_submitted(Task(
                        uid=task_uid("pps", i), job_id=f"pps-{i % 4}",
                        cpu_request=1200, ram_request=1 << 20))
        jd, jm = jp.schedule_round()
        td, tm = tp.schedule_round()
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in TIER_FIELDS:
            assert getattr(jm, name) == getattr(tm, name), (r, name)
        pruned += tm.pruned_bands
    assert pruned >= 1

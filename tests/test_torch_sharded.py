"""The port's mesh-sharded solve and sharded band tier against the JAX
package's, exactly.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's side on a mesh of 8 logical shards of the CPU
(``transport_sharded.visible_devices`` monkeypatched to return the CPU
eight times, or a ``SolverMesh`` built from that list).  Same seeded
numpy inputs into both: ``solve_transport_sharded`` field for field,
contiguous and strided, on the reference's own sharded test cases; the
port's contiguous sharded solve bit-equal to its one-device solve, with
the same host reads; the reference's sharded-tier planner tests, each
against the JAX planner on the same ``_contended_state`` seeds (deltas
byte-identical, the round's counts equal); ``solver_devices=8`` through
the gRPC service.  The ``cuda`` tests hold k = 2, 4 and 8 logical shards
of the card bit-equal to the one-device solve with the kernels.
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.ops import transport_sharded as TS

CPU = torch.device("cpu")
SOL_FIELDS = ("objective", "gap_bound", "iterations", "bf_sweeps",
              "phase_iters", "entry_phase", "eps_certified")
SOL_ARRAYS = ("flows", "unsched", "prices")
TELEM_ARRAYS = ("iters", "active_excess", "active_rows", "active_cols",
                "eps", "gu_fired", "bf_sweeps", "saturated")
ROUND_FIELDS = ("placed", "unscheduled", "preempted", "migrated",
                "objective", "iterations", "bf_sweeps", "gap_bound",
                "converged", "device_calls", "repair_firings",
                "pruned_bands", "solve_tier", "sharded_bands",
                "shard_devices", "shard_imbalance", "ladder_entry_phase",
                "telem_samples", "telem_gu_firings",
                "telem_decay_half_life", "telem_iters_to_90")


def _port_mesh(k=8):
    return TS.SolverMesh([CPU] * k)


@pytest.fixture()
def cpu_mesh(monkeypatch):
    """Eight logical shards of the CPU as every visible device."""
    monkeypatch.setattr(TS, "visible_devices", lambda device=None: [CPU] * 8)


def _same_solution(a, b, telemetry=True, shard_lanes=True):
    for f in SOL_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in SOL_ARRAYS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    if not telemetry:
        return
    ta, tb = a.telemetry, b.telemetry
    assert (ta is None) == (tb is None)
    if ta is None:
        return
    for f in TELEM_ARRAYS:
        assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
    assert (ta.total_iters, ta.cap) == (tb.total_iters, tb.cap)
    if shard_lanes:
        assert (ta.shard_excess is None) == (tb.shard_excess is None)
        if ta.shard_excess is not None:
            assert np.array_equal(ta.shard_excess, tb.shard_excess)
            assert ta.digest() == tb.digest()


# ------------------------------------------------------------ solve parity

def random_instance(rng, E, M, max_cost=1000):
    """The reference's sharded-test recipe (tests/test_transport_sharded)."""
    costs = rng.integers(0, max_cost, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = T.INF_COST  # ~10% inadmissible
    supply = rng.integers(1, 8, size=E).astype(np.int32)
    capacity = rng.integers(1, 10, size=M).astype(np.int32)
    unsched = rng.integers(max_cost, 2 * max_cost, size=E).astype(np.int32)
    return costs, supply, capacity, unsched


def _cases():
    """The reference's sharded cases as ``[(inputs, kw)]`` calls: the
    oracle instances, the one-device comparison instance, arc capacity,
    a cold solve and its warm re-solve after a cost perturbation."""
    out = {}
    rng = np.random.default_rng(7)
    out["oracle"] = [(random_instance(rng, E, M), {})
                     for E, M in [(5, 12), (9, 30), (16, 64)]]
    out["single_device"] = [
        (random_instance(np.random.default_rng(11), 12, 40), {})]
    rng = np.random.default_rng(13)
    inst = random_instance(rng, 6, 16)
    arc = rng.integers(0, 3, size=inst[0].shape).astype(np.int32)
    out["arc_capacity"] = [(inst, {"arc_capacity": arc})]
    rng = np.random.default_rng(17)
    inst = random_instance(rng, 10, 24)
    costs2 = inst[0].copy()
    mask = (costs2 < T.INF_COST) & (rng.random(costs2.shape) < 0.05)
    costs2[mask] = np.minimum(costs2[mask] + 50, 1000)
    out["warm_start"] = [(inst, {}), ((costs2,) + inst[1:], "warm")]
    return out


@pytest.mark.parametrize("strided", ["0", "1"])
@pytest.mark.parametrize("case", ["oracle", "single_device", "arc_capacity",
                                  "warm_start"])
def test_sharded_solve_matches_reference(monkeypatch, case, strided):
    """Every field of the port's 8-shard solve equals the JAX package's
    on its 8-device mesh, the ring's per-shard lanes included; the warm
    case re-solves from the cold solution in each package."""
    from poseidon_tpu.ops import transport_sharded as JS

    monkeypatch.setenv("POSEIDON_SHARD_STRIDED", strided)
    jmesh = JS.make_solver_mesh(8)
    j_prev = t_prev = None
    for inst, kw in _cases()[case]:
        if kw == "warm":
            j = JS.solve_transport_sharded(
                *inst, j_prev.prices, mesh=jmesh, init_flows=j_prev.flows,
                init_unsched=j_prev.unsched)
            t = TS.solve_transport_sharded(
                *inst, t_prev.prices, mesh=_port_mesh(),
                init_flows=t_prev.flows, init_unsched=t_prev.unsched)
        else:
            j = JS.solve_transport_sharded(*inst, mesh=jmesh, **kw)
            t = TS.solve_transport_sharded(*inst, mesh=_port_mesh(), **kw)
        assert t.gap_bound == 0.0
        if "arc_capacity" in kw:
            assert (t.flows <= kw["arc_capacity"]).all()
        _same_solution(j, t)
        if t.iterations:
            assert t.telemetry.shard_excess.shape[0] == 8
        j_prev, t_prev = j, t


def test_one_device_mesh_falls_back_like_reference():
    """A mesh of one device is the one-device solve, as the reference's
    ``make_solver_mesh(1)`` is."""
    from poseidon_tpu.ops import transport_sharded as JS

    inst = random_instance(np.random.default_rng(19), 4, 6)
    j = JS.solve_transport_sharded(*inst, mesh=JS.make_solver_mesh(1))
    calls = dict(T._Telemetry.routes)
    t = TS.solve_transport_sharded(
        *inst, mesh=TS.make_solver_mesh(1, device="cpu"))
    assert not any(k[0] == "sharded" and n > calls.get(k, 0)
                   for k, n in T._Telemetry.routes.items())
    _same_solution(j, t)
    _same_solution(t, T.solve_transport(*inst, device="cpu"))


def test_mesh_and_visible_devices():
    mesh = TS.make_solver_mesh(device="cpu")
    assert mesh.devices == (CPU,) and mesh.size == 1
    assert mesh.shape == {TS.MACHINE_AXIS: 1}
    assert TS.SolverMesh([CPU] * 4).size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TS.visible_devices()


# --------------------------------------------------- one-device parity

def _contended_instance(seed, E, M):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 500, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.05] = T.INF_COST
    supply = rng.integers(4, 40, size=E).astype(np.int32)
    capacity = rng.integers(1, 4, size=M).astype(np.int32)
    unsched = np.full(E, 900, dtype=np.int32)
    return costs, supply, capacity, unsched


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("seed,E,M,greedy", [
    (0, 12, 64, False), (1, 24, 100, True), (2, 7, 128, False),
])
def test_contiguous_shards_equal_the_one_device_solve(monkeypatch, k, seed,
                                                      E, M, greedy):
    """Contiguous shards are the one-device ladder split: every field
    bit-equal to ``solve_transport``'s (the shared ring rows too), with
    the same host reads."""
    monkeypatch.setenv("POSEIDON_SHARD_STRIDED", "0")
    inst = _contended_instance(seed, E, M)
    r0 = T.host_read_count()
    one = T.solve_transport(*inst, greedy_init=greedy, device="cpu")
    r1 = T.host_read_count()
    sh = TS.solve_transport_sharded(*inst, mesh=_port_mesh(k),
                                    greedy_init=greedy)
    r2 = T.host_read_count()
    assert one.iterations > 0
    _same_solution(one, sh, shard_lanes=False)
    assert r2 - r1 == r1 - r0
    lanes = sh.telemetry.shard_excess
    assert lanes.shape == (k, sh.telemetry.samples())


def test_no_plane_crosses_shards(monkeypatch):
    """Inside the sharded ladder only row, sink and per-shard vectors
    meet in a collective (no [E, M] block), the flow matrix comes home
    once, in blocks, and a mesh of k > 1 shards of one device runs the
    sharded route, never the one-device fallback."""
    parts, fetches = [], []
    stack, read_blocks = T._Collectives._stack, TS._host_read_blocks

    def spy_stack(self, ps):
        parts.extend(p.dim() for p in ps)
        return stack(self, ps)

    def spy_read(blocks, axis):
        fetches.append([tuple(b.shape) for b in blocks])
        return read_blocks(blocks, axis)

    monkeypatch.setattr(T._Collectives, "_stack", spy_stack)
    monkeypatch.setattr(TS, "_host_read_blocks", spy_read)
    inst = _contended_instance(4, 12, 64)
    routes = dict(T._Telemetry.routes)
    sol = TS.solve_transport_sharded(*inst, mesh=_port_mesh(4),
                                     greedy_init=False)
    assert sol.iterations > 0 and parts and max(parts) <= 1
    assert fetches == [[(16, 16)] * 4]
    key = ("sharded", 16, 64, 4)
    assert T._Telemetry.routes[key] == routes.get(key, 0) + 1


def test_shard_lanes_split_the_machine_excess(monkeypatch):
    """The per-shard lanes split the machine side of the active excess:
    a sample's lanes are positive exactly where some machine column has
    positive excess, and they never exceed the sample's whole total."""
    monkeypatch.setenv("POSEIDON_SHARD_STRIDED", "0")
    inst = _contended_instance(3, 8, 64)
    sol = TS.solve_transport_sharded(*inst, mesh=_port_mesh(4),
                                     greedy_init=False)
    t = sol.telemetry
    lanes = t.shard_excess.astype(np.int64)
    assert lanes.shape == (4, t.samples()) and lanes.sum() > 0
    assert ((lanes.sum(0) > 0) == (t.active_cols > 0)).all()
    assert (lanes.sum(0) <= t.active_excess).all()
    assert sol.gap_bound == 0.0


def test_decode_telemetry_shard_rows():
    ring = np.arange((T.TELEM_ROWS + 2) * 4, dtype=np.int32).reshape(
        T.TELEM_ROWS + 2, 4)
    t = T.decode_telemetry(ring, 6, telem_shards=2)
    assert np.array_equal(t.shard_excess, ring[T.TELEM_ROWS:][:, [2, 3, 0, 1]])
    assert "shard_excess" in t.digest()
    assert T.decode_telemetry(ring, 6).shard_excess is None


# --------------------------------------------------------------- planner

def _contended_state(pkg, machines=64, seed=5, tasks=600):
    """The reference's ``_contended_state`` (tests/test_sharded_tier.py)
    in either package: 64 machines, demand near capacity."""
    if pkg == "jax":
        from poseidon_tpu.graph.state import ClusterState, MachineInfo
        from poseidon_tpu.graph.state import TaskInfo
    else:
        from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
        from poseidon_tpu_torch.graph.state import TaskInfo
    from poseidon_tpu_torch.utils.ids import task_uid

    state = ClusterState()
    rng = np.random.default_rng(seed)
    for i in range(machines):
        state.node_added(MachineInfo(
            uuid=f"sh-m{i}", cpu_capacity=int(rng.integers(4000, 16000)),
            ram_capacity=1 << 24, task_slots=6,
        ))
    for i in range(tasks):
        state.task_submitted(TaskInfo(
            uid=task_uid(f"sh{seed}", i), job_id=f"j{i % 8}",
            cpu_request=int(rng.integers(400, 2000)),
            ram_request=1 << 18,
        ))
    return state


def _planner(pkg, state, **kw):
    if pkg == "jax":
        from poseidon_tpu.costmodel import get_cost_model
        from poseidon_tpu.graph.instance import RoundPlanner

        return RoundPlanner(state, get_cost_model("cpu_mem"), **kw)
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner

    return RoundPlanner(state, get_cost_model("cpu_mem"), device="cpu", **kw)


def _churn(pkg, state, rng):
    """bench.churn_step in either package: 1% of the tasks resubmitted."""
    if pkg == "jax":
        from poseidon_tpu.graph.state import TaskInfo
    else:
        from poseidon_tpu_torch.graph.state import TaskInfo
    uids = list(state.tasks.keys())
    pick = rng.choice(len(uids), size=max(1, len(uids) // 100),
                      replace=False)
    for k in pick:
        t = state.tasks.get(uids[k])
        if t is None:
            continue
        state.task_removed(uids[k])
        state.task_submitted(TaskInfo(uid=uids[k], job_id=t.job_id,
                                      cpu_request=t.cpu_request,
                                      ram_request=t.ram_request))


def _delta_view(deltas):
    return sorted((int(d.type), int(d.task_id), d.resource_id)
                  for d in deltas)


def _tier_on(monkeypatch, min_cols="64", min_contention="1"):
    monkeypatch.setenv("POSEIDON_SHARDED_BANDS", "1")
    monkeypatch.setenv("POSEIDON_SHARDED_MIN_COLS", min_cols)
    monkeypatch.setenv("POSEIDON_SHARDED_MIN_CONTENTION", min_contention)


def _both_rounds(seed, churn_flips=(), **kw):
    """The JAX planner and the port's on ``_contended_state(seed)``: the
    wave, then a churn round per entry of ``churn_flips`` (the sharded
    hatch's value for it).  Every round's deltas must be byte-identical
    and its counts equal; returns the port's metrics per round."""
    import os

    states = {p: _contended_state(p, seed=seed, **kw) for p in ("jax", "t")}
    planners = {p: _planner(p, states[p]) for p in states}
    rngs = {p: np.random.default_rng(2) for p in states}
    out = []
    for flip in (None,) + tuple(churn_flips):
        if flip is not None:
            os.environ["POSEIDON_SHARDED_BANDS"] = flip
            for p in states:
                _churn(p, states[p], rngs[p])
        (jd, jm), (td, tm) = (planners[p].schedule_round()
                              for p in ("jax", "t"))
        assert _delta_view(jd) == _delta_view(td)
        for f in ROUND_FIELDS:
            assert getattr(jm, f) == getattr(tm, f), f
        out.append(tm)
    return out, planners["t"]


def test_sharded_tier_serves_contended_band(monkeypatch, cpu_mesh):
    _tier_on(monkeypatch)
    (m,), planner = _both_rounds(5)
    assert m.solve_tier == "sharded"
    assert m.sharded_bands >= 1 and m.shard_devices == 8
    assert m.converged and m.gap_bound == 0.0 and m.placed > 0
    assert m.shard_imbalance >= 1.0
    assert any(c.get("shard_excess") for c in planner.last_solve_curves)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_vs_dense_parity_randomized(monkeypatch, cpu_mesh, seed):
    """Tier on with contiguous shards: the JAX planner's deltas and
    counts, and the port's own tier-off round's placements, objective
    and iterations."""
    _tier_on(monkeypatch)
    monkeypatch.setenv("POSEIDON_SHARD_STRIDED", "0")
    (m_sh,), _ = _both_rounds(seed)
    d_sh = _planner("t", _contended_state("t", seed=seed)).schedule_round()[0]
    monkeypatch.setenv("POSEIDON_SHARDED_BANDS", "0")
    d_dn, m_dn = _planner("t", _contended_state("t", seed=seed)) \
        .schedule_round()
    assert m_sh.solve_tier == "sharded"
    assert m_dn.solve_tier in ("pruned", "dense")
    assert (m_sh.objective, m_sh.placed, m_sh.iterations) == \
        (m_dn.objective, m_dn.placed, m_dn.iterations)
    assert _delta_view(d_sh) == _delta_view(d_dn)


@pytest.mark.parametrize("seed", [0, 2])
def test_strided_shards_keep_solution_quality(monkeypatch, cpu_mesh, seed):
    """The default strided layout: the JAX planner's deltas, and the
    dense round's objective, placed count and certificate."""
    _tier_on(monkeypatch)
    (m_st,), _ = _both_rounds(seed)
    monkeypatch.setenv("POSEIDON_SHARDED_BANDS", "0")
    d_dn, m_dn = _planner("t", _contended_state("t", seed=seed)) \
        .schedule_round()
    assert m_st.solve_tier == "sharded"
    assert (m_st.objective, m_st.placed) == (m_dn.objective, m_dn.placed)
    assert m_st.converged and m_st.gap_bound == 0.0


def test_sharded_gate_declines_are_bit_identical(monkeypatch, cpu_mesh):
    """The hatch on with the width gate declining is the hatch off."""
    _tier_on(monkeypatch, min_cols="100000")
    (m_on,), _ = _both_rounds(9)
    monkeypatch.setenv("POSEIDON_SHARDED_BANDS", "0")
    d_off, m_off = _planner("t", _contended_state("t", seed=9)) \
        .schedule_round()
    monkeypatch.setenv("POSEIDON_SHARDED_BANDS", "1")
    d_on, _ = _planner("t", _contended_state("t", seed=9)).schedule_round()
    assert m_on.solve_tier != "sharded"
    assert m_on.sharded_bands == 0 and m_on.shard_devices == 0
    assert (m_on.solve_tier, m_on.objective, m_on.iterations) == \
        (m_off.solve_tier, m_off.objective, m_off.iterations)
    assert _delta_view(d_on) == _delta_view(d_off)


def test_sharded_gate_declines_under_contention(monkeypatch, cpu_mesh):
    """A 1000% contention threshold declines this ~156% cluster."""
    _tier_on(monkeypatch, min_contention="1000")
    (m,), _ = _both_rounds(3)
    assert m.solve_tier != "sharded" and m.sharded_bands == 0


def test_tier_transition_warm_start_both_directions(monkeypatch, cpu_mesh):
    """Warm frames carry across tier transitions both ways (sharded ->
    sharded -> dense -> sharded), each round certified, no costlier than
    the cold wave, and equal to the JAX planner's round."""
    _tier_on(monkeypatch)
    ms, planner = _both_rounds(11, churn_flips=("1", "0", "1"))
    assert ms[0].solve_tier == "sharded" and ms[0].gap_bound == 0.0
    for flip, m in zip(("1", "0", "1"), ms[1:]):
        if flip == "1":
            assert m.solve_tier == "sharded"
        else:
            assert m.solve_tier in ("pruned", "dense")
        assert m.converged and m.gap_bound == 0.0
        assert m.iterations <= ms[0].iterations
    assert planner._warm_bands


def test_solve_tier_sharded_telemetry_ride_through():
    """``solve_tier == "sharded"`` and the shard series ride the wire
    format, the ``/metrics`` exposition and the harness vocabulary, as
    the reference's do."""
    from poseidon_tpu_torch.chaos import soak
    from poseidon_tpu_torch.chaos.harness import KNOWN_TIERS
    from poseidon_tpu_torch.graph.instance import RoundMetrics
    from poseidon_tpu_torch.obs import metrics as obs_metrics

    m = RoundMetrics(round_index=3, solve_tier="sharded", sharded_bands=2,
                     shard_devices=8, shard_imbalance=1.25, placed=7)
    d = m.to_dict()
    assert (d["solve_tier"], d["sharded_bands"], d["shard_devices"],
            d["shard_imbalance"]) == ("sharded", 2, 8, 1.25)
    rt = RoundMetrics.from_dict(d)
    assert (rt.solve_tier, rt.sharded_bands, rt.shard_devices,
            rt.shard_imbalance) == ("sharded", 2, 8, 1.25)
    assert "sharded" in obs_metrics.SOLVE_TIERS
    reg = obs_metrics.Registry()
    obs_metrics.observe_round(m, registry=reg)
    text = reg.expose()
    assert 'poseidon_round_solve_tier{tier="sharded"} 1' in text
    assert 'poseidon_round_solve_tier{tier="dense"} 0' in text
    assert "poseidon_round_sharded_bands 2" in text
    assert "poseidon_round_shard_devices 8" in text
    assert "poseidon_round_shard_imbalance 1.25" in text
    assert "sharded" in KNOWN_TIERS
    assert soak.metrics_wire(m)["solve_tier"] == "sharded"


def test_precompile_covers_sharded_tier_key(monkeypatch, cpu_mesh):
    """With the hatch on, precompile probes the sharded solve at the full
    bucket, so a warm sharded round sees no fresh solve key.  The probe
    ceiling covers this round's EC rows (512 padded): the port counts a
    key's first sight in the process, whatever ran before this test."""
    from poseidon_tpu_torch.check.ledger import CompileLedger

    _tier_on(monkeypatch)
    planner = _planner("t", _contended_state("t", seed=21))
    planner.precompile(max_ecs=512)
    with CompileLedger(budget=0, label="post-precompile sharded round"):
        _, m = planner.schedule_round()
    assert m.solve_tier == "sharded"
    assert m.fresh_compiles == 0


# --------------------------------------------------------------- service

def test_sharded_solver_through_service(cpu_mesh):
    """``solver_devices=8`` through the port's gRPC service: every band
    solves on the 8-shard mesh and every pod is placed."""
    from poseidon_tpu_torch.protos import firmament_pb2 as fpb
    from poseidon_tpu_torch.service.client import FirmamentClient
    from poseidon_tpu_torch.service.server import FirmamentTPUServer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig
    from poseidon_tpu_torch.utils.ids import generate_uuid, hash_combine

    cfg = FirmamentTPUConfig(listen_address="127.0.0.1:0", solver_devices=8,
                             device="cpu")
    calls = T.device_call_count()
    with FirmamentTPUServer(config=cfg) as server, \
            FirmamentClient(server.address) as client:
        for i in range(16):
            rtnd = fpb.ResourceTopologyNodeDescriptor()
            rd = rtnd.resource_desc
            rd.uuid = generate_uuid(f"svc-shard-m{i}")
            rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
            rd.resource_capacity.cpu_cores = 4000
            rd.resource_capacity.ram_cap = 1 << 24
            rd.task_capacity = 100
            assert client.node_added(rtnd) == fpb.NODE_ADDED_OK
        for i in range(24):
            td = fpb.TaskDescriptor(uid=hash_combine(99, i),
                                    job_id="shard-job")
            td.resource_request.cpu_cores = 100 * (1 + i % 3)
            td.resource_request.ram_cap = 1 << 20
            jd = fpb.JobDescriptor(uuid="shard-job", name="shard-job")
            assert client.task_submitted(td, jd) == fpb.TASK_SUBMITTED_OK
        deltas = client.schedule()
        placed = sum(1 for d in deltas
                     if d.type == fpb.SchedulingDelta.PLACE)
        assert placed == 24
        mesh = server.servicer.planner._mesh
        assert mesh is not None and mesh.size == 8
    assert T.device_call_count() >= calls


def test_sharded_coarse_start_objective_parity(monkeypatch, cpu_mesh):
    """The coarse start's aggregated solve goes through the same dispatch
    as the full solve, so ``solver_devices`` 8 and 1 land on the same
    objective with the coarse lift firing on both (gates shrunk to test
    scale, as the reference's test shrinks them; a disaggregation spy
    proves it ran)."""
    from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
    from poseidon_tpu_torch.graph.state import TaskInfo
    from poseidon_tpu_torch.utils.ids import task_uid

    monkeypatch.setattr(T, "COARSE_MIN_MACHINES", 32)
    monkeypatch.setattr(T, "COARSE_GROUPS", 8)
    lifted = {"n": 0}
    orig = T._coarse_disaggregate

    def spy(*a, **k):
        lifted["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(T, "_coarse_disaggregate", spy)

    def run(devices):
        state = ClusterState()
        rng = np.random.default_rng(5)
        for i in range(64):
            state.node_added(MachineInfo(
                uuid=f"sc-m{i}", cpu_capacity=int(rng.integers(4000, 16000)),
                ram_capacity=1 << 24, task_slots=6,
            ))
        for i in range(600):
            state.task_submitted(TaskInfo(
                uid=task_uid("sc", i), job_id=f"j{i % 8}",
                cpu_request=int(rng.integers(400, 2000)),
                ram_request=1 << 18,
            ))
        planner = _planner("t", state, solver_devices=devices)
        _, m = planner.schedule_round()
        assert m.converged and m.gap_bound == 0.0
        assert (planner._mesh is None) == (devices == 1)
        return m.objective, m.placed

    single = run(1)
    mid = lifted["n"]
    assert mid > 0, "coarse lift did not fire on one device"
    sharded = run(8)
    assert lifted["n"] > mid, "coarse lift did not fire on 8 shards"
    assert single == sharded


# --------------------------------------------------------------- the card

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a mesh of the card's shards)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [32, 128])
def test_logical_shards_of_the_card_equal_the_kernel_solve(
        monkeypatch, cuda_device, E):
    """k = 2, 4 and 8 logical shards of the card, contiguous: every field
    bit-equal to the one-device solve, which runs the kernels at this
    width, and every shard's tensors on the card."""
    monkeypatch.setenv("POSEIDON_SHARD_STRIDED", "0")
    inst = _contended_instance(E, E, 10000)
    one = T.solve_transport(*inst, greedy_init=False, device=cuda_device)
    for k in (2, 4, 8):
        mesh = TS.SolverMesh([cuda_device] * k)
        sh = TS.solve_transport_sharded(*inst, mesh=mesh, greedy_init=False)
        _same_solution(one, sh, shard_lanes=False)
        assert sh.telemetry.shard_excess.shape[0] == k

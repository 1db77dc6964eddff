"""The port's convergence-telemetry ring against the JAX package's.

With ``POSEIDON_SOLVE_TELEMETRY`` on (the default in both packages) every
device solve carries an int32 ``[TELEM_ROWS, cap]`` ring, one sample per
active push/relabel iteration, read with the solve's one small result
vector.  Seeded numpy instances go through both packages and everything
must be EQUAL (exact tolerance): the whole small result vector with the
ring in it, at the reference's offsets, against the JAX lax path and its
Pallas kernels in interpret mode; the decoded curves and their digests;
and the results with the ring on and off.  The port runs on the CPU,
where the kernel routes' wrappers run their plain versions; the CUDA
kernels' rings are held against those on the card
(tests/test_torch_kernels.py and ``chip_smoke.py``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseidon_tpu.ops import transport as J
from poseidon_tpu_torch.ops import transport as T


def _instance(E, M, seed, *, cap_hi=4, supply_hi=8):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = J.INF_COST
    supply = rng.integers(1, supply_hi, size=E).astype(np.int32)
    cap = rng.integers(1, cap_hi, size=M).astype(np.int32)
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    return costs, supply, cap, unsched, arc


def _packed(costs, supply, cap, unsched, arc, adaptive=1):
    """The packed operands of a cold solve of this (unpadded) instance."""
    E, M = costs.shape
    scale, eps_sched, _ = T._host_validate(costs, supply, cap, unsched,
                                           None, None, 8000)
    big = np.stack([costs, arc, np.zeros_like(costs)])
    vec = np.concatenate([
        supply, cap, unsched, np.zeros(E + M + 1, np.int32),
        np.zeros(E, np.int32), eps_sched,
        np.asarray([8192, 4, 64, adaptive], np.int32),
    ]).astype(np.int32)
    return big, vec, int(scale)


def _both_packed(big, vec, scale, impl, telem_cap):
    """The small result vectors of the JAX package's and the port's
    packed solve (the JAX kernels in interpret mode)."""
    _, j_small = J._solve_device_packed(
        jnp.asarray(big), jnp.asarray(vec), max_iter=8192, scale=scale,
        impl=impl, interpret=impl != "lax", telem_cap=telem_cap)
    _, t_small = T._solve_device_packed(
        big, vec, max_iter=8192, scale=scale, impl=impl, device="cpu",
        telem_cap=telem_cap)
    return np.asarray(j_small), t_small


def _ring_of(small, E, M, cap):
    o = E + E + M + 1
    iters = int(small[o])
    ring = small[o + 4 + T.NUM_PHASES:].reshape(T.TELEM_ROWS, cap)
    return ring, iters


@pytest.fixture()
def lax_path(monkeypatch):
    monkeypatch.setenv("POSEIDON_FUSED", "0")
    monkeypatch.setenv("POSEIDON_TILED", "0")


@pytest.mark.parametrize("env", [
    {}, {"POSEIDON_SOLVE_TELEMETRY_CAP": "100"},
    {"POSEIDON_SOLVE_TELEMETRY_CAP": "129"},
    {"POSEIDON_SOLVE_TELEMETRY_CAP": "0"},
    {"POSEIDON_SOLVE_TELEMETRY_CAP": "-5"},
    {"POSEIDON_SOLVE_TELEMETRY": "0"},
])
def test_cap_hatch_matches_reference(monkeypatch, env):
    for k in ("POSEIDON_SOLVE_TELEMETRY", "POSEIDON_SOLVE_TELEMETRY_CAP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert T.solve_telemetry_cap() == J.solve_telemetry_cap()
    assert T.solve_telemetry_cap() % 128 == 0


@pytest.mark.parametrize("impl,E,M,seed,adaptive", [
    ("lax", 16, 96, 1, 0),
    ("lax", 24, 160, 2, 1),
    ("fused", 16, 128, 5, 1),
    ("tiled", 16, 128, 5, 0),
])
def test_ring_bit_equal_to_reference(impl, E, M, seed, adaptive):
    """The whole small result vector (fallback flows, prices, iterations,
    sweeps, clean, unchanged, phase iterations and the ring after them)
    is bit-equal to the JAX package's: its lax path, and its fused and
    tiled Pallas kernels in interpret mode.  The ring really sampled the
    solve: one sample per iteration, global updates with their sweeps."""
    big, vec, scale = _packed(*_instance(E, M, seed, cap_hi=2), adaptive)
    j_small, t_small = _both_packed(big, vec, scale, impl, 256)
    np.testing.assert_array_equal(j_small, t_small)
    ring, iters = _ring_of(t_small, E, M, 256)
    t = T.decode_telemetry(ring, iters)
    assert 0 < iters <= 256 and t.samples() == iters
    assert (np.diff(t.iters) == 1).all()
    assert t.gu_firings() >= 1
    assert int(t.bf_sweeps.sum()) == int(t_small[E + E + M + 1 + 1])
    assert (t.bf_sweeps[t.gu_fired == 0] == 0).all()
    assert t.saturated_samples() == 0


@pytest.mark.parametrize("impl", ["lax", "tiled"])
def test_ring_wraps_at_cap_128(impl):
    """A solve longer than the ring: the last 128 samples, bit-equal to
    the reference's, decoded oldest first from ``total_iters % cap``."""
    E, M = 32, 160
    big, vec, scale = _packed(*_instance(E, M, 4, cap_hi=2, supply_hi=40))
    j_small, t_small = _both_packed(big, vec, scale, impl, 128)
    np.testing.assert_array_equal(j_small, t_small)
    ring, iters = _ring_of(t_small, E, M, 128)
    assert iters > 128
    t = T.decode_telemetry(ring, iters)
    assert t.wrapped() and t.samples() == 128
    assert int(t.iters[-1]) == iters - 1
    assert (np.diff(t.iters) == 1).all()


@pytest.mark.parametrize("impl", ["lax", "fused", "tiled"])
def test_cap_zero_threads_no_ring(impl):
    """With the cap at 0 no ring is threaded: the small vector ends at the
    phase iterations, and it and the flows are those of a solve with the
    ring on, minus the ring."""
    E, M = 16, 96
    big, vec, scale = _packed(*_instance(E, M, 1, cap_hi=2))
    F_off, off = T._solve_device_packed(big, vec, max_iter=8192,
                                        scale=scale, impl=impl,
                                        device="cpu", telem_cap=0)
    F_on, on = T._solve_device_packed(big, vec, max_iter=8192, scale=scale,
                                      impl=impl, device="cpu", telem_cap=128)
    assert off.size == E + E + M + 1 + 4 + T.NUM_PHASES
    assert on.size == off.size + T.TELEM_ROWS * 128
    np.testing.assert_array_equal(on[:off.size], off)
    np.testing.assert_array_equal(F_on.numpy(), F_off.numpy())


def test_solve_results_equal_with_telemetry_on_and_off(lax_path, monkeypatch):
    """solve_transport with the ring on and off: every result field equal
    and the same number of host reads per solve (the ring rides the one
    small read); off carries no curve.  The curve equals the
    reference's."""
    costs, supply, cap, unsched, arc = _instance(24, 128, 3, cap_hi=2)
    sols, reads = {}, {}
    for flag in ("1", "0"):
        monkeypatch.setenv("POSEIDON_SOLVE_TELEMETRY", flag)
        r0 = T.host_read_count()
        sols[flag] = T.solve_transport(costs, supply, cap, unsched,
                                       arc_capacity=arc, device="cpu")
        reads[flag] = T.host_read_count() - r0
    on, off = sols["1"], sols["0"]
    assert reads["1"] == reads["0"] > 0
    assert off.telemetry is None and on.telemetry is not None
    np.testing.assert_array_equal(on.flows, off.flows)
    np.testing.assert_array_equal(on.unsched, off.unsched)
    np.testing.assert_array_equal(on.prices, off.prices)
    for name in ("objective", "gap_bound", "iterations", "bf_sweeps",
                 "phase_iters", "entry_phase"):
        assert getattr(on, name) == getattr(off, name), name
    monkeypatch.setenv("POSEIDON_SOLVE_TELEMETRY", "1")
    ref = J.solve_transport(costs, supply, cap, unsched, arc_capacity=arc)
    assert ref.telemetry.digest() == on.telemetry.digest()
    assert on.telemetry.samples() == on.iterations > 0


def test_selective_passes_the_reduced_solves_curve(lax_path):
    """solve_transport_selective returns its reduced solve's curve, as
    the reference does."""
    costs, supply, cap, unsched, arc = _instance(12, 900, 30, cap_hi=2)
    supply[:] = np.minimum(supply, 3)
    a = J.solve_transport_selective(costs, supply, cap, unsched,
                                    arc_capacity=arc, slack=8)
    b = T.solve_transport_selective(costs, supply, cap, unsched,
                                    arc_capacity=arc, slack=8, device="cpu")
    assert a.iterations == b.iterations > 0
    assert b.telemetry.samples() == b.iterations
    assert a.telemetry.digest() == b.telemetry.digest()


@pytest.mark.parametrize("total_iters,cap", [(0, 8), (5, 8), (8, 8),
                                             (11, 8), (300, 128),
                                             (1000, 128)])
def test_decode_and_digest_match_reference(total_iters, cap):
    """decode_telemetry and SolveTelemetry's roll-ups and digest on one
    seeded ring (wrapped or not) against the reference's."""
    rng = np.random.default_rng(total_iters + cap)
    ring = rng.integers(0, 50, size=(T.TELEM_ROWS, cap)).astype(np.int32)
    for it in range(total_iters):
        ring[T._TR_ITER, it % cap] = it
        ring[T._TR_EXCESS, it % cap] = max(1000 - 7 * it, 0)
    ring[T._TR_GU] &= 1
    ring[T._TR_SAT] = 0
    a = J.decode_telemetry(ring, total_iters)
    b = T.decode_telemetry(ring, total_iters)
    assert (a is None) == (b is None)
    if a is None:
        return
    da, db = a.digest(), b.digest()
    assert da == db
    json.dumps(db)
    assert b.decay_half_life() == a.decay_half_life()
    assert b.iters_to_drain(0.9) == a.iters_to_drain(0.9)
    assert b.gu_firings() == a.gu_firings()
    assert b.wrapped() == a.wrapped() == (total_iters > cap)


@pytest.mark.parametrize("total,sat", [((1 << 30) - 1, 0), (1 << 30, 1),
                                       ((1 << 31) - 2, 1)])
def test_status_saturation_lane(total, sat):
    """The status's active-excess total clamps to INT32_MAX from 2^30 up
    and sets the saturation bit the ring's _TR_SAT row carries (the
    reference decides the clamp with a float32 shadow sum, and agrees
    below 2^30)."""
    exc_e = torch.tensor([total // 2, -3], dtype=torch.int32)
    exc_m = torch.tensor([total - total // 2, 0, 0], dtype=torch.int32)
    exc_t = torch.tensor([0], dtype=torch.int32)
    st = T._phase_status(exc_e, exc_m, exc_t,
                         torch.tensor([9], dtype=torch.int32)).tolist()
    assert st == [1, total if not sat else (1 << 31) - 1, 9, 1, 1, sat]
    ring = torch.zeros((T.TELEM_ROWS, 128), dtype=torch.int32)
    T._telem_write(ring, torch.tensor(st, dtype=torch.int32), 300, 7)
    col = (300 + 9) % 128
    assert ring[:, col].tolist() == [309, st[1], 1, 1, 7, 0, 0, sat]
    assert int(ring.abs().sum()) == sum(abs(v) for v in ring[:, col].tolist())


def test_inactive_status_writes_nothing():
    """An iteration entering with no positive excess (an unroll group's
    no-op past convergence) leaves the ring as it was."""
    ring = torch.arange(T.TELEM_ROWS * 128, dtype=torch.int32).reshape(
        T.TELEM_ROWS, 128)
    before = ring.clone()
    st = T._phase_status(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.tensor([40], dtype=torch.int32))
    T._telem_write(ring, st, 0, 1)
    assert torch.equal(ring, before)


def test_planner_rolls_curves_like_reference(monkeypatch):
    """A contended fresh wave and a churn round through both planners:
    the telem_* RoundMetrics counts and the per-band digests
    (``last_solve_curves``) equal the reference's."""
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask
    from poseidon_tpu.utils.ids import generate_uuid, hash_combine
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
    from poseidon_tpu_torch.graph.state import TaskInfo

    monkeypatch.setenv("POSEIDON_SOLVE_TELEMETRY_CAP", "128")
    rng = np.random.default_rng(31)
    pods = [(hash_combine(41, i), f"tc-{e}", 300 + 37 * e, 1 << 18)
            for i, e in enumerate(rng.integers(0, 6, size=200))]

    def build(State, Machine, Task):
        st = State()
        for i in range(24):
            st.node_added(Machine(uuid=generate_uuid(f"tc-m{i}"),
                                  cpu_capacity=4000, ram_capacity=1 << 24,
                                  task_slots=6))
        for uid, job, cpu, ram in pods:
            st.task_submitted(Task(uid=uid, job_id=job, cpu_request=cpu,
                                   ram_request=ram))
        return st

    js, ts = build(JState, JMachine, JTask), build(ClusterState, MachineInfo,
                                                   TaskInfo)
    jp = JPlanner(js, j_cost_model("cpu_mem"))
    tp = RoundPlanner(ts, get_cost_model("cpu_mem"), device="cpu")
    samples = 0
    for r in range(2):
        if r:
            for state, Task in ((js, JTask), (ts, TaskInfo)):
                for uid, job, cpu, ram in pods[::9]:
                    state.task_removed(uid)
                    state.task_submitted(Task(uid=uid, job_id=job,
                                              cpu_request=cpu,
                                              ram_request=ram))
        _, jm = jp.schedule_round()
        _, tm = tp.schedule_round()
        for name in ("telem_samples", "telem_gu_firings",
                     "telem_decay_half_life", "telem_iters_to_90",
                     "iterations", "objective"):
            assert getattr(jm, name) == getattr(tm, name), (r, name)
        assert jp.last_solve_curves == tp.last_solve_curves
        json.dumps(tp.last_solve_curves)
        samples += tm.telem_samples
    assert samples > 0

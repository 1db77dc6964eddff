"""The port's runtime ledgers (``check/ledger.py``) and the round wire
they feed, against the JAX package's.

- the numerics validator counts the same anomalies as the reference's on
  seeded arrays (non-finite floats, int32 near the rails);
- the transfer interposer installs on ``torch.Tensor``, leaves CPU
  tensors and ``transport._host_read`` uncounted, and counts a CUDA
  tensor's ``.item()`` (a ``cuda`` test);
- the compile ledger counts a solve key's first sight once, and a
  precompiled planner's next round counts no first sight where an
  unprecompiled one counts some;
- ``RoundMetrics.to_dict()`` carries the reference's key set, ``schema``
  included, and the port's three contention fields beside it, and
  ``from_dict`` round-trips (across packages too, where the reference
  drops the port's fields);
- the planner's ``round`` span parents its stage spans, and
  ``utils/stagetimer`` is the tracer's aggregate mode, as in the
  reference.

The JAX package is imported inside the tests that compare with it, so
the ``cuda`` test also runs on the card, which has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.check import ledger as tledger
from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.instance import RoundMetrics, RoundPlanner
from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo
from poseidon_tpu_torch.obs import trace as ttrace
from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.utils import stagetimer
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid
from poseidon_tpu_torch.utils.numerics import SaturationError, certify_i32

I32_MAX = (1 << 31) - 1
# RoundMetrics fields the port has and the reference lacks.
PORT_ONLY = {"band_groups", "escalated_ecs", "max_wait_rounds"}


def _arrays(case: str, seed: int):
    rng = np.random.default_rng(seed)
    if case == "finite_float":
        return [rng.normal(size=(16, 8)).astype(np.float32)]
    if case == "nan_and_inf":
        a = rng.normal(size=(16, 8)).astype(np.float32)
        a[rng.integers(16), rng.integers(8)] = np.nan
        b = rng.normal(size=5)
        b[rng.integers(5)] = -np.inf
        return [a, b]
    if case == "int32_clear":
        return [rng.integers(-(1 << 30), 1 << 30, size=64).astype(np.int32)]
    if case == "int32_near_top":
        a = rng.integers(0, 1 << 20, size=64).astype(np.int32)
        a[rng.integers(64)] = I32_MAX - int(rng.integers(1 << 19))
        return [a]
    if case == "int32_near_bottom":
        a = rng.integers(0, 1 << 20, size=(4, 16)).astype(np.int32)
        a[1, 3] = -(1 << 31) + int(rng.integers(1 << 19))
        return [a]
    if case == "mixed":
        return _arrays("nan_and_inf", seed) + _arrays("int32_near_top", seed)
    if case == "empty_and_int64":
        return [np.zeros(0, np.float32), np.full(3, 1 << 40, np.int64)]
    raise KeyError(case)


CASES = ("finite_float", "nan_and_inf", "int32_clear", "int32_near_top",
         "int32_near_bottom", "mixed", "empty_and_int64")


def _validate(L, arrays):
    with L.NumericsLedger(budget=None, label="parity") as led:
        c0 = L.numeric_anomaly_count()
        for a in arrays:
            L.maybe_validate_fetched(a, site="host_read")
        return L.numeric_anomaly_count() - c0, led.anomalies, led.offenders


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_numerics_validator_counts_like_the_reference(case, seed):
    from poseidon_tpu.check import ledger as jledger

    arrays = _arrays(case, seed)
    got = _validate(tledger, arrays)
    ref = _validate(jledger, arrays)
    assert got == ref
    expect = {"finite_float": 0, "nan_and_inf": 2, "int32_clear": 0,
              "int32_near_top": 1, "int32_near_bottom": 1, "mixed": 3,
              "empty_and_int64": 0}[case]
    assert got[0] == expect


def test_numerics_validation_is_off_outside_a_window(monkeypatch):
    monkeypatch.delenv("POSEIDON_NUMERICS_LEDGER", raising=False)
    c0 = tledger.numeric_anomaly_count()
    for a in _arrays("nan_and_inf", 0):
        tledger.maybe_validate_fetched(a, site="x")
    assert tledger.numeric_anomaly_count() == c0
    monkeypatch.setenv("POSEIDON_NUMERICS_LEDGER", "1")
    for a in _arrays("nan_and_inf", 0):
        tledger.maybe_validate_fetched(a, site="x")
    assert tledger.numeric_anomaly_count() == c0 + 2


def test_numerics_budget_and_saturation_trips():
    with pytest.raises(tledger.NumericsBudgetExceeded, match="non-finite"):
        with tledger.NumericsLedger(budget=0, label="window"):
            tledger.maybe_validate_fetched(
                np.array([1.0, np.nan]), site="host_read")
    # A saturation certificate's trip counts as an anomaly too.
    with tledger.NumericsLedger(budget=None) as led:
        with pytest.raises(SaturationError):
            certify_i32(np.array([I32_MAX], dtype=np.int32), site="probe")
    assert led.anomalies == 1 and "probe" in led.offenders[0]


def test_host_read_validates_what_it_reads():
    with tledger.NumericsLedger(budget=None) as led:
        T._host_read(torch.tensor([1, I32_MAX], dtype=torch.int32))
        T._host_read(torch.tensor([0, 5], dtype=torch.int32))
    assert led.anomalies == 1
    assert led.offenders[0].startswith("host_read: int32[2]")


def test_transfer_interposer_skips_cpu_tensors_and_the_seam():
    c0 = tledger.implicit_transfer_count()
    for name in tledger._SYNC_METHODS:
        assert hasattr(getattr(torch.Tensor, name), "_poseidon_sync_orig")
    t = torch.tensor([3], dtype=torch.int32)
    with tledger.TransferLedger(budget=0, label="cpu tensors"):
        assert t.item() == 3 and int(t) == 3 and float(t) == 3.0
        assert bool(t) and t.tolist() == [3] and [0, 1, 2, 3][t] == 3
        assert T._host_read(t).tolist() == [3]
    assert tledger.implicit_transfer_count() == c0
    # The JAX package's interposer is its own: the port's counter never
    # sees a jax array's sync, nor the reference's a tensor's.
    import jax.numpy as jnp

    from poseidon_tpu.check import ledger as jledger

    j0 = jledger.implicit_transfer_count()
    int(jnp.int32(4))
    assert tledger.implicit_transfer_count() == c0
    assert jledger.implicit_transfer_count() == j0 + 1


def test_transfer_ledger_budget_names_the_offender():
    t = torch.tensor([7])
    with pytest.raises(tledger.TransferBudgetExceeded,
                       match=r"item\(\) on torch.int64\[1\] at"):
        with tledger.TransferLedger(budget=0, label="warm round"):
            tledger._note_sync("item", t)
    with tledger.TransferLedger(budget=None) as led:
        tledger._note_sync("__int__", t)
    assert led.implicit_transfers == 1


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA tensor's sync)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_transfer_interposer_counts_a_cuda_item(cuda_device):
    t = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    c0 = tledger.implicit_transfer_count()
    with tledger.TransferLedger(budget=None) as led:
        assert t.item() == 5
        assert int(t) == 5
        assert T._host_read(t).tolist() == [5]
    assert led.implicit_transfers == 2
    assert tledger.implicit_transfer_count() == c0 + 2


def test_compile_ledger_counts_first_sights(monkeypatch):
    monkeypatch.setattr(tledger, "_solve_keys", set())
    c0 = tledger.fresh_compile_count()
    with tledger.capture_solve_keys() as keys:
        assert tledger.note_solve_key(("lax", 8, 32, 5))
        assert not tledger.note_solve_key(("lax", 8, 32, 5))
    assert keys == {("lax", 8, 32, 5)}
    assert tledger.fresh_compile_count() == c0 + 1
    with pytest.raises(tledger.CompileBudgetExceeded, match="lax/16/32/5"):
        with tledger.CompileLedger(budget=0, label="warm round"):
            tledger.note_solve_key(("lax", 16, 32, 5))
    with tledger.CompileLedger(budget=0):
        tledger.note_solve_key(("lax", 16, 32, 5))


def _cluster(machines=20, tasks=60):
    st = ClusterState()
    for i in range(machines):
        st.node_added(MachineInfo(
            uuid=generate_uuid(f"led-m{i}"), cpu_capacity=32000,
            ram_capacity=128 << 20, task_slots=16))
    for i in range(tasks):
        st.task_submitted(TaskInfo(
            uid=task_uid("led", i), job_id="led-j",
            cpu_request=(200, 400, 800)[i % 3],
            ram_request=(1 << 19, 1 << 20)[i % 2]))
    return st


@pytest.mark.parametrize("precompiled", [True, False])
def test_precompiled_round_counts_no_first_sight(monkeypatch, precompiled):
    monkeypatch.setattr(tledger, "_solve_keys", set())
    # Every round dispatches a device solve (no host certificate).
    monkeypatch.setenv("POSEIDON_HOST_CERT", "0")
    st = _cluster()
    planner = RoundPlanner(st, get_cost_model("cpu_mem"), device="cpu")
    if precompiled:
        assert planner.precompile(max_ecs=16) == 2
    _, m = planner.schedule_round()
    assert m.device_calls > 0
    if precompiled:
        assert m.fresh_compiles == 0
    else:
        assert m.fresh_compiles > 0
    assert (m.implicit_transfers, m.numeric_anomalies) == (0, 0)


def test_round_metrics_wire_is_the_reference_s():
    from poseidon_tpu.graph.instance import RoundMetrics as JRoundMetrics

    t, j = RoundMetrics().to_dict(), JRoundMetrics().to_dict()
    assert set(t) - set(j) == PORT_ONLY and set(j) <= set(t)
    assert t["schema"] == j["schema"] == 1
    assert RoundMetrics.SCHEMA == JRoundMetrics.SCHEMA
    m = RoundMetrics(round_index=3, placed=7, gap_bound=float("inf"),
                     fresh_compiles=2, implicit_transfers=1,
                     numeric_anomalies=4, lock_contention_ns=99,
                     solve_tier="host_greedy", converged=False,
                     solve_phase_iters=[1, 2, 3, 4], band_groups=2,
                     escalated_ecs=5, max_wait_rounds=3)
    d = m.to_dict()
    assert d["gap_bound"] == "inf"
    assert (d["band_groups"], d["escalated_ecs"], d["max_wait_rounds"]) \
        == (2, 5, 3)
    assert RoundMetrics.from_dict(d) == m
    # Across packages: each side reads the other's wire; the reference
    # drops the port's fields, which then read their defaults.
    shared = {k: v for k, v in d.items() if k not in PORT_ONLY}
    assert JRoundMetrics.from_dict(d).to_dict() == shared
    assert RoundMetrics.from_dict(JRoundMetrics.from_dict(d).to_dict()) \
        == dataclasses.replace(m, band_groups=0, escalated_ecs=0,
                               max_wait_rounds=0)
    # Forward compatibility: unknown keys dropped, missing ones default;
    # a newer schema refuses.
    assert RoundMetrics.from_dict({"placed": 5, "future": 1}).placed == 5
    with pytest.raises(ValueError, match="newer"):
        RoundMetrics.from_dict({"schema": 2})


def test_round_span_parents_the_stage_spans(monkeypatch):
    monkeypatch.delenv("POSEIDON_STAGE_TIMERS", raising=False)
    monkeypatch.setenv("POSEIDON_HOST_CERT", "0")
    tr = ttrace.tracer()
    prev = tr.force
    tr.force = True
    try:
        ttrace.drain_spans()
        planner = RoundPlanner(_cluster(), get_cost_model("cpu_mem"),
                               device="cpu")
        _, m = planner.schedule_round()
        spans = ttrace.drain_spans()
    finally:
        tr.force = prev
    rounds = [s for s in spans if s["name"] == "round"]
    assert len(rounds) == 1
    rid = rounds[0]["id"]
    assert rounds[0]["attrs"]["placed"] == m.placed
    assert rounds[0]["attrs"]["fresh_compiles"] == m.fresh_compiles
    by_name = {s["name"]: s for s in spans}
    for name in ("round.view_build", "round.cost_build", "round.solve_band",
                 "round.assign"):
        assert by_name[name]["parent"] == rid, name
    assert by_name["solve.device"]["parent"] == by_name["round.solve_band"][
        "id"]


def test_stagetimer_is_the_tracer_s_aggregate_mode(monkeypatch):
    monkeypatch.delenv("POSEIDON_STAGE_TIMERS", raising=False)
    monkeypatch.delenv("POSEIDON_TRACE", raising=False)
    stagetimer.reset()
    assert stagetimer.stage("x") is ttrace.NULL_SPAN
    with stagetimer.stage("x"):
        pass
    assert stagetimer.snapshot() == {}
    monkeypatch.setenv("POSEIDON_STAGE_TIMERS", "1")
    for _ in range(3):
        with stagetimer.stage("x", torch.device("cpu")):
            pass
    assert stagetimer.snapshot()["x"][1] == 3
    assert stagetimer.device_snapshot() == {}
    assert "x" in stagetimer.report()
    stagetimer.reset()
    assert stagetimer.snapshot() == {}

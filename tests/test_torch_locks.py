"""The port's TrackedLock/LockLedger against the JAX package's.

Each package keeps its own process-wide lock graph.  The same scripted
interleavings run through both, and the edges, cycles, contention counts
and budget-0 ledger verdicts must be identical.  Lock names are unique per
test so the process-wide graphs diff cleanly.
"""

import threading
import time

import pytest

from poseidon_tpu.utils import locks as jlocks
from poseidon_tpu_torch.utils import locks as tlocks

PACKAGES = pytest.mark.parametrize("L", [jlocks, tlocks], ids=["jax", "torch"])


def _edges(L, prefix):
    return sorted((a, b) for a, b, _ in L.lock_order_edges()
                  if a.startswith(prefix) and b.startswith(prefix))


def _nested(L, outer, inner):
    with outer:
        with inner:
            pass


def _script_order_edges(L, tag):
    """Three locks taken in two nestings, then the opposite order of one
    pair (a cycle), each from its own thread."""
    a = L.TrackedLock(f"{tag}.a")
    b = L.TrackedLock(f"{tag}.b")
    c = L.TrackedLock(f"{tag}.c", reentrant=True)
    for outer, inner in ((a, b), (b, c), (c, a)):
        t = threading.Thread(target=_nested, args=(L, outer, inner))
        t.start()
        t.join()
    with c:
        with c:  # re-entry neither re-edges nor re-times
            pass
    return _edges(L, tag), [x for x in L.lock_cycles() if tag in x]


def test_order_edges_and_cycles_match_reference():
    j_edges, j_cycles = _script_order_edges(jlocks, "lk1")
    t_edges, t_cycles = _script_order_edges(tlocks, "lk1")
    assert t_edges == j_edges == [("lk1.a", "lk1.b"), ("lk1.b", "lk1.c"),
                                  ("lk1.c", "lk1.a")]
    assert len(t_cycles) == len(j_cycles) == 1
    assert t_cycles[0].split(" at ")[0] == j_cycles[0].split(" at ")[0]


def _script_contention(L, tag, waiters):
    """One holder, ``waiters`` threads blocking on it until it lets go."""
    lk = L.TrackedLock(f"{tag}.held")
    started = threading.Barrier(waiters + 1)

    def waiter():
        started.wait()
        with lk:
            pass

    lk.acquire()
    threads = [threading.Thread(target=waiter) for _ in range(waiters)]
    for t in threads:
        t.start()
    started.wait()
    time.sleep(0.05)  # every waiter is parked on the inner lock
    lk.release()
    for t in threads:
        t.join()
    stats = L.per_lock_stats()[f"{tag}.held"]
    return lk.acquisitions, lk.contended, stats


@pytest.mark.parametrize("waiters", [1, 3])
def test_contention_counts_match_reference(waiters):
    j = _script_contention(jlocks, f"lk2w{waiters}", waiters)
    t = _script_contention(tlocks, f"lk2w{waiters}", waiters)
    assert t[:2] == j[:2] == (waiters + 1, waiters)
    assert t[2]["acquisitions"] == j[2]["acquisitions"] == waiters + 1
    assert t[2]["contended"] == j[2]["contended"] == waiters
    assert t[2]["contention_ns"] > 0 and j[2]["contention_ns"] > 0


@PACKAGES
def test_budget_zero_ledger_refuses_a_new_edge(L):
    a = L.TrackedLock("lk3.a")
    b = L.TrackedLock("lk3.b")
    _nested(L, a, b)  # the known edge, before the window
    with L.LockLedger(budget=0, label="warm"):
        _nested(L, a, b)  # known: allowed
    with pytest.raises(L.LockBudgetExceeded, match="lk3.b -> lk3.a"):
        with L.LockLedger(budget=0, label="warm"):
            _nested(L, b, a)


@PACKAGES
def test_budget_zero_ledger_refuses_blocking_under_a_lock(L):
    lk = L.TrackedLock("lk4.a")
    with pytest.raises(L.LockBudgetExceeded, match="sleep"):
        with L.LockLedger(budget=0):
            with lk:
                time.sleep(0.001)
    with L.LockLedger(budget=0):  # the same sleep outside the lock is fine
        time.sleep(0.001)
        with lk:
            pass


@PACKAGES
def test_telemetry_ledger_records_without_asserting(L):
    a = L.TrackedLock("lk5.a")
    b = L.TrackedLock("lk5.b")
    with L.LockLedger(budget=None) as led:
        _nested(L, a, b)
    assert [(x, y) for x, y, _ in led.new_edges] == [("lk5.a", "lk5.b")]


def test_ledger_off_degrades_to_a_bare_delegate(monkeypatch):
    monkeypatch.setenv("POSEIDON_LOCK_LEDGER", "0")
    for L in (jlocks, tlocks):
        lk = L.TrackedLock("lk6.a")
        with lk:
            assert lk.locked()
        assert lk.acquisitions == 0 and "lk6.a" not in L.per_lock_stats()


def test_the_port_names_its_locks_as_the_reference_does():
    from poseidon_tpu_torch.costmodel.delta import CostPlaneCache
    from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel
    from poseidon_tpu_torch.graph.pipeline import CostPipeline
    from poseidon_tpu_torch.service.server import FirmamentServicer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

    cache = CostPlaneCache(CpuMemCostModel())
    servicer = FirmamentServicer(FirmamentTPUConfig(device="cpu"))
    assert cache._ingest_lock.name == "costmodel.CostPlaneCache._ingest_lock"
    assert CostPipeline(cache)._lock.name == "graph.CostPipeline._lock"
    assert servicer._schedule_lock.name == (
        "service.FirmamentServicer._schedule_lock")
    assert servicer._ckpt_write_lock.name == (
        "service.FirmamentServicer._ckpt_write_lock")

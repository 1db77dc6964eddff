"""The port's telemetry plane (obs/) against the JAX package's.

The same observations go into a fresh registry of each package, and the
Prometheus exposition text must be byte-equal; spans export to a Chrome
trace that both validators accept; the round-history ring and the
``MetricsServer`` endpoints answer alike.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from poseidon_tpu.obs import history as jhist
from poseidon_tpu.obs import metrics as jmetrics
from poseidon_tpu.obs import trace as jtrace
from poseidon_tpu_torch.obs import history as thist
from poseidon_tpu_torch.obs import metrics as tmetrics
from poseidon_tpu_torch.obs import trace as ttrace

ROUND = {
    "round_index": 7, "num_tasks": 120, "num_ecs": 5, "num_machines": 40,
    "solve_seconds": 0.125, "total_seconds": 0.5, "objective": 123456,
    "gap_bound": 0.0, "iterations": 321, "placed": 100, "preempted": 2,
    "migrated": 1, "unscheduled": 20, "device_calls": 3, "bf_sweeps": 17,
    "repair_firings": 0, "solve_tier": "pruned", "converged": True,
    "solve_phase_iters": [1, 2, 3, 4], "overlap_fraction": 0.25,
    "admission_deferred": 3, "admission_staleness_s": 0.0125,
}


class _Stats:
    rounds, placed, preempted, migrated = 4, 250, 3, 1
    failed_rounds, consecutive_failures, bind_failures, requeued = 1, 0, 2, 5


def _observe(M, reg):
    c = reg.counter("poseidon_test_total", "a counter", ("kind",))
    c.inc(2.0, "a")
    c.inc(1.5, "b\n\"q\"")
    c.set_total(9.0, "a")
    g = reg.gauge("poseidon_test_gauge", "a gauge")
    g.set(-3.25)
    h = reg.histogram("poseidon_test_seconds", "a histogram", ("op",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, 1.0):
        h.observe(v, "x")
    M.observe_round(dict(ROUND), registry=reg)
    M.observe_round(dict(ROUND, round_index=8, solve_tier="quiet",
                         gap_bound="inf"), registry=reg)
    M.observe_loop(_Stats(), resyncs=2, crash_loop_budget=8,
                   placements_per_sec=12.5, ingest_lag_s=0.75,
                   registry=reg)
    for rpc, code, retried in (("Schedule", "UNAVAILABLE", True),
                               ("TaskSubmitted", "DEADLINE_EXCEEDED", False)):
        M.rpc_attempt(rpc, registry=reg)
        M.rpc_error(rpc, code, retried, registry=reg)
    M.watch_event("pod", "ADDED", registry=reg)
    M.watch_event("node", "MODIFIED", registry=reg)
    return reg.expose()


def test_exposition_text_byte_equal():
    j = _observe(jmetrics, jmetrics.Registry())
    t = _observe(tmetrics, tmetrics.Registry())
    assert t == j
    assert 'poseidon_round_solve_tier{tier="quiet"} 1' in t
    assert "poseidon_loop_rounds_total 4" in t
    assert 'poseidon_client_rpc_retries_total{rpc="Schedule"} 1' in t


def test_observe_ledger_exports_the_lock_series_only():
    """In a process without torch (the glue's), the lock series alone:
    the compile and transfer series are read only once torch is
    imported."""
    code = (
        "import sys\n"
        "from poseidon_tpu_torch.obs import metrics as m\n"
        "reg = m.Registry()\n"
        "m.observe_ledger(registry=reg)\n"
        "assert 'torch' not in sys.modules\n"
        "print(reg.expose())\n"
    )
    text = subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True, cwd=str(Path(__file__).resolve().parents[1]),
    ).stdout
    assert "poseidon_lock_contention_total" in text
    assert "poseidon_lock_order_edges" in text
    assert "poseidon_fresh_compiles_total" not in text
    assert "poseidon_implicit_transfers_total" not in text


def test_observe_ledger_exports_lock_compile_transfer_series():
    """With torch imported, the lock series and the compile and transfer
    ledgers' series, and never the reference's retrace series, which has
    no torch event."""
    import torch  # noqa: F401 - the ledgers' series need torch loaded

    reg = tmetrics.Registry()
    tmetrics.observe_ledger(registry=reg)
    text = reg.expose()
    assert "poseidon_lock_contention_total" in text
    assert "poseidon_lock_order_edges" in text
    assert "poseidon_fresh_compiles_total" in text
    assert "poseidon_implicit_transfers_total" in text
    assert "poseidon_retraces_total" not in text


def _record_spans(T, monkeypatch):
    monkeypatch.setenv("POSEIDON_TRACE", "1")
    tr = T.Tracer()
    with tr.span("glue.try_round", round=1):
        with tr.span("glue.schedule_rpc"):
            with tr.span("rpc.Schedule", attempt=0) as sp:
                sp.set(code="OK", obj=object())
        with tr.span("glue.enact", deltas=3):
            pass
    tr.counter("telem.excess", 5)
    return tr


@pytest.mark.parametrize("T", [jtrace, ttrace], ids=["jax", "torch"])
def test_spans_nest_and_export_a_valid_trace(T, monkeypatch, tmp_path):
    tr = _record_spans(T, monkeypatch)
    spans = tr.spans()
    by_name = {s["name"]: s for s in spans}
    assert by_name["rpc.Schedule"]["parent"] == by_name["glue.schedule_rpc"]["id"]
    assert by_name["glue.enact"]["parent"] == by_name["glue.try_round"]["id"]
    obj = tr.export_chrome_trace(str(tmp_path / "t.json"))
    json.loads((tmp_path / "t.json").read_text())
    # Each package's validator accepts the other's export.
    assert jtrace.validate_chrome_trace(obj) == []
    assert ttrace.validate_chrome_trace(obj) == []
    assert T.counter_tracks(obj) == {"telem.excess": 1}
    assert set(T.span_totals(spans)) == set(tr.snapshot_totals())


def test_validators_agree_on_a_partial_overlap():
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1},
        {"name": "c", "ph": "C", "ts": 1, "pid": 1, "args": {}},
    ]}
    assert ttrace.validate_chrome_trace(bad) == jtrace.validate_chrome_trace(
        bad)
    assert len(ttrace.validate_chrome_trace(bad)) == 2


def test_stage_timer_mode_accumulates_without_recording(monkeypatch):
    monkeypatch.delenv("POSEIDON_TRACE", raising=False)
    monkeypatch.setenv("POSEIDON_STAGE_TIMERS", "1")
    tr = ttrace.Tracer()
    for _ in range(3):
        with tr.span("glue.enact"):
            pass
    assert tr.spans() == []
    assert tr.snapshot_totals()["glue.enact"][1] == 3
    monkeypatch.delenv("POSEIDON_STAGE_TIMERS")
    assert tr.span("x") is ttrace.NULL_SPAN


def _fill_history(H, cap):
    h = H.RoundHistory(capacity=cap)
    for i in range(6):
        h.record(dict(ROUND, round_index=i, placed=10 * i),
                 curves=[{"band": 0, "samples": i}])
    return h


def test_history_ring_matches_reference():
    j, t = _fill_history(jhist, 4), _fill_history(thist, 4)
    assert len(t) == len(j) == 4
    assert t.retained_range() == j.retained_range() == (2, 5)
    strip = [{k: v for k, v in s.items() if k != "age_s"}
             for s in t.summaries()]
    assert strip == [{k: v for k, v in s.items() if k != "age_s"}
                     for s in j.summaries()]
    rt, rj = t.get(3), j.get(3)
    rt.pop("age_s"), rj.pop("age_s")
    assert rt == rj and t.get(0) is None and t.latest()[0] == 5


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_endpoints():
    reg = tmetrics.Registry()
    reg.gauge("poseidon_up", "one").set(1)
    hist = _fill_history(thist, 3)
    srv = tmetrics.MetricsServer("127.0.0.1:0", registry=reg,
                                 history=hist).start()
    try:
        base = f"http://{srv.address}"
        status, text = _get(base + "/metrics")
        assert status == 200 and "poseidon_up 1" in text
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        status, body = _get(base + "/debug/rounds")
        assert json.loads(body)["retained"] == 3
        status, body = _get(base + "/debug/round/5")
        assert status == 200 and json.loads(body)["round"] == 5
        status, body = _get(base + "/debug/round/0")
        assert status == 404 and json.loads(body)["retained_range"] == [3, 5]
        assert _get(base + "/nope")[0] == 404
    finally:
        srv.stop()

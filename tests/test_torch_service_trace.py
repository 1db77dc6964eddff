"""A pod's path through the port's service, as its spans show it.

A real ``FirmamentTPUServer`` on the CPU takes task RPCs over gRPC and a
``Schedule()``: each call leaves one ``rpc.<Method>`` span and one
``rpc.<Method>.queued`` interval carrying its pod, and the round's parts
nest inside ``rpc.Schedule``.  A pod accepted after a round's snapshot
leaves a ``pod.missed_cut`` span once a later round places it; the
collector's pauses leave ``runtime.gc`` spans; a contended tracked lock
a ``lock_wait.<name>`` span.  With both tracer gates unset nothing is
recorded.  The profiler capture carries the program's spans on its own
time base, and a traced churn run of the benchmark on the CPU drops no
span.
"""

import gc
import json
import threading
import time

import grpc
import pytest

from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import profile as obs_profile
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos.services import (
    FIRMAMENT_METHODS,
    FIRMAMENT_SERVICE,
    make_stubs,
)
from poseidon_tpu_torch.service.server import (
    FirmamentServicer,
    FirmamentTPUServer,
)
from poseidon_tpu_torch.utils.config import FirmamentTPUConfig
from poseidon_tpu_torch.utils.ids import generate_uuid
from poseidon_tpu_torch.utils.locks import TrackedLock

GATES = ("POSEIDON_TRACE", "POSEIDON_STAGE_TIMERS")
SUBMITS = 240
COMPLETES = 120


@pytest.fixture
def recording(monkeypatch):
    """Span recording on, an empty tracer, and an empty one after."""
    monkeypatch.setenv("POSEIDON_TRACE", "1")
    obs_trace.reset()
    yield obs_trace.tracer()
    obs_trace.reset()


@pytest.fixture
def gates_off(monkeypatch):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    obs_trace.reset()
    yield obs_trace.tracer()
    obs_trace.reset()


def node(k):
    rtnd = fpb.ResourceTopologyNodeDescriptor()
    rd = rtnd.resource_desc
    rd.uuid = generate_uuid(f"trace-node-{k}")
    rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
    rd.resource_capacity.cpu_cores = 64000.0
    rd.resource_capacity.ram_cap = 1 << 28
    rd.task_capacity = 64
    return rtnd


def task(uid):
    req = fpb.TaskDescription()
    td = req.task_descriptor
    td.uid = uid
    td.job_id = "trace-job"
    td.resource_request.cpu_cores = 100.0
    td.resource_request.ram_cap = 1 << 18
    req.job_descriptor.uuid = "trace-job"
    return req


def uid(k):
    return 1_000_003 * (k + 1)


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def drive_grpc(n_submit=SUBMITS, n_complete=COMPLETES):
    """Machines, ``n_submit`` submissions (as futures, so calls queue),
    a ``Schedule()`` and ``n_complete`` completions, all over gRPC."""
    with FirmamentTPUServer(FirmamentTPUConfig(device="cpu"),
                            address="127.0.0.1:0") as srv, \
            grpc.insecure_channel(srv.address) as ch:
        stub = make_stubs(ch, FIRMAMENT_SERVICE, FIRMAMENT_METHODS)
        for k in range(8):
            assert stub.NodeAdded(node(k)).type == 0
        futs = [stub.TaskSubmitted.future(task(uid(k)))
                for k in range(n_submit)]
        assert all(f.result().type == 1 for f in futs)
        reply = stub.Schedule(fpb.ScheduleRequest())
        assert len(reply.deltas) == n_submit
        futs = [stub.TaskCompleted.future(fpb.TaskUID(task_uid=uid(k)))
                for k in range(n_complete)]
        assert all(f.result().type == 0 for f in futs)
    return reply


def test_each_grpc_call_has_one_span_and_one_queued_interval(recording):
    drive_grpc()
    spans = recording.spans()
    for method, n in (("TaskSubmitted", SUBMITS),
                      ("TaskCompleted", COMPLETES)):
        calls = by_name(spans, f"rpc.{method}")
        queued = by_name(spans, f"rpc.{method}.queued")
        assert len(calls) == len(queued) == n
        want = sorted(uid(k) for k in range(n))
        assert sorted(s["attrs"]["pod"] for s in calls) == want
        assert sorted(s["attrs"]["pod"] for s in queued) == want
        assert all(s["dur"] >= 0 and s.get("async") for s in queued)
        # A call's queue wait ends where its handler starts.
        start = {s["attrs"]["pod"]: s["ts"] for s in calls}
        assert all(q["ts"] + q["dur"] <= start[q["attrs"]["pod"]] + 1e-3
                   for q in queued)
    assert len(by_name(spans, "rpc.NodeAdded")) == 8
    assert len(by_name(spans, "rpc.TaskSubmitted.serialize")) == SUBMITS
    assert recording.dropped == 0


def test_schedule_span_holds_the_round_and_its_service_parts(recording):
    drive_grpc(n_submit=40, n_complete=0)
    spans = recording.spans()
    (sched,) = by_name(spans, "rpc.Schedule")
    assert sched["attrs"]["round"] == 0
    lo, hi = sched["ts"], sched["ts"] + sched["dur"]
    for name in ("round", "service.deltas_to_proto", "service.observe"):
        (s,) = by_name(spans, name)
        assert s["parent"] == sched["id"], name
        assert lo <= s["ts"] and s["ts"] + s["dur"] <= hi, name
        assert s["tid"] == sched["tid"]
    (ser,) = by_name(spans, "rpc.Schedule.serialize")
    assert ser["tid"] == sched["tid"] and ser["ts"] >= hi
    assert obs_trace.validate_chrome_trace(
        obs_trace.chrome_trace(spans)) == []


def _planted_servicer(late):
    """A CPU servicer whose first view build is followed, inside the same
    call, by the submission of ``late``: accepted after the snapshot."""
    svc = FirmamentServicer(FirmamentTPUConfig(device="cpu"))
    st = svc.state
    for k in range(4):
        svc.NodeAdded(node(k), None)
    real = st.build_round_view
    planted = []

    def build_round_view(*a, **kw):
        view = real(*a, **kw)
        if not planted:
            planted.append(svc.TaskSubmitted(task(late), None).type)
        return view

    st.build_round_view = build_round_view
    return svc, planted


def schedule(svc):
    return svc.Schedule(fpb.ScheduleRequest(), None)


def test_pod_accepted_after_the_snapshot_records_a_missed_cut(recording):
    svc, planted = _planted_servicer(uid(1))
    svc.TaskSubmitted(task(uid(0)), None)
    hist = obs_metrics.default_registry().histogram(
        "poseidon_pod_wait_seconds")
    waits0 = hist.labels()
    n0 = waits0.count
    assert [d.task_id for d in schedule(svc).deltas] == [uid(0)]
    assert planted == [1]
    # The round after is quiet: the pod accepted after the snapshot waits
    # for the next mutation (PERF.md §7 item 1), which this test makes.
    assert len(schedule(svc).deltas) == 0
    svc.TaskSubmitted(task(uid(2)), None)
    placed = sorted(d.task_id for d in schedule(svc).deltas)
    assert placed == [uid(1), uid(2)]
    (missed,) = by_name(recording.spans(), "pod.missed_cut")
    assert missed["attrs"] == {"pod": uid(1), "submitted_round": 0,
                               "placed_round": 2}
    assert missed["dur"] > 0 and missed.get("async")
    assert waits0.count - n0 == 3


def test_gates_unset_record_nothing(gates_off, monkeypatch):
    made = []
    init = obs_trace.Span.__init__

    def counting(self, *a, **kw):
        made.append(a[0] if a else None)
        init(self, *a, **kw)

    monkeypatch.setattr(obs_trace.Span, "__init__", counting)
    drive_grpc(n_submit=30, n_complete=10)
    assert made == []
    assert gates_off.span("x") is obs_trace.NULL_SPAN
    assert gates_off.record("x", 1.0, 2.0) is None
    assert gates_off.spans() == [] and gates_off.snapshot_totals() == {}


def test_forced_collection_records_one_runtime_gc_span(recording):
    counter = obs_metrics.default_registry().counter(
        "poseidon_gc_pause_seconds_total", labelnames=("generation",))
    before = counter.value(2)
    was = gc.isenabled()
    gc.disable()  # no automatic collection inside the window
    try:
        obs_trace.reset()
        gc.collect()
        spans = by_name(recording.spans(), "runtime.gc")
    finally:
        if was:
            gc.enable()
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"generation": 2} and spans[0]["dur"] > 0
    assert not spans[0].get("async")
    assert counter.value(2) > before


def test_collector_counter_runs_with_the_gates_unset(gates_off):
    counter = obs_metrics.default_registry().counter(
        "poseidon_gc_pause_seconds_total", labelnames=("generation",))
    before = counter.value(2)
    gc.collect()
    assert counter.value(2) > before
    assert gates_off.spans() == []
    assert "poseidon_gc_pause_seconds_total" in \
        obs_metrics.default_registry().expose()


@pytest.mark.parametrize("recorded", [2, 5, 9])
def test_record_obeys_the_cap_and_counts_drops(recorded):
    tr = obs_trace.Tracer(max_spans=5)
    tr.force = True
    t = time.perf_counter()
    for k in range(recorded):
        tr.record("rec", t + k, t + k + 0.5, n=k)
    assert len(tr.spans()) == min(recorded, 5)
    assert tr.dropped == max(0, recorded - 5)
    assert tr.snapshot_totals()["rec"] == (0.5 * recorded, recorded)
    assert [s["attrs"]["n"] for s in tr.spans()] == list(
        range(min(recorded, 5)))


def test_recorded_intervals_export_as_async_slices():
    tr = obs_trace.Tracer()
    tr.force = True
    t = time.perf_counter()
    with tr.span("outer"):
        tr.record("waited", t - 1.0, t + 0.001, pod=7)
        tr.record("pause", t, t + 0.0001, nested=True)
    obj = tr.export_chrome_trace()
    assert obs_trace.validate_chrome_trace(obj) == []
    phases = sorted(e["ph"] for e in obj["traceEvents"]
                    if e.get("name") == "waited")
    assert phases == ["b", "e"]
    assert [e["ph"] for e in obj["traceEvents"]
            if e.get("name") == "pause"] == ["X"]
    lone = {"traceEvents": [{"name": "w", "cat": "c", "ph": "b", "id": 1,
                             "ts": 0, "pid": 1, "tid": 1}]}
    assert len(obs_trace.validate_chrome_trace(lone)) == 1


def test_contended_lock_records_its_wait(recording):
    lk = TrackedLock("trace_test.held")
    lk.acquire()
    t = threading.Thread(target=lambda: lk.acquire() or lk.release())
    t.start()
    time.sleep(0.05)
    lk.release()
    t.join(timeout=10)
    assert not t.is_alive()
    (wait,) = by_name(recording.spans(), "lock_wait.trace_test.held")
    assert 0.03 < wait["dur"] < 5 and not wait.get("async")
    assert not [s for s in recording.spans()
                if s["name"] == "lock_wait.obs.Tracer._lock"]


def test_state_lock_is_tracked():
    svc = FirmamentServicer(FirmamentTPUConfig(device="cpu"))
    assert svc.state._lock.name == "graph.ClusterState._lock"


def test_profile_capture_aligns_spans_with_the_profiler(recording,
                                                        tmp_path):
    from torch.profiler import record_function

    obs_profile._reset_for_tests()
    svc = FirmamentServicer(FirmamentTPUConfig(device="cpu",
                                               profile_dir=str(tmp_path)))
    for k in range(4):
        svc.NodeAdded(node(k), None)
    for k in range(20):
        svc.TaskSubmitted(task(uid(k)), None)
    inner = svc.planner.schedule_round

    def marked():
        with record_function("test.round"):
            return inner()

    svc.planner.schedule_round = marked
    assert len(schedule(svc).deltas) == 20
    path = tmp_path / "round_000000" / obs_profile.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    (mark,) = [e for e in events
               if e.get("name") == "test.round" and e.get("ph") == "X"]
    (rnd,) = [e for e in events if e.get("name") == "round"
              and e.get("cat") == "poseidon"]
    lo = max(float(mark["ts"]), float(rnd["ts"]))
    hi = min(float(mark["ts"]) + float(mark["dur"]),
             float(rnd["ts"]) + float(rnd["dur"]))
    assert hi - lo > 0.5 * float(rnd["dur"])


def test_traced_churn_run_drops_no_span(tmp_path, monkeypatch):
    from portbench import harness
    from portbench.tests.conftest import make_root

    for g in GATES:
        monkeypatch.setenv(g, "0")
    obs_trace.reset()
    root = make_root(tmp_path / "checkout")
    res = harness.run_cell("northstar-10k.churn", 3100000007, 2.0, True,
                           device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert obs_trace.tracer().dropped == 0
    for name in ("rpc_queue_ms.stream", "submit_handler_ms.stream"):
        assert res["metrics"][name]["value"] >= 0

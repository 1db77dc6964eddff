"""The port's glue process against the JAX package's, end to end.

Each scenario of ``tests/test_glue.py`` (bare pod, owner grouping,
unschedulable pod, node selector, node failure and recovery, spec
update, completion, deletion, restart recovery, stats, preemption) runs
twice: JAX glue against the JAX server, and port glue against the port
server (``device="cpu"``).  Every round records the deltas, the kube
truth (each pod's phase and node), ``LoopStats`` and the planner's
``admission_deferred``, and the two records must be identical, in the
synchronous loop and under ``POSEIDON_STREAMING=1``.  The watchers run
one worker each, so both packages see the events in one order.
"""

import dataclasses
import os
from contextlib import contextmanager
from types import SimpleNamespace

import grpc
import pytest

import poseidon_tpu.glue as jglue
import poseidon_tpu_torch.glue as tglue
from poseidon_tpu.glue.metrics_agent import MetricsAgent as JMetricsAgent
from poseidon_tpu.service import FirmamentTPUServer as JServer
from poseidon_tpu.utils.config import PoseidonConfig as JPoseidonConfig
from poseidon_tpu_torch.glue.metrics_agent import MetricsAgent
from poseidon_tpu_torch.protos import stats_pb2 as spb
from poseidon_tpu_torch.protos.services import (
    STATS_METHODS,
    STATS_SERVICE,
    make_stubs,
)
from poseidon_tpu_torch.service.server import FirmamentTPUServer
from poseidon_tpu_torch.utils.config import FirmamentTPUConfig, PoseidonConfig

JAX = SimpleNamespace(
    name="jax", FakeKube=jglue.FakeKube, Node=jglue.Node, Pod=jglue.Pod,
    Poseidon=jglue.Poseidon, Config=JPoseidonConfig,
    MetricsAgent=JMetricsAgent,
    server=lambda: JServer(address="127.0.0.1:0"),
)
PORT = SimpleNamespace(
    name="torch", FakeKube=tglue.FakeKube, Node=tglue.Node, Pod=tglue.Pod,
    Poseidon=tglue.Poseidon, Config=PoseidonConfig,
    MetricsAgent=MetricsAgent,
    server=lambda: FirmamentTPUServer(FirmamentTPUConfig(device="cpu"),
                                      address="127.0.0.1:0"),
)
MB = 1 << 20


@contextmanager
def glue_for(P, kube, server, stats=True):
    cfg = P.Config(firmament_address=server.address, scheduling_interval=3600)
    glue = P.Poseidon(kube, config=cfg, run_loop=False,
                      stats_address="127.0.0.1:0" if stats else None)
    glue.pod_watcher.workers = 1
    glue.node_watcher.workers = 1
    glue.start(health_timeout=10)
    try:
        yield glue
    finally:
        glue.stop()


class System:
    """One package's server + FakeKube + glue, and the round record."""

    def __init__(self, P, kube, server, glue):
        self.P, self.kube, self.server, self.glue = P, kube, server, glue
        self.record = []

    def drain(self):
        assert self.glue.drain_watchers(timeout=20)

    def round(self):
        self.drain()
        deltas = self.glue.schedule_once()
        assert self.glue.drain_rounds(timeout=20)
        assert not self.glue.enact_failed()
        # The streaming leg enacts on the engine's worker, the
        # synchronous one on this thread.
        streaming = os.environ.get("POSEIDON_STREAMING") == "1"
        assert (self.glue._enact_pool is not None) == streaming
        self.drain()
        m = self.server.servicer.planner.last_metrics
        assert 0.0 <= m.overlap_fraction <= 1.0
        assert m.admission_staleness_s >= 0.0
        self.note(
            deltas=[(d.type, d.task_id, d.resource_id) for d in deltas],
            truth=self.truth(),
            stats=dataclasses.asdict(self.glue.loop_stats),
            deferred=m.admission_deferred,
            tier=m.solve_tier,
        )
        return deltas

    def truth(self):
        return sorted((p.key, p.phase, p.node_name)
                      for p in self.kube.pods.values())

    def note(self, **kw):
        self.record.append(kw)

    def task(self, pod_key):
        uid = self.glue.shared.uid_for_pod(pod_key)
        return None if uid is None else self.server.servicer.state.tasks[uid]


@contextmanager
def system(P):
    with P.server() as server:
        kube = P.FakeKube()
        with glue_for(P, kube, server) as glue:
            yield System(P, kube, server, glue)


def node(S, name, cpu=4000, ram=16 * MB, **kw):
    S.kube.add_node(S.P.Node(name=name, cpu_capacity=cpu, ram_capacity=ram,
                             **kw))


def pod(S, name, cpu=100, ram=MB // 4, **kw):
    S.kube.create_pod(S.P.Pod(name=name, cpu_request=cpu, ram_request=ram,
                              **kw))


# ------------------------------------------------------------- scenarios


def bare_pod(S):
    node(S, "n1")
    pod(S, "p1", ram=MB)
    S.round()
    assert S.kube.bindings == [("default/p1", "n1")]


def owner_grouping(S):
    for i in range(3):
        node(S, f"n{i}")
    for i in range(6):
        pod(S, f"web-{i}", cpu=500, ram=MB, owner_uid="rs-uid-1")
    S.round()
    assert len(S.kube.bindings) == 6


def unschedulable_pod(S):
    node(S, "small", cpu=1000, ram=MB)
    pod(S, "fits", cpu=500)
    pod(S, "huge", cpu=64000, ram=1 << 30)
    S.round()
    S.round()
    assert S.kube.pods["default/huge"].phase == "Pending"


def node_selector(S):
    node(S, "ssd-node", labels={"disktype": "ssd"})
    node(S, "hdd-node")
    node(S, "cordoned", unschedulable=True)
    pod(S, "picky", node_selector={"disktype": "ssd"})
    pod(S, "impossible", node_selector={"disktype": "nvme"})
    pod(S, "any")
    S.round()
    assert ("default/picky", "ssd-node") in S.kube.bindings
    assert ("default/any", "cordoned") not in S.kube.bindings


def node_failure_and_recovery(S):
    node(S, "n1")
    pod(S, "p", owner_uid="job-1")
    S.round()
    node(S, "n2")
    S.kube.update_node("n1", lambda n: setattr(n, "ready", False))
    S.round()
    assert ("default/p", "n2") in S.kube.bindings
    S.kube.update_node("n1", lambda n: setattr(n, "ready", True))
    pod(S, "q", cpu=3950)
    S.round()
    assert S.kube.pods["default/q"].node_name == "n1"


def spec_update(S):
    node(S, "n1")
    pod(S, "p")
    S.round()
    S.kube.update_pod("default/p", lambda p: setattr(p, "cpu_request", 3500))
    S.drain()
    S.note(cpu=S.task("default/p").cpu_request)
    pod(S, "q", cpu=1000)
    S.round()
    assert S.record[-2]["cpu"] == 3500


def completion(S):
    node(S, "n1", cpu=1000)
    pod(S, "p1")
    S.round()
    S.kube.set_pod_phase("default/p1", "Succeeded")
    S.drain()
    S.note(uid=S.glue.shared.uid_for_pod("default/p1"))
    assert S.round() == []


def deletion(S):
    node(S, "n1", cpu=1000)
    pod(S, "p1")
    pod(S, "p2")
    S.round()
    S.kube.delete_pod("default", "p1")
    assert S.round() == []
    assert S.glue.shared.uid_for_pod("default/p1") is None


def stats(S):
    node(S, "hot")
    node(S, "cold")
    S.drain()
    channel = grpc.insecure_channel(S.glue.stats_server.address)
    stubs = make_stubs(channel, STATS_SERVICE, STATS_METHODS)
    replies = list(stubs.ReceiveNodeStats(iter(
        [spb.NodeStats(hostname="hot", cpu_utilization=0.95,
                       mem_utilization=0.95) for _ in range(4)]
        + [spb.NodeStats(hostname="nope", cpu_utilization=0.1)])))
    pod_replies = list(stubs.ReceivePodStats(
        iter([spb.PodStats(name="x", namespace="y")])))
    channel.close()
    S.note(node_replies=[r.type for r in replies],
           pod_replies=[r.type for r in pod_replies])
    pod(S, "p")
    S.round()
    assert S.kube.bindings == [("default/p", "cold")]

    def source():
        return ([spb.NodeStats(hostname="cold", cpu_utilization=0.7,
                               mem_utilization=0.6)],
                [spb.PodStats(name="p", namespace="default", cpu_usage=90,
                              mem_usage=MB // 8)])

    agent = S.P.MetricsAgent(source, S.glue.stats_server.address)
    try:
        S.note(pushed=agent.push_once())
    finally:
        agent.stop()
    st = S.server.servicer.state
    S.note(util=sorted((m.cpu_util, m.mem_util) for m in st.machines.values()),
           task_kb=sum(len(e.samples) for e in st.task_kb.values()))
    pod(S, "q")
    S.round()


def preemption(S):
    S.kube.recreate_on_delete = True
    node(S, "n1", cpu=1000)
    pod(S, "p", cpu=800, owner_uid="rs-1")
    S.round()
    S.kube.delete_pod("default", "p")
    S.drain()
    clones = sorted(k for k in S.kube.pods if k != "default/p")
    S.note(clones=clones)
    S.round()
    assert S.kube.pods[clones[0]].phase == "Running"


SCENARIOS = [bare_pod, owner_grouping, unschedulable_pod, node_selector,
             node_failure_and_recovery, spec_update, completion, deletion,
             stats, preemption]


def _run(P, scenario):
    with system(P) as S:
        scenario(S)
        return S.record


@pytest.fixture(params=["sync", "streaming"])
def leg(request, monkeypatch):
    if request.param == "streaming":
        monkeypatch.setenv("POSEIDON_STREAMING", "1")
    else:
        monkeypatch.delenv("POSEIDON_STREAMING", raising=False)
    return request.param


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(leg, scenario):
    j = _run(JAX, scenario)
    t = _run(PORT, scenario)
    assert t == j
    assert any("deltas" in r for r in t)


def _restart(P):
    """Full restart of both processes against a cluster whose pod is
    already bound: the new service adopts the carried binding."""
    record = []
    kube = P.FakeKube()
    kube.add_node(P.Node(name="n1", cpu_capacity=1000, ram_capacity=16 * MB))
    with P.server() as server1, glue_for(P, kube, server1, stats=False) as g:
        S = System(P, kube, server1, g)
        pod(S, "p", cpu=900)
        S.round()
        record += S.record
    with P.server() as server2, glue_for(P, kube, server2, stats=False) as g:
        S = System(P, kube, server2, g)
        S.drain()
        S.note(adopted=S.task("default/p").scheduled_to is not None)
        pod(S, "q", cpu=900)
        S.round()
        record += S.record
    assert kube.pods["default/q"].phase == "Pending"
    return record


def test_restart_recovery_matches_reference(leg):
    assert _restart(PORT) == _restart(JAX)


def test_streaming_metrics_fields_match_reference(monkeypatch):
    """Under streaming, an arrival after the round's admission cut counts
    as deferred in both packages (and is admitted by the next cut), and
    the realized staleness is stamped on both sides."""
    monkeypatch.setenv("POSEIDON_STREAMING", "1")
    out = []
    for P in (JAX, PORT):
        with system(P) as S:
            node(S, "n1")
            pod(S, "p1")
            S.drain()
            state = S.server.servicer.state
            planner = S.server.servicer.planner
            real = state.take_ingest_hints

            def late_arrival():
                # A mutation that lands just after the admission cut.
                with state._lock:
                    state.generation += 1
                return real()

            state.take_ingest_hints = late_arrival
            S.glue.schedule_once()
            S.glue.drain_rounds(timeout=20)
            m = planner.last_metrics
            state.take_ingest_hints = real
            admitted, _ = state.admission_cut()
            out.append((m.admission_deferred, admitted, m.placed,
                        m.admission_staleness_s > 0.0,
                        sorted(f.name for f in dataclasses.fields(m)
                               if f.name in ("overlap_fraction",
                                             "admission_deferred",
                                             "admission_staleness_s"))))
    assert out[0] == out[1]
    assert out[1][:4] == (1, 1, 1, True)

"""The port's FirmamentClient against the JAX package's.

A scripted servicer answers each RPC attempt with a status code or a
reply.  Both clients run the same scripts: the attempts the servicer
sees, the replies, the errors raised, ``schedule_retried`` and the
client-side metric counts must be identical.  Then a reply larger than
gRPC's 4 MB default arrives through the port's client.
"""

from concurrent import futures

import grpc
import pytest

from poseidon_tpu.obs import metrics as jmetrics
from poseidon_tpu.service import client as jclient
from poseidon_tpu_torch.obs import metrics as tmetrics
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos.services import (
    FIRMAMENT_METHODS,
    FIRMAMENT_SERVICE,
    generic_handler,
)
from poseidon_tpu_torch.service import client as tclient

U, D, OK = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED,
            "ok")


class ScriptedServicer:
    """Pops one scripted outcome per attempt: a StatusCode aborts the
    attempt, anything else answers with the RPC's normal reply."""

    def __init__(self):
        self.script = []
        self.seen = []
        self.deltas = 0

    def _next(self, rpc, context):
        self.seen.append(rpc)
        step = self.script.pop(0) if self.script else OK
        if isinstance(step, grpc.StatusCode):
            context.abort(step, f"scripted {step.name}")
        return step

    def Schedule(self, request, context):
        self._next("Schedule", context)
        out = fpb.SchedulingDeltas()
        for i in range(self.deltas):
            out.deltas.add(task_id=1_000_000_007 * (i + 1),
                           resource_id=f"{i:08x}-0000-4000-8000-000000000000",
                           type=fpb.SchedulingDelta.PLACE)
        return out

    def TaskSubmitted(self, request, context):
        step = self._next("TaskSubmitted", context)
        return fpb.TaskSubmittedResponse(
            type=fpb.TASK_STATE_NOT_CREATED if step == "fatal"
            else fpb.TASK_SUBMITTED_OK)

    def TaskRemoved(self, request, context):
        self._next("TaskRemoved", context)
        return fpb.TaskRemovedResponse(type=fpb.TASK_REMOVED_OK)

    def Check(self, request, context):
        step = self._next("Check", context)
        return fpb.HealthCheckResponse(
            status=fpb.NOT_SERVING if step == "down" else fpb.SERVING)

    def __getattr__(self, name):
        if name in FIRMAMENT_METHODS:
            def unary(request, context):
                self._next(name, context)
                return FIRMAMENT_METHODS[name].response_cls()
            return unary
        raise AttributeError(name)


@pytest.fixture(scope="module")
def service():
    servicer = ScriptedServicer()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers(
        (generic_handler(FIRMAMENT_SERVICE, FIRMAMENT_METHODS, servicer),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    yield servicer, f"127.0.0.1:{port}"
    server.stop(0).wait()


def _counter(reg, name, *labels):
    return reg.counter(name, "", ("rpc",) if len(labels) == 1 else
                       ("rpc", "code")).value(*labels)


def _run(C, M, servicer, address, script, call):
    """Run one scripted call; returns what the servicer saw, the outcome
    and the client-side counters it moved."""
    servicer.script = list(script)
    servicer.seen = []
    reg = M.default_registry()
    before = (_counter(reg, "poseidon_client_rpc_attempts_total", "Schedule"),
              _counter(reg, "poseidon_client_rpc_attempts_total",
                       "TaskSubmitted"))
    client = C.FirmamentClient(address, rpc_timeout_s=10, rpc_retries=2,
                               rpc_backoff_s=0.001, retry_seed=7)
    try:
        out = ("ok", call(client))
    except grpc.RpcError as e:
        out = ("rpc", C.rpc_code(e).name)
    except C.FatalReplyError as e:
        out = ("fatal", e.rpc, e.reply)
    finally:
        retried = client.schedule_retried
        client.close()
    after = (_counter(reg, "poseidon_client_rpc_attempts_total", "Schedule"),
             _counter(reg, "poseidon_client_rpc_attempts_total",
                      "TaskSubmitted"))
    moved = tuple(a - b for a, b in zip(after, before))
    return list(servicer.seen), out, retried, moved, servicer.script


def _schedule(c):
    return len(c.schedule())


def _submit(c):
    return c.task_submitted(fpb.TaskDescriptor(uid=5, name="t", job_id="j"))


SCRIPTS = [
    ("schedule_clean", [OK], _schedule),
    ("schedule_retries_unavailable", [U, U, OK], _schedule),
    ("schedule_exhausts_unavailable", [U, U, U, OK], _schedule),
    ("schedule_never_retries_deadline", [D, OK], _schedule),
    ("submit_retries_deadline", [D, U, OK], _submit),
    ("submit_exhausts", [D, D, D], _submit),
    ("submit_fatal_reply", ["fatal"], _submit),
    ("removed_not_retried_on_internal", [grpc.StatusCode.INTERNAL],
     lambda c: c.task_removed(5)),
    ("check_never_retries", [U], lambda c: c.check()),
]


@pytest.mark.parametrize("script,call", [s[1:] for s in SCRIPTS],
                         ids=[s[0] for s in SCRIPTS])
def test_attempt_sequences_match_reference(service, script, call):
    servicer, address = service
    j = _run(jclient, jmetrics, servicer, address, script, call)
    t = _run(tclient, tmetrics, servicer, address, script, call)
    assert t == j


def test_wait_for_service_matches_reference(service):
    servicer, address = service
    outcomes = []
    for C in (jclient, tclient):
        servicer.script = [U, "down", OK]
        servicer.seen = []
        client = C.FirmamentClient(address)
        try:
            outcomes.append((client.wait_for_service(timeout=10,
                                                     poll_interval=0.01),
                             list(servicer.seen)))
            servicer.script = [grpc.StatusCode.UNIMPLEMENTED]
            with pytest.raises(grpc.RpcError):
                client.wait_for_service(timeout=10, poll_interval=0.01)
        finally:
            client.close()
    assert outcomes[0] == outcomes[1] == (True, ["Check"] * 3)


def test_reply_larger_than_4mb_arrives(service):
    servicer, address = service
    servicer.deltas = 150_000
    try:
        reply = fpb.SchedulingDeltas()
        reply.deltas.add(task_id=1, resource_id="x" * 44, type=1)
        assert reply.ByteSize() * servicer.deltas > 4 << 20
        with tclient.FirmamentClient(address) as c:
            deltas = c.schedule()
        assert len(deltas) == 150_000
        assert deltas[-1].task_id == 1_000_000_007 * 150_000
        # The JAX package's client keeps gRPC's default receive limit and
        # cannot take this reply (a documented reference gap).
        with jclient.FirmamentClient(address, rpc_retries=0) as c:
            with pytest.raises(grpc.RpcError) as err:
                c.schedule()
        assert jclient.rpc_code(err.value) == (
            grpc.StatusCode.RESOURCE_EXHAUSTED)
    finally:
        servicer.deltas = 0

"""Hand-written gRPC method tables for the two services in the contract.

The image has protoc but not the grpc Python codegen plugin, so instead of
generated ``*_pb2_grpc.py`` stubs we describe each service as a method table
and build servers (``grpc.method_handlers_generic_handler``) and clients
(``channel.unary_unary`` / ``channel.stream_stream``) from it.  The resulting
wire behavior is identical to generated stubs: method paths are
``/<package>.<Service>/<Method>`` with protobuf (de)serialization.

Reference service definitions: pkg/firmament/firmament_scheduler.proto:15-45
and pkg/stats/poseidonstats.proto:22-25.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos import poseidonstats_pb2 as spb


@dataclass(frozen=True)
class MethodSpec:
    name: str
    request_cls: Any
    response_cls: Any
    # One of: "unary_unary", "stream_stream".
    arity: str = "unary_unary"


FIRMAMENT_SERVICE = "firmament.FirmamentScheduler"

FIRMAMENT_METHODS: Dict[str, MethodSpec] = {
    m.name: m
    for m in [
        MethodSpec("Schedule", fpb.ScheduleRequest, fpb.SchedulingDeltas),
        MethodSpec("TaskCompleted", fpb.TaskUID, fpb.TaskCompletedResponse),
        MethodSpec("TaskFailed", fpb.TaskUID, fpb.TaskFailedResponse),
        MethodSpec("TaskRemoved", fpb.TaskUID, fpb.TaskRemovedResponse),
        MethodSpec("TaskSubmitted", fpb.TaskDescription, fpb.TaskSubmittedResponse),
        MethodSpec("TaskUpdated", fpb.TaskDescription, fpb.TaskUpdatedResponse),
        MethodSpec(
            "NodeAdded", fpb.ResourceTopologyNodeDescriptor, fpb.NodeAddedResponse
        ),
        MethodSpec("NodeFailed", fpb.ResourceUID, fpb.NodeFailedResponse),
        MethodSpec("NodeRemoved", fpb.ResourceUID, fpb.NodeRemovedResponse),
        MethodSpec(
            "NodeUpdated", fpb.ResourceTopologyNodeDescriptor, fpb.NodeUpdatedResponse
        ),
        MethodSpec("AddTaskStats", fpb.TaskStats, fpb.TaskStatsResponse),
        MethodSpec("AddNodeStats", fpb.ResourceStats, fpb.ResourceStatsResponse),
        MethodSpec("Check", fpb.HealthCheckRequest, fpb.HealthCheckResponse),
    ]
}

STATS_SERVICE = "stats.PoseidonStats"

STATS_METHODS: Dict[str, MethodSpec] = {
    m.name: m
    for m in [
        MethodSpec(
            "ReceiveNodeStats", spb.NodeStats, spb.NodeStatsResponse, "stream_stream"
        ),
        MethodSpec(
            "ReceivePodStats", spb.PodStats, spb.PodStatsResponse, "stream_stream"
        ),
    ]
}


# The pod a task RPC's request names: its spans carry it as ``pod``.
_POD_OF: Dict[str, Callable[[Any], int]] = {
    "TaskSubmitted": lambda r: r.task_descriptor.uid,
    "TaskUpdated": lambda r: r.task_descriptor.uid,
    "TaskCompleted": lambda r: r.task_uid,
    "TaskFailed": lambda r: r.task_uid,
    "TaskRemoved": lambda r: r.task_uid,
}

# The time the server handed the call now running on this thread to its
# pool (``stamped``); None on a thread no stamping pool runs.
_CALL = threading.local()


def stamped(t_submit: float, fn, args, kwargs):
    """Run one of the server pool's work items, ``fn(*args, **kwargs)``,
    with ``t_submit``, the time the server submitted it, on record for
    the handler (``service/server.py``'s pool submits through this)."""
    _CALL.submitted = t_submit
    return fn(*args, **kwargs)


def _traced_handler(name: str, fn):
    """``fn`` under a span ``rpc.<name>`` from the handler's start to its
    return, after a ``rpc.<name>.queued`` interval from the pool's
    submission to that start (the pool's queue and the request's
    receipt).  Task RPCs' spans carry ``pod``.  With the tracer's gates
    off: one probe."""
    tracer = _trace.tracer()
    span_name, queued_name = f"rpc.{name}", f"rpc.{name}.queued"
    pod_of = _POD_OF.get(name)

    def handler(request, context):
        if not tracer.gated():
            return fn(request, context)
        t_start = time.perf_counter()
        attrs = {"pod": int(pod_of(request))} if pod_of else {}
        t_submit: Optional[float] = getattr(_CALL, "submitted", None)
        if t_submit is not None:
            tracer.record(queued_name, t_submit, t_start, **attrs)
        with tracer.span(span_name, **attrs):
            return fn(request, context)

    return handler


def _traced_serializer(name: str, serialize):
    """The response's encoding, which grpc runs on the pool thread after
    the handler returns, under a span ``rpc.<name>.serialize``."""
    tracer = _trace.tracer()
    span_name = f"rpc.{name}.serialize"

    def serializer(response) -> bytes:
        with tracer.span(span_name):
            return serialize(response)

    return serializer


def generic_handler(service_name: str, methods: Dict[str, MethodSpec], servicer: Any):
    """Build a grpc generic handler binding ``servicer.<Method>`` for each
    method.  Unary methods are traced (``_traced_handler``,
    ``_traced_serializer``): calls that arrive over gRPC record their
    spans, calls made on the servicer in-process none."""
    import grpc

    handlers = {}
    for name, spec in methods.items():
        fn = getattr(servicer, name)
        if spec.arity == "unary_unary":
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                _traced_handler(name, fn),
                request_deserializer=spec.request_cls.FromString,
                response_serializer=_traced_serializer(
                    name, spec.response_cls.SerializeToString),
            )
        elif spec.arity == "stream_stream":
            handlers[name] = grpc.stream_stream_rpc_method_handler(
                fn,
                request_deserializer=spec.request_cls.FromString,
                response_serializer=spec.response_cls.SerializeToString,
            )
        else:  # pragma: no cover - contract has only these two arities
            raise ValueError(f"unsupported arity {spec.arity}")
    return grpc.method_handlers_generic_handler(service_name, handlers)


def make_stubs(channel, service_name: str, methods: Dict[str, MethodSpec]):
    """Build a namespace of callables over ``channel``, one per method."""
    import types

    ns = types.SimpleNamespace()
    for name, spec in methods.items():
        path = f"/{service_name}/{name}"
        if spec.arity == "unary_unary":
            stub = channel.unary_unary(
                path,
                request_serializer=spec.request_cls.SerializeToString,
                response_deserializer=spec.response_cls.FromString,
            )
        else:
            stub = channel.stream_stream(
                path,
                request_serializer=spec.request_cls.SerializeToString,
                response_deserializer=spec.response_cls.FromString,
            )
        setattr(ns, name, stub)
    return ns

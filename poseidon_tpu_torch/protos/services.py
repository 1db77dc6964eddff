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

from dataclasses import dataclass
from typing import Any, Dict

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


def generic_handler(service_name: str, methods: Dict[str, MethodSpec], servicer: Any):
    """Build a grpc generic handler binding ``servicer.<Method>`` for each method."""
    import grpc

    handlers = {}
    for name, spec in methods.items():
        fn = getattr(servicer, name)
        if spec.arity == "unary_unary":
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=spec.request_cls.FromString,
                response_serializer=spec.response_cls.SerializeToString,
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

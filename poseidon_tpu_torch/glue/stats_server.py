"""PoseidonStats gRPC server: Heapster-style metrics -> Firmament knowledge base.

Re-creates the reference's stats service (pkg/stats/stats.go:33-178): a
bidi-streaming gRPC server receives NodeStats/PodStats from the metrics
sink, converts them to Firmament ResourceStats/TaskStats, joins them to
task/resource ids through the shared maps, and forwards them via
AddTaskStats/AddNodeStats.  Unknown pods/nodes answer NOT_FOUND on the
stream and are dropped (stats.go:89-91,132-134).
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import grpc

from poseidon_tpu_torch.glue.types import SharedState
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos import stats_pb2 as spb
from poseidon_tpu_torch.protos.services import (
    STATS_METHODS,
    STATS_SERVICE,
    generic_handler,
)
from poseidon_tpu_torch.service.client import FirmamentClient

log = logging.getLogger("poseidon.stats")


def node_stats_to_resource_stats(
    ns: spb.NodeStats, resource_uuid: str
) -> fpb.ResourceStats:
    """NodeStats -> ResourceStats (stats.go:33-54)."""
    rs = fpb.ResourceStats(
        resource_id=resource_uuid,
        timestamp=ns.timestamp,
        mem_allocatable=ns.mem_allocatable,
        mem_capacity=ns.mem_capacity,
        mem_reservation=ns.mem_reservation,
        mem_utilization=ns.mem_utilization,
    )
    rs.cpus_stats.add(
        cpu_allocatable=ns.cpu_allocatable,
        cpu_capacity=ns.cpu_capacity,
        cpu_reservation=ns.cpu_reservation,
        cpu_utilization=ns.cpu_utilization,
    )
    return rs


def pod_stats_to_task_stats(ps: spb.PodStats, task_id: int) -> fpb.TaskStats:
    """PodStats -> TaskStats, field-for-field (stats.go:56-75)."""
    # PodStats carries no timestamp (poseidonstats.proto:38-66); the
    # TaskStats one is left at its default, as in the reference's
    # conversion (stats.go:56-75).
    return fpb.TaskStats(
        task_id=task_id,
        hostname=ps.hostname,
        cpu_limit=ps.cpu_limit,
        cpu_request=ps.cpu_request,
        cpu_usage=ps.cpu_usage,
        mem_limit=ps.mem_limit,
        mem_request=ps.mem_request,
        mem_usage=ps.mem_usage,
        mem_rss=ps.mem_rss,
        mem_cache=ps.mem_cache,
        mem_working_set=ps.mem_working_set,
        mem_page_faults=ps.mem_page_faults,
        mem_page_faults_rate=ps.mem_page_faults_rate,
        major_page_faults=ps.major_page_faults,
        major_page_faults_rate=ps.major_page_faults_rate,
        net_rx=ps.net_rx,
        net_rx_errors=ps.net_rx_errors,
        net_rx_errors_rate=ps.net_rx_errors_rate,
        net_rx_rate=ps.net_rx_rate,
        net_tx=ps.net_tx,
        net_tx_errors=ps.net_tx_errors,
        net_tx_errors_rate=ps.net_tx_errors_rate,
        net_tx_rate=ps.net_tx_rate,
    )


class StatsServicer:
    def __init__(self, shared: SharedState, firmament: FirmamentClient) -> None:
        self.shared = shared
        self.fc = firmament

    def ReceiveNodeStats(self, request_iterator, context):
        for ns in request_iterator:
            uuid = self.shared.resource_for_node(ns.hostname)
            if uuid is None:
                yield spb.NodeStatsResponse(
                    type=spb.NODE_NOT_FOUND, hostname=ns.hostname
                )
                continue
            self.fc.add_node_stats(node_stats_to_resource_stats(ns, uuid))
            yield spb.NodeStatsResponse(
                type=spb.NODE_STATS_OK, hostname=ns.hostname
            )

    def ReceivePodStats(self, request_iterator, context):
        for ps in request_iterator:
            uid = self.shared.uid_for_pod(f"{ps.namespace}/{ps.name}")
            if uid is None:
                yield spb.PodStatsResponse(
                    type=spb.POD_NOT_FOUND, name=ps.name, namespace=ps.namespace
                )
                continue
            self.fc.add_task_stats(pod_stats_to_task_stats(ps, uid))
            yield spb.PodStatsResponse(
                type=spb.POD_STATS_OK, name=ps.name, namespace=ps.namespace
            )


class StatsServer:
    """Owns the gRPC server bound to the stats address (stats.go:163-178)."""

    def __init__(
        self,
        shared: SharedState,
        firmament: FirmamentClient,
        address: str = "0.0.0.0:9091",
        max_workers: int = 8,
    ) -> None:
        self.servicer = StatsServicer(shared, firmament)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers(
            (generic_handler(STATS_SERVICE, STATS_METHODS, self.servicer),)
        )
        self.port = self._server.add_insecure_port(address)
        host = address.rsplit(":", 1)[0]
        if host in ("0.0.0.0", "[::]", ""):
            host = "127.0.0.1"
        self.address = f"{host}:{self.port}"

    def start(self) -> "StatsServer":
        self._server.start()
        log.info("stats server on %s", self.address)
        return self

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self._server.stop(grace).wait()

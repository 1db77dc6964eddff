"""The port's gRPC server: all 13 FirmamentScheduler RPCs.

The wire contract is the reference's (firmament_scheduler.proto:15-45);
the round underneath is the port's RoundPlanner, solving on the CUDA card
unless the config asks for the CPU.  Reply-enum fidelity is load-bearing
(the Poseidon client ``glog.Fatalf``s on unexpected answers), so every
state-machine answer comes from graph/state.py.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from concurrent import futures
from typing import Optional

import grpc

from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph.instance import RoundPlanner
from poseidon_tpu_torch.graph.state import ClusterState
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos.services import (
    FIRMAMENT_METHODS,
    FIRMAMENT_SERVICE,
    generic_handler,
)
from poseidon_tpu_torch.service import converters
from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.utils.config import FirmamentTPUConfig, load_config
from poseidon_tpu_torch.utils.locks import TrackedLock

log = logging.getLogger("poseidon_tpu_torch.server")


class FirmamentServicer:
    """Method-per-RPC servicer bound via the generic handler table."""

    def __init__(self, config: Optional[FirmamentTPUConfig] = None) -> None:
        self.config = config or FirmamentTPUConfig()
        self.config.validate()
        planner_kw = dict(
            gang_scheduling=self.config.gang_scheduling,
            pod_affinity=self.config.pod_affinity,
        )
        state = planner = None
        path = self.config.checkpoint_path
        if path and os.path.exists(path):
            # Restart recovery: placements and solver warm frames come
            # back, so the first round solves warm.  An unreadable
            # checkpoint degrades to a fresh start (the client replays its
            # world onto ALREADY_* replies): recovery must never be the
            # reason the scheduler cannot start.
            from poseidon_tpu_torch.graph.snapshot import load_checkpoint

            try:
                state, planner = load_checkpoint(
                    path, cost_model=get_cost_model(self.config.cost_model),
                    device=self.config.device, **planner_kw,
                )
                log.info("restored checkpoint %s: %d machines, %d tasks",
                         path, len(state.machines), len(state.tasks))
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                log.error("checkpoint %s unreadable (%s); starting fresh",
                          path, e)
                state = planner = None
        self.state = state or ClusterState()
        self.planner = planner or RoundPlanner(
            self.state, get_cost_model(self.config.cost_model),
            device=self.config.device, **planner_kw,
        )
        # Schedule() rounds are serialized: the planner's warm-start state
        # is single-writer.
        self._schedule_lock = TrackedLock(
            "service.FirmamentServicer._schedule_lock"
        )
        # Checkpoint writes happen OUTSIDE the schedule lock (fsync
        # latency must not stall rounds) but must still not interleave
        # with each other (periodic vs shutdown save share a tmp path).
        self._ckpt_write_lock = TrackedLock(
            "service.FirmamentServicer._ckpt_write_lock"
        )
        self._precompiled = False

    # ------------------------------------------------------------- scheduling

    def ensure_precompiled(self) -> int:
        """Run the planner's precompile up to the configured ceilings,
        exactly once (idempotent, serialized on the schedule lock), and
        return the number of solve keys it reached (0 when already done
        or when the config turns precompile off).  The first Schedule()
        calls this lazily; harness code that measures per-round compile
        events (the chaos soak) calls it eagerly instead — a lazy
        precompile keeps running in the first round's handler thread
        after the client's deadline expires, and its first sights would
        then straggle into later rounds' ledger windows.  The wall
        seconds and key count ride /metrics as gauges
        (``poseidon_precompile_*``)."""
        with self._schedule_lock:
            if not self.config.precompile or self._precompiled:
                return 0
            self._precompiled = True
            t0 = time.perf_counter()
            n = self.planner.precompile(
                max_ecs=self.config.max_ecs,
                max_machines=self.config.max_machines,
            )
            wall = time.perf_counter() - t0
            obs_metrics.default_registry().gauge(
                "poseidon_precompile_seconds",
                "Wall seconds the startup solver-ladder precompile took "
                "(persistent-cache hits make this seconds, not minutes)",
            ).set(wall)
            obs_metrics.default_registry().gauge(
                "poseidon_precompile_shapes",
                "Solver shapes compiled/warmed by the startup precompile",
            ).set(float(n))
            log.info("precompiled %d solve keys in %.1fs", n, wall)
            return n

    def Schedule(self, request, context):
        self.ensure_precompiled()
        with self._schedule_lock:
            deltas, metrics = self.planner.schedule_round()
        log.info(
            "round %d: %d tasks / %d ECs / %d machines -> "
            "%d place %d preempt %d migrate %d unsched; "
            "solve %.3fs total %.3fs objective %d (iters %d, bf %d; "
            "tier %s, pruned bands %d, cost delta hits %d)",
            metrics.round_index, metrics.num_tasks, metrics.num_ecs,
            metrics.num_machines, metrics.placed, metrics.preempted,
            metrics.migrated, metrics.unscheduled, metrics.solve_seconds,
            metrics.total_seconds, metrics.objective,
            metrics.iterations, metrics.bf_sweeps, metrics.solve_tier,
            metrics.pruned_bands, metrics.cost_delta_hits,
        )
        # Prometheus feed: every RoundMetrics field (schema-driven via
        # to_dict) plus the process-wide lock-ledger counters.
        obs_metrics.observe_round(metrics)
        obs_metrics.observe_ledger()
        every = self.config.checkpoint_every_rounds
        if (
            self.config.checkpoint_path and every > 0
            and metrics.round_index % every == every - 1
        ):
            self.save_checkpoint()
        return converters.deltas_to_proto(deltas)

    def save_checkpoint(self) -> None:
        """Write state + warm frames; failures are logged, never fatal."""
        if not self.config.checkpoint_path:
            return
        from poseidon_tpu_torch.graph.snapshot import (
            serialize_checkpoint,
            write_checkpoint,
        )

        try:
            with self._schedule_lock:
                payload = serialize_checkpoint(self.state, self.planner)
            with self._ckpt_write_lock:
                write_checkpoint(self.config.checkpoint_path, *payload)
        except Exception as e:  # noqa: BLE001 - never fatal by contract
            log.error("checkpoint write failed: %s", e)

    # ----------------------------------------------------------- task lifecycle

    def TaskSubmitted(self, request, context):
        task = converters.task_info_from_proto(
            request.task_descriptor, job_id=request.job_descriptor.uuid
        )
        return fpb.TaskSubmittedResponse(
            type=int(self.state.task_submitted(task)))

    def TaskCompleted(self, request, context):
        reply = self.state.task_completed(int(request.task_uid))
        return fpb.TaskCompletedResponse(type=int(reply))

    def TaskFailed(self, request, context):
        reply = self.state.task_failed(int(request.task_uid))
        return fpb.TaskFailedResponse(type=int(reply))

    def TaskRemoved(self, request, context):
        reply = self.state.task_removed(int(request.task_uid))
        return fpb.TaskRemovedResponse(type=int(reply))

    def TaskUpdated(self, request, context):
        task = converters.task_info_from_proto(
            request.task_descriptor, job_id=request.job_descriptor.uuid
        )
        return fpb.TaskUpdatedResponse(type=int(self.state.task_updated(task)))

    # ----------------------------------------------------------- node lifecycle

    def NodeAdded(self, request, context):
        machine = converters.machine_info_from_proto(
            request, default_slots=self.config.max_tasks_per_pu
        )
        return fpb.NodeAddedResponse(type=int(self.state.node_added(machine)))

    def NodeFailed(self, request, context):
        reply = self.state.node_failed(request.resource_uid)
        return fpb.NodeFailedResponse(type=int(reply))

    def NodeRemoved(self, request, context):
        reply = self.state.node_removed(request.resource_uid)
        return fpb.NodeRemovedResponse(type=int(reply))

    def NodeUpdated(self, request, context):
        machine = converters.machine_info_from_proto(
            request, default_slots=self.config.max_tasks_per_pu
        )
        return fpb.NodeUpdatedResponse(
            type=int(self.state.node_updated(machine)))

    # ------------------------------------------------------------------- stats

    def AddTaskStats(self, request, context):
        reply = self.state.add_task_stats(
            int(request.task_id), converters.task_stats_sample(request)
        )
        return fpb.TaskStatsResponse(type=int(reply))

    def AddNodeStats(self, request, context):
        reply = self.state.add_node_stats(
            request.resource_id, converters.resource_stats_sample(request)
        )
        return fpb.ResourceStatsResponse(type=int(reply))

    # ------------------------------------------------------------------ health

    def Check(self, request, context):
        return fpb.HealthCheckResponse(status=fpb.SERVING)


class FirmamentTPUServer:
    """Owns the grpc.Server; usable as a context manager."""

    def __init__(
        self,
        config: Optional[FirmamentTPUConfig] = None,
        address: Optional[str] = None,
        max_workers: int = 16,
    ) -> None:
        self.config = config or FirmamentTPUConfig()
        if address is not None:
            self.config.listen_address = address
        self.servicer = FirmamentServicer(config=self.config)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers(
            (generic_handler(FIRMAMENT_SERVICE, FIRMAMENT_METHODS,
                             self.servicer),)
        )
        self.port = self._server.add_insecure_port(self.config.listen_address)
        if self.port == 0:
            raise RuntimeError(f"could not bind {self.config.listen_address}")
        # Service-side Prometheus exporter: the round metrics live in THIS
        # process (Schedule() runs here), so the two-process deployment
        # needs an endpoint on both sides.
        self.metrics_server: Optional[obs_metrics.MetricsServer] = None
        if self.config.metrics_address:
            self.metrics_server = obs_metrics.MetricsServer(
                self.config.metrics_address
            )

    @property
    def address(self) -> str:
        host = self.config.listen_address.rsplit(":", 1)[0]
        if host in ("0.0.0.0", "[::]", ""):
            host = "127.0.0.1"
        return f"{host}:{self.port}"

    def start(self) -> "FirmamentTPUServer":
        self._server.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
            log.info("metrics on http://%s/metrics",
                     self.metrics_server.address)
        log.info("firmament (torch port) serving on %s", self.address)
        return self

    def stop(self, grace: Optional[float] = None) -> None:
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self._server.stop(grace).wait()

    def wait(self) -> None:
        self._server.wait_for_termination()

    def __enter__(self) -> "FirmamentTPUServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(grace=0.5)


def main(argv=None) -> None:
    """Process entry point (the analog of the firmament_scheduler binary)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
    )
    cfg = load_config(FirmamentTPUConfig, argv=argv)
    server = FirmamentTPUServer(config=cfg).start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop(grace=2.0)
    # Shutdown checkpoint after the server quiesces.
    server.servicer.save_checkpoint()


if __name__ == "__main__":
    main()

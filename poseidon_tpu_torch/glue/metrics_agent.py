"""Metrics agent: the stand-in for the forked Heapster sink.

The reference wires cluster telemetry as Heapster -> Poseidon's stats
server -> Firmament's knowledge base (reference
deploy/heapster-poseidon.yaml:46-50 pointing --sink=poseidon at the
stats port; pkg/stats/stats.go:77-159 forwards).  Heapster is long dead
upstream; the equivalent here is a small agent process that polls a
usage source and streams ``NodeStats``/``PodStats`` over the same bidi
gRPC surface the stats server already serves
(poseidon_tpu/glue/stats_server.py), closing the knowledge-base loop.

Sources are pluggable: ``metrics_api_source`` reads the metrics.k8s.io
API (metrics-server, the modern Heapster replacement; gated on the
``kubernetes`` package), and tests inject synthetic callables.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

import grpc

from poseidon_tpu_torch.protos import stats_pb2 as spb
from poseidon_tpu_torch.protos.services import STATS_METHODS, STATS_SERVICE, make_stubs

log = logging.getLogger("poseidon.metrics_agent")

# A source returns one sample batch per call.
Sample = Tuple[List[spb.NodeStats], List[spb.PodStats]]
Source = Callable[[], Sample]


def metrics_api_source(kubeconfig: str = "") -> Source:
    """Usage from the metrics.k8s.io API (metrics-server).

    Units follow the stats server's conventions: CPU in millicores,
    memory in KB (stats_server.py conversion into ResourceStats /
    TaskStats).
    """
    from kubernetes import client as k8s_client
    from kubernetes import config as k8s_config

    from poseidon_tpu_torch.glue.kube_convert import parse_cpu, parse_mem_kb

    if kubeconfig:
        k8s_config.load_kube_config(config_file=kubeconfig)
    else:
        try:
            k8s_config.load_incluster_config()
        except Exception:
            k8s_config.load_kube_config()
    api = k8s_client.CustomObjectsApi()
    core = k8s_client.CoreV1Api()

    def poll() -> Sample:
        now = int(time.time())
        nodes: List[spb.NodeStats] = []
        pods: List[spb.PodStats] = []
        caps = {}
        for n in core.list_node().items:
            cap = n.status.capacity or {}
            caps[n.metadata.name] = (
                parse_cpu(cap.get("cpu", "")),
                parse_mem_kb(cap.get("memory", "")),
            )
        node_metrics = api.list_cluster_custom_object(
            "metrics.k8s.io", "v1beta1", "nodes"
        )
        for item in node_metrics.get("items", []):
            name = item["metadata"]["name"]
            usage = item.get("usage", {})
            cpu_m = parse_cpu(usage.get("cpu", "0"))
            mem_kb = parse_mem_kb(usage.get("memory", "0"))
            cap_cpu, cap_mem = caps.get(name, (0, 0))
            nodes.append(
                spb.NodeStats(
                    hostname=name,
                    timestamp=now,
                    cpu_capacity=cap_cpu,
                    cpu_allocatable=max(cap_cpu - cpu_m, 0),
                    cpu_utilization=(cpu_m / cap_cpu) if cap_cpu else 0.0,
                    mem_capacity=cap_mem,
                    mem_allocatable=max(cap_mem - mem_kb, 0),
                    mem_utilization=(mem_kb / cap_mem) if cap_mem else 0.0,
                )
            )
        pod_metrics = api.list_cluster_custom_object(
            "metrics.k8s.io", "v1beta1", "pods"
        )
        for item in pod_metrics.get("items", []):
            meta = item["metadata"]
            cpu_m = 0
            mem_kb = 0
            for c in item.get("containers", []):
                usage = c.get("usage", {})
                cpu_m += parse_cpu(usage.get("cpu", "0"))
                mem_kb += parse_mem_kb(usage.get("memory", "0"))
            pods.append(
                spb.PodStats(
                    name=meta["name"],
                    namespace=meta.get("namespace", "default"),
                    cpu_usage=cpu_m,
                    mem_usage=mem_kb,
                )
            )
        return nodes, pods

    return poll


class MetricsAgent:
    """Polls a source on an interval and streams batches to the stats
    server, logging NOT_FOUND answers (unknown pods/nodes) at debug."""

    def __init__(
        self,
        source: Source,
        stats_address: str,
        interval: float = 10.0,
    ) -> None:
        self.source = source
        self.interval = interval
        self._channel = grpc.insecure_channel(stats_address)
        self._stubs = make_stubs(
            self._channel, STATS_SERVICE, STATS_METHODS
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # One-shot push, usable directly (tests, cron-style invocations).
    def push_once(self) -> Tuple[int, int]:
        nodes, pods = self.source()
        n_ok = p_ok = 0
        if nodes:
            for reply in self._stubs.ReceiveNodeStats(iter(nodes)):
                if reply.type == spb.NODE_STATS_OK:
                    n_ok += 1
                else:
                    log.debug("node stats dropped: %s", reply.hostname)
        if pods:
            for reply in self._stubs.ReceivePodStats(iter(pods)):
                if reply.type == spb.POD_STATS_OK:
                    p_ok += 1
                else:
                    log.debug(
                        "pod stats dropped: %s/%s",
                        reply.namespace, reply.name,
                    )
        return n_ok, p_ok

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.push_once()
            except Exception as e:  # noqa: BLE001 - the poll loop must
                # survive transient API/stream failures (metrics-server
                # rollouts, channel resets) and retry next interval.
                log.warning("stats push failed: %s", e)
            self._stop.wait(self.interval)

    def start(self) -> "MetricsAgent":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._channel.close()


def main(argv: Optional[Iterable[str]] = None) -> int:
    import argparse

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
    )
    p = argparse.ArgumentParser(prog="poseidon-metrics-agent")
    p.add_argument("--stats-address", default="poseidon-stats.kube-system:9091")
    p.add_argument("--kube-config", default="")
    p.add_argument("--interval", type=float, default=10.0)
    args = p.parse_args(list(argv) if argv is not None else None)

    agent = MetricsAgent(
        metrics_api_source(args.kube_config),
        args.stats_address,
        interval=args.interval,
    )
    try:
        agent.run()
    except KeyboardInterrupt:
        agent.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Node watcher: K8s node lifecycle -> Firmament node RPCs.

Re-creates the reference's node watcher (pkg/k8sclient/nodewatcher.go):

- ``Unschedulable`` nodes are skipped entirely (:124-132);
- conditions map to phases: Ready -> Added, NotReady/OutOfDisk -> Failed,
  deletion -> Removed (:134-178);
- each node becomes a 2-level Machine -> PU#0 topology with the capacity
  vector (RAM KB, CPU millicores) and labels copied onto the machine
  descriptor (:292-339);
- deterministic resource UUIDs from the node name, per-node ordered
  processing via the keyed queue + N workers (:219-283).
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import List

from poseidon_tpu_torch.glue.fake_kube import KubeAPI, Node
from poseidon_tpu_torch.glue.keyed_queue import KeyedQueue
from poseidon_tpu_torch.glue.types import SharedState
from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.service.client import FirmamentClient
from poseidon_tpu_torch.utils.ids import resource_uuid

log = logging.getLogger("poseidon.nodewatcher")

DEFAULT_TASK_SLOTS = 100


def topology_for_node(node: Node) -> fpb.ResourceTopologyNodeDescriptor:
    """Machine + single PU#0 child (nodewatcher.go:292-339)."""
    rtnd = fpb.ResourceTopologyNodeDescriptor()
    rd = rtnd.resource_desc
    rd.uuid = resource_uuid(node.name)
    rd.friendly_name = node.name
    rd.descriptive_name = node.name
    rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
    rd.state = fpb.ResourceDescriptor.RESOURCE_IDLE
    rd.schedulable = True
    rd.task_capacity = DEFAULT_TASK_SLOTS
    rd.resource_capacity.cpu_cores = node.cpu_capacity
    rd.resource_capacity.ram_cap = node.ram_capacity
    rd.available_resources.cpu_cores = node.cpu_capacity
    rd.available_resources.ram_cap = node.ram_capacity
    for k, v in sorted(node.labels.items()):
        rd.labels.add(key=k, value=v)

    pu = rtnd.children.add()
    pu.parent_id = rd.uuid
    prd = pu.resource_desc
    prd.uuid = resource_uuid(f"{node.name}/pu0")
    prd.friendly_name = f"{node.name}_pu0"
    prd.type = fpb.ResourceDescriptor.RESOURCE_PU
    prd.state = fpb.ResourceDescriptor.RESOURCE_IDLE
    prd.schedulable = True
    prd.task_capacity = DEFAULT_TASK_SLOTS
    return rtnd


class NodeWatcher:
    def __init__(
        self,
        kube: KubeAPI,
        firmament: FirmamentClient,
        shared: SharedState,
        workers: int = 10,
    ) -> None:
        self.kube = kube
        self.fc = firmament
        self.shared = shared
        self.workers = workers
        self.queue = KeyedQueue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # Observability: how many times the watch dropped and re-synced.
        self.resyncs = 0

    def run(self) -> None:
        watch = self.kube.watch_nodes()
        for node in self.kube.list_nodes():
            self.queue.add(node.name, ("ADDED", node))
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker, name=f"node-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        pump = threading.Thread(
            target=self._pump, args=(watch,), name="node-watch", daemon=True
        )
        pump.start()
        self._threads.append(pump)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()

    def _pump(self, watch) -> None:
        while not self._stop.is_set():
            try:
                kind, node = watch.get(timeout=0.2)
            except Exception:
                continue
            if kind == "ERROR":
                # Same contract as the pod watcher: a dropped watch
                # swallowed events; re-subscribe, re-list, synthesize
                # the deletions the gap hid.
                log.warning("node watch dropped (%s); resyncing", node)
                watch = self._resync(watch)
                continue
            self.queue.add(node.name, (kind, node))

    def _resync(self, old_watch=None):
        """Re-list + re-watch after a dropped node watch; nodes the
        tracked world knows but the fresh list lacks were removed while
        disconnected — synthesize their DELETED events so the scheduler
        evicts their tasks.  (Replaying known nodes as ADDED is sound
        here: the node phase machine diffs capacity/labels/health
        regardless of event kind.)"""
        self.resyncs += 1
        if old_watch is not None:
            self.kube.unwatch_nodes(old_watch)
        watch = self.kube.watch_nodes()
        listed = {n.name: n for n in self.kube.list_nodes()}
        known = self.shared.nodes_snapshot()
        for name in sorted(set(known) - set(listed)):
            lost = copy.copy(known[name])
            lost.deleted = True
            self.queue.add(name, ("DELETED", lost))
        for name in sorted(listed):
            self.queue.add(name, ("ADDED", listed[name]))
        return watch

    def _worker(self) -> None:
        # Continuous ingest (see PodWatcher._worker): node deltas land
        # in ClusterState as they arrive; watch_event stamps ingest
        # liveness for /healthz's streaming wedge gate.
        while True:
            batch = self.queue.get()
            if batch is None:
                return
            key, items = batch
            try:
                for kind, node in items:
                    with obs_trace.span("watch.node_event", kind=kind,
                                        node=node.name):
                        self._process(kind, node)
                    obs_metrics.watch_event("node", kind)
            except Exception:
                log.exception("node worker failed on %s", key)
            finally:
                self.queue.done(key)

    # ----------------------------------------------------------- phase machine

    def _process(self, kind: str, node: Node) -> None:
        sh = self.shared
        known = sh.get_node(node.name)
        if kind == "DELETED" or node.deleted:
            entry = sh.pop_node(node.name)
            if entry is not None:
                self.fc.node_removed(entry.rtnd.resource_desc.uuid)
            return
        if node.unschedulable:
            # Unschedulable gate (nodewatcher.go:124-132): treat a known
            # node turning unschedulable as a removal, never add it.
            entry = sh.pop_node(node.name)
            if entry is not None:
                self.fc.node_removed(entry.rtnd.resource_desc.uuid)
            return
        healthy = node.ready and not node.out_of_disk
        if known is None:
            if healthy:
                rtnd = topology_for_node(node)
                sh.put_node(node, rtnd)
                self.fc.node_added(rtnd)
            return
        if not healthy:
            # Ready=False / OutOfDisk=True -> Failed (nodewatcher.go:151-165).
            # Store the failed condition so a later recovery event is
            # detectable (and re-armed via NodeUpdated below).
            sh.put_node(node, known.rtnd)
            self.fc.node_failed(known.rtnd.resource_desc.uuid)
            return
        if (
            node.cpu_capacity != known.node.cpu_capacity
            or node.ram_capacity != known.node.ram_capacity
            or node.labels != known.node.labels
        ):
            rtnd = topology_for_node(node)
            sh.put_node(node, rtnd)
            self.fc.node_updated(rtnd)
        elif not known.node.ready or known.node.out_of_disk:
            # Healthy again after a Failed phase: NodeUpdated re-arms it.
            sh.put_node(node, known.rtnd)
            self.fc.node_updated(known.rtnd)
        else:
            sh.put_node(node, known.rtnd)

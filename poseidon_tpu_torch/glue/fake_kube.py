"""In-process fake Kubernetes cluster + the KubeAPI seam.

The reference talks to a real API server via client-go informers and the
pods/binding subresource (pkg/k8sclient/k8sclient.go:33-54, watchers at
podwatcher.go:81-129, nodewatcher.go:47-81).  This module defines the same
seam as a minimal interface — list/watch of pods and nodes, bind, delete —
plus ``FakeKube``, a thread-safe in-process implementation used by the
integration tier and the trace-replay harness (the fake plays the role of
client-go's fake.Clientset, nodewatcher_test.go:45, and of the cluster in
the e2e tier).
"""

from __future__ import annotations

import copy
import itertools
import queue
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from poseidon_tpu_torch.utils.locks import TrackedLock


@dataclass
class Pod:
    """The scheduling-relevant slice of a K8s Pod (podwatcher.go:135-175)."""

    name: str
    namespace: str = "default"
    # Owner reference UID: groups pods into jobs (podwatcher.go:425-453).
    owner_uid: str = ""
    scheduler_name: str = "poseidon"
    phase: str = "Pending"   # Pending/Running/Succeeded/Failed/Unknown
    node_name: str = ""      # set by bind
    cpu_request: int = 0     # millicores
    ram_request: int = 0     # KB
    labels: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # K8s podAffinity/podAntiAffinity requiredDuringScheduling matchLabels
    # (machine-level topology): match against labels of pods running on
    # the candidate node.
    pod_affinity: Dict[str, str] = field(default_factory=dict)
    pod_anti_affinity: Dict[str, str] = field(default_factory=dict)
    deleted: bool = False

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Node:
    """The scheduling-relevant slice of a K8s Node (nodewatcher.go:120-216)."""

    name: str
    cpu_capacity: int = 0    # millicores
    ram_capacity: int = 0    # KB
    unschedulable: bool = False
    ready: bool = True
    out_of_disk: bool = False
    labels: Dict[str, str] = field(default_factory=dict)
    deleted: bool = False


Event = Tuple[str, object]  # ("ADDED"|"MODIFIED"|"DELETED", Pod|Node)


class KubeAPI:
    """The client-go seam the watchers and actuation depend on."""

    def list_pods(self) -> List[Pod]:
        raise NotImplementedError

    def list_nodes(self) -> List[Node]:
        raise NotImplementedError

    def watch_pods(self) -> "queue.Queue[Event]":
        raise NotImplementedError

    def watch_nodes(self) -> "queue.Queue[Event]":
        raise NotImplementedError

    def unwatch_pods(self, watch) -> None:
        """Unsubscribe a watch returned by ``watch_pods`` (the watcher's
        resync path drops the dead stream before re-subscribing, or the
        fan-out keeps feeding an abandoned queue forever).  Default
        no-op: adapters whose watch streams die with their server-side
        connection have nothing to release."""

    def unwatch_nodes(self, watch) -> None:
        """Unsubscribe a watch returned by ``watch_nodes`` (see
        ``unwatch_pods``)."""

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        raise NotImplementedError

    def delete_pod(self, namespace: str, name: str) -> None:
        raise NotImplementedError


class FakeKube(KubeAPI):
    """Thread-safe in-process cluster with watch fan-out.

    Mutators (``create_pod``/``set_pod_phase``/``add_node``/...) model the
    API-server + controller side; ``bind_pod``/``delete_pod`` are the
    scheduler-side actuation calls the reference makes
    (k8sclient.go:33-54).  Every mutation fans out a watch event to all
    subscribers, mirroring informer delivery.
    """

    def __init__(self) -> None:
        self._lock = TrackedLock("glue.FakeKube._lock", reentrant=True)
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self._pod_watchers: List["queue.Queue[Event]"] = []
        self._node_watchers: List["queue.Queue[Event]"] = []
        # Actuation log for assertions: (kind, namespace/name, node).
        self.bindings: List[Tuple[str, str]] = []
        self.deletions: List[str] = []
        # Controller emulation: deleted pods of owned sets get recreated.
        self.recreate_on_delete: bool = False
        self._recreate_counter = itertools.count()

    # ------------------------------------------------------------ fan-out

    # Watch delivery hands out *copies*, the way real informers deliver
    # freshly decoded objects: the registry object keeps mutating in place,
    # and if subscribers held the live reference, change detection
    # (old-vs-new spec comparison in the watchers) would compare an object
    # against itself and never fire.

    @staticmethod
    def _copy_pod(pod: Pod) -> Pod:
        clone = copy.copy(pod)
        clone.labels = dict(pod.labels)
        clone.node_selector = dict(pod.node_selector)
        clone.pod_affinity = dict(pod.pod_affinity)
        clone.pod_anti_affinity = dict(pod.pod_anti_affinity)
        return clone

    @staticmethod
    def _copy_node(node: Node) -> Node:
        clone = copy.copy(node)
        clone.labels = dict(node.labels)
        return clone

    def _emit_pod(self, kind: str, pod: Pod) -> None:
        clone = self._copy_pod(pod)
        for q in list(self._pod_watchers):
            q.put((kind, clone))

    def _emit_node(self, kind: str, node: Node) -> None:
        clone = self._copy_node(node)
        for q in list(self._node_watchers):
            q.put((kind, clone))

    # ------------------------------------------------------------- KubeAPI

    def list_pods(self) -> List[Pod]:
        with self._lock:
            return [self._copy_pod(p) for p in self.pods.values()]

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return [self._copy_node(n) for n in self.nodes.values()]

    def watch_pods(self) -> "queue.Queue[Event]":
        q: "queue.Queue[Event]" = queue.Queue()
        with self._lock:
            self._pod_watchers.append(q)
        return q

    def watch_nodes(self) -> "queue.Queue[Event]":
        q: "queue.Queue[Event]" = queue.Queue()
        with self._lock:
            self._node_watchers.append(q)
        return q

    def unwatch_pods(self, watch) -> None:
        with self._lock:
            if watch in self._pod_watchers:
                self._pod_watchers.remove(watch)

    def unwatch_nodes(self, watch) -> None:
        with self._lock:
            if watch in self._node_watchers:
                self._node_watchers.remove(watch)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        with self._lock:
            pod = self.pods.get(f"{namespace}/{name}")
            if pod is None or pod.deleted:
                raise KeyError(f"bind: no such pod {namespace}/{name}")
            pod.node_name = node_name
            pod.phase = "Running"
            self.bindings.append((pod.key, node_name))
            self._emit_pod("MODIFIED", pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            key = f"{namespace}/{name}"
            pod = self.pods.pop(key, None)
            if pod is None:
                raise KeyError(f"delete: no such pod {key}")
            pod.deleted = True
            self.deletions.append(key)
            self._emit_pod("DELETED", pod)
            if self.recreate_on_delete and pod.owner_uid:
                # The owning controller resubmits a replacement pod — the
                # preemption emulation the reference relies on
                # (cmd/poseidon/poseidon.go:59-63).
                clone = Pod(
                    name=f"{pod.name}-r{next(self._recreate_counter)}",
                    namespace=pod.namespace,
                    owner_uid=pod.owner_uid,
                    scheduler_name=pod.scheduler_name,
                    cpu_request=pod.cpu_request,
                    ram_request=pod.ram_request,
                    labels=dict(pod.labels),
                    node_selector=dict(pod.node_selector),
                )
                self.pods[clone.key] = clone
                self._emit_pod("ADDED", clone)

    # -------------------------------------------------- cluster-side mutators

    def create_pod(self, pod: Pod) -> Pod:
        with self._lock:
            self.pods[pod.key] = pod
            self._emit_pod("ADDED", pod)
            return pod

    def set_pod_phase(self, key: str, phase: str) -> None:
        with self._lock:
            pod = self.pods[key]
            pod.phase = phase
            self._emit_pod("MODIFIED", pod)

    def update_pod(self, key: str, mutate: Callable[[Pod], None]) -> None:
        with self._lock:
            pod = self.pods[key]
            mutate(pod)
            self._emit_pod("MODIFIED", pod)

    def add_node(self, node: Node) -> Node:
        with self._lock:
            self.nodes[node.name] = node
            self._emit_node("ADDED", node)
            return node

    def update_node(self, name: str, mutate: Callable[[Node], None]) -> None:
        with self._lock:
            node = self.nodes[name]
            mutate(node)
            self._emit_node("MODIFIED", node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            node = self.nodes.pop(name)
            node.deleted = True
            self._emit_node("DELETED", node)

"""Shared glue-process state: the id maps joining watchers, stats, and the
schedule loop.

Mirrors the reference's shared maps + RW mutexes (pkg/k8sclient/types.go:31-48):
PodToTD / TaskIDToPod / NodeToRTND / ResIDToNode, here folded into one
lock-guarded registry with typed accessors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from poseidon_tpu_torch.glue.fake_kube import Node, Pod
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.utils.locks import TrackedLock


@dataclass
class TaskEntry:
    pod: Pod
    descriptor: fpb.TaskDescriptor
    # Task reached a terminal phase (Succeeded/Failed reported to the
    # scheduler).  The entry stays until the pod object is DELETED — the
    # uid must remain resolvable for the TaskRemoved hand-off — but stats
    # for finished tasks are dropped (the reference answers NOT_FOUND for
    # pods it no longer tracks, stats.go:132-134).
    finished: bool = False


@dataclass
class NodeEntry:
    node: Node
    rtnd: fpb.ResourceTopologyNodeDescriptor


class SharedState:
    def __init__(self) -> None:
        self._lock = TrackedLock("glue.SharedState._lock", reentrant=True)
        self._tasks: Dict[int, TaskEntry] = {}          # task uid -> entry
        self._pod_to_uid: Dict[str, int] = {}           # pod key -> task uid
        self._nodes: Dict[str, NodeEntry] = {}          # node name -> entry
        self._res_to_node: Dict[str, str] = {}          # resource uuid -> name

    # ------------------------------------------------------------------ tasks

    def put_task(self, uid: int, pod: Pod, td: fpb.TaskDescriptor) -> None:
        with self._lock:
            self._tasks[uid] = TaskEntry(pod=pod, descriptor=td)
            self._pod_to_uid[pod.key] = uid

    def get_task(self, uid: int) -> Optional[TaskEntry]:
        with self._lock:
            return self._tasks.get(uid)

    def pop_task(self, uid: int) -> Optional[TaskEntry]:
        with self._lock:
            entry = self._tasks.pop(uid, None)
            if entry is not None:
                self._pod_to_uid.pop(entry.pod.key, None)
            return entry

    def mark_finished(self, uid: int) -> None:
        with self._lock:
            entry = self._tasks.get(uid)
            if entry is not None:
                entry.finished = True

    def uid_for_pod(self, pod_key: str) -> Optional[int]:
        """Task uid for a live pod; None for unknown or finished pods
        (the stats path — finished tasks answer NOT_FOUND)."""
        with self._lock:
            uid = self._pod_to_uid.get(pod_key)
            if uid is None:
                return None
            entry = self._tasks.get(uid)
            if entry is None or entry.finished:
                return None
            return uid

    def task_for_uid(self, uid: int) -> Optional[Pod]:
        with self._lock:
            entry = self._tasks.get(uid)
            return entry.pod if entry else None

    def pods_snapshot(self) -> Dict[str, Pod]:
        """pod key -> last-seen Pod for every tracked task (the watcher
        resync path diffs this against a fresh list to synthesize the
        DELETED events a dropped watch swallowed)."""
        with self._lock:
            return {
                entry.pod.key: entry.pod for entry in self._tasks.values()
            }

    def live_uids(self) -> Dict[int, Pod]:
        """uid -> Pod for every non-finished tracked task (the
        suspect-reconciler's candidate set after a commit-ambiguous
        Schedule failure)."""
        with self._lock:
            return {
                uid: entry.pod
                for uid, entry in self._tasks.items()
                if not entry.finished
            }

    # ------------------------------------------------------------------ nodes

    def put_node(
        self, node: Node, rtnd: fpb.ResourceTopologyNodeDescriptor
    ) -> None:
        with self._lock:
            self._nodes[node.name] = NodeEntry(node=node, rtnd=rtnd)
            self._register_subtree(node.name, rtnd)

    def _register_subtree(self, name, rtnd) -> None:
        self._res_to_node[rtnd.resource_desc.uuid] = name
        for child in rtnd.children:
            self._register_subtree(name, child)

    def get_node(self, name: str) -> Optional[NodeEntry]:
        with self._lock:
            return self._nodes.get(name)

    def pop_node(self, name: str) -> Optional[NodeEntry]:
        with self._lock:
            entry = self._nodes.pop(name, None)
            if entry is not None:
                dead = [
                    r for r, n in self._res_to_node.items() if n == name
                ]
                for r in dead:
                    del self._res_to_node[r]
            return entry

    def node_for_resource(self, uuid: str) -> Optional[str]:
        with self._lock:
            return self._res_to_node.get(uuid)

    def nodes_snapshot(self) -> Dict[str, Node]:
        """node name -> last-seen Node for every tracked node (the node
        watcher's resync diff, mirroring ``pods_snapshot``)."""
        with self._lock:
            return {
                name: entry.node for name, entry in self._nodes.items()
            }

    def resource_for_node(self, name: str) -> Optional[str]:
        with self._lock:
            entry = self._nodes.get(name)
            return entry.rtnd.resource_desc.uuid if entry else None

"""Pod watcher: K8s pod lifecycle -> Firmament task RPCs.

Re-creates the reference's pod watcher semantics (pkg/k8sclient/podwatcher.go):

- only pods with ``spec.schedulerName == poseidon`` are watched (:81-90);
- pods are grouped into jobs by owner reference, with a deterministic job
  UUID and FNV hash-combine task uids (:377-422);
- the phase machine maps Pending/Succeeded/Failed/Deleted/Updated to
  TaskSubmitted/TaskCompleted/TaskFailed/TaskRemoved/TaskUpdated (:249-351);
- nodeSelector terms become IN_SET label selectors (:455-465), the
  ``networkRequirement`` label becomes a NetRxBw request (:467-476), and
  the ``taskType`` label selects the interference class (:478-495);
- a keyed queue + N workers guarantee per-pod ordered processing (:91-129).
"""

from __future__ import annotations

import copy
import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from poseidon_tpu_torch.glue.fake_kube import KubeAPI, Pod
from poseidon_tpu_torch.glue.keyed_queue import KeyedQueue
from poseidon_tpu_torch.glue.types import SharedState
from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.service.client import FirmamentClient
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid
from poseidon_tpu_torch.utils.locks import TrackedLock

log = logging.getLogger("poseidon.podwatcher")

# taskType label -> interference class (podwatcher.go:478-495).
_TASK_TYPES = {
    "sheep": fpb.TaskDescriptor.SHEEP,
    "rabbit": fpb.TaskDescriptor.RABBIT,
    "devil": fpb.TaskDescriptor.DEVIL,
    "turtle": fpb.TaskDescriptor.TURTLE,
}


@dataclass
class _JobEntry:
    uuid: str
    # Pod key -> task index within the job (index 0 = root task).
    indices: Dict[str, int] = field(default_factory=dict)
    next_index: int = 0


class PodWatcher:
    def __init__(
        self,
        kube: KubeAPI,
        firmament: FirmamentClient,
        shared: SharedState,
        scheduler_name: str = "poseidon",
        workers: int = 10,
    ) -> None:
        self.kube = kube
        self.fc = firmament
        self.shared = shared
        self.scheduler_name = scheduler_name
        self.workers = workers
        self.queue = KeyedQueue()
        self._jobs: Dict[str, _JobEntry] = {}
        self._jobs_lock = TrackedLock("glue.PodWatcher._jobs_lock")
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # Observability: how many times the watch dropped and re-synced.
        self.resyncs = 0

    # ------------------------------------------------------------- job model

    def _job_for(self, pod: Pod) -> _JobEntry:
        """Owner-ref grouping with deterministic ids (podwatcher.go:377-422).

        Pods without an owner are singleton jobs keyed by their own name
        (GetOwnerReference falls back to the pod itself, :425-453).
        """
        owner = pod.owner_uid or f"pod:{pod.key}"
        with self._jobs_lock:
            entry = self._jobs.get(owner)
            if entry is None:
                entry = _JobEntry(uuid=generate_uuid(owner))
                self._jobs[owner] = entry
            if pod.key not in entry.indices:
                entry.indices[pod.key] = entry.next_index
                entry.next_index += 1
            return entry

    def _task_uid(self, pod: Pod) -> int:
        entry = self._job_for(pod)
        return task_uid(entry.uuid, entry.indices[pod.key])

    # ----------------------------------------------------------- descriptors

    def _descriptor(self, pod: Pod) -> fpb.TaskDescription:
        entry = self._job_for(pod)
        td = fpb.TaskDescriptor(
            uid=self._task_uid(pod),
            name=pod.key,
            job_id=entry.uuid,
            index=entry.indices[pod.key],
        )
        td.resource_request.cpu_cores = pod.cpu_request
        td.resource_request.ram_cap = pod.ram_request
        # networkRequirement label -> net receive bandwidth request
        # (podwatcher.go:467-476; value in Mbps in the reference, carried
        # through as-is).
        net = pod.labels.get("networkRequirement")
        if net:
            try:
                td.resource_request.net_rx_bw = int(net)
            except ValueError:
                log.warning("pod %s: bad networkRequirement %r", pod.key, net)
        ttype = pod.labels.get("taskType")
        if ttype:
            td.task_type = _TASK_TYPES.get(ttype.lower(), fpb.TaskDescriptor.SHEEP)
        for k, v in sorted(pod.labels.items()):
            td.labels.add(key=k, value=v)
        # nodeSelector -> IN_SET constraints (podwatcher.go:455-465).
        for k, v in sorted(pod.node_selector.items()):
            td.label_selectors.add(
                type=fpb.LabelSelector.IN_SET, key=k, values=[v]
            )
        # podAffinity/podAntiAffinity matchLabels -> pod-level selectors
        # (contract extension; resolved against machine residents).
        for k, v in sorted(pod.pod_affinity.items()):
            td.pod_affinity.add(
                type=fpb.LabelSelector.IN_SET, key=k, values=[v]
            )
        for k, v in sorted(pod.pod_anti_affinity.items()):
            td.pod_anti_affinity.add(
                type=fpb.LabelSelector.IN_SET, key=k, values=[v]
            )
        # Already-bound pods (seen on restart re-list) carry their binding
        # so the scheduler state machine can recover the placement
        # (task_desc.proto's scheduled_to_resource field).
        if pod.node_name:
            res = self.shared.resource_for_node(pod.node_name)
            if res is not None:
                td.scheduled_to_resource = res
        jd = fpb.JobDescriptor(uuid=entry.uuid, name=pod.owner_uid or pod.key)
        return fpb.TaskDescription(task_descriptor=td, job_descriptor=jd)

    # -------------------------------------------------------------- lifecycle

    def run(self) -> None:
        """List+watch, then start the worker pool (podwatcher.go:91-129)."""
        watch = self.kube.watch_pods()
        for pod in self.kube.list_pods():
            self._enqueue("ADDED", pod)
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker, name=f"pod-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        pump = threading.Thread(
            target=self._pump, args=(watch,), name="pod-watch", daemon=True
        )
        pump.start()
        self._threads.append(pump)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()

    def _pump(self, watch) -> None:
        while not self._stop.is_set():
            try:
                kind, pod = watch.get(timeout=0.2)
            except Exception:
                continue
            if kind == "ERROR":
                # Watch dropped (stale resourceVersion / connection
                # loss): events between the drop and now are GONE, so a
                # fresh watch alone would leave the scheduler's world
                # diverged forever.  Resync: re-subscribe, re-list, and
                # synthesize the deletions the dead watch swallowed.
                log.warning("pod watch dropped (%s); resyncing", pod)
                watch = self._resync(watch)
                continue
            self._enqueue(kind, pod)

    def _resync(self, old_watch=None):
        """Re-list + re-watch after a dropped watch (the informer
        relist path).  Subscribe-then-list ordering leaves no gap: an
        event racing the list is delivered by the new watch too, and the
        phase machine is idempotent under the duplicate.  Pods the
        tracked world knows but the fresh list lacks were deleted while
        disconnected — synthesize their DELETED events; pods it knows
        that still exist replay as MODIFIED, so a spec change whose
        event died with the watch still lands (the ADDED path ignores
        already-known pods)."""
        self.resyncs += 1
        if old_watch is not None:
            self.kube.unwatch_pods(old_watch)
        watch = self.kube.watch_pods()
        listed = {}
        for pod in self.kube.list_pods():
            listed[pod.key] = pod
        known = self.shared.pods_snapshot()
        for key in sorted(set(known) - set(listed)):
            lost = copy.copy(known[key])
            lost.deleted = True
            self._enqueue("DELETED", lost)
        for key in sorted(listed):
            kind = "MODIFIED" if key in known else "ADDED"
            self._enqueue(kind, listed[key])
        return watch

    def _enqueue(self, kind: str, pod: Pod) -> None:
        if pod.scheduler_name != self.scheduler_name:
            return  # filtered informer (podwatcher.go:81-90)
        self.queue.add(pod.key, (kind, pod))

    # ----------------------------------------------------------- phase machine

    def _worker(self) -> None:
        # The continuous-ingest thread of the streaming round engine:
        # every event becomes RPC state in the service's ClusterState
        # the moment it is processed (the state's own lock publishes
        # it), and watch_event's stamp is the ingest-liveness signal
        # /healthz judges wedged watchers by.  The round's admission
        # cut happens service-side at view-snapshot time — nothing
        # here batches or waits on round boundaries.
        while True:
            batch = self.queue.get()
            if batch is None:
                return
            key, items = batch
            try:
                for kind, pod in items:
                    with obs_trace.span("watch.pod_event", kind=kind,
                                        pod=pod.key):
                        self._process(kind, pod)
                    obs_metrics.watch_event("pod", kind)
            except Exception:
                log.exception("pod worker failed on %s", key)
            finally:
                self.queue.done(key)

    def _process(self, kind: str, pod: Pod) -> None:
        uid = self._task_uid(pod)
        sh = self.shared
        if kind == "DELETED" or pod.deleted:
            if sh.pop_task(uid) is not None:
                self.fc.task_removed(uid)
            self._gc_job(pod)
            return
        if pod.phase == "Succeeded":
            known = sh.get_task(uid)
            if known is not None and not known.finished:
                self.fc.task_completed(uid)
                sh.mark_finished(uid)
            return
        if pod.phase == "Failed":
            known = sh.get_task(uid)
            if known is not None and not known.finished:
                self.fc.task_failed(uid)
                sh.mark_finished(uid)
            return
        if pod.phase in ("Pending", "Running"):
            known = sh.get_task(uid)
            if known is None:
                # Fresh Pending pod — or an already-bound pod re-listed
                # after a glue restart, whose binding the descriptor
                # carries via scheduled_to_resource.
                desc = self._descriptor(pod)
                sh.put_task(uid, pod, desc.task_descriptor)
                self.fc.task_submitted(
                    desc.task_descriptor, desc.job_descriptor
                )
            elif kind == "MODIFIED" and self._spec_changed(known.pod, pod):
                desc = self._descriptor(pod)
                sh.put_task(uid, pod, desc.task_descriptor)
                self.fc.task_updated(desc.task_descriptor, desc.job_descriptor)

    @staticmethod
    def _spec_changed(old: Pod, new: Pod) -> bool:
        """Request/label mutations trigger TaskUpdated (podwatcher.go:362-375);
        phase/binding transitions do not."""
        return (
            old.cpu_request != new.cpu_request
            or old.ram_request != new.ram_request
            or old.labels != new.labels
            or old.node_selector != new.node_selector
            or old.pod_affinity != new.pod_affinity
            or old.pod_anti_affinity != new.pod_anti_affinity
        )

    def _gc_job(self, pod: Pod) -> None:
        """Drop the job entry once its last task is gone (podwatcher.go:288-309)."""
        owner = pod.owner_uid or f"pod:{pod.key}"
        with self._jobs_lock:
            entry = self._jobs.get(owner)
            if entry is None:
                return
            entry.indices.pop(pod.key, None)
            if not entry.indices:
                del self._jobs[owner]

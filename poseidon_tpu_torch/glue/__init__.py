"""Poseidon glue: the K8s-integration half of the framework.

Re-creates the reference's Go client process (reference pkg/k8sclient/,
pkg/stats/, cmd/poseidon/) as a Python package: watchers translate pod/node
lifecycle events into FirmamentScheduler RPCs, a keyed queue serializes
per-object event processing, a stats server ingests Heapster-style metrics,
and the schedule loop enacts SchedulingDeltas as bind/delete calls.

Cluster access goes through the ``KubeAPI`` interface; ``FakeKube`` is the
in-process fake cluster used by the test/benchmark harness (the reference
only has a cluster-backed e2e tier — SURVEY.md section 4 flags the missing
in-process tier as a gap to fill).
"""

from poseidon_tpu_torch.glue.keyed_queue import KeyedQueue
from poseidon_tpu_torch.glue.fake_kube import FakeKube, Pod, Node
from poseidon_tpu_torch.glue.podwatcher import PodWatcher
from poseidon_tpu_torch.glue.nodewatcher import NodeWatcher
from poseidon_tpu_torch.glue.poseidon import Poseidon

__all__ = [
    "KeyedQueue",
    "FakeKube",
    "Pod",
    "Node",
    "PodWatcher",
    "NodeWatcher",
    "Poseidon",
]

"""Real-cluster KubeAPI adapter (gated on the ``kubernetes`` client).

Maps the watcher seam (poseidon_tpu_torch.glue.fake_kube.KubeAPI) onto the
official Kubernetes Python client the way the reference maps it onto
client-go: list+watch informers for pods/nodes (reference
pkg/k8sclient/podwatcher.go:81-129, nodewatcher.go:47-81), the
pods/binding subresource for actuation (k8sclient.go:33-46), and pod
deletion for preemption (k8sclient.go:49-54).

The ``kubernetes`` package is imported when the first ``RealKube`` is
built, not when this module is: without it that constructor raises
ImportError with a clear message, and everything else (the service, the
glue against FakeKube) works without it.
"""

from __future__ import annotations

import queue
import threading
from typing import List

from poseidon_tpu_torch.glue.fake_kube import Event, KubeAPI, Node, Pod
from poseidon_tpu_torch.glue.kube_convert import node_from_v1 as _node_from_v1
from poseidon_tpu_torch.glue.kube_convert import pod_from_v1 as _pod_from_v1

k8s_client = k8s_config = k8s_watch = None


def _load_kubernetes() -> None:
    """Bind the ``kubernetes`` client modules on first use."""
    global k8s_client, k8s_config, k8s_watch
    if k8s_client is not None:
        return
    try:
        from kubernetes import client, config, watch
    except ImportError as exc:  # pragma: no cover - gated dependency
        raise ImportError(
            "poseidon_tpu_torch.glue.kube_client requires the `kubernetes` "
            "package; in-process use goes through FakeKube"
        ) from exc
    k8s_client, k8s_config, k8s_watch = client, config, watch


class RealKube(KubeAPI):
    """KubeAPI over the official client; in- or out-of-cluster config
    (k8sclient.go:57-62)."""

    def __init__(self, kubeconfig: str = "") -> None:
        _load_kubernetes()
        if kubeconfig:
            k8s_config.load_kube_config(config_file=kubeconfig)
        else:
            try:
                k8s_config.load_incluster_config()
            except Exception:
                k8s_config.load_kube_config()
        self._core = k8s_client.CoreV1Api()
        self._stop = threading.Event()

    def list_pods(self) -> List[Pod]:
        out = self._core.list_pod_for_all_namespaces()
        return [_pod_from_v1(p) for p in out.items]

    def list_nodes(self) -> List[Node]:
        out = self._core.list_node()
        return [_node_from_v1(n) for n in out.items]

    def _watch_loop(self, q, list_fn, convert) -> None:
        w = k8s_watch.Watch()
        while not self._stop.is_set():
            try:
                for ev in w.stream(list_fn, timeout_seconds=30):
                    q.put((ev["type"], convert(ev["object"])))
                    if self._stop.is_set():
                        return
            except Exception:
                continue  # resync on watch errors, as informers do

    def watch_pods(self) -> "queue.Queue[Event]":
        q: "queue.Queue[Event]" = queue.Queue()
        threading.Thread(
            target=self._watch_loop,
            args=(q, self._core.list_pod_for_all_namespaces, _pod_from_v1),
            daemon=True,
        ).start()
        return q

    def watch_nodes(self) -> "queue.Queue[Event]":
        q: "queue.Queue[Event]" = queue.Queue()
        threading.Thread(
            target=self._watch_loop,
            args=(q, self._core.list_node, _node_from_v1),
            daemon=True,
        ).start()
        return q

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        # POST pods/{name}/binding (k8sclient.go:33-46).
        body = k8s_client.V1Binding(
            metadata=k8s_client.V1ObjectMeta(name=name, namespace=namespace),
            target=k8s_client.V1ObjectReference(
                api_version="v1", kind="Node", name=node_name
            ),
        )
        self._core.create_namespaced_pod_binding(
            name=name, namespace=namespace, body=body, _preload_content=False
        )

    def delete_pod(self, namespace: str, name: str) -> None:
        self._core.delete_namespaced_pod(name=name, namespace=namespace)

    def stop(self) -> None:
        self._stop.set()

"""K8s API object -> watcher-seam conversion (no client dependency).

The quantity parsing and V1Pod/V1Node mapping the real-cluster adapter
(poseidon_tpu_torch.glue.kube_client) applies, split out so it is importable —
and unit-testable — without the ``kubernetes`` package.  The functions
are duck-typed over the official client's models (attribute access only),
exactly the surface the reference unit-tests against fake clientset
objects (reference pkg/k8sclient/nodewatcher_test.go:120-216).
"""

from __future__ import annotations

from poseidon_tpu_torch.glue.fake_kube import Node, Pod


def parse_cpu(q: str) -> int:
    """K8s CPU quantity -> millicores (podwatcher.go:135-147 semantics).

    Also accepts the nanocore/microcore forms metrics.k8s.io serializes
    usage in (e.g. ``231584746n``) — requests use ``m``/plain cores, but
    the metrics agent feeds usage through the same parser.
    """
    if not q:
        return 0
    if q.endswith("n"):
        return int(int(q[:-1]) / 1_000_000)
    if q.endswith("u"):
        return int(int(q[:-1]) / 1_000)
    if q.endswith("m"):
        return int(q[:-1])
    return int(float(q) * 1000)


_MEM_SUFFIX = {
    "Ki": 1, "Mi": 1 << 10, "Gi": 1 << 20, "Ti": 1 << 30,
    "K": 1, "M": 10 ** 3, "G": 10 ** 6, "T": 10 ** 9,
}


def parse_mem_kb(q: str) -> int:
    """K8s memory quantity -> KB (the node watcher's unit)."""
    if not q:
        return 0
    for suf, mult in _MEM_SUFFIX.items():
        if q.endswith(suf):
            return int(float(q[: -len(suf)]) * mult)
    return int(q) >> 10  # plain bytes


def pod_from_v1(p) -> Pod:
    """V1Pod -> watcher-seam Pod (podwatcher.go:135-175 parsing)."""
    cpu = ram = 0
    for c in p.spec.containers or []:
        req = (c.resources and c.resources.requests) or {}
        cpu += parse_cpu(req.get("cpu", ""))
        ram += parse_mem_kb(req.get("memory", ""))
    owner = ""
    if p.metadata.owner_references:
        owner = p.metadata.owner_references[0].uid
    affinity = {}
    anti = {}
    aff = p.spec.affinity
    if aff and aff.pod_affinity:
        for term in (
            aff.pod_affinity
            .required_during_scheduling_ignored_during_execution or []
        ):
            if term.label_selector and term.label_selector.match_labels:
                affinity.update(term.label_selector.match_labels)
    if aff and aff.pod_anti_affinity:
        for term in (
            aff.pod_anti_affinity
            .required_during_scheduling_ignored_during_execution or []
        ):
            if term.label_selector and term.label_selector.match_labels:
                anti.update(term.label_selector.match_labels)
    return Pod(
        name=p.metadata.name,
        namespace=p.metadata.namespace,
        owner_uid=owner,
        scheduler_name=p.spec.scheduler_name or "",
        phase=p.status.phase or "Unknown",
        node_name=p.spec.node_name or "",
        cpu_request=cpu,
        ram_request=ram,
        labels=dict(p.metadata.labels or {}),
        node_selector=dict(p.spec.node_selector or {}),
        pod_affinity=affinity,
        pod_anti_affinity=anti,
        deleted=p.metadata.deletion_timestamp is not None,
    )


def node_from_v1(n) -> Node:
    """V1Node -> watcher-seam Node: Unschedulable gate + Ready/OutOfDisk
    condition mapping (nodewatcher.go:123-178)."""
    cap = n.status.capacity or {}
    ready = True
    out_of_disk = False
    for cond in n.status.conditions or []:
        if cond.type == "Ready":
            ready = cond.status == "True"
        if cond.type == "OutOfDisk":
            out_of_disk = cond.status == "True"
    return Node(
        name=n.metadata.name,
        cpu_capacity=parse_cpu(cap.get("cpu", "")),
        ram_capacity=parse_mem_kb(cap.get("memory", "")),
        unschedulable=bool(n.spec.unschedulable),
        ready=ready,
        out_of_disk=out_of_disk,
        labels=dict(n.metadata.labels or {}),
    )

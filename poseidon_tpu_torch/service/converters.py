"""Proto <-> internal-model converters for the scheduler service.

Unit conventions follow the reference's watchers: CPU in millicores carried
in ``ResourceVector.cpu_cores`` (reference pkg/k8sclient/podwatcher.go:135-147
parses requests into millicores), RAM in KB in ``ram_cap``
(nodewatcher.go:292-339 builds capacity vectors the same way).
"""

from __future__ import annotations

from typing import Dict, List, Set

from poseidon_tpu_torch.graph.ecs import canonical_selectors
from poseidon_tpu_torch.graph.state import MachineInfo, TaskInfo
from poseidon_tpu_torch.protos import firmament_pb2 as fpb


def labels_to_dict(labels) -> Dict[str, str]:
    return {l.key: l.value for l in labels}


def task_info_from_proto(td: fpb.TaskDescriptor, job_id: str = "") -> TaskInfo:
    """Build a TaskInfo from a TaskDescriptor.

    ``job_id`` falls back to the descriptor's own field; TaskSubmitted
    requests carry an explicit JobDescriptor whose uuid wins (the reference
    keys jobs by the descriptor uuid, podwatcher.go:262-268).
    """
    req = td.resource_request
    labels = labels_to_dict(td.labels)
    return TaskInfo(
        uid=int(td.uid),
        job_id=job_id or td.job_id,
        name=td.name,
        cpu_request=int(round(req.cpu_cores)),
        ram_request=int(req.ram_cap),
        net_rx_request=int(req.net_rx_bw),
        priority=int(td.priority),
        task_type=int(td.task_type),
        selectors=canonical_selectors(td.label_selectors),
        pod_affinity=canonical_selectors(td.pod_affinity),
        pod_anti_affinity=canonical_selectors(td.pod_anti_affinity),
        labels=labels,
        # The gangScheduling pod label makes the whole job place
        # atomically (BASELINE config 4).
        gang=labels.get("gangScheduling", "").lower() == "true",
        # Carried binding (restart recovery): the state machine adopts it
        # when the resource resolves to a known machine.
        scheduled_to=td.scheduled_to_resource or None,
        trace_job_id=int(td.trace_job_id),
        trace_task_id=int(td.trace_task_id),
    )


def _collect_subtree(
    rtnd: fpb.ResourceTopologyNodeDescriptor, uuids: Set[str]
) -> None:
    for child in rtnd.children:
        uuids.add(child.resource_desc.uuid)
        _collect_subtree(child, uuids)


def machine_info_from_proto(
    rtnd: fpb.ResourceTopologyNodeDescriptor,
    default_slots: int = 0,
) -> MachineInfo:
    """Machine record from a topology tree.

    Poseidon emits a 2-level Machine -> PU#0 tree (nodewatcher.go:292-339);
    deeper trees are accepted, with capacity read at the root and every
    descendant uuid registered so stats addressed to any level resolve.
    """
    rd = rtnd.resource_desc
    cap = rd.resource_capacity
    subtree: Set[str] = set()
    _collect_subtree(rtnd, subtree)
    slots = int(rd.task_capacity)
    if slots <= 0:
        # Sum child PU slot counts if the root carries none.
        slots = sum(
            int(c.resource_desc.task_capacity) for c in rtnd.children
        )
    machine = MachineInfo(
        uuid=rd.uuid,
        hostname=rd.friendly_name,
        cpu_capacity=int(round(cap.cpu_cores)),
        ram_capacity=int(cap.ram_cap),
        net_rx_capacity=int(cap.net_rx_bw),
        labels=labels_to_dict(rd.labels),
        subtree_uuids=subtree,
        trace_machine_id=int(rd.trace_machine_id),
    )
    # Cost-model stat hooks (whare_map_stats.proto:23-29,
    # coco_interference_scores.proto:24-29): carried when present.
    if rd.HasField("whare_map_stats"):
        wm = rd.whare_map_stats
        machine.whare_stats = (
            int(wm.num_idle), int(wm.num_devils), int(wm.num_rabbits),
            int(wm.num_sheep), int(wm.num_turtles),
        )
    if rd.HasField("coco_interference_scores"):
        co = rd.coco_interference_scores
        machine.coco_penalties = (
            int(co.devil_penalty), int(co.rabbit_penalty),
            int(co.sheep_penalty), int(co.turtle_penalty),
        )
    if slots > 0:
        machine.task_slots = slots
    elif default_slots > 0:
        # The service's max_tasks_per_pu flag (the Firmament
        # --max_tasks_per_pu analog) for topologies that carry no
        # task_capacity of their own.
        machine.task_slots = default_slots
    return machine


def task_stats_sample(ts: fpb.TaskStats) -> dict:
    return {
        "timestamp": int(ts.timestamp),
        "hostname": ts.hostname,
        "cpu_usage": int(ts.cpu_usage),
        "cpu_request": int(ts.cpu_request),
        "cpu_limit": int(ts.cpu_limit),
        "mem_usage": int(ts.mem_usage),
        "mem_request": int(ts.mem_request),
        "mem_limit": int(ts.mem_limit),
        "mem_rss": int(ts.mem_rss),
        "mem_working_set": int(ts.mem_working_set),
        "net_rx_rate": float(ts.net_rx_rate),
        "net_tx_rate": float(ts.net_tx_rate),
    }


def resource_stats_sample(rs: fpb.ResourceStats) -> dict:
    """Fold per-CPU utilization into a machine-level signal.

    The Heapster sink reports one CpuStats entry per logical CPU
    (resource_stats.proto:22-60); the CPU/Mem cost model consumes a single
    machine-level utilization, so average across CPUs.
    """
    cpu_utils: List[float] = [c.cpu_utilization for c in rs.cpus_stats]
    sample = {
        "timestamp": int(rs.timestamp),
        "mem_allocatable": int(rs.mem_allocatable),
        "mem_capacity": int(rs.mem_capacity),
        "disk_bw": int(rs.disk_bw),
        "net_rx_bw": int(rs.net_rx_bw),
        "net_tx_bw": int(rs.net_tx_bw),
    }
    if cpu_utils:
        sample["cpu_utilization"] = float(sum(cpu_utils) / len(cpu_utils))
    if rs.mem_utilization or rs.mem_capacity:
        sample["mem_utilization"] = float(rs.mem_utilization)
    return sample


def deltas_to_proto(deltas) -> fpb.SchedulingDeltas:
    out = fpb.SchedulingDeltas()
    for d in deltas:
        out.deltas.add(
            task_id=int(d.task_id),
            resource_id=d.resource_id,
            type=int(d.type),
        )
    return out

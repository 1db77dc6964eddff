"""Cluster-state checkpoint/restore.

The reference has no checkpointing: Firmament's graph state is in-memory
only and rebuilt from list+watch on restart (SURVEY.md section 5; HA is
an explicit roadmap gap, reference README.md:67).  This module closes
that gap for the service: the whole scheduling state — tasks with
their placements and wait counters, machines with capacities/stat hooks,
the round index — serializes to a single JSON document, so a restarted
service resumes with placements intact even before the client re-plays
its world (the re-play then lands on ALREADY_* replies as usual).

Derived state is NOT serialized: the constraint-mask engine's resident
count matrices (graph/residency.py) and the machine-label interning
cache rebuild through the same mutators ``load_state`` drives
(task_submitted / apply_placements / node_added), so the checkpoint
format stays a pure record of the cluster facts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo

_FORMAT_VERSION = 1


def _task_to_dict(t: TaskInfo) -> dict:
    return {
        "uid": t.uid,
        "job_id": t.job_id,
        "name": t.name,
        "cpu": t.cpu_request,
        "ram": t.ram_request,
        "net": t.net_rx_request,
        "priority": t.priority,
        "task_type": t.task_type,
        "selectors": [list(s[:2]) + [list(s[2])] for s in t.selectors],
        "pod_affinity": [
            list(s[:2]) + [list(s[2])] for s in t.pod_affinity
        ],
        "pod_anti_affinity": [
            list(s[:2]) + [list(s[2])] for s in t.pod_anti_affinity
        ],
        "labels": t.labels,
        "state": int(t.state),
        "scheduled_to": t.scheduled_to,
        "wait_rounds": t.wait_rounds,
        "gang": t.gang,
        "trace_job_id": t.trace_job_id,
        "trace_task_id": t.trace_task_id,
    }


def _sel(rows) -> tuple:
    return tuple((int(s), k, tuple(v)) for s, k, v in rows)


def _task_from_dict(d: dict) -> TaskInfo:
    t = TaskInfo(
        uid=int(d["uid"]),
        job_id=d["job_id"],
        name=d.get("name", ""),
        cpu_request=int(d["cpu"]),
        ram_request=int(d["ram"]),
        net_rx_request=int(d.get("net", 0)),
        priority=int(d.get("priority", 0)),
        task_type=int(d.get("task_type", 0)),
        selectors=_sel(d.get("selectors", [])),
        pod_affinity=_sel(d.get("pod_affinity", [])),
        pod_anti_affinity=_sel(d.get("pod_anti_affinity", [])),
        labels=dict(d.get("labels", {})),
        gang=bool(d.get("gang", False)),
        trace_job_id=int(d.get("trace_job_id", 0)),
        trace_task_id=int(d.get("trace_task_id", 0)),
    )
    return t


def _machine_to_dict(m: MachineInfo) -> dict:
    return {
        "uuid": m.uuid,
        "hostname": m.hostname,
        "cpu": m.cpu_capacity,
        "ram": m.ram_capacity,
        "net": m.net_rx_capacity,
        "slots": m.task_slots,
        "labels": m.labels,
        "healthy": m.healthy,
        "subtree": sorted(m.subtree_uuids),
        "cpu_util": m.cpu_util,
        "mem_util": m.mem_util,
        "whare": list(m.whare_stats) if m.whare_stats else None,
        "coco": list(m.coco_penalties) if m.coco_penalties else None,
        "trace_machine_id": m.trace_machine_id,
    }


def save_state(state: ClusterState, path: Union[str, Path]) -> None:
    with state._lock:
        doc = {
            "version": _FORMAT_VERSION,
            "round_index": state.round_index,
            "machines": [
                _machine_to_dict(m) for m in state.machines.values()
            ],
            "tasks": [_task_to_dict(t) for t in state.tasks.values()],
        }
    _atomic_write(Path(path), json.dumps(doc).encode())


def _atomic_write(path: Path, data: bytes) -> None:
    """Temp file + rename: a crash mid-checkpoint must leave the previous
    checkpoint intact, never a truncated file the next start chokes on."""
    import os

    tmp = path.with_name(path.name + ".tmp")
    fd = os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
    try:
        view = memoryview(data)
        while view:  # os.write may write short (and caps at ~2GB/call)
            view = view[os.write(fd, view):]
        # Without the fsync, a power loss can persist the rename but not
        # the data blocks — an empty checkpoint where "degrade to fresh
        # start" silently discards everything the checkpoint existed for.
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # directory fsync is best-effort (not all FS allow it)


def load_state(path: Union[str, Path],
               use_native: bool = True) -> ClusterState:
    doc = json.loads(Path(path).read_text())
    if doc.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unknown snapshot version {doc.get('version')}")
    state = ClusterState(use_native=use_native)
    for md in doc["machines"]:
        m = MachineInfo(
            uuid=md["uuid"],
            hostname=md.get("hostname", ""),
            cpu_capacity=int(md["cpu"]),
            ram_capacity=int(md["ram"]),
            net_rx_capacity=int(md.get("net", 0)),
            task_slots=int(md.get("slots", 100)),
            labels=dict(md.get("labels", {})),
            subtree_uuids=set(md.get("subtree", [])),
            trace_machine_id=int(md.get("trace_machine_id", 0)),
        )
        if md.get("whare"):
            m.whare_stats = tuple(md["whare"])
        if md.get("coco"):
            m.coco_penalties = tuple(md["coco"])
        state.node_added(m)
        if not md.get("healthy", True):
            state.node_failed(m.uuid)
        m2 = state.machines[m.uuid]
        m2.cpu_util = float(md.get("cpu_util", 0.0))
        m2.mem_util = float(md.get("mem_util", 0.0))
    placements = []
    for td in doc["tasks"]:
        t = _task_from_dict(td)
        state.task_submitted(t)
        st = int(td.get("state", 2))
        if st in (5, 6, 7):  # COMPLETED / FAILED / ABORTED
            state._finish_task(t.uid, st)
        elif td.get("scheduled_to"):
            placements.append((t.uid, td["scheduled_to"]))
        t2 = state.tasks.get(t.uid)
        if t2 is not None:
            t2.wait_rounds = int(td.get("wait_rounds", 0))
    state.apply_placements(placements)
    state.mirror_wait_rounds()
    state.round_index = int(doc.get("round_index", 0))
    return state


def serialize_checkpoint(state: ClusterState, planner):
    """Capture a consistent ``(state_bytes, frames_bytes | None)`` pair.

    Split from the disk write so a caller holding a scheduling lock can
    release it before paying the fsync latency: only the serialization
    needs the consistent view, the durable write does not.
    """
    import numpy as np

    with state._lock:
        doc = {
            "version": _FORMAT_VERSION,
            "round_index": state.round_index,
            "machines": [
                _machine_to_dict(m) for m in state.machines.values()
            ],
            "tasks": [_task_to_dict(t) for t in state.tasks.values()],
        }
        frames = planner.export_warm_state()
    state_bytes = json.dumps(doc).encode()
    if frames:
        import io

        buf = io.BytesIO()
        np.savez_compressed(buf, **frames)
        return state_bytes, buf.getvalue()
    return state_bytes, None


def write_checkpoint(path: Union[str, Path], state_bytes: bytes,
                     frames_bytes) -> None:
    """Durably install serialized checkpoint bytes (atomic + fsync)."""
    _atomic_write(Path(path), state_bytes)
    warm_path = Path(str(path) + ".warm.npz")
    if frames_bytes is not None:
        _atomic_write(warm_path, frames_bytes)
    elif warm_path.exists():
        warm_path.unlink()  # stale frames must not outlive their state


def save_checkpoint(state: ClusterState, planner, path: Union[str, Path]):
    """Full service checkpoint: cluster state (JSON) + the planner's
    solver warm frames (compressed npz at ``<path>.warm.npz``).

    The warm frames are what make recovery fast: restoring state alone
    re-pays the cold epsilon ladder on whatever backlog was pending at
    snapshot time, while a restored frame solves the unchanged backlog at

    the drift-epsilon floor in near-zero iterations.
    """
    write_checkpoint(path, *serialize_checkpoint(state, planner))


def load_checkpoint(path: Union[str, Path], cost_model=None, device=None,
                    strict: bool = False, use_native: bool = True,
                    **planner_kw):
    """Restore ``(state, planner)`` from a checkpoint.

    ``cost_model`` defaults to the CPU/Mem model (the reference's active
    one).  Warm frames are restored when present; with ``strict`` off a
    missing or corrupt frames file degrades to a cold start (the frames
    are an optimization, the state is the truth).  ``use_native`` is
    ``ClusterState``'s.
    """
    import numpy as np

    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner

    state = load_state(path, use_native=use_native)
    planner = RoundPlanner(
        state, cost_model or get_cost_model("cpu_mem"), device=device,
        **planner_kw,
    )
    warm_path = Path(str(path) + ".warm.npz")
    if warm_path.exists():
        try:
            with np.load(warm_path, allow_pickle=False) as frames:
                planner.import_warm_state(dict(frames))
        except Exception:  # noqa: BLE001 - frames are an optimization
            if strict:
                raise
    return state, planner


def load_reference_checkpoint(path: Union[str, Path], cost_model=None,
                              device=None, **planner_kw):
    """Load a checkpoint written by the JAX package
    (``poseidon_tpu.graph.snapshot.serialize_checkpoint`` and
    ``write_checkpoint``: JSON cluster state plus ``.warm.npz`` per-band
    frames) as the port's ``(ClusterState, RoundPlanner)``.  The planner
    holds the same per-band prices and flows, so the next round starts
    warm from the same frames in both packages.  Damaged frames raise."""
    return load_checkpoint(path, cost_model, device, strict=True,
                           **planner_kw)

"""Cost-model interface and the dense tables it consumes.

The graph layer flattens cluster state into two structure-of-arrays tables
(ECTable / MachineTable) so every cost model is a pure vectorized function
numpy -> numpy, trivially portable into the jitted solve when a model is hot
enough to fuse (the CPU/Mem model's arithmetic is all broadcastable).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # annotation-only: no graph <-> costmodel import cycle
    from poseidon_tpu_torch.graph.residency import (
        MachineLabelIndex,
        ResidentCounts,
    )

# The normalized cost range models map into.  Must stay well under the
# solver's COST_CAP (1 << 14) including the unscheduled multiple.
NORMALIZED_COST = 1000


@dataclass
class ECTable:
    """Structure-of-arrays view of the equivalence classes in one round.

    Equivalence classes collapse identical tasks into one supply node —
    Firmament's own scalability trick (SURVEY.md section 2.2).  Tasks fall
    into the same EC iff their request vector, selector set, task type and
    priority are identical (see graph/ecs.py).
    """

    ec_ids: np.ndarray          # uint64 [E] stable EC hash ids
    cpu_request: np.ndarray     # int64 [E] millicores per task
    ram_request: np.ndarray     # int64 [E] KB per task
    supply: np.ndarray          # int32 [E] number of tasks to place
    priority: np.ndarray        # int32 [E]
    task_type: np.ndarray       # int32 [E] SHEEP/RABBIT/DEVIL/TURTLE
    max_wait_rounds: np.ndarray  # int32 [E] max rounds any member has waited
    # Per-EC selector list: (type, key, values) tuples, canonical order.
    selectors: List[Tuple[Tuple[int, str, Tuple[str, ...]], ...]] = field(
        default_factory=list
    )
    # int64 [E] net receive bandwidth request per task (net-aware model).
    net_rx_request: Optional[np.ndarray] = None
    # int32 [E, M] count of this EC's *running* members per machine.  Lets
    # resource-accounting models exclude an EC's own committed usage from
    # its fit check (a running task must not be evicted by its own
    # reservation).
    running_by_machine: Optional[np.ndarray] = None
    # bool [E] rows that must place all-or-nothing (gang jobs; each gang
    # is its own EC row by signature construction).
    is_gang: Optional[np.ndarray] = None
    # Pod-level (anti-)affinity selectors per EC, and the representative
    # member's labels (for the self-satisfying first-pod rule).
    pod_affinity: Optional[List] = None
    pod_anti_affinity: Optional[List] = None
    labels: Optional[List[Dict[str, str]]] = None

    def net_rx(self) -> np.ndarray:
        if self.net_rx_request is None:
            return np.zeros(self.num_ecs, dtype=np.int64)
        return self.net_rx_request

    @property
    def num_ecs(self) -> int:
        return int(self.ec_ids.shape[0])


@dataclass
class MachineTable:
    """Structure-of-arrays view of schedulable machines in one round."""

    uuids: List[str]            # [M] machine resource uuids
    cpu_capacity: np.ndarray    # int64 [M] millicores
    ram_capacity: np.ndarray    # int64 [M] KB
    cpu_used: np.ndarray        # int64 [M] millicores committed (placed tasks)
    ram_used: np.ndarray        # int64 [M] KB committed
    cpu_util: np.ndarray        # float32 [M] measured utilization 0..1 (KB)
    mem_util: np.ndarray        # float32 [M] measured utilization 0..1
    slots_free: np.ndarray      # int32 [M] free task slots
    labels: List[Dict[str, str]] = field(default_factory=list)
    # Net receive bandwidth (net-aware model); zero = unknown/unlimited.
    net_rx_capacity: Optional[np.ndarray] = None   # int64 [M]
    net_rx_used: Optional[np.ndarray] = None       # int64 [M]
    # Interference inputs: resident-task census by type (live placements
    # plus any descriptor-carried WhareMapStats) and per-machine CoCo
    # penalty vectors (devil, rabbit, sheep, turtle).
    type_census: Optional[np.ndarray] = None       # int64 [M, 4]
    coco_penalties: Optional[np.ndarray] = None    # int64 [M, 4]
    # Resident-task label aggregates for pod-level affinity: the round's
    # view of the incrementally-maintained interned count matrices
    # (graph/residency.ResidentCounts — [M, K] counts + totals, machine-
    # column order).  None when no pending task carries pod selectors.
    residents: Optional["ResidentCounts"] = None
    # Interned machine labels for node-selector admissibility, cached
    # across rounds by node generation (graph/state).  None falls back
    # to the per-machine probe engine.
    label_index: Optional["MachineLabelIndex"] = None
    # Observed committed load: like cpu_used/ram_used but with each
    # resident's reservation replaced by its knowledge-base usage EMA
    # (AddTaskStats history) when one exists.  None when the task KB is
    # empty (or in global-reschedule mode, where reservations are zero).
    # Cost models use it for load pricing only — fit stays
    # reservation-based.
    cpu_obs_used: Optional[np.ndarray] = None      # int64 [M] millicores
    ram_obs_used: Optional[np.ndarray] = None      # int64 [M] KB

    @property
    def num_machines(self) -> int:
        return len(self.uuids)

    def census(self) -> np.ndarray:
        if self.type_census is None:
            return np.zeros((self.num_machines, 4), dtype=np.int64)
        return self.type_census


@dataclass
class CostMatrices:
    """What the solver consumes.  costs uses INF_COST for inadmissible arcs.

    arc_capacity bounds how many units of EC e machine m can hold — the
    flow formulation's handle on multi-dimensional fit (the upstream
    cpu_mem model bounds its EC->machine arcs the same way).
    """

    costs: np.ndarray           # int32 [E, M]
    unsched_cost: np.ndarray    # int32 [E]
    capacity: np.ndarray        # int32 [M] machine slot capacity
    arc_capacity: Optional[np.ndarray] = None  # int32 [E, M]


class CostModel:
    """Interface: a pure function of the round's tables."""

    name: str = "base"

    # Delta-plane opt-in (costmodel/delta.CostPlaneCache): True declares
    # that every cost/arc-capacity CELL [e, m] is a pure function of
    # (row attributes captured by the EC id + the EC's representative
    # labels) x (the machine-side inputs listed by ``delta_col_arrays``
    # plus machine labels and resident-label counts) — i.e. building the
    # model on row/column-sliced tables yields bit-identical cells to
    # the full build.  Models reading cross-machine aggregates
    # (type_census rollups, running_by_machine, ...) must NOT opt in.
    delta_plane: bool = False

    def build(self, ecs: ECTable, machines: MachineTable) -> CostMatrices:
        raise NotImplementedError

    def build_unsched(self, ecs: ECTable) -> np.ndarray:
        """The per-EC unscheduled-cost vector ``build`` would emit —
        factored out so the delta-plane cache can refresh the O(E)
        vector every round while reusing cached [E, M] cells.  Required
        for ``delta_plane`` models; others may leave it unimplemented."""
        raise NotImplementedError

    def build_capacity(self, machines: MachineTable) -> np.ndarray:
        """The per-machine slot-capacity vector ``build`` would emit
        (recomputed fresh by the delta-plane cache — slot churn must
        never be masked by cached matrices)."""
        return machines.slots_free.astype(np.int32)

    def delta_col_arrays(self, machines: MachineTable):
        """``[(name, array-or-None), ...]`` — the machine-side numeric
        inputs this model's cells read (column dirtiness is their
        vectorized diff).  Labels and resident counts are diffed by the
        cache itself; arrays that only feed per-machine VECTORS (e.g.
        slots_free -> capacity) must be left out, or every slot change
        would dirty the whole column."""
        raise NotImplementedError

    def max_cost(self) -> int:
        """Static upper bound on every finite cost this model can emit.

        The solver derives its cost scale from this bound instead of the
        instance's observed maximum, so per-round drift in the actual
        cost range cannot move the scale.  Every

        bundled model clips its outputs within 8x NORMALIZED_COST."""
        return 8 * NORMALIZED_COST


def slice_ecs(ecs: ECTable, idx) -> ECTable:
    """Row-sliced ECTable view (shared by the planner's band ladder and
    the delta-plane cache's dirty-row rebuilds).  ``idx`` is an integer
    index array."""
    rows = [int(i) for i in idx]
    return ECTable(
        ec_ids=ecs.ec_ids[idx],
        cpu_request=ecs.cpu_request[idx],
        ram_request=ecs.ram_request[idx],
        supply=ecs.supply[idx],
        priority=ecs.priority[idx],
        task_type=ecs.task_type[idx],
        max_wait_rounds=ecs.max_wait_rounds[idx],
        selectors=[ecs.selectors[i] for i in rows],
        net_rx_request=(
            ecs.net_rx_request[idx]
            if ecs.net_rx_request is not None else None
        ),
        running_by_machine=(
            ecs.running_by_machine[idx]
            if ecs.running_by_machine is not None else None
        ),
        is_gang=ecs.is_gang[idx] if ecs.is_gang is not None else None,
        pod_affinity=(
            [ecs.pod_affinity[i] for i in rows]
            if ecs.pod_affinity is not None else None
        ),
        pod_anti_affinity=(
            [ecs.pod_anti_affinity[i] for i in rows]
            if ecs.pod_anti_affinity is not None else None
        ),
        labels=(
            [ecs.labels[i] for i in rows]
            if ecs.labels is not None else None
        ),
    )


def slice_machines(machines: MachineTable, idx) -> MachineTable:
    """Column-sliced MachineTable view (delta-plane dirty-column
    rebuilds).  Interned index structures slice by machine row; their
    id dicts are shared snapshots."""
    from dataclasses import replace

    from poseidon_tpu_torch.graph.residency import (
        MachineLabelIndex,
        ResidentCounts,
    )

    cols = [int(j) for j in idx]
    residents = machines.residents
    if residents is not None:
        residents = ResidentCounts(
            kv_counts=residents.kv_counts[idx],
            key_counts=residents.key_counts[idx],
            total=residents.total[idx],
            kv_id=residents.kv_id,
            key_id=residents.key_id,
        )
    label_index = machines.label_index
    if label_index is not None:
        label_index = MachineLabelIndex(
            kv_id=label_index.kv_id,
            key_id=label_index.key_id,
            kv_mask=label_index.kv_mask[idx],
            key_mask=label_index.key_mask[idx],
        )
    return replace(
        machines,
        uuids=[machines.uuids[j] for j in cols],
        cpu_capacity=machines.cpu_capacity[idx],
        ram_capacity=machines.ram_capacity[idx],
        cpu_used=machines.cpu_used[idx],
        ram_used=machines.ram_used[idx],
        cpu_util=machines.cpu_util[idx],
        mem_util=machines.mem_util[idx],
        slots_free=machines.slots_free[idx],
        labels=[machines.labels[j] for j in cols],
        net_rx_capacity=(
            machines.net_rx_capacity[idx]
            if machines.net_rx_capacity is not None else None
        ),
        net_rx_used=(
            machines.net_rx_used[idx]
            if machines.net_rx_used is not None else None
        ),
        type_census=(
            machines.type_census[idx]
            if machines.type_census is not None else None
        ),
        coco_penalties=(
            machines.coco_penalties[idx]
            if machines.coco_penalties is not None else None
        ),
        residents=residents,
        label_index=label_index,
        cpu_obs_used=(
            machines.cpu_obs_used[idx]
            if machines.cpu_obs_used is not None else None
        ),
        ram_obs_used=(
            machines.ram_obs_used[idx]
            if machines.ram_obs_used is not None else None
        ),
    )


_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    _REGISTRY[cls.name] = cls
    return cls


def get_cost_model(name: str, **kwargs) -> CostModel:
    """Cost-model selection by flag, the analog of Firmament's
    ``--flagfile=...cpu_mem.cfg`` model switch (reference
    deploy/firmament-deployment.yaml:29-31)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cost model {name!r}; have {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)

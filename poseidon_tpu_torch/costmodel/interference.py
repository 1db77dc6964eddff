"""Interference-aware cost models: Whare-Map and CoCo (the port of
``poseidon_tpu/costmodel/interference.py``).

Firmament's interference vocabulary classifies tasks as SHEEP (quiet),
RABBIT (bursty), DEVIL (antagonist), TURTLE (slow/sensitive)
(task_desc.proto:45-50; classified from the ``taskType`` pod label,
podwatcher.go:478-495).  Two cost models consume it:

- **Whare-Map** (whare_map_stats.proto:23-29): scores a placement by the
  co-location census of the target machine — who already lives there.
  The arc cost adds a pairwise penalty ``P[task_type, resident_type]``
  per resident, so devils price themselves away from turtles etc.  The
  census combines live placements (tracked by the graph layer each round)
  with any descriptor-carried WhareMapStats.
- **CoCo** (coco_interference_scores.proto:24-29): each machine carries a
  per-class penalty vector (devil/rabbit/sheep/turtle_penalty); the arc
  cost adds the machine's penalty for the task's class.  Penalties arrive
  on the ResourceDescriptor at NodeAdded/NodeUpdated time.

Both models keep the CPU/Mem fit + selector admissibility gates (admission
is graph shape, not policy) and add their interference term on top of the
load-balancing base cost.  All arithmetic is broadcastable numpy over
``[E, M]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from poseidon_tpu_torch.costmodel import base
from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel

# Pairwise co-location penalty [task_type, resident_type] in normalized
# cost units per resident, rows/cols ordered SHEEP, RABBIT, DEVIL, TURTLE.
# Shape follows the Whare-Map intuition: devils antagonize everyone
# (especially turtles); sheep are nearly indifferent; turtles are the most
# sensitive class.
DEFAULT_WHARE_PENALTY = np.array(
    [
        #  SHEEP RABBIT DEVIL TURTLE   <- resident
        [    2,    5,   40,    2],   # placing a SHEEP
        [    5,   15,   60,    5],   # placing a RABBIT
        [   10,   30,   80,   50],   # placing a DEVIL
        [    5,   20,  100,   10],   # placing a TURTLE
    ],
    dtype=np.int64,
)


@base.register
@dataclass
class WhareMapCostModel(base.CostModel):
    name = "whare"

    penalty: np.ndarray = field(
        default_factory=lambda: DEFAULT_WHARE_PENALTY.copy()
    )
    # Cap on the interference term so a crowded machine saturates instead
    # of overflowing the solver's cost range.
    max_interference: int = 2 * base.NORMALIZED_COST
    base_model: CpuMemCostModel = field(default_factory=CpuMemCostModel)

    def build(
        self, ecs: base.ECTable, machines: base.MachineTable
    ) -> base.CostMatrices:
        cm = self.base_model.build(ecs, machines)
        E, M = ecs.num_ecs, machines.num_machines
        if E == 0 or M == 0:
            return cm
        census = machines.census()                        # [M, 4]
        ttype = np.clip(ecs.task_type, 0, 3)              # [E]
        # interference[e, m] = sum_s penalty[type_e, s] * census[m, s]
        add = self.penalty[ttype] @ census.T              # [E, M]
        # Self-exclusion on arcs where this EC already runs: a resident
        # counted itself in the census (penalty[t, t] per unit), which
        # would make the current machine look strictly worse than an
        # identical empty one and ping-pong the task every round.
        resident = None
        if ecs.running_by_machine is not None:
            resident = ecs.running_by_machine > 0         # [E, M]
            self_pen = self.penalty[ttype, ttype][:, None]  # [E, 1]
            add = add - resident * self_pen
        add = np.clip(add, 0, self.max_interference)
        from poseidon_tpu_torch.ops.transport import INF_COST

        costs = cm.costs.astype(np.int64) + add
        if resident is not None:
            # 1-unit stability discount so exact ties break toward staying
            # put (Firmament's migration hysteresis), applied to the final
            # cost so the zero-floor above cannot absorb it.
            costs = np.maximum(costs - resident, 0)
        costs = np.where(
            cm.costs < INF_COST,
            np.minimum(costs, INF_COST - 1),
            INF_COST,
        ).astype(np.int32)
        return base.CostMatrices(
            costs=costs,
            unsched_cost=cm.unsched_cost,
            capacity=cm.capacity,
            arc_capacity=cm.arc_capacity,
        )


@base.register
@dataclass
class CoCoCostModel(base.CostModel):
    name = "coco"

    # Scale applied to descriptor penalties (wire values are small uints).
    penalty_weight: int = 1
    max_interference: int = 2 * base.NORMALIZED_COST
    base_model: CpuMemCostModel = field(default_factory=CpuMemCostModel)

    def build(
        self, ecs: base.ECTable, machines: base.MachineTable
    ) -> base.CostMatrices:
        cm = self.base_model.build(ecs, machines)
        E, M = ecs.num_ecs, machines.num_machines
        if E == 0 or M == 0:
            return cm
        from poseidon_tpu_torch.ops.transport import INF_COST

        pen = machines.coco_penalties
        if pen is None:
            return cm
        # Descriptor order is (devil, rabbit, sheep, turtle); task_type
        # wire order is SHEEP=0 RABBIT=1 DEVIL=2 TURTLE=3.
        order = np.array([2, 1, 0, 3])
        per_class = pen[:, order]                          # [M, 4] by task_type
        ttype = np.clip(ecs.task_type, 0, 3)
        add = np.clip(
            per_class.T[ttype] * self.penalty_weight,
            0, self.max_interference,
        ).astype(np.int32)                                 # [E, M]
        costs = np.where(
            cm.costs < INF_COST,
            np.minimum(cm.costs + add, INF_COST - 1),
            INF_COST,
        ).astype(np.int32)
        return base.CostMatrices(
            costs=costs,
            unsched_cost=cm.unsched_cost,
            capacity=cm.capacity,
            arc_capacity=cm.arc_capacity,
        )

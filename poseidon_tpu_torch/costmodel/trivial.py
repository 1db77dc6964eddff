"""Trivial cost model: fixed arc costs, selector gating only.

The analog of Firmament's trivial cost model — useful as a solver-behavior
baseline (all admissible placements cost the same, so the solve reduces to
feasibility/max-cardinality) and for tests that want placement decisions
isolated from load arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from poseidon_tpu_torch.costmodel import base
from poseidon_tpu_torch.costmodel.selectors import selector_admissibility
from poseidon_tpu_torch.ops.transport import INF_COST


@base.register
@dataclass
class TrivialCostModel(base.CostModel):
    name = "trivial"

    arc_cost: int = base.NORMALIZED_COST // 2
    unsched_cost: int = 2 * base.NORMALIZED_COST

    def build(
        self, ecs: base.ECTable, machines: base.MachineTable
    ) -> base.CostMatrices:
        E, M = ecs.num_ecs, machines.num_machines
        costs = np.full((E, M), self.arc_cost, dtype=np.int32)
        if E and M:
            # Even the trivial model respects fit and selectors: admission
            # is part of the graph shape, not of cost policy.
            cpu_free = (machines.cpu_capacity - machines.cpu_used)[None, :]
            ram_free = (machines.ram_capacity - machines.ram_used)[None, :]
            fits = (ecs.cpu_request[:, None] <= cpu_free) & (
                ecs.ram_request[:, None] <= ram_free
            )
            adm = fits & selector_admissibility(ecs.selectors, machines.labels)
            costs = np.where(adm, costs, INF_COST).astype(np.int32)
        return base.CostMatrices(
            costs=costs,
            unsched_cost=np.full(E, self.unsched_cost, dtype=np.int32),
            capacity=machines.slots_free.astype(np.int32),
        )

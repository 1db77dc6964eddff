"""Network-aware cost model (the port of ``poseidon_tpu/costmodel/net.py``).

The reference's network-aware scheduling path: pods declare a
``networkRequirement`` label that the pod watcher turns into a
``ResourceVector.net_rx_bw`` request (podwatcher.go:467-476;
resource_vector.proto:33-37), and the cost model must both gate placement
on available bandwidth and prefer network-idle machines.

Semantics here:
- admissibility additionally requires
  ``net_rx_request <= net_rx_capacity - net_rx_used`` on machines that
  declare a capacity (capacity 0 = no network accounting, always admits);
- the arc cost blends the CPU/Mem load cost with the post-placement
  network utilization, so bandwidth-hungry tasks spread across NICs;
- per-arc capacity additionally bounds how many tasks fit the remaining
  bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from poseidon_tpu_torch.costmodel import base
from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel
from poseidon_tpu_torch.ops.transport import INF_COST


@base.register
@dataclass
class NetAwareCostModel(base.CostModel):
    name = "net"

    # Weight of the network-utilization term vs the CPU/Mem base cost.
    net_weight: float = 0.5
    base_model: CpuMemCostModel = field(default_factory=CpuMemCostModel)

    def build(
        self, ecs: base.ECTable, machines: base.MachineTable
    ) -> base.CostMatrices:
        cm = self.base_model.build(ecs, machines)
        E, M = ecs.num_ecs, machines.num_machines
        if E == 0 or M == 0:
            return cm
        net_req = ecs.net_rx().astype(np.float64)[:, None]       # [E, 1]
        cap = machines.net_rx_capacity
        used = machines.net_rx_used
        if cap is None:
            return cm
        cap = cap.astype(np.float64)[None, :]                    # [1, M]
        used = (
            used if used is not None else np.zeros(M, dtype=np.int64)
        ).astype(np.float64)[None, :]
        accounted = cap > 0
        # Free bandwidth per (EC, machine): total minus other tasks'
        # commitments — an EC's own running members' bandwidth is reusable
        # by the re-solve, so a running task never evicts itself.
        self_used = (
            ecs.running_by_machine.astype(np.float64) * net_req
            if ecs.running_by_machine is not None
            else 0.0
        )
        free = np.maximum(cap - used + self_used, 0.0)

        fits = ~accounted | (net_req <= free)
        admissible = (cm.costs < INF_COST) & fits

        # How many tasks of this EC the remaining bandwidth admits.
        with np.errstate(divide="ignore", invalid="ignore"):
            n_net = np.where(
                accounted & (net_req > 0),
                np.floor(free / np.maximum(net_req, 1e-9)),
                np.inf,
            )
        n_net = np.where(np.isfinite(n_net), n_net, np.iinfo(np.int32).max // 4)
        arc_cap = cm.arc_capacity
        if arc_cap is None:
            arc_cap = np.full((E, M), np.iinfo(np.int32).max // 4, np.int32)
        arc_cap = np.minimum(arc_cap, n_net).astype(np.int32)
        arc_cap = np.where(admissible, arc_cap, 0).astype(np.int32)

        # Post-placement network utilization as the added cost term.
        util_after = np.where(
            accounted, (used + net_req) / np.maximum(cap, 1.0), 0.0
        )
        w = float(self.net_weight)
        add = np.rint(
            np.clip(util_after, 0.0, 2.0) * w * base.NORMALIZED_COST
        ).astype(np.int64)
        costs = np.where(
            admissible,
            np.minimum(cm.costs.astype(np.int64) + add, INF_COST - 1),
            INF_COST,
        ).astype(np.int32)
        return base.CostMatrices(
            costs=costs,
            unsched_cost=cm.unsched_cost,
            capacity=cm.capacity,
            arc_capacity=arc_cap,
        )

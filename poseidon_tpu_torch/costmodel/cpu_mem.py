"""The multi-dimensional CPU/Memory cost model.

Reproduces the behavior of the reference deployment's active cost model
(reference README.md:53-59 "multi-dimensional CPU/Memory cost model";
selected by ``firmament_scheduler_cpu_mem.cfg``,
deploy/firmament-deployment.yaml:29-31).  Behavioral contract:

- an EC->machine arc exists only if the task's request fits the machine's
  *currently unreserved* capacity in every dimension and the EC's selectors
  admit the machine (node-level affinity, reference roadmap release 0.2);
- arc cost grows with the machine's load after placement, averaged over the
  CPU and memory dimensions, so the solve spreads load / picks the least
  loaded machines first and the flow optimum matches the "globally optimal
  for a given policy" claim (README.md:26);
- measured utilization from the knowledge base (AddNodeStats round-trip) is
  blended with request-based reservation so chronically hot machines price
  themselves out even when reservations look light;
- the unscheduled fallback cost rises with how many rounds the EC's tasks
  have waited, bounding starvation (Firmament's unscheduled-aggregator cost
  scales with wait time the same way).

All arithmetic is broadcastable [E,1]x[1,M] numpy; no Python loops over
arcs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from poseidon_tpu_torch.costmodel import base
from poseidon_tpu_torch.costmodel.selectors import (
    _matches,
    pod_selector_admissibility,
    selector_admissibility,
)
from poseidon_tpu_torch.ops.transport import INF_COST, sparse_adm_cells
from poseidon_tpu_torch.utils.stagetimer import stage as _stage


@base.register
@dataclass
class CpuMemCostModel(base.CostModel):
    name = "cpu_mem"

    # Blend between reservation-based load (requests) and measured load
    # (knowledge-base utilization).
    measured_weight: float = 0.25
    # Relative weight of the CPU dimension vs memory.
    cpu_weight: float = 0.5
    # Unscheduled cost: base multiple of the normalized cost range plus a
    # per-wait-round escalator.
    unsched_base: int = 2 * base.NORMALIZED_COST
    unsched_per_round: int = base.NORMALIZED_COST // 4

    # Every cost/arc-capacity cell is a pure broadcastable function of
    # (EC request/selectors/labels) x (machine capacity/usage/util/
    # labels/residents) — the delta-plane cache's contract (and the
    # reason this module forbids cross-cell arithmetic; see
    # tests/test_cost_delta.py's oracle-parity suite).
    delta_plane = True

    def build_unsched(self, ecs: base.ECTable) -> np.ndarray:
        """Per-EC unscheduled cost (the starvation escalator) — the one
        ``build`` output that moves every round regardless of cost-plane
        churn, so the delta cache recomputes it fresh."""
        unsched = (
            self.unsched_base
            + self.unsched_per_round * ecs.max_wait_rounds.astype(np.int64)
        )
        return np.clip(
            unsched, 0, 8 * base.NORMALIZED_COST
        ).astype(np.int32)

    def delta_col_arrays(self, machines: base.MachineTable):
        """Machine-side cell inputs (fit, load pricing, blending);
        slots_free feeds only the capacity VECTOR and is excluded."""
        return [
            ("cpu_capacity", machines.cpu_capacity),
            ("ram_capacity", machines.ram_capacity),
            ("cpu_used", machines.cpu_used),
            ("ram_used", machines.ram_used),
            ("cpu_util", machines.cpu_util),
            ("mem_util", machines.mem_util),
            ("cpu_obs_used", machines.cpu_obs_used),
            ("ram_obs_used", machines.ram_obs_used),
        ]

    def build(
        self, ecs: base.ECTable, machines: base.MachineTable
    ) -> base.CostMatrices:
        E, M = ecs.num_ecs, machines.num_machines
        unsched = self.build_unsched(ecs)
        if E == 0 or M == 0:
            # No arcs to price, but the starvation escalator still applies
            # (a machineless round must not report zero unscheduled cost).
            return base.CostMatrices(
                costs=np.zeros((E, M), dtype=np.int32),
                unsched_cost=unsched,
                capacity=machines.slots_free.astype(np.int32),
                arc_capacity=np.zeros((E, M), dtype=np.int32),
            )

        cpu_cap = np.maximum(machines.cpu_capacity.astype(np.float64), 1.0)
        ram_cap = np.maximum(machines.ram_capacity.astype(np.float64), 1.0)
        cpu_req = ecs.cpu_request.astype(np.float64)[:, None]      # [E,1]
        ram_req = ecs.ram_request.astype(np.float64)[:, None]

        # Fit: request must fit what is not already committed to placed
        # tasks.  (Measured utilization does not gate fit — reservations
        # do, as in the reference's reservation-based admission.)
        cpu_free = (machines.cpu_capacity - machines.cpu_used).astype(
            np.float64
        )[None, :]
        ram_free = (machines.ram_capacity - machines.ram_used).astype(
            np.float64
        )[None, :]
        fits = (cpu_req <= cpu_free) & (ram_req <= ram_free)

        with _stage("round.mask_build"):
            constraint_mask = selector_admissibility(
                ecs.selectors, machines.labels, machines.label_index
            )
            if (
                machines.residents is not None
                and ecs.pod_affinity is not None
            ):
                constraint_mask &= pod_selector_admissibility(
                    ecs.pod_affinity, ecs.pod_anti_affinity, ecs.labels,
                    machines.residents,
                )
        admissible = fits & constraint_mask

        # Heavily-constrained rounds (pod affinity pinning each EC to a
        # handful of machines) leave a vanishing admissible fraction of
        # a large [E, M] plane: compute the per-arc capacity and cost
        # surfaces ONLY at admissible cells then (identical float64
        # arithmetic in the same operation order, so the result is
        # bit-identical to the dense build).  Dense rounds keep the
        # full-matrix broadcasts below.
        sparse_cells = sparse_adm_cells(admissible)

        # Per-arc capacity: how many tasks of EC e fit machine m's free
        # resources simultaneously (min over dimensions).  This is the
        # flow network's multi-dimensional packing bound.
        big_fit = np.iinfo(np.int32).max // 4
        if sparse_cells is not None:
            rows, cols = sparse_cells
            cpu_req_v = cpu_req[rows, 0]
            ram_req_v = ram_req[rows, 0]
            cpu_free_v = cpu_free[0, cols]
            ram_free_v = ram_free[0, cols]
            with np.errstate(divide="ignore", invalid="ignore"):
                n_cpu_v = np.where(
                    cpu_req_v > 0,
                    np.floor(cpu_free_v / np.maximum(cpu_req_v, 1e-9)),
                    np.inf,
                )
                n_ram_v = np.where(
                    ram_req_v > 0,
                    np.floor(ram_free_v / np.maximum(ram_req_v, 1e-9)),
                    np.inf,
                )
            n_fit_v = np.minimum(n_cpu_v, n_ram_v)
            # Saturate at big_fit BEFORE the int32 cast: a finite fit
            # count (huge free / tiny request) can exceed 2^31 and the
            # bare astype would wrap it negative — an arc capacity of
            # big_fit is already "unbounded" to the flow network.
            n_fit_v = np.minimum(
                np.where(np.isfinite(n_fit_v), n_fit_v, big_fit), big_fit
            )
            arc_cap = np.zeros((E, M), dtype=np.int32)
            arc_cap[rows, cols] = n_fit_v.astype(np.int32)
        else:
            # Row dedup: every resource surface below depends on the EC
            # row ONLY through (cpu_request, ram_request), and feature
            # rounds carry hundreds of same-shape ECs (the 10k gang
            # config: 501 rows, 2 shapes — 501 rows of float64 broadcasts
            # for 2 distinct rows' worth of information).  Compute the

            # [U, M] unique-shape surfaces once and GATHER: the same
            # float64 ops in the same order produce each cell, so the
            # result is bit-identical to the direct [E, M] build.
            shape_u, shape_inv = np.unique(
                np.stack([ecs.cpu_request, ecs.ram_request], axis=1),
                axis=0, return_inverse=True,
            )
            dedup = 2 * shape_u.shape[0] <= E
            if dedup:
                cpu_req_d = shape_u[:, 0].astype(np.float64)[:, None]
                ram_req_d = shape_u[:, 1].astype(np.float64)[:, None]
            else:
                cpu_req_d, ram_req_d = cpu_req, ram_req
            with np.errstate(divide="ignore", invalid="ignore"):
                n_cpu = np.where(
                    cpu_req_d > 0,
                    np.floor(cpu_free / np.maximum(cpu_req_d, 1e-9)),
                    np.inf,
                )
                n_ram = np.where(
                    ram_req_d > 0,
                    np.floor(ram_free / np.maximum(ram_req_d, 1e-9)),
                    np.inf,
                )
            n_fit = np.minimum(n_cpu, n_ram)
            # Same saturation as the sparse path: finite fits past
            # big_fit clamp instead of wrapping through astype(int32).
            n_fit = np.minimum(
                np.where(np.isfinite(n_fit), n_fit, big_fit), big_fit
            )
            n_fit_i = n_fit.astype(np.int32)
            if dedup:
                n_fit_i = n_fit_i[shape_inv]
            arc_cap = np.where(admissible, n_fit_i, np.int32(0))

        # Anti-affinity to self = spreading: members of such an EC cannot
        # co-locate, so each machine takes at most one per round (running
        # residents already exclude their machines via the mask).
        if ecs.pod_anti_affinity is not None and ecs.labels is not None:
            for e, sels in enumerate(ecs.pod_anti_affinity):
                if sels and any(_matches(ecs.labels[e], s) for s in sels):
                    arc_cap[e] = np.minimum(arc_cap[e], 1)

        # Load after placement, per dimension, blending reserved and
        # measured load.  The committed term prefers the knowledge base's
        # observed per-task usage (AddTaskStats EMAs, rolled up per
        # machine in build_round_view) over raw reservations when
        # history exists — chronically hungry residents price their
        # machine up, chronically idle ones price it down.  Fit above
        # stays reservation-based.
        cpu_committed = (
            machines.cpu_obs_used
            if machines.cpu_obs_used is not None else machines.cpu_used
        )
        ram_committed = (
            machines.ram_obs_used
            if machines.ram_obs_used is not None else machines.ram_used
        )
        w = float(self.measured_weight)
        wc = float(self.cpu_weight)
        if sparse_cells is not None:
            cpu_load_v = (
                (1.0 - w)
                * (cpu_committed.astype(np.float64)[cols] + cpu_req_v)
                / cpu_cap[cols]
                + w * machines.cpu_util.astype(np.float64)[cols]
            )
            mem_load_v = (
                (1.0 - w)
                * (ram_committed.astype(np.float64)[cols] + ram_req_v)
                / ram_cap[cols]
                + w * machines.mem_util.astype(np.float64)[cols]
            )
            load_v = wc * cpu_load_v + (1.0 - wc) * mem_load_v
            costs = np.full((E, M), INF_COST, dtype=np.int32)
            costs[rows, cols] = np.clip(
                np.rint(load_v * base.NORMALIZED_COST),
                0, 4 * base.NORMALIZED_COST,
            ).astype(np.int32)
        else:
            # Same unique-shape gather as the packing bound above.
            cpu_load = (
                (1.0 - w)
                * (cpu_committed[None, :] + cpu_req_d) / cpu_cap[None, :]
                + w * machines.cpu_util.astype(np.float64)[None, :]
            )
            mem_load = (
                (1.0 - w)
                * (ram_committed[None, :] + ram_req_d) / ram_cap[None, :]
                + w * machines.mem_util.astype(np.float64)[None, :]
            )
            load = wc * cpu_load + (1.0 - wc) * mem_load
            costs = np.clip(
                np.rint(load * base.NORMALIZED_COST),
                0, 4 * base.NORMALIZED_COST,
            ).astype(np.int32)
            if dedup:
                costs = costs[shape_inv]
            costs = np.where(admissible, costs, INF_COST).astype(np.int32)

        return base.CostMatrices(
            costs=costs,
            unsched_cost=unsched,
            capacity=machines.slots_free.astype(np.int32),
            arc_capacity=arc_cap,
        )

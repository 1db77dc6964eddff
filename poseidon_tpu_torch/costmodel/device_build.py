"""Device-side cost-matrix construction for chained band solves (the port
of ``poseidon_tpu/costmodel/device_build.py``).

A wave's bands are chained: band k+1's costs depend on the machine load
band k's flows commit.  Building band k+1's ``[E, M]`` cost, arc and
column-capacity planes on the device from band k's device-resident
flows removes the flow fetch, the host build and the re-upload from the
wave's critical path; the host ships only O(E + M) vectors and the
admissibility mask.

Semantics mirror ``costmodel/cpu_mem.py`` plus the per-column capacity
denominator of ``graph/instance._solve_banded``:

- the integer terms (fit mask, per-arc capacity, column capacity, slot
  capacity) are int32 arithmetic, exactly equal to the host build;
- the load-derived cost surface is float32 (the host builds it in
  float64, so entries can differ from the host's by one normalized cost
  unit at rounding boundaries).

**The float32 order of operations is the jitted reference's, bit for
bit.**  XLA's CPU compiler contracts a multiply feeding an add into one
fused multiply-add (one rounding instead of two) wherever the pattern
``a * b + c`` appears, and the reference's program runs under ``jit``.
Measured on seeded ``[32, 10240]`` planes against
``jax.jit(device_cost_build)``, three contractions happen, and only
these three:

    cpu_load = fma(w, cpu_util, (1 - w) * (cpu_com + req) / cpu_cap)
    mem_load = fma(w, mem_util, (1 - w) * (ram_com + req) / ram_cap)
    load     = fma(wc, cpu_load, (1 - wc) * mem_load)

(in the blend, the left product is the one fused; the right one is
rounded first).  Computing any of the three as a rounded multiply and a
rounded add differs from the jitted program on a few entries per plane.
``_fma32`` computes a correctly rounded float32 fma from float64 parts:
the product of two float32 values is exact in float64, the sum's
rounding error comes from TwoSum, and rounding the float64 sum to odd
before the final rounding to float32 makes the double rounding exact.
Every step is an IEEE-754 operation, so the CPU and the card give the
same bits.

The admissibility mask (selectors, pod (anti-)affinity against resident
tasks) stays host-computed: it is label-set logic over the interned
label and resident count matrices (costmodel/selectors.py), independent
of earlier bands' flows, and ships as one ``[E, M]`` int8 plane.
"""

from __future__ import annotations

import numpy as np
import torch

from poseidon_tpu_torch.costmodel import base
from poseidon_tpu_torch.costmodel.selectors import (
    _matches,
    pod_selector_admissibility,
    selector_admissibility,
)
from poseidon_tpu_torch.ops.transport import I32, INF_COST

_BIG_FIT = np.iinfo(np.int32).max // 4


def extract_band_operands(ecs_b, mt, model) -> dict:
    """Host-side operands of ``device_cost_build`` that do not depend on
    any earlier band's flows, so they can be staged while the previous
    band is still solving.  ``model`` supplies the cpu_mem blend and clip
    constants; the unsched escalator is evaluated here (it depends only
    on wait counters)."""
    E = ecs_b.num_ecs
    unsched = (
        model.unsched_base
        + model.unsched_per_round * ecs_b.max_wait_rounds.astype(np.int64)
    )
    unsched = np.clip(unsched, 0, 8 * base.NORMALIZED_COST).astype(np.int32)

    adm0 = selector_admissibility(
        ecs_b.selectors, mt.labels, mt.label_index
    )
    if mt.residents is not None and ecs_b.pod_affinity is not None:
        adm0 = adm0 & pod_selector_admissibility(
            ecs_b.pod_affinity, ecs_b.pod_anti_affinity, ecs_b.labels,
            mt.residents,
        )
    anti_self = np.zeros(E, dtype=bool)
    if ecs_b.pod_anti_affinity is not None and ecs_b.labels is not None:
        for e, sels in enumerate(ecs_b.pod_anti_affinity):
            if sels and any(_matches(ecs_b.labels[e], s) for s in sels):
                anti_self[e] = True

    cpu_obs = mt.cpu_obs_used if mt.cpu_obs_used is not None else mt.cpu_used
    ram_obs = mt.ram_obs_used if mt.ram_obs_used is not None else mt.ram_used
    return {
        "cpu_req": ecs_b.cpu_request.astype(np.int32),
        "ram_req": ecs_b.ram_request.astype(np.int32),
        "unsched": unsched,
        "adm0": adm0.astype(np.int8),
        "anti_self": anti_self.astype(np.int8),
        "cpu_cap": mt.cpu_capacity.astype(np.int32),
        "ram_cap": mt.ram_capacity.astype(np.int32),
        "cpu_used0": mt.cpu_used.astype(np.int32),
        "ram_used0": mt.ram_used.astype(np.int32),
        "cpu_obs0": cpu_obs.astype(np.int32),
        "ram_obs0": ram_obs.astype(np.int32),
        "cpu_util": mt.cpu_util.astype(np.float32),
        "mem_util": mt.mem_util.astype(np.float32),
        "slots_free0": mt.slots_free.astype(np.int32),
        "measured_weight": np.float32(model.measured_weight),
        "cpu_weight": np.float32(model.cpu_weight),
    }


def int_surfaces_host(ops, delta_cpu, delta_ram, delta_slots):
    """Numpy twin of ``device_cost_build``'s integer surfaces, given the
    committed deltas the device measured (they come home with the chained
    solve's stat vector).  Bit-exact against the device by construction
    (the same int32 formulas), so the chained path certifies band 2's arc
    and column capacities without fetching two more ``[E, M]`` planes;
    only the float-derived cost plane travels."""
    cpu_req = ops["cpu_req"].astype(np.int64)[:, None]
    ram_req = ops["ram_req"].astype(np.int64)[:, None]
    adm0 = ops["adm0"].astype(bool)
    cpu_committed = ops["cpu_used0"].astype(np.int64) + delta_cpu
    ram_committed = ops["ram_used0"].astype(np.int64) + delta_ram
    cpu_free = (ops["cpu_cap"] - cpu_committed)[None, :]
    ram_free = (ops["ram_cap"] - ram_committed)[None, :]
    fits = (cpu_req <= cpu_free) & (ram_req <= ram_free)
    admissible = fits & adm0
    n_cpu = np.where(
        cpu_req > 0,
        np.maximum(cpu_free, 0) // np.maximum(cpu_req, 1), _BIG_FIT,
    )
    n_ram = np.where(
        ram_req > 0,
        np.maximum(ram_free, 0) // np.maximum(ram_req, 1), _BIG_FIT,
    )
    n_fit = np.minimum(np.minimum(n_cpu, n_ram), _BIG_FIT)
    arc_cap = np.where(admissible, n_fit, 0).astype(np.int32)
    arc_cap = np.where(
        ops["anti_self"].astype(bool)[:, None],
        np.minimum(arc_cap, 1), arc_cap,
    )
    capacity = np.maximum(
        ops["slots_free0"].astype(np.int64) - delta_slots, 0
    ).astype(np.int32)
    col_cap = capacity.astype(np.int64)
    for req, cap_arr, committed in (
        (ops["cpu_req"], ops["cpu_cap"], cpu_committed),
        (ops["ram_req"], ops["ram_cap"], ram_committed),
    ):
        denom = np.where(admissible, req.astype(np.int64)[:, None], 0)
        denom = denom.max(axis=0)
        free = np.maximum(cap_arr.astype(np.int64) - committed, 0)
        col_cap = np.where(
            denom > 0,
            np.minimum(col_cap, free // np.maximum(denom, 1)),
            col_cap,
        )
    return arc_cap, capacity, np.clip(col_cap, 0, None).astype(np.int32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding), from
    float64 operations only (see the module docstring)."""
    p = a.double() * b.double()              # exact: 24 + 24 bits < 53
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))         # TwoSum: s + err == p + c
    # Round s to odd: an inexact s with an even last bit steps one ulp
    # toward the exact sum, so the rounding to float32 below is exact.
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def device_cost_build(ops, delta_cpu, delta_ram, delta_slots):
    """The cost build of one band given earlier bands' committed deltas,
    as torch ops on the operands' device.

    ``ops`` holds tensors on one device: ``extract_band_operands``'s
    vectors (int32 requests, capacities and usage, float32 utilizations),
    ``adm0`` (int8 ``[E, M]``), ``anti_self`` (int ``[E]``), and the
    float32 0-d ``measured_weight`` and ``cpu_weight``.  ``delta_*`` are
    ``[M]`` int32 tensors of the resources the round's earlier bands
    committed (zero for the first band).

    Returns ``(costs, arc_cap, capacity, col_cap)``, int32: the operand
    set ``_solve_banded`` feeds a band's solve.
    """
    cpu_req = ops["cpu_req"][:, None]                       # [E, 1] i32
    ram_req = ops["ram_req"][:, None]
    adm0 = ops["adm0"].bool()
    cpu_committed = ops["cpu_used0"] + delta_cpu            # [M] i32
    ram_committed = ops["ram_used0"] + delta_ram

    # Fit: reservation-based free capacity, integer-exact.  Raw (it can
    # go negative on an overcommitted machine): a zero-request row must
    # not fit there.
    cpu_free = (ops["cpu_cap"] - cpu_committed)[None, :]
    ram_free = (ops["ram_cap"] - ram_committed)[None, :]
    fits = (cpu_req <= cpu_free) & (ram_req <= ram_free)
    admissible = fits & adm0

    # Per-arc capacity: floor(free / req) per dimension, integer-exact.
    n_cpu = torch.where(
        cpu_req > 0,
        torch.clamp(cpu_free, min=0) // torch.clamp(cpu_req, min=1),
        _BIG_FIT)
    n_ram = torch.where(
        ram_req > 0,
        torch.clamp(ram_free, min=0) // torch.clamp(ram_req, min=1),
        _BIG_FIT)
    n_fit = torch.clamp(torch.minimum(n_cpu, n_ram), max=_BIG_FIT)
    arc_cap = torch.where(admissible, n_fit, 0).to(I32)
    # Anti-affinity to self = spreading: at most one member per machine.
    arc_cap = torch.where(
        ops["anti_self"].bool()[:, None],
        torch.clamp(arc_cap, max=1), arc_cap,
    )

    # Load after placement, float32 in the jitted reference's order.
    w = ops["measured_weight"]
    wc = ops["cpu_weight"]
    cpu_capf = torch.clamp(ops["cpu_cap"].float(), min=1.0)
    ram_capf = torch.clamp(ops["ram_cap"].float(), min=1.0)
    cpu_com = (ops["cpu_obs0"] + delta_cpu).float()
    ram_com = (ops["ram_obs0"] + delta_ram).float()
    cpu_div = ((1.0 - w) * (cpu_com[None, :] + cpu_req.float())
               / cpu_capf[None, :])
    mem_div = ((1.0 - w) * (ram_com[None, :] + ram_req.float())
               / ram_capf[None, :])
    cpu_load = _fma32(w, ops["cpu_util"][None, :], cpu_div)
    mem_load = _fma32(w, ops["mem_util"][None, :], mem_div)
    load = _fma32(wc, cpu_load, (1.0 - wc) * mem_load)
    nc = float(base.NORMALIZED_COST)
    costs = torch.clamp(
        torch.round(load * nc), 0, 4 * base.NORMALIZED_COST
    ).to(I32)
    costs = torch.where(admissible, costs, INF_COST).to(I32)

    # Slot capacity after earlier bands' placements.
    capacity = torch.clamp(ops["slots_free0"] - delta_slots, min=0).to(I32)

    # Per-column resource-safe capacity (the _solve_banded denominator:
    # the largest admissible request on each column bounds how many units
    # the column takes within each dimension's free budget), int32.
    col_cap = capacity
    for req, cap_arr, committed in (
        (ops["cpu_req"], ops["cpu_cap"], cpu_committed),
        (ops["ram_req"], ops["ram_cap"], ram_committed),
    ):
        denom = torch.where(admissible, req[:, None], 0).amax(dim=0)
        free = torch.clamp(cap_arr - committed, min=0)
        col_cap = torch.where(
            denom > 0,
            torch.minimum(col_cap, free // torch.clamp(denom, min=1)),
            col_cap,
        )
    col_cap = torch.clamp(col_cap, min=0).to(I32)
    return costs, arc_cap, capacity, col_cap


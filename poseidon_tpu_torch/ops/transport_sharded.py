"""The mesh-sharded transportation solve: the machine axis split over a
1-D mesh of devices (B6; the port of
``poseidon_tpu/ops/transport_sharded.py``).

The reference lays the machine (column) axis of the dense ladder's
``[E, M]`` operands over a ``jax.sharding.Mesh`` and jits the one-device
ladder; XLA's SPMD partitioner splits every elementwise op column-wise
and inserts the collectives.  The port runs its one ladder too:
``transport``'s ladder is written over column blocks, one device being
one block, and a 1-D mesh of ``torch.device``s (``SolverMesh``) is k
blocks.  Each shard holds its ``[E_pad, M_pad / k]`` column block of the
costs, arc capacities, flows and admissibility mask and its ``[M_pad /
k]`` slices of the column capacities, sink flows and machine potentials
on its own device, plus its own copy of every row vector (supplies,
fallback costs and flows, EC and sink potentials, EC excesses).
Column-axis work is local; the reductions over the machine axis are the
ladder's collectives (``transport._Collectives``) over per-shard
partials: the EC rows' push allocation is a local cumsum plus the
shards-before's row totals, the sink row's the same over the shards'
sink-arc blocks, the row sums, relabel candidates and Bellman-Ford
minima are sums, maxima, minima and ORs.  No ``[E, M]`` plane crosses
devices or reaches the host inside the ladder; only the final fetch
assembles the flows on the host.

Integer addition modulo 2^32 does not depend on how it is split, so with
contiguous column blocks the sharded ladder is bit-equal to the
one-device ladder on the same padded operands, and with the strided
layout (``POSEIDON_SHARD_STRIDED``, the default) bit-equal to the
reference's strided solve.  The host reads one status per group of
``iter_unroll`` iterations, from shard 0, as on one device.

Kernels: the reference runs no Pallas kernel inside the sharded program
(its lax ladder, split by XLA), so the shards run torch ops, as the
resident-operand ops and the coarse program's glue do.  A mesh may list
one device several times (k logical shards of one card): every shard
keeps its own tensors, joined only through the collectives, which then
run on that device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.ops import transport
from poseidon_tpu_torch.ops.transport import (
    NUM_PHASES,
    TransportSolution,
    _block_solve,
    _checked_instance,
    _Collectives,
    _finish_solve,
    _host_read_blocks,
    _host_validate,
    _pad_instance,
    _pad_start,
    _read_small,
    _stage,
    _Telemetry,
    _upload,
    resolve_device,
)
from poseidon_tpu_torch.utils.hatches import hatch_bool

MACHINE_AXIS = "machines"


class SolverMesh:
    """A 1-D device mesh over the machine axis (the counterpart of the
    reference's ``Mesh(devices, (MACHINE_AXIS,))``).  ``devices`` may
    repeat a device: each entry is one shard."""

    def __init__(self, devices: Sequence) -> None:
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {MACHINE_AXIS: self.size}

    def __repr__(self) -> str:
        return f"SolverMesh({[str(d) for d in self.devices]})"


def visible_devices(device=None) -> List[torch.device]:
    """Every device a mesh may span: on CUDA each card, on the CPU the
    CPU.  No card and no ``device="cpu"`` raises, as ``resolve_device``
    does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_solver_mesh(num_devices: Optional[int] = None,
                     device=None) -> SolverMesh:
    """1-D mesh over the first ``num_devices`` visible devices (all of
    them with ``None``)."""
    return SolverMesh(visible_devices(device)[:num_devices])


def solve_transport_sharded(
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    unsched_cost: np.ndarray,
    init_prices: Optional[np.ndarray] = None,
    *,
    mesh: SolverMesh,
    arc_capacity: Optional[np.ndarray] = None,
    init_flows: Optional[np.ndarray] = None,
    init_unsched: Optional[np.ndarray] = None,
    eps_start: Optional[int] = None,
    max_iter_per_phase: int = 8192,
    max_iter_total: Optional[int] = None,
    scale: Optional[int] = None,
    max_cost_hint: Optional[int] = None,
    global_update_every: int = 4,
    bf_max: int = 64,
    greedy_init: bool = True,
    eps_exact: bool = False,  # accepted for wrapper parity: the sharded
    # path runs no pre-dispatch host certificate, so there is nothing to
    # skip (the fallback forwards it to the one-device solve).
) -> TransportSolution:
    """Drop-in mesh-sharded variant of ``transport.solve_transport``.

    Machines are padded to the one-device padded width rounded up to a
    mesh multiple with zero-capacity, inadmissible columns (semantically
    invisible), and each shard solves its column block on its device.
    An empty instance or a one-device mesh falls back to
    ``solve_transport`` on that device, as the reference does; a mesh of
    k > 1 shards on one device does not.

    Column-to-shard assignment is strided by default
    (``POSEIDON_SHARD_STRIDED``): shard ``d`` holds original columns
    ``d, d + k, d + 2k, ...``, spreading the contended columns (the cost
    model emits machines in rack and capacity order) over the mesh.  The
    permutation is applied on the host after the greedy start and the
    validation and undone on the fetched results, so callers see the
    original column order.  With ``POSEIDON_SHARD_STRIDED=0``
    (contiguous blocks) the solution is bit-identical to the one-device
    ladder's on the same padded operands; the strided layout keeps the
    objective and the certificate but may break cost ties in another
    order.
    """
    costs, supply, capacity, unsched_cost = _checked_instance(
        costs, supply, capacity, unsched_cost, global_update_every,
        site="solve_transport_sharded.supply")
    E, M = costs.shape
    n_dev = int(np.prod(list(mesh.shape.values())))
    if E == 0 or M == 0 or n_dev <= 1:
        return transport.solve_transport(
            costs, supply, capacity, unsched_cost, init_prices,
            arc_capacity=arc_capacity, init_flows=init_flows,
            init_unsched=init_unsched, eps_start=eps_start,
            max_iter_per_phase=max_iter_per_phase,
            max_iter_total=max_iter_total, scale=scale,
            max_cost_hint=max_cost_hint,
            global_update_every=global_update_every, bf_max=bf_max,
            greedy_init=greedy_init, eps_exact=eps_exact,
            device=mesh.devices[0] if mesh.devices else None,
        )
    coll = _Collectives(mesh.devices)

    # Rows pad to a power of two, machines to the quarter-octave bucket
    # rounded up to a mesh multiple (transport.padded_shape): dead rows
    # and columns have zero supply and capacity and no admissible arcs.
    e_pad, m_bucket = transport.padded_shape(E, M)
    m_pad = ((m_bucket + n_dev - 1) // n_dev) * n_dev
    big, supply_p, capacity_p, unsched_p, arc_capacity = _pad_instance(
        costs, supply, capacity, unsched_cost, arc_capacity, e_pad, m_pad)
    # The shared cold-start policy (the mesh-rounded m_pad lands on the
    # one-device bucket for mesh sizes dividing it, so the derived scale
    # and the greedy duals match the one-device solve's).
    with _stage("solve.greedy_start"):
        (init_flows, init_unsched, init_prices,
         eps_start) = transport.maybe_greedy_start(
            greedy_init, init_flows, init_prices, init_unsched, eps_start,
            costs, supply, capacity, arc_capacity, unsched_cost,
            max_cost_hint, e_pad, m_pad, scale=scale,
        )
    fb_p, prices_p, _ = _pad_start(big, E, M, init_flows, init_unsched,
                                   init_prices)
    with _stage("solve.validate"):
        scale, eps_sched, eps0_cold = _host_validate(
            big[0], supply_p, capacity_p, unsched_p, scale, eps_start,
            max_cost_hint,
        )

    # Strided layout: slot d*B + b of the padded machine axis holds
    # original column b*k + d, so shard d's contiguous block holds every
    # column c with c % k == d.  Applied after the greedy start and the
    # validation (both in original column order; the scale, epsilon and
    # warm duals do not depend on the layout) and inverted on every
    # fetched [*, m_pad] result.
    inv_perm = None
    if hatch_bool("POSEIDON_SHARD_STRIDED"):
        perm = np.arange(m_pad).reshape(m_pad // n_dev, n_dev).T.ravel()
        inv_perm = np.argsort(perm)
        big = np.ascontiguousarray(big[:, :, perm])
        capacity_p = capacity_p[perm]
        prices_p[e_pad:e_pad + m_pad] = prices_p[e_pad:e_pad + m_pad][perm]

    if max_iter_total is None:
        max_iter_total = NUM_PHASES * max_iter_per_phase
    _Telemetry.device_calls += 1
    _Telemetry.routes[("sharded", e_pad, m_pad, n_dev)] += 1
    _ledger.note_solve_key(("sharded", e_pad, m_pad, n_dev, int(scale)))
    telem_cap = transport.solve_telemetry_cap()

    # Each shard's blocks on its device: the [3, E, B] planes (costs, arc
    # capacities, flows), its capacities and its prices (the rows', its
    # columns', the sink's), and the row vectors (supply, unscheduled
    # cost, fallback flows).
    rows = np.stack([supply_p, unsched_p, fb_p])
    with _stage("solve.upload", coll.lead):
        big_d, cap_d, prices_d, rows_d = zip(*[(
            _upload(b, d), _upload(c, d),
            _upload(np.concatenate([prices_p[:e_pad], p, prices_p[-1:]]), d),
            _upload(rows, d),
        ) for d, b, c, p in zip(coll.devices, np.split(big, n_dev, axis=2),
                                np.split(capacity_p, n_dev),
                                np.split(prices_p[e_pad:-1], n_dev))])
    costs_d, arc_d, flows_d = map(list, zip(*big_d))
    supply_d, unsched_d, fb_d = map(list, zip(*rows_d))

    with _stage("solve.device"), _stage("solve.device.sharded", coll.lead):
        F, Ffb, prices, stats = _block_solve(
            costs_d, supply_d, list(cap_d), unsched_d, arc_d, list(prices_d),
            flows_d, fb_d, [int(e) for e in eps_sched],
            int(max_iter_total), int(global_update_every), int(bf_max),
            transport.adaptive_bf_flag(coll.lead),
            max_iter=max_iter_per_phase,
            scale=int(scale), total=int(supply_p.astype(np.int64).sum()),
            coll=coll, stage="solve.device.sharded", telem_cap=telem_cap,
        )
        small = _read_small(F, flows_d, Ffb, prices, stats, coll)

    def fetch_flows():
        with _stage("solve.fetch_flows"):
            return _host_read_blocks(F, axis=1)

    # The ring carries one more row per shard: its machine columns'
    # active excess (decode_telemetry's shard_excess).
    return _finish_solve(
        small, big[2], fetch_flows, costs=costs, supply=supply,
        capacity=capacity, unsched_cost=unsched_cost,
        arc_capacity=arc_capacity, scale=scale, e_pad=e_pad, m_pad=m_pad,
        impl="sharded", telem_cap=telem_cap, eps0_cold=eps0_cold,
        eps0=int(eps_sched[0]), inv_perm=inv_perm,
    )

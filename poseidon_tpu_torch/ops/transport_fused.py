"""The fused ladder route (B1): the whole epsilon ladder of one solve in
one kernel launch (``csrc/fused_ladder.cu``).

Replaces the JAX package's Pallas kernel
``poseidon_tpu/ops/transport_fused.py::_phase_ladder_kernel``.  The
wrapper ``solve_device_fused`` has the operand contract of the plain
ladder (``transport._solve_device``) and returns bit-identical results:
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
ladder, and it never does the one in place of the other.

The route's gate ``fits_vmem`` is the reference's VMEM budget, inherited
unchanged so the port sends the same padded shapes to this kernel as the
reference's accelerator policy does; it is not yet derived for the H100.
Within it, the shape alone picks among B1's three paths, which give the
same bits: ``ladder_ctas`` a thread-block cluster whose CTAs hold the
planes' rows in their shared memory (``csrc/fused_ladder.cu``); where it
declines, ``ladder_slab_ctas`` a cluster whose CTAs hold the planes'
columns (``csrc/fused_ladder_columns.cu``), for skinny planes from
``SLAB_MIN_COLS`` columns; else one block on one SM with its planes in L2.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops.transport import (
    I32,
    NUM_PHASES,
    TELEM_ROWS,
    _prepare_operands,
    _solve_device,
)

# The reference's working-set gate: aligned [E, M] elements.
VMEM_ELEM_BUDGET = 160 * 1024
# The fewest EC rows B1 runs as a row cluster.  At 8 rows (one a CTA) the
# row cluster was no faster than the one-SM kernel on wide planes
# ([8, 1024] 1.360 against 1.365 ms, [8, 2048] 10.610 against 10.843);
# from 16 rows it was 1.2x to 8.9x faster at every shape timed (NVIDIA
# H100 80GB HBM3, 700 W; csrc/fused_ladder.cu's note).  Fewer rows go to
# the column cluster where ``ladder_slab_ctas`` takes them.
CLUSTER_MIN_ROWS = 16

# B1's dynamic shared memory, as ``csrc/fused_ladder.cu`` sizes it at
# launch (``ladder_smem_bytes``, exported as
# ``pt_fused_ladder_smem_bytes``): a 1 KB slot for the block's scalars and
# reduction scratch, the row and column stages' int32 partials [4][1024
# threads], and pe with the two Bellman-Ford distance buffers, [E] int32
# each.  A block may use at most 227 KB on the H100.
SMEM_SCALAR_BYTES = 1024
SMEM_PART_INTS = 4 * 1024


def _kernel_shape(e_pad: int, m_pad: int):
    """The reference kernel's aligned operand shape (rows to 8, lanes to
    128), which its gate budgets."""
    return -(-e_pad // 8) * 8, -(-m_pad // 128) * 128


def fits_vmem(e_pad: int, m_pad: int) -> bool:
    ek, mk = _kernel_shape(e_pad, m_pad)
    return ek * mk <= VMEM_ELEM_BUDGET


def ladder_smem_bytes(e_pad: int) -> int:
    """B1's dynamic shared memory in bytes for ``e_pad`` EC rows."""
    return SMEM_SCALAR_BYTES + 4 * (SMEM_PART_INTS + 3 * e_pad)


# The cluster path's dynamic shared memory a CTA, as ``csrc/fused_ladder.cu``
# lays it out (``cluster_layout``, exported as
# ``pt_fused_ladder_cluster_smem_bytes``): a slot for the CTA's scalars and
# reductions, then int32 arrays: five [S, M] planes of the CTA's S = ceil(E
# / k) rows (C, Uem, F, the pushes P shared with the forward lengths, the
# reverse lengths), eleven [S] row vectors, eight [M] column vectors (a
# global update's four over four of the push sweep's), the [M + 1],
# [M] and [M] buffers the other CTAs combine into, and the row- and
# column-segment partials.
CLUSTER_SCALAR_BYTES = 1152
CLUSTER_THREADS = 512
CLUSTER_WARPS = CLUSTER_THREADS // 32
# Cluster sizes the route takes, in order of preference: 8 is the portable
# size; 16 needs the card's non-portable cluster size.
CLUSTER_CTAS = (8, 16)
# Shared memory one block may use on the H100.
SMEM_LIMIT = 227 * 1024
# The cluster path's cluster barriers (csrc/fused_ladder.cu's note): per
# push/relabel iteration, per Bellman-Ford sweep, per global update (its
# convergence check) and per epsilon phase (the excesses and the entering
# state).
CLUSTER_BARRIERS = {"iteration": 3, "sweep": 1, "update": 1, "phase": 2}


def cluster_smem_bytes(e_pad: int, m_pad: int, ctas: int) -> int:
    """The cluster path's dynamic shared memory a CTA, in bytes, for an
    ``[e_pad, m_pad]`` plane over ``ctas`` CTAs (each array starts on 16
    bytes)."""
    s = -(-e_pad // ctas)

    def r4(n):
        return -(-n // 4) * 4

    ints = (5 * r4(s * m_pad) + 11 * r4(s) + 8 * r4(m_pad) + r4(m_pad + 1)
            + 2 * r4(m_pad) + r4(4 * CLUSTER_WARPS) + r4(4 * CLUSTER_THREADS))
    return CLUSTER_SCALAR_BYTES + 4 * ints


def ladder_ctas(e_pad: int, m_pad: int) -> int:
    """B1's CTAs at ``[e_pad, m_pad]``: from ``CLUSTER_MIN_ROWS`` rows and
    for a multiple of 4 columns (the cluster path loads a plane four
    columns at a time; every padded width is one), the first of
    ``CLUSTER_CTAS`` whose shares of the planes fit a CTA's shared
    memory; else 1, the one-SM kernel.  A property of the shape alone:
    both paths give the same bits."""
    if e_pad < CLUSTER_MIN_ROWS or m_pad % 4:
        return 1
    for k in CLUSTER_CTAS:
        if cluster_smem_bytes(e_pad, m_pad, k) <= SMEM_LIMIT:
            return k
    return 1


# The column cluster's dynamic shared memory a CTA, as
# ``csrc/fused_ladder_columns.cu`` lays it out (``slab_layout``, exported
# as ``pt_fused_ladder_columns_smem_bytes``): a slot for the CTA's
# scalars, then int32 arrays: five [E, W] planes of the CTA's W columns
# (C, Uem, F, the pushes P shared with the forward lengths, the reverse
# lengths), ten [E] row vectors, seven [W] column vectors, the row units'
# and the warps' partials, and two buffers of k slots of the widest
# exchange's 4 E + 6 ints.
SLAB_SCALAR_BYTES = 128
# The column cluster's cluster barriers (csrc/fused_ladder_columns.cu's
# note), as CLUSTER_BARRIERS counts the row cluster's.
SLAB_BARRIERS = {"iteration": 2, "sweep": 1, "update": 1, "phase": 1}
# The narrowest plane the column cluster takes (padded columns): at 8 rows
# it was 1.23x to 7.4x faster than the one-SM kernel from 128 columns to
# 10240 (csrc/fused_ladder_columns.cu's note).  At 64 it was 1.04x to
# 1.06x, a few percent for eight SMs in place of one, each holding eight
# columns, so narrower planes keep the one-SM kernel.
SLAB_MIN_COLS = 128


def slab_width(m_pad: int, ctas: int) -> int:
    """Columns a CTA of the column cluster holds: its share of
    ``m_pad`` rounded up to a multiple of 4."""
    return -(-m_pad // (4 * ctas)) * 4


def slab_smem_bytes(e_pad: int, m_pad: int, ctas: int) -> int:
    """The column cluster's dynamic shared memory a CTA, in bytes, for an
    ``[e_pad, m_pad]`` plane over ``ctas`` CTAs (each array starts on 16
    bytes)."""
    w, nx = slab_width(m_pad, ctas), 4 * e_pad + 6

    def r4(n):
        return -(-n // 4) * 4

    ints = (5 * r4(e_pad * w) + 10 * r4(e_pad) + 7 * r4(w)
            + r4(5 * max(e_pad, CLUSTER_WARPS)) + r4(8 * CLUSTER_WARPS)
            + r4(2 * ctas * nx))
    return SLAB_SCALAR_BYTES + 4 * ints


def ladder_slab_ctas(e_pad: int, m_pad: int) -> int:
    """B1's column-cluster CTAs at ``[e_pad, m_pad]``, a shape that
    ``ladder_ctas`` keeps on one SM: from ``SLAB_MIN_COLS`` columns and
    for a multiple of 4 of them, the first of ``CLUSTER_CTAS`` whose
    column slabs fit a CTA's shared memory; else 1, the one-SM kernel.  A
    property of the shape alone: every path gives the same bits."""
    if m_pad < SLAB_MIN_COLS or m_pad % 4:
        return 1
    for k in CLUSTER_CTAS:
        if slab_smem_bytes(e_pad, m_pad, k) <= SMEM_LIMIT:
            return k
    return 1


def fused_ladder(ops: dict, state: tuple, knobs: torch.Tensor, ring=None):
    """Launch B1 on prepared operands; updates the flow/price state in
    place and returns the int32 stats ``[iters, bf, clean,
    phase_iters...]``.  With ``ring``, a zeroed int32 [TELEM_ROWS, cap]
    tensor of its own (never the workspace), the kernel writes each
    active iteration's telemetry sample into it."""
    F, Ffb, Fmt, pe, pm, pt = state
    E, M = F.shape
    dev = F.device
    ctas = ladder_ctas(E, M)
    slab = ladder_slab_ctas(E, M) if ctas == 1 else 1
    so = _kernels.lib()
    ck = _kernels.check
    stats = torch.empty(3 + NUM_PHASES, dtype=I32, device=dev)
    # The one-SM kernel's workspace; the clusters hold their state in
    # shared memory.
    ws = (torch.empty(3 * E * M + 5 * E + 6 * M, dtype=I32, device=dev)
          if ctas == 1 and slab == 1 else None)
    args = [
        ck(ops["C"], "C", (E, M), dev), ck(ops["U"], "U", (E,), dev),
        ck(ops["supply"], "supply", (E,), dev),
        ck(ops["cap"], "cap", (M,), dev), ck(ops["Uem"], "Uem", (E, M), dev),
        ck(F, "F", (E, M), dev), ck(Ffb, "Ffb", (E,), dev),
        ck(Fmt, "Fmt", (M,), dev), ck(pe, "pe", (E,), dev),
        ck(pm, "pm", (M,), dev), ck(pt, "pt", (1,), dev),
        ck(knobs, "knobs", (10,), dev), stats.data_ptr(),
    ]
    cap = 0 if ring is None else ring.shape[1]
    ring_ptr = (None if ring is None
                else ck(ring, "ring", (TELEM_ROWS, cap), dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    _kernels.LAUNCHES["fused_ladder"] += 1
    if slab > 1:
        _kernels.LAUNCHES["fused_ladder_columns"] += 1
        rc = so.pt_fused_ladder_columns(*args, ring_ptr, E, M, cap, slab,
                                        stream)
    else:
        if ctas > 1:
            _kernels.LAUNCHES["fused_ladder_cluster"] += 1
        rc = so.pt_fused_ladder(*args, None if ws is None else ws.data_ptr(),
                                ring_ptr, E, M, cap, ctas, stream)
    _kernels.launch_check(rc, "fused_ladder")
    return stats


def solve_device_fused(costs, supply, capacity, unsched_cost, arc_cap,
                       init_prices, init_flows, init_fb, eps_sched,
                       max_iter_total, global_every, bf_max, adaptive_bf=0,
                       *, max_iter, scale, total, telem_cap=0):
    """``transport._solve_device`` as one B1 launch (CUDA tensors) or as
    the plain ladder (CPU tensors).  Returns ``(F, Ffb, prices, stats)``,
    ``stats`` with the telemetry ring appended when ``telem_cap`` > 0."""
    if costs.device.type == "cpu":
        return _solve_device(
            costs, supply, capacity, unsched_cost, arc_cap, init_prices,
            init_flows, init_fb, eps_sched, max_iter_total, global_every,
            bf_max, adaptive_bf, max_iter=max_iter, scale=scale, total=total,
            stage="solve.device.fused", telem_cap=telem_cap,
        )
    ops, state = _prepare_operands(
        costs, supply, capacity, unsched_cost, arc_cap, init_prices,
        init_flows, init_fb, scale=scale,
    )
    knobs = torch.tensor(
        [int(e) for e in eps_sched] + [max_iter, max_iter_total,
                                       global_every, bf_max, total,
                                       adaptive_bf],
        dtype=I32,
    ).to(costs.device)
    ring = (torch.zeros((TELEM_ROWS, telem_cap), dtype=I32,
                        device=costs.device) if telem_cap else None)
    stats = fused_ladder(ops, state, knobs, ring)
    if ring is not None:
        stats = torch.cat([stats, ring.reshape(-1)])
    F, Ffb, _Fmt, pe, pm, pt = state
    return F, Ffb, torch.cat([pe, pm, pt]), stats

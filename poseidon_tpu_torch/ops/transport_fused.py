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


def fused_ladder(ops: dict, state: tuple, knobs: torch.Tensor, ring=None):
    """Launch B1 on prepared operands; updates the flow/price state in
    place and returns the int32 stats ``[iters, bf, clean,
    phase_iters...]``.  With ``ring``, a zeroed int32 [TELEM_ROWS, cap]
    tensor of its own (never the workspace), the kernel writes each
    active iteration's telemetry sample into it."""
    F, Ffb, Fmt, pe, pm, pt = state
    E, M = F.shape
    dev = F.device
    so = _kernels.lib()
    ck = _kernels.check
    stats = torch.empty(3 + NUM_PHASES, dtype=I32, device=dev)
    ws = torch.empty(3 * E * M + 5 * E + 6 * M, dtype=I32, device=dev)
    args = [
        ck(ops["C"], "C", (E, M), dev), ck(ops["U"], "U", (E,), dev),
        ck(ops["supply"], "supply", (E,), dev),
        ck(ops["cap"], "cap", (M,), dev), ck(ops["Uem"], "Uem", (E, M), dev),
        ck(F, "F", (E, M), dev), ck(Ffb, "Ffb", (E,), dev),
        ck(Fmt, "Fmt", (M,), dev), ck(pe, "pe", (E,), dev),
        ck(pm, "pm", (M,), dev), ck(pt, "pt", (1,), dev),
        ck(knobs, "knobs", (10,), dev), stats.data_ptr(), ws.data_ptr(),
    ]
    cap = 0 if ring is None else ring.shape[1]
    ring_ptr = (None if ring is None
                else ck(ring, "ring", (TELEM_ROWS, cap), dev))
    _kernels.LAUNCHES["fused_ladder"] += 1
    rc = so.pt_fused_ladder(*args, ring_ptr, E, M, cap,
                            torch.cuda.current_stream(dev).cuda_stream)
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

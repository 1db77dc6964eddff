"""The per-iteration route (B2): one push/excess/relabel iteration per
launch sequence (``csrc/tiled_iteration.cu``), for padded shapes past the
fused gate with few enough EC rows — the 10k-machine wave band.

Replaces the JAX package's Pallas kernel
``poseidon_tpu/ops/transport_tiled.py::_iteration_kernel`` (launched by
``_tiled_iteration`` from ``_pr_phase_tiled``).  The refine step and the
Bellman-Ford global update stay torch ops here, as they stay XLA in the
reference.  ``tiled_iteration`` has the contract of the plain iteration
(``transport._pr_iteration``): on CUDA tensors it launches the kernels, on
CPU tensors it runs the plain iteration.

The gate ``fits_tile`` is the reference's VMEM tile budget, inherited
unchanged (same padded shapes as the reference's accelerator policy); it
is not yet derived for the H100.
"""

from __future__ import annotations

import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops.transport import I32, _pr_iteration, _solve_device

# The reference's tile working-set gate: E * TILE_W <= 2^17.
TILE_W = 512
TILE_ELEM_BUDGET = 1 << 17


def fits_tile(e_pad: int) -> bool:
    return e_pad * TILE_W <= TILE_ELEM_BUDGET


def tiled_iteration(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, *,
                    eps, do_relabel, C, U, Uem, supply, cap, adm, total):
    """One iteration: B2 on CUDA tensors, ``_pr_iteration`` on CPU."""
    if F.device.type == "cpu":
        return _pr_iteration(
            F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, eps=eps,
            do_relabel=do_relabel, C=C, U=U, Uem=Uem, supply=supply,
            cap=cap, adm=adm, total=total,
        )
    E, M = F.shape
    dev = F.device
    ck = _kernels.check
    outs = [torch.empty_like(t) for t in
            (F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st)]
    tpm = torch.empty(M, dtype=I32, device=dev)
    tpe = torch.empty(E, dtype=I32, device=dev)
    ins = [
        ck(C, "C", (E, M), dev), ck(Uem, "Uem", (E, M), dev),
        ck(U, "U", (E,), dev), ck(supply, "supply", (E,), dev),
        ck(cap, "cap", (M,), dev), ck(F, "F", (E, M), dev),
        ck(Ffb, "Ffb", (E,), dev), ck(Fmt, "Fmt", (M,), dev),
        ck(pe, "pe", (E,), dev), ck(pm, "pm", (M,), dev),
        ck(pt, "pt", (1,), dev), ck(exc_e, "exc_e", (E,), dev),
        ck(exc_m, "exc_m", (M,), dev), ck(exc_t, "exc_t", (1,), dev),
        ck(st, "st", (3,), dev),
    ]
    so = _kernels.lib()
    _kernels.LAUNCHES["tiled_iteration"] += 1
    rc = so.pt_tiled_iteration(
        *ins, *[o.data_ptr() for o in outs], tpm.data_ptr(), tpe.data_ptr(),
        E, M, int(eps), 1 if do_relabel else 0, int(total),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.launch_check(rc, "tiled_iteration")
    return tuple(outs)


def solve_device_tiled(costs, supply, capacity, unsched_cost, arc_cap,
                       init_prices, init_flows, init_fb, eps_sched,
                       max_iter_total, global_every, bf_max, adaptive_bf=0,
                       *, max_iter, scale, total):
    """``transport._solve_device`` with ``tiled_iteration`` as the
    iteration body.  Returns ``(F, Ffb, prices, stats)``."""
    return _solve_device(
        costs, supply, capacity, unsched_cost, arc_cap, init_prices,
        init_flows, init_fb, eps_sched, max_iter_total, global_every,
        bf_max, adaptive_bf, max_iter=max_iter, scale=scale, total=total,
        iterate=tiled_iteration,
    )

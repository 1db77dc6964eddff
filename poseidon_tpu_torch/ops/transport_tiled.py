"""The per-iteration route (B2): one push/excess/relabel iteration per
launch sequence (``csrc/tiled_iteration.cu``), and the route's global
price update as one cooperative launch (``csrc/global_update.cu``), for
padded shapes past the fused gate with few enough EC rows — the
10k-machine wave band.

Replaces the JAX package's Pallas kernel
``poseidon_tpu/ops/transport_tiled.py::_iteration_kernel`` (launched by
``_tiled_iteration`` from ``_pr_phase_tiled``).  The reference leaves the
global update to XLA inside its ``lax.while_loop``; here it is a kernel
too, so the update makes no host read, as on the reference's device.  The
refine step stays torch ops.  ``TiledIteration`` and ``GlobalUpdate`` have
the contracts of the plain ``transport._pr_iteration`` and
``transport._global_update``: on CUDA tensors they launch the kernels, on
CPU tensors they run the plain versions.

The gate ``fits_tile`` is the reference's VMEM tile budget, inherited
unchanged (same padded shapes as the reference's accelerator policy); it
is not yet derived for the H100.
"""

from __future__ import annotations

import ctypes

import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops.transport import (
    I32,
    STATUS_INTS,
    TELEM_ROWS,
    _global_update,
    _pr_iteration,
    _solve_device,
)

# The reference's tile working-set gate: E * TILE_W <= 2^17.
TILE_W = 512
TILE_ELEM_BUDGET = 1 << 17

# The global update keeps its row vectors (d_e for two sweeps, the
# fallback arcs' lengths) in each block's shared memory: 128 KB at this
# many rows, beside which its length planes go to the workspace.
GU_MAX_ROWS = 8192


def fits_tile(e_pad: int) -> bool:
    return e_pad * TILE_W <= TILE_ELEM_BUDGET


class _Operands:
    """The solve's fixed operands (C, Uem, U, supply, cap), checked once
    and held by identity: a call with other tensors checks them again."""

    def __init__(self):
        self.key = None

    def bind(self, C, Uem, U, supply, cap) -> bool:
        """Check the operands unless they are the ones last checked;
        returns whether they changed."""
        key = (C, Uem, U, supply, cap)
        if self.key is not None and all(
                a is b for a, b in zip(key, self.key)):
            return False
        E, M = C.shape
        dev = C.device
        ck = _kernels.check
        self.ptrs = [
            ck(C, "C", (E, M), dev), ck(Uem, "Uem", (E, M), dev),
            ck(U, "U", (E,), dev), ck(supply, "supply", (E,), dev),
            ck(cap, "cap", (M,), dev),
        ]
        self.key, self.E, self.M, self.dev = key, E, M, dev
        self.ring = self.ring_ptr = None
        return True

    def ring_args(self, ring):
        """The kernel's ring pointer and capacity (null and 0 without a
        ring); the solve's one ring is checked once."""
        if ring is None:
            return None, 0
        if ring is not self.ring:
            self.ring_ptr = _kernels.check(
                ring, "ring", (TELEM_ROWS, ring.shape[1]), self.dev)
            self.ring = ring
        return self.ring_ptr, ring.shape[1]


class TiledIteration:
    """B2 for one solve.  The fixed operands are checked and the
    workspace and two output sets are allocated at the first call (again
    only if the operands change); each call writes the set that holds none
    of its inputs, and checks only the inputs it did not produce itself."""

    _STATE = ("F", "Ffb", "Fmt", "pe", "pm", "pt", "exc_e", "exc_m",
              "exc_t", "st")

    def __init__(self):
        self._ops = _Operands()
        self._sets = None

    def _alloc(self):
        E, M, dev = self._ops.E, self._ops.M, self._ops.dev
        return [torch.empty(s, dtype=I32, device=dev) for s in
                ((E, M), E, M, E, M, 1, E, M, 1, STATUS_INTS)]

    def __call__(self, F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, *,
                 eps, do_relabel, C, U, Uem, supply, cap, adm, total,
                 ring=None, ring_base=0):
        if F.device.type == "cpu":
            return _pr_iteration(
                F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, eps=eps,
                do_relabel=do_relabel, C=C, U=U, Uem=Uem, supply=supply,
                cap=cap, adm=adm, total=total, ring=ring, ring_base=ring_base,
            )
        ops = self._ops
        if ops.bind(C, Uem, U, supply, cap):
            self._sets = None
        E, M, dev = ops.E, ops.M, ops.dev
        ins = (F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st)
        in_ids = {id(t) for t in ins}
        owned = set() if self._sets is None else self._ids[0] | self._ids[1]
        shapes = ((E, M), (E,), (M,), (E,), (M,), (1,), (E,), (M,), (1,),
                  (STATUS_INTS,))
        ptrs = [t.data_ptr() if id(t) in owned
                else _kernels.check(t, name, shape, dev)
                for t, name, shape in zip(ins, self._STATE, shapes)]
        so = _kernels.lib()
        if self._sets is None:
            # Zeroed: the last int is the final pass's ticket.
            self._ws = torch.zeros(so.pt_tiled_iteration_ws_ints(E, M),
                                   dtype=I32, device=dev)
            self._sets = [self._alloc(), self._alloc()]
            self._ids = [{id(t) for t in s} for s in self._sets]
            self._next = 0
        for k in (self._next, 1 - self._next):
            if not in_ids & self._ids[k]:
                break
        else:  # both sets hold inputs: write a fresh one
            k = self._next
            self._sets[k] = self._alloc()
            self._ids[k] = {id(t) for t in self._sets[k]}
        self._next = 1 - k
        outs = self._sets[k]
        ring_ptr, ring_cap = ops.ring_args(ring)
        _kernels.LAUNCHES["tiled_iteration"] += 1
        rc = so.pt_tiled_iteration(
            *ops.ptrs, *ptrs, *[o.data_ptr() for o in outs],
            self._ws.data_ptr(), ring_ptr, E, M, int(eps),
            1 if do_relabel else 0, int(total), int(ring_base), ring_cap,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _kernels.launch_check(rc, "tiled_iteration")
        return tuple(outs)


def global_update_plan(E: int, M: int) -> tuple[int, int, int]:
    """The global update's launch plan at [E, M] on the current card:
    (blocks of the cooperative grid, at most one per SM; where each
    block keeps the length planes of its columns: 2 both in shared
    memory, 1 the forward plane there and the reverse one in the
    workspace, 0 both in the workspace; the machine columns each block
    owns, whole tiles of 32).  Raises where no co-resident grid can hold
    the rows."""
    plan = (ctypes.c_int * 3)()
    _kernels.launch_check(
        _kernels.lib().pt_global_update_plan(E, M, plan), "global_update plan")
    return plan[0], plan[1], plan[2]


class GlobalUpdate:
    """The route's global update for one solve: the fixed operands are
    checked and the workspace (the exchange slots, the grid barrier and,
    in the workspace plan, the length planes) is allocated at the first
    call.  Each call is one cooperative launch that runs the whole
    Bellman-Ford loop, two sweeps per grid barrier, and adds its sweeps to
    ``sweeps_acc`` on the device; it writes fresh (pe, pm, pt), and with a
    telemetry ``ring`` marks column ``ring_slot`` as fired, with its
    sweeps."""

    def __init__(self):
        self._ops = _Operands()
        self._ws = None

    def barriers(self) -> int:
        """Grid barriers run by this object's launches so far: the
        workspace's exchange count (a host read; for diagnostics)."""
        return 0 if self._ws is None else int(self._ws[0].item())

    def __call__(self, F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t,
                 sweeps_acc, *, C, U, Uem, supply, cap, adm, eps, bf_max,
                 ring=None, ring_slot=0):
        if F.device.type == "cpu":
            return _global_update(
                F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, sweeps_acc,
                C=C, U=U, Uem=Uem, supply=supply, cap=cap, adm=adm, eps=eps,
                bf_max=bf_max, ring=ring, ring_slot=ring_slot,
            )
        ops = self._ops
        if ops.bind(C, Uem, U, supply, cap):
            self._ws = None
        E, M, dev = ops.E, ops.M, ops.dev
        if E > GU_MAX_ROWS:
            raise ValueError(f"global_update: {E} rows, at most "
                             f"{GU_MAX_ROWS}")
        ck = _kernels.check
        ptrs = [
            ck(F, "F", (E, M), dev), ck(Ffb, "Ffb", (E,), dev),
            ck(Fmt, "Fmt", (M,), dev), ck(pe, "pe", (E,), dev),
            ck(pm, "pm", (M,), dev), ck(pt, "pt", (1,), dev),
            ck(exc_e, "exc_e", (E,), dev), ck(exc_m, "exc_m", (M,), dev),
            ck(exc_t, "exc_t", (1,), dev),
        ]
        acc = ck(sweeps_acc, "sweeps_acc", (1,), dev)
        so = _kernels.lib()
        if self._ws is None:
            self._plan = (ctypes.c_int * 3)(*global_update_plan(E, M))
            # Zeroed: the exchange tags and the grid barrier start at 0.
            self._ws = torch.zeros(
                so.pt_global_update_ws_ints(E, self._plan),
                dtype=I32, device=dev)
        outs = [torch.empty(n, dtype=I32, device=dev) for n in (E, M, 1)]
        ring_ptr, ring_cap = ops.ring_args(ring)
        if ring is not None and not 0 <= ring_slot < ring_cap:
            raise ValueError(f"global_update: ring slot {ring_slot} outside "
                             f"[0, {ring_cap})")
        _kernels.LAUNCHES["global_update"] += 1
        rc = so.pt_global_update_launch(
            *ops.ptrs, *ptrs, *[o.data_ptr() for o in outs], acc,
            self._ws.data_ptr(), ring_ptr, E, M, int(eps), int(bf_max),
            self._plan, int(ring_slot), ring_cap,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _kernels.launch_check(rc, "global_update")
        return tuple(outs)


def solve_device_tiled(costs, supply, capacity, unsched_cost, arc_cap,
                       init_prices, init_flows, init_fb, eps_sched,
                       max_iter_total, global_every, bf_max, adaptive_bf=0,
                       *, max_iter, scale, total, telem_cap=0):
    """``transport._solve_device`` with this route's iteration and global
    update, each created once for the solve; the telemetry ring (when
    ``telem_cap`` > 0) is written by their kernels inside launches the
    route makes anyway.  Returns ``(F, Ffb, prices, stats)``."""
    return _solve_device(
        costs, supply, capacity, unsched_cost, arc_cap, init_prices,
        init_flows, init_fb, eps_sched, max_iter_total, global_every,
        bf_max, adaptive_bf, max_iter=max_iter, scale=scale, total=total,
        iterate=TiledIteration(), global_update=GlobalUpdate(),
        stage="solve.device.tiled", telem_cap=telem_cap,
    )

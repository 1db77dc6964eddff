"""The mesh-sharded transportation solve: the machine axis split over a
1-D mesh of devices (B6; the port of
``poseidon_tpu/ops/transport_sharded.py``).

The reference lays the machine (column) axis of the dense ladder's
``[E, M]`` operands over a ``jax.sharding.Mesh`` and jits the one-device
ladder; XLA's SPMD partitioner splits every elementwise op column-wise
and inserts the collectives.  The port is the same program written out:
one process, a 1-D mesh of ``torch.device``s (``SolverMesh``), each shard
holding its ``[E_pad, M_pad / k]`` column block of the costs, arc
capacities, flows and admissibility mask and its ``[M_pad / k]`` slices
of the column capacities, sink flows and machine potentials on its own
device, plus its own copy of every row vector (supplies, fallback costs
and flows, EC and sink potentials, EC excesses).  Column-axis work is
local; the reductions over the machine axis are explicit collectives
over per-shard partials (``_Collectives``): the EC rows' push
allocation is a local cumsum plus each shard's exclusive offset, the
sink row's the same over the shards' sink-arc blocks, the row sums,
relabel candidates and Bellman-Ford minima are sums, maxima, minima and
ORs.  No ``[E, M]`` plane crosses devices or reaches the host inside
the ladder; only the final fetch assembles the flows on the host.

Integer addition modulo 2^32 does not depend on how it is split, so with
contiguous column blocks the sharded ladder is bit-equal to the
one-device ladder on the same padded operands, and with the strided
layout (``POSEIDON_SHARD_STRIDED``, the default) bit-equal to the
reference's strided solve.  The phase loop is the one-device ladder's
(``transport._pr_phase``), so the host reads one status per group of
``iter_unroll`` iterations, from shard 0, as the plain ladder does.

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
    _DINF,
    _EXCESS_SAT,
    _EXCESS_SAT_THRESH,
    _NEG,
    _POS,
    _ST_ACTIVE,
    _ST_ITERS,
    _TR_BF,
    _TR_GU,
    I32,
    INF_COST,
    NUM_PHASES,
    TELEM_ROWS,
    TransportSolution,
    _host_finalize,
    _host_read,
    _host_read_blocks,
    _host_validate,
    _relabel_to,
    _stage,
    _Telemetry,
    _upload,
    resolve_device,
)
from poseidon_tpu_torch.utils.hatches import hatch_bool
from poseidon_tpu_torch.utils.numerics import certify_i32_total

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
    devices = visible_devices(device)
    if num_devices is not None:
        devices = devices[:num_devices]
    return SolverMesh(devices)


def _pad_columns(arr: np.ndarray, m_pad: int, fill) -> np.ndarray:
    if arr.ndim == 1:
        out = np.full(m_pad, fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
    else:
        out = np.full((arr.shape[0], m_pad), fill, dtype=arr.dtype)
        out[:, : arr.shape[1]] = arr
    return out


# ---------------------------------------------------------- collectives

class _Collectives:
    """The sharded ladder's cross-shard steps, over per-shard partials
    (one tensor per shard, each on its shard's device, all one shape).
    The partials are stacked on shard 0 and reduced there; a replicated
    result goes back to every shard.  When every shard is on one device
    the stack is the whole collective and the result is shared.  Integer
    sums and scans are int32 (wrapping as the one-device ladder's do)
    unless the partials are int64."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        self.devices = tuple(devices)
        self.lead = self.devices[0]
        self.one_device = all(d == self.lead for d in self.devices)

    def _stack(self, parts):
        return torch.stack([p.to(self.lead) for p in parts])

    def _out(self, t):
        if self.one_device:
            return [t] * len(self.devices)
        return [t.to(d) for d in self.devices]

    def reduce(self, op: str, parts, lead_only: bool = False):
        """``op`` ("sum", "amax", "amin" or "any") over the shards'
        partials: the result on every shard, or on shard 0 alone."""
        s = self._stack(parts)
        r = s.sum(0, dtype=s.dtype) if op == "sum" else getattr(s, op)(0)
        return r if lead_only else self._out(r)

    def exscan(self, parts):
        """Per shard, the sum of the partials of the shards before it
        (in shard order), and everyone's total: ``(offsets, totals)``."""
        s = self._stack(parts)
        inc = torch.cumsum(s, 0, dtype=s.dtype)
        if self.one_device:
            offs = list(inc - s)
        else:
            offs = [(inc[j] - s[j]).to(d) for j, d in enumerate(self.devices)]
        return offs, self._out(inc[-1])

    def gather(self, parts):
        """The shards' blocks of a ``[M]`` vector, joined on shard 0."""
        return torch.cat([p.to(self.lead) for p in parts])


# ------------------------------------------------------- sharded ladder
# Each of these is the plain ladder's function of the same name
# (``transport._excesses``, ``_phase_status``, ``_phase_enter``,
# ``_pr_iteration``, ``_global_update``) over lists with one entry per
# shard: ``[E, Mb]`` blocks and ``[Mb]`` slices local, ``[E]`` and
# ``[1]`` row and sink vectors replicated.  Each shard's arithmetic is
# the plain function's, in its order; the comments mark the steps that
# reduce over the machine axis.

def _sh_excesses(F, Ffb, Fmt, *, supply, total: int, coll):
    rows = coll.reduce("sum", [f.sum(1, dtype=I32) for f in F])
    fmt = coll.reduce("sum", [m.sum(dtype=I32).reshape(1) for m in Fmt])
    k = len(F)
    exc_e = [supply[j] - rows[j] - Ffb[j] for j in range(k)]
    exc_m = [F[j].sum(0, dtype=I32) - Fmt[j] for j in range(k)]
    exc_t = [(fmt[j] + Ffb[j].sum(dtype=I32) - total).reshape(1)
             for j in range(k)]
    return exc_e, exc_m, exc_t


def _sh_status(exc_e, exc_m, exc_t, iters, *, coll):
    """``_phase_status`` on shard 0, with one more entry per shard after
    the shared ones: the shard's machine-side active excess (its
    telemetry lane), an exact int64 sum clamped to INT32_MAX from 2^30 up
    (the reference decides that clamp with a float32 shadow sum, so the
    two agree below 2^30), as the total is."""
    e0, t0 = exc_e[0], exc_t[0]
    rows = (e0 > 0).sum(dtype=I32).reshape(1)
    cols = coll.reduce("sum", [(m > 0).sum(dtype=I32).reshape(1)
                               for m in exc_m], lead_only=True)
    act = (rows > 0) | (cols > 0) | (t0 > 0)
    lanes = coll._stack(
        [m.clamp(min=0).sum(dtype=torch.int64) for m in exc_m])
    s = (e0.clamp(min=0).sum(dtype=torch.int64) + lanes.sum()
         + t0.clamp(min=0).sum(dtype=torch.int64)).reshape(1)
    sat = s >= _EXCESS_SAT_THRESH
    tot = torch.where(sat, _EXCESS_SAT, s).to(I32)
    lanes = torch.where(lanes >= _EXCESS_SAT_THRESH, _EXCESS_SAT,
                        lanes).to(I32)
    return torch.cat([act.to(I32), tot, iters, rows, cols, sat.to(I32),
                      lanes])


def _sh_enter(state, eps: int, *, ops: dict, refine: bool):
    F, Ffb, Fmt, pe, pm, pt = state
    C, U, Uem, supply, cap, adm = (ops[n] for n in
                                   ("C", "U", "Uem", "supply", "cap", "adm"))
    coll, k = ops["coll"], len(F)
    if refine:
        def refine_to(rc, flow, hi):
            return torch.where(rc < -eps, hi,
                               torch.where(rc > eps, 0, flow))

        F = [refine_to(torch.where(adm[j], C[j] + pe[j][:, None]
                                   - pm[j][None, :], _POS), F[j], Uem[j])
             for j in range(k)]
        Ffb = [refine_to(U[j] + pe[j] - pt[j], Ffb[j], supply[j])
               for j in range(k)]
        Fmt = [refine_to(pm[j] - pt[j], Fmt[j], cap[j]) for j in range(k)]
    exc_e, exc_m, exc_t = _sh_excesses(F, Ffb, Fmt, supply=supply,
                                       total=ops["total"], coll=coll)
    st = _sh_status(exc_e, exc_m, exc_t,
                    torch.zeros(1, dtype=I32, device=coll.lead), coll=coll)
    return (F, Ffb, Fmt, pe, pm, pt), exc_e, exc_m, exc_t, st


def _sh_iteration(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, *,
                  eps: int, do_relabel: bool, C, U, Uem, supply, cap, adm,
                  total: int, ring=None, ring_base: int = 0, coll):
    k = len(F)
    R = range(k)
    if ring is not None:
        transport._telem_write(ring, st, ring_base, eps)
    rc_em = [torch.where(adm[j], C[j] + pe[j][:, None] - pm[j][None, :],
                         _POS) for j in R]
    rc_fb = [U[j] + pe[j] - pt[j] for j in R]
    rc_mt = [pm[j] - pt[j] for j in R]

    # EC rows: machine arcs in column order (a local cumsum plus the
    # shards-before's row totals), then the fallback arc.
    res_em = [torch.where((rc_em[j] < 0) & (exc_e[j][:, None] > 0),
                          Uem[j] - F[j], 0) for j in R]
    cs = [torch.cumsum(res_em[j], 1, dtype=I32) for j in R]
    off, _ = coll.exscan([c[:, -1] for c in cs])
    ec_push = [torch.clamp(torch.minimum(
        res_em[j], exc_e[j][:, None] - (cs[j] + off[j][:, None] - res_em[j])),
        min=0) for j in R]
    pushed = coll.reduce("sum", [p.sum(1, dtype=I32) for p in ec_push])
    left_e = [exc_e[j] - pushed[j] for j in R]
    fb_push = [torch.where((rc_fb[j] < 0) & (left_e[j] > 0),
                           torch.minimum(supply[j] - Ffb[j], left_e[j]), 0)
               for j in R]

    # Machine rows (local): the sink arc first, then reverse arcs.
    mt_push = [torch.where((rc_mt[j] < 0) & (exc_m[j] > 0),
                           torch.minimum(cap[j] - Fmt[j], exc_m[j]), 0)
               for j in R]
    left_m = [exc_m[j] - mt_push[j] for j in R]
    me_push = []
    for j in R:
        res_me = torch.where((rc_em[j] > 0) & (left_m[j][None, :] > 0),
                             F[j], 0)
        before_me = torch.cumsum(res_me, 0, dtype=I32) - res_me
        me_push.append(torch.clamp(
            torch.minimum(res_me, left_m[j][None, :] - before_me), min=0))

    # Sink row: reverse arcs to machines (a local cumsum plus the
    # shards-before's totals), then to EC fallbacks (after every
    # machine's: offset by the whole machine part's total).
    res_tm = [torch.where(-rc_mt[j] < 0, Fmt[j], 0) * (exc_t[j] > 0)
              for j in R]
    res_tf = [torch.where(-rc_fb[j] < 0, Ffb[j], 0) * (exc_t[j] > 0)
              for j in R]
    cs_tm = [torch.cumsum(r, 0, dtype=I32) for r in res_tm]
    off_t, tot_t = coll.exscan([c[-1:] for c in cs_tm])
    t_push_m = [torch.clamp(torch.minimum(
        res_tm[j], exc_t[j] - (cs_tm[j] + off_t[j] - res_tm[j])), min=0)
        for j in R]
    t_push_f = [torch.clamp(torch.minimum(
        res_tf[j], exc_t[j] - (torch.cumsum(res_tf[j], 0, dtype=I32)
                               + tot_t[j] - res_tf[j])), min=0)
        for j in R]

    F_new = [F[j] + ec_push[j] - me_push[j] for j in R]
    Ffb_new = [Ffb[j] + fb_push[j] - t_push_f[j] for j in R]
    Fmt_new = [Fmt[j] + mt_push[j] - t_push_m[j] for j in R]
    exc_e, exc_m, exc_t = _sh_excesses(F_new, Ffb_new, Fmt_new,
                                       supply=supply, total=total, coll=coll)

    if do_relabel:
        has_em = [(Uem[j] - F_new[j]) > 0 for j in R]
        fb_open = [supply[j] - Ffb_new[j] > 0 for j in R]
        any_e = coll.reduce("any", [((rc_em[j] < 0) & has_em[j]).any(1)
                                    for j in R])
        max_e = coll.reduce("amax", [
            torch.where(has_em[j] & adm[j], pm[j][None, :] - C[j],
                        _NEG).amax(1) for j in R])
        any_t = coll.reduce("any", [
            ((-rc_mt[j] < 0) & (Fmt_new[j] > 0)).any().reshape(1)
            for j in R])
        max_t = coll.reduce("amax", [
            torch.where(Fmt_new[j] > 0, pm[j], _NEG).amax().reshape(1)
            for j in R])
        pe_new, pm_new, pt_new = [], [], []
        for j in R:
            has_adm_e = any_e[j] | ((rc_fb[j] < 0) & fb_open[j])
            maxcand_e = torch.maximum(
                max_e[j], torch.where(fb_open[j], pt[j] - U[j], _NEG))
            pe_new.append(_relabel_to(maxcand_e, has_adm_e, exc_e[j], pe[j],
                                      eps))

            mt_open = cap[j] - Fmt_new[j] > 0
            has_adm_m = (((rc_mt[j] < 0) & mt_open)
                         | ((rc_em[j] > 0) & (F_new[j] > 0)).any(0))
            maxcand_m = torch.maximum(
                torch.where(mt_open, pt[j], _NEG),
                torch.where((F_new[j] > 0) & adm[j],
                            pe[j][:, None] + C[j], _NEG).amax(0),
            )
            pm_new.append(_relabel_to(maxcand_m, has_adm_m, exc_m[j], pm[j],
                                      eps))

            fb_loaded = Ffb_new[j] > 0
            has_adm_t = any_t[j] | ((-rc_fb[j] < 0) & fb_loaded).any() \
                .reshape(1)
            maxcand_t = torch.maximum(
                max_t[j], torch.where(fb_loaded, pe[j] + U[j], _NEG).amax()
                .reshape(1))
            pt_new.append(_relabel_to(maxcand_t, has_adm_t, exc_t[j], pt[j],
                                      eps))
        pe, pm, pt = pe_new, pm_new, pt_new

    counted = st[_ST_ITERS:_ST_ITERS + 1] + st[_ST_ACTIVE:_ST_ACTIVE + 1]
    st = _sh_status(exc_e, exc_m, exc_t, counted, coll=coll)
    return F_new, Ffb_new, Fmt_new, pe, pm, pt, exc_e, exc_m, exc_t, st


def _sh_global_update(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t,
                      sweeps_acc, *, C, U, Uem, supply, cap, adm, eps: int,
                      bf_max: int, ring=None, ring_slot: int = 0, coll):
    k = len(F)
    R = range(k)

    def lengths(rc):
        return torch.div(rc, eps, rounding_mode="floor") + 1

    l_em, l_me, l_efb, l_tfb, l_mt, l_tm = [], [], [], [], [], []
    has_em, has_me, has_efb, has_tfb, has_mt, has_tm = [], [], [], [], [], []
    for j in R:
        rc_em = torch.where(adm[j], C[j] + pe[j][:, None] - pm[j][None, :], 0)
        l_em.append(torch.where(adm[j], lengths(rc_em), _DINF))
        l_me.append(torch.where(adm[j], lengths(-rc_em), _DINF))
        l_efb.append(lengths(U[j] + pe[j] - pt[j]))
        l_tfb.append(lengths(-(U[j] + pe[j] - pt[j])))
        l_mt.append(lengths(pm[j] - pt[j]))
        l_tm.append(lengths(-(pm[j] - pt[j])))
        has_em.append((Uem[j] - F[j]) > 0)
        has_me.append(F[j] > 0)
        has_efb.append((supply[j] - Ffb[j]) > 0)
        has_tfb.append(Ffb[j] > 0)
        has_mt.append((cap[j] - Fmt[j]) > 0)
        has_tm.append(Fmt[j] > 0)

    d_e = [torch.where(exc_e[j] < 0, 0, torch.full_like(exc_e[j], _DINF))
           for j in R]
    d_m = [torch.where(exc_m[j] < 0, 0, torch.full_like(exc_m[j], _DINF))
           for j in R]
    d_t = [torch.where(exc_t[j] < 0, 0, torch.full_like(exc_t[j], _DINF))
           for j in R]

    def sweep(d_e, d_m, d_t):
        via_m = coll.reduce("amin", [
            torch.where(has_em[j], l_em[j] + d_m[j][None, :], _DINF).amin(1)
            for j in R])
        via_m_t = coll.reduce("amin", [
            torch.where(has_tm[j], l_tm[j] + d_m[j], _DINF).amin().reshape(1)
            for j in R])
        e_new, m_new, t_new = [], [], []
        for j in R:
            via_t = torch.where(has_efb[j], l_efb[j] + d_t[j], _DINF)
            e_new.append(torch.minimum(d_e[j], torch.minimum(via_m[j],
                                                             via_t)))
            via_e = torch.where(has_me[j], l_me[j] + d_e[j][:, None],
                                _DINF).amin(0)
            via_t_m = torch.where(has_mt[j], l_mt[j] + d_t[j], _DINF)
            m_new.append(torch.minimum(d_m[j], torch.minimum(via_e, via_t_m)))
            via_e_t = torch.where(has_tfb[j], l_tfb[j] + d_e[j], _DINF).amin()
            t_new.append(torch.minimum(d_t[j], torch.minimum(via_m_t[j],
                                                             via_e_t)))
        return e_new, m_new, t_new

    # Four sweeps per read of the ``changed`` flag (reduced onto shard
    # 0), as the plain update.
    BF_UNROLL = 4
    sweeps = 0
    changed = True
    while changed and sweeps <= bf_max:
        d0 = (d_e, d_m, d_t)
        for _ in range(BF_UNROLL):
            d_e, d_m, d_t = sweep(d_e, d_m, d_t)
        moved_m = coll.reduce("any", [
            (d_m[j] != d0[1][j]).any().reshape(1) for j in R],
            lead_only=True)
        flag = ((d_e[0] != d0[0][0]).any() | moved_m
                | (d_t[0] != d0[2][0]).any())
        changed = bool(_host_read(flag))
        sweeps += BF_UNROLL

    sweeps_acc += sweeps
    if ring is not None:
        ring[_TR_GU, ring_slot] = 1
        ring[_TR_BF, ring_slot] = sweeps
    if changed:
        return pe, pm, pt
    max_m = coll.reduce("amax", [
        torch.where(d_m[j] < _DINF, d_m[j], 0).amax().reshape(1)
        for j in R])
    pe_new, pm_new, pt_new = [], [], []
    for j in R:
        finite_max = torch.maximum(
            torch.maximum(torch.where(d_e[j] < _DINF, d_e[j], 0).amax(),
                          max_m[j]),
            torch.where(d_t[j] < _DINF, d_t[j], 0).amax(),
        )
        dbig = finite_max + 1
        de = torch.where(d_e[j] >= _DINF, dbig, d_e[j])
        dm = torch.where(d_m[j] >= _DINF, dbig, d_m[j])
        dt = torch.where(d_t[j] >= _DINF, dbig, d_t[j])
        ok = finite_max < (1 << 26) // max(eps, 1)
        pe_new.append(torch.where(
            ok, torch.clamp(pe[j] - eps * de, min=_NEG // 2), pe[j]))
        pm_new.append(torch.where(
            ok, torch.clamp(pm[j] - eps * dm, min=_NEG // 2), pm[j]))
        pt_new.append(torch.where(
            ok, torch.clamp(pt[j] - eps * dt, min=_NEG // 2), pt[j]))
    return pe_new, pm_new, pt_new


def _solve_device_sharded(devices, costs, supply, capacity, unsched_cost,
                          arc_cap, init_prices, init_flows, init_fb,
                          eps_sched, max_iter_total: int, global_every: int,
                          bf_max: int, adaptive_bf: int = 0, *,
                          max_iter: int, scale: int, total: int,
                          telem_cap: int = 0):
    """The sharded ladder (the reference's ``_solve_device`` run SPMD
    over the mesh ``devices``) on host int32 operands at the padded
    shape, the machine axis already in shard order.  Uploads each
    shard's blocks to its device, runs every phase through
    ``transport._pr_phase`` with the sharded hooks, and returns
    ``(F blocks, small)``: the per-shard flow blocks on their devices
    and, on shard 0, the int32 vector ``fallback | prices | iters, bf,
    clean, unchanged | per-phase iterations | the flattened ring`` (the
    one-device packed path's layout; the ring has one lane per shard
    after the shared rows)."""
    k = len(devices)
    coll = _Collectives(devices)
    lead = coll.lead
    E, M = costs.shape
    if M % k != 0:
        raise ValueError(f"sharded solve: {M} machine columns are not a "
                         f"multiple of the mesh's {k} shards")
    B = M // k
    R = range(k)

    def cols(a, j):
        return a[..., j * B:(j + 1) * B]

    with _stage("solve.upload", lead):
        costs_d = [_upload(cols(costs, j), devices[j]) for j in R]
        arc_d = [_upload(cols(arc_cap, j), devices[j]) for j in R]
        flows_d = [_upload(cols(init_flows, j), devices[j]) for j in R]
        cap_d = [_upload(cols(capacity, j), devices[j]) for j in R]
        pm_d = [_upload(cols(init_prices[E:E + M], j), devices[j]) for j in R]
        supply_d = [_upload(supply, d) for d in devices]
        unsched_d = [_upload(unsched_cost, d) for d in devices]
        pe_d = [_upload(init_prices[:E], d) for d in devices]
        pt_d = [_upload(init_prices[E + M:E + M + 1], d) for d in devices]
        fb_d = [_upload(init_fb, d) for d in devices]

    # The preamble (the plain ladder's ``_prepare_operands``), per shard;
    # the warm clip's row check sums over the machine axis.
    C = [torch.where(c >= INF_COST, INF_COST, c * scale) for c in costs_d]
    U = [u * scale for u in unsched_d]
    Uem = [torch.minimum(torch.minimum(supply_d[j][:, None],
                                       cap_d[j][None, :]), arc_d[j])
           for j in R]
    F0 = [torch.where(costs_d[j] < INF_COST,
                      torch.minimum(torch.clamp(flows_d[j], min=0), Uem[j]),
                      0) for j in R]
    rows = coll.reduce("sum", [f.sum(1, dtype=I32) for f in F0])
    keep = [rows[j] <= supply_d[j] for j in R]
    F0 = [torch.where(keep[j][:, None], F0[j], 0).contiguous() for j in R]
    Ffb0 = [torch.minimum(torch.clamp(fb_d[j], min=0),
                          supply_d[j] - torch.where(keep[j], rows[j], 0))
            for j in R]
    Fmt0 = [torch.minimum(F0[j].sum(0, dtype=I32), cap_d[j]) for j in R]
    ops = dict(C=C, U=U, Uem=Uem, supply=supply_d, cap=cap_d,
               adm=[c < INF_COST for c in costs_d], total=total, coll=coll)
    state = (F0, Ffb0, Fmt0, pe_d, pm_d, pt_d)

    def iterate(*a, **kw):
        return _sh_iteration(*a, coll=coll, **kw)

    def global_update(*a, **kw):
        return _sh_global_update(*a, coll=coll, **kw)

    unroll = transport.iter_unroll(lead)
    iters = 0
    sweeps = torch.zeros(1, dtype=I32, device=lead)
    ring = (torch.zeros((TELEM_ROWS + k, telem_cap), dtype=I32, device=lead)
            if telem_cap else None)
    phase_iters = []
    with _stage("solve.device"), _stage("solve.device.sharded", lead):
        for eps in eps_sched:
            state, it = transport._pr_phase(
                state, int(eps), ops=ops, iterate=iterate,
                global_update=global_update, enter=_sh_enter, sweeps=sweeps,
                total_iters=iters, max_iter=max_iter,
                max_iter_total=max_iter_total, global_every=global_every,
                bf_max=bf_max, adaptive=adaptive_bf, unroll=unroll,
                stage="solve.device.sharded", ring=ring,
            )
            iters += it
            phase_iters.append(it)
        F, Ffb, Fmt, pe, pm, pt = state
        exc_e, exc_m, exc_t = _sh_excesses(F, Ffb, Fmt, supply=supply_d,
                                           total=total, coll=coll)
        dirty_m = coll.reduce("any", [(m != 0).any().reshape(1)
                                      for m in exc_m], lead_only=True)
        clean = ~((exc_e[0] != 0).any() | dirty_m | (exc_t[0] != 0).any())
        # A solve that returns its warm start bit for bit needs no flow
        # fetch (the host owns that matrix), as on one device.
        unchanged = ~coll.reduce("any", [
            (F[j] != flows_d[j]).any().reshape(1) for j in R],
            lead_only=True)
        small = torch.cat([
            Ffb[0], pe[0], coll.gather(pm), pt[0],
            torch.tensor([iters], dtype=I32, device=lead), sweeps,
            clean.to(I32).reshape(1), unchanged.to(I32).reshape(1),
            torch.tensor(phase_iters, dtype=I32, device=lead),
        ] + ([] if ring is None else [ring.reshape(-1)]))
    return F, small


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
    costs = np.asarray(costs, dtype=np.int32)
    supply = np.asarray(supply, dtype=np.int32)
    capacity = np.asarray(capacity, dtype=np.int32)
    unsched_cost = np.asarray(unsched_cost, dtype=np.int32)
    # The device's int32 flow sums (the per-shard partials included) are
    # bounded by this total.
    certify_i32_total(supply, site="solve_transport_sharded.supply")
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
    devices = mesh.devices
    lead = devices[0]
    if global_update_every < 1:
        raise ValueError(
            f"global_update_every must be >= 1, got {global_update_every}"
        )

    # Rows pad to a power of two, machines to the quarter-octave bucket
    # rounded up to a mesh multiple (transport.padded_shape): dead rows
    # and columns have zero supply and capacity and no admissible arcs.
    e_pad, m_bucket = transport.padded_shape(E, M)
    m_pad = ((m_bucket + n_dev - 1) // n_dev) * n_dev

    costs_p = np.full((e_pad, m_pad), INF_COST, dtype=np.int32)
    costs_p[:E, :M] = costs
    supply_p = np.zeros(e_pad, dtype=np.int32)
    supply_p[:E] = supply
    unsched_p = np.ones(e_pad, dtype=np.int32)
    unsched_p[:E] = unsched_cost
    capacity_p = _pad_columns(capacity, m_pad, 0)
    arc_cap_p = np.zeros((e_pad, m_pad), dtype=np.int32)
    if arc_capacity is None:
        arc_cap_p[:E, :M] = _POS
    else:
        arc_capacity = np.asarray(arc_capacity, dtype=np.int32)
        if (arc_capacity < 0).any():
            raise ValueError("arc_capacity must be non-negative")
        arc_cap_p[:E, :M] = arc_capacity
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
    flows_p = np.zeros((e_pad, m_pad), dtype=np.int32)
    if init_flows is not None:
        flows_p[:E, :M] = init_flows
    fb_p = np.zeros(e_pad, dtype=np.int32)
    if init_unsched is not None:
        fb_p[:E] = init_unsched
    prices_p = np.zeros(e_pad + m_pad + 1, dtype=np.int32)
    if init_prices is not None:
        # Anchored at max 0 with the spread floor-clamped, as on one
        # device.
        init_prices = transport.normalize_prices(init_prices)
        prices_p[:E] = init_prices[:E]
        prices_p[e_pad:e_pad + M] = init_prices[E:E + M]
        prices_p[e_pad + m_pad] = init_prices[E + M]

    with _stage("solve.validate"):
        scale, eps_sched, eps0_cold = _host_validate(
            costs_p, supply_p, capacity_p, unsched_p, scale, eps_start,
            max_cost_hint,
        )

    # Strided layout: slot d*B + b of the padded machine axis holds
    # original column b*k + d, so shard d's contiguous block holds every
    # column c with c % k == d.  Applied after the greedy start and the
    # validation (both in original column order; the scale, epsilon and
    # warm duals do not depend on the layout) and inverted on every
    # fetched [*, m_pad] result.
    strided = hatch_bool("POSEIDON_SHARD_STRIDED")
    if strided:
        blk = m_pad // n_dev
        perm = np.arange(m_pad).reshape(blk, n_dev).T.ravel()
        inv_perm = np.argsort(perm)
        costs_p = np.ascontiguousarray(costs_p[:, perm])
        capacity_p = np.ascontiguousarray(capacity_p[perm])
        arc_cap_p = np.ascontiguousarray(arc_cap_p[:, perm])
        flows_p = np.ascontiguousarray(flows_p[:, perm])
        prices_p[e_pad:e_pad + m_pad] = prices_p[e_pad:e_pad + m_pad][perm]

    if max_iter_total is None:
        max_iter_total = NUM_PHASES * max_iter_per_phase
    _Telemetry.device_calls += 1
    _Telemetry.routes[("sharded", e_pad, m_pad, n_dev)] += 1
    _ledger.note_solve_key(("sharded", e_pad, m_pad, n_dev, int(scale)))
    # The ring carries one more row per shard: its machine columns'
    # active excess (decode_telemetry's shard_excess).
    telem_cap = transport.solve_telemetry_cap()
    telem_shards = n_dev if telem_cap else 0
    F_blocks, small_d = _solve_device_sharded(
        devices, costs_p, supply_p, capacity_p, unsched_p, arc_cap_p,
        prices_p, flows_p, fb_p, [int(e) for e in eps_sched],
        int(max_iter_total), int(global_update_every), int(bf_max),
        transport.adaptive_bf_flag(lead), max_iter=max_iter_per_phase,
        scale=int(scale), total=int(supply_p.astype(np.int64).sum()),
        telem_cap=telem_cap,
    )
    small = _host_read(small_d)
    unsched = small[:E]
    o = e_pad
    prices_full = small[o:o + e_pad + m_pad + 1]
    o += e_pad + m_pad + 1
    iters, bf, clean, unchanged = (int(small[o]), int(small[o + 1]),
                                   bool(small[o + 2]), bool(small[o + 3]))
    _Telemetry.route_iters["sharded"] += iters
    _Telemetry.route_sweeps["sharded"] += bf
    phase_iters = small[o + 4:o + 4 + NUM_PHASES]
    ring = small[o + 4 + NUM_PHASES:].reshape(TELEM_ROWS + n_dev, -1) \
        if telem_cap else np.zeros((TELEM_ROWS, 0), dtype=np.int32)
    if unchanged:
        flows = flows_p
    else:
        with _stage("solve.fetch_flows"):
            flows = _host_read_blocks(F_blocks, axis=1)
    if strided:
        flows = flows[:, inv_perm]
        prices_full = prices_full.copy()
        prices_full[e_pad:e_pad + m_pad] = (
            prices_full[e_pad:e_pad + m_pad][inv_perm]
        )
    flows = flows[:E, :M].copy()
    prices_out = np.concatenate(
        [prices_full[:E], prices_full[e_pad:e_pad + M],
         prices_full[e_pad + m_pad:]]
    )
    sol = _host_finalize(
        flows, unsched, prices_out, iters,
        costs=costs, supply=supply, capacity=capacity,
        unsched_cost=unsched_cost, scale=scale, clean=clean,
        arc_capacity=arc_capacity, bf_sweeps=bf,
        phase_iters=tuple(int(x) for x in phase_iters),
    )
    sol.entry_phase = transport.ladder_entry_phase(eps0_cold,
                                                   int(eps_sched[0]))
    sol.telemetry = transport.decode_telemetry(
        ring, iters, telem_shards=telem_shards
    )
    return sol

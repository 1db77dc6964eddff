"""The plain reference that decides ``correct``: NumPy only.

It imports nothing of the scheduler under test.  From the inputs the
benchmark hands the service (machines, pods, completions, and the order
in which the service took them in) it rebuilds the cluster, and for
every judged ``Schedule()`` round it works out again what the round had
to solve and checks the deltas the client received:

* the replies: every delta is a PLACE of a pod that was pending when the
  round took its snapshot, onto a known machine, at most once;
* the cluster the deltas imply: after the round no machine holds more
  cpu, ram or pods than it has;
* the ``cpu_mem`` costs: the round's objective, summed from this file's
  own cost planes over the placement the deltas make, equals the
  objective the service reports for the round;
* optimality: each band group's transportation problem, rebuilt here
  (bands, merge gate, per-column capacities, arc capacities, costs,
  starvation-escalated unscheduled costs), has no negative cycle in the
  residual graph of the flows the deltas make.

The band rules, the merge gate, the column capacities and the cost
arithmetic follow the deployment's planner as documented (Firmament's
size-banded transportation with a largest-request column denominator,
and the ``cpu_mem`` model's float64 load-after-placement cost); the
arithmetic is a plain copy, operation for operation, so that equal
inputs give bit-equal costs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# The cost model's constants (Firmament's cpu_mem model as deployed).
NORMALIZED_COST = 1000
INF_COST = 1 << 28
MEASURED_WEIGHT = 0.25
CPU_WEIGHT = 0.5
UNSCHED_BASE = 2 * NORMALIZED_COST
UNSCHED_PER_ROUND = NORMALIZED_COST // 4
UNSCHED_MAX = 8 * NORMALIZED_COST
COST_MAX = 4 * NORMALIZED_COST
# Size bands: rows whose dominant request fraction lies within one factor
# of BAND_BASE solve together, largest first.
BAND_BASE = 8.0
NUM_BANDS = 8
BIG_FIT = np.iinfo(np.int32).max // 4

PLACE = 1


@dataclass
class Machines:
    """The fleet: per machine cpu (millicores), ram (KB) and pod slots."""

    uuids: List[str]
    cpu: np.ndarray
    ram: np.ndarray
    slots: np.ndarray

    def __post_init__(self):
        self.cpu = np.asarray(self.cpu, np.int64)
        self.ram = np.asarray(self.ram, np.int64)
        self.slots = np.asarray(self.slots, np.int64)
        self.index = {u: i for i, u in enumerate(self.uuids)}


@dataclass
class Verdict:
    """What the reference found over the rounds it judged."""

    bad_replies: int = 0
    infeasible: int = 0
    neg_cycles: int = 0
    objective_gap: int = 0
    never_placed: int = 0
    notes: List[str] = field(default_factory=list)

    def add(self, other: "Verdict") -> None:
        self.bad_replies += other.bad_replies
        self.infeasible += other.infeasible
        self.neg_cycles += other.neg_cycles
        self.objective_gap += other.objective_gap
        self.never_placed += other.never_placed
        self.notes.extend(other.notes)

    def numbers(self) -> Dict[str, int]:
        return {"bad_replies": self.bad_replies,
                "infeasible": self.infeasible,
                "neg_cycles": self.neg_cycles,
                "objective_gap": self.objective_gap,
                "never_placed": self.never_placed}


def cost_planes(cpu_req, ram_req, cap_cpu, cap_ram, used_cpu, used_ram):
    """The cpu_mem model's planes for rows of requests against machines
    with ``used`` committed: ``(costs int32 [E, M], arc_cap int32 [E, M],
    admissible bool [E, M])``.  No utilization samples reach the service
    in these workloads, so the measured term is zero."""
    cpu_capf = np.maximum(cap_cpu.astype(np.float64), 1.0)
    ram_capf = np.maximum(cap_ram.astype(np.float64), 1.0)
    creq = np.asarray(cpu_req).astype(np.float64)[:, None]
    rreq = np.asarray(ram_req).astype(np.float64)[:, None]
    cpu_free = (cap_cpu - used_cpu).astype(np.float64)[None, :]
    ram_free = (cap_ram - used_ram).astype(np.float64)[None, :]
    adm = (creq <= cpu_free) & (rreq <= ram_free)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_cpu = np.where(creq > 0,
                         np.floor(cpu_free / np.maximum(creq, 1e-9)), np.inf)
        n_ram = np.where(rreq > 0,
                         np.floor(ram_free / np.maximum(rreq, 1e-9)), np.inf)
    n_fit = np.minimum(n_cpu, n_ram)
    n_fit = np.minimum(np.where(np.isfinite(n_fit), n_fit, BIG_FIT), BIG_FIT)
    arc_cap = np.where(adm, n_fit.astype(np.int32), np.int32(0))
    util = np.zeros(cap_cpu.shape[0], np.float64)
    w, wc = MEASURED_WEIGHT, CPU_WEIGHT
    cpu_load = ((1.0 - w) * (used_cpu[None, :] + creq) / cpu_capf[None, :]
                + w * util[None, :])
    mem_load = ((1.0 - w) * (used_ram[None, :] + rreq) / ram_capf[None, :]
                + w * util[None, :])
    load = wc * cpu_load + (1.0 - wc) * mem_load
    costs = np.clip(np.rint(load * NORMALIZED_COST), 0, COST_MAX).astype(
        np.int32)
    costs = np.where(adm, costs, INF_COST).astype(np.int32)
    return costs, arc_cap, adm


def unsched_costs(max_wait) -> np.ndarray:
    """Per-row unscheduled cost: the starvation escalator."""
    u = UNSCHED_BASE + UNSCHED_PER_ROUND * np.asarray(max_wait, np.int64)
    return np.clip(u, 0, UNSCHED_MAX).astype(np.int32)


def bands_of(cpu_req, ram_req, cap_cpu, cap_ram) -> np.ndarray:
    """Band per row from the dominant request fraction (0 = largest)."""
    ccpu = float(max(int(cap_cpu.max(initial=1)), 1))
    cram = float(max(int(cap_ram.max(initial=1)), 1))
    frac = np.maximum(np.asarray(cpu_req, np.float64) / ccpu,
                      np.asarray(ram_req, np.float64) / cram)
    frac = np.clip(frac, 1e-12, 1.0)
    band = np.floor(-np.log(frac) / np.log(BAND_BASE))
    return np.clip(band, 0, NUM_BANDS - 1).astype(np.int64)


def next_group(remaining, bands, cpu_req, ram_req, supply, cap_cpu, cap_ram,
               com_cpu, com_ram, merge: bool):
    """How many leading bands of ``remaining`` solve together, and their
    rows: merged while the group's capacity units (free // the group's
    largest request, summed over machines) cover twice its supply."""
    idx = np.nonzero(bands == remaining[0])[0]
    if not merge:
        return 1, idx
    cpu_free = np.maximum(cap_cpu - com_cpu, 0)
    ram_free = np.maximum(cap_ram - com_ram, 0)
    g_supply = int(supply[idx].sum())
    g_cpu = int(cpu_req[idx].max(initial=0))
    g_ram = int(ram_req[idx].max(initial=0))
    n = 1
    for band in remaining[1:]:
        b_idx = np.nonzero(bands == band)[0]
        mc = max(g_cpu, int(cpu_req[b_idx].max(initial=0)))
        mr = max(g_ram, int(ram_req[b_idx].max(initial=0)))
        s = g_supply + int(supply[b_idx].sum())
        units = np.minimum(cpu_free // max(mc, 1), ram_free // max(mr, 1))
        if int(units.sum()) < 2 * s:
            break
        idx = np.concatenate([idx, b_idx])
        g_supply, g_cpu, g_ram = s, mc, mr
        n += 1
    return n, np.sort(idx)


def column_caps(adm, cpu_req, ram_req, slots_free, cap_cpu, cap_ram,
                com_cpu, com_ram) -> np.ndarray:
    """Per-column capacity in pods: the free slots, and free cpu and ram
    over the largest request admissible on the column."""
    col = slots_free.astype(np.int64)
    for req, cap, used in ((cpu_req, cap_cpu, com_cpu),
                           (ram_req, cap_ram, com_ram)):
        denom = np.where(adm, np.asarray(req, np.int64)[:, None], 0).max(
            axis=0, initial=0)
        free = np.maximum(cap - used, 0)
        col = np.where(denom > 0, np.minimum(col, free // np.maximum(denom, 1)),
                       col)
    return np.clip(col, 0, None)


def negative_cycle(costs, adm, arc_cap, col_cap, unsched, supply,
                   flows) -> bool:
    """True when the residual graph of ``flows`` in the transportation
    problem (rows with ``supply``, columns with ``col_cap``, arcs with
    ``arc_cap`` and ``costs``, and each row's unscheduled arc at
    ``unsched``) holds a negative cycle, i.e. the flows are not optimal.

    Bellman-Ford from a virtual source over rows, columns and the sink,
    all arcs relaxed at once per sweep.  A simple path alternates rows
    with a column or the sink, so it has at most 2E + 3 arcs: distances
    that still fall after 2E + 5 sweeps prove a cycle."""
    E, M = costs.shape
    if E == 0 or M == 0:
        return False
    big = np.int64(1) << 50
    c = costs.astype(np.int64)
    fwd = adm & (flows < arc_cap)
    cf = np.where(fwd, c, big)
    be, bm = np.nonzero(flows > 0)
    bc = c[be, bm]
    colsum = flows.sum(axis=0, dtype=np.int64)
    rowsum = flows.sum(axis=1, dtype=np.int64)
    u = np.asarray(supply, np.int64) - rowsum
    un = np.asarray(unsched, np.int64)
    t_to_m = colsum > 0
    m_to_t = colsum < col_cap
    t_to_e = u > 0
    de = np.zeros(E, np.int64)
    dm = np.zeros(M, np.int64)
    dt = np.int64(0)
    for _ in range(2 * E + 6):
        ndm = np.minimum(dm, (de[:, None] + cf).min(axis=0))
        ndm = np.where(t_to_m, np.minimum(ndm, dt), ndm)
        ndt = min(dt, (de + un).min())
        if m_to_t.any():
            ndt = min(ndt, dm[m_to_t].min())
        nde = de.copy()
        if be.size:
            np.minimum.at(nde, be, dm[bm] - bc)
        nde = np.where(t_to_e, np.minimum(nde, dt - un), nde)
        if (ndt == dt and np.array_equal(nde, de)
                and np.array_equal(ndm, dm)):
            return False
        de, dm, dt = nde, ndm, np.int64(ndt)
    return True


class Reference:
    """The cluster as the inputs and the judged deltas leave it."""

    def __init__(self, machines: Machines, merge_bands: bool) -> None:
        self.m = machines
        self.merge = merge_bands
        M = len(machines.uuids)
        self.used_cpu = np.zeros(M, np.int64)
        self.used_ram = np.zeros(M, np.int64)
        self.used_slots = np.zeros(M, np.int64)
        self.shape: Dict[int, Tuple[int, int]] = {}
        self.where: Dict[int, int] = {}
        self.pending: Dict[int, int] = {}   # uid -> rounds waited

    # ----------------------------------------------------------- inputs

    def submit(self, uid: int, cpu: int, ram: int) -> None:
        self.shape[uid] = (int(cpu), int(ram))
        self.pending[uid] = 0

    def complete(self, uid: int) -> None:
        m = self.where.pop(uid, None)
        if m is None:
            self.pending.pop(uid, None)
            return
        cpu, ram = self.shape[uid]
        self.used_cpu[m] -= cpu
        self.used_ram[m] -= ram
        self.used_slots[m] -= 1

    # ----------------------------------------------------------- rounds

    def judge(self, uids, cols, types, port_objective: Optional[int],
              ) -> Verdict:
        """Judge one round's deltas (task uids, machine indices with -1
        for an unknown machine, delta types) against the pending set,
        then apply the valid placements."""
        v = Verdict()
        uids = np.asarray(uids, np.uint64)
        cols = np.asarray(cols, np.int64)
        types = np.asarray(types, np.int64)
        seen = set()
        ok_uid, ok_col = [], []
        for u, c, t in zip(uids.tolist(), cols.tolist(), types.tolist()):
            if t != PLACE or c < 0 or u not in self.pending or u in seen:
                v.bad_replies += 1
                continue
            seen.add(u)
            ok_uid.append(u)
            ok_col.append(c)
        pend = sorted(self.pending)
        if pend:
            gap, cycles, infeasible = self._lp_check(
                pend, dict(zip(ok_uid, ok_col)), port_objective, v)
            v.objective_gap += gap
            v.neg_cycles += cycles
            v.infeasible += infeasible
        # Apply: placed pods run, the rest wait one more round.
        placed = set(ok_uid)
        for u, c in zip(ok_uid, ok_col):
            cpu, ram = self.shape[u]
            self.used_cpu[c] += cpu
            self.used_ram[c] += ram
            self.used_slots[c] += 1
            self.where[u] = c
            del self.pending[u]
        for u in pend:
            if u not in placed:
                self.pending[u] += 1
        over = ((self.used_cpu > self.m.cpu) | (self.used_ram > self.m.ram)
                | (self.used_slots > self.m.slots))
        v.infeasible += int(over.sum())
        return v

    def _lp_check(self, pend, place, port_objective, v: Verdict):
        m = self.m
        shp = np.array([self.shape[u] for u in pend], np.int64)
        wait = np.array([self.pending[u] for u in pend], np.int64)
        keys, inv = np.unique(shp, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        E, M = keys.shape[0], len(m.uuids)
        cpu_req, ram_req = keys[:, 0], keys[:, 1]
        supply = np.bincount(inv, minlength=E).astype(np.int64)
        max_wait = np.zeros(E, np.int64)
        np.maximum.at(max_wait, inv, wait)
        flows_all = np.zeros((E, M), np.int64)
        row_of = dict(zip(pend, inv.tolist()))
        for u, c in place.items():
            flows_all[row_of[u], c] += 1
        bands = bands_of(cpu_req, ram_req, m.cpu, m.ram)
        com_cpu = self.used_cpu.copy()
        com_ram = self.used_ram.copy()
        com_slots = np.zeros(M, np.int64)
        base_slots = np.maximum(m.slots - self.used_slots, 0)
        remaining = sorted(set(bands.tolist()))
        objective = 0
        cycles = infeasible = 0
        while remaining:
            n, idx = next_group(remaining, bands, cpu_req, ram_req, supply,
                                m.cpu, m.ram, com_cpu, com_ram, self.merge)
            remaining = remaining[n:]
            costs, arc_cap, adm = cost_planes(cpu_req[idx], ram_req[idx],
                                              m.cpu, m.ram, com_cpu, com_ram)
            slots_free = np.maximum(base_slots - com_slots, 0)
            col_cap = column_caps(adm, cpu_req[idx], ram_req[idx], slots_free,
                                  m.cpu, m.ram, com_cpu, com_ram)
            un = unsched_costs(max_wait[idx])
            f = flows_all[idx]
            sup = supply[idx]
            bad = ((f > 0) & ~adm) | (f > arc_cap)
            rows_over = f.sum(axis=1) > sup
            cols_over = f.sum(axis=0) > col_cap
            infeasible += int(bad.sum() + rows_over.sum() + cols_over.sum())
            cost_sum = int((np.where(adm, costs, 0).astype(np.int64)
                            * f).sum())
            objective += cost_sum + int(
                (un.astype(np.int64) * (sup - f.sum(axis=1))).sum())
            if negative_cycle(costs, adm, arc_cap, col_cap, un, sup, f):
                cycles += 1
                v.notes.append(f"band group of {len(idx)} rows is not "
                               "optimal")
            com_cpu += f.T @ cpu_req[idx]
            com_ram += f.T @ ram_req[idx]
            com_slots += f.sum(axis=0)
        gap = 0
        if port_objective is not None:
            gap = abs(int(port_objective) - objective)
        return gap, cycles, infeasible


# Intake log kinds (the harness's record of the order the service took
# its inputs in) and the OK replies of the two task calls.
SUBMIT, COMPLETE, VIEW = 0, 1, 2
TASK_COMPLETED_OK, TASK_SUBMITTED_OK = 0, 1


def replay(machines: Machines, shapes: Dict[int, Tuple[int, int]],
           kind, uid, reply, rounds, merge_bands: bool,
           expected=()) -> Verdict:
    """Replay the inputs in the order the service took them in and judge
    every round.

    ``kind``, ``uid``, ``reply``: the intake log.  ``rounds``: per round
    in order, ``(pos, view, objective, deltas)``: the log's length when
    the round began, the index of the round's snapshot among the log's
    VIEW events (None for a round that took none), the objective the
    service reported (None when it solved nothing) and the (uids, machine
    indices, types) the client received.  A submission or completion the
    service did not answer with OK counts as a bad reply, and so does a
    delta of a round that took no snapshot.  Of the pods in
    ``expected``, those still pending at the end were never placed."""
    ref = Reference(machines, merge_bands)
    total = Verdict()
    by_view = {}
    blind = {}
    for pos, view, objective, deltas in rounds:
        if view is None:
            blind.setdefault(pos, []).append(deltas)
        else:
            by_view[view] = (objective, deltas)
    k = 0

    def check_blind(i):
        for deltas in blind.pop(i, ()):
            total.bad_replies += int(len(deltas[0]))

    for i, (kd, u, rp) in enumerate(zip(kind, uid, reply)):
        check_blind(i)
        if kd == SUBMIT:
            if rp != TASK_SUBMITTED_OK:
                total.bad_replies += 1
                continue
            cpu, ram = shapes[u]
            ref.submit(u, cpu, ram)
        elif kd == COMPLETE:
            if rp != TASK_COMPLETED_OK:
                total.bad_replies += 1
                continue
            ref.complete(u)
        else:
            objective, deltas = by_view.pop(k, (None, None))
            k += 1
            if deltas is None:
                total.notes.append(f"snapshot {k - 1} has no reply")
                total.bad_replies += 1
                continue
            total.add(ref.judge(*deltas, objective))
    for i in sorted(blind):
        check_blind(i)
    for view in by_view:
        total.notes.append(f"round of snapshot {view} has no snapshot")
        total.bad_replies += 1
    total.never_placed = sum(1 for u in expected if u in ref.pending)
    return total

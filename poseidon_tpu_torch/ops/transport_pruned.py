"""Pruned-plane transportation solves: per-row column shortlists with a
price-out optimality certificate (the PyTorch/CUDA port of
``poseidon_tpu/ops/transport_pruned.py``).

Why this exists: a gang-bound round carries hundreds of EC rows against a
dense 10k-column plane, yet an optimal placement provably touches only a
handful of columns per row (each row needs ``ceil(supply_e / col_cap)``
columns).  FleetOpt's compress-and-route framing (PAPERS.md, arxiv
2603.16514) applies directly: solve a compressed instance, then certify it
against the full one.  The compression here is a *column shortlist* — the
union of every row's k cheapest admissible columns, k sized so the union's
capacity covers total supply with slack — and the certification is the
classical price-out step of delayed column generation: with the reduced
solve's prices (excluded columns priced by the same conservative lift the
selective wrapper uses), any excluded arc with negative reduced cost at
the certified epsilon invalidates the certificate; the violating columns
join the shortlist and the instance re-solves warm.  Columns only ever
grow, so the loop terminates; the final accept is the full-plane
``_certified_eps``, so an accepted solution carries exactly the optimality
guarantee a dense solve would.

Division of labor vs ``solve_transport_selective``: the selective wrapper
reduces ONE dispatch and falls back to the full width the moment its
certificate fails — right for sparse steady-state churn.  This module
reduces a whole *band pipeline* (warm frames, coarse start, gang-repair
re-solves all run on the reduced plane, via the caller's ``solve_on``
closure) and answers certificate failures by *growing the shortlist*
instead of abandoning the reduction — right for dense, wide, row-heavy
bands where every re-solve would otherwise drag the full plane through
the epsilon ladder.  Escalation to the dense path remains the universal
fallback (``solve_pruned`` returns ``sol=None``).

Everything here is host-side numpy; the device work happens inside the
caller's closure (on the card: the same kernels as the dense path, at the
reduced plane's padded shape).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from poseidon_tpu_torch.ops.transport import (
    INF_COST,
    TransportSolution,
    _certified_eps,
    _lift_excluded_prices,
    bucket_size,
    derive_scale,
    normalize_prices,
    padded_shape,
)
from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_int

# Gate defaults (env-overridable per knob: tests and triage shrink them to
# exercise the path at toy scale; production keeps the pruned path off the
# small planes where the dense solve is already cheap).
PRUNE_MIN_ROWS = 192       # POSEIDON_PRUNE_MIN_ROWS
PRUNE_MIN_COLS = 4096      # POSEIDON_PRUNE_MIN_COLS
# Dense-plane requirement: admissible cells * factor >= E * M.  Sparse
# planes already have the gathered host paths + the selective wrapper;
# the shortlist's argpartition passes would be pure overhead there.
PRUNE_DENSE_FACTOR = 4
# Union capacity must cover total supply with this slack factor — below
# it, capacity contention forces flow beyond every row's cheap columns,
# the certificate fails by construction (an excluded free column always
# undercuts a loaded fallback arc), and the reduction is wasted work.
PRUNE_SLACK = 2
# The union (after shape bucketing) must stay under this fraction of the
# full width or the reduction isn't buying anything.
PRUNE_MAX_WIDTH_NUM = 1
PRUNE_MAX_WIDTH_DEN = 2
# Price-out loop bounds: violating columns added per offending row and
# re-solve rounds before escalating to the dense path.
PRICE_OUT_TOP_J = 8
PRICE_OUT_MAX_ROUNDS = 3

# Wave-shaped planes: very wide device planes with FEW EC rows (the 10k
# fresh wave solves at [~100, 10240]) are device-bound in the reference
# (docs/PERF.md round 8) — so shrinking the device width pays even
# though the host-side O(E*M) passes were never the problem there.  The
# classic row gate (PRUNE_MIN_ROWS, sized for the
# host-bound gang shape) would exclude them; wave-shaped planes qualify
# through this secondary gate instead.  Every OTHER gate still applies —
# in particular the capacity-slack gate, which correctly declines the
# contended big wave band where a covering union would approach the full
# width anyway.  POSEIDON_PRUNE_WAVE=0 restores the classic gate exactly.
PRUNE_WAVE_MIN_ROWS = 16     # POSEIDON_PRUNE_WAVE_MIN_ROWS
PRUNE_WAVE_MIN_COLS = 8192   # POSEIDON_PRUNE_WAVE_MIN_COLS


def row_gate_ok(E: int, M: int, min_rows: int) -> bool:
    """The shortlist planner's row gate, wave-shape aware.  Shared by
    ``plan_shortlist`` and the planner's shortlist revival so the two
    can never disagree on which planes prune."""
    if E >= min_rows:
        return True
    if not hatch_bool("POSEIDON_PRUNE_WAVE"):
        return False
    return (
        E >= hatch_int("POSEIDON_PRUNE_WAVE_MIN_ROWS", PRUNE_WAVE_MIN_ROWS)
        and M >= hatch_int("POSEIDON_PRUNE_WAVE_MIN_COLS",
                          PRUNE_WAVE_MIN_COLS)
    )


@dataclass
class ShortlistPlan:
    sel: np.ndarray   # sorted full-plane column ids in the union
    k: int            # per-row shortlist width the union was built from


def plan_shortlist(
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    arc_capacity: Optional[np.ndarray] = None,
    *,
    must_include: Optional[np.ndarray] = None,
    min_rows: Optional[int] = None,
    min_cols: Optional[int] = None,
    dense_factor: Optional[int] = None,
    slack: Optional[int] = None,
    k0: Optional[int] = None,
) -> Optional[ShortlistPlan]:
    """Gate + shortlist build.  ``None`` means "solve dense".

    The union is the per-row k cheapest *admissible* columns (k doubling
    from ``k0`` until the union's column capacity covers ``slack`` times
    total supply), plus ``must_include`` columns (warm-frame flow — a
    carried assignment must never be widened away), padded with the
    globally cheapest remaining columns up to a ``bucket_size`` width so
    round-to-round union jitter cannot mint per-round solve shapes (the
reference's compile keys).
    """
    E, M = costs.shape
    # Env tunables apply only when the caller left the knob unset —
    # explicit arguments always win over ambient configuration.
    if min_rows is None:
        min_rows = hatch_int("POSEIDON_PRUNE_MIN_ROWS", PRUNE_MIN_ROWS)
    if min_cols is None:
        min_cols = hatch_int("POSEIDON_PRUNE_MIN_COLS", PRUNE_MIN_COLS)
    dense_factor = (PRUNE_DENSE_FACTOR if dense_factor is None
                    else dense_factor)
    slack = PRUNE_SLACK if slack is None else slack
    if not row_gate_ok(E, M, min_rows) or M < min_cols:
        return None
    adm = costs < INF_COST
    if int(np.count_nonzero(adm)) * dense_factor < E * M:
        return None
    total_supply = int(supply.astype(np.int64).sum())
    cap64 = capacity.astype(np.int64)
    if total_supply <= 0 or slack * total_supply > int(cap64.sum()):
        return None
    width_cap = M * PRUNE_MAX_WIDTH_NUM // PRUNE_MAX_WIDTH_DEN

    base_mask = np.zeros(M, dtype=bool)
    if must_include is not None:
        base_mask |= must_include
    work = np.where(adm, costs, INF_COST)

    # One argpartition + per-row sorted prefix, then the minimal
    # covering k DIRECTLY: a column joins the union at prefix position
    # ``first_pos[m] = min over rows of its rank in that row's sorted
    # shortlist``, so the smallest k whose union capacity covers the
    # slack target falls out of one cumulative-capacity scan over
    # columns ordered by first_pos — no probing.  (The old doubling +
    # 12-step binary refine re-partitioned the full plane per probe:
    # ~22 O(E*M) passes, 1.8 s of the 10k gang round's host time, for
    # the same k this computes exactly.)
    prefix = {"k": 0, "cols": None, "adm": None}

    def _grow_prefix(k):
        kk = min(M, max(k, 64))
        part = np.argpartition(work, kk - 1, axis=1)[:, :kk]
        vals = np.take_along_axis(work, part, axis=1)
        order = np.argsort(vals, axis=1, kind="stable")
        prefix["cols"] = np.take_along_axis(part, order, axis=1)
        prefix["adm"] = np.take_along_axis(vals, order, axis=1) < INF_COST
        prefix["k"] = kk

    pos_cap = cap64[cap64 > 0]
    med_cap = int(np.median(pos_cap)) if pos_cap.size else 1
    if k0 is None:
        # Start from what a row actually needs — enough columns at the
        # median column capacity to hold its own supply, plus margin.
        # A fixed k0 makes the union E*k0 wide under diverse costs (rows
        # share nothing), overshooting the width cap before capacity
        # coverage ever gets a say.
        k0 = int(np.ceil(int(supply.max(initial=1)) / max(med_cap, 1))) + 2
    k = max(4, min(k0, M))
    need = slack * total_supply
    # Prefix width guess: under fully tied costs the union tracks k
    # directly, so coverage needs ~need/med_cap columns per row; the
    # loop regrows (rare) when admissibility holes push k past it.
    _grow_prefix(min(M, max(
        64, 2 * k, int(np.ceil(need / max(med_cap, 1))) + 64,
    )))
    sentinel = np.int64(M) + 1
    while True:
        K = prefix["k"]
        first_pos = np.full(M, sentinel, dtype=np.int64)
        jj = np.broadcast_to(
            np.arange(K, dtype=np.int64), prefix["cols"].shape
        )
        a = prefix["adm"]
        # Only admissible cells select their column: an inadmissible
        # cell would add capacity no row in the shortlist can use.
        np.minimum.at(first_pos, prefix["cols"][a], jj[a])
        first_pos[base_mask] = -1
        order = np.argsort(first_pos, kind="stable")
        cum = np.cumsum(
            np.where(first_pos < sentinel, cap64, 0)[order]
        )
        if cum.size == 0 or int(cum[-1]) < need:
            if K >= M:
                return None  # even the full admissible union can't cover
            _grow_prefix(2 * K)
            continue
        idx = int(np.searchsorted(cum, need))
        fp = int(first_pos[order[idx]])
        if fp >= K and K < M:
            # Coverage only closes beyond the prefix: regrow and redo.
            _grow_prefix(2 * K)
            continue
        mask = base_mask | (first_pos <= fp)
        k = max(fp + 1, 1)
        break
    width = int(mask.sum())
    if width > width_cap:
        return None
    target = bucket_size(width, lo=32)
    if target > width_cap:
        # The quarter-octave bucket would round past the cap: the
        # reduction is no longer buying a meaningful width.
        return None
    if target > width:
        # Pad with the globally cheapest unselected columns (dead columns
        # last) — extra columns only enlarge the union, never unsound.
        col_min = np.where(adm.any(axis=0), work.min(axis=0), INF_COST)
        order = np.argsort(col_min, kind="stable")
        extra = order[~mask[order]][: target - width]
        mask[extra] = True
    return ShortlistPlan(sel=np.nonzero(mask)[0], k=k)


_POS64 = np.int64(1) << 60


class ExcludedColumnCert:
    """Incremental excluded-column certificate: the reduced-plane accept
    without the full-plane O(E*M) pass.

    The pruned accept's only full-plane work is proving that every
    EXCLUDED column prices out clean — equivalently (see
    ``_lift_excluded_prices``) that each excluded column m satisfies
    ``min over open arcs of (C[e,m]*scale + pe[e]) >= pt - 2``.  This
    cache maintains, per band, a sound per-column LOWER BOUND on that
    minimum — ``floor[m] <= min over stable rows of (C*scale + pe_ref)``
    for a reference price vector ``pe_ref`` captured at the last full
    certification — and each round certifies excluded columns by

        ``floor[m] - shift >= pt - 1``   (then ``pm = pt`` is 1-optimal),

    where ``shift = max(pe_ref - pe_now)`` over the stable rows.
    Columns failing the bound are re-checked EXACTLY (a gathered
    O(E * |candidates|) pass that reproduces the lift's accept boundary
    bit-for-bit); genuine violations feed the existing price-out
    escalation.  The caller certifies the INCLUDED plane through the
    reduced solve's own certificate, so an accepted round touches no
    full-plane host work at all.

    Soundness upkeep (fold-only, so the bound can sag but never lie):

    - the planner's delta plane cache reports, per band build, exactly
      which rows/columns changed (``note_build``); their CURRENT cell
      values are folded into ``floor`` with ``min`` before the next
      check — intermediate values a check never saw don't matter;
    - rows are trusted only while STABLE (present in every build since
      the reference): a row that leaves and returns may have missed a
      column fold while absent, so it drops to the exact path until the
      next refresh re-anchors it;
    - a full plane rebuild (unknown changes), a scale change, or a
      fold/exact set grown past its gate invalidates the cache; the
      caller then runs the classic full pass, whose lift already
      computes the per-column minima this cache refreshes from — a
      refresh round costs nothing extra.
    """

    # Unstable + new rows past this fraction of E are declared
    # inconclusive at arm time (their exact block approaches the full
    # plane's O(E*M)); bound-failing COLUMNS carry no such cap — their
    # exact re-check is O(E * cand) <= O(E * excluded), always cheaper
    # than the classic full pass it replaces, and at the solver's
    # normalized equilibrium (uniform-cost gang planes) every excluded
    # minimum sits exactly at pt - 1, so a zero-margin bound flagging
    # every column is the NORMAL case, not a degenerate one.
    ROW_FRAC_NUM = 1
    ROW_FRAC_DEN = 4

    def __init__(self) -> None:
        self.invalidate()

    def invalidate(self) -> None:
        self._scale: Optional[int] = None
        self._ec_pos: dict = {}
        self._pe_ref: Optional[np.ndarray] = None
        self._uuid_pos: dict = {}
        self._floor: Optional[np.ndarray] = None
        self._stable: Optional[np.ndarray] = None   # bool over ref rows
        # Dirty row/column IDS accumulated from plane builds since the
        # last fold (deferred: folding needs costs + scale, which only
        # the firing pruned path has).
        self._pending_rows: set = set()
        self._pending_cols: set = set()
        self._broken = True
        # Per-round prepared state (begin_round):
        self._ready = False
        self._cur_ref_row: Optional[np.ndarray] = None
        self._exact_rows: Optional[np.ndarray] = None
        self._floor_cur: Optional[np.ndarray] = None
        self._trusted_rows: Optional[np.ndarray] = None
        self._cur_ec_ids = None
        self._cur_uuids = None

    @property
    def ready(self) -> bool:
        return self._ready

    # ------------------------------------------------------------ bookkeeping

    def note_build(self, ec_ids, uuids, ledger) -> None:
        """Consume the plane cache's accumulated dirty ledger for this
        band (costmodel/delta.PlaneLedger) — the UNION of every build's
        dirty rows/columns since the last consume, speculative pipeline
        builds included.  ``ledger`` is None when no cache build was
        recorded since the last take: the chain is broken (an unseen
        plane replaced the one the floors describe)."""
        self._cur_ec_ids = np.asarray(ec_ids, dtype=np.uint64)
        self._cur_uuids = list(uuids)
        self._ready = False
        if self._floor is None:
            return
        if ledger is None or ledger.broken:
            self._broken = True
            return
        if ledger.present is not None:
            # Stability: a ref row absent from ANY build since the last
            # consume may have missed a column fold; drop it from the
            # trusted set until the next refresh re-anchors it.
            present = np.zeros(len(self._ec_pos), dtype=bool)
            for e in ledger.present:
                j = self._ec_pos.get(int(e))
                if j is not None:
                    present[j] = True
            self._stable &= present
        self._pending_rows.update(ledger.rows)
        self._pending_cols.update(ledger.cols)
        # A pending set this large means churn outran the cache; give
        # up and let the next full pass re-anchor (bounded memory).
        if (len(self._pending_rows) > 4 * len(self._ec_pos)
                or len(self._pending_cols) > len(self._uuid_pos)):
            self._broken = True

    def begin_attempt(self, costs: np.ndarray, scale: int) -> bool:
        """Fold the pending deltas against the CURRENT costs and prepare
        per-round state; returns usability.  ``costs`` is the band's
        BASE cost plane (gang-forbidden rows are handled by the eff >=
        base superset argument at check time)."""
        self._ready = False
        if (self._broken or self._floor is None
                or self._cur_ec_ids is None
                or scale != self._scale):
            return False
        E = self._cur_ec_ids.shape[0]
        M = len(self._cur_uuids)
        if costs.shape != (E, M):
            return False
        cur_ref = np.asarray(
            [self._ec_pos.get(int(e), -1) for e in self._cur_ec_ids],
            dtype=np.int64,
        )
        trusted = (cur_ref >= 0) & self._stable[np.clip(cur_ref, 0, None)]
        exact_rows = np.nonzero(~trusted)[0]
        if exact_rows.size * self.ROW_FRAC_DEN > E * self.ROW_FRAC_NUM:
            return False
        col_ref = np.asarray(
            [self._uuid_pos.get(u, -1) for u in self._cur_uuids],
            dtype=np.int64,
        )
        trust_rows = np.nonzero(trusted)[0]
        pe_ref_cur = np.zeros(E, dtype=np.int64)
        pe_ref_cur[trust_rows] = self._pe_ref[cur_ref[trust_rows]]

        def col_min(cols: np.ndarray) -> np.ndarray:
            """min over trusted rows of (C*scale + pe_ref), by column."""
            if trust_rows.size == 0 or cols.size == 0:
                return np.full(cols.size, _POS64, dtype=np.int64)
            sub = costs[np.ix_(trust_rows, cols)]
            val = np.where(
                sub < INF_COST,
                sub.astype(np.int64) * scale
                + pe_ref_cur[trust_rows][:, None],
                _POS64,
            )
            return val.min(axis=0)

        # Fold pending dirty rows (trusted ones: their current cells may
        # undercut the stored floor anywhere).
        fold_rows = [
            i for i in trust_rows.tolist()
            if int(self._cur_ec_ids[i]) in self._pending_rows
        ]
        if fold_rows:
            have = np.nonzero(col_ref >= 0)[0]
            sub = costs[np.ix_(np.asarray(fold_rows, dtype=np.int64),
                               have)]
            val = np.where(
                sub < INF_COST,
                sub.astype(np.int64) * scale
                + pe_ref_cur[np.asarray(fold_rows)][:, None],
                _POS64,
            )
            np.minimum.at(self._floor, col_ref[have], val.min(axis=0))
        # Fold pending dirty columns and mint floors for new columns
        # (exact over the trusted rows — sound by construction, and a
        # returning column self-heals here).
        fold_cols = np.asarray(
            [j for j in range(M)
             if col_ref[j] < 0 or self._cur_uuids[j] in self._pending_cols],
            dtype=np.int64,
        )
        if fold_cols.size:
            fresh = col_min(fold_cols)
            minted: List[int] = []
            for k, j in enumerate(fold_cols.tolist()):
                u = self._cur_uuids[j]
                p = self._uuid_pos.get(u)
                if p is None:
                    p = self._floor.shape[0] + len(minted)
                    self._uuid_pos[u] = p
                    minted.append(int(fresh[k]))
                    col_ref[j] = p
                else:
                    self._floor[p] = min(int(self._floor[p]),
                                         int(fresh[k]))
            if minted:
                self._floor = np.concatenate(
                    [self._floor, np.asarray(minted, dtype=np.int64)]
                )
        self._pending_rows.clear()
        self._pending_cols.clear()
        self._cur_ref_row = cur_ref
        self._exact_rows = exact_rows
        self._floor_cur = self._floor[col_ref]
        self._trusted_rows = trust_rows
        self._ready = True
        return True

    # ----------------------------------------------------------------- check

    def check(self, *, eff_costs, pe, pt, supply, capacity, arc_capacity,
              scale, mask):
        """Certify the excluded columns under current prices.  Returns
        ``(status, viol_cols, worst, pm_excluded)`` with status one of
        ``"certified"`` / ``"violations"`` / ``"inconclusive"``.
        ``pm_excluded`` (int64 [M], excluded entries valid) reproduces
        the lift's potentials: ``pt`` for bound-certified columns,
        ``max(min_adm, pt - 1)`` for exactly-checked ones."""
        if not self._ready or scale != self._scale:
            return "inconclusive", None, 0, None
        E, M = eff_costs.shape
        pe64 = np.asarray(pe, dtype=np.int64)
        excluded = np.nonzero(~mask)[0]
        pm = np.full(M, int(pt), dtype=np.int64)
        pm[np.asarray(capacity, dtype=np.int64) <= 0] = 0  # inert (lift)
        if excluded.size == 0:
            return "certified", None, 0, pm
        tr = self._trusted_rows
        ex_rows = self._exact_rows
        shift = 0
        if tr.size:
            drift = self._pe_ref[self._cur_ref_row[tr]] - pe64[tr]
            shift = max(0, int(drift.max()))
            if shift > 2:
                # A handful of heavy drifters (gang-repair forbidden
                # rows whose pe collapses on the re-solve) would drag
                # the bound down for EVERY column; demote them to the
                # exact path and keep the bound tight for the rest.
                # Sound: the bound only needs to cover the rows the
                # exact pass does not, and ``floor`` is a lower bound
                # for any subset's minimum.
                keep = max(1, tr.size - max(8, tr.size // 32))
                part = np.partition(drift, keep - 1)
                cut = max(int(part[keep - 1]), 2)
                heavy = drift > cut
                if heavy.any():
                    ex_rows = np.union1d(ex_rows, tr[heavy])
                    shift = max(0, int(drift[~heavy].max()))
        bound = self._floor_cur[excluded] - shift
        if ex_rows.size:
            sub = eff_costs[np.ix_(ex_rows, excluded)]
            val = np.where(
                sub < INF_COST,
                sub.astype(np.int64) * scale + pe64[ex_rows][:, None],
                _POS64,
            )
            bound = np.minimum(bound, val.min(axis=0))
        cand = excluded[bound < pt - 1]
        if cand.size == 0:
            return "certified", None, 0, pm
        # Exact pass over the failing columns: reproduces the full
        # lift + certificate boundary (open-arc minimum vs pt - 2).
        sub = eff_costs[:, cand]
        adm = sub < INF_COST
        val = np.where(
            adm, sub.astype(np.int64) * scale + pe64[:, None], _POS64
        )
        min_adm = val.min(axis=0)
        open_ = adm & (supply.astype(np.int64)[:, None] > 0)
        open_ &= capacity.astype(np.int64)[cand][None, :] > 0
        if arc_capacity is not None:
            open_ &= arc_capacity[:, cand].astype(np.int64) > 0
        min_open = np.where(open_, val, _POS64).min(axis=0)
        dead = capacity.astype(np.int64)[cand] <= 0
        ok = dead | (min_open >= pt - 2)
        # The lift's exact potentials: max(min_adm, pt-1), pt when the
        # column has no admissible arcs, 0 when it has no sink capacity.
        pm_cand = np.maximum(min_adm, pt - 1)
        pm_cand = np.where(min_adm >= _POS64, pt, pm_cand)
        pm[cand] = np.where(dead, 0, pm_cand)
        if ok.all():
            return "certified", None, 0, pm
        viol = cand[~ok]
        worst = int((pt - 1 - min_open[~ok]).max())
        return "violations", viol, worst, pm

    # --------------------------------------------------------------- refresh

    def refresh(self, *, scale: int, pe: np.ndarray,
                min_e: np.ndarray) -> None:
        """Re-anchor from a full certification pass: ``min_e`` is the
        per-column admissible minimum of ``C*scale + pe`` over the BASE
        costs (the lift computes it anyway)."""
        if self._cur_ec_ids is None:
            return
        self._scale = int(scale)
        self._ec_pos = {
            int(e): i for i, e in enumerate(self._cur_ec_ids)
        }
        self._pe_ref = np.asarray(pe, dtype=np.int64).copy()
        self._uuid_pos = {u: j for j, u in enumerate(self._cur_uuids)}
        self._floor = np.asarray(min_e, dtype=np.int64).copy()
        self._stable = np.ones(len(self._ec_pos), dtype=bool)
        self._pending_rows.clear()
        self._pending_cols.clear()
        self._broken = False
        self._ready = False  # begin_attempt re-prepares (same round ok)
        # Prepared state for an immediate same-round re-check (gang
        # repair attempts): everything matches the frame just stored.
        E = len(self._ec_pos)
        self._cur_ref_row = np.arange(E, dtype=np.int64)
        self._exact_rows = np.zeros(0, dtype=np.int64)
        self._floor_cur = self._floor.copy()
        self._trusted_rows = np.arange(E, dtype=np.int64)
        self._ready = True


def _carry_state(prices_full, flows_full, unsched, eps):
    """Package a lifted full-plane state as a dense-path warm start:
    (int32 prices, flows, unsched, exact eps the state satisfies
    eps-complementary-slackness at).  Copies: the price-out loop keeps
    mutating its working arrays after the snapshot."""
    p = np.clip(
        np.asarray(prices_full, dtype=np.int64),
        np.iinfo(np.int32).min, np.iinfo(np.int32).max,
    ).astype(np.int32)
    return p, flows_full.copy(), np.asarray(unsched).copy(), int(eps)


def scatter_flows(sel: np.ndarray, flows_r: np.ndarray, M: int) -> np.ndarray:
    """Reduced [E, W] flows -> full [E, M] (excluded columns zero)."""
    E = flows_r.shape[0]
    flows = np.zeros((E, M), dtype=np.int32)
    flows[:, sel] = flows_r
    return flows


def lift_prices(sel: np.ndarray, prices_r: np.ndarray, *, costs: np.ndarray,
                capacity: np.ndarray, scale: int,
                with_min_e: bool = False):
    """Reduced prices -> full-plane prices, excluded columns priced by the
    conservative residual-arc lift (transport._lift_excluded_prices).
    ``with_min_e=True`` also returns the per-column admissible minimum of
    ``C*scale + pe`` the lift derives from — the certificate cache's
    refresh input (one O(E*M) pass instead of two)."""
    E, M = costs.shape
    pe = prices_r[:E]
    pt = int(prices_r[E + sel.size])
    min_e = np.where(
        costs < INF_COST,
        costs.astype(np.int64) * scale + pe.astype(np.int64)[:, None],
        _POS64,
    ).min(axis=0)
    pm = _lift_excluded_prices(
        pe, prices_r[E:E + sel.size].astype(np.int64), pt, sel,
        costs=costs, capacity=capacity, scale=scale, min_e=min_e,
    )
    prices = np.concatenate(
        [pe.astype(np.int64), pm, np.int64([pt])]
    ).astype(np.int64)
    if with_min_e:
        return prices, min_e
    return prices


def price_out_violations(
    prices_full: np.ndarray,
    *,
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    arc_capacity: Optional[np.ndarray],
    scale: int,
    mask: np.ndarray,
    top_j: int,
) -> Tuple[np.ndarray, int]:
    """Columns outside ``mask`` holding an arc with reduced cost < -1.

    Returns ``(cols_to_add, worst_violation)``: the union of each
    offending row's ``top_j`` most negative excluded columns, and the
    magnitude of the worst violation (the carried state is exactly
    eps-optimal at that epsilon once the columns join the plane, so it
    seeds the re-solve's ladder).  Empty when every excluded arc prices
    out clean — the certificate failure is then internal to the union
    and only the dense path can answer it.
    """
    E, M = costs.shape
    cols_out = np.nonzero(~mask)[0]
    if cols_out.size == 0:
        return cols_out, 0
    BIG = np.int64(1) << 60
    pe = prices_full[:E].astype(np.int64)
    pm_out = prices_full[E:E + M][cols_out].astype(np.int64)
    sub = costs[:, cols_out]
    adm = sub < INF_COST
    uem = np.minimum(supply.astype(np.int64)[:, None],
                     capacity.astype(np.int64)[cols_out][None, :])
    if arc_capacity is not None:
        uem = np.minimum(uem, arc_capacity[:, cols_out].astype(np.int64))
    open_ = adm & (uem > 0)
    rc = np.where(
        open_, sub.astype(np.int64) * scale + pe[:, None] - pm_out[None, :],
        BIG,
    )
    viol = rc < -1
    if not viol.any():
        return cols_out[:0], 0
    worst = int(-(rc[viol].min()))
    rows = np.nonzero(viol.any(axis=1))[0]
    j = min(max(1, top_j), cols_out.size)
    sub_rc = rc[rows]
    if j < cols_out.size:
        part = np.argpartition(sub_rc, j - 1, axis=1)[:, :j]
    else:
        part = np.broadcast_to(np.arange(cols_out.size),
                               (rows.size, cols_out.size))
    picked = viol[rows][np.arange(rows.size)[:, None], part]
    taken = np.zeros(cols_out.size, dtype=bool)
    taken[part[picked]] = True
    return cols_out[taken], worst


def solve_pruned(
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    unsched_cost: np.ndarray,
    *,
    arc_capacity: Optional[np.ndarray] = None,
    scale: Optional[int] = None,
    plan: Optional[ShortlistPlan] = None,
    solve_on: Callable,
    max_rounds: Optional[int] = None,
    top_j: Optional[int] = None,
    plan_kw: Optional[dict] = None,
    cert: Optional[ExcludedColumnCert] = None,
) -> Tuple[Optional[TransportSolution], Optional[np.ndarray], dict]:
    """The pruned-plane driver: shortlist -> solve -> price-out loop.

    ``solve_on(sel, warm)`` runs the caller's whole solve pipeline on the
    plane restricted to columns ``sel`` and returns ``(sol_r,
    effective_costs_r)`` — ``effective_costs_r`` is the reduced cost
    matrix the returned prices are optimal for (gang repair may have
    INF'd rows).  ``warm`` is ``None`` on the first round (the caller
    applies its own warm-start policy) and ``(prices_r, flows_r,
    unsched_r, eps_start)`` on price-out re-solves, already remapped to
    the grown ``sel``.

    Returns ``(sol, effective_costs_full, stats)``.  ``sol is None``
    means escalate to the dense path (gate declined inside ``plan``,
    reduced solve unconverged, price-out budget exhausted, or a
    certificate failure no column addition can answer); stats always
    reports what happened (``width``, ``rounds``, ``escalated``).

    Escalations after at least one CERTIFIED reduced solve also carry
    ``stats["carry"] = (prices_full, flows_full, unsched, eps)``: the
    last lifted full-plane state and the exact epsilon it satisfies
    eps-complementary-slackness at (the worst full-plane violation the
    lift measured).  The dense fallback can warm-start the full ladder
    there instead of re-paying the coarse pipeline from cold — the
    price-out work the naive pruned-wave experiment double-paid.
    """
    costs = np.asarray(costs, dtype=np.int32)
    supply = np.asarray(supply, dtype=np.int32)
    capacity = np.asarray(capacity, dtype=np.int32)
    unsched_cost = np.asarray(unsched_cost, dtype=np.int32)
    E, M = costs.shape
    stats = {"width": 0, "rounds": 0, "escalated": False,
             "declined": False, "iterations": 0, "bf_sweeps": 0,
             "cert": "off", "sel": None, "carry": None}
    if plan is None:
        plan = plan_shortlist(costs, supply, capacity, arc_capacity,
                              **(plan_kw or {}))
    if plan is None:
        stats["declined"] = True
        return None, None, stats
    if scale is None:
        scale, _ = derive_scale(costs, unsched_cost, None,
                                *padded_shape(E, M))
    max_rounds = (PRICE_OUT_MAX_ROUNDS if max_rounds is None
                  else max_rounds)
    top_j = PRICE_OUT_TOP_J if top_j is None else top_j
    # Looser than the plan gate's width cap on purpose: the initial cap
    # decides whether the reduction is worth STARTING; once reduced work
    # exists, abandoning it over a few price-out columns wastes more
    # than the extra width costs.
    grow_cap = M * 3 // 4

    mask = np.zeros(M, dtype=bool)
    mask[plan.sel] = True
    stats["width"] = int(plan.sel.size)
    warm = None
    iters = 0
    bf = 0
    for rnd in range(max_rounds + 1):
        sel = np.nonzero(mask)[0]
        stats["width"] = int(sel.size)
        sol_r, eff_r = solve_on(sel, warm)
        iters += sol_r.iterations
        bf += sol_r.bf_sweeps
        # Mirrored into stats so an ESCALATED attempt's device work can
        # still reach the caller's telemetry (the accepted path reports
        # it through the returned solution instead).
        stats["iterations"] = iters
        stats["bf_sweeps"] = bf
        # Exactly-certified reduced solves report gap_bound == 0 when
        # scale > n_r and n_r/scale otherwise (_host_finalize); both are
        # eps<=1 certificates.  Requiring literally 0.0 would make the
        # pruned path escalate EVERY band at scales where the int32
        # safety bound caps the cost scale below the node count (~40k
        # padded machines) — a silent permanent 2x solve cost.
        n_r = E + sel.size + 3
        if not (sol_r.gap_bound <= n_r / float(scale)):
            break  # unconverged / uncertified reduced solve: dense owns it
        base_r = costs[:, sel]
        forbidden = ((eff_r >= INF_COST) & (base_r < INF_COST)).any(axis=1)
        if forbidden.any():
            eff_full = costs.copy()
            eff_full[forbidden] = INF_COST
        else:
            eff_full = costs
        flows_full = scatter_flows(sel, sol_r.flows, M)
        n = E + M + 3
        pe_now = sol_r.prices[:E].astype(np.int64)
        pt_now = int(sol_r.prices[E + sel.size])

        def accept(prices_full):
            sol = TransportSolution(
                flows=flows_full,
                unsched=sol_r.unsched.copy(),
                prices=normalize_prices(prices_full),
                objective=sol_r.objective,
                gap_bound=0.0 if scale > n else n / float(scale),
                iterations=iters,
                bf_sweeps=bf,
                phase_iters=sol_r.phase_iters,
                # The (last) reduced solve's convergence curve: the
                # accepted plane's device work is that solve's.
                telemetry=sol_r.telemetry,
            )
            stats["sel"] = sel
            return sol, eff_full, stats

        # Reduced-plane certificate: the included plane is certified by
        # the reduced solve itself (the gap accept above); the excluded
        # columns go through the incremental bound + exact-candidate
        # pass — same accept boundary as the classic full-plane lift +
        # _certified_eps, without the O(E*M) work.  Inconclusive rounds
        # (stale floors, heavy churn) fall through to the full pass,
        # which re-anchors the cache for free.
        add_cols = worst = None
        if cert is not None and cert.ready:
            status, viol, worst_c, pm_exc = cert.check(
                eff_costs=eff_full, pe=pe_now, pt=pt_now, supply=supply,
                capacity=capacity, arc_capacity=arc_capacity,
                scale=scale, mask=mask,
            )
            stats["cert"] = status
            if status in ("certified", "violations"):
                pm_exc = np.clip(pm_exc, -(1 << 30) // 2, 1 << 30)
                pm_exc[sel] = sol_r.prices[E:E + sel.size].astype(np.int64)
                prices_full = np.concatenate(
                    [pe_now, pm_exc, np.int64([pt_now])]
                )
                if status == "certified":
                    return accept(prices_full)
                add_cols, worst = viol, int(worst_c)
                stats["carry"] = _carry_state(
                    prices_full, flows_full, sol_r.unsched, worst + 1
                )

        if add_cols is None:
            # Classic full-plane pass (also the cache's refresh point:
            # the lift's per-column minima are exactly the new floors).
            prices_full, min_e_eff = lift_prices(
                sel, sol_r.prices, costs=eff_full, capacity=capacity,
                scale=scale, with_min_e=True,
            )
            eps_full = _certified_eps(
                flows_full, sol_r.unsched, prices_full, costs=eff_full,
                supply=supply, capacity=capacity,
                unsched_cost=unsched_cost, scale=scale,
                arc_capacity=arc_capacity,
            )
            if eps_full > 1:
                stats["carry"] = _carry_state(
                    prices_full, flows_full, sol_r.unsched, eps_full
                )
            if eps_full <= 1:
                if cert is not None:
                    min_e_base = min_e_eff
                    if eff_full is not costs and forbidden.any():
                        # Floors must cover the BASE plane: a row the
                        # gang repair forbade re-opens next round.
                        sub = costs[forbidden]
                        val = np.where(
                            sub < INF_COST,
                            sub.astype(np.int64) * scale
                            + pe_now[forbidden][:, None],
                            _POS64,
                        )
                        min_e_base = np.minimum(
                            min_e_eff, val.min(axis=0)
                        )
                    cert.refresh(
                        scale=scale, pe=pe_now, min_e=min_e_base
                    )
                return accept(prices_full)
            if rnd == max_rounds:
                break
            add_cols, worst = price_out_violations(
                prices_full, costs=eff_full, supply=supply,
                capacity=capacity, arc_capacity=arc_capacity,
                scale=scale, mask=mask, top_j=top_j,
            )
        if rnd == max_rounds:
            break
        if add_cols.size == 0:
            break  # violation inside the union: growing columns can't help
        mask[add_cols] = True
        if int(mask.sum()) > grow_cap:
            break  # reduction no longer buying anything
        stats["rounds"] += 1
        sel_new = np.nonzero(mask)[0]
        prices_r = np.concatenate([
            prices_full[:E], prices_full[E:E + M][sel_new],
            prices_full[E + M:],
        ]).astype(np.int64)
        prices_r = np.clip(
            prices_r, np.iinfo(np.int32).min, np.iinfo(np.int32).max
        ).astype(np.int32)
        # The carried state is exactly eps-optimal at the worst included
        # violation once the added columns join the plane.
        warm = (prices_r, flows_full[:, sel_new], sol_r.unsched.copy(),
                int(worst) + 1)
    stats["escalated"] = True
    return None, None, stats

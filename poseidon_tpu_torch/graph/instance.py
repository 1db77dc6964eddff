"""RoundPlanner: one ``Schedule()`` round, state -> solve -> deltas (the
PyTorch/CUDA port of ``poseidon_tpu/graph/instance.py``).

The round pipeline (reference contract firmament_scheduler.proto:15-45,
delta vocabulary scheduling_delta.proto:24-40):

1. snapshot the schedulable world (runnable tasks, healthy machines) from
   ClusterState;
2. collapse tasks into equivalence classes -> ECTable, pack machines ->
   MachineTable (stable sort orders so warm starts carry over);
3. per size band, run the cost model -> dense [E, M] cost/capacity arrays;
4. solve the transportation problem on the device (ops/transport.py),
   warm-started from the previous round's prices and flows, or — on a
   fresh wave — from the coarse [E, 256] aggregate solve;
5. turn EC-level flows into per-task assignments, keeping each task where
   it already runs (placement stability minimizes MIGRATEs);
6. diff against previous placements -> SchedulingDeltas and commit.

The reference's default-on planner tiers run here as they do there: the
pruned-plane solve with its excluded-column certificate cache
(ops/transport_pruned.py), delta-maintained cost planes
(costmodel/delta.py), cross-band cost-build pipelining
(graph/pipeline.py) and the overlapped EC->task assignment, with the
one-program coarse start and the streaming engine's branches
(``POSEIDON_STREAMING``: the admission cut, the plane cache's ingest
hints and the cross-round speculative cost build), the opt-in chained
two-band wave (``POSEIDON_CHAINED``, ops/transport_chained.py) and the
host ``ssp`` solver, and the mesh-sharded solve
(ops/transport_sharded.py): every band's with ``solver_devices > 1``,
or, under ``POSEIDON_SHARDED_BANDS``, the wide contended bands' as the
``sharded`` tier.  The worker threads of the pipeline and the assignment
do host numpy only; every device solve runs on the calling thread.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np

from poseidon_tpu_torch.costmodel.base import CostModel, slice_ecs
from poseidon_tpu_torch.costmodel.delta import CostPlaneCache
from poseidon_tpu_torch.graph.pipeline import CostPipeline, pipelining_enabled
from poseidon_tpu_torch.graph.state import ClusterState
from poseidon_tpu_torch.obs import history as _history
from poseidon_tpu_torch.obs import profile as _profile
from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.ops import transport_pruned as tp
from poseidon_tpu_torch.ops.transport import (
    INF_COST,
    NUM_PHASES,
    TransportSolution,
    accel_policy,
    bucket_size,
    coarse_precheck,
    coarse_warm_start,
    derive_scale,
    device_call_count,
    greedy_flows,
    padded_shape,
    resolve_device,
    solve_transport_selective,
    sparse_adm_cells,
)
from poseidon_tpu_torch.ops.transport_coarse import (
    solve_transport_coarse_fused,
)
from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_int
from poseidon_tpu_torch.utils.stagetimer import stage as _stage

log = logging.getLogger("poseidon_tpu_torch.planner")


class DeltaType(enum.IntEnum):
    """SchedulingDelta.ChangeType wire values (scheduling_delta.proto:26-31)."""

    NOOP = 0
    PLACE = 1
    PREEMPT = 2
    MIGRATE = 3


@dataclass
class Delta:
    task_id: int
    resource_id: str  # machine uuid ("" for PREEMPT)
    type: DeltaType



@dataclass
class RoundMetrics:
    """Per-round observability: solve latency, placement cost, counts."""

    round_index: int = 0
    num_tasks: int = 0
    num_ecs: int = 0
    num_machines: int = 0
    solve_seconds: float = 0.0
    total_seconds: float = 0.0
    objective: int = 0
    gap_bound: float = 0.0
    iterations: int = 0
    placed: int = 0
    preempted: int = 0
    migrated: int = 0
    unscheduled: int = 0
    # Device solves this round (host-certificate answers dispatch none).
    device_calls: int = 0
    # Compile events this round (check/ledger.py counter diff): a kernel
    # build or load, or a solve key's (route, padded shape, scale) first
    # sight in the process.  A warm steady-state round must report 0.
    fresh_compiles: int = 0
    # Implicit device->host scalar syncs this round (check/ledger.py
    # implicit_transfer_count diff): ``item``/``int``/``bool``... on a
    # CUDA tensor outside transport._host_read, the sanctioned seam.
    # Must be 0.
    implicit_transfers: int = 0
    # Numeric anomalies observed in this round's solve window
    # (check/ledger.numeric_anomaly_count diff): non-finite floats or
    # int32 values riding the rails at transport._host_read, plus
    # utils.numerics saturation-certificate trips.  0 whenever
    # validation is off (POSEIDON_NUMERICS_LEDGER unset and no ledger
    # window open); must be 0 when it is on.
    numeric_anomalies: int = 0
    # Nanoseconds threads spent waiting on tracked locks during this
    # round's solve window (utils/locks.py process counter diff).
    lock_contention_ns: int = 0
    # Bellman-Ford sweeps inside the ladders' global updates.
    bf_sweeps: int = 0
    # Gang-atomicity repair firings (_forbid_partial_gangs) this round.
    repair_firings: int = 0
    # Pruned-plane solve path (ops/transport_pruned): bands solved on a
    # column shortlist, the widest shortlist used, price-out re-solve
    # rounds, escalations back to the dense path, and accepts certified
    # by the incremental excluded-column bound instead of the full-plane
    # lift + certificate pass.
    pruned_bands: int = 0
    pruned_width: int = 0
    pruned_price_out_rounds: int = 0
    pruned_escalations: int = 0
    pruned_cert_accepts: int = 0
    # Delta-maintained cost planes (costmodel/delta.py): band builds
    # served incrementally this round, and the dirty row/column slices
    # they rebuilt.
    cost_delta_hits: int = 0
    cost_rows_rebuilt: int = 0
    cost_cols_rebuilt: int = 0
    # Seconds the cross-band pipeline's speculative cost build ran
    # concurrently with a band solve (graph/pipeline.py).
    pipeline_overlap_s: float = 0.0
    # Worst (lowest) ladder entry phase across the round's band solves
    # (NUM_PHASES: every solve was answered without a device ladder).
    ladder_entry_phase: int = 0
    # Per-epsilon-phase iteration split summed across band solves.
    solve_phase_iters: list = field(default_factory=list)
    # Convergence-telemetry roll-up (POSEIDON_SOLVE_TELEMETRY;
    # ops/transport.SolveTelemetry): ring samples captured across the
    # round's band solves, global-update firings in them, and, from the
    # dominant band's curve (the one with the most samples), the
    # active-excess decay half-life and the iterations until 90% of the
    # initial active excess had drained.  All zero when telemetry is off
    # or nothing solved on the device.
    telem_samples: int = 0
    telem_gu_firings: int = 0
    telem_decay_half_life: float = 0.0
    telem_iters_to_90: int = 0
    # Mesh-sharded band tier (POSEIDON_SHARDED_BANDS): bands this round
    # served by the sharded solve, the mesh size they ran on, and the
    # max/mean per-shard work ratio read off the dominant sharded curve's
    # per-shard telemetry lanes (1.0 = balanced; 0.0 when nothing
    # sharded solved or telemetry was off).
    sharded_bands: int = 0
    shard_devices: int = 0
    shard_imbalance: float = 0.0
    # The worst band's tier: "pruned" (shortlist + full-plane
    # certificate), "dense", "sharded" (the dense plane split over the
    # device mesh), "host_greedy" (uncertified last resort),
    # or "quiet"/"none" for skipped/degenerate rounds.
    solve_tier: str = "none"
    # False when a band's solve exhausted its budget even on a cold retry.
    converged: bool = True
    # Streaming round engine (POSEIDON_STREAMING).  overlap_fraction:
    # share of this round's wall time that ran concurrently with the
    # previous round's tail (cross-round speculative cost build plus the
    # cross-band pipeline's in-solve overlap); 0.0 in the synchronous
    # loop.  admission_deferred: watcher deltas that arrived after this
    # round's admission cut and rolled to round N+1.
    # admission_staleness_s: age of the OLDEST delta admitted into this
    # round at the cut (the bounded-staleness bound actually realized).
    # placements_per_sec is stamped by schedule_round (placed / total
    # wall), in both loop modes.
    overlap_fraction: float = 0.0
    admission_deferred: int = 0
    admission_staleness_s: float = 0.0
    placements_per_sec: float = 0.0
    # Contention: band groups solved this round (one per pass of
    # _solve_banded's loop; 2 for a chained wave), EC rows whose members
    # have waited a round or more (their unscheduled cost escalated), and
    # the oldest pending task's wait in rounds.  Port-only fields: the
    # reference's wire drops them (from_dict ignores unknown keys).
    band_groups: int = 0
    escalated_ecs: int = 0
    max_wait_rounds: int = 0

    # Serialization schema version: bumped whenever a field is renamed
    # or its meaning changes (pure additions keep the version — from_dict
    # defaults missing fields and drops unknown ones).
    SCHEMA = 1

    def to_dict(self) -> dict:
        """THE round-metrics wire format: JSON-safe, schema-versioned.

        Single source of truth for every serialization of a round —
        chaos soak round records (``chaos/soak.py``), the round-history
        ring and the Prometheus exporter (``obs/metrics.observe_round``)
        all consume this dict."""
        d = asdict(self)
        if d["gap_bound"] == float("inf"):
            d["gap_bound"] = "inf"  # json has no Infinity literal
        d["schema"] = self.SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RoundMetrics":
        """Inverse of ``to_dict``; tolerant of unknown keys (forward
        compat) and missing ones (dataclass defaults apply)."""
        d = dict(d)
        schema = int(d.pop("schema", cls.SCHEMA))
        if schema > cls.SCHEMA:
            raise ValueError(
                f"RoundMetrics schema {schema} is newer than supported "
                f"({cls.SCHEMA})"
            )
        if d.get("gap_bound") == "inf":
            d["gap_bound"] = float("inf")
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class _WarmState:
    ec_ids: List[int] = field(default_factory=list)
    machine_uuids: List[str] = field(default_factory=list)
    prices: Optional[np.ndarray] = None
    flows: Optional[np.ndarray] = None
    unsched: Optional[np.ndarray] = None
    # Last round's raw cost matrix + unscheduled-cost vector (post-remap
    # reference frame): the incremental epsilon heuristic reads the
    # per-arc cost drift off them.
    costs: Optional[np.ndarray] = None
    unsched_cost: Optional[np.ndarray] = None


def _remap_warm_state(w: _WarmState, ec_ids: List[int],
                      machine_uuids: List[str]):
    """Carry one band's prices/flows/costs from the previous round into
    this round's index space (ECs/machines may have churned).

    Returns ``(prices, flows, unsched, prev_costs, prev_unsched_cost,
    full_overlap)``; ``prev_costs``/``prev_unsched_cost`` cells with no
    predecessor are -1, and ``full_overlap`` is True iff every current EC
    and machine existed last round (the precondition for the incremental
    epsilon start).
    """
    if w.prices is None:
        return None, None, None, None, None, False
    E, M = len(ec_ids), len(machine_uuids)
    prev_e = {e: i for i, e in enumerate(w.ec_ids)}
    prev_m = {u: i for i, u in enumerate(w.machine_uuids)}
    prices = np.zeros(E + M + 1, dtype=np.int32)
    prices[E + M] = w.prices[len(w.ec_ids) + len(w.machine_uuids)]
    flows = np.zeros((E, M), dtype=np.int32)
    unsched = np.zeros(E, dtype=np.int32)
    prev_costs = np.full((E, M), -1, dtype=np.int64)
    prev_unsched_cost = np.full(E, -1, dtype=np.int64)
    # Vectorized gather of the surviving rows/columns (this runs every
    # round; a Python E*M loop would dwarf the solve at scale).
    e_idx = np.array([prev_e.get(e, -1) for e in ec_ids], dtype=np.int64)
    m_idx = np.array(
        [prev_m.get(u, -1) for u in machine_uuids], dtype=np.int64
    )
    ke_new = np.nonzero(e_idx >= 0)[0]
    km_new = np.nonzero(m_idx >= 0)[0]
    ke_old = e_idx[ke_new]
    km_old = m_idx[km_new]
    prices[ke_new] = w.prices[ke_old]
    prices[E + km_new] = w.prices[len(w.ec_ids) + km_old]
    if w.unsched is not None:
        unsched[ke_new] = w.unsched[ke_old]
    if w.flows is not None and ke_new.size and km_new.size:
        flows[np.ix_(ke_new, km_new)] = w.flows[np.ix_(ke_old, km_old)]
    if w.costs is not None and ke_new.size and km_new.size:
        prev_costs[np.ix_(ke_new, km_new)] = w.costs[np.ix_(ke_old, km_old)]
    if w.unsched_cost is not None and ke_new.size:
        prev_unsched_cost[ke_new] = w.unsched_cost[ke_old]
    full_overlap = ke_new.size == E and km_new.size == M
    return prices, flows, unsched, prev_costs, prev_unsched_cost, full_overlap

def _column_caps(ecs_b, cm, mt, committed_cpu, committed_ram,
                 committed_net):
    """Resource-safe column capacity (min over dimensions), with a
    PER-COLUMN denominator: the largest request among rows actually
    admissible on that column (selectors + fit, read off the cost
    model's INF mask).  Sound — every unit a feasible flow puts on the
    column consumes at most that denominator, so units <= free // denom
    keeps the column within capacity — and strictly tighter than the
    band-global max, which strands small machines whenever a large task
    exists ANYWHERE in the band (a selector-pinned 2.8-core task on a
    4-core node was starved by an 11.2-core task bound elsewhere: the
    reference e2e resource-limits predicate,
    poseidon_integration.go:294-407).  One definition shared by the
    per-band loop (and, in the reference, its chained wave path)."""
    adm = cm.costs < INF_COST                      # [E_b, M]
    M = adm.shape[1]
    # Sparse-admissibility rounds (each EC pinned to a few machines):
    # the per-column max over a near-empty plane is a scatter-max over
    # the admissible cells, not three full [E, M] passes.
    cells = sparse_adm_cells(adm)

    def col_denom(req) -> np.ndarray:
        if cells is not None:
            denom = np.zeros(M, dtype=np.int64)
            np.maximum.at(denom, cells[1], req.astype(np.int64)[cells[0]])
            return denom
        return np.where(adm, req.astype(np.int64)[:, None], 0).max(axis=0)

    col_cap = cm.capacity.astype(np.int64)
    for req, cap_arr, used in (
        (ecs_b.cpu_request, mt.cpu_capacity, committed_cpu),
        (ecs_b.ram_request, mt.ram_capacity, committed_ram),
    ):
        denom = col_denom(req)                      # [M]
        free = np.maximum(cap_arr.astype(np.int64) - used, 0)
        col_cap = np.where(
            denom > 0,
            np.minimum(col_cap, free // np.maximum(denom, 1)),
            col_cap,
        )
    net_req = ecs_b.net_rx()
    if mt.net_rx_capacity is not None:
        raw = mt.net_rx_capacity.astype(np.int64)
        denom = col_denom(net_req)
        free = np.maximum(raw - committed_net, 0)
        col_cap = np.where(
            (raw > 0) & (denom > 0),
            np.minimum(col_cap, free // np.maximum(denom, 1)),
            col_cap,
        )
    return np.clip(col_cap, 0, None).astype(np.int32), net_req
_ASSIGN_POOL = None


def _shared_assign_pool():
    """One process-wide single-worker pool for assignment pipelining.

    A single worker keeps chunk execution strictly serialized (overlap
    with the device, never with another chunk); the chunks are host
    numpy only, so no CUDA call leaves the main thread."""
    global _ASSIGN_POOL
    if _ASSIGN_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _ASSIGN_POOL = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="poseidon-assign"
        )
    return _ASSIGN_POOL


def _with_usage(mt, cpu_used, ram_used, net_used, slots_free):
    """MachineTable with this band's committed-resource view.

    The observed-load arrays (knowledge-base usage EMAs) must advance by
    the same intra-round commitment delta as the reservations, or later
    bands would price machines at their pre-round load whenever usage
    history exists."""
    from dataclasses import replace

    kw = {}
    if mt.cpu_obs_used is not None:
        kw["cpu_obs_used"] = mt.cpu_obs_used + (cpu_used - mt.cpu_used)
    if mt.ram_obs_used is not None:
        kw["ram_obs_used"] = mt.ram_obs_used + (ram_used - mt.ram_used)
    return replace(
        mt, cpu_used=cpu_used, ram_used=ram_used,
        net_rx_used=net_used, slots_free=slots_free, **kw,
    )


class RoundPlanner:
    """Owns the solve path; one instance per service process."""

    # Size-band ladder: rows whose dominant resource fraction falls within
    # one factor-of-BAND_BASE band solve together; bands go largest-first.
    BAND_BASE = 8.0
    NUM_BANDS = 8

    def __init__(
        self,
        state: ClusterState,
        cost_model: CostModel,
        *,
        preemption: bool = True,
        incremental: bool = True,
        reschedule_running: bool = False,
        gang_scheduling: bool = True,
        pod_affinity: bool = True,
        global_update_every: int = 4,
        flow_solver: str = "auction",
        solver_devices: int = 1,
        device=None,
    ) -> None:
        if global_update_every < 1:
            raise ValueError(
                f"global_update_every must be >= 1, got {global_update_every}"
            )
        # flow_solver: "auction" = the device cost-scaling push-relabel
        # ladder; "ssp" = the host network-simplex verification solver
        # (exact, slow, no device; solver/oracle.py).
        if flow_solver not in ("auction", "ssp"):
            raise ValueError(f"unknown flow_solver {flow_solver!r}")
        self.flow_solver = flow_solver
        # solver_devices > 1: every band solves on a machine-axis mesh
        # (ops/transport_sharded.py), built on first use.
        self.solver_devices = solver_devices
        self._mesh = None
        self.state = state
        self.cost_model = cost_model
        self.preemption = preemption
        self.gang_scheduling = gang_scheduling
        self.pod_affinity = pod_affinity
        self.global_update_every = global_update_every
        # RUNNING tasks hold reservations and stay put unless
        # reschedule_running re-enters the whole workload every round.
        self.reschedule_running = reschedule_running
        # Quiet rounds skip the solve outright; low-churn rounds start the
        # epsilon ladder at the observed cost drift.
        self.incremental = incremental
        # The solve's device: CUDA unless the caller asks for the CPU.
        self.device = resolve_device(device)
        # Warm-start frames, one per size band (see _solve_banded).
        self._warm_bands: Dict[int, _WarmState] = {}
        # Delta-maintained cost planes (costmodel/delta.py): per-band
        # [E, M] planes patched from the round's dirty rows/columns, the
        # model's full build kept as the oracle.
        self._plane_cache = CostPlaneCache(cost_model)
        # Cross-band pipeline (graph/pipeline.py), built on first use.
        self._cost_pipeline = None
        # Last build's delta stats for the band being solved (read by
        # the shortlist revival).
        self._last_build_stats: dict = self._plane_cache.last_stats
        # Reduced-plane certificate caches and accepted shortlists, per
        # band (the shortlist as machine uuids, so column churn remaps).
        self._cert_bands: Dict[int, tp.ExcludedColumnCert] = {}
        self._shortlist_bands: Dict[int, Tuple[List[str], int]] = {}
        # Per-round resubmission-affinity hint: per-EC arrays of prior
        # machine columns for pending members (None when nothing matched).
        self._round_prior: Optional[List[np.ndarray]] = None
        self._last_generation = -1
        self._last_unscheduled = 1  # force a solve on the first round
        self.last_metrics = RoundMetrics()
        # Per-round solve accumulators (reset in _solve_banded).
        self._hidden_iters = 0
        self._hidden_bf = 0
        self._repair_firings = 0
        self._pruned_bands = 0
        self._pruned_width = 0
        self._pruned_rounds = 0
        self._pruned_escalations = 0
        self._cert_accepts = 0
        self._cost_delta_hits = 0
        self._cost_rows_rebuilt = 0
        self._cost_cols_rebuilt = 0
        self._pipeline_overlap = 0.0
        self._tier_rank = -1
        # Sharded band tier (POSEIDON_SHARDED_BANDS): bands the mesh-split
        # solve served this round, the mesh size they ran on, and the
        # lazily built tier mesh (None = not yet probed; False = probed,
        # fewer than 2 devices visible).  Distinct from self._mesh, which
        # backs the solver_devices > 1 all-bands configuration.
        self._sharded_bands = 0
        self._shard_devices = 0
        self._tier_mesh = None
        # Submission time of the cross-ROUND speculation (streaming round
        # engine): set when this round, on its way out, speculates the
        # next round's first cost build on frozen final usage.  None when
        # no cross-round spec was submitted this round.  The next round
        # harvests the spec's realized run time into _cross_overlap_prev
        # at its admission cut.
        self._cross_spec_t = None
        self._cross_overlap_prev = 0.0
        # Per-band convergence curves ((band, SolveTelemetry) pairs)
        # collected this round, and their JSON-safe digests.
        self._telem_curves: list = []
        self.last_solve_curves: list = []
        # Chaos seam (chaos/): when set, an object whose
        # ``solver_fault() -> (force_uncertified, partial_fraction)`` is
        # consulted per band — forcing the degraded host-greedy tier
        # (certificate-failure injection) and/or capping the fraction of
        # supply placed (partial-Schedule-response injection).  None in
        # production; the solve path itself is unchanged when unset.
        self.chaos = None

    def set_cost_model(self, cost_model) -> None:
        """Swap the cost model before a drive's first round.  Rebuilds the
        delta-plane cache and drops certificate/shortlist reuse (every
        cached cell priced by the old model is invalid under the new
        one); warm solver frames survive."""
        self.cost_model = cost_model
        self._plane_cache = CostPlaneCache(cost_model)
        self._cost_pipeline = None
        self._last_build_stats = self._plane_cache.last_stats
        self._cert_bands = {}
        self._shortlist_bands = {}

    # ------------------------------------------------------------- warm frames

    def export_warm_state(self) -> dict:
        """Serialize per-band warm frames (prices/flows/costs) to a flat
        {key: np.ndarray} dict (npz-compatible).

        A restarted service that restores these solves its first round
        WARM: with an unchanged pending backlog the drift epsilon is the
        scale floor and the solve certifies in near-zero iterations,
        instead of re-paying the cold ladder on the whole backlog.
        """
        out: dict = {}
        for band, w in self._warm_bands.items():
            if w.prices is None:
                continue
            p = f"b{band}."
            out[p + "ec_ids"] = np.asarray(w.ec_ids, dtype=np.int64)
            out[p + "machine_uuids"] = np.asarray(w.machine_uuids)
            out[p + "prices"] = w.prices
            out[p + "flows"] = w.flows
            out[p + "unsched"] = w.unsched
            out[p + "costs"] = w.costs
            out[p + "unsched_cost"] = w.unsched_cost
        return out

    def import_warm_state(self, frames: dict) -> int:
        """Restore frames exported by ``export_warm_state``; returns the
        number of bands restored."""
        bands: Dict[int, _WarmState] = {}
        for key in frames:
            if not key.endswith(".prices"):
                continue
            band = int(key.split(".", 1)[0][1:])
            p = f"b{band}."
            bands[band] = _WarmState(
                ec_ids=[int(e) for e in frames[p + "ec_ids"]],
                machine_uuids=[str(u) for u in frames[p + "machine_uuids"]],
                prices=np.asarray(frames[p + "prices"], dtype=np.int32),
                flows=np.asarray(frames[p + "flows"], dtype=np.int32),
                unsched=np.asarray(frames[p + "unsched"], dtype=np.int32),
                costs=np.asarray(frames[p + "costs"], dtype=np.int64),
                unsched_cost=np.asarray(
                    frames[p + "unsched_cost"], dtype=np.int64
                ),
            )
        self._warm_bands.update(bands)
        return len(bands)

    # ---------------------------------------------------------------- solving

    def _dispatch_solve(self, costs, supply, capacity, unsched_cost,
                        prices=None, sharded_mesh=None, **kw):
        """The one solver dispatch (rounds and precompile): the host ssp
        oracle, the mesh-sharded solve, or the selective (column-reduced)
        wrapper, which falls through to the full solve when the reduction
        would not shrink the instance or does not certify.
        ``sharded_mesh`` routes a single band through the sharded solve
        (the sharded tier's gate passes its mesh here)."""
        if self.flow_solver == "ssp":
            from poseidon_tpu_torch.solver.oracle import transport_solve

            obj, flows, unsched = transport_solve(
                costs, supply, capacity, unsched_cost,
                arc_capacity=kw.get("arc_capacity"),
            )
            E_b, M_b = np.asarray(costs).shape
            return TransportSolution(
                flows=flows, unsched=unsched,
                prices=np.zeros(E_b + M_b + 1, dtype=np.int32),
                objective=obj, gap_bound=0.0, iterations=0,
            )
        kw.setdefault("global_update_every", self.global_update_every)
        if self.solver_devices > 1 or sharded_mesh is not None:
            from poseidon_tpu_torch.ops import transport_sharded as TS

            mesh = sharded_mesh
            if mesh is None:
                if self._mesh is None:
                    self._mesh = TS.make_solver_mesh(self.solver_devices,
                                                     device=self.device)
                mesh = self._mesh
            return TS.solve_transport_sharded(
                costs, supply, capacity, unsched_cost, prices, mesh=mesh,
                **kw)
        return solve_transport_selective(
            costs, supply, capacity, unsched_cost, prices,
            device=self.device, **kw
        )

    def precompile(self, max_ecs: int = 256,
                   max_machines: int = 0) -> int:
        """Run the solve ladder ahead of traffic.

        One synthetic solve per EC-row bucket (8, 16, ... up to
        ``max_ecs``) at the machine-count bucket of the CURRENT cluster —
        plus, when ``max_machines`` exceeds it, at that expected-growth
        bucket too — covering every solve key (route, padded shape and
        scale) churn rounds can produce: the selective path's reduced
        widths at the full bucket's scale, the coarse start's [E, 256]
        width, and, where the one-program coarse solve is on, its probe
        at the full width and at the pruned tier's reduced widths.  So
        every route's first launch (the kernels' load included) and
        every key's first sight happen before traffic, and the compile
        ledger's warm-round budget of 0 is unambiguous.  The scale
        matches production because both derive from the cost model's
        static bound (``max_cost_hint``).  Returns the number of solve
        keys the probes reached.
        """
        from poseidon_tpu_torch.check.ledger import capture_solve_keys
        from poseidon_tpu_torch.ops import transport_coarse
        from poseidon_tpu_torch.ops.transport import (
            COARSE_MIN_MACHINES,
            coarse_group_count,
            solve_transport,
        )
        if self.flow_solver == "ssp":
            return 0  # the host oracle has nothing to run ahead
        m_now = len(self.state.machines)
        m_buckets = sorted({
            bucket_size(m) for m in (m_now, max_machines) if m > 0
        })
        hint = self.cost_model.max_cost()
        rng = np.random.default_rng(0)
        e_cap, _ = padded_shape(max(max_ecs, 1), 1)
        probe_costs = np.full((1, 1), hint, dtype=np.int32)
        probe_unsched = np.full(1, hint, dtype=np.int32)
        dev = self.device
        with capture_solve_keys() as keys:
            for m_bucket in m_buckets:
                e_bucket = 8
                while e_bucket <= e_cap:
                    # The selective (column-reduced) path solves sparse
                    # rounds at power-of-four widths below the full
                    # bucket, at the full bucket's scale (the scale
                    # depends on both padded axes): probe those keys too.
                    widths = [(m_bucket, None)]
                    scale_full, _ = derive_scale(
                        probe_costs, probe_unsched, hint,
                        *padded_shape(e_bucket, m_bucket),
                    )
                    w = 128
                    while w * 4 < m_bucket * 3:
                        widths.append((w, scale_full))
                        w *= 4
                    if (m_bucket >= COARSE_MIN_MACHINES
                            and coarse_group_count(m_bucket) == 256):
                        # The coarse wave warm start solves [E, 256] at
                        # the full bucket's scale.
                        widths.append((256, scale_full))
                    if (m_bucket >= COARSE_MIN_MACHINES
                            and self.solver_devices == 1
                            and accel_policy("POSEIDON_COARSE_FUSED", dev)):
                        # The one-program coarse solve: the full width
                        # (scale derived in force mode, as production's
                        # dense planes do) plus the pinned-scale reduced
                        # widths the wave-shaped prune gate opens (the
                        # covering union targets 2x supply, landing at
                        # <= half width).
                        probe_widths = [(m_bucket, None)]
                        if (e_bucket <= 64
                                and m_bucket >= tp.PRUNE_WAVE_MIN_COLS
                                and tp.row_gate_ok(e_bucket, m_bucket,
                                                   1 << 30)):
                            probe_widths += [
                                (w, scale_full)
                                for w in sorted({m_bucket // 4,
                                                 m_bucket // 2})
                                if w >= COARSE_MIN_MACHINES
                            ]
                        for width, pinned in probe_widths:
                            probe_c = rng.integers(
                                0, hint + 1, size=(e_bucket, width)
                            ).astype(np.int32)
                            transport_coarse.solve_transport_coarse_fused(
                                probe_c, np.ones(e_bucket, dtype=np.int32),
                                np.ones(width, dtype=np.int32),
                                np.full(e_bucket, hint, dtype=np.int32),
                                arc_capacity=np.ones(
                                    (e_bucket, width), dtype=np.int32
                                ),
                                max_cost_hint=hint, max_iter_total=8192,
                                force=True, scale=pinned, device=dev,
                            )
                    for width, scale in widths:
                        costs = rng.integers(
                            0, hint + 1, size=(e_bucket, width)
                        ).astype(np.int32)
                        probe = (
                            costs, np.ones(e_bucket, dtype=np.int32),
                            np.ones(width, dtype=np.int32),
                            np.full(e_bucket, hint, dtype=np.int32),
                        )
                        # greedy_init is off for every probe: an easy
                        # probe whose greedy start certifies exactly is
                        # answered on the host with no device solve,
                        # skipping the very key this loop exists for.
                        kw = dict(
                            arc_capacity=np.ones((e_bucket, width),
                                                 dtype=np.int32),
                            max_cost_hint=hint, greedy_init=False,
                            **({} if scale is None else {"scale": scale}),
                        )
                        if self.solver_devices > 1 and (
                            scale is None
                            or width == coarse_group_count(m_bucket)
                        ):
                            # The shapes the sharded dispatch sees (the
                            # full bucket and the coarse width): it never
                            # reduces, so no selective width occurs.
                            self._dispatch_solve(*probe, **kw)
                            continue
                        solve_transport(*probe, device=dev, **kw)
                        tier_mesh = (None if scale is not None
                                     else self._sharded_band_mesh(width))
                        if tier_mesh is not None:
                            # The sharded tier solves the same full
                            # bucket on the mesh: its own solve key.
                            # Both tiers stay reachable (the gate can
                            # decline), so both keys are probed.
                            self._dispatch_solve(*probe,
                                                 sharded_mesh=tier_mesh,
                                                 **kw)
                    e_bucket *= 2
        return len(keys)

    # ------------------------------------------------------------------ round

    def schedule_round(self) -> Tuple[List[Delta], RoundMetrics]:
        """One round under a ``round`` tracer span: the span parents the
        stage spans opened beneath it (``round.view_build`` ...
        ``round.assign``, the ``solve.*`` stages) and carries the
        round's headline attributes, so an exported Perfetto timeline
        decomposes the round without consulting the metrics stream."""
        with _trace.span("round") as sp:
            deltas, metrics = self._schedule_round()
            # Stamped here, so the figure rides the wire identically
            # whatever drove the round.
            if metrics.total_seconds > 0:
                metrics.placements_per_sec = round(
                    metrics.placed / metrics.total_seconds, 3
                )
            sp.set(
                round=metrics.round_index,
                solve_tier=metrics.solve_tier,
                tasks=metrics.num_tasks,
                ecs=metrics.num_ecs,
                machines=metrics.num_machines,
                placed=metrics.placed,
                unscheduled=metrics.unscheduled,
                iterations=metrics.iterations,
                device_calls=metrics.device_calls,
                fresh_compiles=metrics.fresh_compiles,
                implicit_transfers=metrics.implicit_transfers,
                numeric_anomalies=metrics.numeric_anomalies,
                repair_firings=metrics.repair_firings,
                pruned_bands=metrics.pruned_bands,
                pruned_width=metrics.pruned_width,
                pruned_price_out_rounds=metrics.pruned_price_out_rounds,
                pruned_escalations=metrics.pruned_escalations,
                pruned_cert_accepts=metrics.pruned_cert_accepts,
                ladder_entry_phase=metrics.ladder_entry_phase,
                cost_delta_hits=metrics.cost_delta_hits,
                cost_rows_rebuilt=metrics.cost_rows_rebuilt,
                cost_cols_rebuilt=metrics.cost_cols_rebuilt,
                pipeline_overlap_s=metrics.pipeline_overlap_s,
                telem_samples=metrics.telem_samples,
                telem_iters_to_90=metrics.telem_iters_to_90,
                converged=metrics.converged,
            )
        # Round-history ring (/debug/rounds): every completed round lands
        # here, so a live process is interrogable.
        _history.default_history().record(
            metrics.to_dict(), curves=self.last_solve_curves
        )
        return deltas, metrics

    def _schedule_round(self) -> Tuple[List[Delta], RoundMetrics]:
        t0 = time.perf_counter()
        st = self.state
        # Rounds that never reach _solve_banded carry no convergence
        # curves: a previous round's must not pass for theirs.
        self.last_solve_curves = []

        # Quiet-round fast path: no mutation since the last committed
        # result and nothing left unscheduled => the previous optimum
        # stands and stability yields zero deltas.
        if (
            self.incremental
            and st.generation == self._last_generation
            and self._last_unscheduled == 0
        ):
            m = self.last_metrics
            metrics = RoundMetrics(
                round_index=st.round_index, num_tasks=m.num_tasks,
                num_ecs=m.num_ecs, num_machines=m.num_machines,
                objective=m.objective, gap_bound=m.gap_bound,
                converged=m.converged, solve_tier="quiet",
                ladder_entry_phase=NUM_PHASES,
            )
            st.round_index += 1
            metrics.total_seconds = time.perf_counter() - t0
            self.last_metrics = metrics
            return [], metrics

        with _stage("round.view_build"):
            view = st.build_round_view(
                include_running=self.reschedule_running
            )
        # Admission cut (the streaming bounded-staleness batcher): the
        # view snapshot IS the round's input set — everything that
        # arrived before it is admitted, later arrivals roll to round
        # N+1 (counted as admission_deferred at round end).  The dirty
        # hints ride to the plane cache's continuous-ingest seam only
        # under streaming; the synchronous loop discards them so its
        # delta-rebuild accounting stays exactly as before.
        streaming = hatch_bool("POSEIDON_STREAMING")
        _admitted, adm_stale = st.admission_cut()
        ing_rows, ing_cols = st.take_ingest_hints()
        # The synchronous loop installs an empty set all the same, so
        # every round takes the cache's ingest lock under its caller's
        # locks from round 0 on: the first warm delta build, which reads
        # the hints, then takes no new lock order (ROADMAP §C).
        self._plane_cache.set_round_hints(
            ing_rows if streaming else (), ing_cols if streaming else ()
        )
        # Harvest the PREVIOUS round's cross-round speculation: every
        # second its build ran after submission — the previous round's
        # own tail, the glue side's enactment, RPC transit — is work
        # THIS round would otherwise pay inside its own wall time, so
        # it is credited here as realized cross-round overlap.
        self._cross_overlap_prev = 0.0
        if (streaming and self._cross_spec_t is not None
                and self._cost_pipeline is not None):
            self._cross_overlap_prev = self._cost_pipeline.overlap_with(
                self._cross_spec_t, time.perf_counter()
            )
        ecs, mt = view.ecs, view.machines
        if not self.pod_affinity:
            ecs.pod_affinity = None
            ecs.pod_anti_affinity = None
        metrics = RoundMetrics(
            round_index=st.round_index,
            num_tasks=int(ecs.supply.sum()),
            num_machines=mt.num_machines,
        )
        metrics.admission_staleness_s = round(adm_stale, 6)
        waits = ecs.max_wait_rounds
        metrics.escalated_ecs = int((waits > 0).sum())
        metrics.max_wait_rounds = int(waits.max(initial=0))
        if ecs.num_ecs == 0:
            st.round_index += 1
            self._last_generation = st.generation
            self._last_unscheduled = 0
            # Nothing solved: the standing placement's certificate carries.
            metrics.gap_bound = self.last_metrics.gap_bound
            metrics.converged = self.last_metrics.converged
            metrics.total_seconds = time.perf_counter() - t0
            self.last_metrics = metrics
            return [], metrics

        metrics.num_ecs = ecs.num_ecs
        with _stage("round.collect_prior"):
            self._collect_prior(view, mt)

        t_solve = time.perf_counter()
        from poseidon_tpu_torch.check.ledger import (
            fresh_compile_count,
            implicit_transfer_count,
            numeric_anomaly_count,
        )
        from poseidon_tpu_torch.utils.locks import lock_contention_ns

        calls0 = device_call_count()
        fresh0 = fresh_compile_count()
        transfers0 = implicit_transfer_count()
        anomalies0 = numeric_anomaly_count()
        contention0 = lock_contention_ns()
        # Assignment pipelining: a finished band's EC->task assignment
        # (host numpy) runs on a worker thread while the next band's
        # solve occupies the device.  The last band's chunk is deferred
        # to the assign phase below, after a join, so chunks never run
        # concurrently; chunks merge in band order, identical to the
        # POSEIDON_OVERLAP_ASSIGN=0 path.
        chunks: dict = {}
        futures: list = []
        deferred: list = []
        pool = None
        if hatch_bool("POSEIDON_OVERLAP_ASSIGN"):
            pool = _shared_assign_pool()

        def on_band(idx, is_last, flows_full):
            order = len(chunks)
            chunks[order] = None

            def work():
                chunks[order] = self._assign_ecs(
                    idx.tolist(), flows_full, view, metrics
                )

            if pool is not None and not is_last:
                futures.append(pool.submit(work))
            else:
                deferred.append(work)

        def on_band_reset():
            # A speculative chunk (the chained path's early band-1
            # assignment) whose round DECLINED must be discarded before
            # the per-band path re-assigns the same ECs — duplicate
            # chunks would double every delta.  Metrics counted by the
            # discarded chunk are rolled back by re-zeroing the fields
            # _assign_ecs accumulates.
            for f in futures:
                try:
                    f.result()
                except Exception:  # noqa: BLE001
                    pass
            futures.clear()
            deferred.clear()
            chunks.clear()
            metrics.placed = metrics.preempted = metrics.migrated = 0
            metrics.unscheduled = 0

        try:
            # Hatch-gated torch.profiler capture around the solve window
            # (POSEIDON_JAX_PROFILE=<dir>); the artifact path lands on
            # the round span.
            with _profile.solve_profile(metrics.round_index) as ppath:
                flows = self._solve_banded(
                    ecs, mt, metrics, on_band=on_band,
                    on_band_reset=on_band_reset,
                )
            if ppath is not None:
                _trace.current().set(profile_path=ppath)
        except BaseException:
            # A failed solve must not leave a worker chunk mutating shared
            # state for a round that never commits: join, then propagate.
            for f in futures:
                try:
                    f.result()
                except Exception:  # noqa: BLE001 - the solve's error wins
                    pass
            raise
        metrics.device_calls = device_call_count() - calls0
        metrics.fresh_compiles = fresh_compile_count() - fresh0
        metrics.implicit_transfers = implicit_transfer_count() - transfers0
        metrics.numeric_anomalies = numeric_anomaly_count() - anomalies0
        metrics.lock_contention_ns = lock_contention_ns() - contention0
        metrics.solve_seconds = time.perf_counter() - t_solve
        if metrics.gap_bound == float("inf"):
            metrics.converged = False
            log.error(
                "schedule round %d did not converge: E=%d M=%d tasks=%d "
                "(placements are repaired-feasible, optimality uncertified)",
                metrics.round_index, metrics.num_ecs, metrics.num_machines,
                metrics.num_tasks,
            )

        with _stage("round.assign"):
            if chunks:
                # Join the worker, run the deferred last chunk, merge in
                # band order, commit once.
                for f in futures:
                    f.result()
                for work in deferred:
                    work()
                deltas = []
                placements: list = []
                for k in sorted(chunks):
                    d, p, hints = chunks[k]
                    deltas.extend(d)
                    placements.extend(p)
                    self._apply_hint_reinserts(hints)
                st.apply_placements(placements)
            else:
                # Degenerate path that skipped every band (M == 0).
                deltas = self._assign(flows, view, metrics)
        st.round_index += 1
        self._last_generation = st.generation
        # Any task left off a machine moves the starvation escalator next
        # round, so the quiet-round fast path must not trigger.
        self._last_unscheduled = metrics.unscheduled + metrics.preempted
        # Arrivals that landed after this round's admission cut: they
        # are round N+1's input set (the bounded-staleness batcher's
        # deferred side).
        metrics.admission_deferred = st.pending_ingest()
        metrics.total_seconds = time.perf_counter() - t0
        # Realized round overlap: the cross-band pipeline's in-solve
        # concurrency plus the previous round's cross-round speculation
        # harvested at this round's start.  A fraction of the round's
        # wall — 0.0 in the fully synchronous configuration.
        overlap = self._pipeline_overlap + self._cross_overlap_prev
        if metrics.total_seconds > 0 and overlap > 0:
            metrics.overlap_fraction = round(
                min(1.0, overlap / metrics.total_seconds), 6
            )
        self.last_metrics = metrics
        return deltas, metrics

    def _collect_prior(self, view, mt) -> None:
        """Resubmission affinity: map each pending member's PRIOR machine
        (recorded by ClusterState.task_removed) to this round's machine
        column, for the ASSIGNMENT pass only — a resubmitted task whose
        prior machine still receives flow goes back there (image/data
        locality), at zero solver cost.  (Seeding the SOLVE from prior
        placements was measured net-harmful: load-shaped costs move
        between rounds, so the prior assignment certifies worse than a
        fresh greedy — 217-300 iterations vs 0 at 1k/10k churn.)
        Entries are consumed (popped) only when their machine column
        RESOLVES in this round's view; a hint whose machine is absent
        stays for a later round (the FIFO cap bounds growth), and the
        assignment pass re-inserts hints for members that end the round
        still unplaced — a churned task that misses placement in the
        following round must not permanently lose its locality."""
        self._round_prior = None
        prior = self.state.prior_machine
        if not (self.incremental and prior):
            return
        col_of = {u: j for j, u in enumerate(mt.uuids)}
        per_ec: List[np.ndarray] = []
        found = 0
        # Mutating the state's hint dict follows the class's locking
        # discipline (task_removed writes it under the same lock).
        with self.state._lock:
            keys = None  # built lazily: only the big-EC prefilter needs it
            for i in range(view.ecs.num_ecs):
                uids = view.member_uids[i]
                cur = view.member_cur[i]
                cols = np.full(uids.size, -1, dtype=np.int64)
                per_ec.append(cols)
                if not prior:
                    continue  # drained: remaining ECs cannot match
                cand = np.nonzero(cur < 0)[0]  # pending members only
                if cand.size > 64:
                    # Vectorized prefilter: the Python pop loop below
                    # must touch only actual hits, not a whole wave of
                    # fresh uids (the hint dict can hold a megabyte of
                    # dead entries a wave never matches).  Sorted keys +
                    # searchsorted, NOT np.isin: isin re-sorts its
                    # needle set on every call (100 ECs x one sort of a
                    # 100k-entry hint dict per 10k fresh wave).
                    if keys is None:
                        keys = np.sort(np.fromiter(
                            prior.keys(), dtype=np.uint64,
                            count=len(prior),
                        ))
                    probe = uids[cand].astype(np.uint64, copy=False)
                    pos = np.searchsorted(keys, probe)
                    pos[pos == keys.size] = 0  # any in-range slot;
                    # the equality check below rejects non-matches.
                    cand = cand[keys[pos] == probe]
                for j in cand.tolist():
                    uid = int(uids[j])
                    m = prior.get(uid)
                    if m is None:
                        continue
                    c = col_of.get(m, -1)
                    if c >= 0:
                        prior.pop(uid)
                        cols[j] = c
                        found += 1
        if found:
            self._round_prior = per_ec

    # Size-band ladder: rows whose dominant resource fraction falls within
    # one factor-of-BAND_BASE band solve together; bands go largest-first.
    # Measured sweep (mixed-size workloads, uncontended AND 1.5x
    # oversubscribed): base 8 matches base 4's objective when capacity is
    # plentiful and strictly beats it under contention (fewer bands means
    # small tasks share a solve with big ones and pack the gaps the
    # per-band capacity denominator would otherwise strand), with fewer
    # solve shapes; base 16 collapses everything into one band and
    # strands capacity behind the largest request's denominator.
    BAND_BASE = 8.0
    NUM_BANDS = 8

    def _band_of_rows(self, ecs, mt) -> np.ndarray:
        """Band index per EC row from the dominant request/capacity
        fraction (0 = largest tasks)."""
        cap_cpu = float(max(int(mt.cpu_capacity.max(initial=1)), 1))
        cap_ram = float(max(int(mt.ram_capacity.max(initial=1)), 1))
        frac = np.maximum(
            ecs.cpu_request.astype(np.float64) / cap_cpu,
            ecs.ram_request.astype(np.float64) / cap_ram,
        )
        frac = np.clip(frac, 1e-12, 1.0)
        band = np.floor(-np.log(frac) / np.log(self.BAND_BASE))
        return np.clip(band, 0, self.NUM_BANDS - 1).astype(np.int64)

    def _next_band_group(self, remaining, bands, ecs, mt,
                         committed_cpu, committed_ram, committed_net):
        """Greedily merge the next size bands into one solve while
        capacity slack makes it safe.  Returns ``(n_bands, idx)`` — how
        many leading entries of ``remaining`` the group takes, and their
        EC row indices.

        Why merge at all: every device solve pays a fixed launch and
        host-read cost, so sequential band solves multiply the round's
        latency floor; and a merged solve is
        jointly MORE optimal than largest-first commitment (the ladder
        is the approximation, not the merge).  Why a gate: within one
        solve, capacity is denominated in the largest admissible request
        per column, so a band spanning big and small tasks strands up to
        a max/min-request factor of each machine's capacity.  The merge
        is therefore allowed only while the group's crude LOWER bound on
        capacity units (free // group-max request, summed over machines,
        min over CPU/RAM/net dimensions) still covers twice the group's
        supply — under that slack, stranding cannot cause unscheduled
        tasks, and the per-column denominators inside the solve recover
        most of it anyway.  Under tightness the gate closes and the
        ladder behaves exactly as before (largest-first, per-band
        denominators).

        Called once per group from _solve_banded's loop, AGAINST THE
        LIVE committed arrays — the slack seen by group k+1 reflects
        everything groups 1..k committed this round.

        Device policy: merging trades more device iterations (the joint
        instance is more contended) for fewer dispatches, which pays where
        the per-dispatch cost dominates — the reference's accelerator
        policy, here "the solve's device is CUDA"; per-band stays the CPU
        default.  POSEIDON_MERGE_BANDS=1/0 force-overrides.
        """
        if not accel_policy("POSEIDON_MERGE_BANDS", self.device):
            return 1, np.nonzero(bands == remaining[0])[0]
        cpu_free = np.maximum(
            mt.cpu_capacity.astype(np.int64) - committed_cpu, 0
        )
        ram_free = np.maximum(
            mt.ram_capacity.astype(np.int64) - committed_ram, 0
        )
        net_raw = (
            mt.net_rx_capacity.astype(np.int64)
            if mt.net_rx_capacity is not None else None
        )
        net_req_all = ecs.net_rx().astype(np.int64)

        idx = np.nonzero(bands == remaining[0])[0]
        g_supply = int(ecs.supply[idx].sum())
        g_max_cpu = int(ecs.cpu_request[idx].max(initial=0))
        g_max_ram = int(ecs.ram_request[idx].max(initial=0))
        g_max_net = int(net_req_all[idx].max(initial=0))
        n = 1
        for band in remaining[1:]:
            b_idx = np.nonzero(bands == band)[0]
            max_cpu = max(g_max_cpu, int(ecs.cpu_request[b_idx].max(
                initial=0)))
            max_ram = max(g_max_ram, int(ecs.ram_request[b_idx].max(
                initial=0)))
            max_net = max(g_max_net, int(net_req_all[b_idx].max(
                initial=0)))
            supply = g_supply + int(ecs.supply[b_idx].sum())
            units = np.minimum(
                cpu_free // max(max_cpu, 1),
                ram_free // max(max_ram, 1),
            )
            if net_raw is not None and max_net > 0:
                net_free = np.maximum(net_raw - committed_net, 0)
                units = np.minimum(
                    units,
                    # Machines with no accounted NIC capacity (raw 0)
                    # are net-unconstrained, as in the band solve.
                    np.where(net_raw > 0, net_free // max_net,
                             units),
                )
            if int(units.sum()) < 2 * supply:
                break
            idx = np.concatenate([idx, b_idx])
            g_supply = supply
            g_max_cpu, g_max_ram, g_max_net = max_cpu, max_ram, max_net
            n += 1
        return n, np.sort(idx)

    def _solve_banded(self, ecs, mt, metrics, on_band=None,
                      on_band_reset=None) -> np.ndarray:
        """The round's solve: size-banded transportation with committed
        resources flowing between bands.

        The transportation relaxation's machine capacity is a task count,
        so heterogeneous ECs could jointly oversubscribe a machine's
        CPU/RAM/NIC.  Within a band all requests are within a factor of
        BAND_BASE, so a per-machine column capacity of ``floor(free_dim /
        max_request_in_band)`` (min over dimensions) makes any feasible
        flow resource-safe by construction.  Bands run largest-first, each
        consuming what the previous ones committed; gang atomicity is
        enforced per band by forbidding partially-placed gang rows and
        re-solving warm.  Each band's plane comes from the delta-plane
        cache, through the cross-band pipeline when more than one band
        group remains.
        """
        E, M = ecs.num_ecs, mt.num_machines
        flows_full = np.zeros((E, M), dtype=np.int32)
        if M == 0:
            metrics.objective = int(
                (self.cost_model.build(ecs, mt).unsched_cost.astype(np.int64)
                 * ecs.supply.astype(np.int64)).sum()
            )
            metrics.ladder_entry_phase = NUM_PHASES  # no device ladder ran
            return flows_full

        bands = self._band_of_rows(ecs, mt)
        committed_cpu = mt.cpu_used.astype(np.int64).copy()
        committed_ram = mt.ram_used.astype(np.int64).copy()
        committed_net = (
            mt.net_rx_used.astype(np.int64).copy()
            if mt.net_rx_used is not None
            else np.zeros(M, dtype=np.int64)
        )
        committed_slots = np.zeros(M, dtype=np.int64)
        base_slots = mt.slots_free.astype(np.int64)

        objective = 0
        gap = 0.0
        iters = 0
        self._hidden_iters = 0
        self._hidden_bf = 0
        self._repair_firings = 0
        self._pruned_bands = 0
        self._pruned_width = 0
        self._pruned_rounds = 0
        self._pruned_escalations = 0
        self._cert_accepts = 0
        self._cost_delta_hits = 0
        self._cost_rows_rebuilt = 0
        self._cost_cols_rebuilt = 0
        self._pipeline_overlap = 0.0
        self._tier_rank = -1
        self._sharded_bands = 0
        self._shard_devices = 0
        self._telem_curves = []
        entry_min = -1
        phase_sums = None
        self._cross_spec_t = None
        remaining = sorted(set(bands.tolist()))
        if len(remaining) > 1:
            chained = self._try_chained_wave(
                ecs, mt, bands, remaining, committed_cpu, committed_ram,
                committed_net, base_slots, flows_full, metrics, on_band,
                on_band_reset,
            )
            if chained is not None:
                metrics.band_groups = 2
                return chained
        pipe = self._maybe_pipeline(len(remaining))
        first_band, first_idx = None, None
        while remaining:
            t_group = time.perf_counter()
            n_bands, idx = self._next_band_group(
                remaining, bands, ecs, mt, committed_cpu, committed_ram,
                committed_net,
            )
            metrics.band_groups += 1
            band = int(remaining[0])  # warm-frame key: group's largest
            if first_band is None:
                first_band, first_idx = band, idx
            remaining = remaining[n_bands:]
            ecs_b = slice_ecs(ecs, idx)
            mt_b = _with_usage(
                mt, committed_cpu, committed_ram, committed_net,
                np.maximum(base_slots - committed_slots, 0).astype(np.int32),
            )
            with _stage("round.cost_build"):
                if pipe is not None:
                    cm, build_stats = pipe.build(band, ecs_b, mt_b)
                else:
                    cm = self._plane_cache.build(band, ecs_b, mt_b)
                    build_stats = self._plane_cache.last_stats
            self._note_build_stats(build_stats)
            col_cap, net_req = _column_caps(
                ecs_b, cm, mt, committed_cpu, committed_ram, committed_net
            )

            idx_next = None
            if pipe is not None and remaining:
                # Speculate band k+1's plane against the PRE-commit usage
                # while this band solves: the authoritative build next
                # iteration patches exactly the columns this band's flows
                # dirty.  Usage arrays are copied here (frozen) — the live
                # committed arrays keep mutating below.
                _, idx_next = self._next_band_group(
                    remaining, bands, ecs, mt, committed_cpu,
                    committed_ram, committed_net,
                )
                if idx_next.size < 8:
                    # A near-empty band rebuilds faster than the cache
                    # can diff it (the delta gate declines it anyway).
                    idx_next = None
            if idx_next is not None:
                pipe.speculate(
                    int(remaining[0]),
                    slice_ecs(ecs, idx_next),
                    _with_usage(
                        mt, committed_cpu.copy(), committed_ram.copy(),
                        committed_net.copy(),
                        np.maximum(
                            base_slots - committed_slots, 0
                        ).astype(np.int32),
                    ),
                    parent_span_id=self._round_span_id(),
                )

            t_band = time.perf_counter()
            with _stage("round.solve_band"):
                sol = self._solve_band(band, ecs_b, cm, col_cap, mt.uuids)
            if pipe is not None:
                self._pipeline_overlap += pipe.overlap_with(
                    t_band, time.perf_counter()
                )
            self._note_solve_telemetry(band, sol, t_band,
                                       time.perf_counter())
            objective += sol.objective
            gap = max(gap, sol.gap_bound)
            iters += sol.iterations
            metrics.bf_sweeps += sol.bf_sweeps
            ep = int(sol.entry_phase)
            entry_min = ep if entry_min < 0 else min(entry_min, ep)
            if sol.phase_iters:
                if phase_sums is None:
                    phase_sums = [0] * len(sol.phase_iters)
                phase_sums = [
                    a + int(b) for a, b in zip(phase_sums, sol.phase_iters)
                ]
            flows_full[idx] = sol.flows

            fl = sol.flows.astype(np.int64)
            committed_cpu += fl.T @ ecs_b.cpu_request.astype(np.int64)
            committed_ram += fl.T @ ecs_b.ram_request.astype(np.int64)
            committed_net += fl.T @ net_req.astype(np.int64)
            committed_slots += fl.sum(axis=0)
            if on_band is not None:
                # Hand this band's rows to the caller (assignment
                # pipelining) the moment its flows are final.  Later
                # bands write DISJOINT rows of flows_full, so a worker
                # reading this band's rows races nothing.
                on_band(idx, not remaining, flows_full)
            # One interval per group, beside (not around) its stage
            # spans, which keep the round as their parent.
            _trace.record(
                "round.band_group", t_group, time.perf_counter(),
                self._round_span_id(), nested=True, bands=n_bands,
                rows=int(idx.size), supply=int(ecs_b.supply.sum()),
                merged=n_bands > 1,
            )

        # No small-band floor here (unlike the cross-band speculation
        # above): the cross-round spec runs while the worker is
        # otherwise IDLE — the glue side is enacting — so even a build
        # the delta cache declines is pure overlap, not contention.
        if (pipe is not None and first_idx is not None
                and hatch_bool("POSEIDON_STREAMING")):
            # Cross-ROUND speculation (streaming round engine): while the
            # glue side enacts this round's deltas, the pipeline worker
            # pre-builds next round's first band against the FINAL
            # committed usage.  Next round's authoritative pipe.build
            # joins it and delta-patches whatever the admitted watcher
            # deltas actually dirtied — the cross-band contract, so a
            # wrong speculation is never a wrong result.
            pipe.speculate(
                first_band,
                slice_ecs(ecs, first_idx),
                _with_usage(
                    mt, committed_cpu.copy(), committed_ram.copy(),
                    committed_net.copy(),
                    np.maximum(
                        base_slots - committed_slots, 0
                    ).astype(np.int32),
                ),
                parent_span_id=self._round_span_id(),
            )
            self._cross_spec_t = time.perf_counter()

        metrics.objective = objective
        metrics.gap_bound = gap
        metrics.iterations = iters + self._hidden_iters
        metrics.bf_sweeps += self._hidden_bf
        metrics.repair_firings = self._repair_firings
        metrics.pruned_bands = self._pruned_bands
        metrics.pruned_width = self._pruned_width
        metrics.pruned_price_out_rounds = self._pruned_rounds
        metrics.pruned_escalations = self._pruned_escalations
        metrics.pruned_cert_accepts = self._cert_accepts
        metrics.cost_delta_hits = self._cost_delta_hits
        metrics.cost_rows_rebuilt = self._cost_rows_rebuilt
        metrics.cost_cols_rebuilt = self._cost_cols_rebuilt
        metrics.pipeline_overlap_s = round(self._pipeline_overlap, 6)
        metrics.ladder_entry_phase = entry_min if entry_min >= 0 else NUM_PHASES
        if phase_sums is not None:
            metrics.solve_phase_iters = list(phase_sums)
        if self._tier_rank >= 0:
            metrics.solve_tier = self._TIERS[self._tier_rank]
        metrics.sharded_bands = self._sharded_bands
        metrics.shard_devices = (
            self._shard_devices if self._sharded_bands else 0
        )
        self._fold_telemetry(metrics)
        return flows_full

    def _note_solve_telemetry(self, band, sol, t0: float,
                              t1: float) -> None:
        """Collect one band solve's convergence curve (when the
        telemetry ring captured one) and, under span recording, lay it
        onto the timeline as Perfetto counter tracks spread linearly
        over the solve's wall window [t0, t1]."""
        t = sol.telemetry
        if t is None or t.samples() == 0:
            return
        self._telem_curves.append((int(band), t))
        tr = _trace.tracer()
        if tr.tracing():
            tr.counter_series("conv.active_excess", t0, t1,
                              t.active_excess)
            tr.counter_series("conv.active_rows", t0, t1, t.active_rows)
            if t.shard_excess is not None:
                # Per-shard work lanes (mesh-sharded solves).
                for i, row in enumerate(t.shard_excess):
                    tr.counter_series(f"conv.shard{i}.excess", t0, t1,
                                      row)

    def _fold_telemetry(self, metrics: RoundMetrics) -> None:
        """Roll the collected curves into the RoundMetrics scalars and
        keep their JSON-safe digests in ``last_solve_curves``."""
        self.last_solve_curves = [
            dict(band=b, **t.digest()) for b, t in self._telem_curves
        ]
        if not self._telem_curves:
            return
        # Half-life and drain come from the dominant curve: the band with
        # the most captured iterations carries the round's device work.
        dominant = max(self._telem_curves, key=lambda bt: bt[1].samples())
        metrics.telem_samples = sum(
            t.samples() for _, t in self._telem_curves)
        metrics.telem_gu_firings = sum(
            t.gu_firings() for _, t in self._telem_curves)
        metrics.telem_decay_half_life = dominant[1].decay_half_life()
        metrics.telem_iters_to_90 = dominant[1].iters_to_drain(0.9)
        # Shard imbalance: max/mean of the per-shard total excess over the
        # dominant sharded curve's lanes (1.0 = balanced).  Work follows
        # excess, so the shard carrying most of the unmet supply is the
        # round's critical path.
        sharded = [
            t for _, t in self._telem_curves if t.shard_excess is not None
        ]
        if sharded:
            dom = max(sharded, key=lambda t: t.samples())
            totals = np.asarray(dom.shard_excess, dtype=np.float64).sum(
                axis=1
            )
            mean = float(totals.mean())
            if mean > 0.0:
                metrics.shard_imbalance = round(
                    float(totals.max()) / mean, 4
                )

    def _try_chained_wave(self, ecs, mt, bands, remaining, committed_cpu,
                          committed_ram, committed_net, base_slots,
                          flows_full, metrics, on_band, on_band_reset):
        """The chained two-band wave (ops/transport_chained), or None to
        fall through to the per-band loop.

        Gates: ``chain_gate()`` (``POSEIDON_CHAINED=1``, off by
        default), the auction solver, the cpu_mem model without real net
        bounds, no gang rows, exactly two band groups under the
        base-committed grouping gate, and no usable warm frame for either
        group (fresh-wave territory: warm churn rounds are answered by
        the host certificate or the warm solve, both cheaper)."""
        from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel
        from poseidon_tpu_torch.costmodel.device_build import (
            extract_band_operands,
        )
        from poseidon_tpu_torch.ops import transport_chained as TCH

        if not TCH.chain_gate():
            return None
        if (
            self.solver_devices != 1
            or self.flow_solver == "ssp"
            or type(self.cost_model) is not CpuMemCostModel
            # Zero net capacity means unknown/unlimited (MachineTable
            # contract) and is inert in _column_caps; only real net
            # bounds need the host path (no net dimension on the device).
            or (mt.net_rx_capacity is not None
                and bool(np.asarray(mt.net_rx_capacity).any()))
            or (self.gang_scheduling and ecs.is_gang is not None
                and bool(ecs.is_gang.any()))
        ):
            log.debug(
                "chained wave: config gate declined (devices=%d solver=%s "
                "model=%s net=%s gang=%s)", self.solver_devices,
                self.flow_solver,
                type(self.cost_model).__name__,
                mt.net_rx_capacity is not None,
                ecs.is_gang is not None and bool(ecs.is_gang.any()),
            )
            return TCH._outcome(TCH.DECLINED_CONFIG)
        # Grouping under base commitment (an approximation of the loop's
        # own gate, which re-evaluates after band 1 commits; capacity
        # soundness is recomputed exactly on the device for whatever
        # partition this picks).
        n1, idx1 = self._next_band_group(
            remaining, bands, ecs, mt, committed_cpu, committed_ram,
            committed_net,
        )
        rest = remaining[n1:]
        if not rest:
            # A single group: the plain fused path is ideal.
            return TCH._outcome(TCH.DECLINED_GROUPS)
        n2, idx2 = self._next_band_group(
            rest, bands, ecs, mt, committed_cpu, committed_ram,
            committed_net,
        )
        if rest[n2:]:
            log.debug("chained wave: >2 band groups; per-band path")
            return TCH._outcome(TCH.DECLINED_GROUPS)
        if self.incremental:
            uuid_set_now = set(mt.uuids)
            for key_band, idx in (
                (int(remaining[0]), idx1), (int(rest[0]), idx2),
            ):
                warm = self._warm_bands.get(key_band)
                if warm is None:
                    continue
                # Usability, not presence: a frame stranded by EC churn
                # remaps to a cold start anyway.  A full-overlap frame
                # signals churn, where the warm machinery beats re-solving
                # both bands cold.
                ids_now = set(ecs.ec_ids[idx].tolist())
                if (warm.prices is not None
                        and ids_now <= set(warm.ec_ids)
                        and uuid_set_now <= set(warm.machine_uuids)):
                    log.debug("chained wave: usable warm frame for band "
                              "%d; warm path owns it", key_band)
                    return TCH._outcome(TCH.DECLINED_WARM)
        ecs_1 = slice_ecs(ecs, idx1)
        ecs_2 = slice_ecs(ecs, idx2)
        mt_b = _with_usage(
            mt, committed_cpu, committed_ram, committed_net,
            np.maximum(base_slots, 0).astype(np.int32),
        )
        cm1 = self.cost_model.build(ecs_1, mt_b)
        col1, _ = _column_caps(
            ecs_1, cm1, mt, committed_cpu, committed_ram, committed_net
        )
        ops2 = extract_band_operands(ecs_2, mt_b, self.cost_model)
        fired = []

        def early(flows1):
            # Band 1's flows are final the moment they land: start its
            # assignment on the worker thread while this thread reads
            # band 2's cost plane and certifies both bands.  A later
            # decline discards the speculative chunk (on_band_reset).
            if on_band is None:
                return
            flows_full[idx1] = flows1
            fired.append(True)
            on_band(idx1, False, flows_full)

        out = TCH.solve_wave_chained(
            cm1.costs, ecs_1.supply, col1, cm1.unsched_cost,
            cm1.arc_capacity,
            ecs_1.cpu_request.astype(np.int32),
            ecs_1.ram_request.astype(np.int32),
            ops2, ecs_2.supply,
            max_cost_hint=self.cost_model.max_cost(),
            global_update_every=self.global_update_every,
            early=early, device=self.device,
        )
        if out is None:
            if fired and on_band_reset is not None:
                on_band_reset()
            return None
        sol1, sol2, costs2 = out
        flows_full[idx1] = sol1.flows
        flows_full[idx2] = sol2.flows
        metrics.objective = sol1.objective + sol2.objective
        metrics.gap_bound = max(sol1.gap_bound, sol2.gap_bound)
        metrics.iterations = sol1.iterations + sol2.iterations
        metrics.bf_sweeps = sol1.bf_sweeps + sol2.bf_sweeps
        metrics.solve_tier = "dense"  # a full-plane solve
        # Entry and phase telemetry for the early return (the banded
        # loop's aggregation never runs): min/sum over the two bands.
        metrics.ladder_entry_phase = min(
            int(sol1.entry_phase), int(sol2.entry_phase)
        )
        if sol1.phase_iters or sol2.phase_iters:
            p1 = list(sol1.phase_iters) or [0] * len(sol2.phase_iters)
            p2 = list(sol2.phase_iters) or [0] * len(p1)
            metrics.solve_phase_iters = [
                int(a) + int(b) for a, b in zip(p1, p2)
            ]
        if self.incremental:
            for key_band, ecs_b, sol, costs_b, unsched_b in (
                (int(remaining[0]), ecs_1, sol1, cm1.costs,
                 cm1.unsched_cost),
                (int(rest[0]), ecs_2, sol2, costs2, ops2["unsched"]),
            ):
                self._warm_bands[key_band] = _WarmState(
                    ec_ids=list(ecs_b.ec_ids.tolist()),
                    machine_uuids=list(mt.uuids),
                    prices=sol.prices, flows=sol.flows,
                    unsched=sol.unsched,
                    costs=costs_b.astype(np.int64),
                    unsched_cost=unsched_b.astype(np.int64),
                )
        if on_band is not None:
            if not fired:
                on_band(idx1, False, flows_full)
            on_band(idx2, True, flows_full)
        return flows_full

    def _maybe_pipeline(self, n_bands: int):
        """The cross-band pipeline, when it can pay: more than one band
        group to ladder through, the delta plane cache live (a
        speculative build must warm the cache, or joining it buys
        nothing), and the env gate open.  Under the streaming round
        engine a SINGLE band still wants the pipeline — the speculation
        runs across rounds (next round's first build overlaps this
        round's enactment), not across bands."""
        if n_bands < 2 and not hatch_bool("POSEIDON_STREAMING"):
            return None
        if not pipelining_enabled() or not self._plane_cache.enabled():
            return None
        if self._cost_pipeline is None:
            self._cost_pipeline = CostPipeline(self._plane_cache)
        return self._cost_pipeline

    @staticmethod
    def _round_span_id():
        """Id of the innermost recorded span on this thread (the round
        span during a solve), or None — the cross-thread parent for the
        pipeline worker's spans."""
        cur = _trace.current()
        return getattr(cur, "id", None) or None

    def _note_build_stats(self, stats: dict) -> None:
        self._last_build_stats = stats
        if stats.get("delta_hit"):
            self._cost_delta_hits += 1
            self._cost_rows_rebuilt += stats["rows_rebuilt"]
            self._cost_cols_rebuilt += stats["cols_rebuilt"]

    # The degraded-mode ladder, best tier first (the worst tier any band
    # used is the round's).  "sharded" ranks after "dense": it serves the
    # same certified full plane, split over the device mesh.
    _TIERS = ("pruned", "dense", "sharded", "host_greedy")

    def _note_tier(self, tier: str) -> None:
        self._tier_rank = max(self._tier_rank, self._TIERS.index(tier))

    # ------------------------------------------------- sharded band tier

    def _sharded_tier_mesh(self):
        """The tier's mesh over every visible device, built on first use
        and cached (False = probed, fewer than 2 devices).  Returns the
        mesh or None."""
        if self._tier_mesh is None:
            from poseidon_tpu_torch.ops import transport_sharded as TS

            n_dev = len(TS.visible_devices(self.device))
            self._tier_mesh = (
                TS.make_solver_mesh(n_dev, device=self.device)
                if n_dev > 1 else False
            )
        return self._tier_mesh or None

    def _sharded_band_mesh(self, n_cols: int):
        """The mesh the sharded tier would solve an ``n_cols``-wide band
        on, or None when the tier cannot serve that width (shared by the
        gate and ``precompile``, so both agree on solve keys).  The width
        conditions are soundness conditions: the tier fires only where
        the mesh's column padding is a no-op (same padded shape, so the
        same scale, warm epsilons and one-device bit-parity)."""
        if (self.flow_solver != "auction" or self.solver_devices != 1
                or not hatch_bool("POSEIDON_SHARDED_BANDS")):
            return None
        if n_cols < hatch_int("POSEIDON_SHARDED_MIN_COLS"):
            return None
        mesh = self._sharded_tier_mesh()
        if mesh is None:
            return None
        _, m_pad = padded_shape(1, n_cols)
        if m_pad % mesh.size != 0:
            return None
        return mesh

    def _sharded_gate(self, ecs_b, cm, col_cap):
        """Width x contention gate of the sharded tier: it fires on the
        wide, contended bands the pruned gate declines, and declines
        where one device is the right tool.  Returns the mesh or None."""
        E, M = cm.costs.shape
        mesh = self._sharded_band_mesh(M)
        if mesh is None:
            return None
        # Contention: demand as a percentage of open column capacity; an
        # under-contended band drains in a few sweeps on one device.
        supply_sum = int(ecs_b.supply.sum())
        cap_sum = int(np.asarray(col_cap, dtype=np.int64).sum())
        if (supply_sum * 100
                < cap_sum * hatch_int("POSEIDON_SHARDED_MIN_CONTENTION")):
            return None
        return mesh

    def _solve_host_greedy(self, ecs_b, cm, col_cap, partial_fraction=None):
        """The last rung of the degraded ladder: a deterministic,
        host-only feasible placement (cheapest-arc greedy) used when
        neither the pruned nor the dense solve can certify — injected
        certificate failure, or a budget-exhausted cold solve.  Feasible
        by construction (column/arc caps respected), gang-atomic
        (partially-covered gang rows are dropped whole), and
        UNCERTIFIED: ``gap_bound`` is inf, so the round reports
        ``converged=False`` and no warm frame is saved.
        ``partial_fraction`` caps the total units placed (the
        partial-Schedule-response fault: the service answers with a
        deliberately incomplete round)."""
        E, M = cm.costs.shape
        flows = greedy_flows(
            cm.costs, ecs_b.supply, col_cap, cm.arc_capacity
        )
        if partial_fraction is not None:
            budget = int(int(ecs_b.supply.sum()) * partial_fraction)
            for e in range(E):
                row_units = int(flows[e].sum())
                if row_units <= budget:
                    budget -= row_units
                    continue
                # Trim this row to the remaining budget, columns in
                # ascending order, then zero every later row.
                keep = budget
                for m in range(M):
                    take = min(int(flows[e, m]), keep)
                    flows[e, m] = take
                    keep -= take
                budget = 0
        if ecs_b.is_gang is not None and ecs_b.is_gang.any():
            placed = flows.sum(axis=1)
            partial = (
                ecs_b.is_gang & (placed > 0) & (placed < ecs_b.supply)
            )
            flows[partial] = 0
        unsched = (ecs_b.supply - flows.sum(axis=1)).astype(np.int32)
        finite = np.where(cm.costs >= INF_COST, 0, cm.costs).astype(np.int64)
        objective = int(
            (flows.astype(np.int64) * finite).sum()
            + (unsched.astype(np.int64)
               * cm.unsched_cost.astype(np.int64)).sum()
        )
        return TransportSolution(
            flows=flows.astype(np.int32), unsched=unsched,
            prices=np.zeros(E + M + 1, dtype=np.int32),
            objective=objective, gap_bound=float("inf"), iterations=0,
        )

    def _solve_band(self, band, ecs_b, cm, col_cap, machine_uuids):
        """One band's solve: warm-started (a band's frame is stable across
        rounds because an EC's band is a function of its size), with a
        drift-derived epsilon start, then the plane pipeline — on the
        pruned plane with a full-plane price-out certificate when the
        shortlist gate fires (``_try_pruned_band``), else on the full
        plane (``_solve_plane``); the deterministic host-greedy
        placement is the last resort when even the cold retry exhausts
        its budget.  Warm frames are always saved in FULL-plane
        coordinates, so carried prices survive the pruned path's column
        remap round to round."""
        if self.chaos is not None:
            forced, frac = self.chaos.solver_fault()
            if forced or frac is not None:
                # Injected certificate failure / partial round: the
                # degraded tier serves, exactly as it would after a real
                # double escalation.
                sol = self._solve_host_greedy(ecs_b, cm, col_cap, frac)
                self._note_tier("host_greedy")
                self._warm_bands.pop(band, None)
                return sol
        eps_start = None
        prices = flows0 = unsched0 = None
        if self.incremental:
            warm = self._warm_bands.get(band, _WarmState())
            (prices, flows0, unsched0, prev_costs, prev_unsched,
             full_overlap) = _remap_warm_state(
                warm, list(ecs_b.ec_ids.tolist()), list(machine_uuids)
            )
            if full_overlap and prev_costs is not None:
                eps_start = self._incremental_eps(
                    cm.costs, prev_costs, cm.unsched_cost, prev_unsched,
                    prices, self.cost_model.max_cost(),
                    mesh_multiple=max(self.solver_devices, 1),
                )
            if eps_start is None:
                # A carried frame without a drift-derived epsilon (the EC
                # set churned) is net-harmful: cold is fast and certified.
                prices = flows0 = unsched0 = None
        warm_state = (prices, flows0, unsched0, eps_start)

        carry_box: dict = {}
        out = self._try_pruned_band(band, ecs_b, cm, col_cap,
                                    machine_uuids, warm_state, carry_box)
        tier = "pruned"
        if out is None:
            # Escalations hand the dense path the last certified reduced
            # solve's LIFTED full-plane state (prices/flows + the exact
            # eps it is eps-CS at) instead of restarting from the stale
            # warm frame / cold coarse pipeline (gated with the adaptive
            # ladder: POSEIDON_ADAPTIVE_LADDER=0 restores the restart).
            # Where the pruned gate declines because the band is wide and
            # contended, the sharded tier takes it: the same full plane and
            # warm state (its gate keeps the mesh's column padding a
            # no-op, so the drift epsilon stays valid), split over the
            # mesh.
            shard_mesh = self._sharded_gate(ecs_b, cm, col_cap)
            out = self._solve_plane(
                ecs_b, cm.costs, col_cap, cm.arc_capacity,
                cm.unsched_cost, carry_box.get("warm", warm_state),
                warm_eps_exact="warm" in carry_box,
                sharded_mesh=shard_mesh,
            )
            if shard_mesh is not None:
                tier = "sharded"
                self._sharded_bands += 1
                self._shard_devices = int(shard_mesh.size)
            else:
                tier = "dense"
        sol, effective_costs = out
        if sol.gap_bound == float("inf"):
            self._hidden_iters += sol.iterations
            self._hidden_bf += sol.bf_sweeps
            sol = self._solve_host_greedy(ecs_b, cm, col_cap)
            tier = "host_greedy"
        self._note_tier(tier)

        if sol.gap_bound != float("inf"):
            self._warm_bands[band] = _WarmState(
                ec_ids=list(ecs_b.ec_ids.tolist()),
                machine_uuids=list(machine_uuids),
                prices=sol.prices,
                flows=sol.flows,
                unsched=sol.unsched,
                # The costs the final prices are optimal for (gang repair
                # may have forbidden rows).
                costs=effective_costs.astype(np.int64),
                unsched_cost=cm.unsched_cost.astype(np.int64),
            )
        else:
            # A budget-exhausted state has no usable dual structure.
            self._warm_bands.pop(band, None)
        return sol

    def _try_pruned_band(self, band, ecs_b, cm, col_cap, machine_uuids,
                         warm_state, carry_box=None):
        """Pruned-plane attempt (ops/transport_pruned): run the band's
        pipeline — coarse start, warm dispatch — on the union of per-row
        cheapest-column shortlists, certify the lifted solution against
        the full plane (growing the shortlist by the price-out's
        violating columns when the certificate fails), and only then
        apply gang-atomicity repair: each firing forbids rows in the
        BASE costs and re-solves through the same certified pruned loop,
        so every forbid decision is made on a full-plane-certified
        optimum.  Returns ``(sol, effective_costs_full)``, or ``None``
        when the gate declines or any stage escalates — the caller then
        runs the dense path with the SAME warm state (or the escalation's
        carry)."""
        if (self.flow_solver != "auction" or self.solver_devices != 1
                or not hatch_bool("POSEIDON_PRUNED")):
            return None
        E, M = cm.costs.shape
        scale_full = None
        repair = (
            self.gang_scheduling and ecs_b.is_gang is not None
            and bool(ecs_b.is_gang.any())
        )
        # Reduced-plane certificate cache: fed the delta plane cache's
        # dirty sets every build (the ledger), armed once the band's
        # scale is known.  POSEIDON_CERT_CACHE=0 escape hatch.
        ledger = self._plane_cache.take_ledger(band)
        cert = None
        if hatch_bool("POSEIDON_CERT_CACHE"):
            cert = self._cert_bands.get(band)
            if cert is None:
                cert = self._cert_bands[band] = tp.ExcludedColumnCert()
            cert.note_build(ecs_b.ec_ids, machine_uuids, ledger)
        eff_base = cm.costs
        warm = warm_state
        sol = None
        for attempt in range(int(ecs_b.is_gang.sum()) + 1 if repair else 1):
            prices, flows0, unsched0, eps_start = warm
            must = flows0.sum(axis=0) > 0 if flows0 is not None else None
            plan = self._revive_shortlist(
                band, ecs_b, col_cap, must, machine_uuids,
                # Revival bets that last round's cheap columns are still
                # the cheap columns: the delta path's small dirty sets
                # evidence it, and an in-round repair attempt gets it
                # from its own accept.
                fresh_ok=(attempt > 0
                          or bool(self._last_build_stats.get("delta_hit"))),
            )
            if plan is None:
                plan = tp.plan_shortlist(
                    eff_base, ecs_b.supply, col_cap, cm.arc_capacity,
                    must_include=must,
                )
            if plan is None:
                # Gate declined — the dense path owns the band.
                self._shortlist_bands.pop(band, None)
                if attempt > 0:
                    self._pruned_escalations += 1
                if sol is not None:
                    # The accepted-then-abandoned attempt's work stays
                    # visible (the dense fallback re-solves).
                    self._hidden_iters += sol.iterations
                    self._hidden_bf += sol.bf_sweeps
                return None
            if scale_full is None:
                # Reduced solves run at the FULL instance's scale so every
                # epsilon, dual and certificate stays in full-instance
                # units; derived only once a plan fired.
                scale_full, _ = derive_scale(
                    cm.costs, cm.unsched_cost, self.cost_model.max_cost(),
                    *padded_shape(E, M),
                )
                if cert is not None:
                    # Arm the certificate cache: fold the deltas
                    # accumulated since its last use against the BASE
                    # plane at the band's pinned scale.
                    cert.begin_attempt(cm.costs, scale_full)

            def solve_on(sel, warm_r, _eff=eff_base, _w=warm):
                costs_r = np.ascontiguousarray(_eff[:, sel])
                arc_r = (np.ascontiguousarray(cm.arc_capacity[:, sel])
                         if cm.arc_capacity is not None else None)
                p, f, u, eps = _w
                if warm_r is None and p is not None:
                    # Round 0: the carried frame, column-sliced onto the
                    # shortlist (must_include kept every column holding
                    # warm flow, so nothing is widened away).
                    warm_r = (
                        np.concatenate([
                            p[:E], p[E:E + M][sel], p[E + M:],
                        ]),
                        np.ascontiguousarray(f[:, sel]), u, eps,
                    )
                elif warm_r is None:
                    warm_r = (None, None, None, None)
                return self._solve_plane(
                    ecs_b, costs_r, col_cap[sel], arc_r, cm.unsched_cost,
                    warm_r, scale=scale_full, gang_repair=False,
                )

            prev = sol
            sol, eff_full, stats = tp.solve_pruned(
                eff_base, ecs_b.supply, col_cap, cm.unsched_cost,
                arc_capacity=cm.arc_capacity, scale=scale_full, plan=plan,
                solve_on=solve_on, cert=cert,
            )
            self._pruned_width = max(self._pruned_width, stats["width"])
            self._pruned_rounds += stats["rounds"]
            if sol is None:
                # The escalated attempt's work stays visible, and any
                # accepted-then-abandoned earlier attempt's.
                self._shortlist_bands.pop(band, None)
                self._hidden_iters += stats["iterations"]
                self._hidden_bf += stats["bf_sweeps"]
                if prev is not None:
                    self._hidden_iters += prev.iterations
                    self._hidden_bf += prev.bf_sweeps
                self._pruned_escalations += 1
                if (carry_box is not None
                        and stats.get("carry") is not None
                        and eff_base is cm.costs
                        and hatch_bool("POSEIDON_ADAPTIVE_LADDER")):
                    # Seed the dense fallback with the last lifted
                    # full-plane state — only while no gang rows were
                    # forbidden yet (the dense path re-runs repair from
                    # the base plane).
                    carry_box["warm"] = stats["carry"]
                return None
            if prev is not None:
                # The replaced (pre-repair) solve's work.
                self._hidden_iters += prev.iterations
                self._hidden_bf += prev.bf_sweeps
            if stats["sel"] is not None:
                # The ACCEPTED union, keyed by machine uuid so column
                # churn remaps next revival.
                self._shortlist_bands[band] = (
                    [machine_uuids[int(j)] for j in stats["sel"]],
                    plan.k,
                )
            if stats["cert"] == "certified":
                self._cert_accepts += 1
            if not repair:
                break
            placed = sol.flows.sum(axis=1)
            partial = (
                ecs_b.is_gang & (placed > 0) & (placed < ecs_b.supply)
            )
            if not partial.any():
                break
            self._repair_firings += 1
            if eff_base is cm.costs:
                eff_base = cm.costs.copy()
            eff_base[partial] = INF_COST
            # Warm re-solve from the certified state, eps=1 — the dense
            # repair's policy (_forbid_partial_gangs).
            warm = (sol.prices, sol.flows, sol.unsched, 1)
        self._pruned_bands += 1
        # eff_full of the last accepted solve is eff_base itself (the
        # closure never forbids rows; repair forbids in the base).
        return sol, eff_full

    def _revive_shortlist(self, band, ecs_b, col_cap, must,
                          machine_uuids, fresh_ok):
        """Revive the band's last ACCEPTED shortlist instead of re-running
        the O(E*M) planner.  Sound for any column selection (every accept
        still passes a certificate and violations grow the union), so the
        gates below are performance gates: the revived union must still
        satisfy the planner's size/capacity/width invariants, and the
        plane must not have churned past the delta path (``fresh_ok``).
        Returns a ShortlistPlan or None (fresh plan)."""
        if not fresh_ok:
            return None
        saved = self._shortlist_bands.get(band)
        if saved is None:
            return None
        uuids, k = saved
        E = int(ecs_b.supply.size)
        M = int(col_cap.size)
        if (not tp.row_gate_ok(
                E, M, hatch_int("POSEIDON_PRUNE_MIN_ROWS",
                                tp.PRUNE_MIN_ROWS))
                or M < hatch_int("POSEIDON_PRUNE_MIN_COLS",
                                 tp.PRUNE_MIN_COLS)):
            return None
        pos = {u: j for j, u in enumerate(machine_uuids)}
        cols = [pos[u] for u in uuids if u in pos]
        if len(cols) * 32 < len(uuids) * 31:
            # >~3% of the union's machines left the cluster: replan.
            return None
        mask = np.zeros(M, dtype=bool)
        mask[np.asarray(cols, dtype=np.int64)] = True
        if must is not None:
            mask |= must
        cap64 = col_cap.astype(np.int64)
        total_supply = int(ecs_b.supply.astype(np.int64).sum())
        if total_supply <= 0:
            return None
        if int(cap64[mask].sum()) < tp.PRUNE_SLACK * total_supply:
            return None  # churn ate the union's capacity slack
        width_cap = (M * tp.PRUNE_MAX_WIDTH_NUM
                     // tp.PRUNE_MAX_WIDTH_DEN)
        width = int(mask.sum())
        if width > width_cap:
            return None
        target = bucket_size(width, lo=32)
        if target > width_cap:
            return None
        if target > width:
            # Pad to the shape bucket with unselected live columns,
            # largest free capacity first.
            free = np.nonzero(~mask)[0]
            order = free[np.argsort(-cap64[free], kind="stable")]
            mask[order[: target - width]] = True
        return tp.ShortlistPlan(sel=np.nonzero(mask)[0], k=k)

    def _solve_plane(self, ecs_b, costs, col_cap, arc_capacity,
                     unsched_cost, warm_state, scale=None,
                     gang_repair=True, warm_eps_exact=False,
                     sharded_mesh=None):
        """The per-plane pipeline: coarse warm start on fresh waves, the
        warm/cold dispatch with policy budgets, gang-atomicity repair.
        The pruned path runs the identical pipeline on a column-reduced
        plane with ``scale`` pinned to the full instance's (``None`` —
        the dense path — derives it per plane); ``gang_repair=False``
        skips repair there, since the pruned path repairs only on
        full-plane-certified solutions (``_try_pruned_band``).
        ``warm_eps_exact`` declares the warm start's epsilon exact (an
        escalation carry), so the dispatch skips the host-cert pass that
        would recompute it and miss.  ``sharded_mesh`` (the sharded tier)
        routes every full-plane dispatch (the warm or cold solve and the
        gang-repair re-solves) through the sharded solve; the coarse
        start's [E, 256] aggregate stays on one device (the host
        two-dispatch start; the one-program start is declined, its full
        ladder would defeat the split).  Returns ``(sol,
        effective_costs)``; ``effective_costs`` is what the final prices
        are optimal for."""
        prices, flows0, unsched0, eps_start = warm_state
        sol = None
        eps_is_exact = warm_eps_exact
        if (prices is None and self.flow_solver != "ssp"
                and hatch_bool("POSEIDON_COARSE")):
            # Fresh-wave coarse start: solve the machine-aggregated
            # [E, 256] instance, lift its duals and primal, and start the
            # ladder at the lift's certified epsilon.  On the card the
            # whole pipeline runs as one device program
            # (transport_coarse); a declined program falls through to the
            # host two-dispatch path.
            hint = self.cost_model.max_cost()
            # Size gates and greedy certificate once, for both paths.
            pre = coarse_precheck(
                costs, ecs_b.supply, col_cap, arc_capacity, unsched_cost,
                hint, scale=scale,
            )
            if (pre is not None
                    and self.solver_devices == 1
                    and sharded_mesh is None
                    and not pre["certified"]
                    and (scale is None
                         or hatch_bool("POSEIDON_COARSE_PINNED"))
                    and accel_policy("POSEIDON_COARSE_FUSED", self.device)):
                # Pinned-scale (pruned) planes run it too: ``pre`` carries
                # the pinned scale.
                sol = solve_transport_coarse_fused(
                    costs, ecs_b.supply, col_cap, unsched_cost,
                    arc_capacity=arc_capacity, max_cost_hint=hint,
                    max_iter_total=8192,
                    global_update_every=self.global_update_every,
                    pre=pre, device=self.device,
                )
            if pre is not None and sol is None:
                def counting_solve(*a, **k):
                    # The coarse dispatch's work lands in the metrics.
                    s = self._dispatch_solve(*a, **k)
                    self._hidden_iters += s.iterations
                    self._hidden_bf += s.bf_sweeps
                    return s

                cs = coarse_warm_start(
                    costs, ecs_b.supply, col_cap, unsched_cost,
                    arc_capacity, counting_solve, max_cost_hint=hint,
                    pre=pre,
                )
                if cs is not None:
                    prices, flows0, unsched0, eps_start = cs
                    eps_is_exact = True

        def run(run_costs, eps, p=None, f=None, u=None, exact=False):
            # Policy budgets: a warm attempt that has not converged within
            # a few times a typical warm solve is misled (its failure mode
            # is the cheap cold retry); cold solves get a wide backstop.
            is_warm = p is not None or f is not None
            return self._dispatch_solve(
                run_costs, ecs_b.supply, col_cap, unsched_cost, p,
                sharded_mesh=sharded_mesh,
                arc_capacity=arc_capacity, init_flows=f,
                init_unsched=u, eps_start=eps,
                max_iter_total=2048 if is_warm else 8192,
                # The model's static bound pins the cost scale.
                max_cost_hint=self.cost_model.max_cost(),
                scale=scale, eps_exact=exact,
            )

        if sol is None:
            sol = run(costs, eps_start, prices, flows0, unsched0,
                      exact=eps_is_exact)
            if prices is not None and sol.gap_bound == float("inf"):
                # Any warm start can mislead: retry cold.
                self._hidden_iters += sol.iterations
                self._hidden_bf += sol.bf_sweeps
                sol = run(costs, None)

        effective_costs = costs
        if (
            gang_repair
            and self.gang_scheduling
            and ecs_b.is_gang is not None
            and ecs_b.is_gang.any()
        ):
            for _ in range(int(ecs_b.is_gang.sum())):
                prev = sol
                sol, effective_costs, fired = self._forbid_partial_gangs(
                    sol, effective_costs, costs, ecs_b.is_gang,
                    ecs_b.supply, run,
                )
                if not fired:
                    break
                self._repair_firings += 1
                self._hidden_iters += prev.iterations
                self._hidden_bf += prev.bf_sweeps
        return sol, effective_costs

    @staticmethod
    def _forbid_partial_gangs(sol, effective_costs, base_costs, gangs,
                              supply, run):
        """One gang-atomicity repair step: forbid currently
        partially-placed gang rows and re-solve warm (cold retry on a
        misled warm start).  ``run(costs, eps, prices, flows, unsched)``
        is the caller's solve closure.  Returns ``(sol, effective_costs,
        fired)``; ``effective_costs`` is what the final prices are
        optimal for (forbidden rows are INF_COST there), which warm
        frames must save.  Each firing permanently forbids >= 1 gang
        row, so loops over this step terminate within ``gangs.sum()``
        passes.
        """
        placed = sol.flows.sum(axis=1)
        partial = gangs & (placed > 0) & (placed < supply)
        if not partial.any():
            return sol, effective_costs, False
        if effective_costs is base_costs:
            effective_costs = base_costs.copy()
        effective_costs[partial] = INF_COST
        sol = run(effective_costs, 1, sol.prices, sol.flows, sol.unsched)
        if sol.gap_bound == float("inf"):
            sol = run(effective_costs, None)
        return sol, effective_costs, True

    @staticmethod
    def _incremental_eps(
        costs: np.ndarray,
        prev_costs: np.ndarray,
        unsched_cost: np.ndarray,
        prev_unsched_cost: np.ndarray,
        prices: Optional[np.ndarray],
        max_cost_hint: int = 0,
        mesh_multiple: int = 1,
    ):
        """Epsilon ladder start from the observed cost change under the
        carried prices.

        The warm prices are 1-optimal for last round's costs, so this
        round they are ``eps``-optimal for the smallest ``eps`` covering
        (a) the per-arc cost drift on arcs that kept their admissibility,
        and (b) the (possibly deeply negative) reduced cost of arcs that
        BECAME admissible this round — e.g. capacity freed by completed
        tasks re-opening fit.  Arcs that became inadmissible need nothing:
        their carried flow is dropped at solve init and re-routed.
        ``scale`` must reproduce the solver's own choice
        (``_host_validate``: padded rows, quantized cost bound).
        """
        from poseidon_tpu_torch.ops.transport import (
            COST_CAP,
            INF_COST,
            LADDER_FACTOR,
            choose_scale,
            padded_shape,
        )

        now_inadm = costs >= INF_COST
        prev_inadm = prev_costs >= INF_COST
        adm_both = ~now_inadm & ~prev_inadm
        fresh = ~now_inadm & prev_inadm          # newly admissible arcs
        drift = 0
        if adm_both.any():
            drift = int(
                np.abs(
                    costs.astype(np.int64)[adm_both]
                    - prev_costs[adm_both]
                ).max()
            )
        drift = max(
            drift,
            int(
                np.abs(
                    unsched_cost.astype(np.int64) - prev_unsched_cost
                ).max(initial=0)
            ),
        )
        E, M = costs.shape
        # Reproduce the solver's scale derivation exactly (it pads rows to
        # a power of two, columns to a quarter-octave bucket, rounded up to
        # a mesh multiple on the sharded path, and quantizes the cost
        # bound; _host_validate / padded_shape / transport_sharded).
        e_pad, m_pad = padded_shape(E, M)
        if mesh_multiple > 1:
            m_pad = -(-m_pad // mesh_multiple) * mesh_multiple
        finite_max = int(costs[~now_inadm].max()) if (~now_inadm).any() else 0
        max_raw = max(finite_max, int(unsched_cost.max(initial=0)),
                      max_cost_hint, 1)
        max_raw_q = 1 << (max_raw - 1).bit_length() if max_raw > 1 else 1
        max_raw_q = min(max_raw_q, COST_CAP)
        scale = choose_scale(e_pad, m_pad, max_raw_q)

        eps = drift * scale + 1
        if fresh.any():
            if prices is None:
                return None
            pe = prices[:E].astype(np.int64)
            pm = prices[E : E + M].astype(np.int64)
            rc = (
                costs.astype(np.int64) * scale
                + pe[:, None] - pm[None, :]
            )
            worst = int((-rc[fresh]).max(initial=0))
            eps = max(eps, worst + 1)
        # Only worth it if the warm ladder skips at least one rung of the
        # cold one: measured at 10k-machine churn, freed capacity makes
        # newly admissible arcs drive eps to within a factor ~7 of the
        # cold eps0 (one rung = LADDER_FACTOR = 4096), and a warm solve
        # from there with stale flows ran 700-1400 iterations where the
        # cold greedy start takes ~100-300.  The one-scale-unit floor
        # keeps bit-identical and tiny-drift rounds (eps ~ scale) on the
        # fast path even for narrow cost ranges (small max_raw_q).
        eps0_cold = max_raw_q * scale // 2
        if eps > max(scale, eps0_cold // LADDER_FACTOR):
            return None
        return eps
    # -------------------------------------------------------------- assignment

    def _assign(
        self,
        flows: np.ndarray,
        view,
        metrics: RoundMetrics,
    ) -> List[Delta]:
        """EC-level flows -> per-task placements, stability-first.

        Vectorized per EC (numpy over the member arrays; Python touches
        only *changed* tasks, which in steady state is the churn set, not
        the whole cluster):

        1. members keep their current machine while the solution still
           routes flow there (placement stability minimizes MIGRATEs);
        2. leftover flow goes to the remainder, longest-waiting first
           (bounded unfairness), machine columns in ascending order;
        3. diffs against the previous placement become the deltas.
        """
        deltas, placements, hints = self._assign_ecs(
            range(view.ecs.num_ecs), flows, view, metrics
        )
        self._apply_hint_reinserts(hints)
        self.state.apply_placements(placements)
        return deltas

    def _assign_ecs(
        self,
        ec_indices,
        flows: np.ndarray,
        view,
        metrics: RoundMetrics,
    ) -> Tuple[List[Delta], List[Tuple[int, Optional[str]]]]:
        """The per-EC assignment loop over a SUBSET of EC rows.

        Factored out of ``_assign`` so each band's assignment runs as
        soon as its flows are final.  Does NOT touch ClusterState
        placements — callers merge the returned chunks in band order and
        apply once, keeping delta order deterministic."""
        deltas: List[Delta] = []
        st = self.state
        mt = view.machines
        M = mt.num_machines
        uuids = mt.uuids
        placements: List[Tuple[int, Optional[str]]] = []
        hint_reinserts: List[Tuple[int, str]] = []

        for i in ec_indices:
            uids = view.member_uids[i]
            cur = view.member_cur[i]
            wait = view.member_wait[i]
            want = flows[i].astype(np.int64)
            n = uids.size
            new_col = np.full(n, -1, dtype=np.int64)

            # Pass 1 (stability): within each machine column, the first
            # `min(#residents, flow)` members by uid order stay.
            has_cur = cur >= 0
            if has_cur.any():
                res_idx = np.nonzero(has_cur)[0]
                cols = cur[res_idx].astype(np.int64)
                counts = np.bincount(cols, minlength=M)
                keep_quota = np.minimum(counts, want)
                order = np.argsort(cols, kind="stable")
                sorted_cols = cols[order]
                first_occ = np.searchsorted(sorted_cols, sorted_cols, "left")
                rank = np.arange(sorted_cols.size) - first_occ
                keep = rank < keep_quota[sorted_cols]
                stays = res_idx[order[keep]]
                new_col[stays] = cur[stays]
                used = np.bincount(new_col[stays], minlength=M)
                rem = want - used
            else:
                rem = want

            # Pass 2: longest-waiting first; ties by uid (members are
            # uid-sorted, so index order is uid order).  Resubmission
            # affinity is a TIE-BREAK within the members this pass
            # would place anyway: WHO places is still wait-ordered (the
            # starvation escalator's bounded-unfairness guarantee must
            # not lose to a wait=0 resubmission), only WHERE adjusts —
            # a chosen member whose prior machine still has flow goes
            # back there (image/data locality); the flow itself is the
            # fresh solve's, best-effort only.
            pool = np.nonzero(new_col < 0)[0]
            if pool.size:
                pool = pool[np.lexsort((pool, -wait[pool]))]
                chosen = pool[: min(pool.size, int(rem.sum()))]
                if self._round_prior is not None and chosen.size:
                    pcols = self._round_prior[i]
                    for j in chosen.tolist():
                        c = int(pcols[j])
                        if c >= 0 and rem[c] > 0:
                            new_col[j] = c
                            rem[c] -= 1
                    chosen = chosen[new_col[chosen] < 0]
                cols_exp = np.repeat(np.arange(M, dtype=np.int64), rem)
                k = min(chosen.size, cols_exp.size)
                if k:
                    new_col[chosen[:k]] = cols_exp[:k]
            if self._round_prior is not None:
                # Hints consumed by _collect_prior but not applied to a
                # member that ends the round UNPLACED (lost the
                # wait-ordered tie-break, or the prior machine received
                # no flow) go back into the state dict: one-shot consume
                # is only for hints actually used.  Members placed
                # elsewhere drop theirs — the new machine supersedes it
                # on the next removal.  COLLECTED here, applied at the
                # commit point with the placements.
                pcols = self._round_prior[i]
                unapplied = np.nonzero((pcols >= 0) & (new_col < 0))[0]
                for j in unapplied.tolist():
                    hint_reinserts.append(
                        (int(uids[j]), uuids[int(pcols[j])])
                    )

            # Pass 3: diff -> deltas; only changed tasks touch Python.
            if not self.preemption:
                # Preemption disabled: evicted-by-the-solver tasks stay put.
                evicted = (new_col < 0) & (cur >= 0)
                new_col[evicted] = cur[evicted]
            changed = np.nonzero(new_col != cur)[0]
            metrics.unscheduled += int(((new_col < 0) & (cur < 0)).sum())
            # Classify in numpy, build deltas from pre-converted Python
            # lists: per-index numpy scalar access + int() casts in one
            # 100k-task loop are slow; bulk .tolist() + zip does the same
            # work in C.

            oc_ch = cur[changed]
            nc_ch = new_col[changed]
            grp_place = changed[oc_ch < 0]
            grp_preempt = changed[(nc_ch < 0) & (oc_ch >= 0)]
            grp_migrate = changed[(nc_ch >= 0) & (oc_ch >= 0)]
            # PREEMPTs first: an in-order consumer with admission checks
            # must see the slot freed before the PLACE that fills it
            # (the old per-index loop interleaved these arbitrarily).
            for uid in uids[grp_preempt].tolist():
                deltas.append(Delta(uid, "", DeltaType.PREEMPT))
                placements.append((uid, None))
            for uid, nc in zip(uids[grp_place].tolist(),
                               new_col[grp_place].tolist()):
                m = uuids[nc]
                deltas.append(Delta(uid, m, DeltaType.PLACE))
                placements.append((uid, m))
            for uid, nc in zip(uids[grp_migrate].tolist(),
                               new_col[grp_migrate].tolist()):
                m = uuids[nc]
                deltas.append(Delta(uid, m, DeltaType.MIGRATE))
                placements.append((uid, m))
            metrics.placed += grp_place.size
            metrics.preempted += grp_preempt.size
            metrics.migrated += grp_migrate.size
            # Unscheduled-and-still-unscheduled tasks age their wait
            # counter (the starvation escalator input).
            still = np.nonzero((new_col < 0) & (cur < 0))[0]
            placements.extend((u, None) for u in uids[still].tolist())

        return deltas, placements, hint_reinserts

    def _apply_hint_reinserts(self, hint_reinserts) -> None:
        """Commit-time application of the unapplied-hint re-inserts a
        chunk collected (FIFO refresh + cap eviction, under the state
        lock) — runs only for chunks whose round actually commits."""
        if not hint_reinserts:
            return
        with self.state._lock:
            pm = self.state.prior_machine
            for uid, machine in hint_reinserts:
                pm.pop(uid, None)  # refresh FIFO position
                pm[uid] = machine
            while len(pm) > self.state._PRIOR_CAP:
                pm.pop(next(iter(pm)))

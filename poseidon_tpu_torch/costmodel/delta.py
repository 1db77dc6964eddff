"""Delta-maintained cost planes: rebuild only what the watch deltas moved
(the PyTorch/CUDA port of ``poseidon_tpu/costmodel/delta.py``; host numpy
only).

A steady-state churn round moves a handful of ECs and the few machines
whose usage changed, yet a full cost-matrix rebuild prices every cell.
graph/residency.py already applies the cure to the mask half of the
build (interned column spaces + delta-maintained count matrices); this
module generalizes the pattern to the cost matrices themselves.

:class:`CostPlaneCache` keeps, per solve band, the previous round's
[E, M] cost/arc-capacity planes together with a snapshot of every input
those cells were computed from.  On the next build it classifies

- **dirty rows** — EC ids absent last round, or whose representative
  labels changed (the EC id already hashes requests + every selector, so
  id equality covers the rest of the row-side inputs);
- **dirty columns** — machines absent last round, or whose snapshot of
  the model-declared column inputs (capacity/usage/utilization arrays),
  machine labels, or resident-label counts changed (vectorized array
  diffs; machine relabels and placement-driven resident churn land
  here)

and rebuilds ONLY those slices, through the model's own ``build`` on
row/column-sliced tables — the full build stays verbatim as the oracle,
and the churn tests (tests/test_torch_cost_delta.py) pin the assembled
plane bit-identical to it and to the JAX package's cache.  A dense-rebuild escape hatch fires
whenever the dirty fraction crosses the gate (mirroring the
``nnz * 16 < E * M`` sparse-admissibility gates): a wave that churns
half the plane pays one full rebuild, never a slower patchwork.

Correctness rests on the ``CostModel.delta_plane`` contract (base.py):
every cell is a pure function of its row x column inputs, so a cell
whose inputs did not change cannot change.  Anything the cache cannot
prove clean — presence flips of optional inputs, resident-interner
compaction, a changed cost-model instance — falls back to the oracle
full rebuild for that round.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_int
from poseidon_tpu_torch.utils.locks import TrackedLock
from poseidon_tpu_torch.costmodel.base import (
    CostMatrices,
    CostModel,
    ECTable,
    MachineTable,
    slice_ecs,
    slice_machines,
)

ENV_GATE = "POSEIDON_COST_DELTA"

# Dense-rebuild escape hatch: the incremental path runs only while
# dirty_rows * M + dirty_cols * E stays under (NUM/DEN) of E * M.
GATE_NUM = 1
GATE_DEN = 4
# Planes smaller than this rebuild dense unconditionally — the dict
# probes + diffs would cost more than the build they save.
MIN_CELLS = 2048
# Row floor: the column-dirtiness diff costs O(M * label/resident
# width) regardless of E, while the full build costs O(E * M) — a
# near-empty band (the 10k gang config's 1-row big-gang plane) rebuilds
# faster than it diffs.
MIN_ROWS = 8


class PlaneLedger:
    """Accumulated dirty sets for one band since the last consume — the
    reduced-plane certificate's fold feed (transport_pruned.
    ExcludedColumnCert).  Maintained by the CACHE on every build so the
    pipeline's speculative builds can never slip a patched column past
    the consumer (``pipe.build`` only surfaces the authoritative
    build's stats; the ledger is the union).  ``broken`` marks any
    build the delta path did not serve (full rebuild, gate, disabled):
    unknown changes, the consumer must re-anchor.  ``present`` is the
    intersection of the EC-id sets of every build since the last take
    (None until a build lands) — rows absent from any build may have
    missed a fold window."""

    __slots__ = ("broken", "rows", "cols", "present")

    def __init__(self) -> None:
        self.broken = False
        self.rows: set = set()       # dirty EC ids
        self.cols: set = set()       # dirty machine uuids
        self.present: Optional[set] = None


class _Plane:
    """One band's cached plane + the input snapshot it was built from."""

    __slots__ = (
        "ec_ids", "ec_pos", "ec_labels", "pod_presence",
        "uuids", "uuid_pos", "col_arrays", "mlabels", "label_index",
        "res_kv_id", "res_key_id", "res_kv", "res_key", "res_total",
        "costs", "arc",
    )


class CostPlaneCache:
    """Per-band delta-maintained cost planes over one cost model.

    Not thread-safe by itself: callers serialize ``build`` calls (the
    planner's cross-band pipeline runs speculative builds on a single
    worker and joins it before the authoritative build — see
    graph/pipeline.py).
    """

    def __init__(self, model: CostModel) -> None:
        self.model = model
        self._bands: Dict[int, _Plane] = {}
        self._ledgers: Dict[int, PlaneLedger] = {}
        # Stats for the LAST build call (the planner folds them into
        # RoundMetrics): delta_hit is True when the incremental path
        # served, rows/cols_rebuilt count the dirty slices it rebuilt.
        self.last_stats: dict = self._stats(False, 0, 0, "disabled")
        # Continuous-ingest seam (the streaming round engine): dirty
        # hints — EC ids / machine uuids touched by watcher deltas —
        # pushed as events arrive instead of discovered at the build's
        # snapshot diff.  Hints are CONSERVATIVE: the round's builds
        # union them into the diffed dirty sets (forcing at most an
        # extra rebuilt slice, never a stale one — cell purity makes
        # the rebuild bit-identical either way), so a hint can never be
        # wrong-result, only wasted.  Own lock: the pusher and the
        # builders (round thread + pipeline worker) are different
        # threads.
        self._ingest_lock = TrackedLock(
            "costmodel.CostPlaneCache._ingest_lock"
        )
        self._hint_rows: set = set()   # dirty EC ids
        self._hint_cols: set = set()   # dirty machine uuids
        self.ingest_hints_applied = 0  # rows+cols forced dirty by hints

    @staticmethod
    def _stats(hit: bool, rows: int, cols: int, path: str) -> dict:
        return {
            "delta_hit": hit,
            "rows_rebuilt": rows,
            "cols_rebuilt": cols,
            "path": path,
            "dirty_rows": None,
            "dirty_cols": None,
        }

    def enabled(self) -> bool:
        return (
            getattr(self.model, "delta_plane", False)
            and hatch_bool(ENV_GATE)
        )

    def invalidate(self, key: Optional[int] = None) -> None:
        if key is None:
            self._bands.clear()
            for led in self._ledgers.values():
                led.broken = True
        else:
            self._bands.pop(key, None)
            if key in self._ledgers:
                self._ledgers[key].broken = True

    def set_round_hints(self, ec_ids: Iterable[int],
                        machine_uuids: Iterable[str]) -> None:
        """Install this round's continuous-ingest dirty hints (replacing
        the last round's): every build until the next call unions them
        into its diffed dirty sets.  Thread-safe."""
        with self._ingest_lock:
            self._hint_rows = set(int(e) for e in ec_ids)
            self._hint_cols = set(machine_uuids)

    def ingest(self, ec_ids: Iterable[int] = (),
               machine_uuids: Iterable[str] = ()) -> None:
        """Accumulate dirty hints as events arrive (the watcher-thread
        half of the seam; additive, unlike ``set_round_hints``)."""
        with self._ingest_lock:
            self._hint_rows.update(int(e) for e in ec_ids)
            self._hint_cols.update(machine_uuids)

    def _apply_hints(self, ecs: ECTable, machines: MachineTable,
                     dirty_rows: np.ndarray,
                     dirty_cols: np.ndarray):
        """Union the installed ingest hints into one build's dirty sets
        (hint identity -> positional index, unknown identities skipped:
        a hint for a row/column not in this band costs nothing here)."""
        with self._ingest_lock:
            rows, cols = self._hint_rows, self._hint_cols
            if not rows and not cols:
                return dirty_rows, dirty_cols
            # ec_ids is a host numpy array: its tolist() reads no device.
            add_r = [
                i for i, e in enumerate(ecs.ec_ids.tolist())  # posecheck: ignore[blocking-under-lock]
                if int(e) in rows
            ]
            add_c = [
                j for j, u in enumerate(machines.uuids) if u in cols
            ]
        if add_r:
            merged = np.union1d(dirty_rows,
                                np.asarray(add_r, dtype=np.int64))
            self.ingest_hints_applied += int(
                merged.size - dirty_rows.size
            )
            dirty_rows = merged
        if add_c:
            merged = np.union1d(dirty_cols,
                                np.asarray(add_c, dtype=np.int64))
            self.ingest_hints_applied += int(
                merged.size - dirty_cols.size
            )
            dirty_cols = merged
        return dirty_rows, dirty_cols

    def take_ledger(self, key: int) -> Optional[PlaneLedger]:
        """Consume the band's accumulated dirty ledger (None = no build
        recorded for the key since the last take)."""
        return self._ledgers.pop(key, None)

    def _ledger_broken(self, key: int) -> None:
        led = self._ledgers.get(key)
        if led is None:
            led = self._ledgers[key] = PlaneLedger()
        led.broken = True

    def _ledger_delta(self, key: int, ecs: ECTable,
                      machines: MachineTable, dirty_rows: np.ndarray,
                      dirty_cols: np.ndarray) -> None:
        led = self._ledgers.get(key)
        if led is None:
            led = self._ledgers[key] = PlaneLedger()
        ids = set(int(e) for e in ecs.ec_ids.tolist())
        led.present = ids if led.present is None else (led.present & ids)
        led.rows.update(int(e) for e in ecs.ec_ids[dirty_rows].tolist())
        led.cols.update(machines.uuids[int(j)] for j in dirty_cols)
        # Bounded memory: dirt past re-anchor usefulness degrades to
        # broken (the consumer's next full pass refreshes for free).
        if (len(led.rows) > 4 * ecs.num_ecs
                or len(led.cols) > 2 * machines.num_machines):
            led.broken = True
            led.rows.clear()
            led.cols.clear()

    # ------------------------------------------------------------------ build

    def build(self, key: int, ecs: ECTable,
              machines: MachineTable) -> CostMatrices:
        E, M = ecs.num_ecs, machines.num_machines
        if not self.enabled() or E == 0 or M == 0:
            self.last_stats = self._stats(False, 0, 0, "disabled")
            self._ledger_broken(key)
            return self.model.build(ecs, machines)
        if (E * M < hatch_int("POSEIDON_COST_DELTA_MIN_CELLS", MIN_CELLS)
                or E < hatch_int("POSEIDON_COST_DELTA_MIN_ROWS", MIN_ROWS)):
            self.last_stats = self._stats(False, 0, 0, "small")
            self._ledger_broken(key)
            return self.model.build(ecs, machines)
        prev = self._bands.get(key)
        if prev is None or not self._comparable(prev, ecs, machines):
            return self._full(key, ecs, machines, "full")

        dirty_rows = self._dirty_rows(prev, ecs)
        dirty_cols = self._dirty_cols(prev, machines)
        if dirty_rows is None or dirty_cols is None:
            return self._full(key, ecs, machines, "full")
        dirty_rows, dirty_cols = self._apply_hints(
            ecs, machines, dirty_rows, dirty_cols
        )
        work = dirty_rows.size * M + dirty_cols.size * E
        if work * GATE_DEN >= E * M * GATE_NUM:
            return self._full(key, ecs, machines, "gate")

        # Assemble: clean x clean gathered from the cached plane, dirty
        # columns rebuilt over every row, dirty rows rebuilt over every
        # column.  Each cell is written exactly once or recomputed by
        # the model itself — bit-identical to the oracle by the
        # delta_plane contract.
        costs = np.empty((E, M), dtype=prev.costs.dtype)
        arc = (np.empty((E, M), dtype=prev.arc.dtype)
               if prev.arc is not None else None)
        row_mask = np.ones(E, dtype=bool)
        row_mask[dirty_rows] = False
        col_mask = np.ones(M, dtype=bool)
        col_mask[dirty_cols] = False
        clean_rows = np.nonzero(row_mask)[0]
        clean_cols = np.nonzero(col_mask)[0]
        if clean_rows.size and clean_cols.size:
            prev_rows = np.asarray(
                [prev.ec_pos[int(e)] for e in ecs.ec_ids[clean_rows]],
                dtype=np.int64,
            )
            prev_cols = np.asarray(
                [prev.uuid_pos[machines.uuids[int(j)]]
                 for j in clean_cols],
                dtype=np.int64,
            )
            costs[np.ix_(clean_rows, clean_cols)] = prev.costs[
                np.ix_(prev_rows, prev_cols)
            ]
            if arc is not None:
                arc[np.ix_(clean_rows, clean_cols)] = prev.arc[
                    np.ix_(prev_rows, prev_cols)
                ]
        if dirty_cols.size:
            sub = self.model.build(
                ecs, slice_machines(machines, dirty_cols)
            )
            costs[:, dirty_cols] = sub.costs
            if arc is not None:
                arc[:, dirty_cols] = sub.arc_capacity
        if dirty_rows.size:
            sub = self.model.build(slice_ecs(ecs, dirty_rows), machines)
            costs[dirty_rows, :] = sub.costs
            if arc is not None:
                arc[dirty_rows, :] = sub.arc_capacity

        cm = CostMatrices(
            costs=costs,
            unsched_cost=self.model.build_unsched(ecs),
            capacity=self.model.build_capacity(machines),
            arc_capacity=arc,
        )
        stats = self._stats(
            True, int(dirty_rows.size), int(dirty_cols.size), "delta"
        )
        stats["dirty_rows"] = dirty_rows
        stats["dirty_cols"] = dirty_cols
        self.last_stats = stats
        self._ledger_delta(key, ecs, machines, dirty_rows, dirty_cols)
        self._snapshot(key, ecs, machines, cm)
        return cm

    def _full(self, key: int, ecs: ECTable, machines: MachineTable,
              path: str) -> CostMatrices:
        cm = self.model.build(ecs, machines)
        self.last_stats = self._stats(False, 0, 0, path)
        self._ledger_broken(key)
        self._snapshot(key, ecs, machines, cm)
        return cm

    # ------------------------------------------------------------- dirtiness

    @staticmethod
    def _pod_presence(ecs: ECTable, machines: MachineTable) -> tuple:
        return (
            ecs.pod_affinity is not None,
            ecs.pod_anti_affinity is not None,
            ecs.labels is not None,
            machines.residents is not None,
            machines.cpu_obs_used is not None,
            machines.ram_obs_used is not None,
        )

    def _comparable(self, prev: _Plane, ecs: ECTable,
                    machines: MachineTable) -> bool:
        """Structural preconditions for a cell-level diff; a presence
        flip of any optional input (pod vocabulary, observed-load
        arrays, resident counts) changes whole terms of the cell
        function, so the oracle rebuild owns those rounds."""
        if prev.pod_presence != self._pod_presence(ecs, machines):
            return False
        res = machines.residents
        if res is not None:
            # Interner identity: compaction (or deactivate/reactivate)
            # installs new id dicts, remapping column meanings the
            # count-matrix diff below cannot see.
            if res.kv_id is not prev.res_kv_id:
                return False
            if res.key_id is not prev.res_key_id:
                return False
        return True

    def _dirty_rows(self, prev: _Plane,
                    ecs: ECTable) -> Optional[np.ndarray]:
        dirty: List[int] = []
        pos = prev.ec_pos
        labels = ecs.labels
        for i in range(ecs.num_ecs):
            j = pos.get(int(ecs.ec_ids[i]))
            if j is None:
                dirty.append(i)
                continue
            if labels is not None and labels[i] != prev.ec_labels[j]:
                # The representative member's labels feed the pod-
                # affinity bootstrap rule (and nothing else) — the EC id
                # does not hash them, so they are diffed directly.
                dirty.append(i)
        return np.asarray(dirty, dtype=np.int64)

    def _dirty_cols(self, prev: _Plane,
                    machines: MachineTable) -> Optional[np.ndarray]:
        M = machines.num_machines
        new_col = np.zeros(M, dtype=bool)
        prev_idx = np.empty(M, dtype=np.int64)
        pos = prev.uuid_pos
        for j, u in enumerate(machines.uuids):
            p = pos.get(u, -1)
            prev_idx[j] = p
            if p < 0:
                new_col[j] = True
        matched = np.nonzero(~new_col)[0]
        pj = prev_idx[matched]
        changed = np.zeros(matched.size, dtype=bool)

        arrays = self.model.delta_col_arrays(machines)
        if len(arrays) != len(prev.col_arrays):
            return None
        for (name, arr), (pname, parr) in zip(arrays, prev.col_arrays):
            if name != pname:
                return None
            if (arr is None) != (parr is None):
                return None  # presence flip: oracle rebuild
            if arr is None:
                continue
            changed |= np.asarray(arr)[matched] != parr[pj]

        # Machine labels: identity of the node-generation-cached label
        # index proves zero node mutations since the snapshot; otherwise
        # diff the dicts pairwise on the matched columns.
        if (machines.label_index is None
                or machines.label_index is not prev.label_index):
            mlabels = machines.labels
            pl = prev.mlabels
            for k in range(matched.size):
                if not changed[k] and (
                    mlabels[int(matched[k])] != pl[int(pj[k])]
                ):
                    changed[k] = True

        res = machines.residents
        if res is not None:
            changed |= self._res_diff(
                prev.res_kv, res.kv_counts, matched, pj
            )
            changed |= self._res_diff(
                prev.res_key, res.key_counts, matched, pj
            )
            changed |= res.total[matched] != prev.res_total[pj]

        dirty = np.zeros(M, dtype=bool)
        dirty[new_col] = True
        dirty[matched[changed]] = True
        return np.nonzero(dirty)[0]

    @staticmethod
    def _res_diff(prev_mat: np.ndarray, now_mat: np.ndarray,
                  matched: np.ndarray, pj: np.ndarray) -> np.ndarray:
        """Row-wise count-matrix diff tolerant of width growth: a column
        minted after the snapshot reads as zero there (exactly the
        semantics the mask evaluators give ids past the view width)."""
        wp, wn = prev_mat.shape[1], now_mat.shape[1]
        w = min(wp, wn)
        changed = (now_mat[matched][:, :w] != prev_mat[pj][:, :w]).any(
            axis=1
        )
        if wn > w:
            changed |= (now_mat[matched][:, w:] != 0).any(axis=1)
        if wp > w:
            changed |= (prev_mat[pj][:, w:] != 0).any(axis=1)
        return changed

    # -------------------------------------------------------------- snapshot

    def _snapshot(self, key: int, ecs: ECTable, machines: MachineTable,
                  cm: CostMatrices) -> None:
        p = _Plane()
        p.ec_ids = ecs.ec_ids.copy()
        p.ec_pos = {int(e): i for i, e in enumerate(ecs.ec_ids)}
        p.ec_labels = (
            [dict(d) if d else d for d in ecs.labels]
            if ecs.labels is not None else None
        )
        p.pod_presence = self._pod_presence(ecs, machines)
        p.uuids = list(machines.uuids)
        p.uuid_pos = {u: j for j, u in enumerate(machines.uuids)}
        p.col_arrays = [
            (name, None if arr is None else np.asarray(arr).copy())
            for name, arr in self.model.delta_col_arrays(machines)
        ]
        p.label_index = machines.label_index
        p.mlabels = [dict(d) if d else d for d in machines.labels]
        res = machines.residents
        if res is not None:
            p.res_kv_id = res.kv_id
            p.res_key_id = res.key_id
            p.res_kv = res.kv_counts.copy()
            p.res_key = res.key_counts.copy()
            p.res_total = res.total.copy()
        else:
            p.res_kv_id = p.res_key_id = None
            p.res_kv = p.res_key = p.res_total = None
        p.costs = cm.costs
        p.arc = cm.arc_capacity
        self._bands[key] = p

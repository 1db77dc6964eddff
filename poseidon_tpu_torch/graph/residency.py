"""Interned resident-label count matrices for pod-level (anti-)affinity.

The old path evaluated every distinct pod-affinity selector with a
per-machine Python generator over per-machine resident-label dicts —
O(distinct_selectors x M) dict probes (~10M per round at the 10k-machine
bench rung) — and rebuilt the resident aggregates

from task state every round.  This module replaces both halves:

- ``ResidentLabelIndex``: the *live* index held by the graph state
  layer.  Resident (key, value) pairs and keys are interned into dense
  column-id spaces, and per-machine resident counts are maintained as
  ``[R, K]`` int32 matrices (plus a per-machine total), updated by
  deltas as tasks RUN / complete / are PREEMPTed — never rebuilt per
  round.  Machine rows are minted on first use and recycled on machine
  removal; dead label columns are compacted away once they dominate.

- ``ResidentCounts``: one round's immutable view — the count matrices
  gathered into the round's machine-column order.  Each selector then
  evaluates as O(1) vectorized numpy reductions over columns
  (``costmodel/selectors.pod_selector_admissibility``), with zero
  per-machine Python.

- ``MachineLabelIndex``: the same interning applied to *machine*
  labels for node-selector admissibility — built once per node
  generation (graph/state caches it keyed on a node-mutation counter),
  so unchanged node labels never re-intern across rounds.

Determinism: the interning path iterates only insertion-ordered dicts
and lists (never bare sets), so column ids — and therefore every
derived matrix — are identical across runs given the same mutation
order (the posecheck determinism contract for graph/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from poseidon_tpu_torch.utils.numerics import widen_counts

# Compact the (key, value) column space once it exceeds this many
# columns AND dead (zero-count) columns are the majority: long-running
# churn with rolling label vocabularies (version=v123, ...) must not
# grow the matrices without bound.
_COMPACT_MIN_COLS = 1024


@dataclass
class ResidentCounts:
    """One round's resident-label aggregates, machine-column order.

    ``kv_counts[m, kv_id[(k, v)]]`` = residents on machine m carrying
    label k=v; ``key_counts[m, key_id[k]]`` = residents carrying key k;
    ``total[m]`` = all residents (labelled or not).  The id dicts are
    snapshots: ids >= the matrix width (minted after this view was
    gathered) are treated as absent by the mask evaluators.

    The count matrices arrive WIDENED to int64 through
    ``utils.numerics.widen_counts``: the live index accumulates int32
    (delta adds on the mutation hot path), and the once-per-round view
    gather is where the saturation certificate is checked — a cell
    outside the headroom band raises instead of letting downstream
    selector reductions consume a wrapped count.
    """

    kv_counts: np.ndarray               # int64 [M, Kkv] (widened, certified)
    key_counts: np.ndarray              # int64 [M, Kkey] (widened, certified)
    total: np.ndarray                   # int64 [M]
    kv_id: Dict[Tuple[str, str], int]
    key_id: Dict[str, int]

    @property
    def num_machines(self) -> int:
        return int(self.total.shape[0])


class ResidentLabelIndex:
    """Incrementally-maintained resident counts, keyed by machine uuid.

    Inactive (the default) it is a no-op shell: the graph state layer
    activates it the first time a round actually carries pod-level
    selectors (one O(tasks) rebuild), maintains it by deltas from then
    on, and deactivates it when the last pod-selector task leaves.
    Callers hold the ClusterState lock for every mutation and view.
    """

    def __init__(self) -> None:
        self.active = False
        self._clear()

    def _clear(self) -> None:
        self.kv_id: Dict[Tuple[str, str], int] = {}
        self.key_id: Dict[str, int] = {}
        self._row_of: Dict[str, int] = {}
        self._free_rows: List[int] = []      # LIFO; deterministic reuse
        self._nrows = 0                      # high-water row count
        self._kv = np.zeros((0, 0), dtype=np.int32)
        self._key = np.zeros((0, 0), dtype=np.int32)
        self._total = np.zeros(0, dtype=np.int64)
        # Per-column count sums: O(1) dead-column tracking for the
        # compaction trigger.
        self._kv_colsum = np.zeros(0, dtype=np.int64)
        self._kv_dead = 0

    # ------------------------------------------------------------ lifecycle

    def activate(self) -> None:
        self.active = True

    def deactivate(self) -> None:
        self.active = False
        self._clear()

    # ------------------------------------------------------------ row space

    def row(self, machine_uuid: str) -> int:
        """Row id for a machine, minted on first use (zero counts)."""
        r = self._row_of.get(machine_uuid)
        if r is None:
            if self._free_rows:
                r = self._free_rows.pop()
            else:
                r = self._nrows
                self._nrows += 1
                if r >= self._total.shape[0]:
                    self._grow_rows(max(64, 2 * self._nrows))
            self._row_of[machine_uuid] = r
        return r

    def machine_removed(self, machine_uuid: str) -> None:
        """Free a machine's row (tasks must already be evicted)."""
        r = self._row_of.pop(machine_uuid, None)
        if r is None:
            return
        if self._kv.shape[1]:
            live = self._kv[r, :] != 0
            if live.any():
                cols = np.nonzero(live)[0]
                self._kv_colsum[cols] -= self._kv[r, cols]
                self._kv_dead += int((self._kv_colsum[cols] == 0).sum())
            self._kv[r, :] = 0
        if self._key.shape[1]:
            self._key[r, :] = 0
        self._total[r] = 0
        self._free_rows.append(r)

    def _grow_rows(self, rows: int) -> None:
        def grow(arr, fill_rows):
            out = np.zeros((fill_rows, arr.shape[1]), dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        self._kv = grow(self._kv, rows)
        self._key = grow(self._key, rows)
        total = np.zeros(rows, dtype=np.int64)
        total[: self._total.shape[0]] = self._total
        self._total = total

    # --------------------------------------------------------- column space

    def _kv_col(self, key: str, value: str) -> int:
        c = self.kv_id.get((key, value))
        if c is None:
            c = len(self.kv_id)
            self.kv_id[(key, value)] = c
            if c >= self._kv.shape[1]:
                self._kv = self._grow_cols(self._kv, max(16, 2 * (c + 1)))
            if c >= self._kv_colsum.shape[0]:
                colsum = np.zeros(self._kv.shape[1], dtype=np.int64)
                colsum[: self._kv_colsum.shape[0]] = self._kv_colsum
                self._kv_colsum = colsum
            self._kv_dead += 1  # minted dead; the first +1 revives it
        return c

    def _key_col(self, key: str) -> int:
        c = self.key_id.get(key)
        if c is None:
            c = len(self.key_id)
            self.key_id[key] = c
            if c >= self._key.shape[1]:
                self._key = self._grow_cols(self._key, max(16, 2 * (c + 1)))
        return c

    @staticmethod
    def _grow_cols(arr: np.ndarray, cols: int) -> np.ndarray:
        out = np.zeros((arr.shape[0], cols), dtype=arr.dtype)
        out[:, : arr.shape[1]] = arr
        return out

    def _maybe_compact(self) -> None:
        """Drop dead (zero-count) kv columns once they are the majority
        of a large column space.  Rebuilds the interner in insertion
        order (deterministic); existing ``ResidentCounts`` views keep
        their own snapshot dicts/arrays and are unaffected."""
        ncols = len(self.kv_id)
        if ncols < _COMPACT_MIN_COLS or self._kv_dead * 2 < ncols:
            return
        new_id: Dict[Tuple[str, str], int] = {}
        keep: List[int] = []
        for pair, c in self.kv_id.items():
            if self._kv_colsum[c] > 0:
                new_id[pair] = len(new_id)
                keep.append(c)
        kept = np.asarray(keep, dtype=np.int64)
        kv = np.zeros(
            (self._kv.shape[0], max(16, 2 * max(len(keep), 1))),
            dtype=np.int32,
        )
        if kept.size:
            kv[:, : kept.size] = self._kv[:, kept]
        colsum = np.zeros(kv.shape[1], dtype=np.int64)
        if kept.size:
            colsum[: kept.size] = self._kv_colsum[kept]
        self.kv_id = new_id
        self._kv = kv
        self._kv_colsum = colsum
        self._kv_dead = 0

    # -------------------------------------------------------------- updates

    def add(self, machine_uuid: str, labels: Dict[str, str]) -> None:
        """A task became resident on this machine."""
        r = self.row(machine_uuid)
        self._total[r] += 1
        if labels:
            self._apply_labels(r, labels, 1)

    def remove(self, machine_uuid: str, labels: Dict[str, str]) -> None:
        """A resident task left this machine (complete/PREEMPT/remove)."""
        r = self.row(machine_uuid)
        self._total[r] -= 1
        if labels:
            self._apply_labels(r, labels, -1)
            self._maybe_compact()

    def relabel(self, machine_uuid: str, old: Dict[str, str],
                new: Dict[str, str]) -> None:
        """A resident task's labels changed in place (TaskUpdated)."""
        r = self.row(machine_uuid)
        if old:
            self._apply_labels(r, old, -1)
        if new:
            self._apply_labels(r, new, 1)
        if old:
            self._maybe_compact()

    def _apply_labels(self, r: int, labels: Dict[str, str],
                      delta: int) -> None:
        for k, v in labels.items():
            # Mint columns BEFORE indexing: the minting helpers may
            # replace the matrices with grown copies.
            c = self._kv_col(k, v)
            ck = self._key_col(k)
            before = self._kv_colsum[c]
            self._kv[r, c] += delta
            self._kv_colsum[c] = after = before + delta
            if delta > 0 and before == 0:
                self._kv_dead -= 1
            elif delta < 0 and after == 0:
                self._kv_dead += 1
            self._key[r, ck] += delta

    def bump_totals(self, dec_rows: Sequence[int],
                    inc_rows: Sequence[int]) -> None:
        """Batched total updates for label-less transitions (the
        100k-placement wave commit: two fused scatter-adds instead of
        one scalar op per task)."""
        if dec_rows:
            np.subtract.at(self._total, dec_rows, 1)
        if inc_rows:
            np.add.at(self._total, inc_rows, 1)

    # ----------------------------------------------------------------- view

    def view(self, machine_uuids: Sequence[str]) -> ResidentCounts:
        """Gather the live matrices into round machine-column order.

        The result is a copy: later index mutations (or compactions)
        never disturb a round already in flight.  The int32 count
        gathers are widened to int64 through the saturation certificate
        (utils.numerics.widen_counts): the per-round boundary where an
        accumulation wrap is ruled out, so the int32 delta adds on the
        mutation hot path never need per-add checks."""
        rows = np.fromiter(
            (self.row(u) for u in machine_uuids),
            dtype=np.int64, count=len(machine_uuids),
        )
        nkv = len(self.kv_id)
        nkey = len(self.key_id)
        return ResidentCounts(
            kv_counts=widen_counts(
                self._kv[np.ix_(rows, np.arange(nkv))],
                site="residency.kv_counts",
            ),
            key_counts=widen_counts(
                self._key[np.ix_(rows, np.arange(nkey))],
                site="residency.key_counts",
            ),
            total=self._total[rows],
            kv_id=self.kv_id,
            key_id=self.key_id,
        )


@dataclass
class MachineLabelIndex:
    """Interned machine labels for node-selector admissibility.

    ``kv_mask[m, kv_id[(k, v)]]`` iff machine m carries label k=v;
    ``key_mask[m, key_id[k]]`` iff it carries key k.  Built once per
    node generation from the round's machine-label dicts; each distinct
    selector then evaluates as one vectorized column reduction instead
    of an O(M) Python probe loop.
    """

    kv_id: Dict[Tuple[str, str], int]
    key_id: Dict[str, int]
    kv_mask: np.ndarray                 # bool [M, Kkv]
    key_mask: np.ndarray                # bool [M, Kkey]

    @classmethod
    def build(cls, machine_labels: Sequence[Dict[str, str]]
              ) -> "MachineLabelIndex":
        kv_id: Dict[Tuple[str, str], int] = {}
        key_id: Dict[str, int] = {}
        kv_rows: List[int] = []
        kv_cols: List[int] = []
        key_rows: List[int] = []
        key_cols: List[int] = []
        for m, labels in enumerate(machine_labels):
            for k, v in labels.items():
                c = kv_id.get((k, v))
                if c is None:
                    c = len(kv_id)
                    kv_id[(k, v)] = c
                kv_rows.append(m)
                kv_cols.append(c)
                ck = key_id.get(k)
                if ck is None:
                    ck = len(key_id)
                    key_id[k] = ck
                key_rows.append(m)
                key_cols.append(ck)
        M = len(machine_labels)
        kv_mask = np.zeros((M, len(kv_id)), dtype=bool)
        key_mask = np.zeros((M, len(key_id)), dtype=bool)
        if kv_rows:
            kv_mask[kv_rows, kv_cols] = True
            key_mask[key_rows, key_cols] = True
        return cls(kv_id=kv_id, key_id=key_id,
                   kv_mask=kv_mask, key_mask=key_mask)

"""Vectorized label-selector admissibility.

Turns the IN_SET / NOT_IN_SET / EXISTS_KEY / NOT_EXISTS_KEY selector
vocabulary (reference label_selector.proto:23-34; produced from K8s
nodeSelector maps by the pod watcher, podwatcher.go:455-465) into a boolean
``[E, M]`` admissibility mask without per-(EC, machine) Python loops.

Two evaluation engines exist for each mask:

- the *interned* engine (default in production): machine labels and
  resident-task labels are interned into dense column-id spaces
  (graph/residency.py — the machine-label index is cached across rounds
  keyed on the node generation; the resident-count matrices are
  maintained incrementally by the graph state layer), and each distinct
  selector is O(1) vectorized column reductions over those matrices;
- the *oracle* engine (the original per-machine dict-probe
  implementation): kept verbatim as the semantics reference — the
  randomized parity suite (tests/test_mask_engine.py) pins the interned
  engine bit-identical to it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # import-free at runtime (no graph <-> costmodel cycle)
    from poseidon_tpu_torch.graph.residency import (
        MachineLabelIndex,
        ResidentCounts,
    )

# Selector type codes, matching LabelSelector.SelectorType wire values.
IN_SET = 0
NOT_IN_SET = 1
EXISTS_KEY = 2
NOT_EXISTS_KEY = 3

Selector = Tuple[int, str, Tuple[str, ...]]


def selector_admissibility(
    ec_selectors: Sequence[Tuple[Selector, ...]],
    machine_labels: Sequence[Dict[str, str]],
    label_index: Optional["MachineLabelIndex"] = None,
) -> np.ndarray:
    """Boolean [E, M]: True where EC e may run on machine m.

    Semantics per selector (all must hold — conjunction, as with K8s
    nodeSelector):
      IN_SET:         machine has key and its value is in `values`
      NOT_IN_SET:     machine lacks key, or its value is not in `values`
      EXISTS_KEY:     machine has key
      NOT_EXISTS_KEY: machine lacks key

    With ``label_index`` (an interned view of the SAME ``machine_labels``)
    each distinct selector evaluates as one vectorized column reduction;
    without it, the per-machine probe loop runs (the oracle engine).
    """
    E = len(ec_selectors)
    M = len(machine_labels)
    mask = np.ones((E, M), dtype=bool)
    if E == 0 or M == 0:
        return mask

    # Distinct selectors across ECs (jobs share selector sets, so this is
    # tiny); evaluate each once over all machines.
    distinct: Dict[Selector, np.ndarray] = {}
    for sels in ec_selectors:
        for sel in sels:
            if sel not in distinct:
                distinct[sel] = (
                    _eval_selector_interned(sel, label_index)
                    if label_index is not None
                    else _eval_selector(sel, machine_labels)
                )

    for e, sels in enumerate(ec_selectors):
        for sel in sels:
            mask[e] &= distinct[sel]
    return mask


def _matches(labels: Dict[str, str], sel: Selector) -> bool:
    """Does one task's label map satisfy a selector?  K8s matchExpressions
    semantics: NotIn/NotExists also match objects lacking the key."""
    stype, key, values = sel
    if stype == IN_SET:
        return labels.get(key) in set(values)
    if stype == NOT_IN_SET:
        return labels.get(key) not in set(values)
    if stype == EXISTS_KEY:
        return key in labels
    if stype == NOT_EXISTS_KEY:
        return key not in labels
    raise ValueError(f"unknown selector type {stype}")


def _kv_cols(key: str, values, kv_id: Dict[Tuple[str, str], int],
             width: int) -> List[int]:
    """Interned column ids for (key, v) pairs, deduplicated in value
    order (dict.fromkeys — never bare-set iteration: column order must
    be run-stable) and clamped to the view's matrix width (ids minted
    after a view was gathered are absent from it by construction)."""
    cols = []
    for v in dict.fromkeys(values):
        c = kv_id.get((key, v))
        if c is not None and c < width:
            cols.append(c)
    return cols


def pod_selector_admissibility(
    ec_pod_affinity,
    ec_pod_anti_affinity,
    ec_labels,
    residents: Optional["ResidentCounts"],
) -> np.ndarray:
    """Boolean [E, M] mask from pod-level (anti-)affinity — interned
    engine.

    Semantics (K8s podAffinity, machine = topology domain; resolved over
    rounds against *running* residents):

    - affinity: for every selector, some resident task must satisfy it —
      unless the EC's own labels satisfy the selector (the first-pod
      bootstrap rule: a self-selecting group may start anywhere);
    - anti-affinity: no resident task may satisfy any selector.

    ``residents`` is the round's ResidentCounts view (incrementally
    maintained count matrices); each distinct selector is O(1)
    vectorized reductions over its columns — no per-machine Python.
    """
    E = len(ec_pod_affinity)
    M = residents.num_machines if residents is not None else 0
    mask = np.ones((E, M), dtype=bool)
    if E == 0 or M == 0 or residents is None:
        return mask

    cache: Dict[Selector, np.ndarray] = {}

    def per_machine(sel: Selector) -> np.ndarray:
        got = cache.get(sel)
        if got is None:
            got = _eval_resident_selector(sel, residents)
            cache[sel] = got
        return got

    for e in range(E):
        own = ec_labels[e] if ec_labels is not None else {}
        for sel in ec_pod_affinity[e]:
            if _matches(own, sel):
                continue  # self-satisfying: bootstrap anywhere
            mask[e] &= per_machine(sel)
        for sel in ec_pod_anti_affinity[e]:
            mask[e] &= ~per_machine(sel)
    return mask


def _eval_resident_selector(
    sel: Selector, rc: "ResidentCounts"
) -> np.ndarray:
    """bool [M]: does SOME resident on machine m satisfy the selector?
    Bit-identical to the oracle's per-machine dict probes: the count
    matrices hold exactly the aggregates the dicts held."""
    stype, key, values = sel
    M = rc.num_machines
    if stype == IN_SET:
        cols = _kv_cols(key, values, rc.kv_id, rc.kv_counts.shape[1])
        if not cols:
            return np.zeros(M, dtype=bool)
        return rc.kv_counts[:, cols].sum(axis=1, dtype=np.int64) > 0
    if stype == EXISTS_KEY:
        c = rc.key_id.get(key)
        if c is None or c >= rc.key_counts.shape[1]:
            return np.zeros(M, dtype=bool)
        return rc.key_counts[:, c] > 0
    if stype == NOT_IN_SET:
        cols = _kv_cols(key, values, rc.kv_id, rc.kv_counts.shape[1])
        matching = (
            rc.kv_counts[:, cols].sum(axis=1, dtype=np.int64)
            if cols else 0
        )
        return rc.total - matching > 0
    if stype == NOT_EXISTS_KEY:
        c = rc.key_id.get(key)
        have = (
            rc.key_counts[:, c].astype(np.int64)
            if c is not None and c < rc.key_counts.shape[1] else 0
        )
        return rc.total - have > 0
    raise ValueError(f"unknown selector type {stype}")


def pod_selector_admissibility_dicts(
    ec_pod_affinity,
    ec_pod_anti_affinity,
    ec_labels,
    resident_kv,
    resident_key,
    resident_total,
) -> np.ndarray:
    """The ORACLE engine: per-machine dict-probe evaluation over
    per-machine resident-label aggregates ((key,value)->count,
    key->count, total).  O(distinct_selectors x M) Python probes — kept
    as the semantics reference the parity suite pins the interned
    engine against, and for callers holding plain dict aggregates."""
    E = len(ec_pod_affinity)
    M = len(resident_kv) if resident_kv is not None else 0
    mask = np.ones((E, M), dtype=bool)
    if E == 0 or M == 0 or resident_kv is None:
        return mask

    def exists_satisfying(m: int, sel: Selector) -> bool:
        stype, key, values = sel
        kv = resident_kv[m]
        kk = resident_key[m]
        total = int(resident_total[m])
        if stype == IN_SET:
            return any(kv.get((key, v), 0) > 0 for v in values)
        if stype == EXISTS_KEY:
            return kk.get(key, 0) > 0
        if stype == NOT_IN_SET:
            matching = sum(kv.get((key, v), 0) for v in set(values))
            return total - matching > 0
        if stype == NOT_EXISTS_KEY:
            return total - kk.get(key, 0) > 0
        raise ValueError(f"unknown selector type {stype}")

    cache: Dict[Selector, np.ndarray] = {}

    def per_machine(sel: Selector) -> np.ndarray:
        got = cache.get(sel)
        if got is None:
            got = np.fromiter(
                (exists_satisfying(m, sel) for m in range(M)),
                dtype=bool, count=M,
            )
            cache[sel] = got
        return got

    for e in range(E):
        own = ec_labels[e] if ec_labels is not None else {}
        for sel in ec_pod_affinity[e]:
            if _matches(own, sel):
                continue  # self-satisfying: bootstrap anywhere
            mask[e] &= per_machine(sel)
        for sel in ec_pod_anti_affinity[e]:
            mask[e] &= ~per_machine(sel)
    return mask


def _eval_selector_interned(
    sel: Selector, li: "MachineLabelIndex"
) -> np.ndarray:
    stype, key, values = sel
    M = li.key_mask.shape[0]
    if stype in (EXISTS_KEY, NOT_EXISTS_KEY):
        c = li.key_id.get(key)
        has_key = (
            li.key_mask[:, c] if c is not None
            else np.zeros(M, dtype=bool)
        )
        return has_key if stype == EXISTS_KEY else ~has_key
    cols = _kv_cols(key, values, li.kv_id, li.kv_mask.shape[1])
    in_set = (
        li.kv_mask[:, cols].any(axis=1) if cols
        else np.zeros(M, dtype=bool)
    )
    if stype == IN_SET:
        return in_set
    if stype == NOT_IN_SET:
        return ~in_set
    raise ValueError(f"unknown selector type {stype}")


def _eval_selector(
    sel: Selector, machine_labels: Sequence[Dict[str, str]]
) -> np.ndarray:
    """Oracle engine for machine-label selectors: O(M) per-machine
    probes (the parity reference for ``_eval_selector_interned``)."""
    stype, key, values = sel
    M = len(machine_labels)
    has_key = np.fromiter(
        (key in lb for lb in machine_labels), dtype=bool, count=M
    )
    if stype == EXISTS_KEY:
        return has_key
    if stype == NOT_EXISTS_KEY:
        return ~has_key
    vset = set(values)
    in_set = np.fromiter(
        (lb.get(key) in vset for lb in machine_labels), dtype=bool, count=M
    )
    if stype == IN_SET:
        return in_set
    if stype == NOT_IN_SET:
        return ~in_set
    raise ValueError(f"unknown selector type {stype}")

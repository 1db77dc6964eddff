"""Equivalence-class derivation.

Firmament's scalability trick is the task -> equivalence class -> resource
middle layer (SURVEY.md section 2.2, BASELINE.json north star): all tasks
with identical scheduling-relevant attributes share one EC node, so the
flow network's size scales with the number of *distinct* task shapes, not
the number of tasks.  The EC id is a deterministic 64-bit hash of the
canonicalized attributes (stable across rounds and process restarts, like
every other id in the system — see utils/ids.py).
"""

from __future__ import annotations

from typing import Tuple

from poseidon_tpu_torch.utils.ids import fnv64a, hash_combine

Selector = Tuple[int, str, Tuple[str, ...]]


def ec_signature(
    cpu_request: int,
    ram_request: int,
    selectors: Tuple[Selector, ...],
    task_type: int,
    priority: int,
    net_rx_request: int = 0,
    gang_job: str = "",
) -> int:
    """64-bit EC id for a task's scheduling-relevant attributes.

    Attribute choice mirrors what the cost models can distinguish: the
    request vector's CPU/mem/net dimensions, the selector set (canonically
    sorted), the interference task type (task_desc.proto:45-50) and
    priority.  Tasks differing only in name/labels/owner land in the same
    EC by design — EXCEPT gang members: a gang job contributes its job id,
    giving each gang its own EC row so all-or-nothing placement is a
    per-row property of the flow solution (the flow-gadget analog of
    Firmament's job-level min-flow requirements).

    Pod-level (anti-)affinity selectors DO partition ECs (the caller
    prefixes them into ``selectors`` — see TaskInfo.compute_ec_id), but
    task labels still don't: the constraint-mask engine evaluates the
    self-satisfying bootstrap rule against the EC's *representative*
    member's labels, so co-EC tasks whose labels differ in ways a
    shared pod selector can see would bootstrap incorrectly.  In
    practice the watcher derives pod selectors from the same label
    vocabulary, so selector-identical tasks are label-compatible; keep
    that invariant if a new ingest path mints pod selectors.
    """
    h = fnv64a("ec")
    h = hash_combine(h, int(cpu_request))
    h = hash_combine(h, int(ram_request))
    h = hash_combine(h, int(net_rx_request))
    h = hash_combine(h, int(task_type))
    h = hash_combine(h, int(priority))
    if gang_job:
        h = hash_combine(h, "gang:" + gang_job)
    for stype, key, values in sorted(selectors):
        h = hash_combine(h, int(stype))
        h = hash_combine(h, key)
        for v in sorted(values):
            h = hash_combine(h, v)
    return h


def canonical_selectors(label_selectors) -> Tuple[Selector, ...]:
    """Canonicalize proto LabelSelector messages into hashable tuples."""
    out = []
    for sel in label_selectors:
        out.append((int(sel.type), sel.key, tuple(sorted(sel.values))))
    return tuple(sorted(out))

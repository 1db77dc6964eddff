"""shard-discipline: the sharded solve's collectives, padding and warm-up.

The port's counterpart of ``poseidon_tpu/check/shard_discipline.py``,
over the block ladder of ``ops/transport.py`` and the sharded front of
``ops/transport_sharded.py``.  The port's mesh is a list of
``torch.device``s with no named axes: each shard holds its column block
of the ``[E, M]`` planes on its own device, and every reduction over the
machine axis is an explicit collective over per-block partials
(``_Collectives``: ``reduce``, ``scan``, ``gather``).  The failure
modes are sharding-specific and silent on one device, where every shard
sees the same numbers:

- a per-shard machine-axis reduction (``.sum(1)``, ``cumsum(..., 1)``,
  ``.amax(1)``, ...) whose partial never reaches a collective is a
  shard-local answer used as the global one — right with one shard,
  wrong with two;
- a function that cuts the machine axis into per-shard blocks without a
  visible pad-to-mesh-multiple (``((m + k - 1) // k) * k``) or a
  ``% k == 0`` guard drops or misaligns the tail columns when ``k`` does
  not divide ``M``;
- a sharded solve key (``note_solve_key`` in a module that builds
  ``_Collectives``) outside the precompile closure meets its first key
  in a live round.

Mesh scope is any function that touches a collective receiver: a name
bound to ``_Collectives(...)``, or a parameter, name or attribute called
``coll``.  The reduction sub-check judges those functions; a partial
counts as reduced when the reduction sits inside a collective call's
arguments, or is bound to a name a collective call of the same function
reads.  Files that touch no collective are not judged for padding.  The
reachability sub-check reuses dispatch-budget's seeds and closure and
honors both ``ignore[shard-discipline]`` and ``ignore[dispatch-budget]``
on the def line.

The reference's axis-name sub-checks (a collective or a
``PartitionSpec`` naming an axis no mesh declares) have no torch
meaning: the port's mesh has no axis names to get wrong.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    suppressions,
)
from poseidon_tpu_torch.check.dispatch_budget import (
    _referenced_names,
    notes_solve_key,
    reach,
)
from poseidon_tpu_torch.check.jit_purity import function_units

# Reductions that, taken over axis 1 of a shard's [E, Mb] block, reduce
# over the machine axis.
_REDUCTIONS = frozenset({
    "sum", "cumsum", "amax", "amin", "any", "all", "max", "min", "prod",
    "cumprod", "mean", "logsumexp",
})
_MACHINE_AXES = (1, -1)
# Calls that cut an axis into per-shard pieces.
_SPLITTERS = frozenset({"chunk", "tensor_split", "array_split"})


def _ceil_multiple_present(fn: ast.AST) -> bool:
    """True when the function body contains a visible pad-to-multiple
    computation: ``((a + b - 1) // b) * b``, ``-(-a // b) * b``, or an
    explicit ``% b == 0`` / ``% b != 0`` divisibility guard."""
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for a in (node.left, node.right):
                if isinstance(a, ast.UnaryOp):
                    a = a.operand
                if isinstance(a, ast.BinOp) and isinstance(
                    a.op, ast.FloorDiv
                ):
                    return True
        if isinstance(node, ast.Compare) and isinstance(
            node.left, ast.BinOp
        ) and isinstance(node.left.op, ast.Mod):
            if any(
                isinstance(c, ast.Constant) and c.value == 0
                for c in node.comparators
            ):
                return True
    return False


def _axis_of(call: ast.Call, pos: int) -> Optional[int]:
    """The integer axis of a reduction call: positional ``pos`` or the
    ``dim=``/``axis=`` keyword."""
    val = call.args[pos] if len(call.args) > pos else None
    for kw in call.keywords:
        if kw.arg in ("dim", "axis"):
            val = kw.value
    if isinstance(val, ast.UnaryOp) and isinstance(val.op, ast.USub) and \
            isinstance(val.operand, ast.Constant):
        return -val.operand.value
    if isinstance(val, ast.Constant) and isinstance(val.value, int):
        return val.value
    return None


def _machine_reduction(node: ast.Call) -> Optional[str]:
    """The reduction's name when ``node`` reduces over axis 1 (or -1):
    ``x.sum(1)`` or ``torch.cumsum(x, 1)``."""
    if not isinstance(node.func, ast.Attribute):
        return None
    op = node.func.attr
    if op not in _REDUCTIONS:
        return None
    head = dotted_name(node.func.value)
    pos = 1 if head in ("torch", "np", "numpy") else 0
    if _axis_of(node, pos) in _MACHINE_AXES:
        return op
    return None


def _per_shard_slice(node: ast.AST) -> bool:
    """``a[..., j * B:(j + 1) * B]``: a slice whose bounds are both
    products (one shard's block of an axis)."""
    if not isinstance(node, ast.Slice):
        return False

    def is_mult(v):
        return isinstance(v, ast.BinOp) and isinstance(v.op, ast.Mult)

    return is_mult(node.lower) and is_mult(node.upper)


@dataclass
class _FileFacts:
    path: str
    # function name -> referenced names (for the precompile closure)
    refs: Dict[str, Set[str]] = field(default_factory=dict)
    defs: Set[str] = field(default_factory=set)
    # sharded solve-key holders: name -> lineno
    sharded_keys: Dict[str, int] = field(default_factory=dict)
    # lines suppressed for this rule OR dispatch-budget
    suppressed: Set[int] = field(default_factory=set)
    # unreduced machine-axis reductions: (lineno, op, fn name)
    unreduced: List[Tuple[int, str, str]] = field(default_factory=list)
    # functions cutting per-shard blocks without a visible pad:
    # (lineno, fn name)
    unpadded: List[Tuple[int, str]] = field(default_factory=list)


class ShardDisciplineRule(Rule):
    name = "shard-discipline"
    # Facts collect everywhere (the precompile seeds live in graph/ and
    # service/); findings are only made under the flag fragments, and
    # only in modules that touch a collective.
    scopes: tuple = ()

    _SEED_NAMES = ("precompile", "ensure_precompiled")

    def __init__(self, flag_fragments=("poseidon_tpu_torch/",)) -> None:
        self._flag_fragments = tuple(flag_fragments)
        self._files: List[_FileFacts] = []
        self._dir_roots = None

    def begin(self, paths: Sequence[str]) -> None:
        # Same partial-graph posture as dispatch-budget: reachability is
        # only judged for files under a directory scan root.
        from pathlib import Path

        self._dir_roots = [
            Path(p).resolve() for p in paths if Path(p).is_dir()
        ]

    # ---------------------------------------------------------------- check

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        facts = _FileFacts(path=path)
        for lineno, rules in suppressions(source).items():
            if rules is None or rules & {self.name, "dispatch-budget"}:
                facts.suppressed.add(lineno)

        receivers = {"coll"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and (dotted_name(node.value.func) or "").rpartition(".")[2] \
                    == "_Collectives":
                receivers.update(
                    t.id for t in node.targets if isinstance(t, ast.Name)
                )

        def is_receiver(v: ast.AST) -> bool:
            if isinstance(v, ast.Name):
                return v.id in receivers
            return isinstance(v, ast.Attribute) and v.attr == "coll"

        def is_collective(call: ast.Call) -> bool:
            return isinstance(call.func, ast.Attribute) and is_receiver(
                call.func.value
            )

        def touches_collective(fn: ast.AST) -> bool:
            for n in ast.walk(fn):
                if isinstance(n, ast.arg) and n.arg in receivers:
                    return True
                if isinstance(n, (ast.Name, ast.Attribute)) and \
                        is_receiver(n):
                    return True
            return False

        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                facts.defs.add(node.name)
                facts.refs.setdefault(node.name, set()).update(
                    _referenced_names(node)
                )
            elif isinstance(node, ast.ClassDef):
                # As in dispatch-budget: a class reaches what constructing
                # and calling an instance runs.
                facts.defs.add(node.name)
                for s in node.body:
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and s.name in ("__init__", "__call__"):
                        facts.refs.setdefault(node.name, set()).update(
                            _referenced_names(s)
                        )
        units = function_units(tree)
        mesh_units = [fn for fn in units if touches_collective(fn)]
        if not mesh_units:
            self._files.append(facts)
            return []

        for fn in units:
            if notes_solve_key(fn):
                facts.sharded_keys[fn.name] = fn.lineno
            if any(
                _per_shard_slice(n) or (
                    isinstance(n, ast.Call)
                    and (dotted_name(n.func) or "").rpartition(".")[2]
                    in _SPLITTERS
                )
                for n in ast.walk(fn)
            ) and not _ceil_multiple_present(fn):
                facts.unpadded.append((fn.lineno, fn.name))
        for fn in mesh_units:
            self._collect_unreduced(fn, is_collective, facts)
        self._files.append(facts)
        return []

    @staticmethod
    def _collect_unreduced(fn, is_collective, facts: _FileFacts) -> None:
        reduced: Set[int] = set()
        fed: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and is_collective(n):
                for a in list(n.args) + [k.value for k in n.keywords]:
                    for sub in ast.walk(a):
                        reduced.add(id(sub))
                        if isinstance(sub, ast.Name):
                            fed.add(sub.id)
        for stmt in ast.walk(fn):
            if not isinstance(stmt, (ast.Assign, ast.Return, ast.Expr,
                                     ast.AugAssign, ast.AnnAssign)):
                continue
            targets: Set[str] = set()
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    targets.update(
                        e.id for e in ast.walk(t) if isinstance(e, ast.Name)
                    )
            value = getattr(stmt, "value", None)
            if value is None:
                continue
            for n in ast.walk(value):
                if not isinstance(n, ast.Call) or id(n) in reduced:
                    continue
                op = _machine_reduction(n)
                if op is None or targets & fed:
                    continue
                facts.unreduced.append((n.lineno, op, fn.name))

    # ------------------------------------------------------------- finalize

    def _judgeable(self, path: str) -> bool:
        if self._dir_roots is None:
            return True
        from pathlib import Path

        try:
            resolved = Path(path).resolve()
        except OSError:
            return False
        return any(
            root == resolved or root in resolved.parents
            for root in self._dir_roots
        )

    def finalize(self) -> List[Finding]:
        files, self._files = self._files, []
        findings: List[Finding] = []

        def in_flag_scope(f: _FileFacts) -> bool:
            return any(frag in f.path for frag in self._flag_fragments)

        for f in files:
            if not in_flag_scope(f):
                continue
            for lineno, op, fn_name in f.unreduced:
                if lineno in f.suppressed:
                    continue
                findings.append(Finding(
                    f.path, lineno, self.name,
                    f"machine-axis `{op}` in `{fn_name}` is a per-shard "
                    "partial that reaches a result without a collective: "
                    "right on one shard, wrong on two — reduce it through "
                    "_Collectives (reduce/scan/gather)",
                ))
            for lineno, fn_name in f.unpadded:
                if lineno in f.suppressed:
                    continue
                findings.append(Finding(
                    f.path, lineno, self.name,
                    f"`{fn_name}` cuts the machine axis into per-shard "
                    "blocks without a visible pad-to-mesh-multiple "
                    "(`((n + d - 1) // d) * d` or a `% d == 0` guard): "
                    "uneven shards drop or misalign the tail columns",
                ))

        # Reachability: sharded solve keys must reach a precompile seed
        # (same closure + partial-graph posture as dispatch-budget).
        all_refs: Dict[str, Set[str]] = {}
        defined: Set[str] = set()
        for f in files:
            defined.update(f.defs)
            for name, refs in f.refs.items():
                all_refs.setdefault(name, set()).update(refs)
        seeds = [
            s for s in self._SEED_NAMES
            if any(s in f.defs for f in files)
        ]
        if seeds:
            reached = reach(seeds, all_refs, defined)
            for f in files:
                if not in_flag_scope(f) or not self._judgeable(f.path):
                    continue
                for name, lineno in sorted(f.sharded_keys.items()):
                    if name in reached or lineno in f.suppressed:
                        continue
                    findings.append(Finding(
                        f.path, lineno, self.name,
                        f"sharded solve key in `{name}` is not reachable "
                        "from precompile/ensure_precompiled: its first "
                        "sharded solve meets a fresh key in a live round "
                        "(wire it in, or opt out with `# posecheck: "
                        "ignore[dispatch-budget]` plus a justification)",
                    ))
        self._dir_roots = None
        findings.sort(key=lambda x: (x.path, x.line, x.message))
        return findings

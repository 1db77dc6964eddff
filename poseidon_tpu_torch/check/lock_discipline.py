"""lock-discipline: unlocked writes to lock-guarded instance state.

The port's copy of the reference rule (``poseidon_tpu/check/
lock_discipline.py``), with the scopes moved to the port's modules.
Scope: ``poseidon_tpu_torch/glue/`` and the other threaded layers — the
multi-threaded watcher/queue layer (KeyedQueue, pod/node watchers,
SharedState, FakeKube, stats plumbing).  CPython's GIL
makes single-bytecode ops atomic, but the invariants here are compound
(queue + parked + processing must agree; the id maps must stay mutually
consistent), so every write to guarded state must hold the class's lock.

Inference is codebase-aware rather than annotation-driven:

- a class participates iff some method assigns ``self.X =
  threading.Lock() / RLock() / Condition()``;
- an attribute counts as *guarded* iff it is accessed (read or write)
  somewhere lexically inside a ``with self.<lock>:`` block — the lock's
  observed coverage defines the guarded set, so unshared helpers
  (thread handles, config) don't false-positive;
- a private method whose every intra-class call site is inside a locked
  region (fixpoint, so recursion and helper chains work) is treated as
  executing under the lock — the ``SharedState._register_subtree``
  pattern;
- ``__init__`` writes are construction-time (no concurrent threads yet)
  and exempt.

Flagged: any other write — assignment, augmented assignment, ``del``,
subscript store, or a mutating method call (``.append``/``.pop``/...) —
to a guarded attribute outside a locked region.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    from_imports,
    import_aliases,
)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# Method names that mutate their receiver in place.
_MUTATORS = {
    "append", "appendleft", "add", "extend", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "sort",
    "reverse", "move_to_end",
}


def _lock_factory_names(tree: ast.AST) -> Set[str]:
    names = set()
    for alias in import_aliases(tree, "threading"):
        names.update(f"{alias}.{f}" for f in _LOCK_FACTORIES)
    for local, orig in from_imports(tree, "threading").items():
        if orig in _LOCK_FACTORIES:
            names.add(local)
    # The TrackedLock migration (utils/locks.py) must not take classes
    # OUT of scope: the wrappers are lock factories too.
    for local, orig in from_imports(
        tree, "poseidon_tpu_torch.utils.locks"
    ).items():
        if orig in ("TrackedLock", "tracked_condition"):
            names.add(local)
    for alias in import_aliases(tree, "poseidon_tpu_torch.utils.locks"):
        names.add(f"{alias}.TrackedLock")
        names.add(f"{alias}.tracked_condition")
    return names


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute expression, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclass
class _Access:
    attr: str
    line: int
    write: bool
    locked: bool
    method: str
    what: str  # description of the write kind for the message


class _MethodScanner(ast.NodeVisitor):
    """Collects self-attribute accesses and call sites with lock context."""

    def __init__(self, method: str, lock_attrs: Set[str],
                 method_names: Set[str]) -> None:
        self.method = method
        self.lock_attrs = lock_attrs
        self.method_names = method_names
        self.locked = False
        self.accesses: List[_Access] = []
        # (callee method name, locked at call site)
        self.calls: List[Tuple[str, bool]] = []
        # Methods referenced WITHOUT being called (thread targets,
        # callbacks): they can be entered from anywhere, so lock-held
        # inference must never apply to them.
        self.escaped: Set[str] = set()
        self._call_funcs: Set[int] = set()

    # -- lock context ------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        holds = any(
            _self_attr(item.context_expr) in self.lock_attrs
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
        prev, self.locked = self.locked, self.locked or holds
        for stmt in node.body:
            self.visit(stmt)
        self.locked = prev

    def _visit_nested(self, node: ast.AST) -> None:
        # A nested def/lambda runs later, possibly on another thread —
        # never inherit the enclosing lock context.
        prev, self.locked = self.locked, False
        self.generic_visit(node)
        self.locked = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested(node)

    # -- accesses ----------------------------------------------------------

    def _record(self, attr: Optional[str], node: ast.AST, write: bool,
                what: str) -> None:
        if attr is None:
            return
        self.accesses.append(
            _Access(attr, node.lineno, write, self.locked, self.method, what)
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._record(attr, node, True, f"assignment to self.{attr}")
            else:
                self._record(attr, node, False, "read")
                if (
                    attr in self.method_names
                    and id(node) not in self._call_funcs
                ):
                    # Bare ``self.meth`` (e.g. Thread(target=self.meth)):
                    # an escaped entry point.
                    self.escaped.add(attr)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        attr = _self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            self._record(attr, node, True, f"subscript store to self.{attr}")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            recv = _self_attr(node.func.value)
            if recv is not None and node.func.attr in _MUTATORS:
                self._record(
                    recv, node, True,
                    f"self.{recv}.{node.func.attr}(...) mutation",
                )
            callee = _self_attr(node.func)
            if callee is not None:
                self.calls.append((callee, self.locked))
                self._call_funcs.add(id(node.func))
        self.generic_visit(node)


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    # The port's threaded layers, as in the reference: the glue's
    # watchers and queue; the cross-band cost-build pipeline, whose worker
    # shares the plane cache with the planner thread; the soak harness
    # driving watcher and loop threads over shared round state; and every
    # module that takes a TrackedLock (obs/, service/, replay/,
    # graph/residency.py).
    scopes = (
        "poseidon_tpu_torch/glue/", "poseidon_tpu_torch/graph/pipeline.py",
        "poseidon_tpu_torch/costmodel/delta.py", "poseidon_tpu_torch/chaos/",
        "poseidon_tpu_torch/obs/", "poseidon_tpu_torch/service/",
        "poseidon_tpu_torch/replay/", "poseidon_tpu_torch/graph/residency.py",
    )

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        factories = _lock_factory_names(tree)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, factories, path))
        return findings

    def _check_class(
        self, cls: ast.ClassDef, factories: Set[str], path: str
    ) -> List[Finding]:
        methods = [
            n for n in cls.body if isinstance(n, ast.FunctionDef)
        ]
        lock_attrs: Set[str] = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    if dotted_name(node.value.func) in factories:
                        for t in node.targets:
                            attr = _self_attr(t)
                            if attr:
                                lock_attrs.add(attr)
        if not lock_attrs:
            return []

        method_names = {m.name for m in methods}
        scanners: Dict[str, _MethodScanner] = {}
        for m in methods:
            sc = _MethodScanner(m.name, lock_attrs, method_names)
            for stmt in m.body:
                sc.visit(stmt)
            scanners[m.name] = sc
        escaped: Set[str] = set()
        for sc in scanners.values():
            escaped |= sc.escaped

        guarded: Set[str] = set()
        for sc in scanners.values():
            for a in sc.accesses:
                if a.locked and a.attr not in lock_attrs:
                    guarded.add(a.attr)
        if not guarded:
            return []

        # Greatest fixpoint: a PRIVATE method is lock-held iff every
        # intra-class call site either holds the lock lexically or sits in
        # another lock-held method.  Starting from "all private methods
        # with call sites" and pruning lets recursion self-justify
        # (SharedState._register_subtree calls itself unlocked but is only
        # ever entered under the lock).  Public methods are excluded —
        # external callers reach them directly, so a locked internal call
        # site proves nothing.
        call_sites: Dict[str, List[Tuple[str, bool]]] = {}
        for caller, sc in scanners.items():
            for callee, locked in sc.calls:
                call_sites.setdefault(callee, []).append((caller, locked))
        lock_held: Set[str] = {
            name for name in scanners
            if name in call_sites
            and name.startswith("_") and not name.startswith("__")
            # A method whose reference escapes (thread target, callback)
            # can be entered without any lock, whatever its call sites say.
            and name not in escaped
        }
        changed = True
        while changed:
            changed = False
            for name in sorted(lock_held):
                if any(
                    not locked and caller not in lock_held
                    for caller, locked in call_sites[name]
                ):
                    lock_held.discard(name)
                    changed = True

        locks = "/".join(f"self.{a}" for a in sorted(lock_attrs))
        findings: List[Finding] = []
        for sc in scanners.values():
            if sc.method == "__init__" or sc.method in lock_held:
                continue
            for a in sc.accesses:
                if a.write and a.attr in guarded:
                    if not a.locked:
                        findings.append(
                            Finding(
                                path, a.line, self.name,
                                f"{a.what} outside `with {locks}` "
                                f"({cls.name}.{a.method}); the lock guards "
                                "this attribute elsewhere",
                            )
                        )
        return findings

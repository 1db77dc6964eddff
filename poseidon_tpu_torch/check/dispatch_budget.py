"""dispatch-budget: every kernel wrapper and solve key in ops/ must be
reachable from the precompile path.

The planner's ``precompile()`` (and the service's ``ensure_precompiled``)
walks every solve the production rounds can request before the first
real round: it builds and loads the kernel library once
(``_kernels.lib()``, the port's compile event) and notes every padded
solve key (``check.ledger.note_solve_key``), so a warm round sees no
fresh key and the runtime ledger's budget-0 window holds.  That only
stays true while every kernel wrapper in ``poseidon_tpu_torch/ops/`` —
a function or method that launches through ``_kernels.lib()`` — and
every function that notes a solve key there stays *reachable* from a
seed: a new route wired into a round path but not into precompile pays
its library load and mints its first key in a live round.

The port's counterpart of ``poseidon_tpu/check/dispatch_budget.py``:
kernel wrappers and solve-key sites take the place of jitted defs.
``check()`` collects per-file facts (definitions, name references,
wrappers, solve-key holders) for every scanned file, and ``finalize()``
computes a name-based transitive closure from every
``precompile``/``ensure_precompiled`` seen, then flags what lies outside
it.  A reference to a class reaches its ``__init__`` and ``__call__``
(a wrapper class is called through its instances).

The closure is deliberately an over-approximation (any Load of a name,
any attribute tail, joins the graph): a false "covered" verdict is
possible, a false finding on genuinely-wired code is not.  Three escape
hatches, as in the reference:

- a scan with no ``precompile`` definition judges nothing;
- explicit file-list scans (``--changed``) never judge: only files
  under a DIRECTORY scan root are flagged (``begin()`` records them);
- a route deliberately left to its first live use carries
  ``# posecheck: ignore[dispatch-budget]`` on its ``def`` line.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Set

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    suppressions,
)
from poseidon_tpu_torch.check.jit_purity import (
    launches,
    lib_call_names,
)


@dataclass
class _FileFacts:
    path: str
    # function/method/class name -> referenced names
    refs: Dict[str, Set[str]] = field(default_factory=dict)
    # judged defs in this file: name -> (def lineno, what it holds)
    judged: Dict[str, tuple] = field(default_factory=dict)
    # names this file defines (functions, methods, classes; unqualified)
    defs: Set[str] = field(default_factory=set)
    # lines with a posecheck suppression covering this rule
    suppressed_lines: Set[int] = field(default_factory=set)


def _referenced_names(fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            # self._dispatch_solve / transport.solve_transport: the tail
            # is the edge.  Over-approximate: any same-named function in
            # the scanned set joins the closure.
            names.add(node.attr)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                names.add(a.name)
    return names


def notes_solve_key(fn: ast.AST) -> bool:
    """Does ``fn`` call ``note_solve_key(...)`` (the ledger's)?"""
    return any(
        isinstance(n, ast.Call)
        and (dotted_name(n.func) or "").rpartition(".")[2]
        == "note_solve_key"
        for n in ast.walk(fn)
    )


class DispatchBudgetRule(Rule):
    name = "dispatch-budget"
    # Empty scopes: facts are collected from EVERY scanned file (the
    # precompile seeds live in graph/ and service/); only defs under
    # the flag fragments are ever flagged.
    scopes: tuple = ()

    _SEED_NAMES = ("precompile", "ensure_precompiled")

    def __init__(self, flag_fragments=("poseidon_tpu_torch/ops/",)) -> None:
        # Defs are only FLAGGED in files matching these fragments (facts
        # still collect everywhere); the self-tests narrow this to the
        # fixtures directory.
        self._flag_fragments = tuple(flag_fragments)
        self._files: List[_FileFacts] = []
        # Directory scan roots from begin(): None = no restriction (the
        # check_file/finalize path the self-tests drive directly).
        self._dir_roots = None

    def begin(self, paths) -> None:
        # A reachability verdict is only sound over a COMPLETE reference
        # graph: only files under directory scan roots are ever judged.
        from pathlib import Path

        self._dir_roots = [
            Path(p).resolve() for p in paths if Path(p).is_dir()
        ]

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        libs = lib_call_names(tree)
        facts = _FileFacts(path=path)

        for lineno, rules in suppressions(source).items():
            if rules is None or self.name in rules:
                facts.suppressed_lines.add(lineno)

        def visit_function(fn, owner=None) -> None:
            facts.defs.add(fn.name)
            facts.refs.setdefault(fn.name, set()).update(
                _referenced_names(fn)
            )
            held = []
            if libs and launches(fn, libs):
                held.append("kernel launch")
            if notes_solve_key(fn):
                held.append("solve key")
            if held:
                # A wrapper class's __call__ is judged under the class.
                name = owner if fn.name == "__call__" and owner else fn.name
                facts.judged[name] = (fn.lineno, " and ".join(held))

        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit_function(node)
            elif isinstance(node, ast.ClassDef):
                facts.defs.add(node.name)
                methods = [
                    s for s in node.body
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                ]
                # Referencing a class reaches what constructing and
                # calling an instance runs (its __init__ and __call__);
                # other methods join through their own names.
                for m in methods:
                    if m.name in ("__init__", "__call__"):
                        facts.refs.setdefault(node.name, set()).update(
                            _referenced_names(m)
                        )
                for sub in methods:
                    visit_function(sub, owner=node.name)
        self._files.append(facts)
        return []

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
        findings: List[Finding] = []
        if seeds:
            reached = reach(seeds, all_refs, defined)
            for f in files:
                if not any(frag in f.path for frag in self._flag_fragments):
                    continue
                if not self._judgeable(f.path):
                    continue
                for name, (lineno, held) in sorted(f.judged.items()):
                    if name in reached or lineno in f.suppressed_lines:
                        continue
                    findings.append(Finding(
                        f.path, lineno, self.name,
                        f"`{name}` ({held}) is not reachable from the "
                        "precompile path: its first production use "
                        "loads the kernel library and mints its solve "
                        "key in a live round (wire it into "
                        "precompile(), or opt out with "
                        "`# posecheck: ignore[dispatch-budget]` plus a "
                        "justification)",
                    ))
        findings.sort(key=lambda x: (x.path, x.line))
        self._dir_roots = None
        return findings


def reach(seeds, all_refs: Dict[str, Set[str]],
          defined: Set[str]) -> Set[str]:
    """Names transitively referenced from ``seeds``."""
    reached: Set[str] = set()
    frontier = list(seeds)
    while frontier:
        name = frontier.pop()
        if name in reached:
            continue
        reached.add(name)
        for ref in all_refs.get(name, ()):
            if ref in defined and ref not in reached:
                frontier.append(ref)
    return reached

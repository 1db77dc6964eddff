"""transfer-discipline: implicit device->host syncs outside the boundary.

Scope: ``poseidon_tpu_torch/ops/``, ``poseidon_tpu_torch/graph/``,
``poseidon_tpu_torch/costmodel/`` — the host-side round path around the
kernel wrappers.  The port's counterpart of
``poseidon_tpu/check/transfer_discipline.py``.  ``jit-purity`` guards
the stretch between a wrapper's launches; this rule guards the code that
handles what comes back.  Every device->host read waits for the card's
queue, and the *implicit* ones are the killers: a ``float(x)`` /
``.item()`` / ``np.asarray(x)`` on a CUDA tensor blocks the host with no
visible smell at the call site — invisible in CPU tests, where the read
is a copy.  The runtime twin is ``check.ledger.TransferLedger``, which
counts the reads the port's one boundary makes (``transport._host_read``
and ``_host_read_blocks``).

Three sub-checks:

- **scalar sync**: ``.item()`` / ``.tolist()`` / ``float()`` / ``int()``
  / ``bool()`` applied to a value dataflow-traced from a kernel
  wrapper's result (wrappers unioned across the scan, so an imported
  wrapper counts) or from a tensor placed on CUDA (``.cuda()``,
  ``device="cuda..."``, ``.to("cuda...")``).  Each is one blocking
  round trip; batch the scalars into the boundary read instead.
- **host materialization**: ``np.asarray`` / ``np.array`` /
  ``np.ascontiguousarray`` on such a value outside a declared host
  boundary.  The read itself is legitimate — once, at the boundary,
  explicitly, where it is counted.
- **read placement**: ``.cpu()`` (and ``.numpy()`` on anything but a
  ``.cpu()`` result) anywhere except a declared boundary function
  (``_host_read``, ``_host_read_blocks``, ``_host_*`` / ``host_*``, view
  builders) — the place-of-use check the reference makes for
  ``jax.device_get``.  Scattered reads are scattered waits, uncounted.

The reference's donation sub-checks (an in-place ``.at[...]`` update
without ``donate_argnums``, and a read after donation) have no torch
meaning: torch never deletes an operand, and an in-place update writes
the operand's own storage.

Dataflow is per-function and name-based (assignments from wrapper
calls, CUDA placements, tuple unpacks, name aliases), resolved in
``finalize()`` against the scan-wide wrapper union.  Line order is
ignored inside a function, except that a name re-bound through a
boundary read is host data.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    import_aliases,
    suppressions,
)
from poseidon_tpu_torch.check.jit_purity import kernel_wrappers

_NP_MATERIALIZERS = ("asarray", "array", "ascontiguousarray")
_SCALAR_CASTS = ("float", "int", "bool")
_SCALAR_METHODS = ("item", "tolist")


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name of an Attribute/Subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_cuda_literal(node: ast.AST) -> bool:
    """``"cuda"`` / ``"cuda:0"`` or ``torch.device("cuda...")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and (
        dotted_name(node.func) or ""
    ).endswith("device") and node.args:
        return _is_cuda_literal(node.args[0])
    return False


def places_on_cuda(v: ast.AST) -> bool:
    """Does the expression put a tensor on CUDA explicitly?"""
    for n in ast.walk(v):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr == "cuda":
            return True
        if isinstance(n.func, ast.Attribute) and n.func.attr == "to" and \
                n.args and _is_cuda_literal(n.args[0]):
            return True
        if any(kw.arg == "device" and _is_cuda_literal(kw.value)
               for kw in n.keywords):
            return True
    return False


@dataclass
class _FnFacts:
    path: str
    fn: str
    # (lineno, targets, kind "call"|"alias"|"cuda", payload)
    assigns: List[Tuple[int, Tuple[str, ...], str, str]] = \
        field(default_factory=list)
    # (lineno, kind, subject, op) — kind in {"scalar_name",
    # "scalar_call", "np_name", "np_call"}
    sites: List[Tuple[int, str, str, str]] = field(default_factory=list)


@dataclass
class _FileFacts:
    path: str
    wrappers: Set[str] = field(default_factory=set)
    fns: List[_FnFacts] = field(default_factory=list)
    suppressed: Set[int] = field(default_factory=set)


class TransferDisciplineRule(Rule):
    name = "transfer-discipline"
    scopes = (
        "poseidon_tpu_torch/ops/", "poseidon_tpu_torch/graph/",
        "poseidon_tpu_torch/costmodel/",
    )

    # Declared host boundaries: the functions allowed to read the
    # device.  Prefix match on "_host_"/"host_" plus the view builder.
    _BOUNDARY_NAMES = frozenset({
        "_host_read", "_host_read_blocks", "build_view",
    })
    _BOUNDARY_PREFIXES = ("_host_", "host_")

    def __init__(self) -> None:
        self._files: List[_FileFacts] = []

    def _is_boundary(self, fn_name: str) -> bool:
        return fn_name in self._BOUNDARY_NAMES or any(
            fn_name.startswith(p) for p in self._BOUNDARY_PREFIXES
        )

    # ---------------------------------------------------------------- check

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        np_aliases = import_aliases(tree, "numpy")
        facts = _FileFacts(path=path, wrappers=set(kernel_wrappers(tree)))
        for lineno, rules in suppressions(source).items():
            if rules is None or self.name in rules:
                facts.suppressed.add(lineno)
        findings: List[Finding] = []
        self._collect_fn_facts(tree, facts, np_aliases, findings, path)
        self._files.append(facts)
        # Placement findings are per-file: returned here so check_file's
        # suppression filter applies normally.
        return findings

    def _collect_fn_facts(self, tree, facts, np_aliases, findings,
                          path) -> None:
        fns: List[Tuple[str, ast.AST]] = [("<module>", tree)]
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append((node.name, node))

        def shallow(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                yield child
                yield from shallow(child)

        for fn_name, scope in fns:
            ff = _FnFacts(path=path, fn=fn_name)
            boundary = self._is_boundary(fn_name)
            for node in shallow(scope):
                if isinstance(node, ast.Assign):
                    targets: List[str] = []
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            targets.append(t.id)
                        elif isinstance(t, (ast.Tuple, ast.List)):
                            targets.extend(
                                e.id for e in t.elts
                                if isinstance(e, ast.Name)
                            )
                    if not targets:
                        continue
                    v = node.value
                    if places_on_cuda(v):
                        ff.assigns.append(
                            (node.lineno, tuple(targets), "cuda", "")
                        )
                    elif isinstance(v, ast.Call):
                        callee = dotted_name(v.func)
                        if callee:
                            ff.assigns.append((
                                node.lineno, tuple(targets), "call",
                                callee.rpartition(".")[2],
                            ))
                    elif isinstance(v, ast.Name):
                        ff.assigns.append(
                            (node.lineno, tuple(targets), "alias", v.id)
                        )
                elif isinstance(node, ast.Call):
                    self._classify_call(
                        node, ff, boundary, np_aliases, findings, path,
                        fn_name,
                    )
            if ff.assigns or ff.sites:
                facts.fns.append(ff)

    def _classify_call(self, node, ff, boundary, np_aliases, findings,
                       path, fn_name) -> None:
        fname = dotted_name(node.func)
        # .cpu() / .numpy() placement: flagged immediately (no dataflow
        # needed) unless inside a declared boundary.
        if isinstance(node.func, ast.Attribute) and not node.args and \
                node.func.attr in ("cpu", "numpy"):
            recv = node.func.value
            on_cpu_call = node.func.attr == "numpy" and isinstance(
                recv, ast.Call
            ) and isinstance(recv.func, ast.Attribute) and \
                recv.func.attr == "cpu"
            if not boundary and not on_cpu_call:
                findings.append(Finding(
                    path, node.lineno, self.name,
                    f"`.{node.func.attr}()` outside a declared host "
                    f"boundary (in `{fn_name}`): route the read through "
                    "transport._host_read/_host_read_blocks so reads "
                    "stay at the boundary (and are counted)",
                ))
            return
        if fname:
            head, _, rest = fname.partition(".")
            if head in np_aliases and rest in _NP_MATERIALIZERS:
                if boundary or not node.args:
                    return
                a = node.args[0]
                root = _root_name(a)
                if root is not None:
                    ff.sites.append((node.lineno, "np_name", root, fname))
                elif isinstance(a, ast.Call):
                    callee = dotted_name(a.func)
                    if callee:
                        ff.sites.append((
                            node.lineno, "np_call",
                            callee.rpartition(".")[2], fname,
                        ))
                return
        # Scalar casts: float(x)/int(x)/bool(x)
        if isinstance(node.func, ast.Name) and \
                node.func.id in _SCALAR_CASTS and len(node.args) == 1:
            a = node.args[0]
            root = _root_name(a)
            if root is not None:
                ff.sites.append(
                    (node.lineno, "scalar_name", root, node.func.id)
                )
            elif isinstance(a, ast.Call):
                callee = dotted_name(a.func)
                if callee:
                    ff.sites.append((
                        node.lineno, "scalar_call",
                        callee.rpartition(".")[2], node.func.id,
                    ))
            return
        # .item() / .tolist()
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SCALAR_METHODS and not node.args:
            base = node.func.value
            root = _root_name(base)
            if root is not None:
                ff.sites.append(
                    (node.lineno, "scalar_name", root, node.func.attr)
                )
            elif isinstance(base, ast.Call):
                callee = dotted_name(base.func)
                if callee:
                    ff.sites.append((
                        node.lineno, "scalar_call",
                        callee.rpartition(".")[2], node.func.attr,
                    ))

    # ------------------------------------------------------------- finalize

    def _tracked(self, ff: _FnFacts, wrappers: Set[str],
                 source: str) -> Set[str]:
        """Names holding a device tensor from ``source``: a wrapper call
        ("call") or a CUDA placement ("cuda"), through aliases; a name
        re-bound through a boundary read (`x = _host_read(x)`) is host
        data from then on."""
        tracked: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for _line, targets, kind, payload in ff.assigns:
                if source == "cuda":
                    hit = kind == "cuda"
                else:
                    hit = kind == "call" and payload in wrappers
                hit = hit or (kind == "alias" and payload in tracked)
                if hit and not set(targets) <= tracked:
                    tracked.update(targets)
                    changed = True
        for _line, targets, kind, payload in ff.assigns:
            if kind == "call" and self._is_boundary(payload):
                tracked.difference_update(targets)
        return tracked

    def finalize(self) -> List[Finding]:
        files, self._files = self._files, []
        wrappers: Set[str] = set()
        for f in files:
            wrappers.update(f.wrappers)

        findings: List[Finding] = []
        for f in files:
            for ff in f.fns:
                by_wrapper = self._tracked(ff, wrappers, "call")
                by_cuda = self._tracked(ff, wrappers, "cuda")
                for lineno, kind, subject, op in ff.sites:
                    if lineno in f.suppressed:
                        continue
                    if kind.endswith("_name"):
                        if subject in by_wrapper:
                            what = "a kernel wrapper's result"
                        elif subject in by_cuda:
                            what = "a tensor placed on CUDA"
                        else:
                            continue
                    elif subject in wrappers:
                        what = "a kernel wrapper's result"
                    else:
                        continue
                    if kind.startswith("scalar"):
                        findings.append(Finding(
                            f.path, lineno, self.name,
                            f"`{op}` on `{subject}` ({what}) is an "
                            "implicit device->host sync — one blocking "
                            "round trip per call; batch it into the "
                            "boundary read (transport._host_read)",
                        ))
                    else:
                        findings.append(Finding(
                            f.path, lineno, self.name,
                            f"`{op}` on `{subject}` ({what}) reads device "
                            "memory implicitly, outside a declared host "
                            "boundary; read through transport._host_read "
                            "instead",
                        ))
        findings.sort(key=lambda x: (x.path, x.line))
        return findings

"""Concurrency discipline: lock ordering, blocking under locks, unsafe
publication — the static half of the TrackedLock/LockLedger runtime
(utils/locks.py), scoped to the threaded layers (glue watchers/queue,
the cost-build pipeline, the obs plane, chaos, service, replay).

Three rules share one class-level analysis, built on lock-discipline's
machinery (``_lock_factory_names``/``_self_attr`` plus the same
greatest-fixpoint lock-held-helper inference, extended from a boolean
"some lock held" to the *set* of held locks):

``lock-order`` (project-scoped, finalize())
    Builds a cross-file lock-acquisition graph: ``with self.<A>:``
    nesting adds the edge ``Class.A -> Class.B`` for every lock B
    acquired inside (lexically, through lock-held private helpers, and
    through calls into *other* scanned classes' lock-taking public
    methods — linked by unambiguous method name, the same
    over-approximation posture dispatch-budget takes).  Any cycle is a
    potential deadlock: two code paths acquire the same locks in
    opposite orders, and the finding lists every edge with its site.

``blocking-under-lock`` (per-file)
    Flags calls that can park the thread while a lock is held: ``time
    .sleep``, thread/queue ``.join()``, blocking ``.get()``, ``Future
    .result()``, ``.wait()`` on anything but the held lock itself,
    socket ops, RPC stubs, and the device: ``torch.cuda.synchronize()``,
    ``.synchronize()`` on a stream or event, a host read (``_host_read``
    / ``_host_read_blocks``, ``.item()``, ``.cpu()``, ``.tolist()``) and
    a kernel launch through ``_kernels.lib().pt_*`` — the torch meaning
    of the reference's ``jax.*`` dispatch and ``.block_until_ready()``.
    The tracer/metrics hot paths must stay wait-free, and a device wait
    under a glue lock serializes the watcher threads behind the card.

``unsafe-publication`` (per-file)
    In classes that spawn threads, flags mutable state (dict/list/set
    literals and factories, lambdas) assigned to ``self.<attr>`` outside
    ``__init__`` and outside any lock: the new object is published to
    every thread with no happens-before edge.  A documented handoff —
    state swapped before the consuming thread starts, or a deliberate
    benign race — carries a ``# handoff: <why>`` comment on the line,
    the annotation analog of ``# posecheck: ignore[...]``.

The runtime complement: TrackedLock records the orders these rules
predict, and the soak's LockLedger budget-0 window asserts warm rounds
explore no new ones.  This module is the port's copy of
``poseidon_tpu/check/concurrency.py``, with the scopes and the
``utils.locks`` alias moved to the port's modules and the device waits
given their torch meaning.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    from_imports,
    import_aliases,
    suppressions,
)
from poseidon_tpu_torch.check.jit_purity import lib_call_names
from poseidon_tpu_torch.check.lock_discipline import (
    _lock_factory_names,
    _self_attr,
)

# The threaded layers: every module the TrackedLock migration covers.
_SCOPES = (
    "poseidon_tpu_torch/glue/",
    "poseidon_tpu_torch/graph/pipeline.py",
    "poseidon_tpu_torch/obs/",
    "poseidon_tpu_torch/chaos/",
    "poseidon_tpu_torch/service/",
    "poseidon_tpu_torch/replay/",
    "poseidon_tpu_torch/costmodel/delta.py",
)

_HANDOFF_RE = re.compile(r"#\s*handoff:")

# Method names that block on a socket receiver.
_SOCKET_METHODS = {
    "connect", "accept", "recv", "recv_into", "recvfrom", "sendall",
}

# Mutable-container factories whose result, published unlocked, is
# visible half-initialized to other threads.
_MUTABLE_FACTORIES = {
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter",
}

_THREAD_FACTORIES = {"Thread", "Timer"}

# Host reads of a device tensor: each waits for the card's queue.
_HOST_READ_FNS = {"_host_read", "_host_read_blocks"}
_HOST_READ_METHODS = {"item", "cpu", "tolist"}


def _tracked_factory_names(tree: ast.AST) -> Set[str]:
    """Lock factories: threading's plus the TrackedLock migration's
    (utils/locks.py) — post-migration code must stay in scope."""
    names = _lock_factory_names(tree)
    for local, orig in from_imports(
        tree, "poseidon_tpu_torch.utils.locks"
    ).items():
        if orig in ("TrackedLock", "tracked_condition"):
            names.add(local)
    for alias in import_aliases(tree, "poseidon_tpu_torch.utils.locks"):
        names.add(f"{alias}.TrackedLock")
        names.add(f"{alias}.tracked_condition")
    return names


@dataclass
class _Blocking:
    desc: str
    held: frozenset
    line: int
    method: str


@dataclass
class _Publish:
    attr: str
    line: int
    method: str
    what: str
    held: frozenset


@dataclass
class _MethodInfo:
    name: str
    # (lock attr, lexically-held locks at that point, line)
    acquires: List[Tuple[str, frozenset, int]] = field(default_factory=list)
    # (callee method name, lexically-held locks, line)
    self_calls: List[Tuple[str, frozenset, int]] = field(
        default_factory=list
    )
    # (callee method name, lexically-held locks, line) on non-self
    # receivers — cross-class edge candidates.
    ext_calls: List[Tuple[str, frozenset, int]] = field(
        default_factory=list
    )
    blocking: List[_Blocking] = field(default_factory=list)
    publishes: List[_Publish] = field(default_factory=list)
    escaped: Set[str] = field(default_factory=set)
    spawns_thread: bool = False


class _Scanner(ast.NodeVisitor):
    """One method's walk: tracks the SET of lexically-held locks (the
    lock-discipline scanner's boolean, widened for ordering)."""

    def __init__(self, method: str, lock_attrs: Set[str],
                 method_names: Set[str], env: "_FileEnv") -> None:
        self.info = _MethodInfo(method)
        self.lock_attrs = lock_attrs
        self.method_names = method_names
        self.env = env
        self.held: List[str] = []
        self._call_funcs: Set[int] = set()
        # Names bound to ``_kernels.lib()`` in this method: their
        # ``pt_*`` attributes are kernel launches.
        self.lib_names: Set[str] = set()

    # -- lock context ------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)
            attr = _self_attr(item.context_expr)
            if attr in self.lock_attrs:
                self.info.acquires.append(
                    (attr, frozenset(self.held), item.context_expr.lineno)
                )
                self.held.append(attr)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def _visit_nested(self, node: ast.AST) -> None:
        # A nested def/lambda runs later, possibly on another thread —
        # never inherit the enclosing lock context.
        prev, self.held = self.held, []
        self.generic_visit(node)
        self.held = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested(node)

    # -- accesses ----------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if (
            attr is not None
            and isinstance(node.ctx, ast.Load)
            and attr in self.method_names
            and id(node) not in self._call_funcs
        ):
            # Bare ``self.meth`` (thread target, callback): an escaped
            # entry point — lock-held inference must never apply to it.
            self.info.escaped.add(attr)
        self.generic_visit(node)

    def _is_lib_call(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            dotted_name(node.func) in self.env.libs

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_lib_call(node.value):
            self.lib_names.update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
        what = self._mutable_kind(node.value)
        if what is not None:
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None and attr not in self.lock_attrs:
                    self.info.publishes.append(_Publish(
                        attr, node.lineno, self.info.name, what,
                        frozenset(self.held),
                    ))
        self.generic_visit(node)

    def _mutable_kind(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, (ast.List, ast.ListComp)):
            return "list"
        if isinstance(value, (ast.Dict, ast.DictComp)):
            return "dict"
        if isinstance(value, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(value, ast.Lambda):
            return "callback"
        if isinstance(value, ast.Call):
            name = dotted_name(value.func)
            tail = name.rsplit(".", 1)[-1] if name else None
            if tail in _MUTABLE_FACTORIES:
                return tail
        return None

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        held = frozenset(self.held)
        name = dotted_name(node.func)
        if name is not None:
            tail = name.rsplit(".", 1)[-1]
            if tail in _THREAD_FACTORIES or tail == "ThreadPoolExecutor":
                self.info.spawns_thread = True
        if isinstance(node.func, ast.Attribute):
            callee = _self_attr(node.func)
            if callee is not None:
                self.info.self_calls.append(
                    (callee, held, node.lineno)
                )
                self._call_funcs.add(id(node.func))
            elif not isinstance(node.func.value, ast.Constant):
                # x.meth(...) / self.attr.meth(...): a cross-object call
                # (string-literal receivers — "sep".join — excluded).
                self.info.ext_calls.append(
                    (node.func.attr, held, node.lineno)
                )
        desc = self._blocking_desc(node, name)
        if desc is not None:
            self.info.blocking.append(
                _Blocking(desc, held, node.lineno, self.info.name)
            )
        self.generic_visit(node)

    def _blocking_desc(self, node: ast.Call,
                       name: Optional[str]) -> Optional[str]:
        env = self.env
        if name is not None:
            if name in env.sleep_names:
                return f"{name}(...) sleep"
            if name in env.urlopen_names or name in env.create_conn_names:
                return f"{name}(...) network call"
            head, _, rest = name.partition(".")
            if head in env.torch_aliases and rest == "cuda.synchronize":
                return f"{name}() device sync"
            if name.rpartition(".")[2] in _HOST_READ_FNS:
                return f"{name}(...) host read"
            if "stub" in name.lower() and isinstance(
                node.func, ast.Attribute
            ):
                return f"{name}(...) RPC"
        if not isinstance(node.func, ast.Attribute):
            return None
        meth = node.func.attr
        npos = len(node.args)
        kwnames = {k.arg for k in node.keywords}
        if meth == "join" and npos == 0:
            # str.join always takes one positional; a no-positional
            # join is a thread/queue join.
            return ".join() thread/queue join"
        if meth == "get" and npos == 0 and kwnames <= {"block", "timeout"}:
            # dict.get always takes a positional key; a no-positional
            # get is a blocking queue get.
            return ".get() blocking queue get"
        if meth == "result":
            return ".result() future join"
        if meth == "wait":
            recv = _self_attr(node.func.value)
            if recv is not None and recv in self.held:
                # Condition.wait on the held lock RELEASES it — the
                # one legal wait inside a critical section.
                return None
            return ".wait() event/condition wait"
        if meth in _SOCKET_METHODS:
            return f".{meth}() socket op"
        if meth == "synchronize" and npos == 0:
            return ".synchronize() stream/event sync"
        if meth in _HOST_READ_METHODS and npos == 0 and not kwnames:
            return f".{meth}() host read"
        recv = node.func.value
        if meth.startswith("pt_") and (
            self._is_lib_call(recv) or (
                isinstance(recv, ast.Name) and recv.id in self.lib_names
            )
        ):
            return f".{meth}(...) kernel launch"
        return None


@dataclass
class _ClassInfo:
    path: str
    name: str
    lock_attrs: Set[str]
    methods: Dict[str, _MethodInfo]
    # method -> inferred entry-held lock set (greatest fixpoint over
    # private, non-escaped methods; public methods enter lock-free).
    entry_held: Dict[str, Set[str]] = field(default_factory=dict)

    def qual(self, lock: str) -> str:
        return f"{self.name}.{lock}"

    def effective_held(self, method: str, lexical: frozenset) -> Set[str]:
        return set(lexical) | self.entry_held.get(method, set())


def _analyze_class(cls: ast.ClassDef, factories: Set[str],
                   env: "_FileEnv", path: str) -> Optional[_ClassInfo]:
    methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
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

    method_names = {m.name for m in methods}
    infos: Dict[str, _MethodInfo] = {}
    for m in methods:
        sc = _Scanner(m.name, lock_attrs, method_names, env)
        for stmt in m.body:
            sc.visit(stmt)
        infos[m.name] = sc.info
    info = _ClassInfo(path, cls.name, lock_attrs, infos)
    if not lock_attrs:
        # Threadless-lockless classes still matter to unsafe-publication
        # (they may spawn threads); entry inference is lock-only.
        return info

    escaped: Set[str] = set()
    for mi in infos.values():
        escaped |= mi.escaped
    call_sites: Dict[str, List[Tuple[str, frozenset]]] = {}
    for caller, mi in infos.items():
        for callee, held, _line in mi.self_calls:
            call_sites.setdefault(callee, []).append((caller, held))

    # Greatest fixpoint over the held SET: a private method's entry-held
    # locks are the intersection over its intra-class call sites of
    # (site-held | caller's entry-held).  Same shape as lock-discipline's
    # boolean fixpoint; recursion self-justifies from the full set.
    entry: Dict[str, Set[str]] = {
        name: set(lock_attrs) for name in infos
        if name in call_sites
        and name.startswith("_") and not name.startswith("__")
        and name not in escaped
    }
    changed = True
    while changed:
        changed = False
        for name in sorted(entry):
            new: Optional[Set[str]] = None
            for caller, held in call_sites[name]:
                eff = set(held) | entry.get(caller, set())
                new = eff if new is None else (new & eff)
            new = new or set()
            if new != entry[name]:
                entry[name] = new
                changed = True
    info.entry_held = entry
    return info


class _FileEnv:
    """Per-file import context shared by the scanners."""

    def __init__(self, tree: ast.AST) -> None:
        self.sleep_names: Set[str] = set()
        for alias in import_aliases(tree, "time"):
            self.sleep_names.add(f"{alias}.sleep")
        for local, orig in from_imports(tree, "time").items():
            if orig == "sleep":
                self.sleep_names.add(local)
        self.torch_aliases = import_aliases(tree, "torch")
        # Dotted names of ``_kernels.lib``: its entry points launch.
        self.libs = lib_call_names(tree)
        self.urlopen_names: Set[str] = set()
        for local, orig in from_imports(
            tree, "urllib.request"
        ).items():
            if orig == "urlopen":
                self.urlopen_names.add(local)
        for alias in import_aliases(tree, "urllib.request"):
            self.urlopen_names.add(f"{alias}.urlopen")
        self.create_conn_names: Set[str] = set()
        for alias in import_aliases(tree, "socket"):
            self.create_conn_names.add(f"{alias}.create_connection")
        for local, orig in from_imports(tree, "socket").items():
            if orig == "create_connection":
                self.create_conn_names.add(local)


def _file_classes(tree: ast.AST, path: str) -> List[_ClassInfo]:
    factories = _tracked_factory_names(tree)
    env = _FileEnv(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            info = _analyze_class(node, factories, env, path)
            if info is not None:
                out.append(info)
    return out


# ------------------------------------------------------------- lock-order


@dataclass(frozen=True)
class _Edge:
    src: str
    dst: str
    path: str
    line: int


class LockOrderRule(Rule):
    """Cross-file acquisition-order graph; any cycle is a deadlock
    finding.  Evidence-positive (edges must exist to form a cycle), so
    partial scans (--changed) can miss cycles but never invent them —
    no scan-completeness gate is needed."""

    name = "lock-order"
    scopes = _SCOPES

    def __init__(self) -> None:
        self._classes: List[_ClassInfo] = []
        self._suppressed: Dict[str, Set[int]] = {}

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        self._classes.extend(_file_classes(tree, path))
        lines: Set[int] = set()
        for lineno, rules in suppressions(source).items():
            if rules is None or self.name in rules:
                lines.add(lineno)
        if lines:
            self._suppressed[path] = lines
        return []

    def _edges(self, classes: Sequence[_ClassInfo]) -> List[_Edge]:
        # Public lock-taking entry points across the scan, for linking
        # cross-object calls made under a lock: method name -> list of
        # (class info, locks acquired with no lock lexically held).
        entries: Dict[str, List[Tuple[_ClassInfo, Set[str]]]] = {}
        for ci in classes:
            if not ci.lock_attrs:
                continue
            for mname, mi in ci.methods.items():
                if mname.startswith("_"):
                    continue
                top = {
                    lock for lock, held, _ in mi.acquires if not held
                }
                if top:
                    entries.setdefault(mname, []).append((ci, top))

        seen: Set[Tuple[str, str]] = set()
        edges: List[_Edge] = []

        def add(src: str, dst: str, path: str, line: int) -> None:
            if src == dst or (src, dst) in seen:
                return
            seen.add((src, dst))
            edges.append(_Edge(src, dst, path, line))

        for ci in classes:
            if not ci.lock_attrs:
                continue
            for mname, mi in ci.methods.items():
                for lock, lexical, line in mi.acquires:
                    for h in ci.effective_held(mname, lexical):
                        add(ci.qual(h), ci.qual(lock), ci.path, line)
                # Same-class call into a public lock-taking method
                # while holding a lock (private helpers are covered by
                # the entry-held inference above).
                for callee, lexical, line in mi.self_calls:
                    held = ci.effective_held(mname, lexical)
                    if not held or callee not in ci.methods:
                        continue
                    for lock, chold, _ in ci.methods[callee].acquires:
                        if chold:
                            continue
                        for h in held:
                            add(ci.qual(h), ci.qual(lock), ci.path, line)
                # Cross-object call under a lock, linked by unambiguous
                # public method name (two candidate classes = ambiguous
                # = no edge; heuristic linking must not invent cycles
                # out of generic names).
                for callee, lexical, line in mi.ext_calls:
                    held = ci.effective_held(mname, lexical)
                    if not held:
                        continue
                    cands = [
                        (other, locks)
                        for other, locks in entries.get(callee, ())
                        if other.name != ci.name
                    ]
                    if len(cands) != 1:
                        continue
                    other, locks = cands[0]
                    for lock in locks:
                        for h in held:
                            add(ci.qual(h), other.qual(lock),
                                ci.path, line)
        return edges

    def finalize(self) -> List[Finding]:
        classes, self._classes = self._classes, []
        suppressed, self._suppressed = self._suppressed, {}
        edges = self._edges(classes)
        succ: Dict[str, List[_Edge]] = {}
        for e in edges:
            succ.setdefault(e.src, []).append(e)

        def path_back(src: str, dst: str) -> Optional[List[_Edge]]:
            """A path of edges from src to dst, if one exists."""
            seen = {src}
            stack: List[Tuple[str, List[_Edge]]] = [(src, [])]
            while stack:
                node, trail = stack.pop()
                if node == dst:
                    return trail
                for e in succ.get(node, ()):
                    if e.dst not in seen or e.dst == dst:
                        seen.add(e.dst)
                        stack.append((e.dst, trail + [e]))
            return None

        findings: List[Finding] = []
        reported: Set[frozenset] = set()
        for e in edges:
            back = path_back(e.dst, e.src)
            if back is None:
                continue
            cycle = [e] + back
            key = frozenset((c.src, c.dst) for c in cycle)
            if key in reported:
                continue
            reported.add(key)
            if any(
                c.line in suppressed.get(c.path, ())
                for c in cycle
            ):
                continue
            desc = ", ".join(
                f"{c.src} -> {c.dst} ({c.path}:{c.line})" for c in cycle
            )
            findings.append(Finding(
                e.path, e.line, self.name,
                f"lock-order cycle (potential deadlock): {desc}; two "
                "paths acquire these locks in opposite orders — pick "
                "one global order (deepest-last) and restructure the "
                "odd one out",
            ))
        findings.sort(key=lambda f: (f.path, f.line))
        return findings


# ----------------------------------------------------- blocking-under-lock


class BlockingUnderLockRule(Rule):
    name = "blocking-under-lock"
    scopes = _SCOPES

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        findings: List[Finding] = []
        for ci in _file_classes(tree, path):
            if not ci.lock_attrs:
                continue
            for mname, mi in ci.methods.items():
                for b in mi.blocking:
                    held = ci.effective_held(mname, b.held)
                    if not held:
                        continue
                    locks = "/".join(
                        f"self.{h}" for h in sorted(held)
                    )
                    findings.append(Finding(
                        path, b.line, self.name,
                        f"{b.desc} while holding {locks} "
                        f"({ci.name}.{mname}): the thread parks inside "
                        "the critical section and every contender "
                        "parks behind it — move the wait outside the "
                        "lock",
                    ))
        return findings


# ------------------------------------------------------ unsafe-publication


class UnsafePublicationRule(Rule):
    name = "unsafe-publication"
    scopes = _SCOPES

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        handoff_lines = {
            lineno
            for lineno, text in enumerate(source.splitlines(), start=1)
            if _HANDOFF_RE.search(text)
        }
        findings: List[Finding] = []
        for ci in _file_classes(tree, path):
            threaded = any(
                mi.spawns_thread for mi in ci.methods.values()
            )
            if not threaded:
                continue
            for mname, mi in ci.methods.items():
                if mname == "__init__":
                    continue
                for p in mi.publishes:
                    if p.line in handoff_lines:
                        continue
                    if ci.effective_held(mname, p.held):
                        continue
                    findings.append(Finding(
                        path, p.line, self.name,
                        f"{p.what} assigned to self.{p.attr} outside "
                        f"a lock ({ci.name}.{mname}): the object is "
                        "published to the class's threads with no "
                        "happens-before edge — assign under the lock, "
                        "or annotate a documented handoff with "
                        "`# handoff: <why>`",
                    ))
        return findings

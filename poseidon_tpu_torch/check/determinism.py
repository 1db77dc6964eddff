"""determinism: wall-clock, unseeded RNG, and unordered-set iteration.

Scope: ``poseidon_tpu_torch/replay/`` and ``poseidon_tpu_torch/graph/`` — the
trace-replay and round-planning path whose whole value is bit-for-bit
reproducibility (BASELINE parity runs, solver-vs-oracle verification,
warm-start reuse across rounds).  Three leak classes:

- ``time.time()``: real wall-clock in a virtual-time replay makes runs
  incomparable.  (``time.perf_counter`` for *measuring* a round is fine
  — it feeds telemetry, not decisions — so only ``time.time`` flags.)
- unseeded RNG: module-level ``random.*`` / ``np.random.*`` draw from
  process-global state seeded by the OS; ``np.random.default_rng(seed)``
  / ``random.Random(seed)`` thread explicit streams instead.  A bare
  ``default_rng()`` with no seed flags too.  In torch the global stream
  is ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` (and their
  kin) called without ``generator=``; a ``torch.Generator()`` that is
  never ``.manual_seed``-ed starts from a fixed default seed nobody
  chose, and flags too.
- iteration over bare ``set``s: set order varies with insertion history
  and (for str keys) per-process hash randomization, so any ordering-
  sensitive consumer — event lists, cost-matrix row order, serialized
  output — silently diverges between runs.  ``sorted(set(...))`` is the
  fix and never flags.
- import-time environment reads: ``os.environ``/``os.getenv`` at module
  (or class-body) level pins the value at whatever the environment held
  when the module was FIRST imported — tests and bench runs that set
  the variable later silently no-op, and two processes with different
  import orders can disagree (the ``POSEIDON_ITER_UNROLL`` pattern this
  check exists to keep out: the value was baked into traced programs at
  import).  Read at call time, or through an accessor.  This sub-check
  also covers ``poseidon_tpu_torch/ops/`` — env-tuned kernels are where
  the pattern keeps trying to return.

The port's copy of ``poseidon_tpu/check/determinism.py``: the scopes and
the tracer's clock exemption name the port's modules, and the RNG
sub-check learns torch's global stream.
"""

from __future__ import annotations

import ast
from typing import List, Set

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    from_imports,
    import_aliases,
)

# Module-level random functions that draw from the global stream.
_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "triangular",
    "vonmisesvariate", "paretovariate", "weibullvariate", "getrandbits",
    "randbytes",
}

# torch functions that draw from the global stream unless given a
# ``generator=``.
_TORCH_RANDOM_FNS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
}

# Call wrappers whose argument order is observable output order.
_ORDER_SENSITIVE_WRAPPERS = {"list", "tuple", "enumerate", "iter"}


def _is_set_expr(
    node: ast.AST, set_vars: Set[str], set_fields: Set[str] = frozenset()
) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        if node.func.id in ("set", "frozenset"):
            return True
    if isinstance(node, ast.Name) and node.id in set_vars:
        return True
    # Attribute whose name is a set-annotated field of a class defined in
    # this module (e.g. a dataclass field ``subtree_uuids: Set[str]``):
    # any ``x.subtree_uuids`` is assumed to be that set.
    if isinstance(node, ast.Attribute) and node.attr in set_fields:
        return True
    return False


def _set_annotated_fields(tree: ast.AST) -> Set[str]:
    """Field names with a set-typed annotation on any class in the module
    (class-level AnnAssign: ``name: Set[str]`` / ``name: set``)."""
    fields: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                ann = stmt.annotation
                base = ann.value if isinstance(ann, ast.Subscript) else ann
                name = dotted_name(base)
                if name and name.split(".")[-1] in (
                    "Set", "set", "FrozenSet", "frozenset", "MutableSet",
                ):
                    fields.add(stmt.target.id)
    return fields


def _collect_set_vars(fn: ast.AST) -> Set[str]:
    """Names bound to set expressions and never rebound to anything else
    within this scope (module or one function; nested defs excluded)."""
    sets: Set[str] = set()
    other: Set[str] = set()

    def walk_shallow(node: ast.AST):
        # Walk statements without descending into nested function/class
        # scopes (their bindings are theirs).
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                 ast.Lambda),
            ):
                continue
            yield child
            yield from walk_shallow(child)

    for node in walk_shallow(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if _is_set_expr(node.value, set()):
                        sets.add(t.id)
                    else:
                        other.add(t.id)
        elif isinstance(node, ast.AugAssign):
            t = node.target
            if isinstance(t, ast.Name):
                # Set-algebra updates (s |= other, s -= dead, ...) keep a
                # tracked set a set; anything else unmarks it.
                keeps = isinstance(
                    node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)
                ) and (t.id in sets or _is_set_expr(node.value, sets))
                if not keeps:
                    other.add(t.id)
        elif isinstance(node, ast.AnnAssign):
            t = node.target
            if isinstance(t, ast.Name):
                other.add(t.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            t = node.target
            if isinstance(t, ast.Name):
                other.add(t.id)
    return sets - other


class DeterminismRule(Rule):
    name = "determinism"
    # chaos/ is in scope because fault plans MUST be seed-reproducible:
    # a soak whose faults fire off the wall clock or an OS-entropy RNG
    # cannot be re-driven from its flight trace, which voids the whole
    # subsystem's replayability contract.  obs/ is in
    # scope with an extra confinement sub-check: the tracer
    # (obs/trace.py) is the ONE module in the telemetry plane allowed
    # to read a clock — everything else (metrics registry, exporters)
    # must take durations from it, or metrics and timeline drift apart.
    scopes = (
        "poseidon_tpu_torch/replay/", "poseidon_tpu_torch/graph/",
        "poseidon_tpu_torch/ops/", "poseidon_tpu_torch/chaos/",
        "poseidon_tpu_torch/obs/",
    )

    # Clock reads confined to obs/trace.py within obs/ (time.time is
    # flagged everywhere in scope already; these are the non-wall clock
    # reads the confinement additionally forbids outside the tracer).
    _CLOCK_FNS = frozenset({
        "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
        "time_ns", "process_time", "process_time_ns",
        "clock_gettime", "clock_gettime_ns",
        "thread_time", "thread_time_ns",
    })

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        time_aliases = import_aliases(tree, "time")
        time_fns = {
            local
            for local, orig in from_imports(tree, "time").items()
            if orig == "time"
        }
        random_aliases = import_aliases(tree, "random")
        random_fns = {
            local: orig
            for local, orig in from_imports(tree, "random").items()
            if orig in _RANDOM_FNS
        }
        np_aliases = import_aliases(tree, "numpy")
        torch_aliases = import_aliases(tree, "torch")

        findings: List[Finding] = []

        def flag(node: ast.AST, message: str) -> None:
            findings.append(Finding(path, node.lineno, self.name, message))

        norm_path = path.replace("\\", "/")
        clock_confined = (
            "poseidon_tpu_torch/obs/" in norm_path
            and not norm_path.endswith("poseidon_tpu_torch/obs/trace.py")
        )
        clock_fns = (
            {
                local
                for local, orig in from_imports(tree, "time").items()
                if orig in self._CLOCK_FNS
            }
            if clock_confined else frozenset()
        )
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(
                    node, flag, time_aliases, time_fns, random_aliases,
                    random_fns, np_aliases,
                )
                self._check_torch_rng(node, flag, torch_aliases)
                if clock_confined:
                    self._check_clock_confinement(
                        node, flag, time_aliases, clock_fns
                    )

        # Set iteration: per-scope variable tracking, then flag iteration
        # sites.  Scopes: the module plus every function (nested included —
        # ast.walk reaches them; each tracks only its own bindings).
        scopes: List[ast.AST] = [tree]
        scopes.extend(
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )
        set_fields = _set_annotated_fields(tree)
        for scope in scopes:
            set_vars = _collect_set_vars(scope)
            self._check_set_iteration(scope, set_vars, set_fields, flag)

        self._check_import_time_env(tree, flag)
        self._check_torch_generators(tree, flag, torch_aliases)
        return findings

    # -- torch RNG ---------------------------------------------------------

    def _check_torch_rng(self, node, flag, torch_aliases) -> None:
        fname = dotted_name(node.func)
        if fname is None:
            return
        head, _, rest = fname.partition(".")
        if head in torch_aliases and rest in _TORCH_RANDOM_FNS and not any(
            kw.arg == "generator" for kw in node.keywords
        ):
            flag(node, f"unseeded global torch RNG `{fname}()`; pass a "
                       "seeded `torch.Generator` as `generator=`")

    def _check_torch_generators(self, tree, flag, torch_aliases) -> None:
        """A ``torch.Generator(...)`` must be ``.manual_seed``-ed: chained
        (``torch.Generator().manual_seed(s)``) or, when bound to a name,
        through that name somewhere in the module."""
        seeded: Set[str] = set()
        chained: Set[int] = set()
        bound: dict = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr == "manual_seed":
                recv = node.func.value
                if isinstance(recv, ast.Name):
                    seeded.add(recv.id)
                chained.add(id(recv))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                bound[id(node.value)] = node.targets[0].id
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname is None:
                continue
            head, _, rest = fname.partition(".")
            if head not in torch_aliases or rest != "Generator":
                continue
            if id(node) in chained or bound.get(id(node)) in seeded:
                continue
            flag(node, "`torch.Generator()` never `.manual_seed`-ed "
                       "starts from torch's fixed default seed; seed it "
                       "from the run's seed")

    # -- import-time environment reads -------------------------------------

    def _check_import_time_env(self, tree: ast.AST, flag) -> None:
        os_aliases = import_aliases(tree, "os")
        env_fns = {
            local
            for local, orig in from_imports(tree, "os").items()
            if orig in ("getenv", "environ")
        }

        def is_env_read(node: ast.AST) -> bool:
            if isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname is None:
                    return False
                head, _, rest = fname.partition(".")
                if head in os_aliases and rest in (
                    "getenv", "environ.get",
                ):
                    return True
                if head in env_fns and rest in ("", "get"):
                    return True
            if isinstance(node, ast.Subscript):
                vname = dotted_name(node.value)
                if vname is None:
                    return False
                head, _, rest = vname.partition(".")
                if head in os_aliases and rest == "environ":
                    return True
                if head in env_fns and not rest:
                    return True
            return False

        def walk_import_time(node: ast.AST):
            # Module and class bodies execute at import; function BODIES
            # do not — their env reads are call-time.  But a def's
            # decorators and argument DEFAULTS evaluate when the def
            # statement runs (import time for module/class-level defs),
            # so those subtrees stay in the walk.
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    args = child.args
                    for sub in (
                        *getattr(child, "decorator_list", ()),
                        *args.defaults,
                        *(d for d in args.kw_defaults if d is not None),
                    ):
                        yield sub
                        yield from walk_import_time(sub)
                    continue
                yield child
                yield from walk_import_time(child)

        for node in walk_import_time(tree):
            if is_env_read(node):
                flag(node, "environment read at import time pins the "
                           "value for the process (tests/bench setting "
                           "it later silently no-op); read at call time "
                           "or through an accessor")

    # -- clock confinement (obs/ outside the tracer) -----------------------

    def _check_clock_confinement(self, node, flag, time_aliases,
                                 clock_fns) -> None:
        fname = dotted_name(node.func)
        if fname is None:
            return
        head, _, rest = fname.partition(".")
        if (head in time_aliases and rest in self._CLOCK_FNS) or (
            not rest and head in clock_fns
        ):
            flag(node, f"clock read `{fname}()` outside obs/trace.py; "
                       "the tracer is the one clock owner in the "
                       "telemetry plane — take durations from spans")

    # -- wall clock + RNG --------------------------------------------------

    def _check_call(
        self, node, flag, time_aliases, time_fns, random_aliases,
        random_fns, np_aliases,
    ) -> None:
        fname = dotted_name(node.func)
        if fname is None:
            return
        head, _, rest = fname.partition(".")
        if (head in time_aliases and rest == "time") or (
            not rest and head in time_fns
        ):
            flag(node, "wall-clock `time.time()` in the replay/parity "
                       "path; use the driver's virtual time or inject a "
                       "clock")
            return
        if head in random_aliases and rest in _RANDOM_FNS:
            flag(node, f"unseeded global RNG `{fname}()`; thread a seeded "
                       "`random.Random(seed)` through instead")
            return
        if not rest and head in random_fns:
            flag(node, f"unseeded global RNG `random.{random_fns[head]}()`"
                       "; thread a seeded `random.Random(seed)` through "
                       "instead")
            return
        if head in np_aliases and rest.startswith("random."):
            sub = rest[len("random."):]
            if sub == "default_rng":
                if not node.args and not node.keywords:
                    flag(node, "`default_rng()` without a seed draws OS "
                               "entropy; pass an explicit seed")
            elif sub not in ("Generator", "RandomState", "SeedSequence"):
                flag(node, f"unseeded global RNG `{fname}()`; use "
                           "`np.random.default_rng(seed)` streams")

    # -- set iteration -----------------------------------------------------

    def _check_set_iteration(self, scope, set_vars, set_fields, flag) -> None:
        def shallow(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                yield child
                yield from shallow(child)

        msg = (
            "iteration over an unordered set feeds ordering-sensitive "
            "output; wrap in sorted(...)"
        )
        for node in shallow(scope):
            if isinstance(node, ast.For) and _is_set_expr(
                node.iter, set_vars, set_fields
            ):
                flag(node.iter, msg)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                for comp in node.generators:
                    if _is_set_expr(comp.iter, set_vars, set_fields):
                        flag(comp.iter, msg)
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id in _ORDER_SENSITIVE_WRAPPERS
                    and node.args
                    and _is_set_expr(node.args[0], set_vars, set_fields)
                ):
                    flag(node, msg)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                    and node.args
                    and _is_set_expr(node.args[0], set_vars, set_fields)
                ):
                    flag(node, msg)

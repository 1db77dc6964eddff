"""numerics: int32 overflow, inf-sentinel hygiene, promotion hazards.

Scope: ``poseidon_tpu_torch/ops/``, ``poseidon_tpu_torch/costmodel/``,
``poseidon_tpu_torch/graph/`` — the int32 solver substrate (overridable
via the ``POSEIDON_NUMERICS_SCOPES`` hatch, comma-separated fragments,
read through the port's registry).  The port's counterpart of
``poseidon_tpu/check/numerics_discipline.py``.  The solver is int32 end
to end because that is what the kernels run natively, and int32
arithmetic wraps silently in numpy, in torch and in CUDA (there is no
trap): a slot-capacity product that crosses 2^31 at cluster scale
routes flow through a *negative* capacity, invisible at test scale.
The runtime twin is ``check.ledger.NumericsLedger`` plus the certified
helpers in ``utils/numerics.py``.

Three sub-checks (message prefixes ``i32-overflow:``, ``inf-sentinel:``,
``promotion:``; suppress with ``# posecheck: ignore[numerics]`` plus a
justification for the bound that makes the line safe).  The numpy
sub-checks are the reference's, unchanged, because the port's host side
is the same numpy; torch adds its own meanings:

- **i32-overflow**: ``sum``/``cumsum``/``prod``/``dot``/``matmul``
  reductions over numpy arrays dataflow-tagged int32 (dtype= kwargs,
  astype casts, propagated through where/minimum/arithmetic) without
  widening (``dtype=np.int64`` / a float accumulator / the
  ``utils.numerics.widen_counts`` certificate); ``*`` between two
  int32-tagged arrays or tensors (a count product is exactly the
  cluster-scale wrap); and narrowing ``astype(int32)`` /
  ``.to(torch.int32)`` casts of unbounded float-ish values
  (floor/rint/division chains, tracked through ``where``) without a
  clip — ``np.clip``/``np.minimum(x, BOUND)``/``torch.clamp``/
  ``torch.minimum``/``utils.numerics.checked_narrow_i32`` all count as
  declared bounds.  Tensors are tagged int32 by ``dtype=torch.int32``
  (or a module alias of it, such as ``I32``) and ``.to(torch.int32)``.
- **inf-sentinel**: the cost planes carry ``INF_COST`` (2^28, an int32
  *sentinel*, not a number) on forbidden arcs.  Additive arithmetic
  through such a plane silently compounds sentinels into garbage that
  still *looks* like a big cost.  The lattice seeds at construction
  sites (expressions mentioning a sentinel constant), propagates through
  arithmetic, subscripts, aliases, and — cross-file, resolved in
  ``finalize()`` — through calls to functions that return a tainted
  plane.  Cleansed by a finiteness-guarded ``where`` (condition mentions
  ``isfinite``/``isinf``, or compares against the sentinel), by
  ``minimum``/``clip``/``torch.clamp`` against a non-tainted bound, or
  by masked comparison.  ``min``/``max`` reductions stay legal;
  ``sum``/``mean``/``dot``/``cumsum``/``prod`` through a tainted plane
  are findings.  torch's index producers (``torch.argsort``,
  ``argmin``, ``argmax``, ``nonzero``, ``argwhere``, ``searchsorted``)
  return positions, not costs, and carry no sentinel.
- **promotion**: torch's parity trap — an int32-tagged tensor summed
  with ``.sum()``, ``torch.sum`` or ``torch.cumsum`` (or ``prod``)
  *without* ``dtype=`` returns int64, where the reference accumulates
  in int32; pass ``dtype=torch.int32`` (a declared int32 accumulator,
  as the reference's, is not flagged).  Inside a kernel wrapper (the
  reference's jitted def), mixing operands tagged with different dtype
  families in bare arithmetic, or a Python float literal against an
  int32-tagged operand, promotes by table, not by intent; and a float
  literal passed positionally to a kernel wrapper ships an untyped
  scalar to int32 operands.

Dataflow is per-function, name-based, and LINE-ORDERED: rebinding
through a clamp (``n = np.minimum(n, big)``) genuinely cleanses the name
from then on, which is exactly the sanctioned fix shape.
Over-approximation is possible through aliasing; every finding names
the operand so a justified ``ignore[numerics]`` documents the bound.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    import_aliases,
    suppressions,
)
from poseidon_tpu_torch.check.jit_purity import kernel_wrappers

_DEFAULT_SCOPES = (
    "poseidon_tpu_torch/ops/", "poseidon_tpu_torch/costmodel/",
    "poseidon_tpu_torch/graph/",
)

# Reductions that accumulate (overflow risk / sentinel mixing).  min/max
# family is deliberately absent: it neither accumulates nor mixes.
_ACC_REDUCTIONS = ("sum", "cumsum", "prod", "cumprod", "dot", "matmul")
# torch reductions whose int32 input returns int64 unless dtype= is given.
_TORCH_PROMOTING = ("sum", "cumsum", "prod", "cumprod")
# torch calls returning positions, not values: no sentinel survives them.
_INDEX_PRODUCERS = (
    "argsort", "argmin", "argmax", "nonzero", "argwhere", "searchsorted",
)
_SENTINEL_REDUCTIONS = (
    "sum", "cumsum", "prod", "cumprod", "dot", "matmul", "mean", "average",
)
_FLOOR_FNS = ("floor", "rint", "ceil", "round", "around", "trunc", "fix")
_CERTIFIED_NARROWS = ("checked_narrow_i32",)
_CERTIFIED_WIDENS = ("widen_counts", "certify_i32")

_DTYPE_TAGS = {
    "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
    "uint8": "u8", "uint16": "u16", "uint32": "u32", "uint64": "u64",
    "float16": "f16", "bfloat16": "bf16", "float32": "f32",
    "float64": "f64", "bool_": "bool", "bool": "bool",
    # The port's conventional module aliases of torch dtypes.
    "I32": "i32", "I64": "i64",
}
_NARROW_INT_TAGS = {"i8", "i16", "i32", "u8", "u16", "u32"}
_WIDE_ACC_TAGS = {"i64", "u64", "f32", "f64", "bf16", "f16"}


def _family(tag: str) -> str:
    if tag in ("bool",):
        return "bool"
    return "int" if tag.startswith(("i", "u")) else "float"


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dtype_tag(node: Optional[ast.AST]) -> Optional[str]:
    """'i32'/'f32'/... for np.int32 / jnp.float32 / "int32" nodes."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _DTYPE_TAGS.get(node.value)
    d = dotted_name(node)
    if d:
        return _DTYPE_TAGS.get(d.rpartition(".")[2])
    return None


def _dtype_kwarg(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _dtype_tag(kw.value)
    return None


def _call_tail(call: ast.Call) -> Optional[str]:
    d = dotted_name(call.func)
    return d.rpartition(".")[2] if d else None


def _call_head(call: ast.Call) -> Optional[str]:
    d = dotted_name(call.func)
    return d.partition(".")[0] if d else None


def _mentions_name(node: ast.AST, names: Set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in names for n in ast.walk(node)
    )


def _mentions_outside_compare(node: ast.AST, names: Set[str]) -> bool:
    """Sentinel mention that is NOT inside a comparison: ``x >= INF_COST``
    is the sanctioned way to consume a sentinel, never a seed."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Compare):
            continue
        if isinstance(n, ast.Name) and n.id in names:
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


def _site_root(node: ast.AST) -> Optional[str]:
    """Bare-Name root of a Name/Subscript chain; Attribute chains return
    None — taint is plane-granular, and ``sol.objective`` on a tainted
    ``sol`` is a different value than the tainted plane itself."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _mentions_call(node: ast.AST, tails: Sequence[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            t = _call_tail(n)
            if t in tails:
                return True
    return False


def _ordered_simple_stmts(scope: ast.AST):
    """Simple statements of ``scope`` in source order, descending into
    compound bodies but never into nested defs/lambdas/classes."""
    def rec(stmts):
        for s in stmts:
            if isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(
                s, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr,
                    ast.Return, ast.Assert)
            ):
                yield s
                continue
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub:
                    yield from rec(sub)
            for h in getattr(s, "handlers", []) or []:
                yield from rec(h.body)
    yield from rec(getattr(scope, "body", []))


def _walk_no_lambda(node: ast.AST):
    """ast.walk that does not descend into lambdas (their bodies run in
    another activation; name tracking does not transfer)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, ast.Lambda):
                continue
            stack.append(child)


def _assign_targets(node: ast.stmt) -> Tuple[str, ...]:
    targets: List[str] = []
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                targets.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                targets.extend(
                    e.id for e in t.elts if isinstance(e, ast.Name)
                )
    elif isinstance(node, ast.AnnAssign) and isinstance(
        node.target, ast.Name
    ) and node.value is not None:
        targets.append(node.target.id)
    return tuple(targets)


# -------------------------------------------------- sentinel lattice facts

# assign specs, replayed in finalize: ("seed",) / ("cleanse",) /
# ("taint_if", roots) / ("call", callee_tail)
_AssignSpec = Tuple


@dataclass
class _SentinelFn:
    fn: str
    # line-ordered events: ("assign", line, targets, spec) |
    # ("site_binop", line, op, roots, always) |
    # ("site_reduce", line, opname, root) | ("return", line, roots)
    events: List[Tuple] = field(default_factory=list)


@dataclass
class _FileFacts:
    path: str
    wrappers: Set[str] = field(default_factory=set)
    sentinel_fns: List[_SentinelFn] = field(default_factory=list)
    # (line, callee_tail, literal) — float literals at call boundaries,
    # resolved against the scan-wide kernel-wrapper union in finalize.
    literal_sites: List[Tuple[int, str, str]] = field(
        default_factory=list
    )
    suppressed: Set[int] = field(default_factory=set)


class NumericsDisciplineRule(Rule):
    name = "numerics"
    scopes = _DEFAULT_SCOPES

    def __init__(self) -> None:
        self._files: List[_FileFacts] = []
        raw = ""
        try:
            from poseidon_tpu_torch.utils.hatches import hatch_str
            raw = hatch_str("POSEIDON_NUMERICS_SCOPES")
        except Exception:  # noqa: BLE001 - registry unavailable mid-bootstrap
            raw = ""
        if raw:
            self.scopes = tuple(
                s.strip() for s in raw.split(",") if s.strip()
            )

    # ---------------------------------------------------------------- check

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        num_aliases = (
            import_aliases(tree, "numpy")
            | import_aliases(tree, "jax.numpy")
            | {"np", "jnp"}
        )
        torch_aliases = import_aliases(tree, "torch") | {"torch"}

        facts = _FileFacts(path=path)
        for lineno, rules in suppressions(source).items():
            if rules is None or self.name in rules:
                facts.suppressed.add(lineno)

        sentinel_consts = self._sentinel_consts(tree)
        # Kernel wrappers: the port's counterpart of the jitted defs.
        wrappers = kernel_wrappers(tree)
        facts.wrappers.update(wrappers)
        wrapper_defs = {id(fn) for fn in wrappers.values()}

        findings: List[Finding] = []
        scopes: List[Tuple[str, ast.AST]] = [("<module>", tree)] + [
            (n.name, n) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for fn_name, scope in scopes:
            self._overflow_pass(
                scope, fn_name, path, num_aliases, torch_aliases, findings
            )
            facts.sentinel_fns.append(self._sentinel_facts(
                scope, fn_name, num_aliases, torch_aliases, sentinel_consts
            ))
            if id(scope) in wrapper_defs:
                self._promotion_pass(
                    scope, fn_name, path, num_aliases | torch_aliases,
                    findings,
                )
        self._collect_literal_sites(tree, facts)

        self._files.append(facts)
        return findings

    # ------------------------------------------------------- i32 overflow

    def _overflow_pass(
        self, scope, fn_name, path, num_aliases, torch_aliases, findings
    ) -> None:
        # int32-tagged names: numpy arrays and torch tensors apart (a
        # torch sum of int32 promotes; a numpy one wraps).
        i32: Set[str] = set()
        t32: Set[str] = set()
        floaty: Set[str] = set()
        heads = num_aliases | torch_aliases

        def dtype_is_torch(node: Optional[ast.AST]) -> bool:
            d = dotted_name(node) if node is not None else None
            if d is None:
                return False
            head = d.partition(".")[0]
            return head in torch_aliases or d in ("I32", "I64")

        def tagged(v: ast.AST, names: Set[str], torch: bool) -> bool:
            """Is ``v`` an int32 array (``torch=False``) or tensor
            (``torch=True``)?"""
            if isinstance(v, ast.Name):
                return v.id in names
            if isinstance(v, (ast.Attribute, ast.Subscript)):
                r = _root_name(v)
                return r is not None and r in names
            if isinstance(v, ast.BinOp) and isinstance(
                v.op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod)
            ):
                return tagged(v.left, names, torch) or \
                    tagged(v.right, names, torch)
            if isinstance(v, ast.Call):
                tail = _call_tail(v)
                if tail in ("astype", "to") and isinstance(
                    v.func, ast.Attribute
                ):
                    base = v.func.value
                    arg = v.args[0] if v.args else None
                    for kw in v.keywords:
                        if kw.arg == "dtype":
                            arg = kw.value
                    tag = _dtype_tag(arg)
                    if tag == "i32" and not isinstance(base, ast.Compare):
                        return (tail == "to" or dtype_is_torch(arg)) \
                            == torch
                    return False
                if tail in _CERTIFIED_NARROWS:
                    return False  # certified: bounded by construction
                for kw in v.keywords:
                    if kw.arg == "dtype" and _dtype_tag(kw.value) == "i32":
                        return dtype_is_torch(kw.value) == torch
                if tail in ("where", "minimum", "maximum", "abs",
                            "absolute", "clamp") and (
                                _call_head(v) in
                                (torch_aliases if torch else num_aliases)
                ):
                    return any(tagged(a, names, torch) for a in v.args)
            return False

        def expr_floaty(v: ast.AST) -> bool:
            if isinstance(v, ast.Name):
                return v.id in floaty
            if isinstance(v, (ast.Attribute, ast.Subscript)):
                r = _root_name(v)
                return r is not None and r in floaty
            if isinstance(v, ast.BinOp):
                if isinstance(v.op, ast.Div):
                    return True
                return expr_floaty(v.left) or expr_floaty(v.right)
            if isinstance(v, ast.Call):
                tail = _call_tail(v)
                head = _call_head(v)
                if head in heads and tail in _FLOOR_FNS:
                    # floor(x): unbounded float-ish unless x already
                    # carries a bound — floor itself adds none.
                    return True
                if head in heads and tail == "where":
                    return any(expr_floaty(a) for a in v.args)
                if head in heads and tail == "minimum":
                    # minimum bounds above ONLY when the other operand
                    # is itself bounded; min of two unbounded floats is
                    # still unbounded.
                    fl = [expr_floaty(a) for a in v.args]
                    return all(fl) if fl else False
                if head in heads and tail == "maximum":
                    return any(expr_floaty(a) for a in v.args)
                if head in heads and tail in ("clip", "clamp"):
                    return False  # bounds declared
                if tail in _CERTIFIED_NARROWS + _CERTIFIED_WIDENS:
                    return False
            return False

        for stmt in _ordered_simple_stmts(scope):
            # Sites first (RHS evaluates before the binding lands).
            for node in _walk_no_lambda(stmt):
                if isinstance(node, ast.Call):
                    self._overflow_call_site(
                        node, fn_name, path, num_aliases, torch_aliases,
                        i32, t32, floaty, findings,
                    )
                elif isinstance(node, ast.BinOp) and isinstance(
                    node.op, ast.Mult
                ):
                    lr = _root_name(node.left)
                    rr = _root_name(node.right)
                    tags = i32 | t32
                    if (
                        lr is not None and rr is not None
                        and lr in tags and rr in tags
                    ):
                        findings.append(Finding(
                            path, node.lineno, self.name,
                            f"i32-overflow: `{lr} * {rr}` multiplies two "
                            "int32-tagged arrays — a count product is "
                            "exactly the cluster-scale wrap; widen "
                            "one side to int64 (or document the bound "
                            "with # posecheck: ignore[numerics])",
                        ))
            targets = _assign_targets(stmt)
            if targets and getattr(stmt, "value", None) is not None:
                v = stmt.value
                is_i32 = tagged(v, i32, False)
                is_t32 = tagged(v, t32, True)
                is_fl = expr_floaty(v)
                for t in targets:
                    i32.add(t) if is_i32 else i32.discard(t)
                    t32.add(t) if is_t32 else t32.discard(t)
                    floaty.add(t) if is_fl else floaty.discard(t)

    def _overflow_call_site(
        self, node, fn_name, path, num_aliases, torch_aliases, i32, t32,
        floaty, findings,
    ) -> None:
        tail = _call_tail(node)
        head = _call_head(node)
        # torch's parity trap: an int32 tensor's sum without dtype= is
        # int64 (``x.sum()`` on any receiver chain, ``torch.sum(x)``).
        t_op = None
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TORCH_PROMOTING:
            t_op = node.func.attr
            recv = node.func.value
            t_operand = node.args[0] if head in torch_aliases and \
                node.args else recv
            if head in num_aliases:
                t_operand = None
            root = _root_name(t_operand) if t_operand is not None else None
            if root is not None and root in t32:
                if _dtype_kwarg(node) is None:
                    findings.append(Finding(
                        path, node.lineno, self.name,
                        f"promotion: `{t_op}` of int32-tagged tensor "
                        f"`{root}` without dtype= returns int64 in torch, "
                        "where the reference accumulates in int32 — pass "
                        "dtype=torch.int32 (the port's parity trap)",
                    ))
                return
        if tail in _ACC_REDUCTIONS:
            operand: Optional[ast.AST] = None
            if head in num_aliases and node.args:
                operand = node.args[0]
            elif isinstance(node.func, ast.Attribute) and head not in (
                num_aliases
            ):
                operand = node.func.value
            if operand is not None:
                root = _root_name(operand)
                acc = _dtype_kwarg(node)
                widened = acc in _WIDE_ACC_TAGS
                if root is not None and root in i32 and not widened:
                    findings.append(Finding(
                        path, node.lineno, self.name,
                        f"i32-overflow: `{tail}` over int32-tagged "
                        f"`{root}` accumulates in int32 and wraps "
                        "silently at scale — pass dtype=np.int64, "
                        "widen through utils.numerics.widen_counts, or "
                        "document the saturation bound "
                        "(# posecheck: ignore[numerics])",
                    ))
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("astype", "to"):
            # NOT via _call_tail: `np.floor(x).astype(i32)` roots the
            # attribute chain in a Call, where dotted_name returns None.
            meth = node.func.attr
            arg = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "dtype":
                    arg = kw.value
            tag = _dtype_tag(arg)
            if tag not in _NARROW_INT_TAGS:
                return
            base = node.func.value
            if isinstance(base, ast.Compare):
                return  # bool mask -> 0/1: no magnitude to wrap
            hazard = False
            if isinstance(base, ast.BinOp) and isinstance(
                base.op, ast.Div
            ):
                hazard = True
            elif isinstance(base, ast.Call):
                btail = _call_tail(base)
                bhead = _call_head(base)
                if bhead in num_aliases | torch_aliases and \
                        btail in _FLOOR_FNS:
                    hazard = True
            else:
                root = _root_name(base)
                hazard = root is not None and root in floaty
            if hazard:
                subj = _root_name(base) or ast.unparse(base)
                findings.append(Finding(
                    path, node.lineno, self.name,
                    f"i32-overflow: narrowing `{meth}({tag})` of "
                    f"unbounded float-ish `{subj}` truncates through "
                    "the int32 rails silently — clamp first (np.clip / "
                    "np.minimum against a declared bound / "
                    "utils.numerics.checked_narrow_i32)",
                ))
            return
        if (
            tail in ("asarray", "array") and head in num_aliases
            and node.args and _dtype_kwarg(node) in _NARROW_INT_TAGS
        ):
            root = _root_name(node.args[0])
            if root is not None and root in floaty:
                findings.append(Finding(
                    path, node.lineno, self.name,
                    f"i32-overflow: `{tail}(..., dtype=int32)` of "
                    f"unbounded float-ish `{root}` truncates through "
                    "the int32 rails silently — clamp first (np.clip / "
                    "utils.numerics.checked_narrow_i32)",
                ))

    # ---------------------------------------------------- sentinel lattice

    def _sentinel_consts(self, tree: ast.Module) -> Set[str]:
        consts: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    local = a.asname or a.name
                    if "INF" in a.name and a.name.isupper():
                        consts.add(local)
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Name)
                        and "INF" in t.id
                        and t.id.isupper()
                        and not _mentions_call(node.value, ("float",))
                        and not any(
                            isinstance(n, ast.Name)
                            for n in ast.walk(node.value)
                        )
                    ):
                        consts.add(t.id)
        # float("inf") / np.inf sentinels are FLOAT planes — the
        # finiteness half of NumericsLedger owns those; this lattice is
        # the int32 sentinel (INF_COST-class) one.
        return consts

    def _sentinel_facts(
        self, scope, fn_name, num_aliases, torch_aliases, consts
    ) -> _SentinelFn:
        sf = _SentinelFn(fn=fn_name)
        where_heads = num_aliases | torch_aliases

        def guarded_where(call: ast.Call) -> bool:
            """A where whose condition tests finiteness — either float
            (isfinite/isinf) or integer (a comparison against a sentinel
            constant) — is the sanctioned guard, not a propagator."""
            if not call.args:
                return False
            cond = call.args[0]
            if _mentions_call(cond, ("isfinite", "isinf")):
                return True
            return any(
                isinstance(n, ast.Compare) and _mentions_name(n, consts)
                for n in ast.walk(cond)
            )

        def classify(v: ast.AST) -> _AssignSpec:
            if isinstance(v, ast.Call):
                tail = _call_tail(v)
                head = _call_head(v)
                if head in torch_aliases and tail in _INDEX_PRODUCERS:
                    return ("cleanse",)  # positions, not costs
                if head in where_heads and tail == "where":
                    value_args = v.args[1:]
                    if any(
                        _mentions_outside_compare(a, consts)
                        for a in value_args
                    ):
                        return ("seed",)  # rails written into the plane
                    if guarded_where(v):
                        return ("cleanse",)
                    roots = tuple(
                        r for a in v.args
                        for r in [_root_name(a)] if r
                    )
                    return ("taint_if", roots)
                if head in where_heads and tail in (
                    "minimum", "clip", "clamp"
                ):
                    # Bounded above by a non-tainted operand: the
                    # sentinel can no longer dominate arithmetic.
                    return ("cleanse",)
                if _mentions_outside_compare(v, consts):
                    return ("seed",)
                if tail is not None and "." not in (
                    dotted_name(v.func) or "."
                ):
                    return ("call", tail)
                # Method / dotted calls (cost.copy(), cost[ix].ravel()):
                # taint flows through the receiver and the arguments.
                roots = tuple(
                    r for src in ([v.func] + list(v.args))
                    for r in [_root_name(src)] if r
                )
                return ("taint_if", roots)
            if _mentions_outside_compare(v, consts):
                return ("seed",)
            roots = tuple(
                n.id for n in ast.walk(v) if isinstance(n, ast.Name)
            )
            return ("taint_if", roots)

        for stmt in _ordered_simple_stmts(scope):
            # Arithmetic lexically inside a guarded where's branches is
            # where-guarded by definition (the sentinel cells are
            # discarded by the select) — exclude those subtrees.
            guarded_nodes: Set[int] = set()
            for node in _walk_no_lambda(stmt):
                if (
                    isinstance(node, ast.Call)
                    and _call_tail(node) == "where"
                    and _call_head(node) in where_heads
                    and guarded_where(node)
                ):
                    for arg in node.args[1:]:
                        guarded_nodes.update(
                            id(n) for n in ast.walk(arg)
                        )
            for node in _walk_no_lambda(stmt):
                if id(node) in guarded_nodes:
                    continue
                if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Add, ast.Sub, ast.Mult)
                ):
                    if isinstance(
                        node.left, (ast.Tuple, ast.List)
                    ) or isinstance(node.right, (ast.Tuple, ast.List)):
                        continue  # tuple/list concat, not plane math
                    # Bare-Name/Subscript operands only; scalar rail
                    # math on the constant itself (INF_COST - 1) and
                    # attribute reads off tainted objects are sanctioned.
                    roots = tuple(
                        r for side in (node.left, node.right)
                        for r in [_site_root(side)]
                        if r and r not in consts
                    )
                    op = {
                        ast.Add: "+", ast.Sub: "-", ast.Mult: "*",
                    }[type(node.op)]
                    if roots:
                        sf.events.append((
                            "site_binop", node.lineno, op, roots, False,
                        ))
                elif isinstance(node, ast.Call):
                    tail = _call_tail(node)
                    head = _call_head(node)
                    operand: Optional[ast.AST] = None
                    if tail in _SENTINEL_REDUCTIONS:
                        if head in where_heads and node.args:
                            operand = node.args[0]
                        elif isinstance(node.func, ast.Attribute):
                            operand = node.func.value
                    if operand is not None:
                        root = _root_name(operand)
                        if root:
                            sf.events.append((
                                "site_reduce", node.lineno, tail, root,
                            ))
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                elts = stmt.value.elts if isinstance(
                    stmt.value, (ast.Tuple, ast.List)
                ) else [stmt.value]
                roots = tuple(
                    r for e in elts for r in [_root_name(e)] if r
                )
                if roots:
                    sf.events.append(("return", stmt.lineno, roots))
            targets = _assign_targets(stmt)
            if targets and getattr(stmt, "value", None) is not None:
                sf.events.append((
                    "assign", stmt.lineno, targets,
                    classify(stmt.value),
                ))
        return sf

    def _replay_sentinel(
        self, sf: _SentinelFn, producers: Set[str],
    ) -> Tuple[bool, List[Tuple[int, str]]]:
        """(returns_tainted, [(line, message)]) for one function."""
        tainted: Set[str] = set()
        hits: List[Tuple[int, str]] = []
        returns_tainted = False
        for ev in sf.events:
            kind = ev[0]
            if kind == "assign":
                _k, _line, targets, spec = ev
                if spec[0] == "seed":
                    tainted.update(targets)
                elif spec[0] == "cleanse":
                    tainted.difference_update(targets)
                elif spec[0] == "taint_if":
                    if any(r in tainted for r in spec[1]):
                        tainted.update(targets)
                    else:
                        tainted.difference_update(targets)
                elif spec[0] == "call":
                    if spec[1] in producers:
                        tainted.update(targets)
                    else:
                        tainted.difference_update(targets)
            elif kind == "site_binop":
                _k, line, op, roots, always = ev
                bad = [r for r in roots if r in tainted]
                if always or bad:
                    subj = bad[0] if bad else "a sentinel constant"
                    hits.append((line, (
                        f"inf-sentinel: `{op}` through inf-carrying "
                        f"plane `{subj}` compounds the INF_COST "
                        "sentinel into ordinary-looking cost — guard "
                        "with np.where(np.isfinite(...)) / np.minimum "
                        "against a cap before arithmetic"
                    )))
            elif kind == "site_reduce":
                _k, line, opname, root = ev
                if root in tainted:
                    hits.append((line, (
                        f"inf-sentinel: `{opname}` over inf-carrying "
                        f"plane `{root}` mixes INF_COST sentinels into "
                        "the accumulated total — mask the forbidden "
                        "arcs first (min/max reductions stay legal)"
                    )))
            elif kind == "return":
                _k, _line, roots = ev
                if any(r in tainted for r in roots):
                    returns_tainted = True
        return returns_tainted, hits

    # ----------------------------------------------------------- promotion

    def _promotion_pass(
        self, scope, fn_name, path, num_aliases, findings
    ) -> None:
        tags: Dict[str, str] = {}

        def tag_of_expr(v: ast.AST) -> Optional[str]:
            if isinstance(v, ast.Call):
                tail = _call_tail(v)
                if tail in ("astype", "to") and v.args:
                    base = v.func.value if isinstance(
                        v.func, ast.Attribute
                    ) else None
                    if isinstance(base, ast.Compare):
                        return "bool"
                    return _dtype_tag(v.args[0])
                kw = _dtype_kwarg(v)
                if kw is not None:
                    return kw
                if _call_head(v) in num_aliases and tail in _DTYPE_TAGS:
                    return _DTYPE_TAGS[tail]  # jnp.float32(x) casts
            elif isinstance(v, ast.Name):
                return tags.get(v.id)
            return None

        for stmt in _ordered_simple_stmts(scope):
            for node in _walk_no_lambda(stmt):
                if not isinstance(node, ast.BinOp) or not isinstance(
                    node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)
                ):
                    continue
                lt = tags.get(node.left.id) if isinstance(
                    node.left, ast.Name
                ) else None
                rt = tags.get(node.right.id) if isinstance(
                    node.right, ast.Name
                ) else None
                if (
                    lt and rt and lt != rt
                    and "bool" not in (lt, rt)
                ):
                    ln = node.left.id     # type: ignore[union-attr]
                    rn = node.right.id    # type: ignore[union-attr]
                    findings.append(Finding(
                        path, node.lineno, self.name,
                        f"promotion: `{ln}` ({lt}) and `{rn}` ({rt}) "
                        f"mix dtypes in kernel wrapper `{fn_name}` — "
                        "the promotion table decides silently; widen "
                        "one operand with an explicit .to(dtype)",
                    ))
                    continue
                for side, other_tag in (
                    (node.left, rt), (node.right, lt),
                ):
                    if (
                        isinstance(side, ast.Constant)
                        and isinstance(side.value, float)
                        and other_tag is not None
                        and _family(other_tag) == "int"
                    ):
                        findings.append(Finding(
                            path, node.lineno, self.name,
                            f"promotion: Python float literal "
                            f"{side.value!r} against {other_tag} "
                            f"operand in kernel wrapper `{fn_name}` "
                            "promotes the whole tensor to float silently "
                            "— cast explicitly or keep the arithmetic "
                            "integral",
                        ))
                        break
            targets = _assign_targets(stmt)
            if targets and getattr(stmt, "value", None) is not None:
                t = tag_of_expr(stmt.value)
                for name in targets:
                    if t is not None:
                        tags[name] = t
                    else:
                        tags.pop(name, None)

    def _collect_literal_sites(self, tree, facts) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if not callee or "." in callee:
                continue  # bare-name calls only: function wrappers
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(
                    a.value, float
                ):
                    facts.literal_sites.append(
                        (node.lineno, callee, repr(a.value))
                    )
                    break

    # ------------------------------------------------------------- finalize

    def finalize(self) -> List[Finding]:
        files, self._files = self._files, []
        findings: List[Finding] = []

        # Sentinel-lattice fixpoint: which functions return tainted
        # planes (cross-file by bare name, like the wrapper union).
        producers: Set[str] = set()
        while True:
            nxt: Set[str] = set()
            for f in files:
                for sf in f.sentinel_fns:
                    rt, _hits = self._replay_sentinel(sf, producers)
                    if rt and sf.fn != "<module>":
                        nxt.add(sf.fn)
            if nxt == producers:
                break
            producers = nxt
        for f in files:
            for sf in f.sentinel_fns:
                _rt, hits = self._replay_sentinel(sf, producers)
                for line, msg in hits:
                    if line in f.suppressed:
                        continue
                    findings.append(Finding(f.path, line, self.name, msg))

        # Float literals at the kernel boundary (scan-wide wrapper union).
        wrappers: Set[str] = set()
        for f in files:
            wrappers.update(f.wrappers)
        for f in files:
            for line, callee, lit in f.literal_sites:
                if callee in wrappers and line not in f.suppressed:
                    findings.append(Finding(
                        f.path, line, self.name,
                        f"promotion: Python float literal {lit} passed "
                        f"positionally to kernel wrapper `{callee}` meets "
                        "int32 operands — the arithmetic around it "
                        "promotes by table, not intent; pass an int or "
                        "an int32 tensor",
                    ))

        findings.sort(key=lambda x: (x.path, x.line))
        # De-dup identical (path, line, message) triples: the same
        # arithmetic site can surface through several tainted aliases.
        seen: Set[Tuple[str, int, str]] = set()
        out: List[Finding] = []
        for fd in findings:
            key = (fd.path, fd.line, fd.message)
            if key not in seen:
                seen.add(key)
                out.append(fd)
        return out

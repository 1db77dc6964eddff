"""jit-purity: host reads between a kernel wrapper's launches.

Scope: ``poseidon_tpu_torch/ops/`` and ``poseidon_tpu_torch/solver/`` —
the solver kernels whose latency is the critical path of a scheduling
round.  The port's counterpart of ``poseidon_tpu/check/jit_purity.py``.
torch has no trace to keep pure: the "jit scope" here is a **kernel
wrapper**, a function or method that calls an attribute of
``_kernels.lib()`` (the C entry points of ``ops/csrc/``), and what must
stay free of host reads is the stretch between its first and its last
launch — a ``.item()`` there makes the host wait for the card's queue to
drain before it can issue the next launch, so the launches stop
overlapping the host's work, invisibly in CPU tests.

The stretch is, in source order, everything after the end of the first
launch call and before the start of the last one, plus the whole body
of any loop that holds a launch (iteration i's host work runs between
launch i and launch i + 1).  Module-level functions called in the
stretch join the scope transitively, with their whole bodies.  Flagged
there:

- a host read: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
- ``float()`` / ``int()`` / ``bool()`` or ``np.asarray()`` /
  ``np.array()`` of a tensor (a name bound from a torch call, a tensor
  method, a wrapper's result, or a parameter annotated
  ``torch.Tensor``);
- ``torch.cuda.synchronize()``.

The reference's ``print`` sub-check has no torch meaning (nothing is
traced; a print is a host call like any other) and is left out.  The
rest of a wrapper (operand checks before the first launch, the CPU
branch that runs the plain version) may use numpy and read tensors
freely.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple, Union

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    import_aliases,
)

FnDef = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# torch attributes that return no tensor.
_TORCH_NON_TENSOR = frozenset({
    "device", "Generator", "Size", "dtype", "is_tensor", "numel",
    "get_default_dtype", "manual_seed", "no_grad", "inference_mode",
    "iinfo", "finfo", "set_grad_enabled", "use_deterministic_algorithms",
})
# Tensor methods and attributes that return host values (metadata or a
# host read), not a tensor.
_HOST_VALUED = frozenset({
    "item", "tolist", "numpy", "size", "dim", "numel", "nelement",
    "data_ptr", "stride", "element_size", "is_contiguous", "get_device",
    "storage_offset", "shape", "dtype", "device", "ndim", "is_cuda",
})
_HOST_READ_METHODS = ("item", "tolist", "cpu", "numpy")
_SCALAR_CASTS = ("float", "int", "bool")


# ------------------------------------------------ shared wrapper discovery


def _kernels_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to the ``ops/_kernels`` module."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "_kernels":
                    names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("._kernels") or a.name == "_kernels":
                    names.add(a.asname or a.name)
    return names


def lib_call_names(tree: ast.AST) -> Set[str]:
    """Dotted names that call ``_kernels.lib`` in this module: through the
    module alias, a from-import of ``lib``, or (inside ``_kernels.py``
    itself) the module's own ``def lib``."""
    names = {f"{a}.lib" for a in _kernels_aliases(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module.endswith("_kernels")
        ):
            for a in node.names:
                if a.name == "lib":
                    names.add(a.asname or a.name)
    if isinstance(tree, ast.Module) and any(
        isinstance(n, ast.FunctionDef) and n.name == "lib"
        for n in tree.body
    ):
        names.add("lib")
    return names


def _is_lib_call(node: ast.AST, libs: Set[str]) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func) in libs


def launches(fn: ast.AST, libs: Set[str]) -> List[ast.Call]:
    """The kernel-library calls in ``fn``: ``X.<entry>(...)`` where ``X``
    is ``_kernels.lib()`` or a name bound to it in ``fn``."""
    handles: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_lib_call(node.value, libs):
            handles.update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
    out = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = node.func.value
        if _is_lib_call(recv, libs) or (
            isinstance(recv, ast.Name) and recv.id in handles
        ):
            out.append(node)
    out.sort(key=lambda n: (n.lineno, n.col_offset))
    return out


def function_units(tree: ast.Module) -> List[FnDef]:
    """Module-level functions and class methods."""
    out: List[FnDef] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
        elif isinstance(node, ast.ClassDef):
            out.extend(
                sub for sub in node.body
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
    return out


def kernel_wrappers(tree: ast.Module) -> Dict[str, FnDef]:
    """Functions and methods of this module that launch a kernel, by
    name (``__call__`` of a class is listed under the class's name: the
    wrapper is called through its instances)."""
    libs = lib_call_names(tree)
    if not libs:
        return {}
    out: Dict[str, FnDef] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if launches(node, libs):
                out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and launches(sub, libs):
                    key = node.name if sub.name == "__call__" else sub.name
                    out[key] = sub
    return out


# ------------------------------------------------------- tensor inference


def tensor_names(fn: ast.AST, torch_aliases: Set[str],
                 producers: Set[str] = frozenset()) -> Set[str]:
    """Names in ``fn`` bound to a tensor: parameters annotated
    ``torch.Tensor``, and names assigned (line-insensitively, to a
    fixpoint) from a tensor-valued expression."""
    names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = dotted_name(a.annotation) if a.annotation else None
            if ann and ann.rpartition(".")[2] == "Tensor":
                names.add(a.arg)
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not is_tensor_expr(node.value, names, torch_aliases,
                                  producers):
                continue
            for t in node.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    if isinstance(e, ast.Name) and e.id not in names:
                        names.add(e.id)
                        changed = True
    return names


def is_tensor_expr(v: ast.AST, names: Set[str], torch_aliases: Set[str],
                   producers: Set[str] = frozenset()) -> bool:
    def rec(v: ast.AST) -> bool:
        if isinstance(v, ast.Name):
            return v.id in names
        if isinstance(v, ast.Subscript):
            return rec(v.value)
        if isinstance(v, ast.Attribute):
            return v.attr not in _HOST_VALUED and rec(v.value)
        if isinstance(v, ast.BinOp):
            return rec(v.left) or rec(v.right)
        if isinstance(v, ast.UnaryOp):
            return rec(v.operand)
        if isinstance(v, ast.Compare):
            return rec(v.left) or any(rec(c) for c in v.comparators)
        if isinstance(v, (ast.Tuple, ast.List)):
            return any(rec(e) for e in v.elts)
        if isinstance(v, ast.Call):
            fname = dotted_name(v.func)
            if fname is not None:
                head, _, rest = fname.partition(".")
                if head in torch_aliases and rest:
                    return not rest.startswith("cuda.") and (
                        rest not in _TORCH_NON_TENSOR
                    )
                if fname.rpartition(".")[2] in producers:
                    return True
            if isinstance(v.func, ast.Attribute):
                return v.func.attr not in _HOST_VALUED and rec(
                    v.func.value
                )
        return False

    return rec(v)


# ------------------------------------------------------------------ rule


def _pos(node: ast.AST) -> Tuple[int, int]:
    return node.lineno, node.col_offset


def _end(node: ast.AST) -> Tuple[int, int]:
    return node.end_lineno or node.lineno, node.end_col_offset or 0


def between_launches(fn: ast.AST, libs: Set[str]) -> List[ast.AST]:
    """The nodes of ``fn`` that run between its first and last launch
    (the launch calls' own subtrees excluded)."""
    calls = launches(fn, libs)
    if not calls:
        return []
    inside: Set[int] = set()
    for c in calls:
        inside.update(id(n) for n in ast.walk(c))
    call_ids = {id(c) for c in calls}
    loop_bodies: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)) and any(
            id(n) in call_ids for n in ast.walk(node)
        ):
            loop_bodies.update(id(n) for n in ast.walk(node))
    lo, hi = _end(calls[0]), _pos(calls[-1])
    out = []
    for node in ast.walk(fn):
        if id(node) in inside or not hasattr(node, "lineno"):
            continue
        if id(node) in loop_bodies or (_pos(node) >= lo and _end(node) <= hi):
            out.append(node)
    return out


class JitPurityRule(Rule):
    name = "jit-purity"
    scopes = ("poseidon_tpu_torch/ops/", "poseidon_tpu_torch/solver/")

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        libs = lib_call_names(tree)
        if not libs:
            return []
        np_aliases = import_aliases(tree, "numpy")
        torch_aliases = import_aliases(tree, "torch")
        wrappers = kernel_wrappers(tree)
        producers = set(wrappers)
        table: Dict[str, FnDef] = {
            n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

        findings: List[Finding] = []
        seen: Set[str] = set()
        frontier: List[Tuple[str, str]] = []
        for wname, fn in wrappers.items():
            region = between_launches(fn, libs)
            findings.extend(self._check_nodes(
                region, fn, wname, path, np_aliases, torch_aliases,
                producers,
            ))
            for node in region:
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name
                ) and node.func.id in table:
                    frontier.append((node.func.id, wname))
        # Module-level functions the stretch calls, with their whole
        # bodies, transitively.
        while frontier:
            name, via = frontier.pop()
            if name in seen or name in wrappers:
                continue
            seen.add(name)
            fn = table[name]
            body = [n for n in ast.walk(fn) if n is not fn]
            findings.extend(self._check_nodes(
                body, fn, via, path, np_aliases, torch_aliases, producers,
            ))
            for node in body:
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load
                ) and node.id in table:
                    frontier.append((node.id, via))
        return findings

    def _check_nodes(self, nodes, fn, wrapper: str, path: str,
                     np_aliases, torch_aliases, producers) -> List[Finding]:
        out: List[Finding] = []
        where = f"`{wrapper}`" if fn.name in (wrapper, "__call__") else \
            f"`{wrapper}` (through `{fn.name}`)"
        tensors: Optional[Set[str]] = None

        def is_tensor(v: ast.AST) -> bool:
            nonlocal tensors
            if tensors is None:
                tensors = tensor_names(fn, torch_aliases, producers)
            return is_tensor_expr(v, tensors, torch_aliases, producers)

        def flag(node: ast.AST, message: str) -> None:
            out.append(Finding(
                path, node.lineno, self.name,
                f"{message} [between kernel launches in {where}]",
            ))

        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname:
                head, _, rest = fname.partition(".")
                if head in np_aliases and rest in ("asarray", "array") \
                        and node.args and is_tensor(node.args[0]):
                    flag(node, f"host materialization `{fname}()` of a "
                               "tensor waits for the card; read it after "
                               "the last launch, through _host_read")
                    continue
                if head in torch_aliases and rest == "cuda.synchronize":
                    flag(node, f"`{fname}()` drains the card's queue; "
                               "the launches that follow stop "
                               "overlapping the host")
                    continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_READ_METHODS and not node.args:
                flag(node, f"`.{node.func.attr}()` synchronizes "
                           "device->host; keep the value on the device "
                           "until the last launch")
                continue
            if isinstance(node.func, ast.Name) and \
                    node.func.id in _SCALAR_CASTS and node.args and \
                    is_tensor(node.args[0]):
                flag(node, f"`{node.func.id}()` of a tensor is a host "
                           "read (device sync); keep it a tensor or "
                           "read it after the last launch")
        return out

"""retrace-guard: solve keys and launch shapes minted per call.

Scope: ``poseidon_tpu_torch/ops/`` and ``poseidon_tpu_torch/graph/`` —
the solver's kernel wrappers and the round planner that feeds them.  The
port's counterpart of ``poseidon_tpu/check/retrace_guard.py``.  torch
traces nothing, so a fresh executable per value cannot happen; what can
is the same bug class one level down: a solve key or a launch shape
that varies per call (each a fresh key for the runtime ledger's
budget-0 window, and per-round shape churn the padding buckets exist to
absorb), and a kernel library loaded more than once.  Four hazards:

- **library loaded per call**: ``ctypes.CDLL`` / ``ctypes.cdll
  .LoadLibrary`` / ``build()`` evaluated inside a function, a method or
  a module-level loop reloads (or rebuilds) the kernels every time — the
  counterpart of a ``jax.jit`` constructed per call.  The library is
  built and loaded once, by ``_kernels.lib()`` / ``_kernels.build()``,
  which are the only functions allowed to.
- **instance-varying solve key**: a ``note_solve_key((...))`` tuple
  element that derives from ``len(...)`` or ``.shape`` directly, not
  through a padded bucket (``bucket_size`` / ``padded_shape``): every
  distinct count is a new key.
- **unpadded operand at the boundary**: a tensor or array constructed
  with a raw ``len(...)``/``.shape`` extent passed straight to a kernel
  wrapper: launch shapes are the ledger's keys, and the padding helpers
  land per-round count churn on a few fixed sizes.
- **float at the boundary**: a Python float literal (or a ``float(...)``
  cast) passed to a kernel wrapper or a launch.  The kernels take int32
  operands only (``_kernels.check`` raises at run time; ctypes refuses a
  float for an ``int``); this catches it at lint time.

The reference's str/bool-at-a-traced-position sub-checks have no torch
meaning: a wrapper's Python arguments are never a compile key.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from poseidon_tpu_torch.check.core import Finding, Rule, dotted_name
from poseidon_tpu_torch.check.jit_purity import (
    function_units,
    kernel_wrappers,
    launches,
    lib_call_names,
)

# Call names that normalize a varying count onto a fixed bucket; a
# len()/.shape occurrence under one of these is the sanctioned pattern,
# not a hazard.  Matched on the trailing identifier so both
# ``bucket_size`` and ``transport.bucket_size`` qualify.
_PADDING_HELPERS = ("bucket_size", "padded_shape")

# The only functions allowed to build or load the kernel library.
_LOADERS = ("lib", "build")


def _is_padding_call(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    if not name:
        return False
    tail = name.split(".")[-1]
    return tail in _PADDING_HELPERS or "pad" in tail


def _contains_varying(node: ast.AST) -> bool:
    """Does this expression derive from len(...) or .shape, outside any
    padding-helper call?"""
    if isinstance(node, ast.Call):
        if _is_padding_call(node):
            return False
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
    if isinstance(node, ast.Attribute) and node.attr == "shape":
        return True
    return any(_contains_varying(c) for c in ast.iter_child_nodes(node))


# Constructors whose first argument is a shape: a raw varying extent here
# puts a per-round shape on the launch.
_SHAPE_CTORS = ("zeros", "ones", "full", "empty", "arange")


def _unpadded_shape_ctor(node: ast.AST) -> Optional[ast.Call]:
    """First constructor call in the expression whose shape argument
    varies unpadded, else None."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = dotted_name(sub.func)
        if not name or name.split(".")[-1] not in _SHAPE_CTORS:
            continue
        if sub.args and _contains_varying(sub.args[0]):
            return sub
    return None


def _float_expr(node: ast.AST) -> bool:
    """Is this expression a Python-float-valued literal or cast?"""
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return True
    if isinstance(node, ast.UnaryOp):
        return _float_expr(node.operand)
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name and name.split(".")[-1] in ("float", "float64", "float32"):
            return True
    return False


def _is_library_load(node: ast.Call, build_names) -> bool:
    name = dotted_name(node.func)
    if name is None:
        return False
    return (
        name.rpartition(".")[2] in ("CDLL", "LoadLibrary")
        or name in build_names
    )


class RetraceGuardRule(Rule):
    name = "retrace-guard"
    scopes = ("poseidon_tpu_torch/ops/", "poseidon_tpu_torch/graph/")

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        assert isinstance(tree, ast.Module)
        libs = lib_call_names(tree)
        build_names = {n[: -len("lib")] + "build" for n in libs}
        findings: List[Finding] = []

        def flag(node: ast.AST, message: str) -> None:
            findings.append(Finding(path, node.lineno, self.name, message))

        # ---- hazard 1: the library loaded per call / per iteration -----
        def scan_module_loops(node: ast.AST, in_loop: bool) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                 ast.Lambda),
            ):
                return
            if in_loop and isinstance(node, ast.Call) and \
                    _is_library_load(node, build_names):
                flag(node, "kernel library loaded inside a module-level "
                           "loop: a fresh library load per iteration; "
                           "load it once through _kernels.lib()")
                return
            child_in_loop = in_loop or isinstance(node, (ast.For, ast.While))
            for child in ast.iter_child_nodes(node):
                scan_module_loops(child, child_in_loop)

        for stmt in tree.body:
            scan_module_loops(stmt, False)
        units = function_units(tree)
        for fn in units:
            if fn.name in _LOADERS:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        _is_library_load(node, build_names):
                    flag(node, f"kernel library loaded inside `{fn.name}()`"
                               ": a fresh library load (or build check) "
                               "per call; go through the cached "
                               "_kernels.lib()")

        # ---- hazard 2: solve keys from raw counts ----------------------
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if (dotted_name(node.func) or "").rpartition(".")[2] != \
                    "note_solve_key" or not node.args:
                continue
            key = node.args[0]
            elts = key.elts if isinstance(key, (ast.Tuple, ast.List)) \
                else [key]
            for e in elts:
                if _contains_varying(e):
                    flag(e, "solve key element derives from len()/.shape:"
                            " a per-instance count mints a fresh key per "
                            "value; key the padded bucket (bucket_size/"
                            "padded_shape) instead")

        # ---- hazards 3-4: the wrapper and launch boundary --------------
        wrappers = set(kernel_wrappers(tree))
        launch_ids = set()
        if libs:
            for fn in units:
                launch_ids.update(id(c) for c in launches(fn, libs))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            is_wrapper = callee is not None and \
                callee.rpartition(".")[2] in wrappers
            if not (is_wrapper or id(node) in launch_ids):
                continue
            where = f"`{callee or node.func.attr}(...)`"
            for value in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(value, ast.Starred):
                    continue
                if _float_expr(value):
                    flag(value, f"Python float passed to {where}: the "
                                "kernels take int32 operands only "
                                "(_kernels.check raises at run time); "
                                "pass an int or an int32 tensor")
                    continue
                if not is_wrapper:
                    continue
                ctor = _unpadded_shape_ctor(value)
                if ctor is not None:
                    flag(ctor, "operand with raw len()/.shape-derived "
                               f"extent reaches kernel wrapper {where}: "
                               "per-round counts become launch shapes; "
                               "pad through bucket_size/padded_shape "
                               "first")
        return findings

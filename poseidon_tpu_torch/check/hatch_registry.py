"""hatch-registry: every POSEIDON_* env hatch reads through the registry.

``poseidon_tpu_torch/utils/hatches.py`` is the port's single source of
truth for its ``POSEIDON_*`` escape hatches (name, kind, default,
one-line effect; ``markdown_table()`` renders them).  Without it a
typo'd name reads its default forever, a renamed hatch leaves dead
readers behind, and docs drift from code.  This rule (the port's copy of
``poseidon_tpu/check/hatch_registry.py``, pointed at the port's
registry and liveness roots) keeps the registry load-bearing:

- **bypass**: a direct ``os.environ`` / ``os.getenv`` READ of a
  ``POSEIDON_*`` string literal anywhere outside the registry module —
  registered or not — must go through the typed call-time accessors
  (``hatch_bool`` / ``hatch_int`` / ...), which also centralize the
  default and the parse-failure fallback.  Writes
  (``os.environ[...] = ...``, ``setdefault``) are fine: harnesses and
  probe latches legitimately *set* hatches for children.
- **undeclared**: an accessor call (or a bypassing read) naming a
  ``POSEIDON_*`` literal that the registry does not declare.  The
  accessors raise ``KeyError`` at runtime; this catches it at lint
  time, including in code paths no test executes.
- **dead flag** (project-scoped, judged in ``finalize``): a declared
  non-``external`` hatch whose name appears as a string literal in NO
  scanned file outside the registry.  Liveness is a whole-project
  property, so this sub-check stays silent unless the scan covered
  every liveness root (``poseidon_tpu_torch/``, ``chip_smoke.py``,
  ``compare_trees.py`` — the CLI's default scan set); a partial scan
  must not flag a hatch whose one reader it simply didn't see.

Detection of "uses" for the dead-flag check is deliberately generous —
ANY string constant equal to the hatch name counts (accessor args,
``ENV_GATE``-style module constants later passed to an accessor,
``accel_policy("POSEIDON_FUSED")`` forwarding, environment writes in
tools) — so a false "dead" verdict requires the name to be truly
absent, while a false "live" verdict is possible and accepted (the
usual over-approximation posture of this suite: quiet on live code).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from poseidon_tpu_torch.check.core import (
    Finding,
    Rule,
    dotted_name,
    from_imports,
    import_aliases,
    suppressions,
)

_PREFIX = "POSEIDON_"

# The typed accessors exported by the registry module; a str-literal
# first argument is statically checkable against the declarations.
_ACCESSORS = frozenset({
    "hatch", "hatch_raw", "hatch_set", "hatch_bool", "hatch_flag",
    "hatch_int", "hatch_float", "hatch_str",
})


def _parse_registry(path: Path) -> Tuple[Dict[str, int], Set[str], Set[int]]:
    """(name -> decl lineno, external-kind names, suppressed linenos)
    from the registry module source — parsed, never imported (the check
    CLI stays dependency-free)."""
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    decls: Dict[str, int] = {}
    external: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and dotted_name(node.func) in ("Hatch", "hatches.Hatch")):
            continue
        name = kind = None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            name = node.args[0].value
        if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
            kind = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = kw.value.value
            if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                kind = kw.value.value
        if name:
            decls[name] = node.lineno
            if kind == "external":
                external.add(name)
    suppressed = {
        lineno
        for lineno, rules in suppressions(source).items()
        if rules is None or HatchRegistryRule.name in rules
    }
    return decls, external, suppressed


class HatchRegistryRule(Rule):
    name = "hatch-registry"
    # Empty scopes: hatch reads live in poseidon_tpu_torch/ and the root
    # scripts alike — every scanned file participates.
    scopes: tuple = ()

    _REGISTRY_FRAGMENT = "poseidon_tpu_torch/utils/hatches.py"
    # Dead-flag liveness roots: the sub-check judges only when the scan
    # saw files under EVERY one of these (the CLI's default scan set).
    _LIVENESS_ROOTS = (
        "poseidon_tpu_torch/", "chip_smoke.py", "compare_trees.py",
    )

    def __init__(
        self,
        registry_path: Optional[Path] = None,
        liveness_roots: Optional[Sequence[str]] = None,
    ) -> None:
        # Default registry: resolved relative to this package so the
        # rule works from any cwd; fixtures inject their own.
        self._registry_path = registry_path or (
            Path(__file__).resolve().parent.parent / "utils" / "hatches.py"
        )
        if liveness_roots is not None:
            self._liveness_roots = tuple(liveness_roots)
        else:
            self._liveness_roots = self._LIVENESS_ROOTS
        self._decls: Optional[Dict[str, int]] = None
        self._external: Set[str] = set()
        self._reg_suppressed: Set[int] = set()
        self._seen_constants: Set[str] = set()
        self._scanned_paths: List[str] = []

    # ------------------------------------------------------------- registry

    def _registry(self) -> Dict[str, int]:
        if self._decls is None:
            try:
                self._decls, self._external, self._reg_suppressed = (
                    _parse_registry(self._registry_path)
                )
            except (OSError, SyntaxError):
                # No registry to check against (the checker vendored
                # without the registry): the rule stays silent
                # rather than flagging every hatch as undeclared.
                self._decls = {}
        return self._decls

    def _is_registry_module(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("utils/hatches.py")

    # ---------------------------------------------------------------- check

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        self._scanned_paths.append(path)
        decls = self._registry()
        findings: List[Finding] = []

        # Liveness facts first: every POSEIDON_* string constant in a
        # non-registry file marks its hatch as referenced.
        in_registry = self._is_registry_module(path)
        if not in_registry:
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ) and node.value.startswith(_PREFIX):
                    self._seen_constants.add(node.value)
        if in_registry:
            return []

        os_aliases = import_aliases(tree, "os")
        env_fns = {
            local
            for local, orig in from_imports(tree, "os").items()
            if orig in ("getenv", "environ")
        }
        accessor_locals = {
            local: orig
            for local, orig in from_imports(
                tree, "poseidon_tpu_torch.utils.hatches"
            ).items()
            if orig in _ACCESSORS
        }

        def literal_hatch(node: ast.AST) -> Optional[str]:
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ) and node.value.startswith(_PREFIX):
                return node.value
            return None

        def flag_read(node: ast.AST, name: str) -> None:
            if name in decls:
                findings.append(Finding(
                    path, node.lineno, self.name,
                    f"direct environment read of `{name}` bypasses the "
                    "hatch registry; use the typed accessor "
                    "(poseidon_tpu_torch.utils.hatches) so default and parse "
                    "semantics stay centralized",
                ))
            else:
                findings.append(Finding(
                    path, node.lineno, self.name,
                    f"undeclared hatch `{name}`: declare it in "
                    "poseidon_tpu_torch/utils/hatches.py (name, kind, "
                    "default, one-line effect) before reading it",
                ))

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname is None:
                    continue
                head, _, rest = fname.partition(".")
                # os.environ.get("POSEIDON_X") / os.getenv("POSEIDON_X")
                if (head in os_aliases and rest in (
                        "getenv", "environ.get")) or (
                        head in env_fns and rest in ("", "get")):
                    if node.args:
                        name = literal_hatch(node.args[0])
                        if name:
                            flag_read(node, name)
                    continue
                # accessor("POSEIDON_X"): undeclared names flag; the
                # registry module's own helpers are exempt above.
                orig = accessor_locals.get(fname) or (
                    rest if head == "hatches" and rest in _ACCESSORS
                    else None
                )
                if orig and node.args:
                    name = literal_hatch(node.args[0])
                    if name and name not in decls and decls:
                        findings.append(Finding(
                            path, node.lineno, self.name,
                            f"accessor read of undeclared hatch `{name}`"
                            ": the registry accessor will raise KeyError"
                            " at call time — declare it in "
                            "poseidon_tpu_torch/utils/hatches.py",
                        ))
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ):
                # os.environ["POSEIDON_X"] reads (stores/dels are
                # legitimate harness latches).
                vname = dotted_name(node.value)
                if vname is None:
                    continue
                head, _, rest = vname.partition(".")
                is_environ = (head in os_aliases and rest == "environ") \
                    or (head in env_fns and not rest)
                if is_environ:
                    name = literal_hatch(node.slice)
                    if name:
                        flag_read(node, name)
        return findings

    # ------------------------------------------------------------- finalize

    def finalize(self) -> List[Finding]:
        scanned, self._scanned_paths = self._scanned_paths, []
        seen, self._seen_constants = self._seen_constants, set()
        decls = self._registry()
        if not decls:
            return []
        registry_scanned = any(
            self._is_registry_module(p) for p in scanned
        )
        covered = all(
            any(root in p for p in scanned)
            for root in self._liveness_roots
        )
        if not (registry_scanned and covered):
            # Partial scan: a hatch's one reader may simply not have
            # been walked — liveness is not judgeable.
            return []
        reg_rel = self._registry_rel(scanned)
        findings: List[Finding] = []
        for name, lineno in sorted(decls.items()):
            if name in self._external or name in seen:
                continue
            if lineno in self._reg_suppressed:
                continue
            findings.append(Finding(
                reg_rel, lineno, self.name,
                f"declared hatch `{name}` is never read anywhere in the "
                "scanned tree (dead flag): delete the declaration or "
                "wire the reader through an accessor",
            ))
        return findings

    def _registry_rel(self, scanned: Sequence[str]) -> str:
        for p in scanned:
            if self._is_registry_module(p):
                return p
        return self._REGISTRY_FRAGMENT

"""posecheck core: finding model, suppressions, baseline, file walking.

The port's copy of ``poseidon_tpu/check/core.py``, changed only in the
package name: the static suite imports neither the JAX package nor
torch (it is pure ``ast``), so ``python -m poseidon_tpu_torch.check``
runs on a machine with neither installed.

Rules are plain objects with a ``name``, a ``scopes`` tuple of
package-relative directory fragments they apply to by default, and a
``check(tree, source, path)`` returning findings.  Suppression is
line-scoped: a trailing ``# posecheck: ignore[rule-id]`` (or a bare
``# posecheck: ignore`` for every rule) on the flagged line silences it.
A committed baseline file can grandfather known findings so the gate
starts clean; the repo's own baseline is kept empty by fixing findings
instead.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

# ----------------------------------------------------------------- findings


@dataclass(frozen=True)
class Finding:
    path: str       # repo-relative posix path
    line: int       # 1-based line of the offending node
    rule: str       # rule id, e.g. "jit-purity"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def baseline_key(self) -> str:
        # Line numbers rot under unrelated edits; the baseline matches on
        # (path, rule, message) instead.
        return f"{self.path}\t{self.rule}\t{self.message}"


# -------------------------------------------------------------- suppressions

_SUPPRESS_RE = re.compile(
    r"#\s*posecheck:\s*ignore(?:\[(?P<ids>[a-z0-9_,\- ]+)\])?"
)


def suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """Line -> suppressed rule ids (None = all rules) from inline comments."""
    out: Dict[int, Optional[Set[str]]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = m.group("ids")
        if ids is None:
            out[lineno] = None
        else:
            out[lineno] = {s.strip() for s in ids.split(",") if s.strip()}
    return out


def apply_suppressions(
    findings: Iterable[Finding], source: str
) -> List[Finding]:
    supp = suppressions(source)
    kept = []
    for f in findings:
        rules = supp.get(f.line, ())
        if rules is None or (rules and f.rule in rules):
            continue
        kept.append(f)
    return kept


# -------------------------------------------------------------------- rules


class Rule:
    """Base rule: subclasses set ``name``/``scopes`` and implement check."""

    name: str = ""
    # Default path scopes (posix fragments); a file is in scope when any
    # fragment occurs in its repo-relative path.  Empty = everywhere.
    scopes: Sequence[str] = ()

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        raise NotImplementedError

    def begin(self, paths: Sequence[str]) -> None:
        """Called by ``run()`` with the raw scan paths before any file's
        ``check()``.  Per-file rules ignore it; cross-file rules use it
        to judge scan completeness (dispatch-budget only trusts its
        reachability graph when whole directories were walked — a
        file-list scan like ``--changed`` sees a partial graph)."""

    def finalize(self) -> List[Finding]:
        """Project-scoped findings, emitted once after every file's
        ``check()`` ran.  Per-file rules return nothing; cross-file rules
        (dispatch-budget's precompile-reachability closure) accumulate
        facts in ``check()`` and judge here.  Implementations handle
        their own suppressions (``check_file``'s line-scoped filter only
        sees per-file findings) and must reset their accumulated state."""
        return []

    def applies_to(self, path: str) -> bool:
        if not self.scopes:
            return True
        return any(frag in path for frag in self.scopes)


def all_rules() -> List[Rule]:
    # Local imports: the rule modules import this one for Rule/Finding.
    from poseidon_tpu_torch.check.concurrency import (
        BlockingUnderLockRule,
        LockOrderRule,
        UnsafePublicationRule,
    )
    from poseidon_tpu_torch.check.determinism import DeterminismRule
    from poseidon_tpu_torch.check.dispatch_budget import DispatchBudgetRule
    from poseidon_tpu_torch.check.hatch_registry import HatchRegistryRule
    from poseidon_tpu_torch.check.jit_purity import JitPurityRule
    from poseidon_tpu_torch.check.lock_discipline import LockDisciplineRule
    from poseidon_tpu_torch.check.numerics_discipline import (
        NumericsDisciplineRule,
    )
    from poseidon_tpu_torch.check.retrace_guard import RetraceGuardRule
    from poseidon_tpu_torch.check.shard_discipline import ShardDisciplineRule
    from poseidon_tpu_torch.check.transfer_discipline import (
        TransferDisciplineRule,
    )

    return [
        JitPurityRule(),
        LockDisciplineRule(),
        DeterminismRule(),
        RetraceGuardRule(),
        DispatchBudgetRule(),
        TransferDisciplineRule(),
        ShardDisciplineRule(),
        HatchRegistryRule(),
        LockOrderRule(),
        BlockingUnderLockRule(),
        UnsafePublicationRule(),
        NumericsDisciplineRule(),
    ]


def rules_by_name(names: Iterable[str]) -> List[Rule]:
    registry = {r.name: r for r in all_rules()}
    out = []
    for n in names:
        if n not in registry:
            raise KeyError(
                f"unknown rule {n!r}; known: {sorted(registry)}"
            )
        out.append(registry[n])
    return out


# -------------------------------------------------------------- AST helpers


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST, module: str) -> Set[str]:
    """Local names bound to ``module`` by import statements.

    ``import numpy as np`` -> {"np"}; ``import numpy`` -> {"numpy"}.
    """
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    names.add(a.asname or a.name.split(".")[0])
    return names


def from_imports(tree: ast.AST, module: str) -> Dict[str, str]:
    """Local name -> original name for ``from module import ...``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


# ------------------------------------------------------------------ running

# Directories never scanned by the default walk: fixtures hold seeded
# violations on purpose; generated protos are gated by the drift check.
_SKIP_FRAGMENTS = ("check/fixtures", "__pycache__", "protos/")


def iter_py_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in sorted(path.rglob("*.py")):
                rel = f.as_posix()
                if any(frag in rel for frag in _SKIP_FRAGMENTS):
                    continue
                files.append(f)
        elif path.suffix == ".py":
            files.append(path)
    return files


def check_file(
    path: Path,
    rules: Sequence[Rule],
    *,
    forced: bool = False,
    root: Optional[Path] = None,
) -> List[Finding]:
    """All findings for one file (suppressions applied, baseline not).

    ``forced`` bypasses per-rule scope filters (the CLI's --rule mode and
    the fixture self-tests).
    """
    rel = path.as_posix()
    if root is not None:
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            pass
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [
            Finding(rel, e.lineno or 1, "parse-error", str(e.msg))
        ]
    findings: List[Finding] = []
    for rule in rules:
        if not forced and not rule.applies_to(rel):
            continue
        findings.extend(rule.check(tree, source, rel))
    findings = apply_suppressions(findings, source)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def load_baseline(path: Path) -> Set[str]:
    if not path.exists():
        return set()
    keys: Set[str] = set()
    for line in path.read_text().splitlines():
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        keys.add(line)
    return keys


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    lines = [
        "# posecheck baseline: grandfathered findings (path<TAB>rule<TAB>"
        "message).",
        "# Regenerate with: python -m poseidon_tpu_torch.check "
        "--write-baseline poseidon_tpu_torch/ chip_smoke.py "
        "compare_trees.py",
    ]
    lines.extend(sorted({f.baseline_key() for f in findings}))
    path.write_text("\n".join(lines) + "\n")


def run(
    paths: Sequence[str],
    *,
    rules: Optional[Sequence[Rule]] = None,
    baseline: Optional[Path] = None,
    root: Optional[Path] = None,
) -> List[Finding]:
    forced = rules is not None
    active = list(rules) if rules is not None else all_rules()
    baseline_keys = load_baseline(baseline) if baseline else set()
    findings: List[Finding] = []
    for rule in active:
        rule.begin(paths)
    for f in iter_py_files(paths):
        findings.extend(check_file(f, active, forced=forced, root=root))
    for rule in active:
        findings.extend(rule.finalize())
    if baseline_keys:
        findings = [
            f for f in findings if f.baseline_key() not in baseline_keys
        ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings

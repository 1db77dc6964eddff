"""CLI: ``python -m poseidon_tpu_torch.check [paths...]``.

Run from the repository root.  With no paths it scans the port's
liveness roots, ``poseidon_tpu_torch/ chip_smoke.py compare_trees.py``
(the hatch registry's dead-flag check judges only a scan that covers
all three).  Exit codes: 0 clean, 1 findings, 2 bad invocation or a git
error.  Findings print as ``file:line rule-id message`` (editors parse
that shape) or, under ``--format=json``, as one JSON object per line
(``{"path", "line", "rule", "message"}``) for machine consumers
(pre-commit hooks, CI annotators).

``--changed`` scans only files touched relative to git HEAD (staged,
unstaged, and untracked), intersected with the given paths — the fast
pre-commit mode.  Scope filters still apply, so a touched glue file
gets the glue rules, not everything.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from poseidon_tpu_torch.check.core import (
    all_rules,
    iter_py_files,
    load_baseline,
    run,
    rules_by_name,
    write_baseline,
)

_DEFAULT_BASELINE = Path(__file__).parent / "baseline.txt"
# The port's liveness roots, relative to the repository root.
DEFAULT_PATHS = ("poseidon_tpu_torch/", "chip_smoke.py", "compare_trees.py")


def changed_files(paths: List[str]) -> Optional[List[str]]:
    """Python files changed vs HEAD (staged + unstaged + untracked),
    restricted to ``paths``.  None when git itself fails (not a repo,
    no git) — the caller reports a usage error rather than silently
    scanning nothing.

    git prints toplevel-relative names (and ``ls-files --others`` would
    be cwd-scoped), so both commands run from the toplevel and the
    comparison happens on RESOLVED absolute paths — a run from a
    subdirectory must not silently drop tracked changes elsewhere in
    the checkout.
    """
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            capture_output=True, text=True, check=True, cwd=top,
        ).stdout.splitlines()
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, check=True, cwd=top,
        ).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return None
    scoped = {f.resolve(): f.as_posix() for f in iter_py_files(paths)}
    out = []
    for name in dict.fromkeys([*diff, *untracked]):  # ordered de-dup
        resolved = Path(top, name).resolve()
        if name.endswith(".py") and resolved in scoped \
                and resolved.exists():
            out.append(scoped[resolved])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m poseidon_tpu_torch.check",
        description="posecheck over the PyTorch/CUDA port: "
                    + " / ".join(r.name for r in all_rules()),
    )
    parser.add_argument(
        "paths", nargs="*", default=list(DEFAULT_PATHS),
        help="files or directories to scan (default: "
             + " ".join(DEFAULT_PATHS) + ")",
    )
    parser.add_argument(
        "--rule", action="append", dest="rules", metavar="RULE-ID",
        help="run only this rule, on every given path regardless of its "
             "default scope (repeatable); known: "
             + ", ".join(r.name for r in all_rules()),
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="finding output shape: `file:line rule message` lines "
             "(text, default) or one JSON object per line (json)",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="scan only files changed vs git HEAD (staged, unstaged, "
             "untracked) within the given paths — fast pre-commit mode",
    )
    parser.add_argument(
        "--baseline", type=Path, default=_DEFAULT_BASELINE,
        help="baseline file of grandfathered findings "
             "(default: the committed package baseline)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report baselined findings too",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from the current findings and exit 0",
    )
    args = parser.parse_args(argv)

    try:
        rules = rules_by_name(args.rules) if args.rules else None
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    paths = args.paths
    if args.changed:
        paths = changed_files(args.paths)
        if paths is None:
            print("--changed requires a git checkout", file=sys.stderr)
            return 2
        if not paths:
            print("posecheck: no changed files in scope", file=sys.stderr)
            return 0

    baseline = None if (args.no_baseline or args.write_baseline) \
        else args.baseline
    findings = run(paths, rules=rules, baseline=baseline, root=Path.cwd())

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(
            f"wrote {len(findings)} finding(s) to {args.baseline}",
            file=sys.stderr,
        )
        return 0

    for f in findings:
        if args.format == "json":
            print(json.dumps(
                {"path": f.path, "line": f.line, "rule": f.rule,
                 "message": f.message},
                sort_keys=True,
            ))
        else:
            print(f.render())
    if findings:
        n_base = len(load_baseline(args.baseline)) if baseline else 0
        suffix = f" ({n_base} baselined)" if n_base else ""
        print(
            f"posecheck: {len(findings)} finding(s){suffix}",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

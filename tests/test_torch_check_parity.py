"""The port's posecheck against the reference's (``poseidon_tpu.check``).

Three layers of parity:

- the mechanics (suppression syntax, baseline keys, the file walk) give
  the reference's results on the same inputs;
- the framework-neutral rules (lock-discipline, lock-order,
  blocking-under-lock, unsafe-publication, determinism, hatch-registry,
  and numerics' numpy sub-checks) give the reference's
  ``(line, rule, message)`` on every fixture of the reference, run
  forced, with the package name normalised;
- each rule given a torch meaning keeps a table of reference sub-check
  -> port sub-check: the reference's count on its fixture equals the
  port's count on its torch fixture, and the sub-checks with no torch
  meaning are listed by name.

Both suites are pure ``ast`` and import neither jax nor torch.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from poseidon_tpu.check import core as j_core
from poseidon_tpu.check.core import rules_by_name as j_rules_by_name
from poseidon_tpu_torch.check import core as t_core
from poseidon_tpu_torch.check.core import rules_by_name as t_rules_by_name

REPO = Path(__file__).resolve().parent.parent
J_FIX = REPO / "poseidon_tpu" / "check" / "fixtures"
T_FIX = REPO / "poseidon_tpu_torch" / "check" / "fixtures"
J_FIXTURES = sorted(
    p.name for p in J_FIX.glob("*.py") if p.name != "__init__.py"
)


def _norm(msg: str) -> str:
    """A message with the package name normalised (and the reference's
    citations of its own history dropped)."""
    msg = re.sub(r"\bposeidon_tpu_torch\b", "poseidon_tpu", msg)
    return re.sub(r"\bPR \d+ ", "", msg)


def _pair(name: str):
    (j,) = j_rules_by_name([name])
    (t,) = t_rules_by_name([name])
    return j, t


# ----------------------------------------------------------------- mechanics


SOURCES = [
    "x = 1  # posecheck: ignore[jit-purity]\n",
    "y = 2  # posecheck: ignore[jit-purity, determinism]\nw = 4\n",
    "z = 3  # posecheck: ignore\n",
    "a = 1  #posecheck:ignore[numerics]\nb = 2  # posecheck: ignore[]\n",
    "c = 1  # posecheck: ignore[Bad Case]\n",
]


@pytest.mark.parametrize("src", SOURCES)
def test_suppressions_match_reference(src):
    assert t_core.suppressions(src) == j_core.suppressions(src)
    lines = src.count("\n") + 1
    rules = ("jit-purity", "determinism", "numerics", "lock-order")
    jf = [j_core.Finding("f.py", ln, r, "m")
          for ln in range(1, lines + 1) for r in rules]
    tf = [t_core.Finding("f.py", ln, r, "m")
          for ln in range(1, lines + 1) for r in rules]
    kept_j = [(f.line, f.rule) for f in j_core.apply_suppressions(jf, src)]
    kept_t = [(f.line, f.rule) for f in t_core.apply_suppressions(tf, src)]
    assert kept_t == kept_j


def test_finding_render_and_key_match_reference():
    j = j_core.Finding("a.py", 3, "numerics", "msg")
    t = t_core.Finding("a.py", 3, "numerics", "msg")
    assert t.render() == j.render()
    assert t.baseline_key() == j.baseline_key()


def test_baseline_round_trip_matches_reference(tmp_path):
    findings = [("a.py", 3, "determinism", "msg one"),
                ("b.py", 9, "jit-purity", "msg two"),
                ("b.py", 12, "jit-purity", "msg two")]
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    j_core.write_baseline(jp, [j_core.Finding(*f) for f in findings])
    t_core.write_baseline(tp, [t_core.Finding(*f) for f in findings])
    keys = j_core.load_baseline(jp)
    assert t_core.load_baseline(tp) == keys == t_core.load_baseline(jp)
    assert j_core.load_baseline(tp) == keys
    # The bodies agree; the headers name their own package.
    assert jp.read_text().splitlines()[2:] == tp.read_text().splitlines()[2:]


def test_iter_py_files_matches_reference(tmp_path):
    for rel in ("a.py", "pkg/b.py", "pkg/check/fixtures/seeded.py",
                "pkg/protos/x_pb2.py", "pkg/__pycache__/c.py",
                "pkg/notes.txt", "pkg/sub/d.py"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x = 1\n")
    paths = [str(tmp_path), str(tmp_path / "a.py"),
             str(tmp_path / "pkg" / "notes.txt")]
    assert t_core.iter_py_files(paths) == j_core.iter_py_files(paths)
    got = [p.relative_to(tmp_path).as_posix()
           for p in t_core.iter_py_files([str(tmp_path)])]
    assert got == ["a.py", "pkg/b.py", "pkg/sub/d.py"]


def test_iter_py_files_on_the_port_tree():
    port = [str(REPO / "poseidon_tpu_torch")]
    assert t_core.iter_py_files(port) == j_core.iter_py_files(port)


# ----------------------------------------------------- neutral rules parity


NEUTRAL = ("lock-discipline", "lock-order", "blocking-under-lock",
           "unsafe-publication", "determinism", "hatch-registry",
           "numerics")


def _keyed(findings, rule):
    out = []
    for f in findings:
        if rule == "numerics" and not f.message.startswith(
            ("i32-overflow:", "inf-sentinel:")
        ):
            continue  # promotion is the torch-meaning part (table below)
        # lock-order cites its sites by path: keep the file's name only.
        msg = f.message.replace(f.path, Path(f.path).name)
        out.append((f.line, f.rule, _norm(msg)))
    return out


@pytest.mark.parametrize("fixture", J_FIXTURES)
@pytest.mark.parametrize("rule", NEUTRAL)
def test_neutral_rule_matches_reference_on_its_fixtures(rule, fixture,
                                                        tmp_path):
    """The reference's fixture, package-renamed for the port, gives the
    same findings line for line."""
    src = (J_FIX / fixture).read_text()
    renamed = tmp_path / fixture
    renamed.write_text(re.sub(r"\bposeidon_tpu\b", "poseidon_tpu_torch",
                              src))
    j_rule, t_rule = _pair(rule)
    j = j_core.check_file(J_FIX / fixture, [j_rule], forced=True,
                          root=REPO) + j_rule.finalize()
    t = t_core.check_file(renamed, [t_rule], forced=True,
                          root=REPO) + t_rule.finalize()
    assert _keyed(t, rule) == _keyed(j, rule)


def test_neutral_parity_is_not_vacuous():
    """The reference's fixtures do exercise every neutral rule."""
    hits = {}
    for rule in NEUTRAL:
        (j_rule,) = j_rules_by_name([rule])
        n = 0
        for fixture in J_FIXTURES:
            n += len(_keyed(
                j_core.check_file(J_FIX / fixture, [j_rule], forced=True,
                                  root=REPO) + j_rule.finalize(), rule))
        hits[rule] = n
    assert all(n > 0 for n in hits.values()), hits


# ------------------------------------------------ torch-meaning sub-checks


def _count(findings, pattern: str) -> int:
    return sum(bool(re.search(pattern, f.message)) for f in findings)


def _j_findings(rule: str, fixture: str):
    if rule == "dispatch-budget":
        from poseidon_tpu.check.dispatch_budget import DispatchBudgetRule

        r = DispatchBudgetRule(flag_fragments=("check/fixtures",))
    else:
        (r,) = j_rules_by_name([rule])
    return j_core.check_file(J_FIX / fixture, [r], forced=True,
                             root=REPO) + r.finalize()


def _t_findings(rule: str, fixture: str):
    if rule == "dispatch-budget":
        from poseidon_tpu_torch.check.dispatch_budget import (
            DispatchBudgetRule,
        )

        r = DispatchBudgetRule(flag_fragments=("check/fixtures",))
    else:
        (r,) = t_rules_by_name([rule])
    return t_core.check_file(T_FIX / fixture, [r], forced=True,
                             root=REPO) + r.finalize()


# (rule, fixture, reference sub-check, its message pattern, port
#  sub-check, its message pattern, count on each side)
SUBCHECKS = [
    ("jit-purity", "jit_purity_violations.py",
     "np.asarray/np.array in jit scope", r"host materialization",
     "np.asarray/np.array of a tensor between launches",
     r"host materialization `np\.", 2),
    ("jit-purity", "jit_purity_violations.py",
     ".item() in jit scope", r"`\.item\(\)`",
     ".item() between launches", r"`\.item\(\)`", 1),
    ("jit-purity", "jit_purity_violations.py",
     "float()/int() tracer casts", r"cast concretizes",
     "float()/int() of a tensor between launches",
     r"of a tensor is a host read", 2),
    ("jit-purity", "jit_purity_violations.py",
     "jax.device_get in jit scope", r"device_get",
     ".cpu() between launches", r"`\.cpu\(\)`", 1),
    ("retrace-guard", "retrace_guard_violations.py",
     "jit constructed per call/loop", r"fresh compile cache",
     "kernel library loaded per call/loop", r"fresh library load", 6),
    ("retrace-guard", "retrace_guard_violations.py",
     "jit constructed in a module-level loop", r"module-level loop",
     "library loaded in a module-level loop", r"module-level loop", 2),
    ("retrace-guard", "retrace_guard_violations.py",
     "static argument from len()/.shape", r"retraces per value",
     "solve key element from len()/.shape", r"solve key element", 1),
    ("retrace-guard", "retrace_guard_violations.py",
     "unpadded shape at the jit boundary", r"pad through bucket_size",
     "unpadded operand at a kernel wrapper", r"pad through bucket_size",
     1),
    ("retrace-guard", "retrace_guard_violations.py",
     "weak float at the jit boundary", r"weak f32/f64",
     "float at a kernel wrapper", r"Python float passed", 1),
    ("dispatch-budget", "dispatch_budget_violations.py",
     "decorated jitted def unreachable", r"`uncovered_kernel`",
     "kernel wrapper unreachable", r"\(kernel launch\)", 1),
    ("dispatch-budget", "dispatch_budget_violations.py",
     "module-level jit wrapper unreachable", r"`wrapper_orphan`",
     "solve key unreachable", r"\(solve key\)", 1),
    ("transfer-discipline", "transfer_discipline_violations.py",
     "scalar sync on a jitted result", r"jitted-call result\) is an "
     r"implicit", "scalar sync on a wrapper's result",
     r"kernel wrapper's result\) is an implicit", 4),
    ("transfer-discipline", "transfer_discipline_violations.py",
     "np materialization of a jitted result", r"materializes device",
     "np materialization of a wrapper's result", r"reads device memory",
     1),
    ("transfer-discipline", "transfer_discipline_violations.py",
     "jax.device_get off the boundary", r"device_get\(\)` outside",
     ".cpu() off the boundary", r"`\.cpu\(\)` outside", 1),
    ("shard-discipline", "shard_discipline_violations.py",
     "collective outside shard_map scope", r"outside any shard_map",
     "machine-axis reduction outside the collectives",
     r"without a collective", 1),
    ("shard-discipline", "shard_discipline_violations.py",
     "NamedSharding + device_put without pad", r"pad-to-mesh-multiple",
     "per-shard column blocks without pad", r"pad-to-mesh-multiple", 1),
    ("shard-discipline", "shard_discipline_violations.py",
     "sharded jitted def unreachable", r"not reachable from precompile",
     "sharded solve key unreachable", r"not reachable from precompile",
     1),
    ("numerics", "numerics_violations.py",
     "i32 sum / .cumsum() reductions", r"i32-overflow: `(sum|cumsum)`",
     "int32 tensor sum / cumsum without dtype=",
     r"promotion: `(sum|cumsum)`", 2),
    ("numerics", "numerics_violations.py",
     "i32 * i32 product", r"i32-overflow: `\w+ \* \w+`",
     "i32 * i32 tensor product", r"i32-overflow: `\w+ \* \w+`", 1),
    ("numerics", "numerics_violations.py",
     "narrowing astype(int32)", r"narrowing `astype",
     "narrowing .to(torch.int32)", r"narrowing `to", 2),
    ("numerics", "numerics_violations.py",
     "inf-sentinel arithmetic and sums", r"inf-sentinel:",
     "inf-sentinel arithmetic and sums (torch planes)", r"inf-sentinel:",
     4),
    ("numerics", "numerics_violations.py",
     "dtype mix in a jitted def", r"mix dtypes in jitted",
     "dtype mix in a kernel wrapper", r"mix dtypes in kernel wrapper", 1),
    ("numerics", "numerics_violations.py",
     "float literal vs i32 in a jitted def", r"operand in jitted",
     "float literal vs i32 in a kernel wrapper",
     r"operand in kernel wrapper", 1),
    ("numerics", "numerics_violations.py",
     "float literal at a jit call boundary", r"at jit boundary",
     "float literal at a kernel wrapper call", r"to kernel wrapper", 1),
    ("blocking-under-lock", "concurrency_violations.py",
     "sleep / join / get / result / wait under a lock",
     r"sleep|\.join\(\)|\.get\(\)|\.result\(\)|\.wait\(\)",
     "the same five shapes",
     r"sleep|\.join\(\)|\.get\(\)|\.result\(\)|\.wait\(\)", 5),
]


@pytest.mark.parametrize(
    "rule,fixture,j_name,j_pat,t_name,t_pat,n", SUBCHECKS,
    ids=[f"{s[0]}:{s[4]}" for s in SUBCHECKS],
)
def test_torch_meaning_subcheck_counts(rule, fixture, j_name, j_pat, t_name,
                                       t_pat, n):
    assert _count(_j_findings(rule, fixture), j_pat) == n, j_name
    assert _count(_t_findings(rule, fixture), t_pat) == n, t_name


# Reference sub-checks with no torch meaning, by rule: (sub-check, its
# message pattern, its count on the reference's fixture, why).
UNMATCHED = [
    ("jit-purity", "jit_purity_violations.py", "bare print in jit scope",
     r"bare `print\(\)`", 2, "nothing is traced: a print is a host call"),
    ("retrace-guard", "retrace_guard_violations.py",
     "str constant at a traced position",
     r"str constant at traced position", 1,
     "a wrapper's Python arguments are never a compile key"),
    ("retrace-guard", "retrace_guard_violations.py",
     "bool constant at a traced position",
     r"bool constant at traced position", 2,
     "a wrapper's Python arguments are never a compile key"),
    ("transfer-discipline", "transfer_discipline_violations.py",
     "in-place .at update without donate_argnums",
     r"without donate_argnums", 1,
     "torch never deletes an operand; in-place writes its own storage"),
    ("transfer-discipline", "transfer_discipline_violations.py",
     "use after donation", r"read after being donated", 1,
     "torch never deletes an operand"),
    ("shard-discipline", "shard_discipline_violations.py",
     "collective naming an undeclared axis",
     r"which no declared mesh carries", 1,
     "the port's mesh is a list of devices with no axis names"),
    ("shard-discipline", "shard_discipline_violations.py",
     "PartitionSpec naming an undeclared axis",
     r"not a declared mesh axis", 1,
     "the port's mesh is a list of devices with no axis names"),
]


@pytest.mark.parametrize(
    "rule,fixture,name,pattern,n,why", UNMATCHED,
    ids=[f"{u[0]}:{u[2]}" for u in UNMATCHED],
)
def test_unmatched_subchecks_are_listed(rule, fixture, name, pattern, n,
                                        why):
    """The listed sub-check is real in the reference and absent from
    the port's rule."""
    assert why
    assert _count(_j_findings(rule, fixture), pattern) == n, name
    assert _count(_t_findings(rule, fixture), pattern) == 0, name


def test_subcheck_tables_cover_every_reference_finding():
    """Every finding the reference's torch-meaning rules make on their
    fixtures is in the matched table or the unmatched list."""
    rules = {s[0]: s[1] for s in SUBCHECKS + UNMATCHED
             if s[0] != "blocking-under-lock"}
    for rule, fixture in rules.items():
        found = _j_findings(rule, fixture)
        pats = [s[3] for s in SUBCHECKS if s[0] == rule] + \
            [u[3] for u in UNMATCHED if u[0] == rule]
        for f in found:
            assert any(re.search(p, f.message) for p in pats), f.render()

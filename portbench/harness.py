"""The benchmark's harness: finds the cell in ``BENCHMARK.json``, its
configuration file, its traffic file and its metrics' readers by name,
starts the port's server, drives the cell's loop, judges the rounds with
the plain reference, and prints the result line.

Everything that belongs to one configuration (``configs/<name>.json``),
one traffic mix (``traffic/<name>.json``, the parameters of the loop
``loops/<loop>.py`` that its ``loop`` names, a ``loop(ctx)`` function)
or one metric (``metrics/<name>.py``, a ``read`` function of the run's
record) is a file of its own, found by the name ``BENCHMARK.json`` or
the traffic file gives it.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names a run must never load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "poseidon_tpu")
# The numbers that decide ``correct`` and their limits: every one is an
# exact comparison (PERF.md gives the readings they were set from).
LIMITS = {"bad_replies": 0, "infeasible": 0, "neg_cycles": 0,
          "objective_gap": 0, "never_placed": 0}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"portbench: no {what} named {name!r}")


def _load(kind: str, name: str, root: Path):
    """The module ``portbench/<kind>/<name>.py``, loaded from its file."""
    path = root / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def loop_of(name: str, root: Path = ROOT):
    """The ``loop`` function of ``loops/<name>.py``."""
    return _load("loops", name, root).loop


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: with ``--trace 0`` its
    end-to-end metrics, with ``--trace 1`` its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if cell in m.get("workloads", [cell])]


def cell_spec(cell: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's entry, configuration and traffic, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    w = find(bench["workloads"], cell, "workload")
    c = find(bench["configs"], w["config"], "configuration")
    return SimpleNamespace(
        bench=bench, workload=w, config=load_json(root / c["file"]),
        traffic=load_json(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json"))


def set_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so a
    cell's later runs there find every kernel built."""
    cache = root / "portbench" / ".cache"
    os.environ["POSEIDON_COMPILE_CACHE_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def device_info(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.TimeoutExpired):
        return None


class Control:
    """The control: the planner's own host-greedy tier forced on every
    band (its chaos seam), which drops the optimality guarantee."""

    def solver_fault(self):
        return True, None


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", rate: Optional[float] = None,
             control: bool = False, t_start: Optional[float] = None,
             root: Path = ROOT, plant=None) -> dict:
    """Run one cell and return its result (the printed line's object,
    and ``checks``).  ``plant``, for tests, is called with the port's
    servicer before the harness wraps it."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(cell, root)
    if trace:
        # The program's stage timers and spans, read by the per-layer
        # metrics.
        os.environ["POSEIDON_STAGE_TIMERS"] = "1"
        os.environ["POSEIDON_TRACE"] = "1"
    from portbench import tracing
    from portbench.reference import replay

    import torch

    ctx = SimpleNamespace(config=spec.config, traffic=spec.traffic,
                          seed=seed, seconds=float(seconds), rate=rate,
                          t_window=[None, None], cleanup=[],
                          cleanup_client=[])
    # A cell with an end-to-end metric from the device trace runs the
    # profiler in its untraced runs too.
    profiled = trace or any(m["source"] == "device_trace"
                            for m in cell_metrics(spec.bench, cell, False))
    prof = tracing.Profiler() if profiled else None
    ops = []

    def trace_early():
        # The profiler's start takes seconds and holds the interpreter:
        # a loop whose window opens at a set time starts it beforehand.
        if prof is not None and prof.prof is None:
            prof.start()

    def window_start(at=None):
        if at is not None:
            time.sleep(max(0.0, at - time.perf_counter()))
        trace_early()
        ctx.t_window[0] = time.perf_counter() if at is None else at

    def window_end(at=None):
        if at is not None:
            time.sleep(max(0.0, at - time.perf_counter()))
        ctx.t_window[1] = time.perf_counter() if at is None else at
        if prof is not None:
            ops.extend(prof.stop())

    ctx.window_start, ctx.window_end = window_start, window_end
    ctx.trace_early = trace_early
    from portbench.service import GcClock, Service

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    svc = Service(spec.config, device, trace, plant)
    ctx.service = svc
    if control:
        svc.servicer.planner.chaos = Control()
    loop = loop_of(spec.traffic["loop"], root)
    try:
        with GcClock() as gcc:
            out = loop(ctx)
        out["gc"] = gcc.pauses
    finally:
        for c in ctx.cleanup_client:
            c.close()
        svc.stop()
    dev = device_info(device, spec.workload["chips"])
    spans = []
    if trace:
        from poseidon_tpu_torch.obs import trace as obs_trace

        epoch = obs_trace.tracer()._epoch
        spans = [(s["name"], epoch + s["ts"], epoch + s["ts"] + s["dur"])
                 for s in obs_trace.drain_spans()]
    server_rounds = svc.rounds.records
    kind, uid, reply = (svc.intake.kind, svc.intake.uid, svc.intake.reply)
    # The program's state goes before the reference runs.
    del svc, ctx.service
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for p in ctx.cleanup:
        shutil.rmtree(p, ignore_errors=True)

    rounds = out["rounds"]
    notes = []
    if len(server_rounds) != len(rounds):
        notes.append(f"{len(server_rounds)} rounds served, "
                     f"{len(rounds)} answered")
    for r, s in zip(rounds, server_rounds):
        r["server"] = s
    merge = os.environ.get("POSEIDON_MERGE_BANDS")
    merge = merge == "1" if merge in ("0", "1") else device == "cuda"
    verdict = replay(out["machines"], out["shapes"], kind, uid, reply,
                     [(r["server"]["pos"], r["server"]["view"],
                       r["server"]["objective"], r["deltas"])
                      for r in rounds if "server" in r], merge,
                     out["expected"])
    checks = verdict.numbers()
    checks["bad_replies"] += out["bad_replies"] + len(notes)
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)

    walls(rounds, out["gc"])
    rec = dict(out, cell=cell, seconds=float(seconds), window=ctx.t_window,
               setup_s=ctx.t_window[0] - t_start, ops=ops, spans=spans,
               trace=trace)
    metrics = {}
    for m in cell_metrics(spec.bench, cell, trace):
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        w0, w1 = ctx.t_window
        b, _ = tracing.busy(ops, [(w0, w1)])
        dev["busy_s"] = b
        dev["window_s"] = w1 - w0
        result["breakdown"] = {
            "device_ops": tracing.top_ops(ops, [(w0, w1)]),
            "idle_gaps": tracing.label_gaps(tracing.gaps(ops, w0, w1), spans)}
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    result["_notes"] = notes + verdict.notes[:20]
    return result


def walls(rounds, pauses) -> None:
    """Each window round's client wall and the collector's pauses inside
    it (seconds, and the oldest generation collected), on standard
    error: where a round-to-round spread comes from."""
    rows = []
    for r in rounds:
        if r["kind"] not in ("burst", "stream"):
            continue
        a, b = r["client"]
        inside = [(d, g) for t, d, g in pauses if a <= t < b]
        rows.append([round(b - a, 4), round(sum(d for d, _ in inside), 4),
                     max((g for _, g in inside), default=-1)])
    if rows:
        print(f"portbench: window rounds [wall s, collector s, gen]: "
              f"{rows}", file=sys.stderr)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="open loops: arrivals a second instead of the "
                    "traffic file's (the rate sweep)")
    ap.add_argument("--control", action="store_true",
                    help="force the planner's host-greedy tier (the "
                    "control run of the correctness check)")
    a = ap.parse_args(argv)
    set_caches(ROOT)
    spec = cell_spec(a.workload)
    import torch

    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      rate=a.rate, control=a.control, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    for n in notes:
        print(f"portbench: {n}", file=sys.stderr)
    pl = power_limit()
    if pl:
        print(f"portbench: card {pl}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

"""A configuration, a traffic mix, a loop and a per-layer metric are
added as new files and entries only: the harness finds them by name in a
copy of the checkout, with no file of the benchmark edited."""

import json

from portbench import harness

NEW_METRIC = '''"""Pods placed per burst round, from the run's record."""


def read(rec):
    n = len([r for r in rec["rounds"] if r["kind"] == "burst"])
    return rec["attempted"] / n if n else None
'''

NEW_LOOP = '''"""Open loop: pods of the running batch's shapes submitted evenly over
span_s, each completing done_s after its placement, Schedule() at fixed
times every every_s seconds."""

import numpy as np

from portbench import drive, workload


def loop(ctx):
    tr = ctx.traffic
    run = workload.burst_batch(ctx.config, ctx.seed, 0)
    n = int(tr["pods"])
    t = np.linspace(0.05, tr["span_s"], n)
    sched = np.arange(0.2, tr["span_s"] + 2.0, tr["every_s"])
    k = sched.size
    plan = workload.plan(
        np.concatenate([workload.START_WINDOW + np.arange(n),
                        np.zeros(k, np.int64)]),
        np.concatenate([t, sched]),
        np.concatenate([np.full(n, workload.SUBMIT),
                        np.full(k, workload.SCHEDULE)]),
        np.zeros(n + k, np.int64),
        np.concatenate([run.cpu[:n], np.zeros(k, np.int64)]),
        np.concatenate([run.ram[:n], np.zeros(k, np.int64)]),
        np.concatenate([np.full(n, float(tr["done_s"])),
                        np.full(k, np.nan)]),
        running=run, gap_s=0.2, warm_s=0.3)
    return drive.run_plan(ctx, workload.machines(ctx.config, ctx.seed),
                          plan)
'''


def test_new_files_are_found(mini_root):
    root = mini_root
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "northstar-10k.json").read_text())
    cfg["name"] = "tiny-60"
    cfg["machines"]["count"] = 60
    cfg["pods"].update(count=300, shapes=6)
    (pb / "configs" / "tiny-60.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "burst2.json").write_text(
        json.dumps({"loop": "burst"}))
    (pb / "metrics" / "pods_per_round.burst2.py").write_text(NEW_METRIC)
    # A mix whose loop is new: SCHEDULE events at fixed times and
    # completions after placement, neither of which the cells use.
    (pb / "loops" / "trickle.py").write_text(NEW_LOOP)
    (pb / "traffic" / "trickle.json").write_text(json.dumps(
        {"loop": "trickle", "pods": 40, "span_s": 1.5, "every_s": 0.3,
         "done_s": 0.4, "grace_s": 3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, cell2 = "tiny-60.burst2", "tiny-60.trickle"
    bench["configs"].append({"name": "tiny-60", "source": "a test",
                             "file": "portbench/configs/tiny-60.json",
                             "reduced": [], "why": "a test"})
    for c, t in ((cell, "burst2"), (cell2, "trickle")):
        bench["workloads"].append({"name": c, "config": "tiny-60",
                                   "traffic": t, "chips": 1,
                                   "why": "a test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["burst_device_s"]["workloads"].append(cell)
    e2e["pod_latency_p99_s"]["workloads"].append(cell2)
    bench["per_layer"].append({"name": "pods_per_round.burst2",
                               "unit": "pods", "better": "higher",
                               "source": "program_counter",
                               "layer": "Service", "moves": "burst_device_s",
                               "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing there was edited

    spec = harness.cell_spec(cell, root)
    assert spec.config["machines"]["count"] == 60
    assert spec.traffic["loop"] == "burst"
    names = [m["name"] for m in harness.cell_metrics(spec.bench, cell, True)]
    assert names == ["pods_per_round.burst2"]
    e2e = [m["name"] for m in harness.cell_metrics(spec.bench, cell, False)]
    assert e2e == ["burst_device_s", "setup_s"]

    traced = harness.run_cell(cell, 11, 1.0, True, device="cpu", root=root)
    assert traced["correct"], traced
    assert traced["metrics"]["pods_per_round.burst2"]["value"] == 300
    plain = harness.run_cell(cell, 12, 1.0, False, device="cpu", root=root)
    assert plain["correct"], plain
    # The CPU runs no device operation, so the device-trace reader,
    # profiled in the untraced run too, finds nothing to read.
    assert set(plain["metrics"]) == {"setup_s"}

    res = harness.run_cell(cell2, 13, 1.0, False, device="cpu", root=root)
    assert res["correct"], res
    assert set(res["metrics"]) == {"pod_latency_p99_s", "setup_s"}
    # The pods due in the window, each placed by a Schedule() at one of
    # the fixed times (0.3 s apart) and completed after it.
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["pod_latency_p99_s"]["value"] < 1.5

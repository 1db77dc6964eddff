"""The reader of B1's column-cluster share
(``ladder_columns_share.backlog``) on a synthetic traced record of the
backlog's window rounds (labelled ``burst``): the program's launch
counters, None untraced, where the program counts no column launch, and
where no round launched B1."""

import pytest

from portbench import harness

NAME = "ladder_columns_share.backlog"


def window_round(i, launches):
    server = {"t0": 10.1 + 2 * i, "t1": 10.8 + 2 * i, "t2": 10.81 + 2 * i,
              "pos": 0, "view": 0, "objective": 1, "ecs": 30,
              "placed": 38000, "tier": "full", "gap_bound": 0.0,
              "device_calls": 4}
    if launches is not None:
        server["launches"] = launches
    return {"kind": "burst", "client": [10.0 + 2 * i, 11.0 + 2 * i],
            "server": server}


def record(launches, trace=True):
    return {"rounds": [window_round(i, la) for i, la in enumerate(launches)],
            "trace": trace, "ops": [], "spans": [], "window": [10.0, 20.0],
            "setup_s": 1.0}


def counts(fused, columns, cluster=1):
    out = {"fused_ladder": fused, "tiled_iteration": 40,
           "global_update": 10, "coarse_disaggregate": 1, "greedy_seed": 0,
           "fused_ladder_cluster": cluster}
    if columns is not None:
        out["fused_ladder_columns"] = columns
    return out


def test_reader_reads_the_share_of_column_launches():
    """Three B1 launches a round: the row cluster's coarse band 0, and
    band 1's two 8-row planes, one or both on the column cluster."""
    rec = record([counts(3, 1), counts(3, 2), counts(3, 1)])
    assert harness.reader(NAME)(rec) == pytest.approx(100.0 * 4 / 9)


def test_reader_counts_other_rounds_out():
    """The drain rounds after the window (``after``) and an open loop's
    rounds do not count."""
    rec = record([counts(3, 1)])
    for kind in ("after", "stream"):
        r = window_round(5, counts(4, 0))
        r["kind"] = kind
        rec["rounds"].append(r)
    assert harness.reader(NAME)(rec) == pytest.approx(100.0 / 3)


@pytest.mark.parametrize("rec", [
    record([counts(3, 1)], trace=False),
    record([counts(3, None), counts(2, None)]),
    record([None]),
    record([counts(0, 0, cluster=0)]),
], ids=["untraced", "no_column_counter", "no_launch_counts", "no_b1_launch"])
def test_reader_finds_nothing(rec):
    """Untraced, on a program without the column counter (the parent
    commit's traced run leaves the metric out), and where no window round
    launched B1."""
    assert harness.reader(NAME)(rec) is None


def test_reader_is_a_benchmark_metric():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    m = listed[NAME]
    assert (m["unit"], m["better"]) == ("%", "higher")
    assert m["source"] == "program_counter"
    assert m["layer"] == "Kernels (ops/csrc/)"
    assert m["moves"] == "burst_device_s"
    assert m["workloads"] == ["contended-10k.backlog"]

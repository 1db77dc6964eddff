"""The reader of B1's cluster share (``ladder_cluster_share.burst``) on a
synthetic traced record: the program's launch counters of the burst
rounds, None untraced or where the program counts no cluster launch."""

import pytest

from portbench import harness

NAME = "ladder_cluster_share.burst"


def burst_round(i, launches):
    server = {"t0": 10.1 + 2 * i, "t1": 10.8 + 2 * i, "t2": 10.81 + 2 * i,
              "pos": 0, "view": 0, "objective": 1, "ecs": 3, "placed": 10,
              "tier": "full", "gap_bound": 0.0, "device_calls": 2}
    if launches is not None:
        server["launches"] = launches
    return {"kind": "burst", "client": [10.0 + 2 * i, 11.0 + 2 * i],
            "server": server}


def record(launches, trace=True):
    return {"rounds": [burst_round(i, la) for i, la in enumerate(launches)],
            "trace": trace, "ops": [], "spans": [], "window": [10.0, 20.0],
            "setup_s": 1.0}


def counts(fused, cluster):
    out = {"fused_ladder": fused, "tiled_iteration": 40,
           "global_update": 10, "coarse_disaggregate": 2, "greedy_seed": 0}
    if cluster is not None:
        out["fused_ladder_cluster"] = cluster
    return out


def test_reader_reads_the_share_of_cluster_launches():
    rec = record([counts(3, 2), counts(3, 1), counts(2, 2)])
    assert harness.reader(NAME)(rec) == pytest.approx(100.0 * 5 / 8)


def test_reader_counts_stream_rounds_out():
    rec = record([counts(3, 3)])
    stream = burst_round(5, counts(4, 0))
    stream["kind"] = "stream"
    rec["rounds"].append(stream)
    assert harness.reader(NAME)(rec) == pytest.approx(100.0)


@pytest.mark.parametrize("rec", [
    record([counts(3, 2)], trace=False),
    record([counts(3, None), counts(2, None)]),
    record([None]),
    record([counts(0, 0)]),
], ids=["untraced", "no_cluster_counter", "no_launch_counts", "no_b1_launch"])
def test_reader_finds_nothing(rec):
    """Untraced, on a program without the cluster counter (the parent
    commit's traced run leaves the metric out), and where no burst round
    launched B1."""
    assert harness.reader(NAME)(rec) is None


def test_reader_is_a_benchmark_metric():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    m = listed[NAME]
    assert m["source"] == "program_counter"
    assert m["moves"] == "burst_device_s"
    assert m["workloads"] == ["northstar-10k.burst"]

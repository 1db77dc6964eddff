"""The readers of the program's own spans (``portbench/spans.py``) on a
synthetic traced record: a value where the spans are, None untraced or
where the program recorded no span of the name."""

import pytest

from portbench import harness


def server(t0, t1):
    return {"t0": t0, "t1": t1, "t2": t1 + 0.01, "pos": 0, "view": 0,
            "objective": 1, "ecs": 3, "placed": 10, "tier": "pruned",
            "gap_bound": 0.0, "device_calls": 1}


def record(trace=True):
    burst = [{"kind": "burst", "client": [10.0 + 2 * i, 11.0 + 2 * i],
              "server": server(10.1 + 2 * i, 10.8 + 2 * i)}
             for i in range(2)]
    stream = [{"kind": "stream", "client": [20.0 + 2 * i, 21.0 + 2 * i],
               "server": server(20.1 + 2 * i, 20.9 + 2 * i)}
              for i in range(3)]
    # A stream round without a snapshot counts in no per-round mean.
    quiet = dict(server(26.1, 26.2), view=None)
    stream.append({"kind": "stream", "client": [26.0, 26.5],
                   "server": quiet})
    spans = [
        # Two submissions in the window, one before it.
        ("rpc.TaskSubmitted.queued", 19.0, 19.5),
        ("rpc.TaskSubmitted.queued", 20.0, 20.002),
        ("rpc.TaskSubmitted.queued", 21.0, 21.004),
        ("rpc.TaskSubmitted", 19.5, 19.6),
        ("rpc.TaskSubmitted", 20.002, 20.003),
        ("rpc.TaskSubmitted", 21.004, 21.007),
        # Missed snapshots: three end in round 0's [t0, t2], one in
        # round 2's, one between rounds, one in the quiet round.
        ("pod.missed_cut", 15.0, 20.5),
        ("pod.missed_cut", 15.1, 20.5),
        ("pod.missed_cut", 15.2, 20.905),
        ("pod.missed_cut", 19.0, 24.5),
        ("pod.missed_cut", 19.0, 23.5),
        ("pod.missed_cut", 19.0, 26.15),
        # Collections: 0.2 s inside round 1, half of 0.1 s at round 2's
        # start, one between rounds.
        ("runtime.gc", 22.3, 22.5),
        ("runtime.gc", 24.05, 24.15),
        ("runtime.gc", 23.5, 23.6),
        # The deltas' protobuf after each burst's round, inside its wall.
        ("service.deltas_to_proto", 10.82, 10.92),
        ("service.deltas_to_proto", 12.82, 12.86),
        ("round", 10.1, 10.8),
    ]
    return {"rounds": burst + stream, "trace": trace, "ops": [],
            "window": [20.0, 30.0], "spans": spans if trace else [],
            "setup_s": 1.0}


EXPECTED = {
    "rpc_queue_ms.stream": 3.0,
    "submit_handler_ms.stream": 2.0,
    "missed_cut_pods.stream": 4 / 3,
    "gc_pause_s.stream": 0.25 / 3,
    "deltas_proto_s.burst": 0.07,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_spans(name):
    assert harness.reader(name)(record()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_untraced(name):
    assert harness.reader(name)(record(trace=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_its_spans(name):
    """The parent commit records none of these spans: its traced run
    leaves the metric out."""
    rec = record()
    rec["spans"] = [s for s in rec["spans"] if s[0] == "round"]
    assert harness.reader(name)(rec) is None


def test_every_new_reader_is_a_benchmark_metric():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        assert listed[name]["source"] == "program_span"

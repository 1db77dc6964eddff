"""Each metric reader on a recorded set of rounds, spans and device
operations."""

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import REPO


def server(t0, t1, view=0, **kw):
    rec = {"t0": t0, "t1": t1, "t2": t1 + 0.01, "pos": 0, "view": view,
           "objective": 1, "ecs": 3, "placed": 10, "tier": "dense",
           "gap_bound": 0.0, "device_calls": 1}
    rec.update(kw)
    return rec


def record():
    stages = {"round": 0.5, "round.view_build": 0.1,
              "round.cost_build": 0.05, "round.assign": 0.2,
              "solve.host_cert": 0.01}
    burst = [{"kind": "burst", "client": [10.0 + 2 * i, 11.0 + 2 * i],
              "server": server(10.1 + 2 * i, 10.9 + 2 * i, stages=stages,
                               device={"solve.device.fused": 0.04,
                                       "solve.device.tiled": 0.02,
                                       "solve.device.tiled.iterate": 0.01},
                               host_reads=36,
                               routes=[["tiled", 128, 10240, 1]])}
             for i in range(3)]
    stream = [{"kind": "stream", "client": [20.0 + i, 20.5 + i],
               "server": server(20.1 + i, 20.4 + i, stages=stages)}
              for i in range(4)]
    # One B2 iteration in every burst: 21 MB in 9 us of kernels.
    ops = []
    for i in range(3):
        t = 10.5 + 2 * i
        ops += [("pt_seg(Iter)", t, t + 2e-6, (40, 8, 1)),
                ("pt_push(Iter)", t + 3e-6, t + 9e-6, (40, 8, 1)),
                ("pt_final(Iter)", t + 9e-6, t + 10e-6, (47, 1, 1))]
    ops.append(("other", 10.2, 10.3, None))
    return {"rounds": burst + stream, "trace": True, "ops": ops,
            "window": [10.0, 20.0], "setup_s": 12.5, "latency": np.linspace(0.1, 1.1, 101),
            "submit_rtt": np.full(10, 0.002), "gc": [(10.2, 0.05)]}


EXPECTED = {
    "burst_device_s": (0.1 + 3 * 9e-6) / 3,
    "round_wall_s.burst": 1.0,
    "pod_latency_p50_s": 0.6,
    "pod_latency_p99_s": 1.09,
    "setup_s": 12.5,
    "service_overhead_s.burst": 1.0 - 0.81,
    "submit_rpc_ms.stream": 2.0,
    "view_build_s.burst": 0.1,
    "view_build_s.stream": 0.1,
    "cost_build_s.burst": 0.05,
    "cost_build_s.stream": 0.05,
    "assign_s.burst": 0.2,
    "round_s.stream": 0.5,
    "host_cert_s.stream": 0.01,
    "device_solve_s.burst": 0.06,
    "host_reads.burst": 36,
    "tiled_iteration_roofline": 100 * (16 * 128 * 10240 / 3.35e12) / 9e-6,
    "gc_pause_s.burst": 0.05 / 3,
    "device_idle_pct.burst": 100 * (1 - (0.1 + 3 * 9e-6) / 3.0),
    "device_idle_pct.stream": 100 * (1 - (0.1 + 3 * 9e-6) / 10.0),
}


def all_metrics():
    bench = harness.load_json(REPO / "BENCHMARK.json")
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]


@pytest.mark.parametrize("name", all_metrics())
def test_reader(name):
    assert harness.reader(name)(record()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", [n for n in all_metrics()
                                  if n not in ("setup_s",)])
def test_reader_finds_nothing(name):
    """Untraced, or with no rounds of its kind, a reader returns None."""
    rec = {"rounds": [], "trace": False, "ops": [], "window": [0.0, 1.0],
           "setup_s": 1.0}
    assert harness.reader(name)(rec) is None


def test_breakdown_shares_gaps_among_spans():
    from portbench import tracing

    ops = [("(anonymous namespace)::k(Iter)", 1.0, 1.1, None),
           ("void k2<1>(int)", 5.0, 5.2, None)]
    idle = tracing.gaps(ops, 0.0, 10.0)
    assert idle == [(0.0, 1.0), (1.1, 5.0), (5.2, 10.0)]
    spans = [("round", 0.5, 3.0), ("round.view_build", 0.6, 0.9),
             ("round", 4.0, 6.0)]
    got = dict(tracing.label_gaps(idle, spans))
    assert got == pytest.approx({"outside the program's spans": 5.5,
                                 "round": 3.9, "round.view_build": 0.3})
    assert tracing.top_ops(ops, [(0.0, 10.0)]) == [
        ["k2<1>", pytest.approx(0.2)], ["k", pytest.approx(0.1)]]

"""The readers of the contended cell's per-layer metrics on a recorded
backlog run: the planner's per-round counts the loop records and the
program's ``round.band_group`` spans.  A program without the new counts
(the loop records them as None) and without the span reads None, but for
``unscheduled_pct.backlog``, whose two counts every program has."""

import pytest

from portbench import harness

NEW = ("band_groups.backlog", "band_group_s.backlog",
       "escalated_ecs.backlog", "unscheduled_pct.backlog")


def backlog_round(i, kind, planner):
    server = {"t0": 10.1 + 2 * i, "t1": 10.8 + 2 * i, "t2": 10.81 + 2 * i,
              "pos": 0, "view": i, "objective": 1, "ecs": 30,
              "placed": 390, "tier": "dense", "gap_bound": 0.0,
              "device_calls": 2}
    return {"kind": kind, "client": [10.0 + 2 * i, 11.0 + 2 * i],
            "server": server, "planner": planner}


def counts(groups, escalated, wait, left, seen, new=True):
    p = {"band_groups": groups, "escalated_ecs": escalated,
         "max_wait_rounds": wait, "unscheduled": left, "num_tasks": seen}
    if not new:
        p.update(band_groups=None, escalated_ecs=None, max_wait_rounds=None)
    return p


def record(new=True, trace=True):
    rounds = [backlog_round(0, "setup", counts(2, 0, 0, 80, 480, new))]
    rounds += [backlog_round(i, "burst", counts(2, 6 + i, 1, 90 + i, 480,
                                                new))
               for i in range(1, 4)]
    rounds.append(backlog_round(4, "after", counts(1, 9, 1, 0, 93, new)))
    spans = []
    if new:
        # Two groups in every round; only the window rounds' count.
        for i in range(5):
            t = 10.2 + 2 * i
            spans += [("round.band_group", t, t + 0.1 * (i + 1)),
                      ("round.band_group", t + 0.3, t + 0.35)]
    return {"rounds": rounds, "trace": trace, "ops": [], "spans": spans,
            "window": [11.5, 18.0], "setup_s": 1.0}


EXPECTED = {
    "band_groups.backlog": 2.0,
    "band_group_s.backlog": (0.2 + 0.3 + 0.4 + 3 * 0.05) / 6,
    "escalated_ecs.backlog": 8.0,
    "unscheduled_pct.backlog": 100.0 * (91 + 92 + 93) / (3 * 480),
}


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_window_rounds(name):
    assert harness.reader(name)(record()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_program_without_the_counts(name):
    got = harness.reader(name)(record(new=False))
    if name == "unscheduled_pct.backlog":
        assert got == pytest.approx(EXPECTED[name])
    else:
        assert got is None


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing(name):
    """No window rounds, or rounds the loop recorded no counts for."""
    empty = {"rounds": [], "trace": True, "ops": [], "spans": [],
             "window": [0.0, 1.0], "setup_s": 1.0}
    assert harness.reader(name)(empty) is None
    rec = record()
    for r in rec["rounds"]:
        del r["planner"]
    rec["spans"] = []
    assert harness.reader(name)(rec) is None


def test_span_reader_needs_a_traced_run():
    assert harness.reader("band_group_s.backlog")(record(trace=False)) is None

"""The port's trace replay (``replay/``) against the JAX package's.

The same trace goes through both packages' ``ReplayDriver`` (the port's
on the CPU): every round's deltas must be byte-identical and
``summary()`` equal but for its time fields, for a steady replay and for
the pressure replay (machines removed mid-trace, the whole workload
re-entering every round), which must emit PREEMPT and MIGRATE on both
sides.
"""

import pytest

from poseidon_tpu.replay import ReplayDriver as JReplayDriver
from poseidon_tpu.replay import synthesize_trace as j_synthesize
from poseidon_tpu_torch.replay import ReplayDriver, synthesize_trace


def _events(E):
    return [(e.time, e.kind, e.payload) for e in E]


@pytest.mark.parametrize("remove_frac", [0.0, 0.25])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_synthesize_trace_equal(seed, remove_frac):
    kw = dict(horizon_s=900.0, seed=seed, remove_frac=remove_frac)
    got = synthesize_trace(40, 70, **kw)
    assert _events(got) == _events(j_synthesize(40, 70, **kw))
    kinds = [e.kind for e in got]
    assert kinds.count("machine_add") == 40
    assert kinds.count("job_submit") == 70
    assert kinds.count("machine_remove") == int(40 * remove_frac)


def _run(driver, rounds):
    """Per-round (task, machine, type) deltas, and the summary without
    its time fields."""
    per_round = []
    schedule_round = driver.planner.schedule_round

    def recorded():
        deltas, m = schedule_round()
        per_round.append([(int(d.task_id), d.resource_id, int(d.type))
                          for d in deltas])
        return deltas, m

    driver.planner.schedule_round = recorded
    report = driver.run(max_rounds=rounds)
    summary = {k: v for k, v in report.summary().items()
               if not k.endswith("_s")}
    return per_round, summary, report


CASES = {
    # A small steady replay: 64 machines, 80 jobs, 4 rounds.
    "steady": dict(trace=(64, 80), kw=dict(horizon_s=400.0, seed=2),
                   driver=dict(round_interval_s=100.0), rounds=4),
    # The pressure replay: a quarter of the fleet removed mid-trace, the
    # whole workload re-entering every round.
    "pressure": dict(trace=(24, 120),
                     kw=dict(horizon_s=600.0, seed=6, remove_frac=0.25),
                     driver=dict(round_interval_s=30.0,
                                 reschedule_running=True), rounds=20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_matches_the_reference(case):
    c = CASES[case]
    got = _run(ReplayDriver(synthesize_trace(*c["trace"], **c["kw"]),
                            device="cpu", **c["driver"]), c["rounds"])
    ref = _run(JReplayDriver(j_synthesize(*c["trace"], **c["kw"]),
                             **c["driver"]), c["rounds"])
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[1]["rounds"] == c["rounds"] and got[1]["converged"]
    assert got[1]["precompile_shapes"] > 0
    if case == "pressure":
        # The reference's test_pressure_replay_exercises_preempt_and_migrate,
        # held on both sides.
        for _, s, _ in (got, ref):
            assert s["preempted"] > 0 and s["migrated"] > 0, s
    else:
        assert got[1]["placed"] == got[1]["tasks_submitted"]


def test_replay_runs_on_the_card_unless_asked():
    """The driver's entry point defaults to the card: with no card and no
    ``device="cpu"`` it raises instead of falling back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplayDriver(synthesize_trace(4, 4, seed=0))


def test_replay_progress_breadcrumbs(monkeypatch, capsys):
    monkeypatch.setenv("POSEIDON_REPLAY_PROGRESS", "1")
    driver = ReplayDriver(synthesize_trace(8, 6, horizon_s=60.0, seed=1),
                          round_interval_s=30.0, device="cpu")
    report = driver.run(max_rounds=2)
    err = capsys.readouterr().err
    assert "# replay precompile:" in err
    assert err.count("# replay round ") == report.rounds == 2

"""The comparison that decides ``correct`` fails when the timed path is
broken: a whole run on the CPU (the harness's look for a chip skipped)
with a fault planted in the program under the harness's records, and the
control (the planner's host-greedy tier forced on every band, which drops
the optimality guarantee)."""

import dataclasses

import pytest

from portbench import harness


def unchanged(servicer):
    """A round that returns the state unchanged: no snapshot, no deltas."""
    p = servicer.planner
    p.schedule_round = lambda: ([], p.last_metrics)


def half(servicer):
    """Half of each round's answers left out."""
    p = servicer.planner
    inner = p.schedule_round

    def f():
        d, m = inner()
        return d[: len(d) // 2], m

    p.schedule_round = f


def altered(servicer):
    """One answer of each round altered where it is produced: its pod
    sent to another machine."""
    p = servicer.planner
    inner = p.schedule_round

    def f():
        d, m = inner()
        if d:
            ids = sorted(servicer.state.machines)
            k = len(d) // 2
            other = ids[0] if d[k].resource_id != ids[0] else ids[1]
            d[k] = dataclasses.replace(d[k], resource_id=other)
        return d, m

    p.schedule_round = f


CELLS = ("northstar-10k.burst", "northstar-10k.churn")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(mini_root, cell):
    res = harness.run_cell(cell, 21, 2.0, False, device="cpu",
                           root=mini_root)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half, altered],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(mini_root, cell, fault):
    res = harness.run_cell(cell, 22, 2.0, False, device="cpu",
                           root=mini_root, plant=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(mini_root, cell):
    res = harness.run_cell(cell, 23, 2.0, False, device="cpu",
                           root=mini_root, control=True)
    assert not res["correct"]
    assert res["checks"]["neg_cycles"]["value"] > 0

"""The traffic generators: the same seed gives the same inputs, another
seed other inputs of the same size."""

import json

import numpy as np
import pytest

from portbench import workload as W
from portbench.tests.conftest import REPO


def config(name):
    return json.loads((REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())


def traffic(name):
    return json.loads((REPO / "portbench" / "traffic"
                       / f"{name}.json").read_text())


def test_machines_by_seed():
    cfg = config("northstar-10k")
    a, b = W.machines(cfg, 5), W.machines(cfg, 5)
    assert a.uuids == b.uuids and np.array_equal(a.cpu, b.cpu)
    assert len(a.uuids) == cfg["machines"]["count"]
    # Three classes in turn: a third of the fleet each.
    _, counts = np.unique(a.cpu, return_counts=True)
    assert counts.size == 3 and counts.max() - counts.min() <= 1


def test_burst_batch_by_seed_and_step():
    cfg = config("northstar-10k")
    big = (1 << 31) + 12345
    a, b = W.burst_batch(cfg, big, 3), W.burst_batch(cfg, big, 3)
    assert np.array_equal(a.uid, b.uid) and np.array_equal(a.cpu, b.cpu)
    c = W.burst_batch(cfg, big, 4)
    d = W.burst_batch(cfg, big + 1, 3)
    assert not np.array_equal(a.cpu, c.cpu)
    assert not np.array_equal(a.cpu, d.cpu)
    # Uids never repeat across steps; each shape holds an equal share.
    assert not set(a.uid.tolist()) & set(c.uid.tolist())
    _, counts = np.unique(np.stack([a.cpu, a.ram]), axis=1,
                          return_counts=True)
    assert counts.size == cfg["pods"]["shapes"]
    assert counts.min() == counts.max()
    lo, hi = cfg["pods"]["cpu"]
    assert a.cpu.min() >= lo and a.cpu.max() < hi


def test_churn_by_seed():
    cfg, tr = config("northstar-10k"), traffic("churn")
    big = (1 << 31) + 777
    a = W.churn(cfg, tr, big, 10, 400)
    b = W.churn(cfg, tr, big, 10, 400)
    for k in ("t", "kind", "uid", "job", "cpu", "ram"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    c = W.churn(cfg, tr, big + 1, 10, 400)
    assert not np.array_equal(a.t, c.t)
    span = tr["warm_s"] + 10 + tr["tail_s"]
    for p in (a, c):
        assert np.all(np.diff(p.t) >= 0)
        sub = p.kind == W.SUBMIT
        comp = p.kind == W.COMPLETE
        # The same work on every seed: the rate's arrivals, as many
        # completions of distinct running pods, no Schedule() events
        # (the loop's interval).
        assert sub.sum() == comp.sum() == round(400 * span)
        assert not (p.kind == W.SCHEDULE).any()
        assert p.gap_s == tr["schedule_gap_s"]
        done = p.uid[comp]
        assert np.unique(done).size == done.size
        assert np.isin(done, p.running.uid).all()
        # Each arrival takes one of the running batch's shapes, every
        # shape an equal share, and a job by shape.
        shapes = set(zip(p.running.cpu.tolist(), p.running.ram.tolist()))
        got = list(zip(p.cpu[sub].tolist(), p.ram[sub].tolist()))
        assert set(got) == shapes
        _, n = np.unique(p.job[sub], return_counts=True)
        assert n.size == cfg["pods"]["shapes"] and n.max() - n.min() <= 1
        # The window holds its share of arrivals exactly.
        w = (p.t >= tr["warm_s"]) & (p.t < tr["warm_s"] + 10)
        assert (w & sub).sum() == 4000

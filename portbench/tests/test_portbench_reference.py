"""The plain reference against hand-worked tiny clusters."""

import numpy as np

from portbench import reference as R


def machines(cpu, ram, slots):
    return R.Machines([f"m{i}" for i in range(len(cpu))], cpu, ram, slots)


def test_cost_planes_by_hand():
    # Two machines, one with 1000 of 4000 millicores and 1 of 4 GiB used.
    cap_cpu = np.array([4000, 8000], np.int64)
    cap_ram = np.array([4 << 20, 8 << 20], np.int64)
    used_cpu = np.array([1000, 0], np.int64)
    used_ram = np.array([1 << 20, 0], np.int64)
    costs, arc, adm = R.cost_planes([1000, 5000], [1 << 20, 1 << 20],
                                    cap_cpu, cap_ram, used_cpu, used_ram)
    # Row 0 on m0: load (0.75 * 2000/4000 + 0.75 * 2/4) / 2 = 0.375.
    assert costs[0, 0] == 375
    # Row 0 on m1: 0.75 * (1000/8000 + 1/8) / 2 = 0.09375 -> 94.
    assert costs[0, 1] == 94
    # Three more of row 0 fit on m0 (cpu 3000 free, ram 3 GiB free).
    assert arc[0, 0] == 3 and arc[0, 1] == 8
    # Row 1 (5000 millicores) fits only m1.
    assert not adm[1, 0] and adm[1, 1] and costs[1, 0] == R.INF_COST
    assert arc[1, 1] == 1


def test_unsched_escalates_and_caps():
    assert R.unsched_costs([0, 1, 100]).tolist() == [2000, 2250, 8000]


def test_bands_and_merge():
    cap_cpu = np.array([64000] * 4, np.int64)
    cap_ram = np.array([256 << 20] * 4, np.int64)
    cpu = np.array([4000, 3000, 100], np.int64)
    ram = np.array([1 << 20, 1 << 20, 1 << 18], np.int64)
    bands = R.bands_of(cpu, ram, cap_cpu, cap_ram)
    assert bands.tolist() == [1, 1, 3]
    zero = np.zeros(4, np.int64)
    # Plenty of room: both bands solve together.
    n, idx = R.next_group([1, 3], bands, cpu, ram, np.array([2, 2, 2]),
                          cap_cpu, cap_ram, zero, zero, merge=True)
    assert n == 2 and idx.tolist() == [0, 1, 2]
    # No merging asked for, or too little room: one band.
    n, idx = R.next_group([1, 3], bands, cpu, ram, np.array([2, 2, 2]),
                          cap_cpu, cap_ram, zero, zero, merge=False)
    assert n == 1 and idx.tolist() == [0, 1]
    n, _ = R.next_group([1, 3], bands, cpu, ram, np.array([30, 30, 30]),
                        cap_cpu, cap_ram, zero, zero, merge=True)
    assert n == 1


def test_negative_cycle_by_hand():
    # Two rows, two columns of one slot each: row 0 is cheap on column 0
    # and row 1 is indifferent.
    costs = np.array([[1, 10], [5, 5]], np.int32)
    adm = np.ones((2, 2), bool)
    arc = np.ones((2, 2), np.int32)
    col = np.array([1, 1])
    un = np.array([100, 100])
    sup = np.array([1, 1])
    good = np.array([[1, 0], [0, 1]])
    swapped = np.array([[0, 1], [1, 0]])
    assert not R.negative_cycle(costs, adm, arc, col, un, sup, good)
    assert R.negative_cycle(costs, adm, arc, col, un, sup, swapped)
    # Leaving a pod out while a column has room is not optimal ...
    lazy = np.array([[1, 0], [0, 0]])
    assert R.negative_cycle(costs, adm, arc, col, un, sup, lazy)
    # ... unless placing it costs more than leaving it.
    assert not R.negative_cycle(costs, adm, arc, col, np.array([100, 4]),
                                sup, lazy)


def test_judge_counts_bad_replies_and_overcommit():
    m = machines([4000, 4000], [4 << 20, 4 << 20], [2, 2])
    ref = R.Reference(m, merge_bands=True)
    for u in (1, 2, 3):
        ref.submit(u, 3000, 1 << 20)
    # Pod 9 is unknown, pod 1 is placed twice, a PREEMPT is unexpected.
    v = ref.judge([1, 1, 9, 2], [0, 1, 0, 1], [1, 1, 1, 2], None)
    assert v.bad_replies == 3
    # Placing pods 2 and 3 both on machine 1 overcommits its cpu.
    ref2 = R.Reference(m, merge_bands=True)
    for u in (2, 3):
        ref2.submit(u, 3000, 1 << 20)
    v2 = ref2.judge([2, 3], [1, 1], [1, 1], None)
    assert v2.infeasible >= 1


def test_judge_optimal_round_and_objective():
    m = machines([4000, 8000], [4 << 20, 8 << 20], [4, 4])
    ref = R.Reference(m, merge_bands=True)
    ref.submit(1, 1000, 1 << 20)
    # The empty, larger machine is the cheaper: 94 against 188.
    v = ref.judge([1], [1], [1], port_objective=94)
    assert (v.neg_cycles, v.objective_gap, v.infeasible) == (0, 0, 0)
    ref = R.Reference(m, merge_bands=True)
    ref.submit(1, 1000, 1 << 20)
    v = ref.judge([1], [0], [1], port_objective=188)
    assert v.neg_cycles == 1 and v.objective_gap == 0


def test_replay_orders_inputs_and_finds_pods_never_placed():
    m = machines([4000], [4 << 20], [4])
    shapes = {1: (1000, 1 << 20), 2: (1000, 1 << 20)}
    S, C, V = R.SUBMIT, R.COMPLETE, R.VIEW
    # Pod 1 placed in round 0; pod 2 arrives after round 0's snapshot,
    # and no later round takes a snapshot.
    kind = [S, V, S]
    uid = [1, 0, 2]
    reply = [1, 0, 1]
    rounds = [(1, 0, 188, ([1], [0], [1])), (3, None, None, ([], [], []))]
    v = R.replay(m, shapes, kind, uid, reply, rounds, True, expected=[1, 2])
    assert v.numbers() == {"bad_replies": 0, "infeasible": 0,
                           "neg_cycles": 0, "objective_gap": 0,
                           "never_placed": 1}
    # A round without a snapshot may not move anything.
    rounds[1] = (3, None, None, ([2], [0], [1]))
    v = R.replay(m, shapes, kind, uid, reply, rounds, True)
    assert v.bad_replies == 1

"""The port's cost planes against the JAX package's, bit for bit.

Seeded clusters go into both packages' ClusterState; the round views and
the ``cpu_mem`` (and ``trivial``) cost, arc-capacity and capacity planes
must be equal, with and without node selectors and pod (anti-)affinity,
and so must the planner's resource-safe column capacities.  The
network-aware ``net`` and the interference-aware ``whare`` and ``coco``
models are held to the reference the same way, on clusters with NIC
capacities, task classes, CoCo penalties and running tasks, and through
whole planner rounds.
"""

import numpy as np
import pytest

from poseidon_tpu.costmodel import get_cost_model as j_cost_model
from poseidon_tpu.graph import instance as j_instance
from poseidon_tpu.graph import state as j_state
from poseidon_tpu.utils.ids import generate_uuid, hash_combine
from poseidon_tpu_torch.costmodel import get_cost_model
from poseidon_tpu_torch.graph import instance as t_instance
from poseidon_tpu_torch.graph import state as t_state


def _cluster(mod, seed, *, selectors, affinity, machines=60, tasks=400):
    rng = np.random.default_rng(seed)
    st = mod.ClusterState()
    hw = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]
    for i in range(machines):
        cpu, ram = hw[i % 3]
        st.node_added(mod.MachineInfo(
            uuid=generate_uuid(f"cm-m{seed}-{i}"), cpu_capacity=cpu,
            ram_capacity=ram, task_slots=int(rng.integers(4, 32)),
            labels={"zone": "abc"[i % 3], "gpu": "yes"} if i % 4 == 0
            else {"zone": "abc"[i % 3]},
        ))
    shapes = [(int(rng.integers(100, 9000)), int(rng.integers(1 << 18,
                                                               1 << 24)))
              for _ in range(14)]
    for i in range(tasks):
        e = int(rng.integers(0, len(shapes)))
        sel = ()
        if selectors and e % 3 == 0:
            sel = ((0, "zone", ("a", "b")),)
        if selectors and e % 5 == 0:
            sel = sel + ((2, "gpu", ()),)
        aff = anti = ()
        labels = {"app": f"a{e % 4}"}
        if affinity and e % 4 == 1:
            anti = ((0, "app", ("a1",)),)
        if affinity and e % 7 == 2:
            aff = ((0, "app", ("a0",)),)
        st.task_submitted(mod.TaskInfo(
            uid=hash_combine(seed, i), job_id=f"cm-{e}",
            cpu_request=shapes[e][0], ram_request=shapes[e][1],
            selectors=sel, pod_affinity=aff, pod_anti_affinity=anti,
            labels=labels,
        ))
    # Some residents, so load pricing and residency count matter.
    placed = [(hash_combine(seed, i), generate_uuid(f"cm-m{seed}-{i % 9}"))
              for i in range(0, tasks, 7)]
    st.apply_placements(placed)
    return st


def _views(seed, **kw):
    js = _cluster(j_state, seed, **kw)
    ts = _cluster(t_state, seed, **kw)
    return js.build_round_view(), ts.build_round_view()


@pytest.mark.parametrize("model", ["cpu_mem", "trivial"])
@pytest.mark.parametrize("selectors,affinity", [(False, False),
                                                (True, False),
                                                (True, True)])
@pytest.mark.parametrize("seed", range(2))
def test_cost_planes_bit_equal(model, selectors, affinity, seed):
    jv, tv = _views(seed, selectors=selectors, affinity=affinity)
    np.testing.assert_array_equal(jv.ecs.ec_ids, tv.ecs.ec_ids)
    np.testing.assert_array_equal(jv.ecs.supply, tv.ecs.supply)
    assert jv.machines.uuids == tv.machines.uuids
    jc = j_cost_model(model).build(jv.ecs, jv.machines)
    tc = get_cost_model(model).build(tv.ecs, tv.machines)
    np.testing.assert_array_equal(jc.costs, tc.costs)
    np.testing.assert_array_equal(jc.unsched_cost, tc.unsched_cost)
    np.testing.assert_array_equal(jc.capacity, tc.capacity)
    if jc.arc_capacity is None:
        assert tc.arc_capacity is None
    else:
        np.testing.assert_array_equal(jc.arc_capacity, tc.arc_capacity)
    assert (jc.costs < j_instance.INF_COST).any()
    if selectors:
        assert (jc.costs >= j_instance.INF_COST).any()


@pytest.mark.parametrize("seed", range(2))
def test_column_caps_bit_equal(seed):
    jv, tv = _views(seed, selectors=True, affinity=False)
    jc = j_cost_model("cpu_mem").build(jv.ecs, jv.machines)
    tc = get_cost_model("cpu_mem").build(tv.ecs, tv.machines)
    mt_j, mt_t = jv.machines, tv.machines
    args_j = (mt_j.cpu_used.astype(np.int64), mt_j.ram_used.astype(np.int64),
              np.zeros(mt_j.num_machines, np.int64))
    args_t = (mt_t.cpu_used.astype(np.int64), mt_t.ram_used.astype(np.int64),
              np.zeros(mt_t.num_machines, np.int64))
    cj, nj = j_instance._column_caps(jv.ecs, jc, mt_j, *args_j)
    ct, nt = t_instance._column_caps(tv.ecs, tc, mt_t, *args_t)
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(nj, nt)


def _interference_cluster(mod, seed, machines=48, tasks=300):
    """NIC capacities and usage, four task classes, CoCo penalties on
    some machines and running tasks, so every model term is live."""
    rng = np.random.default_rng(100 + seed)
    st = mod.ClusterState()
    hw = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]
    for i in range(machines):
        cpu, ram = hw[i % 3]
        m = mod.MachineInfo(
            uuid=generate_uuid(f"im-m{seed}-{i}"), cpu_capacity=cpu,
            ram_capacity=ram, task_slots=int(rng.integers(4, 24)),
            net_rx_capacity=int(rng.choice([0, 2000, 10_000])),
            cpu_util=float(rng.random()), mem_util=float(rng.random()),
        )
        if i % 3 == 1:
            m.coco_penalties = tuple(int(x) for x in
                                     rng.integers(0, 600, size=4))
        st.node_added(m)
    for i in range(tasks):
        e = int(rng.integers(0, 12))
        st.task_submitted(mod.TaskInfo(
            uid=hash_combine(seed, i), job_id=f"im-{e}",
            cpu_request=200 + 300 * e, ram_request=(1 << 18) * (1 + e % 5),
            net_rx_request=[0, 150, 400][e % 3], task_type=e % 4,
        ))
    placed = [(hash_combine(seed, i), generate_uuid(f"im-m{seed}-{i % 11}"))
              for i in range(0, tasks, 5)]
    st.apply_placements(placed)
    return st


@pytest.mark.parametrize("model", ["net", "whare", "coco"])
@pytest.mark.parametrize("seed", range(2))
def test_interference_and_net_planes_bit_equal(model, seed):
    jv = _interference_cluster(j_state, seed).build_round_view()
    tv = _interference_cluster(t_state, seed).build_round_view()
    assert jv.machines.uuids == tv.machines.uuids
    jc = j_cost_model(model).build(jv.ecs, jv.machines)
    tc = get_cost_model(model).build(tv.ecs, tv.machines)
    for f in ("costs", "unsched_cost", "capacity", "arc_capacity"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
    base = get_cost_model("cpu_mem").build(tv.ecs, tv.machines)
    finite = tc.costs < j_instance.INF_COST
    # The model's own term is live, not a copy of the base plane.
    assert (tc.costs[finite] != base.costs[finite]).any()
    # The models keep the reference's delta-plane opt-in (off).
    assert get_cost_model(model).delta_plane is \
        j_cost_model(model).delta_plane is False


@pytest.mark.parametrize("model", ["net", "whare", "coco"])
def test_interference_and_net_rounds_identical(model):
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner

    jp = JPlanner(_interference_cluster(j_state, 0), j_cost_model(model))
    tp = t_instance.RoundPlanner(_interference_cluster(t_state, 0),
                                 get_cost_model(model), device="cpu")
    placed = []
    for _ in range(2):
        jd, jm = jp.schedule_round()
        td, tm = tp.schedule_round()
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in ("placed", "unscheduled", "objective", "iterations",
                     "gap_bound", "device_calls"):
            assert getattr(jm, name) == getattr(tm, name), name
        placed.append(tm.placed)
    assert placed[0] > 0

"""The port's cost planes against the JAX package's, bit for bit.

Seeded clusters go into both packages' ClusterState; the round views and
the ``cpu_mem`` (and ``trivial``) cost, arc-capacity and capacity planes
must be equal, with and without node selectors and pod (anti-)affinity,
and so must the planner's resource-safe column capacities.
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

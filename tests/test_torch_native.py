"""The port's native C++ graph core under ``ClusterState``.

The core mirrors every ``ClusterState`` mutation; its round view must
equal the port's pure-Python builder (a differential fuzz over a long
random mutation sequence) and the JAX package's ``ClusterState`` view on
the same mutations (the reference runs its own copy of the core).
"""

import numpy as np
import pytest

from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo, TaskInfo
from poseidon_tpu_torch.native import bindings, native_available
from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid


@pytest.fixture(autouse=True)
def _toolchain():
    # Decided in a fixture, not at import: every test worker collects the
    # same tests whether or not its build succeeds.
    if not native_available():
        pytest.skip("native toolchain unavailable")


def make_machine(i, **kw):
    defaults = dict(uuid=generate_uuid(f"nm{i}"), cpu_capacity=8000,
                    ram_capacity=1 << 24, net_rx_capacity=1000)
    defaults.update(kw)
    return defaults


def make_task(i, **kw):
    defaults = dict(cpu_request=100 * (1 + i % 5), ram_request=1 << 18)
    defaults.update(kw)
    return dict(uid=task_uid("njob", i), job_id=f"njob-{i % 3}", **defaults)


def assert_views_equal(va, vb):
    for f in ("ec_ids", "supply", "cpu_request", "ram_request",
              "max_wait_rounds", "is_gang", "running_by_machine",
              "task_type", "net_rx_request"):
        np.testing.assert_array_equal(getattr(va.ecs, f), getattr(vb.ecs, f),
                                      f)
    assert va.machines.uuids == vb.machines.uuids
    for f in ("cpu_used", "ram_used", "net_rx_used", "slots_free",
              "type_census", "cpu_capacity", "cpu_obs_used", "ram_obs_used"):
        np.testing.assert_array_equal(getattr(va.machines, f),
                                      getattr(vb.machines, f), f)
    assert len(va.member_uids) == len(vb.member_uids)
    for i in range(len(va.member_uids)):
        np.testing.assert_array_equal(va.member_uids[i], vb.member_uids[i])
        np.testing.assert_array_equal(va.member_cur[i], vb.member_cur[i])
        np.testing.assert_array_equal(va.member_wait[i], vb.member_wait[i])


def test_native_is_active_by_default():
    st = ClusterState()
    assert st._native is not None and st.native_loaded
    assert not ClusterState(use_native=False).native_loaded


def test_use_native_matches_the_reference_signature():
    """``use_native`` is the reference's plain boolean, default on; no
    environment variable turns it."""
    import inspect

    from poseidon_tpu.graph.state import ClusterState as JState

    ours = inspect.signature(ClusterState).parameters["use_native"]
    ref = inspect.signature(JState).parameters["use_native"]
    assert ours.default is ref.default is True
    assert ours.annotation == ref.annotation


@pytest.mark.parametrize("use_native", [True, False])
def test_restored_wait_counters_reach_the_view(tmp_path, use_native):
    """Pods that waited rounds before a checkpoint: after the restore the
    round view (native or Python) carries their restored counts, equal
    to the view of the state that was saved, and the next unscheduled
    round counts on from there in both."""
    from poseidon_tpu_torch.graph.snapshot import load_state, save_state

    st = ClusterState(use_native=False)
    for i in range(3):
        st.node_added(MachineInfo(**make_machine(i)))
    uuids = sorted(st.machines)
    for i in range(12):
        st.task_submitted(TaskInfo(**make_task(i)))
    uids = sorted(st.tasks)
    # Uneven waits: task j misses (j % 4) rounds; the first three run.
    for r in range(3):
        st.apply_placements([(u, None) for j, u in enumerate(uids)
                             if j % 4 > r])
    st.apply_placements([(u, uuids[j]) for j, u in enumerate(uids[:3])])
    assert max(t.wait_rounds for t in st.tasks.values()) == 3
    save_state(st, tmp_path / "s.json")
    restored = load_state(tmp_path / "s.json", use_native=use_native)
    assert restored.native_loaded == use_native
    for include_running in (False, True):
        assert_views_equal(restored.build_round_view(include_running),
                           st.build_round_view(include_running))
    for s in (st, restored):
        s.apply_placements([(u, None) for u in uids[3:]])
    assert_views_equal(restored.build_round_view(False),
                       st.build_round_view(False))
    assert restored.build_round_view(False).ecs.max_wait_rounds.max() == 4


def test_core_builds_outside_the_package():
    so = bindings.library_path()
    assert so.exists()
    assert so.parent.name == "poseidon_tpu_torch"
    assert so.parent.parent.name == "build"
    assert not list(bindings._SRC.parent.glob("*.so"))


def test_failed_build_falls_back_with_a_warning(monkeypatch, caplog):
    """A core that cannot be built leaves the Python view in place and
    says so in the log."""
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_lib_error", "g++: not found")
    with caplog.at_level("WARNING", logger="poseidon_tpu_torch.state"):
        st = ClusterState()
    assert not st.native_loaded
    assert "g++: not found" in caplog.text


def _mutations(seed, steps=400):
    """A seeded random mutation sequence: (method, kwargs) pairs, with
    the view checkpoints marked by None."""
    rng = np.random.default_rng(seed)
    live_machines, live_tasks, out = [], [], []
    for step in range(steps):
        op = rng.random()
        if op < 0.15 or not live_machines:
            i = len(live_machines) + 1000 * seed
            out.append(("node_added", make_machine(i)))
            live_machines.append(generate_uuid(f"nm{i}"))
        elif op < 0.55:
            t = make_task(int(rng.integers(0, 10_000)),
                          task_type=int(rng.integers(0, 4)))
            out.append(("task_submitted", t))
            if t["uid"] not in live_tasks:
                live_tasks.append(t["uid"])
        elif op < 0.7 and live_tasks:
            uid = live_tasks[int(rng.integers(0, len(live_tasks)))]
            target = (live_machines[int(rng.integers(0, len(live_machines)))]
                      if rng.random() < 0.8 else None)
            out.append(("apply_placements", [(uid, target)]))
        elif op < 0.75 and live_tasks:
            uid = live_tasks.pop(int(rng.integers(0, len(live_tasks))))
            out.append(("task_removed", uid))
        elif op < 0.8 and live_tasks:
            t = make_task(0, task_type=int(rng.integers(0, 4)),
                          cpu_request=int(rng.integers(50, 900)))
            t["uid"] = live_tasks[int(rng.integers(0, len(live_tasks)))]
            out.append(("task_updated", t))
        elif op < 0.88 and live_tasks:
            uid = live_tasks[int(rng.integers(0, len(live_tasks)))]
            out.append((("task_completed", "task_failed")[step % 2], uid))
        elif live_machines and rng.random() < 0.4:
            uuid = live_machines[int(rng.integers(0, len(live_machines)))]
            out.append(("node_failed", uuid))
        elif live_machines and rng.random() < 0.5:
            uuid = live_machines[int(rng.integers(0, len(live_machines)))]
            out.append(("node_updated", make_machine(
                0, uuid=uuid, cpu_capacity=int(rng.integers(4000, 16000)))))
        elif live_machines:
            out.append(("node_removed", live_machines.pop(
                int(rng.integers(0, len(live_machines))))))
        if step % 40 == 0 or step == steps - 1:
            out.append(None)
    return out


def _apply(state, Machine, Task, step):
    method, arg = step
    if method in ("node_added", "node_updated"):
        arg = Machine(**arg)
    elif method in ("task_submitted", "task_updated"):
        arg = Task(**arg)
    getattr(state, method)(arg)


@pytest.mark.parametrize("seed", [5, 6])
def test_differential_fuzz(seed):
    """The native view equals the port's Python view after every stretch
    of a random mutation sequence, with and without running tasks."""
    st_n = ClusterState(use_native=True)
    st_p = ClusterState(use_native=False)
    views = 0
    for step in _mutations(seed):
        if step is None:
            for include_running in (False, True):
                assert_views_equal(st_n.build_round_view(include_running),
                                   st_p.build_round_view(include_running))
                views += 1
            continue
        for st in (st_n, st_p):
            _apply(st, MachineInfo, TaskInfo, step)
    assert views >= 20


@pytest.mark.parametrize("seed", [7])
def test_native_view_matches_the_reference(seed):
    """The port's native view equals the JAX package's (native) view on
    the same mutations."""
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask

    st_j = JState()
    st_t = ClusterState()
    assert st_t.native_loaded
    for step in _mutations(seed):
        if step is None:
            for include_running in (False, True):
                assert_views_equal(st_j.build_round_view(include_running),
                                   st_t.build_round_view(include_running))
            continue
        _apply(st_j, JMachine, JTask, step)
        _apply(st_t, MachineInfo, TaskInfo, step)


def test_planner_native_matches_python():
    """Same workload through two planners (native and Python state): the
    same deltas and placements."""
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner

    results = []
    for use_native in (True, False):
        st = ClusterState(use_native=use_native)
        for i in range(6):
            st.node_added(MachineInfo(**make_machine(i)))
        for i in range(30):
            st.task_submitted(TaskInfo(**make_task(i)))
        planner = RoundPlanner(st, get_cost_model("cpu_mem"), device="cpu")
        deltas, m = planner.schedule_round()
        placements = sorted((uid, t.scheduled_to)
                            for uid, t in st.tasks.items())
        results.append((m.objective, m.placed, placements,
                        [(d.task_id, d.resource_id, int(d.type))
                         for d in deltas]))
    assert results[0] == results[1]

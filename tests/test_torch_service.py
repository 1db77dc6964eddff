"""The port's service against the JAX package's, over the same RPC script.

Both servers run in this process on loopback ports (the port's on the
CPU, through its plain torch solve); the same seeded RPC script — a
fresh wave, churn, a node removal and a gang job — goes to both, and every
round's SchedulingDeltas must be byte-identical and its RoundMetrics
counts equal.  Two runs: both packages at their defaults (every planner
tier on — pruned planes, the certificate cache, delta-maintained costs,
band pipelining, overlapped assignment — with the gates shrunk so the
tiers fire at test size), and both with those tiers off; the convergence
telemetry is at its default (on) in both, and its RoundMetrics counts must
agree too.  Also: a coarse-start fresh wave at planner level, with the
coarse start on and off, ``load_reference_checkpoint``, and both servers
starting fresh on an unreadable checkpoint.
"""

import grpc
import numpy as np
import pytest

from poseidon_tpu.protos import firmament_pb2 as jfpb
from poseidon_tpu.protos.services import FIRMAMENT_METHODS as J_METHODS
from poseidon_tpu.protos.services import FIRMAMENT_SERVICE as J_SERVICE
from poseidon_tpu.protos.services import make_stubs as j_make_stubs
from poseidon_tpu.service import FirmamentTPUServer as JServer
from poseidon_tpu.utils.config import FirmamentTPUConfig as JConfig
from poseidon_tpu.utils.ids import generate_uuid, hash_combine
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos.services import (
    FIRMAMENT_METHODS,
    FIRMAMENT_SERVICE,
    make_stubs,
)
from poseidon_tpu_torch.service.server import FirmamentTPUServer
from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

SLICE_HATCHES = {
    "POSEIDON_PRUNED": "0",
    "POSEIDON_COST_DELTA": "0",
    "POSEIDON_CERT_CACHE": "0",
    "POSEIDON_PIPELINE_BANDS": "0",
}
TELEM_COUNTS = ("telem_samples", "telem_gu_firings", "telem_iters_to_90",
                "telem_decay_half_life")
COUNTS = ("placed", "unscheduled", "preempted", "migrated", "objective",
          "iterations", "bf_sweeps", "num_ecs", "num_tasks",
          "gap_bound") + TELEM_COUNTS
# The tiers-on run: every hatch at its default, the gates shrunk so the
# wave prunes and churn rounds take the delta path at test size.
TIER_GATES = {
    "POSEIDON_PRUNE_MIN_ROWS": "2",
    "POSEIDON_PRUNE_MIN_COLS": "32",
    "POSEIDON_PRUNE_WAVE_MIN_ROWS": "2",
    "POSEIDON_PRUNE_WAVE_MIN_COLS": "32",
    "POSEIDON_COST_DELTA_MIN_CELLS": "1",
    "POSEIDON_COST_DELTA_MIN_ROWS": "1",
}
TIER_COUNTS = COUNTS + (
    "device_calls", "repair_firings", "solve_tier", "ladder_entry_phase",
    "pruned_bands", "pruned_width", "pruned_price_out_rounds",
    "pruned_escalations", "pruned_cert_accepts", "cost_delta_hits",
    "cost_rows_rebuilt", "cost_cols_rebuilt",
)


@pytest.fixture()
def slice_hatches(monkeypatch):
    for k, v in SLICE_HATCHES.items():
        monkeypatch.setenv(k, v)


def test_port_protos_share_the_reference_messages():
    # Byte-identical descriptors register once: same message classes.
    assert fpb.SchedulingDeltas is jfpb.SchedulingDeltas
    assert set(FIRMAMENT_METHODS) == set(J_METHODS)
    assert FIRMAMENT_SERVICE == J_SERVICE


def make_node(uuid, cpu, ram, labels=None, slots=16):
    rtnd = fpb.ResourceTopologyNodeDescriptor()
    rd = rtnd.resource_desc
    rd.uuid = uuid
    rd.friendly_name = f"node-{uuid[:8]}"
    rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
    rd.resource_capacity.cpu_cores = cpu
    rd.resource_capacity.ram_cap = ram
    rd.task_capacity = slots
    for k, v in (labels or {}).items():
        rd.labels.add(key=k, value=v)
    pu = rtnd.children.add()
    pu.resource_desc.uuid = uuid + "-pu0"
    pu.resource_desc.type = fpb.ResourceDescriptor.RESOURCE_PU
    pu.parent_id = uuid
    return rtnd


def make_task(uid, job, cpu, ram, selectors=(), labels=None):
    req = fpb.TaskDescription()
    td = req.task_descriptor
    td.uid = uid
    td.name = f"task-{uid}"
    td.job_id = job
    td.resource_request.cpu_cores = cpu
    td.resource_request.ram_cap = ram
    for stype, key, values in selectors:
        td.label_selectors.add(type=stype, key=key, values=list(values))
    for k, v in (labels or {}).items():
        td.labels.add(key=k, value=v)
    req.job_descriptor.uuid = job
    req.job_descriptor.name = job
    return req


def rpc_script(seed=0, machines=48, shapes=12, tasks=360, slots=16):
    """A seeded list of (method, request) steps; None marks a Schedule."""
    rng = np.random.default_rng(seed)
    steps = []
    hw = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]
    nodes = []
    for i in range(machines):
        cpu, ram = hw[i % 3]
        uuid = generate_uuid(f"svc-m{i}")
        nodes.append(uuid)
        labels = {"zone": "a" if i % 2 else "b"}
        steps.append(("NodeAdded", make_node(uuid, cpu, ram, labels,
                                             slots=slots)))
    ec_cpu = rng.integers(500, 6000, size=shapes)
    ec_ram = rng.integers(1 << 20, 1 << 24, size=shapes)
    live = []
    for i in range(tasks):
        e = int(rng.integers(0, shapes))
        sel = ((0, "zone", ("a",)),) if e == 0 else ()
        uid = hash_combine(seed + 1, i)
        live.append((uid, f"job-{e}", int(ec_cpu[e]), int(ec_ram[e]), sel))
        steps.append(("TaskSubmitted", make_task(*live[-1])))
    steps.append(None)  # fresh wave
    for r in range(2):  # churn: remove and resubmit 5% of the tasks
        pick = rng.choice(len(live), size=len(live) // 20, replace=False)
        for k in pick:
            uid = live[k][0]
            steps.append(("TaskRemoved", fpb.TaskUID(task_uid=uid)))
            steps.append(("TaskSubmitted", make_task(*live[k])))
        steps.append(None)
    steps.append(("NodeRemoved", fpb.ResourceUID(resource_uid=nodes[3])))
    steps.append(None)
    for i in range(24):  # one gang job
        steps.append(("TaskSubmitted", make_task(
            hash_combine(seed + 99, i), "gang-job", 9000, 1 << 24,
            labels={"gangScheduling": "true"})))
    steps.append(None)
    return steps


def drive(stubs, servicer, steps):
    rounds = []
    for step in steps:
        if step is None:
            out = stubs.Schedule(fpb.ScheduleRequest())
            rounds.append((out.SerializeToString(),
                           servicer.planner.last_metrics))
        else:
            method, req = step
            getattr(stubs, method)(req)
    return rounds


def assert_same_round(j, t, counts=COUNTS):
    (j_bytes, jm), (t_bytes, tm) = j, t
    assert j_bytes == t_bytes
    for name in counts:
        assert getattr(jm, name) == getattr(tm, name), name


def drive_both(steps, check=None):
    """Both servers over ``steps``; ``check(js, ts)`` runs on the two
    servers before they close."""
    with JServer(JConfig(), address="127.0.0.1:0") as js, \
            FirmamentTPUServer(FirmamentTPUConfig(device="cpu"),
                               address="127.0.0.1:0") as ts:
        with grpc.insecure_channel(js.address) as jc, \
                grpc.insecure_channel(ts.address) as tc:
            j_rounds = drive(j_make_stubs(jc, J_SERVICE, J_METHODS),
                             js.servicer, steps)
            t_rounds = drive(make_stubs(tc, FIRMAMENT_SERVICE,
                                        FIRMAMENT_METHODS),
                             ts.servicer, steps)
        if check is not None:
            check(js, ts)
    return j_rounds, t_rounds


def test_service_deltas_byte_identical(slice_hatches):
    j_rounds, t_rounds = drive_both(rpc_script())
    assert len(j_rounds) == len(t_rounds) == 5
    for j, t in zip(j_rounds, t_rounds):
        assert_same_round(j, t)
    # The script exercises what it claims to.
    wave, gang = t_rounds[0][1], t_rounds[-1][1]
    assert wave.placed > 0 and wave.gap_bound == 0.0
    assert gang.num_tasks >= 24
    assert all(m.pruned_bands == m.cost_delta_hits == 0
               for _, m in t_rounds)


def test_service_deltas_byte_identical_tiers_on(monkeypatch):
    """Both packages at their default planner tiers, over a wider cluster
    (256 machines, so a shortlist fits under half the width): the wave
    solves on a pruned plane, churn rounds build from delta-maintained
    planes, and every round's deltas and tier counts agree."""
    for k, v in TIER_GATES.items():
        monkeypatch.setenv(k, v)
    j_rounds, t_rounds = drive_both(rpc_script(machines=256, tasks=300))
    assert len(j_rounds) == len(t_rounds) == 5
    for j, t in zip(j_rounds, t_rounds):
        assert_same_round(j, t, TIER_COUNTS)
    metrics = [m for _, m in t_rounds]
    wave, churn = metrics[0], metrics[1:3]
    assert wave.placed > 0 and wave.gap_bound == 0.0
    assert wave.pruned_bands >= 1 and wave.solve_tier == "pruned"
    assert sum(m.cost_delta_hits for m in churn) >= 1
    assert all(m.gap_bound == 0.0 for m in metrics)


def _count_fused(monkeypatch):
    """Count the fused coarse programs that returned a solution, in each
    package's planner: ``{"jax": n, "port": n}``."""
    import poseidon_tpu.ops.transport_coarse as JC
    import poseidon_tpu_torch.graph.instance as TI

    counts = {"jax": 0, "port": 0}
    for key, mod in (("jax", JC), ("port", TI)):
        real = mod.solve_transport_coarse_fused

        def spy(*a, _real=real, _key=key, **k):
            sol = _real(*a, **k)
            counts[_key] += sol is not None
            return sol

        monkeypatch.setattr(mod, "solve_transport_coarse_fused", spy)
    return counts


def test_service_deltas_byte_identical_coarse_fused(monkeypatch):
    """Both packages at their default planner tiers with the one-program
    coarse start forced on (the card's default, ``POSEIDON_COARSE_FUSED=1``
    in both), over a cluster wide and contended enough for it (960
    one-slot machines): the program answers the fresh bands in both, and
    every round's deltas and tier counts, device calls included, agree.
    Each server runs its native graph core."""
    monkeypatch.setenv("POSEIDON_COARSE_FUSED", "1")
    counts = _count_fused(monkeypatch)

    def native(js, ts):
        assert js.servicer.state._native is not None
        assert ts.servicer.state.native_loaded

    j_rounds, t_rounds = drive_both(
        rpc_script(machines=960, tasks=1500, slots=1), check=native)
    assert len(j_rounds) == len(t_rounds) == 5
    for j, t in zip(j_rounds, t_rounds):
        assert_same_round(j, t, TIER_COUNTS)
    assert counts["jax"] == counts["port"] > 0, counts
    assert all(m.gap_bound == 0.0 for _, m in t_rounds)


def test_planner_coarse_wave_identical(slice_hatches):
    """A fresh wave big enough for the coarse [E, 256] warm start (the
    main path's shape of work), at planner level."""
    routes = _coarse_wave_routes()
    # The contended wave went through the coarse [E, 256] aggregate solve.
    assert any(m_pad == 256 for _, _, m_pad in routes), routes


def test_planner_coarse_wave_identical_coarse_off(slice_hatches,
                                                  monkeypatch):
    """The same wave with ``POSEIDON_COARSE=0`` in both packages: no
    coarse start, the full-width ladder from a cold start, and the same
    deltas and counts."""
    monkeypatch.setenv("POSEIDON_COARSE", "0")
    routes = _coarse_wave_routes()
    assert routes and not any(m_pad == 256 for _, _, m_pad in routes), routes


def test_planner_coarse_wave_identical_fused(slice_hatches, monkeypatch):
    """The same wave with the one-program coarse start forced on in both
    packages (the card's default): the program answers the wave, whose
    solves run at the coarse [E, 256] and full widths inside it."""
    monkeypatch.setenv("POSEIDON_COARSE_FUSED", "1")
    counts = _count_fused(monkeypatch)
    routes = _coarse_wave_routes()
    assert counts["jax"] == counts["port"] > 0, counts
    assert any(m_pad == 256 for _, _, m_pad in routes), routes


def _coarse_wave_routes():
    """Two rounds of the 1900-machine wave through both planners with
    identical deltas and counts; returns the port's solve routes."""
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
    from poseidon_tpu_torch.graph.state import TaskInfo
    from poseidon_tpu_torch.ops import transport as T

    def build(State, Machine, Task):
        st = State()
        hw = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]
        for i in range(1900):
            cpu, ram = hw[i % 3]
            st.node_added(Machine(uuid=generate_uuid(f"cw-m{i}"),
                                  cpu_capacity=cpu, ram_capacity=ram,
                                  task_slots=2))
        rng = np.random.default_rng(3)
        ec_cpu = rng.integers(100, 4000, size=10)
        ec_ram = rng.integers(1 << 18, 1 << 22, size=10)
        for i in range(4500):
            e = int(rng.integers(0, 10))
            st.task_submitted(Task(uid=hash_combine(7, i), job_id=f"cw-{e}",
                                   cpu_request=int(ec_cpu[e]),
                                   ram_request=int(ec_ram[e])))
        return st

    jp = JPlanner(build(JState, JMachine, JTask), j_cost_model("cpu_mem"))
    tp = RoundPlanner(build(ClusterState, MachineInfo, TaskInfo),
                      get_cost_model("cpu_mem"), device="cpu")
    routes0 = dict(T._Telemetry.routes)
    for _ in range(2):
        jd, jm = jp.schedule_round()
        td, tm = tp.schedule_round()
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in COUNTS + ("device_calls", "repair_firings"):
            assert getattr(jm, name) == getattr(tm, name), name
    return [k for k, n in T._Telemetry.routes.items()
            if n > routes0.get(k, 0)]


@pytest.mark.parametrize("host_cert", ["1", "0"])
def test_planner_merged_bands_identical(slice_hatches, monkeypatch,
                                        host_cert):
    """The planner under the card's defaults, forced on for both packages:
    merged size bands, the adaptive global-update cadence and four
    iterations per host read.  CPU and RAM are slack, so the merge gate
    opens and several bands go into one solve; the task slots are tight,
    so the churn rounds' solves run push/relabel iterations."""
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
    from poseidon_tpu_torch.graph.state import TaskInfo

    for k, v in (("POSEIDON_MERGE_BANDS", "1"), ("POSEIDON_ADAPTIVE_BF", "1"),
                 ("POSEIDON_ITER_UNROLL", "4"),
                 ("POSEIDON_HOST_CERT", host_cert)):
        monkeypatch.setenv(k, v)
    # Four size bands (requests a factor of ~3 apart) over 40 machines.
    shapes = [(4000, 1 << 22), (1300, 1 << 21), (400, 1 << 20), (120, 1 << 18)]
    rng = np.random.default_rng(13)
    pods = []
    for i in range(300):
        e = int(rng.integers(0, len(shapes)))
        pods.append((hash_combine(17, i), f"mb-{e}", *shapes[e]))

    def build(State, Machine, Task):
        st = State()
        for i in range(40):
            st.node_added(Machine(uuid=generate_uuid(f"mb-m{i}"),
                                  cpu_capacity=(32000, 64000)[i % 2],
                                  ram_capacity=1 << 28, task_slots=8))
        for uid, job, cpu, ram in pods:
            st.task_submitted(Task(uid=uid, job_id=job, cpu_request=cpu,
                                   ram_request=ram))
        return st

    js, ts = build(JState, JMachine, JTask), build(ClusterState, MachineInfo,
                                                   TaskInfo)
    jp = JPlanner(js, j_cost_model("cpu_mem"))
    tp = RoundPlanner(ts, get_cost_model("cpu_mem"), device="cpu")
    group_sizes = []
    gate = tp._next_band_group

    def spy(*args):
        n, idx = gate(*args)
        group_sizes.append(n)
        return n, idx

    tp._next_band_group = spy
    iterations = 0
    for r in range(3):
        if r:  # churn: remove and resubmit a tenth of the pods
            for state, Task in ((js, JTask), (ts, TaskInfo)):
                for uid, job, cpu, ram in pods[r::10]:
                    state.task_removed(uid)
                    state.task_submitted(Task(uid=uid, job_id=job,
                                              cpu_request=cpu,
                                              ram_request=ram))
        jd, jm = jp.schedule_round()
        td, tm = tp.schedule_round()
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in COUNTS + ("device_calls", "repair_firings"):
            assert getattr(jm, name) == getattr(tm, name), (r, name)
        assert tm.gap_bound == 0.0 and tm.placed > 0
        iterations += tm.iterations
    assert max(group_sizes) > 1, group_sizes  # bands merged
    assert iterations > 0


def test_load_reference_checkpoint(slice_hatches, tmp_path):
    """JAX runs two rounds and checkpoints; the port loads that
    checkpoint; round 3 (after churn) is identical in both."""
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu.graph.snapshot import load_checkpoint as j_load
    from poseidon_tpu.graph.snapshot import save_checkpoint as j_save
    from poseidon_tpu.graph.state import ClusterState as JState
    from poseidon_tpu.graph.state import MachineInfo as JMachine
    from poseidon_tpu.graph.state import TaskInfo as JTask
    from poseidon_tpu_torch.graph.snapshot import load_reference_checkpoint
    from poseidon_tpu_torch.graph.state import TaskInfo

    st = JState()
    for i in range(40):
        st.node_added(JMachine(uuid=generate_uuid(f"ck-m{i}"),
                               cpu_capacity=16000, ram_capacity=64 << 20,
                               task_slots=8))
    rng = np.random.default_rng(5)
    shapes = rng.integers(300, 3000, size=8)
    uids = []
    for i in range(240):
        e = int(rng.integers(0, 8))
        uids.append((hash_combine(11, i), f"ck-{e}", int(shapes[e])))
        st.task_submitted(JTask(uid=uids[-1][0], job_id=uids[-1][1],
                                cpu_request=uids[-1][2],
                                ram_request=1 << 20))
    jp = JPlanner(st, j_cost_model("cpu_mem"))
    jp.schedule_round()
    for uid, job, cpu in uids[:12]:  # churn between rounds 1 and 2
        st.task_removed(uid)
        st.task_submitted(JTask(uid=uid, job_id=job, cpu_request=cpu,
                                ram_request=1 << 20))
    jp.schedule_round()
    path = tmp_path / "ckpt.json"
    j_save(st, jp, path)
    assert (tmp_path / "ckpt.json.warm.npz").exists()

    j_state, j_planner = j_load(path, use_native=False)
    t_state, t_planner = load_reference_checkpoint(path, device="cpu")
    assert sorted(t_planner._warm_bands) == sorted(j_planner._warm_bands)
    for band, w in j_planner._warm_bands.items():
        np.testing.assert_array_equal(w.prices,
                                      t_planner._warm_bands[band].prices)
    for state, Task in ((j_state, JTask), (t_state, TaskInfo)):
        for uid, job, cpu in uids[20:36]:
            state.task_removed(uid)
            state.task_submitted(Task(uid=uid, job_id=job, cpu_request=cpu,
                                      ram_request=1 << 20))
    jd, jm = j_planner.schedule_round()
    td, tm = t_planner.schedule_round()
    assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
        [(d.task_id, d.resource_id, int(d.type)) for d in td]
    for name in COUNTS:
        assert getattr(jm, name) == getattr(tm, name), name
    assert tm.placed > 0


def test_servers_start_fresh_on_an_unreadable_checkpoint(tmp_path):
    """A checkpoint file that does not parse: both servicers log it and
    start with an empty cluster instead of failing to start."""
    from poseidon_tpu.service.server import FirmamentServicer as JServicer
    from poseidon_tpu_torch.service.server import FirmamentServicer

    path = tmp_path / "ckpt.json"
    path.write_text("{not json")
    js = JServicer(config=JConfig(checkpoint_path=str(path)))
    ts = FirmamentServicer(FirmamentTPUConfig(device="cpu",
                                              checkpoint_path=str(path)))
    assert len(js.state.tasks) == len(ts.state.tasks) == 0
    assert len(js.state.machines) == len(ts.state.machines) == 0
    assert ts.planner.state is ts.state

"""The port's ``ssp`` oracle (``solver/oracle.py``) against the JAX
package's.

The oracle's three entry points give the reference's answers on seeded
instances; ``flow_solver="ssp"`` planner rounds give the reference's
ssp rounds byte for byte; the oracle's objective equals the device
ladder's certified objective; the config and the service accept "ssp";
and the package imports without networkx, the oracle's call then raising
an ``ImportError`` that names it.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.solver import oracle

ROOT = Path(__file__).resolve().parents[1]


def _instance(seed, E=7, M=23, arc=True):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 500, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.15] = T.INF_COST
    supply = rng.integers(0, 12, size=E).astype(np.int32)
    capacity = rng.integers(0, 5, size=M).astype(np.int32)
    unsched = rng.integers(300, 900, size=E).astype(np.int32)
    arc_cap = rng.integers(0, 4, size=(E, M)).astype(np.int32) if arc else None
    return costs, supply, capacity, unsched, arc_cap


@pytest.mark.parametrize("seed,arc", [(0, True), (1, False), (2, True)])
def test_oracle_matches_reference(seed, arc):
    from poseidon_tpu.solver import oracle as j_oracle

    inst = _instance(seed, arc=arc)
    kw = dict(arc_capacity=inst[4])
    assert oracle.transport_objective(*inst[:4], **kw) == \
        j_oracle.transport_objective(*inst[:4], **kw)
    got = oracle.transport_solve(*inst[:4], **kw)
    ref = j_oracle.transport_solve(*inst[:4], **kw)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[1].dtype == got[2].dtype == np.int32
    arcs = [(0, 1, 4, 3), (0, 2, 2, 1), (2, 1, 5, 1), (1, 3, 6, 2),
            (2, 3, 1, 7)]
    sup = {0: 5, 3: -5}
    assert oracle.mcmf_objective(4, arcs, sup) == \
        j_oracle.mcmf_objective(4, arcs, sup)


@pytest.mark.parametrize("seed", range(3))
def test_oracle_objective_equals_the_certified_ladder(seed):
    inst = _instance(seed, E=9, M=40)
    sol = T.solve_transport(*inst[:4], arc_capacity=inst[4], device="cpu")
    assert sol.gap_bound == 0.0
    assert oracle.transport_objective(*inst[:4],
                                      arc_capacity=inst[4]) == sol.objective


def _cluster(mod):
    from poseidon_tpu_torch.utils.ids import generate_uuid, hash_combine

    rng = np.random.default_rng(4)
    st = mod.ClusterState()
    for i in range(24):
        st.node_added(mod.MachineInfo(
            uuid=generate_uuid(f"ssp-m{i}"), cpu_capacity=16000,
            ram_capacity=64 << 20, task_slots=int(rng.integers(2, 9))))
    for i in range(150):
        e = int(rng.integers(0, 6))
        st.task_submitted(mod.TaskInfo(
            uid=hash_combine(11, i), job_id=f"ssp-{e}",
            cpu_request=500 + 700 * e, ram_request=(1 << 20) * (1 + e)))
    return st


def test_ssp_rounds_match_reference():
    from poseidon_tpu.costmodel import get_cost_model as j_cost_model
    from poseidon_tpu.graph import state as j_state
    from poseidon_tpu.graph.instance import RoundPlanner as JPlanner
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph import state as t_state
    from poseidon_tpu_torch.graph.instance import RoundPlanner

    jp = JPlanner(_cluster(j_state), j_cost_model("cpu_mem"),
                  flow_solver="ssp")
    tp = RoundPlanner(_cluster(t_state), get_cost_model("cpu_mem"),
                      flow_solver="ssp", device="cpu")
    assert tp.precompile() == jp.precompile() == 0
    calls0 = T.device_call_count()
    for _ in range(2):
        jd, jm = jp.schedule_round()
        td, tm = tp.schedule_round()
        assert [(d.task_id, d.resource_id, int(d.type)) for d in jd] == \
            [(d.task_id, d.resource_id, int(d.type)) for d in td]
        for name in ("placed", "unscheduled", "objective", "iterations",
                     "gap_bound", "device_calls"):
            assert getattr(jm, name) == getattr(tm, name), name
    assert T.device_call_count() == calls0  # no device involvement
    with pytest.raises(ValueError, match="flow_solver"):
        RoundPlanner(t_state.ClusterState(), get_cost_model("cpu_mem"),
                     flow_solver="cs2", device="cpu")


def test_service_takes_the_ssp_solver():
    from poseidon_tpu_torch.service.server import FirmamentServicer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

    svc = FirmamentServicer(FirmamentTPUConfig(device="cpu",
                                               flow_solver="ssp"))
    assert svc.planner.flow_solver == "ssp"


PROBE = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("networkx", "jax", "poseidon_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from poseidon_tpu_torch.solver import oracle
try:
    oracle.transport_objective(np.ones((1, 1), np.int32),
                               np.ones(1, np.int32), np.ones(1, np.int32),
                               np.ones(1, np.int32))
except ImportError as e:
    assert "networkx" in str(e), e
    print("OK")
"""


def test_package_imports_without_networkx():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"

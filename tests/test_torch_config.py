"""The port's service configuration against the JAX package's.

The deploy profile loads to the same values in both packages, and a value
the port cannot honour yet (another solver, more than one device, a
profiler or metrics endpoint) raises instead of being dropped.
"""

from pathlib import Path

import pytest

from poseidon_tpu.utils.config import FirmamentTPUConfig as JConfig
from poseidon_tpu.utils.config import load_config as j_load_config
from poseidon_tpu_torch.utils.config import FirmamentTPUConfig, load_config

PROFILE = (Path(__file__).resolve().parents[1] / "deploy" / "configs"
           / "firmament_tpu_cpu_mem.yaml")
SHARED = ("listen_address", "metrics_address", "cost_model", "flow_solver",
          "precompile", "max_machines", "max_ecs", "max_tasks_per_pu",
          "gang_scheduling", "pod_affinity", "solver_devices", "profile_dir",
          "checkpoint_path", "checkpoint_every_rounds")


def test_defaults_match_reference():
    j, t = JConfig(), FirmamentTPUConfig()
    for name in SHARED:
        assert getattr(j, name) == getattr(t, name), name


def test_deploy_profile_loads_like_reference():
    argv = ["--config-file", str(PROFILE)]
    j = j_load_config(JConfig, argv=argv)
    t = load_config(FirmamentTPUConfig, argv=argv)
    for name in SHARED:
        assert getattr(j, name) == getattr(t, name), name
    assert t.max_machines == 16384 and t.max_ecs == 1024
    assert t.gang_scheduling is False


@pytest.mark.parametrize("line,key", [
    ("flow_solver: ssp", "flow_solver"),
    ("solver_devices: 8", "solver_devices"),
    ("profile_dir: /tmp/prof", "profile_dir"),
    ("metrics_address: 0.0.0.0:9100", "metrics_address"),
])
def test_unsupported_values_raise(tmp_path, line, key):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(PROFILE.read_text() + line + "\n")
    with pytest.raises(ValueError, match=key):
        load_config(FirmamentTPUConfig, argv=["--config-file", str(cfg)])


@pytest.mark.parametrize("flag", ["--flow-solver=ssp", "--solver-devices=2"])
def test_unsupported_flags_raise(flag):
    with pytest.raises(ValueError):
        load_config(FirmamentTPUConfig, argv=[flag])


def test_servicer_refuses_an_unsupported_config():
    from poseidon_tpu_torch.service.server import FirmamentServicer

    with pytest.raises(ValueError, match="solver_devices"):
        FirmamentServicer(FirmamentTPUConfig(device="cpu", solver_devices=4))

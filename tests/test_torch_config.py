"""The port's service configuration against the JAX package's.

The deploy profile loads to the same values in both packages, and a value
the port cannot honour (an unknown solver, a mesh of no device) raises
instead of being dropped; the values it has come to honour (the ``ssp``
solver, a profiler directory, more than one solver device) load as the
reference loads them, and a metrics endpoint is honoured.
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


# Values the port once refused and now honours, as the reference does.
HONOURED = ("flow_solver", "profile_dir", "solver_devices")


@pytest.mark.parametrize("line,key", [
    ("flow_solver: ssp", "flow_solver"),
    ("solver_devices: 8", "solver_devices"),
    ("profile_dir: /tmp/prof", "profile_dir"),
])
def test_unsupported_values_raise(tmp_path, line, key):
    """A value the port cannot honour raises; one it honours since the
    ssp oracle, the profiler bridge and the sharded solve loads as the
    reference's does."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(PROFILE.read_text() + line + "\n")
    argv = ["--config-file", str(cfg)]
    if key in HONOURED:
        t = load_config(FirmamentTPUConfig, argv=argv)
        value = getattr(t, key)
        assert value == getattr(j_load_config(JConfig, argv=argv), key)
        assert str(value) == line.split(": ")[1]
        return
    with pytest.raises(ValueError, match=key):
        load_config(FirmamentTPUConfig, argv=argv)


def test_metrics_address_is_honoured(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(PROFILE.read_text() + "metrics_address: 0.0.0.0:9100\n")
    t = load_config(FirmamentTPUConfig, argv=["--config-file", str(cfg)])
    assert t.metrics_address == "0.0.0.0:9100"


def test_glue_config_loads_like_reference(tmp_path):
    from poseidon_tpu.utils.config import PoseidonConfig as JPoseidonConfig
    from poseidon_tpu_torch.utils.config import PoseidonConfig

    cfg = tmp_path / "glue.yaml"
    cfg.write_text("firmamentAddress: 10.0.0.1:9090\nschedulingInterval: 2.5\n"
                   "rpc_retries: 5\n")
    argv = ["--config-file", str(cfg), "--metrics-address=127.0.0.1:0",
            "--kube-version=1.9"]
    j = j_load_config(JPoseidonConfig, argv=argv)
    t = load_config(PoseidonConfig, argv=argv)
    assert j.__dict__ == t.__dict__
    assert load_config(argv=[]).__dict__ == JPoseidonConfig().__dict__
    assert t.kube_version_tuple() == (1, 9)


@pytest.mark.parametrize("flag", ["--flow-solver=ssp", "--solver-devices=2"])
def test_unsupported_flags_raise(flag):
    """Both flags are honoured now, and a value still unsupported raises
    in each one's place: an unknown solver, a mesh of no device."""
    if flag == "--flow-solver=ssp":
        assert load_config(FirmamentTPUConfig, argv=[flag]).flow_solver == \
            "ssp"
        flag = "--flow-solver=cs2"
    else:
        assert load_config(FirmamentTPUConfig,
                           argv=[flag]).solver_devices == 2
        flag = "--solver-devices=0"
    with pytest.raises(ValueError):
        load_config(FirmamentTPUConfig, argv=[flag])


def test_servicer_refuses_an_unsupported_config():
    from poseidon_tpu_torch.service.server import FirmamentServicer

    with pytest.raises(ValueError, match="flow_solver"):
        FirmamentServicer(FirmamentTPUConfig(device="cpu", flow_solver="cs2"))

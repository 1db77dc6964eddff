"""The port's profiler bridge (``obs/profile.py``), its process helpers
(``utils/envutil.py``) and the reference names its module copies had
left out, against the JAX package's.

- The device-memory gauges read nothing while CUDA is uninitialised (or
  torch is not loaded), and export the reference's gauge names when it
  is; a ``POSEIDON_JAX_PROFILE`` window and the service's ``profile_dir``
  capture write a torch.profiler trace on the CPU, and the round span
  carries its path.
- envutil: the clean-CPU environment, the device probe, the build
  directory, the host-wide device lock (held, busy, released), SIGTERM
  handling and the CUDA-initialised check.
- ``host_cert_count``, ``ClusterState.ingest_age_s``,
  ``observe_scenario``, ``markdown_table``, ``checked_narrow_i32``,
  ``i32_headroom`` and ``protos/gen.py`` behave as the reference's; the
  hatches both registries declare have the same kind and default.
"""

import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import profile as obs_profile
from poseidon_tpu_torch.utils import envutil

ROOT = Path(__file__).resolve().parents[1]
GAUGES = ("poseidon_device_bytes_in_use",
          "poseidon_device_peak_bytes_in_use", "poseidon_device_bytes_limit")


# ---------------------------------------------------------------- gauges

def test_gauges_read_nothing_while_cuda_is_uninitialised():
    import torch

    assert not torch.cuda.is_initialized()
    reg = obs_metrics.Registry()
    assert obs_profile.observe_device_memory(reg) == 0
    assert "poseidon_device" not in reg.expose()
    assert "poseidon_live_buffers" not in reg.expose()
    assert not torch.cuda.is_initialized()


GLUE_PROBE = r"""
import sys
from poseidon_tpu_torch.obs import metrics, profile
assert profile.observe_device_memory(metrics.Registry()) == 0
assert "torch" not in sys.modules, "reading the gauges imported torch"
print("OK")
"""


def test_gauges_never_import_torch():
    out = subprocess.run([sys.executable, "-c", GLUE_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_gauges_export_the_reference_names(monkeypatch):
    """With CUDA initialised (a stand-in torch here), one labelled series
    per device under the reference's names, and the live-block count."""
    from poseidon_tpu.obs import profile as j_profile

    ref_src = Path(j_profile.__file__).read_text()
    for name in GAUGES + ("poseidon_live_buffers",):
        assert f'"{name}"' in ref_src, name

    cuda = types.SimpleNamespace(
        is_initialized=lambda: True, device_count=lambda: 2,
        memory_allocated=lambda i: 100 + i,
        max_memory_allocated=lambda i: 200 + i,
        mem_get_info=lambda i: (5, 80_000 + i),
        memory_stats=lambda i: {"active.all.current": 3 + i},
    )
    monkeypatch.setitem(sys.modules, "torch",
                        types.SimpleNamespace(cuda=cuda))
    reg = obs_metrics.Registry()
    assert obs_profile.observe_device_memory(reg) == 2
    text = reg.expose()
    for name, v0, v1 in zip(GAUGES, (100, 200, 80_000), (101, 201, 80_001)):
        assert f'{name}{{device="cuda:0"}} {v0}' in text, text
        assert f'{name}{{device="cuda:1"}} {v1}' in text, text
    assert "poseidon_live_buffers 7" in text


# ------------------------------------------------------------- profiling

def _small_state():
    from poseidon_tpu_torch.graph import state as t_state
    from poseidon_tpu_torch.utils.ids import generate_uuid, hash_combine

    st = t_state.ClusterState()
    for i in range(6):
        st.node_added(t_state.MachineInfo(
            uuid=generate_uuid(f"pf{i}"), cpu_capacity=8000,
            ram_capacity=1 << 24, task_slots=4))
    for i in range(15):
        st.task_submitted(t_state.TaskInfo(
            uid=hash_combine(3, i), job_id="pf", cpu_request=500,
            ram_request=1 << 18))
    return st


def test_profile_window_writes_a_trace(tmp_path, monkeypatch):
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.obs import trace as _trace

    obs_profile._reset_for_tests()
    monkeypatch.setenv("POSEIDON_JAX_PROFILE", str(tmp_path))
    monkeypatch.setenv("POSEIDON_TRACE", "1")
    planner = RoundPlanner(_small_state(), get_cost_model("cpu_mem"),
                           device="cpu")
    _trace.reset()
    _, m = planner.schedule_round()
    assert m.placed > 0
    path = tmp_path / "round_000000"
    assert (path / obs_profile.TRACE_FILE).stat().st_size > 0
    rounds = [s for s in _trace.spans() if s["name"] == "round"]
    assert rounds[-1]["attrs"]["profile_path"] == str(path)
    _trace.reset()


def test_profile_window_is_off_by_default(monkeypatch):
    monkeypatch.delenv("POSEIDON_JAX_PROFILE", raising=False)
    with obs_profile.solve_profile(0) as p:
        assert p is None


def test_service_profile_dir_captures_each_round(tmp_path):
    from poseidon_tpu_torch.service.server import FirmamentServicer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

    obs_profile._reset_for_tests()
    svc = FirmamentServicer(FirmamentTPUConfig(device="cpu",
                                               profile_dir=str(tmp_path)))
    svc.state = svc.planner.state = _small_state()
    svc.Schedule(None, None)
    svc.Schedule(None, None)
    for n in (0, 1):
        trace = tmp_path / f"round_{n:06d}" / obs_profile.TRACE_FILE
        assert trace.stat().st_size > 0


# --------------------------------------------------------------- envutil

def test_clean_cpu_env_hides_the_card(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/a" + os.pathsep + "/b")
    env = envutil.clean_cpu_env("/repo")
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PYTHONPATH"].split(os.pathsep) == ["/a", "/b", "/repo"]
    assert "CUDA_VISIBLE_DEVICES" not in os.environ or \
        os.environ["CUDA_VISIBLE_DEVICES"] != env["CUDA_VISIBLE_DEVICES"]


def test_probe_device_count_is_zero_without_a_card():
    import torch

    assert envutil.probe_device_count() == torch.cuda.device_count() == 0
    assert not torch.cuda.is_initialized()


def test_compile_cache_dir_names_the_build_directory(tmp_path, monkeypatch):
    from poseidon_tpu_torch.native import bindings
    from poseidon_tpu_torch.ops import _kernels

    # Set empty (= unset) through monkeypatch, so the value the helper
    # exports is undone after the test.
    monkeypatch.setenv("POSEIDON_COMPILE_CACHE_DIR", "")
    default = ROOT / "build" / "poseidon_tpu_torch"
    assert _kernels.build_dir() == bindings.build_dir() == default
    assert envutil.enable_compilation_cache() is None
    assert envutil.enable_compilation_cache(str(tmp_path / "k")) == \
        str(tmp_path / "k")
    assert os.environ["POSEIDON_COMPILE_CACHE_DIR"] == str(tmp_path / "k")
    assert _kernels.build_dir() == bindings.build_dir() == tmp_path / "k"
    # The operator's setting wins over the caller's path.
    assert envutil.enable_compilation_cache(str(tmp_path / "other")) == \
        str(tmp_path / "k")


LOCK_PROBE = r"""
import sys
from poseidon_tpu_torch.utils import envutil
print("BUSY" if not envutil.serialize_device_access(timeout=0) else "HELD")
"""


def test_device_lock_serializes_processes(tmp_path, monkeypatch):
    from poseidon_tpu.utils import envutil as j_envutil

    lock = tmp_path / "dev.lock"
    monkeypatch.setenv("POSEIDON_DEVICE_LOCK", str(lock))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert envutil.device_lock_path() == j_envutil.device_lock_path() == \
        str(lock)
    envutil.release_device_lock()
    try:
        assert envutil.serialize_device_access(timeout=0)
        assert envutil.serialize_device_access(timeout=0)  # reentrant
        assert "pid=" in lock.read_text()

        def probe(extra=None):
            env = dict(os.environ, **(extra or {}))
            out = subprocess.run([sys.executable, "-c", LOCK_PROBE],
                                 cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=120)
            assert out.returncode == 0, out.stderr
            return out.stdout.strip()

        assert probe() == "BUSY"
        # A process told to see no card never waits for the lock.
        assert probe({"CUDA_VISIBLE_DEVICES": ""}) == "HELD"
        envutil.release_device_lock()
        assert probe() == "HELD"
    finally:
        envutil.release_device_lock()
    monkeypatch.delenv("POSEIDON_DEVICE_LOCK")
    assert os.path.dirname(envutil.device_lock_path()) == \
        __import__("tempfile").gettempdir()


def test_graceful_term_and_backend_check():
    import torch

    old = signal.getsignal(signal.SIGTERM)
    try:
        envutil.install_graceful_term()
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as e:
            handler(signal.SIGTERM, None)
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, old)
    assert envutil.backend_initialized() is torch.cuda.is_initialized()
    assert envutil.backend_initialized() is False


# ------------------------------------------------- the names added back

def test_host_cert_count_reads_the_counter():
    from poseidon_tpu_torch.ops import transport as T

    assert T.host_cert_count() == T._Telemetry.host_cert_returns
    n0 = T.host_cert_count()
    T._Telemetry.host_cert_returns += 2
    try:
        assert T.host_cert_count() == n0 + 2
    finally:
        T._Telemetry.host_cert_returns -= 2


def test_ingest_age_matches_reference():
    from poseidon_tpu.graph import state as j_state
    from poseidon_tpu_torch.graph import state as t_state

    for mod in (j_state, t_state):
        st = mod.ClusterState()
        assert st.ingest_age_s() is None
        st.node_added(mod.MachineInfo(uuid="ia-0", cpu_capacity=1000,
                                      ram_capacity=1 << 20))
        age = st.ingest_age_s()
        assert age is not None and 0.0 <= age < 60.0


def test_observe_scenario_matches_reference():
    from poseidon_tpu.obs import metrics as j_metrics

    kw = dict(robustness_score=0.5, placements_per_sec=12.5,
              regression_p90=0.25, placement_divergence=0.125,
              admission_staleness_p50_s=0.01,
              admission_staleness_p99_s=0.02, ok=False)
    jr, tr = j_metrics.Registry(), obs_metrics.Registry()
    j_metrics.observe_scenario("burst", registry=jr, **kw)
    obs_metrics.observe_scenario("burst", registry=tr, **kw)
    assert tr.expose() == jr.expose()


def test_markdown_table_and_shared_hatches_match_reference():
    from poseidon_tpu.utils import hatches as j_hatches
    from poseidon_tpu_torch.utils import hatches

    table = hatches.markdown_table()
    for h in hatches.HATCHES:
        assert f"| `{h.name}` |" in table
    ref = {h.name: h for h in j_hatches.HATCHES}
    shared = [h for h in hatches.HATCHES if h.name in ref]
    assert {"POSEIDON_JAX_PROFILE", "POSEIDON_CHAINED",
            "POSEIDON_DEVICE_LOCK_TIMEOUT"} <= {h.name for h in shared}
    for h in shared:
        assert h.kind == ref[h.name].kind, h.name
        if h.name not in ("POSEIDON_DEVICE_LOCK",
                          "POSEIDON_COMPILE_CACHE_DIR"):
            # The lock defaults under the process's temporary directory
            # and the build directory under the checkout, not in /tmp
            # and the home directory.
            assert h.default == ref[h.name].default, h.name


@pytest.mark.parametrize("arr,kw", [
    (np.array([0, 5, 1 << 40]), dict(site="t")),
    (np.array([-3.5, 2.0]), dict(site="t", lo=-10, hi=10)),
    (np.array([], dtype=np.int64), dict(site="t")),
])
def test_checked_narrow_and_headroom_match_reference(arr, kw):
    from poseidon_tpu.utils import numerics as j_num
    from poseidon_tpu_torch.utils import numerics as t_num

    got, ref = t_num.checked_narrow_i32(arr, **kw), \
        j_num.checked_narrow_i32(arr, **kw)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert t_num.i32_headroom(arr) == j_num.i32_headroom(arr)
    if arr.size and (arr.max() > kw.get("hi", t_num.I32_MAX)):
        with pytest.raises(t_num.SaturationError):
            t_num.checked_narrow_i32(arr, clamp=False, **kw)
    with pytest.raises(ValueError):
        t_num.checked_narrow_i32(arr, site="t", lo=1, hi=0)


def test_protos_gen_points_at_the_port_copy():
    from poseidon_tpu.protos import gen as j_gen
    from poseidon_tpu_torch.protos import gen

    cmd, ref = gen.protoc_command(), j_gen.protoc_command()
    here = ROOT / "poseidon_tpu_torch" / "protos"
    assert cmd[0] == ref[0] == "protoc"
    assert cmd[1:3] == [f"--proto_path={here}", f"--python_out={here}"]
    assert [Path(p).name for p in cmd[3:]] == \
        [Path(p).name for p in ref[3:]]
    for p in cmd[3:]:
        assert Path(p).exists()

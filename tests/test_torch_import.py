"""The port imports neither JAX nor the JAX package.

tests/conftest.py imports jax into this process, so the check runs in a
subprocess whose ``sys.meta_path`` refuses ``jax`` and ``poseidon_tpu``:
every module of ``poseidon_tpu_torch``, and ``chip_smoke``, must import.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "poseidon_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import poseidon_tpu_torch
names = ["poseidon_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(
        poseidon_tpu_torch.__path__, "poseidon_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
assert {"poseidon_tpu_torch.ops.transport_coarse",
        "poseidon_tpu_torch.native", "poseidon_tpu_torch.native.bindings",
        "poseidon_tpu_torch.utils.locks", "poseidon_tpu_torch.obs.trace",
        "poseidon_tpu_torch.obs.history", "poseidon_tpu_torch.obs.metrics",
        "poseidon_tpu_torch.service.client",
        "poseidon_tpu_torch.glue.fake_kube",
        "poseidon_tpu_torch.glue.keyed_queue", "poseidon_tpu_torch.glue.types",
        "poseidon_tpu_torch.glue.kube_convert",
        "poseidon_tpu_torch.glue.podwatcher",
        "poseidon_tpu_torch.glue.nodewatcher",
        "poseidon_tpu_torch.glue.stats_server",
        "poseidon_tpu_torch.glue.metrics_agent",
        "poseidon_tpu_torch.glue.poseidon", "poseidon_tpu_torch.glue.main",
        "poseidon_tpu_torch.glue.kube_client",
        "poseidon_tpu_torch.check", "poseidon_tpu_torch.check.ledger",
        "poseidon_tpu_torch.replay", "poseidon_tpu_torch.replay.trace",
        "poseidon_tpu_torch.replay.driver",
        "poseidon_tpu_torch.replay.flight",
        "poseidon_tpu_torch.chaos", "poseidon_tpu_torch.chaos.plan",
        "poseidon_tpu_torch.chaos.inject",
        "poseidon_tpu_torch.chaos.preempt",
        "poseidon_tpu_torch.chaos.recorder",
        "poseidon_tpu_torch.chaos.harness",
        "poseidon_tpu_torch.chaos.soak",
        "poseidon_tpu_torch.scenario", "poseidon_tpu_torch.scenario.plan",
        "poseidon_tpu_torch.scenario.generate",
        "poseidon_tpu_torch.scenario.score",
        "poseidon_tpu_torch.scenario.drive",
        } <= set(names), names
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "poseidon_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


GLUE_PROBE = r"""
import sys
import poseidon_tpu_torch.glue
import poseidon_tpu_torch.glue.main
import poseidon_tpu_torch.glue.metrics_agent
import poseidon_tpu_torch.glue.kube_client
from poseidon_tpu_torch.utils.config import PoseidonConfig, load_config

cfg = load_config(PoseidonConfig, argv=[
    "--firmament-address=127.0.0.1:19090", "--metrics-address=127.0.0.1:0",
    "--scheduling-interval=2.5"])
assert cfg.firmament_address == "127.0.0.1:19090", cfg
assert cfg.scheduling_interval == 2.5, cfg
bad = [m for m in sys.modules
       if m.split(".")[0] in ("torch", "jax", "jaxlib", "poseidon_tpu")]
assert not bad, bad
print("ok")
"""


def test_glue_process_imports_no_torch():
    """The glue process (the port's counterpart of the reference keeping
    jax out of its glue) never loads torch."""
    out = subprocess.run(
        [sys.executable, "-c", GLUE_PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_no_module_names_the_jax_package_in_an_import():
    for path in list((ROOT / "poseidon_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                words = stripped.replace(",", " ").split()
                assert "jax" not in words[1].split("."), (path, line)
                assert words[1].split(".")[0] != "poseidon_tpu", (path, line)


NUMPY_ONLY_PROBE = r"""
import sys
import poseidon_tpu_torch.chaos.plan
import poseidon_tpu_torch.scenario.plan
import poseidon_tpu_torch.scenario.generate
import poseidon_tpu_torch.replay.trace
from poseidon_tpu_torch.scenario import named_scenario, workload_events
from poseidon_tpu_torch.replay import synthesize_trace

plan = named_scenario("multi_tenant", machines=8, rounds=4, seed=0)
assert workload_events(plan) and synthesize_trace(4, 4, seed=0)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("torch", "jax", "jaxlib", "poseidon_tpu")]
assert not bad, bad
print("ok")
"""


def test_plan_and_trace_modules_import_no_torch():
    """The fault plans, the scenario plans and generators, and the trace
    generator are numpy-only, as in the reference: importing them (and
    their packages) loads no torch."""
    out = subprocess.run(
        [sys.executable, "-c", NUMPY_ONLY_PROBE], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"

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

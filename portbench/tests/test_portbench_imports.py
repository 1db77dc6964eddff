"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``poseidon_tpu``, compared whole (``poseidon_tpu_torch``
begins with ``poseidon_tpu`` and is the program under test), and the
client loads neither torch nor the port."""

import json
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import REPO

RUN = """
import json, sys
sys.path.insert(0, {repo!r})
from portbench import harness
res = harness.run_cell({cell!r}, 5, 1.0, {trace}, device="cpu",
                       root=__import__("pathlib").Path({root!r}))
print(json.dumps({{"correct": res["correct"],
                  "loaded": sorted({{m.split(".")[0]
                                     for m in sys.modules}})}}))
"""


def run(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(mini_root):
    for cell, trace in (("northstar-10k.burst", True),
                        ("northstar-10k.churn", False)):
        res = run(RUN.format(repo=str(REPO), cell=cell, trace=trace,
                             root=str(mini_root)))
        assert res["correct"]
        loaded = set(res["loaded"])
        assert "poseidon_tpu_torch" in loaded and "torch" in loaded
        assert not loaded & set(harness.FORBIDDEN), loaded


def test_client_loads_no_torch():
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['client.py', '--help']\n"
        "try:\n"
        f"    runpy.run_path({str(REPO / 'portbench/client/client.py')!r},"
        " run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "print(__import__('json').dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "grpc" in loaded
    assert not loaded & {"torch", "poseidon_tpu_torch", *harness.FORBIDDEN}


def test_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "poseidon_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "poseidon_tpu.ops", sys)
    assert harness.forbidden_modules() == ["poseidon_tpu"]

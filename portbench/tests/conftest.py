"""Fixtures of the benchmark's CPU tests: a small copy of the benchmark's
data files under a temporary root, which the harness runs from like a
checkout (the port itself is imported from the repository)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def make_root(root: Path, machines=120, pods=1200, shapes=12, rate=24.0,
              gap=0.4, grace=3.0) -> Path:
    """BENCHMARK.json and portbench's data and loops under ``root``, the
    cluster cut to ``machines`` machines, the loads to match, and the
    churn's scheduling interval to ``gap`` seconds."""
    (root / "portbench").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics", "loops"):
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d,
                        dirs_exist_ok=True)
    cfgs = root / "portbench" / "configs"
    ns = json.loads((cfgs / "northstar-10k.json").read_text())
    ns["machines"]["count"] = machines
    ns["pods"].update(count=pods, shapes=shapes)
    (cfgs / "northstar-10k.json").write_text(json.dumps(ns))
    tr = root / "portbench" / "traffic" / "churn.json"
    ch = json.loads(tr.read_text())
    ch.update(rate=rate, schedule_gap_s=gap, grace_s=grace, warm_s=1,
              tail_s=2)
    tr.write_text(json.dumps(ch))
    return root


@pytest.fixture
def mini_root(tmp_path):
    return make_root(tmp_path / "checkout")

"""Compare two checkouts' kernels on one card, in one call.

    python3 compare_trees.py OLD_TREE NEW_TREE [TURNS]

Runs each tree's ``chip_smoke.py`` kernel phase in turns, old, new, new,
old (``TURNS`` such rounds, default 1), each turn a process of its own
started in that tree: ``build_kernels()``, then ``kernel_phase()`` timed,
both from the tree's own ``chip_smoke.py``.  Each turn prints one JSON
line: the tree, the kernel phase's seconds, every global-update case's
device milliseconds and grid barriers, every greedy-rows case's
milliseconds, the empty launch's milliseconds (where the tree's checks
record them) and the card's ``nvidia-smi`` name and power limit.  A
turn's own log goes to ``build/compare_trees/turn_<n>.log`` under the
current directory.  Exits with the first failing turn's code.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_TURN = r"""
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke as cs

info = cs.device_info()
cs._timers(True)
cs.build_kernels()
t0 = time.perf_counter()
res = cs.kernel_phase()
secs = time.perf_counter() - t0
gu, greedy = res[2], res[4]
print("TURN " + json.dumps({
    "tree": sys.argv[1], "kernel_phase_s": secs,
    "gu_ms": {r["label"]: r["ms"] for r in gu},
    "gu_barriers": {r["label"]: r.get("barriers") for r in gu},
    "gu_split": {r["label"]: r["split"] for r in gu if "split" in r},
    "greedy_ms": {f"{r['label']} {r['shape']}": r["ms"] for r in greedy},
    "empty_launch_ms": greedy[0].get("floor_ms"),
    "smi": info["smi"]}), flush=True)
"""


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (str(Path(t).resolve()) for t in argv[:2])
    turns = int(argv[2]) if len(argv) == 3 else 1
    logs = Path("build/compare_trees").resolve()
    logs.mkdir(parents=True, exist_ok=True)
    order = [old, new, new, old] * turns
    for n, tree in enumerate(order):
        log = logs / f"turn_{n}.log"
        proc = subprocess.run([sys.executable, "-c", _TURN, tree], cwd=tree,
                              capture_output=True, text=True, timeout=1800)
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"compare_trees: turn {n} in {tree} exited "
                  f"{proc.returncode}; see {log}", file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("TURN "):
                print(line[5:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

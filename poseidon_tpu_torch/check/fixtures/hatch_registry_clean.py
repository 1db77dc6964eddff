"""hatch-registry clean fixture: registered call-time accessor reads.

Accessor reads of declared hatches, environment WRITES (harness
latches), and dynamic accessor names are all legal.  Zero findings.
"""

import os

from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_int, hatch_raw

GATE = "POSEIDON_COST_DELTA"


def gates():
    if not hatch_bool("POSEIDON_PRUNE_WAVE"):
        return 0
    return hatch_int("POSEIDON_PRUNE_MIN_ROWS", 192)


def policy(env_var: str):
    # Dynamic name: validated by the accessor at call time.
    return hatch_raw(env_var)


def latch_for_children():
    # Environment WRITES are harness latches, not reads: legal.
    os.environ["POSEIDON_BENCH_NO_PROBE"] = "1"
    os.environ.setdefault("POSEIDON_REPLAY_PROGRESS", "1")


def named_gate():
    # A module constant carrying the name keeps the hatch live for the
    # dead-flag check AND reads through the accessor.
    return hatch_bool(GATE)


def non_hatch_env():
    # Non-POSEIDON environment reads are out of this rule's scope.
    return os.environ.get("JAX_PLATFORMS", "")

"""hatch-registry violation fixture: bypasses and undeclared hatches.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - direct env reads of REGISTERED hatches (bypass)               (3)
  - direct env read of an UNDECLARED POSEIDON_* name              (1)
  - accessor read of an UNDECLARED name                           (1)
  - the suppressed bypass and the env WRITE do not count
"""

import os

from poseidon_tpu_torch.utils.hatches import hatch_bool


def bypasses():
    a = os.environ.get("POSEIDON_TRACE")          # VIOLATION: bypass
    b = os.getenv("POSEIDON_FUSED")               # VIOLATION: bypass
    c = os.environ["POSEIDON_TILED"]              # VIOLATION: bypass
    ok = os.environ.get("POSEIDON_CHAINED")  # posecheck: ignore[hatch-registry]
    return a, b, c, ok


def undeclared():
    # VIOLATION: a POSEIDON_* name the registry does not declare.
    x = os.environ.get("POSEIDON_NOT_A_DECLARED_HATCH")
    # VIOLATION: the accessor would raise KeyError at call time.
    y = hatch_bool("POSEIDON_ALSO_NOT_DECLARED")
    return x, y


def legal_write():
    os.environ["POSEIDON_TRACE"] = "1"  # write: a harness latch, legal

"""determinism clean fixture: seeded RNG streams, virtual time, sorted
iteration over sets, and call-time environment reads."""

import os
import time

import numpy as np
import torch


def unroll_factor() -> int:
    # Call-time accessor: tests/bench can vary the env var per call.
    return int(os.environ.get("FIXTURE_UNROLL", "4"))


def seeded_trace(seed: int):
    rng = np.random.default_rng(seed)          # seeded stream: fine
    return rng.uniform(0.0, 1.0, size=8)


def seeded_tensors(seed: int, n: int):
    gen = torch.Generator().manual_seed(seed)   # seeded stream: fine
    other = torch.Generator()
    other.manual_seed(seed + 1)                 # seeded through its name
    return (torch.randn(n, generator=gen),
            torch.randperm(n, generator=other))


def measure(fn):
    # perf_counter feeds telemetry, not decisions: not flagged.
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def stable_order(uuids):
    pending = set(uuids)
    # sorted() normalizes set order before it can leak into output.
    report = [u.upper() for u in sorted(pending)]
    for u in sorted({x for x in uuids if x}):
        report.append(u)
    if "m0" in pending:                         # membership tests are fine
        report.append("m0")
    return report

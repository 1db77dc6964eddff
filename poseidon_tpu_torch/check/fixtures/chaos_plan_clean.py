"""determinism-rule CLEAN fixture, chaos flavor: a seed-reproducible
fault plan.  Everything here is the pattern chaos/ code must follow —
seeded RNG streams, sorted iteration over unordered collections, no wall
clock — and must produce ZERO findings."""

import random

import numpy as np

FAMILIES = ("watch", "events", "rpc")


def seeded_schedule(seed: int, rounds: int):
    """Fault rounds drawn from an explicit seeded stream."""
    rng = np.random.default_rng(seed)
    return sorted(int(rng.integers(rounds)) for _ in FAMILIES)


def seeded_jitter(seed: int) -> float:
    """Backoff jitter threads a seeded random.Random, never the global."""
    stream = random.Random(seed)
    return stream.random()


def covered_families(faults) -> tuple:
    """Set contents reach output only through sorted()."""
    families = {f.family for f in faults}
    return tuple(sorted(families))


def virtual_time(round_index: int, interval_s: float) -> float:
    """Round index is the only time axis a replayable plan may carry."""
    return round_index * interval_s

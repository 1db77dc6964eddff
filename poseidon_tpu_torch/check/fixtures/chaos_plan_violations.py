"""determinism-rule VIOLATION fixture, chaos flavor: every way a fault
plan stops being seed-reproducible.  Expected findings (one per marked
line): 2 wall-clock, 2 unseeded-RNG, 1 seedless default_rng, 2 set
iteration — 7 total."""

import random
import time

import numpy as np


def wall_clock_schedule(rounds: int):
    """Fault timing off the wall clock: two runs disagree."""
    now = time.time()                       # finding: wall-clock
    return [int(now) % rounds, int(time.time()) % rounds]  # finding


def entropy_schedule(rounds: int):
    """OS-entropy draws: unseeded global streams."""
    r = random.randrange(rounds)            # finding: unseeded global RNG
    rng = np.random.default_rng()           # finding: default_rng no seed
    k = np.random.randint(rounds)           # finding: unseeded global RNG
    return [r, int(rng.integers(rounds)), int(k)]


def family_order(faults):
    """Set iteration order feeds the plan's output order."""
    families = {"watch", "events", "rpc"}
    out = []
    for fam in families:                    # finding: set iteration
        out.append(fam)
    return out + list({f.family for f in faults})   # finding: set iteration

"""determinism violation fixture: wall clock, unseeded RNG, set iteration.

Expected findings:
  - time.time() wall clock                       (2: dotted + from-import)
  - unseeded global random.* / np.random.*       (3)
  - default_rng() with no seed                   (1)
  - unseeded torch RNG: torch.rand without a
    generator, a torch.Generator never seeded    (2)
  - iteration over bare sets                     (5: for / comprehension /
                                                  list() / tracked var /
                                                  var grown via |=)
  - import-time environment reads                (4: .get / subscript /
                                                  class body / def default)
  - suppressed time.time() does NOT count
"""

import os
import random
import time
from time import time as now

import numpy as np
import torch

UNROLL = int(os.environ.get("FIXTURE_UNROLL", "4"))   # VIOLATION: import-time
MODE = os.environ["FIXTURE_MODE"]                     # VIOLATION: import-time


class Tunables:
    budget = int(os.getenv("FIXTURE_BUDGET", "8"))    # VIOLATION: class body

    def call_time(self):
        return os.environ.get("FIXTURE_BUDGET", "8")  # call time: fine


def pinned_default(                                   # default evaluates at
    n=int(os.environ.get("FIXTURE_N", "4")),          # VIOLATION: import
):
    return n


def stamp_events(events):
    t = time.time()                         # VIOLATION: wall clock
    t2 = now()                              # VIOLATION: wall clock (alias)
    ok = time.time()                        # posecheck: ignore[determinism]
    return [(t, t2, ok, e) for e in events]


def jitter(n):
    a = random.random()                     # VIOLATION: global RNG
    b = np.random.uniform(0, 1, size=n)     # VIOLATION: global np RNG
    c = random.shuffle(list(range(n)))      # VIOLATION: global RNG
    rng = np.random.default_rng()           # VIOLATION: unseeded default_rng
    return a, b, c, rng.integers(0, n)


def torch_jitter(n):
    noise = torch.rand(n)                   # VIOLATION: global torch RNG
    gen = torch.Generator()                 # VIOLATION: never seeded
    perm = torch.randperm(n, generator=gen)
    return noise, perm


def leak_order(uuids):
    pending = set(uuids)
    out = []
    for u in pending:                       # VIOLATION: tracked set var
        out.append(u)
    for u in {x for x in uuids}:            # VIOLATION: set comprehension
        out.append(u)
    out.extend(list(set(uuids)))            # VIOLATION: list(set(...))
    out.extend(x for x in set(uuids))       # VIOLATION: genexp over set
    grown = set(uuids)
    grown |= {"extra"}                      # set algebra keeps it a set
    for u in grown:                         # VIOLATION: still unordered
        out.append(u)
    return out

"""Seeded preemption-point race harness (the port of the JAX package's
``chaos/preempt.py``).

An *instrumented* harness, where brute thread counts are not: every
:class:`~poseidon_tpu_torch.utils.locks.TrackedLock` acquire/release is a
**preemption point**, and while :class:`PreemptPoints` is installed each
point consults a seeded RNG to decide whether the thread yields its
timeslice or parks for a few hundred microseconds.  The decision
*sequence* is a pure function of the seed, so a failure's schedule
pressure is reproducible — re-running the same seed replays the same
widening of the same race windows (thread wake-up order stays the OS's,
which is why the suites sweep several seeds rather than trusting one).

The harness drives real interleavings (the port's keyed queue, the
cost pipeline's speculate/join, metrics scrapes racing
``observe_round``), with the TrackedLock edge graph recording any
ordering the storm explores.

Knobs (the port's hatch registry, utils/hatches.py):

- ``POSEIDON_RACE_SEED`` — base seed; suite seed k runs at base + k;
- ``POSEIDON_RACE_SWEEP`` — how many seeded interleavings each suite
  drives (CI keeps the default small; a soak box can turn it up).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Iterable, List, Optional

from poseidon_tpu_torch.utils import locks as _locks
from poseidon_tpu_torch.utils.hatches import hatch_int


def race_seeds(sweep: Optional[int] = None) -> Iterable[int]:
    """The seeds a harness suite parametrizes over: base seed from
    ``POSEIDON_RACE_SEED``, count from ``POSEIDON_RACE_SWEEP`` (or the
    explicit ``sweep`` override for suites with their own budget)."""
    base = hatch_int("POSEIDON_RACE_SEED")
    n = sweep if sweep is not None else hatch_int("POSEIDON_RACE_SWEEP")
    return range(base, base + max(n, 1))


class PreemptPoints:
    """Install seeded preemption at every TrackedLock boundary.

    >>> with PreemptPoints(seed=3):
    ...     drive_threads()

    ``p_yield`` of decisions surrender the timeslice (``sleep(0)``) and
    ``p_park`` of them park for ``park_s`` — long enough that any thread
    waiting on the freshly-released (or about-to-be-taken) lock actually
    runs into the window.  The RNG is consulted under its own plain lock
    so the decision sequence is total-ordered across threads; the
    consuming order is scheduler-dependent, the sequence itself is not.

    Installation is process-global (the hook lives in utils/locks);
    nesting is rejected rather than silently stacked.
    """

    def __init__(self, seed: int, *, p_yield: float = 0.25,
                 p_park: float = 0.1, park_s: float = 0.0005) -> None:
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._p_yield = p_yield
        self._p_park = p_park
        self._park_s = park_s
        self.decisions = 0

    def _point(self, point: str, name: str) -> None:
        with self._mu:
            self.decisions += 1
            r = self._rng.random()
        if r < self._p_park:
            time.sleep(self._park_s)
        elif r < self._p_park + self._p_yield:
            time.sleep(0)

    def __enter__(self) -> "PreemptPoints":
        if _locks._preempt_hook is not None:
            raise RuntimeError("PreemptPoints already installed")
        _locks.install_preempt_hook(self._point)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _locks.install_preempt_hook(None)


class InvariantTracker:
    """Mutual-exclusion recorder for harness probes (shared by every
    race suite):
    ``enter(key, who)`` / ``exit(key, who)`` bracket a section that must
    be exclusive per key; overlaps land in ``violations`` instead of
    raising, so the storm runs to completion and reports everything."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._in_flight: dict = {}
        self.violations: List[str] = []

    def enter(self, key, who: str) -> None:
        with self._mu:
            holder = self._in_flight.get(key)
            if holder is not None:
                self.violations.append(
                    f"{key!r} entered concurrently by {holder} and {who}"
                )
            self._in_flight[key] = who

    def exit(self, key, who: str) -> None:
        with self._mu:
            if self._in_flight.get(key) == who:
                del self._in_flight[key]

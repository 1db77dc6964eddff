"""TrackedLock + LockLedger: runtime lock-order, contention, and
blocking-under-lock accounting (the JAX package's ``utils/locks.py``,
kept line for line: the port carries its own process-wide lock graph).

Every lock in the threaded layers (glue watchers/queue, the cost-build
pipeline, the obs plane, the service) is a :class:`TrackedLock` — a
drop-in ``threading.Lock`` / ``RLock`` wrapper that:

- records **acquisition-order edges** into a process-wide graph: when a
  thread acquires lock B while holding lock A, the edge ``A -> B`` is
  latched (once, with the call site that first observed it).  A new edge
  that closes a cycle in the graph is a *potential deadlock* — two
  threads taking the same pair of locks in opposite orders — recorded in
  :func:`lock_cycles` with both directions' call sites;
- accounts **contention** (acquisitions that had to wait, and the
  nanoseconds they waited) and **hold time** per lock name — exported as
  the ``poseidon_lock_{contention_total,hold_seconds}`` series
  (obs/metrics.observe_locks).

:class:`LockLedger` is the budget-0 context manager for warm windows: on
exit it asserts **no new lock-order edge** appeared (a warm round
exploring a new lock ordering is how opposite-order deadlocks ship) and
**no blocking call ran while a tracked lock was held** — detected
through a ``sys.setprofile``/``threading.setprofile`` window that
matches ``time.sleep``, ``queue.Queue.get/join``, ``Thread.join``,
``Future.result`` and socket calls against the calling thread's held
set.  The profile window covers the entering thread and threads started
inside the window (long-lived worker threads predating the window are
outside it — the edge graph, being process-wide, still covers them).

Tracking overhead on the uncontended path is one non-blocking inner
acquire, two ``perf_counter_ns`` reads and a thread-local list append.
``POSEIDON_LOCK_LEDGER=0`` drops even that: the wrapper degrades to a
bare delegate (read at lock construction, the one place a per-acquire
env probe would be too hot).

The preemption-point hook (:data:`install_preempt_hook`) is the seeded
race harness's instrumentation surface (chaos/preempt.py): when
installed, every tracked acquire/release calls it, letting the harness
widen interleaving windows deterministically-in-decisions without
touching the code under test.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from poseidon_tpu_torch.utils.hatches import hatch_bool

# --------------------------------------------------------- process state

# Plain (untracked) module lock: guards the edge graph, the instance
# registry and the active-ledger list.  It is a leaf by construction —
# nothing is acquired under it and no user code runs under it — so it
# can never participate in the orderings it records.
_REG = threading.Lock()

# (held_name, acquired_name) -> first-observation description.
_edges: Dict[Tuple[str, str], str] = {}
# Append-only mirror of _edges in observation order; LockLedger windows
# snapshot an index into it instead of copying the graph.
_edge_list: List[Tuple[str, str, str]] = []
# Successor adjacency for cycle detection (names, not instances).
_succ: Dict[str, set] = {}
# Human-readable descriptions of every cycle the graph ever closed.
_cycles: List[str] = []
# Every tracking TrackedLock ever constructed (strong refs: lock objects
# are tiny and process-lifetime; retiring them would make the summed
# counters non-monotonic).
_instances: List["TrackedLock"] = []
_active: List["LockLedger"] = []

# Race-harness preemption hook (chaos/preempt.py); None = disabled, and
# the hot path pays one global load + is-None test.
_preempt_hook: Optional[Callable[[str, str], None]] = None

_tls = threading.local()


def _stack() -> List[Tuple[str, int]]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def install_preempt_hook(
    hook: Optional[Callable[[str, str], None]],
) -> None:
    """Install (or clear, with None) the race-harness preemption hook.
    Called as ``hook(point, lock_name)`` with point ``"acquire"`` (before
    the inner acquire) or ``"release"`` (after the inner release)."""
    global _preempt_hook
    _preempt_hook = hook


def _caller_site() -> str:
    """file.py:line of the nearest frame outside this module/threading —
    only walked on a first-observed edge, never on the hot path."""
    try:
        f = sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename.replace("\\", "/")
            if not fn.endswith("utils/locks.py") \
                    and "/threading.py" not in fn:
                return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
            f = f.f_back
    except Exception:  # noqa: BLE001 - attribution must never raise
        pass
    return "<unknown>"


def _path_exists(src: str, dst: str) -> bool:
    """True iff dst is reachable from src over the edge graph.  Called
    under _REG."""
    seen = {src}
    frontier = [src]
    while frontier:
        n = frontier.pop()
        if n == dst:
            return True
        for m in _succ.get(n, ()):
            if m not in seen:
                seen.add(m)
                frontier.append(m)
    return False


def _note_edge(prev: str, name: str) -> None:
    key = (prev, name)
    if key in _edges:  # racy fast path: edges are only ever added
        return
    site = _caller_site()
    with _REG:
        if key in _edges:
            return
        # The reverse path existing means this edge closes a cycle:
        # some thread somewhere acquires these locks in the opposite
        # order — the classic two-thread deadlock shape.
        if _path_exists(name, prev):
            back = _edges.get((name, prev))
            back_site = f" (reverse edge first seen at {back})" \
                if back else ""
            _cycles.append(
                f"lock-order cycle: {prev} -> {name} at {site}"
                f"{back_site}"
            )
        desc = f"{prev} -> {name} first acquired at {site}"
        _edges[key] = desc
        _edge_list.append((prev, name, desc))
        _succ.setdefault(prev, set()).add(name)


class TrackedLock:
    """Drop-in ``threading.Lock``/``RLock`` with order + timing tracking.

    ``name`` keys the process-wide edge graph and the per-lock metric
    series — use a stable ``module.Class.attr`` string, shared by every
    instance guarding the same role (per-instance names would unbound
    the graph).  ``reentrant=True`` wraps an RLock; nested acquisitions
    by the owner neither re-edge nor re-time.
    """

    __slots__ = (
        "name", "_inner", "_reentrant", "_owner", "_depth", "_tracking",
        "acquisitions", "contended", "contention_ns", "hold_ns",
    )

    def __init__(self, name: str, *, reentrant: bool = False) -> None:
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: Optional[int] = None
        self._depth = 0
        # Read once at construction: a per-acquire env probe would be
        # too hot for the tracer/metrics paths this wrapper sits on.
        self._tracking = hatch_bool("POSEIDON_LOCK_LEDGER")
        # Per-instance counters, mutated only by the thread that holds
        # the lock (contention is noted AFTER the inner acquire), so
        # they need no lock of their own.
        self.acquisitions = 0
        self.contended = 0
        self.contention_ns = 0
        self.hold_ns = 0
        if self._tracking:
            with _REG:
                _instances.append(self)

    # -- core protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._tracking:
            return self._inner.acquire(blocking, timeout)
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._inner.acquire()
            self._depth += 1
            return True
        hook = _preempt_hook
        if hook is not None:
            hook("acquire", self.name)
        t0 = time.perf_counter_ns()
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
            waited = time.perf_counter_ns() - t0
            self.contended += 1
            self.contention_ns += waited
        self._owner = me
        self._depth = 1
        self.acquisitions += 1
        st = _stack()
        if st:
            prev = st[-1][0]
            if prev != self.name:
                _note_edge(prev, self.name)
        st.append((self.name, time.perf_counter_ns()))
        return True

    def release(self) -> None:
        if not self._tracking:
            self._inner.release()
            return
        if self._reentrant and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == self.name:
                _, t0 = st.pop(i)
                self.hold_ns += time.perf_counter_ns() - t0
                break
        # Clear ownership BEFORE the inner release: after it, another
        # thread may acquire and stamp itself immediately.
        self._owner = None
        self._depth = 0
        self._inner.release()
        hook = _preempt_hook
        if hook is not None:
            hook("release", self.name)

    def locked(self) -> bool:
        if self._reentrant:
            return self._owner is not None
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r} reentrant={self._reentrant}>"


def tracked_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` over a TrackedLock: wait() releases and
    re-acquires through the tracked wrapper, so the hold-time windows
    and order edges stay exact across waits."""
    return threading.Condition(TrackedLock(name))


# ------------------------------------------------------------- accessors


def lock_order_edge_count() -> int:
    """Process-wide count of distinct lock-acquisition-order edges ever
    observed.  Difference around a window (a warm round): a warm round
    must not explore a new ordering."""
    with _REG:
        return len(_edge_list)


def lock_order_edges() -> List[Tuple[str, str, str]]:
    """(held, acquired, first-observation description) triples."""
    with _REG:
        return list(_edge_list)


def lock_cycles() -> List[str]:
    """Descriptions of every lock-order cycle the graph ever closed —
    each one a potential deadlock (opposite-order acquisition)."""
    with _REG:
        return list(_cycles)


def _reset_edges_for_tests() -> None:
    """Test hook: the edge graph is process-global; harness tests that
    need a fresh graph reset it so later windows diff cleanly."""
    with _REG:
        _edges.clear()
        _edge_list.clear()
        _succ.clear()
        _cycles.clear()


def lock_contention_ns() -> int:
    """Process-wide nanoseconds threads spent waiting on contended
    tracked-lock acquisitions.  Monotonic; difference around a round
    window — ``RoundMetrics.lock_contention_ns`` is wired this way."""
    with _REG:
        return sum(lk.contention_ns for lk in _instances)


def lock_contention_count() -> int:
    """Process-wide count of contended tracked-lock acquisitions."""
    with _REG:
        return sum(lk.contended for lk in _instances)


def lock_hold_ns() -> int:
    """Process-wide nanoseconds tracked locks were held."""
    with _REG:
        return sum(lk.hold_ns for lk in _instances)


def per_lock_stats() -> Dict[str, Dict[str, float]]:
    """Per-lock-name aggregates (instances sharing a name sum), feeding
    the labeled ``poseidon_lock_*`` series."""
    out: Dict[str, Dict[str, float]] = {}
    with _REG:
        snapshot = list(_instances)
    for lk in snapshot:
        agg = out.setdefault(lk.name, {
            "acquisitions": 0.0, "contended": 0.0,
            "contention_ns": 0.0, "hold_ns": 0.0,
        })
        agg["acquisitions"] += lk.acquisitions
        agg["contended"] += lk.contended
        agg["contention_ns"] += lk.contention_ns
        agg["hold_ns"] += lk.hold_ns
    return out


# ----------------------------------------------------- blocking detection

# C-level blocking callables matched by identity on "c_call" events.
_BLOCKING_BUILTINS = frozenset({time.sleep})

# Socket method names: a c_call whose __self__ is a socket.socket with
# one of these names is a network round trip under a lock.
_SOCKET_BLOCKING = frozenset({
    "connect", "accept", "recv", "recv_into", "recvfrom", "sendall",
})


def _blocking_codes() -> frozenset:
    """Code objects of the Python-level blocking calls the profile
    window matches: queue gets/joins, thread joins, future results."""
    import queue
    from concurrent.futures import Future

    codes = set()
    for fn in (
        queue.Queue.get, queue.Queue.join, threading.Thread.join,
        Future.result,
    ):
        code = getattr(fn, "__code__", None)
        if code is not None:
            codes.add(code)
    return frozenset(codes)


class LockBudgetExceeded(AssertionError):
    """A LockLedger window observed new lock-order edges or blocking
    calls under a tracked lock."""


class LockLedger:
    """Context manager asserting the concurrency budget of a window.

    >>> with LockLedger(budget=0, label="warm round"):
    ...     poseidon.try_round()

    Budget 0 (the only meaningful strictness) asserts on exit that the
    window minted **no new lock-order edge** process-wide and ran **no
    blocking call while a tracked lock was held** on the entering thread
    or threads started inside the window (a ``sys.setprofile`` +
    ``threading.setprofile`` pair, restored on exit).  ``budget=None``
    records without asserting (telemetry mode) and installs no profile
    hook, so production rounds can ride it for free.  The assertion is
    raised from ``__exit__`` only when the body itself did not raise.
    """

    def __init__(self, budget: Optional[int] = 0, label: str = ""):
        self.budget = budget
        self.label = label
        self._edge0 = 0
        self.blocking_calls: List[str] = []
        self._prev_profile = None
        self._prev_thread_profile = None
        self._codes: frozenset = frozenset()

    # -- telemetry ---------------------------------------------------------

    @property
    def new_edges(self) -> List[Tuple[str, str, str]]:
        with _REG:
            return list(_edge_list[self._edge0:])

    # -- profile hook ------------------------------------------------------

    def _profile(self, frame, event, arg):
        try:
            if event == "c_call":
                st = getattr(_tls, "stack", None)
                if not st:
                    return
                held = st[-1][0]
                if arg in _BLOCKING_BUILTINS:
                    self._note_blocking(getattr(arg, "__name__", "?"),
                                        held, frame)
                elif getattr(arg, "__name__", "") in _SOCKET_BLOCKING:
                    import socket

                    if isinstance(getattr(arg, "__self__", None),
                                  socket.socket):
                        self._note_blocking(arg.__name__, held, frame)
            elif event == "call":
                if frame.f_code in self._codes:
                    st = getattr(_tls, "stack", None)
                    if st:
                        self._note_blocking(
                            frame.f_code.co_qualname
                            if hasattr(frame.f_code, "co_qualname")
                            else frame.f_code.co_name,
                            st[-1][0], frame.f_back or frame,
                        )
        except Exception:  # noqa: BLE001 - a profile hook must never raise
            pass

    def _note_blocking(self, what: str, held: str, frame) -> None:
        if len(self.blocking_calls) < 32:  # cap the report
            fn = frame.f_code.co_filename.replace("\\", "/")
            self.blocking_calls.append(
                f"{what}() under {held} at "
                f"{fn.rsplit('/', 1)[-1]}:{frame.f_lineno}"
            )

    # -- context protocol --------------------------------------------------

    def __enter__(self) -> "LockLedger":
        with _REG:
            self._edge0 = len(_edge_list)
            _active.append(self)
        if self.budget == 0:
            self._codes = _blocking_codes()
            self._prev_profile = sys.getprofile()
            self._prev_thread_profile = getattr(
                threading, "_profile_hook", None
            )
            threading.setprofile(self._profile)
            sys.setprofile(self._profile)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.budget == 0:
            sys.setprofile(self._prev_profile)
            threading.setprofile(self._prev_thread_profile)
            self._prev_profile = None
            self._prev_thread_profile = None
        with _REG:
            if self in _active:
                _active.remove(self)
            fresh = list(_edge_list[self._edge0:])
        if exc_type is not None or self.budget is None:
            return False
        where = f" in {self.label}" if self.label else ""
        if len(fresh) > self.budget:
            edges = "; ".join(d for _, _, d in fresh) or "<none>"
            raise LockBudgetExceeded(
                f"{len(fresh)} new lock-order edge(s){where}, budget "
                f"{self.budget}: {edges}.  A warm window explored a new "
                "lock ordering — check it against the existing graph "
                "for an opposite-order pair."
            )
        if self.blocking_calls:
            calls = "; ".join(self.blocking_calls)
            raise LockBudgetExceeded(
                f"{len(self.blocking_calls)} blocking call(s) under a "
                f"tracked lock{where}: {calls}.  Move the wait outside "
                "the critical section."
            )
        return False

"""Fault-injection proxies around the production seams.

Three seams, all thin and all *inside* the production paths so the code
being hardened is the code being exercised:

- ``ChaoticKube`` wraps a ``KubeAPI``: watch streams come back wrapped in
  ``ChaosWatch`` (disconnects, stalls, duplicates, cross-object
  reorders), and ``bind_pod`` can be made to fail.  The watchers and the
  delta-enactment loop run unmodified against it.
- ``chaotic_client`` builds a real ``FirmamentClient`` and wraps its RPC
  *stubs*, so injected UNAVAILABLE/DEADLINE errors pass through the
  client's own deadline/retry/backoff machinery — the hardening under
  test — not around it.
- the planner's ``chaos`` hook (``graph/instance.py``) consults
  ``FaultInjector.solver_fault()`` to force certificate failure
  (degraded-tier escalation) or a partial round.

The ``FaultInjector`` is the per-soak armature: ``begin_round(r)`` arms
that round's faults from the plan and flushes the previous round's event
stalls; every fired fault is recorded (round, kind, detail) for the
flight recorder.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import grpc

from poseidon_tpu_torch.chaos.plan import Fault, FaultPlan
from poseidon_tpu_torch.glue.fake_kube import KubeAPI
from poseidon_tpu_torch.utils.locks import TrackedLock

log = logging.getLogger("poseidon.chaos")


class InjectedRpcError(grpc.RpcError):
    """A synthetic RpcError carrying a real status code, so retry logic
    that switches on ``e.code()`` treats it exactly like the wire kind."""

    def __init__(self, code: grpc.StatusCode, detail: str = "") -> None:
        super().__init__(f"injected {code.name}: {detail}")
        self._code = code
        self._detail = detail

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._detail


class InjectedBindError(RuntimeError):
    """A bind_pod failure (the API server rejecting the binding
    subresource call)."""


# --------------------------------------------------------------- the injector


class FaultInjector:
    """Arms one round's faults at a time and records what fired.

    Thread-safe: watch wrappers are polled from watcher pump threads
    while the soak loop arms rounds and the RPC wrappers fire from the
    schedule path.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.round_index = -1
        self.fired: List[dict] = []
        # RLock: the record helper runs under the same lock the fault
        # accessors already hold.
        self._lock = TrackedLock(
            "chaos.FaultInjector._lock", reentrant=True
        )
        # Armed state, consumed as faults fire.
        self._disconnect: Dict[str, bool] = {}         # family key -> pending
        self._stall: Dict[str, int] = {}               # family key -> polls
        self._dup: Dict[str, bool] = {}
        self._reorder: Dict[str, bool] = {}
        self._rpc: Dict[str, List[Fault]] = {}         # rpc name -> faults
        self._bind_fails = 0
        self._solver: Optional[Fault] = None
        # Test hook: when set, Schedule blocks on the event before
        # delegating (the stop()-mid-round regression needs a round that
        # is reliably in flight).
        self.hold_schedule: Optional[threading.Event] = None
        self.in_schedule = threading.Event()

    def _record(self, fault_kind: str, detail: str = "") -> None:
        with self._lock:
            self.fired.append({
                "round": self.round_index, "kind": fault_kind,
                "detail": detail,
            })

    def begin_round(self, round_index: int) -> None:
        """Arm ``round_index``'s faults; release any still-stalled event
        buffers from the previous round (a stalled event is 'delayed', not
        lost — it lands before the next round's work begins)."""
        with self._lock:
            self.round_index = round_index
            self._stall = {"pods": 0, "nodes": 0}
            self._dup = {"pods": False, "nodes": False}
            self._reorder = {"pods": False, "nodes": False}
            self._disconnect = {"pods": False, "nodes": False}
            self._rpc = {}
            self._bind_fails = 0
            self._solver = None
            for f in self.plan.for_round(round_index):
                kind = f.kind
                if kind.startswith("disconnect_"):
                    self._disconnect[kind.rsplit("_", 1)[1]] = True
                elif kind.startswith("stall_"):
                    # 2 = armed, not yet recorded; 1 = armed, recorded;
                    # 0 = clear.  Held until the next begin_round.
                    self._stall[kind.rsplit("_", 1)[1]] = 2
                elif kind.startswith("dup_"):
                    self._dup[kind.rsplit("_", 1)[1]] = True
                elif kind.startswith("reorder_"):
                    self._reorder[kind.rsplit("_", 1)[1]] = True
                elif kind in ("rpc_unavailable", "rpc_deadline"):
                    self._rpc.setdefault(f.target or "Schedule", []).append(f)
                elif kind in ("schedule_partial", "schedule_lost"):
                    self._rpc.setdefault("Schedule", []).append(f)
                elif kind == "bind_fail":
                    self._bind_fails += max(f.value, 1)
                elif kind == "solver_uncertified":
                    self._solver = f

    def is_stalled(self, family: str) -> bool:
        """Whether the family's event stream is currently held (the soak
        skips its delivery barriers for held streams — their events land
        a round late by design)."""
        with self._lock:
            return self._stall.get(family, 0) > 0

    def flush_events(self) -> None:
        """Release every held event stream (the soak's quiesce point:
        the divergence gate compares AFTER all in-flight knowledge has
        landed — a stalled event is delivery lag, not divergence; the
        stall already did its damage to the round that solved without
        it)."""
        with self._lock:
            for family in self._stall:
                self._stall[family] = 0

    # ------------------------------------------------------------ watch seam

    def take_disconnect(self, family: str) -> bool:
        with self._lock:
            if self._disconnect.get(family):
                self._disconnect[family] = False
                self._record(f"disconnect_{family}")
                return True
            return False

    def take_stall_poll(self, family: str) -> bool:
        """True while the family's event stream is stalled.  A stall
        holds delivery for the REST OF THE ROUND (``begin_round``
        releases it): events produced under it genuinely land one round
        late, instead of a few pump-polls late, which a drain barrier
        would otherwise absorb invisibly."""
        with self._lock:
            if self._stall.get(family, 0) > 0:
                if self._stall[family] > 1:
                    # Record once, on first observation.
                    self._stall[family] = 1
                    self._record(f"stall_{family}")
                return True
            return False

    def take_dup(self, family: str) -> bool:
        with self._lock:
            if self._dup.get(family):
                self._dup[family] = False
                self._record(f"dup_{family}")
                return True
            return False

    def take_reorder(self, family: str) -> bool:
        with self._lock:
            if self._reorder.get(family):
                self._reorder[family] = False
                self._record(f"reorder_{family}")
                return True
            return False

    # -------------------------------------------------------------- RPC seam

    def before_rpc(self, name: str) -> None:
        """Pre-delegation faults: the request never reaches the service."""
        if name == "Schedule":
            self.in_schedule.set()
            hold = self.hold_schedule
            if hold is not None:
                hold.wait()
        with self._lock:
            armed = self._rpc.get(name, [])
            take = None
            for f in armed:
                if f.kind in ("rpc_unavailable", "rpc_deadline"):
                    take = f
                    break
            if take is None:
                return
            armed.remove(take)
            self._record(take.kind, name)
        if take.kind == "rpc_unavailable":
            raise InjectedRpcError(grpc.StatusCode.UNAVAILABLE, name)
        raise InjectedRpcError(grpc.StatusCode.DEADLINE_EXCEEDED, name)

    def after_rpc(self, name: str, response):
        """Post-delegation faults: the service HAS committed.  Only
        ``schedule_lost`` lives here — the response is discarded and the
        caller sees a deadline, modelling a reply lost on the wire after
        the round ran (the commit-ambiguity case the glue's suspect
        reconciler exists for)."""
        if name != "Schedule":
            return response
        with self._lock:
            armed = self._rpc.get(name, [])
            take = None
            for f in armed:
                if f.kind == "schedule_lost":
                    take = f
                    break
            if take is not None:
                armed.remove(take)
                self._record("schedule_lost", name)
        if take is not None:
            raise InjectedRpcError(
                grpc.StatusCode.DEADLINE_EXCEEDED, "response lost post-commit"
            )
        return response

    # ----------------------------------------------------------- enactment seam

    def take_bind_fault(self) -> bool:
        with self._lock:
            if self._bind_fails > 0:
                self._bind_fails -= 1
                self._record("bind_fail")
                return True
            return False

    # -------------------------------------------------------------- solve seam

    def solver_fault(self) -> Tuple[bool, Optional[float]]:
        """(force_uncertified, partial_fraction) for the CURRENT round.

        Not consumed per call: every band of a faulted round degrades
        (the tier is a per-round property).  ``partial_fraction`` comes
        from an armed ``schedule_partial`` (value = percent placed)."""
        with self._lock:
            forced = self._solver is not None
            frac = None
            for f in self._rpc.get("Schedule", []):
                if f.kind == "schedule_partial":
                    frac = max(min(f.value, 100), 0) / 100.0
                    break
            if forced and not any(
                e["kind"] == "solver_uncertified"
                and e["round"] == self.round_index
                for e in self.fired
            ):
                self._record("solver_uncertified")
            if frac is not None and not any(
                e["kind"] == "schedule_partial"
                and e["round"] == self.round_index
                for e in self.fired
            ):
                self._record("schedule_partial")
        return forced, frac


# ---------------------------------------------------------------- watch seam


class ChaosWatch:
    """A ``queue.Queue``-shaped wrapper over a real watch queue.

    Faults are applied at delivery time: a pending disconnect drops
    everything buffered and delivers one ``("ERROR", reason)`` event (the
    stale-resourceVersion signal the watcher must resync on); a stall
    answers ``queue.Empty`` for N polls while events pile up; duplicate
    re-delivers the next event; reorder swaps the next two events when
    they concern different objects (per-object order is the informer
    contract and is preserved unconditionally).
    """

    def __init__(self, inner: "queue.Queue", injector: FaultInjector,
                 family: str) -> None:
        self._inner = inner
        self._injector = injector
        self.family = family
        self._buf: deque = deque()
        self._dead = False

    @staticmethod
    def _key(event) -> str:
        kind, obj = event
        return getattr(obj, "key", None) or getattr(obj, "name", "")

    def _drain_inner(self) -> None:
        while True:
            try:
                self._buf.append(self._inner.get_nowait())
            except queue.Empty:
                return

    def get(self, timeout: Optional[float] = None):
        if self._dead:
            # A disconnected watch never delivers again (the watcher has
            # resubscribed; this object is garbage the moment ERROR lands).
            raise queue.Empty
        inj = self._injector
        if inj.take_disconnect(self.family):
            self._drain_inner()
            dropped = len(self._buf)
            self._buf.clear()
            self._dead = True
            return ("ERROR", f"stale resourceVersion ({dropped} events lost)")
        if inj.take_stall_poll(self.family):
            self._drain_inner()  # events keep arriving; delivery pauses
            time.sleep(0.02)     # don't busy-spin the pump thread
            raise queue.Empty
        self._drain_inner()
        if not self._buf:
            # Block on the real queue like a plain watch would.
            self._buf.append(self._inner.get(timeout=timeout))
            self._drain_inner()
        if len(self._buf) >= 2 and inj.take_reorder(self.family):
            a, b = self._buf[0], self._buf[1]
            if self._key(a) != self._key(b):
                self._buf[0], self._buf[1] = b, a
        event = self._buf.popleft()
        if inj.take_dup(self.family):
            self._buf.appendleft(event)
        return event


class ChaoticKube(KubeAPI):
    """A ``KubeAPI`` whose watches and bind calls can fail on schedule.

    Everything else (mutators, registries, actuation logs) delegates to
    the wrapped kube — the fake cluster stays the single source of
    truth."""

    def __init__(self, inner: KubeAPI, injector: FaultInjector) -> None:
        self.inner = inner
        self.injector = injector

    def list_pods(self):
        return self.inner.list_pods()

    def list_nodes(self):
        return self.inner.list_nodes()

    def watch_pods(self):
        return ChaosWatch(self.inner.watch_pods(), self.injector, "pods")

    def watch_nodes(self):
        return ChaosWatch(self.inner.watch_nodes(), self.injector, "nodes")

    def unwatch_pods(self, watch) -> None:
        # Unwrap: the fan-out registry holds the inner queue, not the
        # chaos wrapper.
        self.inner.unwatch_pods(getattr(watch, "_inner", watch))

    def unwatch_nodes(self, watch) -> None:
        self.inner.unwatch_nodes(getattr(watch, "_inner", watch))

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        if self.injector.take_bind_fault():
            raise InjectedBindError(
                f"injected bind failure for {namespace}/{name} -> {node_name}"
            )
        self.inner.bind_pod(namespace, name, node_name)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.inner.delete_pod(namespace, name)

    def __getattr__(self, name: str):
        # Mutators and registries (create_pod, add_node, pods, ...) pass
        # straight through to the wrapped kube.
        return getattr(self.inner, name)


# ------------------------------------------------------------------ RPC seam


def wrap_stubs(stubs, injector: FaultInjector):
    """Wrap a client's stub namespace so armed RPC faults fire inside the
    client's own deadline/retry machinery."""
    import types

    ns = types.SimpleNamespace()
    for name in vars(stubs):
        inner = getattr(stubs, name)

        def call(request, timeout=None, *, _name=name, _inner=inner):
            injector.before_rpc(_name)
            response = _inner(request, timeout=timeout)
            return injector.after_rpc(_name, response)

        setattr(ns, name, call)
    return ns


def chaotic_client(address: str, injector: FaultInjector, **kw):
    """A real ``FirmamentClient`` with fault-wrapped stubs: its retry,
    backoff, and deadline hardening runs against the injected faults."""
    from poseidon_tpu_torch.service.client import FirmamentClient

    client = FirmamentClient(address, **kw)
    client._stubs = wrap_stubs(client._stubs, injector)
    return client

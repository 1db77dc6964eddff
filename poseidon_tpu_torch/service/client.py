"""Typed client wrapper for the FirmamentScheduler service.

Mirrors the reference's Go wrapper semantics (pkg/firmament/firmament_client.go:29-221):
one method per RPC, and *fatal* treatment of reply enums the client never
expects in a healthy system (NOT_FOUND on lifecycle RPCs, etc.) — here a
raised ``FatalReplyError`` instead of ``glog.Fatalf`` so callers decide
whether to die (the glue process does, matching the reference's posture).

On top of the reference's semantics, every RPC carries a deadline and a
bounded retry with exponential backoff + jitter (the reference has
neither: a wedged Firmament hangs its client forever).  Retry policy is
code-aware:

- lifecycle RPCs retry UNAVAILABLE and DEADLINE_EXCEEDED: they are
  idempotent by contract (ALREADY_SUBMITTED / ALREADY_EXISTS are
  tolerated replies — the restart re-play path depends on it);
- ``Schedule()`` retries UNAVAILABLE only.  A deadline on Schedule is
  ambiguous — the service may have committed the round and lost the
  reply — and a blind retry would return the *diff* against the already
  committed state, silently dropping the lost deltas.  The caller
  (glue/poseidon.py) owns that case via its suspect reconciler.

The channel raises gRPC's 4 MB default receive limit to
``MAX_RECEIVE_BYTES``: a 100k-pod wave's SchedulingDeltas reply is larger
than 4 MB.  (The JAX package's client keeps the default, so its glue
cannot receive such a wave; it is only driven at a few dozen machines.)
"""

from __future__ import annotations

import random
import time
from typing import FrozenSet, List, Optional

import grpc

from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.protos.services import (
    FIRMAMENT_METHODS,
    FIRMAMENT_SERVICE,
    make_stubs,
)


class FatalReplyError(RuntimeError):
    """A reply enum the reference client treats as fatal (firmament_client.go:44-50)."""

    def __init__(self, rpc: str, reply: int) -> None:
        super().__init__(f"{rpc}: fatal reply {reply}")
        self.rpc = rpc
        self.reply = reply


# Acceptable replies per RPC; anything else is fatal.  TASK_ALREADY_SUBMITTED
# and NODE_ALREADY_EXISTS are tolerated on submit/add because a restarted
# Poseidon re-plays the world from list+watch (SURVEY.md section 5,
# firmament_scheduler.proto:118,128).
_OK = {
    "TaskSubmitted": {fpb.TASK_SUBMITTED_OK, fpb.TASK_ALREADY_SUBMITTED},
    "TaskCompleted": {fpb.TASK_COMPLETED_OK},
    "TaskFailed": {fpb.TASK_FAILED_OK},
    "TaskRemoved": {fpb.TASK_REMOVED_OK},
    "TaskUpdated": {fpb.TASK_UPDATED_OK},
    "NodeAdded": {fpb.NODE_ADDED_OK, fpb.NODE_ALREADY_EXISTS},
    "NodeFailed": {fpb.NODE_FAILED_OK},
    "NodeRemoved": {fpb.NODE_REMOVED_OK},
    "NodeUpdated": {fpb.NODE_UPDATED_OK},
    "AddTaskStats": None,  # stats for unknown entities are dropped, not fatal
    "AddNodeStats": None,
}

# Receive limit of the client's channel: room for a 100k-pod wave's
# SchedulingDeltas (~5 MB at 100k PLACE deltas) with headroom.
MAX_RECEIVE_BYTES = 256 << 20

# Transient transport failures worth absorbing with a retry.
_RETRYABLE: FrozenSet[grpc.StatusCode] = frozenset(
    (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)
)
_SCHEDULE_RETRYABLE: FrozenSet[grpc.StatusCode] = frozenset(
    (grpc.StatusCode.UNAVAILABLE,)
)


def rpc_code(e: BaseException) -> Optional[grpc.StatusCode]:
    """The status code of an RpcError, or None when it carries none
    (grpc.RpcError itself guarantees nothing; channel errors do)."""
    code = getattr(e, "code", None)
    if callable(code):
        try:
            return code()
        except Exception:  # noqa: BLE001 - a broken error object is codeless
            return None
    return None


class FirmamentClient:
    """Insecure-channel client, one typed method per RPC, with per-RPC
    deadlines and code-aware bounded retry."""

    def __init__(
        self,
        address: str,
        *,
        rpc_timeout_s: float = 30.0,
        rpc_retries: int = 3,
        rpc_backoff_s: float = 0.05,
        rpc_backoff_max_s: float = 2.0,
        retry_seed: int = 0,
    ) -> None:
        self._channel = grpc.insecure_channel(
            address,
            options=[("grpc.max_receive_message_length", MAX_RECEIVE_BYTES)],
        )
        self._stubs = make_stubs(
            self._channel, FIRMAMENT_SERVICE, FIRMAMENT_METHODS
        )
        self.rpc_timeout_s = rpc_timeout_s
        self.rpc_retries = rpc_retries
        self.rpc_backoff_s = rpc_backoff_s
        self.rpc_backoff_max_s = rpc_backoff_max_s
        # Seeded jitter: chaos soaks re-run bit-for-bit; a production
        # fleet should pass distinct seeds (or live with per-process
        # phase alignment — the backoff base still decorrelates rounds).
        self._jitter = random.Random(retry_seed)
        # Whether the last successful schedule() burned a retry (its
        # absorbed UNAVAILABLE may have been post-commit; see schedule).
        self.schedule_retried = False

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "FirmamentClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check(self, rpc: str, reply: int) -> int:
        ok = _OK[rpc]
        if ok is not None and reply not in ok:
            raise FatalReplyError(rpc, reply)
        return reply

    def _invoke(
        self,
        rpc: str,
        request,
        retry_codes: FrozenSet[grpc.StatusCode] = _RETRYABLE,
        attempts_out: Optional[list] = None,
    ):
        """One RPC with a deadline and bounded, jittered, code-aware
        retry.  Non-retryable codes (and exhausted budgets) propagate the
        original error.  ``attempts_out``, when given, receives the
        number of retries a successful call burned (callers that must
        distinguish a clean first-try success from a retried one —
        ``schedule()``'s commit-ambiguity accounting)."""
        stub = getattr(self._stubs, rpc)
        attempt = 0
        while True:
            # One span per ATTEMPT (not per logical call): a retried RPC
            # shows as adjacent spans whose code/backoff attributes
            # reconstruct the retry ladder on the timeline.
            with obs_trace.span(f"rpc.{rpc}", attempt=attempt) as sp:
                obs_metrics.rpc_attempt(rpc)
                try:
                    response = stub(
                        request, timeout=self.rpc_timeout_s or None
                    )
                    if attempts_out is not None:
                        attempts_out.append(attempt)
                    return response
                except grpc.RpcError as e:
                    code = rpc_code(e)
                    code_name = code.name if code is not None else "UNKNOWN"
                    retrying = (
                        attempt < self.rpc_retries and code in retry_codes
                    )
                    sp.set(code=code_name, retrying=retrying)
                    obs_metrics.rpc_error(rpc, code_name, retried=retrying)
                    if not retrying:
                        raise
                    delay = min(
                        self.rpc_backoff_s * (2 ** attempt),
                        self.rpc_backoff_max_s,
                    )
                    sp.set(backoff_s=round(delay, 4))
            # Full jitter on [delay/2, delay]: decorrelates a fleet
            # of clients hammering a recovering service.  (The sleep
            # sits OUTSIDE the attempt span: backoff is idle time, not
            # RPC time.)
            time.sleep(delay * (0.5 + 0.5 * self._jitter.random()))
            attempt += 1

    # ------------------------------------------------------------------ RPCs

    def schedule(self) -> List[fpb.SchedulingDelta]:
        # UNAVAILABLE only: a deadline here is commit-ambiguous (see the
        # module docstring); the glue's suspect reconciler owns it.
        # A retried-then-successful call is flagged on
        # ``schedule_retried``: over a real network UNAVAILABLE can also
        # surface AFTER the server processed the request (reply lost
        # mid-stream), in which case the retry silently returned the
        # diff against the already-committed round — the caller must
        # treat the window as suspect.  (An UNAVAILABLE that exhausts
        # every attempt still raises and is treated as pre-commit: gRPC
        # semantics for a request the service never answered.)
        attempts: list = []
        reply = self._invoke(
            "Schedule", fpb.ScheduleRequest(),
            retry_codes=_SCHEDULE_RETRYABLE, attempts_out=attempts,
        )
        self.schedule_retried = bool(attempts and attempts[0] > 0)
        return list(reply.deltas)

    def task_submitted(
        self, td: fpb.TaskDescriptor, jd: Optional[fpb.JobDescriptor] = None
    ) -> int:
        req = fpb.TaskDescription(task_descriptor=td)
        if jd is not None:
            req.job_descriptor.CopyFrom(jd)
        return self._check(
            "TaskSubmitted", self._invoke("TaskSubmitted", req).type
        )

    def task_completed(self, uid: int) -> int:
        return self._check(
            "TaskCompleted",
            self._invoke("TaskCompleted", fpb.TaskUID(task_uid=uid)).type,
        )

    def task_failed(self, uid: int) -> int:
        return self._check(
            "TaskFailed",
            self._invoke("TaskFailed", fpb.TaskUID(task_uid=uid)).type,
        )

    def task_removed(self, uid: int) -> int:
        return self._check(
            "TaskRemoved",
            self._invoke("TaskRemoved", fpb.TaskUID(task_uid=uid)).type,
        )

    def task_updated(
        self, td: fpb.TaskDescriptor, jd: Optional[fpb.JobDescriptor] = None
    ) -> int:
        req = fpb.TaskDescription(task_descriptor=td)
        if jd is not None:
            req.job_descriptor.CopyFrom(jd)
        return self._check("TaskUpdated", self._invoke("TaskUpdated", req).type)

    def node_added(self, rtnd: fpb.ResourceTopologyNodeDescriptor) -> int:
        return self._check("NodeAdded", self._invoke("NodeAdded", rtnd).type)

    def node_failed(self, uuid: str) -> int:
        return self._check(
            "NodeFailed",
            self._invoke(
                "NodeFailed", fpb.ResourceUID(resource_uid=uuid)
            ).type,
        )

    def node_removed(self, uuid: str) -> int:
        return self._check(
            "NodeRemoved",
            self._invoke(
                "NodeRemoved", fpb.ResourceUID(resource_uid=uuid)
            ).type,
        )

    def node_updated(self, rtnd: fpb.ResourceTopologyNodeDescriptor) -> int:
        return self._check(
            "NodeUpdated", self._invoke("NodeUpdated", rtnd).type
        )

    def add_task_stats(self, stats: fpb.TaskStats) -> int:
        return self._invoke("AddTaskStats", stats).type

    def add_node_stats(self, stats: fpb.ResourceStats) -> int:
        return self._invoke("AddNodeStats", stats).type

    def check(self) -> int:
        # No internal retry: the start-gate poll loop IS the retry, and
        # stacking one inside the other would multiply the wait.
        return self._invoke(
            "Check", fpb.HealthCheckRequest(), retry_codes=frozenset()
        ).status

    # -------------------------------------------------------------- start gate

    def wait_for_service(
        self, timeout: float = 600.0, poll_interval: float = 2.0
    ) -> bool:
        """Poll Check() until SERVING (poseidon.go:75-88: 2s x <=10min).

        The final sleep is clamped to the time remaining — the old loop
        slept a full ``poll_interval`` past its deadline, which at the
        reference's 2 s interval stretched short health gates by up to
        2 s each.  Code-aware: UNAVAILABLE / DEADLINE_EXCEEDED mean "not
        up yet, keep polling"; any other RpcError code (UNIMPLEMENTED,
        INVALID_ARGUMENT, ...) means the thing answering is not a
        Firmament and polling harder will not fix it — raise."""
        deadline = time.monotonic() + timeout
        # Each probe carries its own bounded deadline (>= the poll
        # interval, <= the configured RPC deadline): a black-holed
        # address must cost one clamped probe, not a full rpc_timeout_s,
        # per poll.
        probe_timeout = min(self.rpc_timeout_s or 5.0,
                            max(poll_interval, 0.1))
        while True:
            try:
                status = self._stubs.Check(
                    fpb.HealthCheckRequest(), timeout=probe_timeout
                ).status
                if status == fpb.SERVING:
                    return True
            except grpc.RpcError as e:
                if rpc_code(e) not in _RETRYABLE:
                    raise
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(poll_interval, remaining))

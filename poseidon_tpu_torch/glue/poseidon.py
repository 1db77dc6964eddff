"""The Poseidon glue process: schedule loop + watchers + stats server.

Re-creates the reference entry point (cmd/poseidon/poseidon.go:32-103):
connect to Firmament, gate on its health check, then run three concurrent
families — the schedule loop (Schedule() -> enact deltas), the stats
server, and the pod/node watchers.

Delta enactment (poseidon.go:36-67): PLACE binds the pod to the node;
PREEMPT and MIGRATE delete the pod (K8s has no native preemption — the
owning controller resubmits, and a MIGRATEd pod's replacement lands on the
new node next round); NOOP is skipped.  Unknown task/resource ids in a
delta are fatal in the reference (poseidon.go:43); here they raise.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent import futures as cf
from dataclasses import dataclass
from typing import List, Optional

import grpc

from poseidon_tpu_torch.glue.fake_kube import KubeAPI
from poseidon_tpu_torch.glue.nodewatcher import NodeWatcher
from poseidon_tpu_torch.glue.podwatcher import PodWatcher
from poseidon_tpu_torch.glue.stats_server import StatsServer
from poseidon_tpu_torch.glue.types import SharedState
from poseidon_tpu_torch.obs import metrics as obs_metrics
from poseidon_tpu_torch.obs import trace as obs_trace
from poseidon_tpu_torch.protos import firmament_pb2 as fpb
from poseidon_tpu_torch.service.client import FirmamentClient, rpc_code
from poseidon_tpu_torch.utils.config import PoseidonConfig
from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_float
from poseidon_tpu_torch.utils.locks import TrackedLock

log = logging.getLogger("poseidon")


@dataclass
class LoopStats:
    rounds: int = 0
    placed: int = 0
    preempted: int = 0
    migrated: int = 0
    # Hardening counters (the chaos soak's observability surface):
    # rounds that raised, the running consecutive-failure count feeding
    # the crash-loop budget, PLACE enactments the API server rejected
    # (each rolled back + requeued), and tasks requeued — by the bind
    # rollback or by the suspect reconciler after a commit-ambiguous
    # Schedule failure.
    failed_rounds: int = 0
    consecutive_failures: int = 0
    bind_failures: int = 0
    requeued: int = 0


class Poseidon:
    """One glue process; ``start()`` spawns the goroutine families."""

    def __init__(
        self,
        kube: KubeAPI,
        config: Optional[PoseidonConfig] = None,
        firmament: Optional[FirmamentClient] = None,
        stats_address: Optional[str] = None,
        metrics_address: Optional[str] = None,
        run_loop: bool = True,
    ) -> None:
        # run_loop=False: callers drive rounds via schedule_once() — the
        # deterministic mode for tests/replay (the background loop fires
        # immediately on start, racing explicit rounds otherwise).
        self.run_loop = run_loop
        self.config = config or PoseidonConfig()
        self.kube = kube
        self.fc = firmament or FirmamentClient(
            self.config.firmament_address,
            rpc_timeout_s=self.config.rpc_timeout_s,
            rpc_retries=self.config.rpc_retries,
            rpc_backoff_s=self.config.rpc_backoff_s,
        )
        self.shared = SharedState()
        # Watchers own a second client connection in the reference
        # (k8sclient.go:74); one python client object is thread-safe here.
        self.pod_watcher = PodWatcher(
            kube, self.fc, self.shared,
            scheduler_name=self.config.scheduler_name,
        )
        self.node_watcher = NodeWatcher(kube, self.fc, self.shared)
        self.stats_server: Optional[StatsServer] = None
        if stats_address is not None:
            self.stats_server = StatsServer(
                self.shared, self.fc, address=stats_address
            )
        # Prometheus exporter (obs/metrics.py): the scrape endpoint the
        # deploy manifest annotates.  Explicit arg wins; else the config
        # field (empty = disabled, the test-harness default).
        self.metrics_server: Optional[obs_metrics.MetricsServer] = None
        metrics_address = metrics_address or getattr(
            self.config, "metrics_address", ""
        ) or None
        if metrics_address is not None:
            self.metrics_server = obs_metrics.MetricsServer(metrics_address)
        self.loop_stats = LoopStats()
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        # Crash-loop hardening state: the fatal-stop reason once the
        # budget is exhausted (None while healthy), seeded jitter for the
        # failure backoff (seeded: chaos soaks re-run bit-for-bit).
        self.fatal: Optional[str] = None
        self._backoff_jitter = random.Random(0)
        # Suspect-reconciler state: glue's own record of enacted
        # placements (uid -> node), and whether the last Schedule()
        # attempt failed in flight — the commit-ambiguous window in
        # which the service may hold placements whose deltas were lost.
        self._enacted: dict = {}
        self._schedule_suspect = False
        # Suspicion generation: bumped on every _mark_suspect.  The
        # streaming enact worker clears the flag only if the generation
        # it captured at submit is still current — new suspicion raised
        # concurrently (a schedule RPC failing mid-enact) survives.
        self._suspect_gen = 0
        # Half-completed rollbacks: uid -> (td, jd) whose task_removed
        # landed but whose resubmit RPC failed (replayed every round).
        self._resubmit_pending: dict = {}
        # Guards the glue state that BOTH the round thread and the
        # streaming enact worker mutate: the resubmit-pending map and
        # the suspect flag/generation.  Held only around dict/flag
        # writes, never across an RPC.  Synchronous mode takes it
        # uncontended on the one round thread.
        self._state_lock = TrackedLock("glue.Poseidon._state_lock")
        # Streaming round engine (POSEIDON_STREAMING): the single-worker
        # enactment executor and the in-flight round's future.  With the
        # hatch off neither is ever created and schedule_once runs the
        # round-synchronous path bit-identically.
        self._enact_pool: Optional[cf.ThreadPoolExecutor] = None
        self._enact_future: Optional[cf.Future] = None
        # Sustained-throughput gauge state: placements/sec over the
        # window since the previous metrics observation.
        self.placements_per_sec = 0.0
        self._pps_t: Optional[float] = None
        self._pps_placed = 0
        # Last successful round's deltas (the flight recorder's view).
        self.last_deltas: List[fpb.SchedulingDelta] = []

    # --------------------------------------------------------------- lifecycle

    def start(self, health_timeout: float = 600.0) -> "Poseidon":
        if not self.fc.wait_for_service(
            timeout=health_timeout, poll_interval=0.1
        ):
            raise RuntimeError("firmament service never became healthy")
        if self.stats_server is not None:
            self.stats_server.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
            log.info("metrics server on %s", self.metrics_server.address)
        self.node_watcher.run()
        # Initial node sync before pods start flowing (the informer
        # cache-sync ordering): a re-listed bound pod resolves its node's
        # resource uuid through SharedState, which must be populated first.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and len(self.node_watcher.queue):
            time.sleep(0.01)
        self.pod_watcher.run()
        if self.run_loop:
            self._loop_thread = threading.Thread(
                target=self._loop, name="schedule-loop", daemon=True
            )
            self._loop_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
        # Quiesce the streaming engine AFTER the loop thread (it is the
        # only submitter): join the in-flight enactment so no worker
        # races the watcher/server teardown below.
        try:
            self._join_enact()
        except Exception:  # noqa: BLE001 - shutdown path
            log.exception("in-flight enactment failed during stop")
        if self._enact_pool is not None:
            self._enact_pool.shutdown(wait=True)
        self.pod_watcher.stop()
        self.node_watcher.stop()
        if self.stats_server is not None:
            self.stats_server.stop()
        if self.metrics_server is not None:
            self.metrics_server.stop()

    def __enter__(self) -> "Poseidon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ the hot loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            delay = self.try_round()
            if delay is None:
                return  # crash-loop budget exhausted; try_round stopped us
            self._stop.wait(delay)

    def try_round(self) -> Optional[float]:
        """One loop iteration's round + failure policy.

        Returns the delay before the next round: the scheduling interval
        after a healthy round, an exponentially-backed-off (jittered)
        retry delay after a failed one, or ``None`` once the crash-loop
        budget is exhausted — the loop then stops FATALLY with
        ``self.fatal`` set, instead of the old unbounded
        log-and-spin-on-the-interval swallow.  Factored out of ``_loop``
        so the soak harness drives the exact production failure policy
        without a thread."""
        try:
            with obs_trace.span("glue.try_round") as sp:
                self.schedule_once()
                sp.set(deltas=len(self.last_deltas))
        except Exception:
            self.loop_stats.failed_rounds += 1
            self.loop_stats.consecutive_failures += 1
            n = self.loop_stats.consecutive_failures
            log.exception(
                "schedule round failed (consecutive failure %d/%d)",
                n, self.config.crash_loop_budget,
            )
            if n >= self.config.crash_loop_budget:
                self.fatal = (
                    f"schedule loop stopping: {n} consecutive round "
                    f"failures exhausted the crash-loop budget "
                    f"({self.config.crash_loop_budget})"
                )
                log.error("%s", self.fatal)
                self._stop.set()
                self._observe_metrics()
                return None
            backoff = min(
                self.config.crash_backoff_s * (2 ** (n - 1)),
                self.config.crash_backoff_max_s,
            )
            self._observe_metrics()
            # Full jitter on [backoff/2, backoff].
            return backoff * (0.5 + 0.5 * self._backoff_jitter.random())
        self.loop_stats.consecutive_failures = 0
        self._observe_metrics()
        delay = self.config.scheduling_interval
        if hatch_bool("POSEIDON_STREAMING"):
            # The bounded-staleness deadline IS the streaming cadence:
            # cut the next round's admission no later than the staleness
            # bound, even when the configured interval is longer.
            delay = min(
                delay, hatch_float("POSEIDON_ADMISSION_STALENESS_S")
            )
        return delay

    def _observe_metrics(self) -> None:
        """Refresh the Prometheus registry from the loop's state (every
        round outcome, success or failure — the exporter thread only
        reads)."""
        # Sustained throughput over the window since the last
        # observation.  In streaming mode placed is bumped by the enact
        # worker concurrently — a torn read here skews one gauge sample,
        # never the stats themselves.
        now = time.monotonic()
        placed = self.loop_stats.placed
        if self._pps_t is not None and now > self._pps_t:
            self.placements_per_sec = (
                (placed - self._pps_placed) / (now - self._pps_t)
            )
        self._pps_t = now
        self._pps_placed = placed
        ages = [
            a for a in (
                self.pod_watcher.queue.oldest_age_s(),
                self.node_watcher.queue.oldest_age_s(),
            ) if a is not None
        ]
        obs_metrics.observe_loop(
            self.loop_stats,
            resyncs=(
                self.pod_watcher.resyncs + self.node_watcher.resyncs
            ),
            crash_loop_budget=self.config.crash_loop_budget,
            fatal=self.fatal is not None,
            placements_per_sec=self.placements_per_sec,
            ingest_lag_s=max(ages) if ages else 0.0,
        )
        obs_metrics.observe_ledger()

    def schedule_once(self) -> List[fpb.SchedulingDelta]:
        """One Schedule() call + transactional delta enactment
        (poseidon.go:32-67).

        Enactment is per-delta transactional: a PLACE whose bind the API
        server rejects is ROLLED BACK on the scheduler (task_removed +
        task_submitted requeues the pod as runnable, freeing the
        reservation) instead of leaving the scheduler's view diverged
        from the kube truth, and the remaining deltas still enact.
        Unknown ids stay fatal (poseidon.go:43) — they mean the id maps
        themselves are broken, which no retry fixes.

        POSEIDON_STREAMING=1 switches to the streaming round engine:
        this round's Schedule() RPC overlaps the PREVIOUS round's
        enactment (running on a single-worker executor), and the new
        round's enactment is handed to that worker in turn.  With the
        hatch off (default) the synchronous path below runs — schedule,
        enact, reconcile, GC, in program order on the round thread,
        bit-identical to the pre-streaming loop."""
        if hatch_bool("POSEIDON_STREAMING"):
            return self._schedule_once_streaming()
        # Round-thread confinement: only the thread driving try_round
        # (the loop thread, or the soak's main thread with
        # run_loop=False) writes last_deltas/_enacted; readers consume
        # AFTER the round returns on that same thread (chaos/soak.py
        # records last_deltas post-try_round), so these publications
        # carry their happens-before in program order.
        self.last_deltas = []  # handoff: round-thread-confined (above)
        with obs_trace.span("glue.flush_resubmits"):
            self._flush_resubmits()
        try:
            with obs_trace.span("glue.schedule_rpc"):
                deltas = self.fc.schedule()
        except Exception as e:
            # Commit-ambiguity is code-aware: UNAVAILABLE means the
            # request was never processed (and the client already
            # retries it), so nothing committed; every other failure —
            # DEADLINE after commit, a codeless channel error, a
            # non-RPC exception — may have run the round and lost the
            # reply.  Mark the window; the next fully-enacted round
            # reconciles (see below).
            if rpc_code(e) != grpc.StatusCode.UNAVAILABLE:
                self._mark_suspect()
            raise
        # Recorded before enactment so a round that fails mid-enactment
        # still attributes THESE deltas (not a previous round's) to
        # itself in the flight trace.
        self.last_deltas = list(deltas)  # handoff: round-thread-confined
        if getattr(self.fc, "schedule_retried", False):
            # The client absorbed an UNAVAILABLE with a retry.  On a
            # real network that code can surface AFTER the service
            # processed the request (reply lost mid-stream), making the
            # retry's reply the diff against an already-committed round
            # — so a retried schedule is commit-ambiguous too.  The
            # sweep is cheap next to a permanent phantom divergence.
            self._mark_suspect()
        suspect = self._schedule_suspect
        gen = self._suspect_gen
        self._enact_phase(deltas, suspect, gen)
        return list(deltas)

    def _schedule_once_streaming(self) -> List[fpb.SchedulingDelta]:
        """The streaming round: overlap this round's Schedule() RPC with
        the previous round's enactment, then hand this round's deltas to
        the enact worker.

        Round order: (1) flush parked resubmits (lock-disciplined — the
        worker may be adding to the map concurrently); (2) Schedule()
        RPC, overlapping enact(N-1) on the worker; (3) JOIN enact(N-1) —
        its failure is surfaced as THIS round's failure, and this
        round's already-committed deltas are dropped un-enacted, so the
        suspect reconciler is armed exactly as for a lost reply;
        (4) submit enact(N) to the worker with the suspect snapshot.
        The worker clears suspicion only if no NEW suspicion arrived
        while it ran (the generation check in _enact_phase)."""
        self.last_deltas = []  # handoff: round-thread-confined — the
        # enact worker receives its deltas by argument, never through
        # this attribute; readers (spans, soak, tests) run on or after
        # the round thread (same discipline as the synchronous path).
        with obs_trace.span("glue.flush_resubmits"):
            self._flush_resubmits()
        try:
            with obs_trace.span("glue.schedule_rpc"):
                deltas = self.fc.schedule()
        except Exception as e:
            if rpc_code(e) != grpc.StatusCode.UNAVAILABLE:
                self._mark_suspect()
            # The in-flight enactment keeps running through the failure
            # backoff; the NEXT round (or drain/stop) joins it.
            raise
        self.last_deltas = list(deltas)  # handoff: round-thread-confined
        if getattr(self.fc, "schedule_retried", False):
            self._mark_suspect()
        try:
            self._join_enact()
        except Exception:
            # enact(N-1) failed AND this round's committed deltas are
            # now dropped un-enacted — both are phantom-placement
            # shapes; arm the reconciler before surfacing.
            self._mark_suspect()
            raise
        suspect = self._schedule_suspect
        gen = self._suspect_gen
        if self._enact_pool is None:
            self._enact_pool = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="enact-worker"
            )
        self._enact_future = self._enact_pool.submit(
            self._enact_phase, deltas, suspect, gen
        )
        return list(deltas)

    def _enact_phase(self, deltas, suspect: bool, gen: int) -> None:
        """The round's enactment tail: enact, reconcile if the round
        opened suspect, GC the enacted map, conditionally clear
        suspicion, count the round.  Runs on the round thread
        synchronously; on the single enact worker under streaming (at
        most one in flight — the next round joins before submitting)."""
        delta_uids = set()
        try:
            with obs_trace.span("glue.enact", deltas=len(deltas)):
                self._enact(deltas, delta_uids)
        except Exception:
            # A mid-enactment abort orphans this round's remaining
            # committed deltas — the same phantom shape as a lost
            # reply.  Arm the reconciler; the next fully-enacted round
            # requeues whatever never got bound.
            self._mark_suspect()
            raise
        if suspect:
            with obs_trace.span("glue.reconcile"):
                self._reconcile_after_failure(delta_uids)
        # Lifecycle GC: placements whose tasks finished or left the
        # cluster (the pod watcher owns those transitions) must leave
        # the enacted map, or it grows one entry per pod ever placed.
        live = self.shared.live_uids()
        self._enacted = {  # handoff: enact-phase-confined
            uid: node for uid, node in self._enacted.items() if uid in live
        }
        # Cleared only here, after enactment AND reconcile completed —
        # and only if no NEW suspicion arrived while this phase ran (a
        # concurrent Schedule() failure under streaming): a round that
        # raises mid-way keeps the flag, so the pending reconcile is
        # retried instead of silently dropped.
        with self._state_lock:
            if self._suspect_gen == gen:
                self._schedule_suspect = False
        self.loop_stats.rounds += 1

    def _mark_suspect(self) -> None:
        """Open (or re-open) the commit-ambiguity window; the bumped
        generation keeps a concurrent enact phase from clearing it."""
        with self._state_lock:
            self._schedule_suspect = True
            self._suspect_gen += 1

    def _join_enact(self) -> None:
        """Consume the in-flight enactment's outcome (streaming); no-op
        when nothing is in flight (synchronous mode always)."""
        fut = self._enact_future
        if fut is None:
            return
        self._enact_future = None
        with obs_trace.span("glue.enact_join"):
            fut.result()

    def drain_rounds(self, timeout: float = 30.0) -> bool:
        """Wait for the in-flight enactment WITHOUT consuming its
        outcome — the next round's join still surfaces a failure to the
        loop's failure policy.  The soak harness calls this after every
        try_round so its per-round kube-truth gates see a quiesced
        engine; a no-op in synchronous mode."""
        fut = self._enact_future
        if fut is None:
            return True
        done, _ = cf.wait([fut], timeout=timeout)
        return bool(done)

    def enact_failed(self) -> bool:
        """True when a drained-but-unconsumed streaming enactment
        failed; that failure surfaces at the next round's join.  Lets
        round-by-round callers (the soak) keep retrying until a round
        both scheduled AND enacted cleanly."""
        fut = self._enact_future
        return bool(
            fut is not None and fut.done()
            and fut.exception() is not None
        )

    def _enact(self, deltas, delta_uids: set) -> None:
        """Apply one round's deltas to the cluster (transactional per
        delta; see ``schedule_once``)."""
        for delta in deltas:
            delta_uids.add(delta.task_id)
            if delta.type == fpb.SchedulingDelta.PLACE:
                pod = self.shared.task_for_uid(delta.task_id)
                node = self.shared.node_for_resource(delta.resource_id)
                if pod is None or node is None:
                    raise RuntimeError(
                        f"PLACE delta references unknown ids: {delta}"
                    )
                try:
                    self.kube.bind_pod(pod.namespace, pod.name, node)
                except Exception as e:  # noqa: BLE001 - per-delta rollback
                    log.warning(
                        "PLACE %s -> %s failed (%s); rolling back and "
                        "requeueing", pod.key, node, e,
                    )
                    self.loop_stats.bind_failures += 1
                    self._requeue_task(delta.task_id)
                    continue
                self._enacted[delta.task_id] = node
                self.loop_stats.placed += 1
            elif delta.type in (
                fpb.SchedulingDelta.PREEMPT,
                fpb.SchedulingDelta.MIGRATE,
            ):
                pod = self.shared.task_for_uid(delta.task_id)
                if pod is None:
                    raise RuntimeError(
                        f"PREEMPT/MIGRATE delta references unknown task: {delta}"
                    )
                try:
                    self.kube.delete_pod(pod.namespace, pod.name)
                except KeyError:
                    # Already gone (deleted out from under us): the
                    # watcher's DELETED event hands TaskRemoved to the
                    # scheduler; the enactment's intent already holds.
                    log.warning(
                        "PREEMPT/MIGRATE delete of %s: pod already gone",
                        pod.key,
                    )
                self._enacted.pop(delta.task_id, None)
                if delta.type == fpb.SchedulingDelta.PREEMPT:
                    self.loop_stats.preempted += 1
                else:
                    self.loop_stats.migrated += 1
            # NOOP: skip (poseidon.go:64).

    # ------------------------------------------------- divergence containment

    def _requeue_task(self, uid: int) -> None:
        """Roll one placement back on the scheduler: remove + resubmit
        re-enters the task RUNNABLE with its reservation freed, so the
        scheduler's view returns to the kube truth (pod Pending) and the
        next round re-places it.  Uses only the existing RPC vocabulary —
        the state machine answers TASK_SUBMITTED_OK because the removal
        landed first."""
        entry = self.shared.get_task(uid)
        if entry is None:
            return
        td = fpb.TaskDescriptor()
        td.CopyFrom(entry.descriptor)
        td.scheduled_to_resource = ""  # requeue as unbound
        jd = fpb.JobDescriptor(
            uuid=td.job_id, name=entry.pod.owner_uid or entry.pod.key
        )
        self.fc.task_removed(uid)
        self._enacted.pop(uid, None)
        try:
            self.fc.task_submitted(td, jd)
        except Exception:
            # Half rolled back: removed server-side, resubmit lost.
            # Left alone the task would exist NOWHERE and the pod would
            # pend forever — park the descriptor; _flush_resubmits
            # replays it at the top of every round until it lands.  The
            # raise fails this round, so the crash-loop budget governs
            # the retry cadence.  Lock: under streaming this runs on the
            # enact worker while the round thread may be flushing.
            with self._state_lock:
                self._resubmit_pending[uid] = (td, jd)
            raise
        self.loop_stats.requeued += 1

    def _flush_resubmits(self) -> None:
        """Finish half-completed rollbacks (see ``_requeue_task``):
        replay parked resubmits until each lands or its pod left the
        cluster.  TASK_SUBMITTED_OK / ALREADY_SUBMITTED are both
        tolerated replies, so a replay that raced a watcher resubmit is
        harmless.  The map is snapshotted and pruned under the state
        lock (the streaming enact worker parks entries concurrently);
        the RPCs themselves run outside it."""
        with self._state_lock:
            pending = sorted(self._resubmit_pending.items())
        for uid, (td, jd) in pending:
            if self.shared.get_task(uid) is None:
                with self._state_lock:
                    self._resubmit_pending.pop(uid, None)
                continue  # pod left the cluster
            self.fc.task_submitted(td, jd)
            with self._state_lock:
                self._resubmit_pending.pop(uid, None)
            self.loop_stats.requeued += 1

    def _reconcile_after_failure(self, delta_uids) -> None:
        """Heal the commit-ambiguity window after a failed Schedule()
        call (the suspect flag): if that call's round committed on the
        service but its reply was lost, the service holds placements
        whose PLACE deltas no one enacted — the pods sit Pending in kube
        forever while the scheduler believes them running.

        Candidates: tracked, non-finished tasks that (a) glue never
        enacted a placement for, (b) got no delta in THIS round either,
        and (c) did not arrive already-bound (the glue-restart adoption
        path).  Requeueing them (remove + resubmit) is idempotent kube-
        truth re-assertion: a phantom placement is freed and re-placed
        next round; a genuinely pending pod just re-enters the queue.
        Runs only in rounds following a commit-ambiguous Schedule
        failure, until one fully enacts (the suspect flag survives a
        round that raises mid-enactment) — never in steady state, so
        the wait-fairness escalator is undisturbed."""
        healed = 0
        for uid, pod in sorted(self.shared.live_uids().items()):
            if uid in delta_uids or uid in self._enacted:
                continue
            if pod.node_name:
                continue  # adopted pre-bound on restart; not ours to touch
            self._requeue_task(uid)
            healed += 1
        if healed:
            log.warning(
                "post-failure reconcile requeued %d possibly-phantom "
                "placements", healed,
            )

    # -------------------------------------------------------------- test hooks

    def drain_watchers(self, timeout: float = 5.0) -> bool:
        """Wait until both work queues are empty (integration-test barrier)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.pod_watcher.queue) == 0 and \
               len(self.node_watcher.queue) == 0:
                # One extra beat for in-flight worker batches.
                time.sleep(0.05)
                if len(self.pod_watcher.queue) == 0 and \
                   len(self.node_watcher.queue) == 0:
                    return True
            time.sleep(0.01)
        return False

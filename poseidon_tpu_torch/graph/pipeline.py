"""Cross-band cost-build pipelining: overlap band k+1's mask/cost build
with band k's solve (the PyTorch/CUDA port of
``poseidon_tpu/graph/pipeline.py``).

The band ladder is serialized by a real data dependence — band k+1's
cost plane prices machines at the usage band k commits — so its stages
cannot simply run concurrently.  The delta-maintained plane cache
(costmodel/delta.py) dissolves the dependence: a SPECULATIVE build of
band k+1 against the pre-commit usage runs on a worker thread while
band k's solve occupies the device / the host certificates, and the
AUTHORITATIVE build afterwards is an incremental patch that rebuilds
exactly the columns band k's flows touched (their usage arrays diff
dirty).  Wrong speculation is therefore never wrong-RESULT — at worst
the worker warmed the cache with rows the regrouped band no longer
contains, and the authoritative diff rebuilds them.

Concurrency discipline: one single-worker executor; the worker runs ONLY
``cache.build`` — host numpy, never a CUDA call, so the device stream's
order stays the main thread's — on tables frozen by the submitting
thread (usage arrays copied at submit time).  The authoritative build
joins the outstanding future (``_join`` under ``_lock``) and then runs
on the calling thread with the lock released, so cache mutations are
strictly serialized and the pipeline's lock is never held by a thread
inside the cache.  Spans opened on the worker carry an explicit
cross-thread parent (the round span), giving the overlap its own
Perfetto lane.
"""

from __future__ import annotations

import time
from typing import Optional

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.utils.hatches import hatch_bool
from poseidon_tpu_torch.utils.locks import TrackedLock

ENV_GATE = "POSEIDON_PIPELINE_BANDS"


def pipelining_enabled() -> bool:
    return hatch_bool(ENV_GATE)


class _Spec:
    """One speculative build's bookkeeping (wall window + outcome)."""

    __slots__ = ("key", "start", "end", "error")

    def __init__(self, key: int) -> None:
        self.key = key
        self.start = 0.0
        self.end = 0.0
        self.error: Optional[BaseException] = None


class CostPipeline:
    """Planner-lifetime speculative builder over one CostPlaneCache."""

    def __init__(self, cache) -> None:
        self._cache = cache
        self._lock = TrackedLock("graph.CostPipeline._lock")
        self._pool = None
        self._future = None
        self._spec: Optional[_Spec] = None

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # A single worker: cache mutations stay strictly serialized
            # (the pipelining contract — overlap with the SOLVE, never
            # with another build).
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="poseidon-costbuild"
            )
        return self._pool

    def _join(self) -> None:
        """Wait out the outstanding speculative build, if any.  Worker
        errors are swallowed here on purpose: a failed speculation must
        not fail the round — the authoritative build recomputes through
        the same model and raises for real if the inputs are bad."""
        fut = self._future
        if fut is None:
            return
        try:
            # The join under _lock IS the pipelining contract: every
            # cache touch serializes behind the outstanding speculative
            # build (single worker) — an unlocked join would let a fetch
            # read a half-built plane.
            fut.result()  # posecheck: ignore[blocking-under-lock]
        except Exception:  # noqa: BLE001 - speculative; authoritative re-runs
            pass
        self._future = None

    # ------------------------------------------------------------------- API

    def speculate(self, key: int, ecs_b, mt_b,
                  parent_span_id: Optional[int] = None) -> None:
        """Kick the worker at band k+1's plane.  ``ecs_b``/``mt_b`` must
        be frozen (the caller copies the usage arrays before submitting
        — the live committed arrays keep mutating on the main thread)."""
        with self._lock:
            self._join()
            spec = _Spec(key)
            self._spec = spec
            cache = self._cache

            def work():
                spec.start = time.perf_counter()
                try:
                    with _trace.span(
                        "round.cost_build_spec", parent=parent_span_id,
                        band=key,
                    ):
                        cache.build(key, ecs_b, mt_b)
                except BaseException as e:  # noqa: BLE001 - recorded, not raised
                    spec.error = e
                finally:
                    spec.end = time.perf_counter()

            self._future = self._ensure_pool().submit(work)

    def build(self, key: int, ecs_b, mt_b):
        """The authoritative build: joins the outstanding speculation
        under the lock, then patches the plane on the calling thread
        outside it.  Returns ``(cm, stats)``.

        Builds stay serialized without the lock: only the calling thread
        submits speculations, and it is here, so after the join no build
        is in flight until it speculates again.  The reference builds
        under this lock, so a warm round's delta build (the hints are
        read only there) nests the cache's ingest lock inside it for the
        first time, which its warm-round lock-order gate fails (ROADMAP
        §C); released first, the two locks never nest."""
        with self._lock:
            self._join()
        cm = self._cache.build(key, ecs_b, mt_b)
        return cm, self._cache.last_stats

    def overlap_with(self, window_start: float, window_end: float) -> float:
        """Seconds the last speculative build ran inside [window_start,
        window_end] — the round's realized pipeline overlap.  A build
        still running at the window's close overlapped it through the
        close (its final ``end`` lies beyond the window either way)."""
        with self._lock:
            spec = self._spec
            if spec is None or spec.start == 0.0:
                return 0.0  # never started inside the window
            end = spec.end if spec.end > 0.0 else window_end
            lo = max(spec.start, window_start)
            hi = min(end, window_end)
            return max(0.0, hi - lo)

    def drain(self) -> None:
        with self._lock:
            self._join()
            self._spec = None

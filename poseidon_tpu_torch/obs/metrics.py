"""Metrics registry + Prometheus text exposition + tiny HTTP exporter.

The deploy manifests' scrape story finally has a server behind it: a
process-wide :class:`Registry` of counters/gauges/histograms, rendered
in the Prometheus text exposition format (version 0.0.4) and served by
:class:`MetricsServer` — a stdlib ``ThreadingHTTPServer`` on its own
daemon thread (``/metrics`` + ``/healthz``), no dependencies.

Feeding is schema-driven, not hand-enumerated: ``observe_round`` walks
``RoundMetrics.to_dict()`` (the single schema-versioned round-metrics
serialization) so every field — present and future — lands as a
``poseidon_round_*`` gauge, with the monotonic per-round counts also
accumulated into ``poseidon_rounds_*_total`` counters and the two
latency fields into histograms.  ``observe_loop`` mirrors the glue
``LoopStats`` + watcher resyncs; the client's retry machinery calls
``rpc_attempt``/``rpc_error`` per attempt; ``observe_ledger`` exposes
the process-wide lock-ledger counters.  Nothing here imports torch: the
glue process runs this module without it.

Thread safety: one registry lock for child creation, one lock per
metric child for updates — the hot paths (a counter bump per RPC) stay
a dict probe + locked float add.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.obs.history import RoundHistory, default_history
from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_float
from poseidon_tpu_torch.utils.locks import TrackedLock

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets (seconds): sub-ms watch events up through the
# multi-minute cold rounds.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _labels_text(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Child:
    """One labelset's state; updates locked per child."""

    __slots__ = ("lock", "value", "bucket_counts", "sum", "count")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.lock = TrackedLock("obs.metrics._Child.lock")
        self.value = 0.0
        if buckets is not None:
            self.bucket_counts = [0] * (len(buckets) + 1)  # + +Inf
            self.sum = 0.0
            self.count = 0


class Metric:
    """Base: a named family of children keyed by label values."""

    type_name = "untyped"

    def __init__(self, name: str, help: str,  # noqa: A002 - prom term
                 labelnames: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = TrackedLock("obs.metrics.Metric._lock")
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self) -> _Child:
        return _Child()

    def labels(self, *values) -> _Child:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def labelsets(self) -> List[Tuple[str, ...]]:
        """Every labelset this family has exported so far."""
        with self._lock:
            return list(self._children)

    def _samples(self) -> Iterable[Tuple[str, str, float]]:
        """(suffix, rendered-labels, value) triples, label-sorted.

        The family lock is held across the WHOLE iteration so one
        exposition is a consistent snapshot: a scrape racing a
        ``set_onehot`` transaction (which writes under the same lock)
        sees the family entirely before or entirely after the flip,
        never mid-flip.  Plain ``set``/``inc`` writers still only take
        the child lock — per-child atomicity, no family guarantee."""
        with self._lock:
            for key, child in sorted(self._children.items()):
                with child.lock:
                    yield ("", _labels_text(self.labelnames, key),
                           child.value)

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.type_name}",
        ]
        for suffix, labels, value in self._samples():
            lines.append(f"{self.name}{suffix}{labels} {_fmt_value(value)}")
        return "\n".join(lines)


class Counter(Metric):
    type_name = "counter"

    def inc(self, amount: float = 1.0, *labelvalues) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        child = self.labels(*labelvalues)
        with child.lock:
            child.value += amount

    def set_total(self, total: float, *labelvalues) -> None:
        """Pin the cumulative value from an external monotonic source
        (LoopStats counters, the compile ledger) that owns monotonicity.
        Regressions are clamped — exposition must never go backwards."""
        child = self.labels(*labelvalues)
        with child.lock:
            if total > child.value:
                child.value = float(total)

    def value(self, *labelvalues) -> float:
        child = self.labels(*labelvalues)
        with child.lock:
            return child.value


class Gauge(Metric):
    type_name = "gauge"

    def set(self, value: float, *labelvalues) -> None:
        child = self.labels(*labelvalues)
        with child.lock:
            child.value = float(value)

    def inc(self, amount: float = 1.0, *labelvalues) -> None:
        child = self.labels(*labelvalues)
        with child.lock:
            child.value += amount

    def value(self, *labelvalues) -> float:
        child = self.labels(*labelvalues)
        with child.lock:
            return child.value

    def set_onehot(self, *labelvalues, universe=()) -> None:
        """Atomically mark one labelset 1.0 and every other labelset in
        the family 0.0, materialising any ``universe`` labelsets that
        have not been exported yet.

        The whole flip happens under the family lock — the same lock
        ``_samples`` holds across an exposition — so a concurrent
        scrape can never observe a torn one-hot (all-zero, or the new
        labelset published at its default 0.0 before its 1.0 lands).
        ``universe`` entries are labelvalue tuples, or bare values for
        single-label families."""
        target = tuple(str(v) for v in labelvalues)
        if len(target) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(target)}"
            )
        keys = {target}
        for u in universe:
            t = u if isinstance(u, tuple) else (u,)
            keys.add(tuple(str(v) for v in t))
        with self._lock:
            for key in sorted(keys):
                if key not in self._children:
                    child = self._new_child()
                    # Pre-valued BEFORE publication: no 0.0 window.
                    child.value = 1.0 if key == target else 0.0
                    self._children[key] = child
            for key, child in self._children.items():
                with child.lock:
                    child.value = 1.0 if key == target else 0.0


class Histogram(Metric):
    type_name = "histogram"

    def __init__(self, name: str, help: str,  # noqa: A002
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _Child:
        return _Child(buckets=self.buckets)

    def observe(self, value: float, *labelvalues) -> None:
        child = self.labels(*labelvalues)
        with child.lock:
            child.sum += value
            child.count += 1
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    child.bucket_counts[i] += 1
                    break
            else:
                child.bucket_counts[-1] += 1

    def _samples(self) -> Iterable[Tuple[str, str, float]]:
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            with child.lock:
                counts = list(child.bucket_counts)
                total = child.count
                ssum = child.sum
            cumulative = 0
            for ub, n in zip(self.buckets, counts):
                cumulative += n
                labels = _labels_text(
                    self.labelnames + ("le",), key + (_fmt_value(ub),)
                )
                yield "_bucket", labels, float(cumulative)
            labels = _labels_text(self.labelnames + ("le",), key + ("+Inf",))
            yield "_bucket", labels, float(total)
            yield "_sum", _labels_text(self.labelnames, key), ssum
            yield "_count", _labels_text(self.labelnames, key), float(total)


class Registry:
    """Named metric families; get-or-create with type/label checking."""

    def __init__(self) -> None:
        self._lock = TrackedLock("obs.metrics.Registry._lock")
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,  # noqa: A002
                       labelnames: Sequence[str], **kw) -> Metric:
        # Lock-free fast path: dict reads are atomic under the GIL and
        # families are never removed, so the hot feeds (every watch
        # event, every RPC attempt) resolve without contending on the
        # registry lock — it is taken only to create a family.
        existing = self._metrics.get(name)
        if existing is None:
            with self._lock:
                existing = self._metrics.get(name)
                if existing is None:
                    metric = cls(name, help, labelnames, **kw)
                    self._metrics[name] = metric
                    return metric
        if not isinstance(existing, cls) or \
                existing.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-registered with a different "
                f"type/labelset"
            )
        return existing

    def counter(self, name: str, help: str = "",  # noqa: A002
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",  # noqa: A002
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def expose(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return "\n".join(m.expose() for m in metrics) + "\n"


_REGISTRY = Registry()


def default_registry() -> Registry:
    return _REGISTRY


# ----------------------------------------------------------- health state

# Process-wide liveness facts behind /healthz: stamped by the exporter
# feeds (observe_round / observe_loop) so the endpoint reports what the
# process has actually been DOING, not just that a socket answers.
# Timestamps come from obs.trace.monotime() — the telemetry plane's one
# clock owner.
_HEALTH_LOCK = TrackedLock("obs.metrics._HEALTH_LOCK")


def _fresh_health() -> dict:
    return {
        "last_round_ts": None,     # monotime() of the last observed round
        "last_round_index": None,
        "rounds_observed": 0,
        "loop_fatal": False,
        "loop_rounds": 0,
        "consecutive_failures": 0,
        "crash_loop_budget": 0,
        "resyncs": 0,
        # monotime() of the last watcher event processed (watch_event):
        # the streaming engine's ingest-liveness signal.  None until the
        # first event — a process whose watchers simply have nothing to
        # say is healthy, not wedged.
        "last_ingest_ts": None,
    }


_HEALTH = _fresh_health()


def health_report(history: Optional[RoundHistory] = None) -> dict:
    """The /healthz JSON payload: ok flag + last-round age + loop
    hardening state.  ``ok`` is False only on a FATAL loop stop (the
    crash-loop budget fired) — a process that has simply never
    scheduled yet is alive, just idle (``last_round_age_s`` null).
    ``history`` is the serving endpoint's round-history ring (the SAME
    one /debug/rounds reads, so the two endpoints can never disagree
    about liveness); defaults to the process-wide ring."""
    now = _trace.monotime()
    with _HEALTH_LOCK:
        h = dict(_HEALTH)
    ts = h.pop("last_round_ts")
    if ts is None:
        # Processes that drive the planner directly (bench, tools)
        # never feed observe_round/observe_loop — the round-history
        # ring is then the liveness signal.
        latest = (history or default_history()).latest()
        if latest is not None:
            h["last_round_index"], ts = latest
    h["last_round_age_s"] = (
        round(now - ts, 3) if ts is not None else None
    )
    ing = h.pop("last_ingest_ts")
    h["last_ingest_age_s"] = (
        round(now - ing, 3) if ing is not None else None
    )
    h["ok"] = not h["loop_fatal"]
    # Wedged-ingest gate (streaming only): a dead watcher thread is
    # invisible to round liveness — speculative rounds keep completing
    # against a frozen view — so /healthz fails once the last processed
    # watch event is older than POSEIDON_INGEST_STALL_S.  Armed only
    # after a FIRST event (quiet clusters are healthy) and only with a
    # positive stall bound (0 disables).
    if h["ok"] and hatch_bool("POSEIDON_STREAMING"):
        stall = hatch_float("POSEIDON_INGEST_STALL_S")
        if (stall > 0 and h["last_ingest_age_s"] is not None
                and h["last_ingest_age_s"] > stall):
            h["ok"] = False
            h["ingest_stalled"] = True
    return h


def _reset_health() -> None:
    """Test hook: the health facts are process-global like the registry."""
    with _HEALTH_LOCK:
        _HEALTH.clear()
        _HEALTH.update(_fresh_health())


# ----------------------------------------------------------------- exporter


class _Handler(BaseHTTPRequestHandler):
    registry: Registry = _REGISTRY
    history: RoundHistory = default_history()

    def _reply(self, body: bytes, ctype: str, status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, obj, status: int = 200) -> None:
        self._reply(
            (json.dumps(obj) + "\n").encode("utf-8"),
            JSON_CONTENT_TYPE, status,
        )

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._reply(self.registry.expose().encode("utf-8"),
                        CONTENT_TYPE)
        elif path in ("/", "/healthz"):
            report = health_report(self.history)
            # A fatally-stopped loop fails liveness (503) so the
            # orchestrator restarts the pod instead of scraping a
            # zombie; everything else — idle included — is alive.
            self._reply_json(report, 200 if report["ok"] else 503)
        elif path == "/debug/rounds":
            self._reply_json({
                "capacity": self.history.capacity(),
                "retained": len(self.history),
                "rounds": self.history.summaries(),
            })
        elif path.startswith("/debug/round/"):
            tail = path[len("/debug/round/"):]
            try:
                idx = int(tail)
            except ValueError:
                self._reply_json({"error": f"bad round index {tail!r}"},
                                 400)
                return
            rec = self.history.get(idx)
            if rec is None:
                self._reply_json({
                    "error": f"round {idx} not retained",
                    "retained_range": self.history.retained_range(),
                }, 404)
                return
            self._reply_json(rec)
        else:
            self.send_error(404)

    def log_message(self, fmt, *args) -> None:  # scrapes are not log news
        pass


class MetricsServer:
    """`/metrics` on a daemon thread (the Poseidon process's scrape
    endpoint; deploy/poseidon-deployment.yaml annotates the port)."""

    def __init__(self, address: str = "0.0.0.0:9100",
                 registry: Optional[Registry] = None,
                 history: Optional[RoundHistory] = None) -> None:
        # Bind happens in start(), not here: an instance whose owner
        # fails before start() (e.g. Poseidon.start raising on an
        # unhealthy service) must not hold the port hostage until GC.
        host, _, port = address.rpartition(":")
        self._bind = (host or "0.0.0.0", int(port))
        self._handler = type(
            "_BoundHandler", (_Handler,),
            {"registry": registry or _REGISTRY,
             "history": history or default_history()},
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self.address: Optional[str] = None

    def start(self) -> "MetricsServer":
        self._httpd = ThreadingHTTPServer(self._bind, self._handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        host = self._bind[0]
        if host in ("0.0.0.0", "::", ""):
            host = "127.0.0.1"
        self.address = f"{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:  # never started
            return
        if self._thread is not None:
            # shutdown() blocks until serve_forever exits — only safe
            # when the serving thread actually ran.
            self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ------------------------------------------------------------------- feeds

# The degraded-ladder vocabulary (graph/instance.py RoundMetrics
# .solve_tier): exported one-hot so dashboards can plot tier occupancy.
SOLVE_TIERS = ("none", "quiet", "pruned", "dense", "sharded",
               "host_greedy")

# RoundMetrics fields that are per-round event counts: also accumulated
# into process-lifetime counters next to the per-round gauges.
_ROUND_COUNTERS = (
    "placed", "preempted", "migrated", "device_calls",
    "fresh_compiles", "iterations", "bf_sweeps", "repair_firings",
)


def observe_round(metrics, registry: Optional[Registry] = None) -> None:
    """Feed one round's ``RoundMetrics`` (the object or its
    ``to_dict()``) into the registry.  Schema-driven: every numeric
    field becomes a ``poseidon_round_<field>`` gauge, so a field added
    to RoundMetrics is exported without touching this module."""
    reg = registry or _REGISTRY
    d = metrics.to_dict() if hasattr(metrics, "to_dict") else dict(metrics)
    d.pop("schema", None)
    with _HEALTH_LOCK:
        _HEALTH["last_round_ts"] = _trace.monotime()
        _HEALTH["last_round_index"] = d.get("round_index")
        _HEALTH["rounds_observed"] += 1
    tier = d.pop("solve_tier", "none")
    tier_g = reg.gauge(
        "poseidon_round_solve_tier",
        "Which degraded-ladder tier served the last round (one-hot)",
        ("tier",),
    )
    # One transactional flip: the serving tier to 1 and every other
    # labelset ever exported to 0 (not just SOLVE_TIERS: a tier name
    # added to instance.py before this list is updated must not stay
    # pinned at 1 forever), under the family lock an exposition also
    # holds.  Per-set writes — in any order — left windows a concurrent
    # scrape could stitch into an all-zero one-hot; the race harness
    # reproduces the worst (zero-then-set) order in tests/test_races.py.
    tier_g.set_onehot(tier, universe=SOLVE_TIERS)
    for key in sorted(d):
        val = d[key]
        if val == "inf":
            val = float("inf")
        if isinstance(val, bool):
            val = float(val)
        if not isinstance(val, (int, float)):
            continue
        reg.gauge(
            f"poseidon_round_{key}",
            f"RoundMetrics.{key} of the most recent schedule round",
        ).set(float(val))
        if key in _ROUND_COUNTERS:
            reg.counter(
                f"poseidon_rounds_{key}_total",
                f"RoundMetrics.{key} accumulated across rounds",
            ).inc(max(float(val), 0.0))
    reg.counter(
        "poseidon_rounds_observed_total", "Schedule rounds observed"
    ).inc()
    # Histogram names must not collide with the schema-walked
    # ``poseidon_round_<field>`` gauges (solve_seconds is a field).
    reg.histogram(
        "poseidon_round_duration_seconds", "End-to-end schedule round latency"
    ).observe(float(d.get("total_seconds", 0.0)))
    reg.histogram(
        "poseidon_round_solve_duration_seconds", "Solver window of the round"
    ).observe(float(d.get("solve_seconds", 0.0)))


def observe_loop(stats, *, resyncs: int = 0, crash_loop_budget: int = 0,
                 fatal: bool = False, placements_per_sec: float = 0.0,
                 ingest_lag_s: float = 0.0,
                 registry: Optional[Registry] = None) -> None:
    """Feed the glue loop's ``LoopStats`` + watcher resync counts.
    Cumulative LoopStats fields pin counters via ``set_total`` (the
    dataclass owns monotonicity); instantaneous ones are gauges."""
    reg = registry or _REGISTRY
    with _HEALTH_LOCK:
        _HEALTH["loop_fatal"] = bool(fatal)
        _HEALTH["consecutive_failures"] = int(stats.consecutive_failures)
        _HEALTH["crash_loop_budget"] = int(crash_loop_budget)
        _HEALTH["resyncs"] = int(resyncs)
        # In the GLUE process (no observe_round feed — RoundMetrics
        # live service-side) the loop's own completed-round counter is
        # the liveness signal: stamp last-round age off its advance.
        if int(stats.rounds) > int(_HEALTH.get("loop_rounds") or 0):
            _HEALTH["loop_rounds"] = int(stats.rounds)
            _HEALTH["last_round_ts"] = _trace.monotime()
    for field in ("rounds", "placed", "preempted", "migrated",
                  "failed_rounds", "bind_failures", "requeued"):
        reg.counter(
            f"poseidon_loop_{field}_total",
            f"LoopStats.{field} (glue schedule loop)",
        ).set_total(float(getattr(stats, field)))
    reg.counter(
        "poseidon_watch_resyncs_total",
        "Pod+node watch resyncs after dropped watches",
    ).set_total(float(resyncs))
    reg.gauge(
        "poseidon_loop_consecutive_failures",
        "Consecutive failed rounds (crash-loop budget numerator)",
    ).set(float(stats.consecutive_failures))
    reg.gauge(
        "poseidon_crash_loop_budget",
        "Configured consecutive-failure budget before fatal stop",
    ).set(float(crash_loop_budget))
    reg.gauge(
        "poseidon_loop_fatal",
        "1 once the crash-loop budget stopped the schedule loop",
    ).set(1.0 if fatal else 0.0)
    reg.gauge(
        "poseidon_loop_placements_per_sec",
        "Sustained placement throughput over the last observation "
        "window (the streaming rung's headline series)",
    ).set(float(placements_per_sec))
    reg.gauge(
        "poseidon_ingest_queue_age_s",
        "Age of the oldest undelivered watcher event (glue-side ingest "
        "lag; 0 when both watch queues are drained)",
    ).set(float(ingest_lag_s))


def observe_locks(registry: Optional[Registry] = None) -> None:
    """Expose the TrackedLock ledger's process-wide counters
    (utils/locks.py): contention events, time spent waiting, time spent
    holding, and the size of the observed acquisition-order edge graph.
    Monotonic sums over every tracked lock ever constructed, so
    ``set_total`` pins the counters without double counting."""
    from poseidon_tpu_torch.utils import locks as _locks

    reg = registry or _REGISTRY
    reg.counter(
        "poseidon_lock_contention_total",
        "TrackedLock acquisitions that found the lock held",
    ).set_total(float(_locks.lock_contention_count()))
    reg.counter(
        "poseidon_lock_contention_seconds_total",
        "Wall seconds tracked-lock acquirers spent waiting",
    ).set_total(_locks.lock_contention_ns() / 1e9)
    reg.counter(
        "poseidon_lock_hold_seconds_total",
        "Wall seconds tracked locks were held",
    ).set_total(_locks.lock_hold_ns() / 1e9)
    reg.gauge(
        "poseidon_lock_order_edges",
        "Distinct lock-acquisition-order edges observed (LockLedger)",
    ).set(float(_locks.lock_order_edge_count()))


def observe_ledger(registry: Optional[Registry] = None) -> None:
    """Expose the ledgers' process-wide counters.  The compile and
    transfer counters (check/ledger.py) are read only when torch is
    already imported: the glue process must not pay a torch import for
    two series that would read 0 anyway.  The lock ledger rides along
    (every call site feeds both): its counters are torch-free, so they
    export before the gate.  The reference's ``poseidon_retraces_total``
    has no torch event and no series here."""
    import sys

    observe_locks(registry)
    if "torch" not in sys.modules:
        return
    from poseidon_tpu_torch.check.ledger import (
        fresh_compile_count,
        implicit_transfer_count,
    )

    reg = registry or _REGISTRY
    reg.counter(
        "poseidon_fresh_compiles_total",
        "Process-wide compile events: kernel builds or loads and solve "
        "keys' first sights (check/ledger.py)",
    ).set_total(float(fresh_compile_count()))
    reg.counter(
        "poseidon_implicit_transfers_total",
        "Process-wide implicit device->host syncs on CUDA tensors outside "
        "the sanctioned read (check/ledger.py)",
    ).set_total(float(implicit_transfer_count()))


def rpc_attempt(rpc: str, registry: Optional[Registry] = None) -> None:
    reg = registry or _REGISTRY
    reg.counter(
        "poseidon_client_rpc_attempts_total",
        "Firmament client RPC attempts (retries counted individually)",
        ("rpc",),
    ).inc(1.0, rpc)


def rpc_error(rpc: str, code: str, retried: bool,
              registry: Optional[Registry] = None) -> None:
    reg = registry or _REGISTRY
    reg.counter(
        "poseidon_client_rpc_errors_total",
        "Firmament client RPC failures by status code",
        ("rpc", "code"),
    ).inc(1.0, rpc, code)
    if retried:
        reg.counter(
            "poseidon_client_rpc_retries_total",
            "Failed attempts absorbed by the client's bounded retry",
            ("rpc",),
        ).inc(1.0, rpc)
    if code == "DEADLINE_EXCEEDED":
        reg.counter(
            "poseidon_client_rpc_deadline_total",
            "RPC attempts that hit their per-RPC deadline",
            ("rpc",),
        ).inc(1.0, rpc)


def watch_event(watcher: str, kind: str,
                registry: Optional[Registry] = None) -> None:
    reg = registry or _REGISTRY
    reg.counter(
        "poseidon_watch_events_total",
        "Watch events processed by the pod/node watchers",
        ("watcher", "kind"),
    ).inc(1.0, watcher, kind)
    # Ingest-liveness stamp for /healthz: every processed watcher event
    # proves the ingest path is moving (see health_report's wedged-
    # ingest gate for the streaming engine).
    with _HEALTH_LOCK:
        _HEALTH["last_ingest_ts"] = _trace.monotime()

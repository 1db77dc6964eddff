"""Round-pipeline span tracer: hierarchical, thread-safe, Perfetto-ready.

One process-wide :class:`Tracer` records *spans* — named wall-duration
windows with attributes — opened via the ``span(name, **attrs)`` context
manager.  Spans nest per thread (each thread keeps its own open-span
stack), so a ``round`` span opened in ``schedule_round`` automatically
parents the ``round.cost_build`` / ``round.solve_band`` stage spans
opened beneath it on the same thread, while watcher-thread spans form
their own lanes.

Two independent gates, both read at call time (never at import):

- ``POSEIDON_TRACE=1``: full span *recording* — every finished span is
  kept (name, start, duration, thread, parent, attrs) for export as
  Chrome trace-event JSON (``chrome://tracing`` / https://ui.perfetto.dev);
- ``POSEIDON_STAGE_TIMERS=1``: *accumulation only* — per-name
  (total_seconds, calls) aggregates with no span objects kept.  This is
  the stage-timer mode; recording implies it.

With neither gate set, ``span()`` returns a shared no-op singleton: the
disabled path is two dict probes and no allocation beyond the kwargs.

``record(name, t0, t1)`` takes an interval that has already ended, on
the same gates: a call's wait in the server's queue, a pod's wait from
its acceptance to its placement, a collector pause, a lock wait.  It
takes no lock (a collector callback or a lock's own acquire path may
call it); its intervals join the buffer, the totals and the cap at the
next span close or read.

Timing uses ``time.perf_counter()`` only (telemetry, never decisions);
this module is the ONE place in ``obs/`` that reads a clock.  The port's
``utils.stagetimer`` is a shim over this tracer, as the reference's is.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_set
from poseidon_tpu_torch.utils.locks import TrackedLock

TRACE_ENV = "POSEIDON_TRACE"
STAGE_ENV = "POSEIDON_STAGE_TIMERS"

# Span-buffer cap: a long-running traced service must not grow without
# bound.  Past the cap, spans are dropped (counted in ``dropped``) while
# totals keep accumulating — the aggregate view stays honest.  A traced
# service under 800 task RPCs a second records three spans a call (the
# call, its queue wait, its reply's encoding): 200,000 a minute and a
# half.
MAX_SPANS = 500_000
# Counter-sample cap (Perfetto counter tracks — the convergence-curve
# series): a 512-sample curve per band solve adds up fast in a long
# traced window, so the buffer is bounded like the span one.
MAX_COUNTER_SAMPLES = 500_000

_ids = itertools.count(1)


def monotime() -> float:
    """Monotonic timestamp for the rest of the telemetry plane.

    The tracer is the ONE clock owner in ``obs/``: modules that need an age or a timestamp —
    the /healthz liveness report, the round-history ring — call this
    instead of reading ``time`` themselves, so metrics and timeline can
    never disagree about what clock they are on.  Same epoch as span
    timestamps (``time.perf_counter``)."""
    return time.perf_counter()


class _NullSpan:
    """The disabled path: a shared, stateless, no-op span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One open span; finished spans become plain dicts in the buffer."""

    __slots__ = ("_tracer", "name", "attrs", "_record", "_t0",
                 "_parent_id", "_explicit_parent", "id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 record: bool,
                 explicit_parent: Optional[int] = None) -> None:
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._record = record
        self._t0 = 0.0
        self._parent_id: Optional[int] = None
        self._explicit_parent = explicit_parent
        self.id = 0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes on the open span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self._record:
            stack = self._tracer._stack()
            if self._explicit_parent is not None:
                # Cross-thread parenting (the pipelined cost build: a
                # worker-lane span whose logical parent — the round —
                # lives on the planner thread's stack).
                self._parent_id = self._explicit_parent
            else:
                self._parent_id = stack[-1].id if stack else None
            self.id = next(_ids)
            stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        tr = self._tracer
        if self._record:
            stack = tr._stack()
            if stack and stack[-1] is self:
                stack.pop()
            else:  # unbalanced exit (generator-held span); best effort
                try:
                    stack.remove(self)
                except ValueError:
                    pass
            if exc_type is not None:
                self.attrs.setdefault("error", exc_type.__name__)
            thread = threading.current_thread()
            rec = {
                "name": self.name,
                "ts": self._t0 - tr._epoch,
                "dur": dur,
                "tid": thread.ident,
                "tname": thread.name,
                "id": self.id,
                "parent": self._parent_id,
                "attrs": dict(self.attrs),
            }
        with tr._lock:
            if tr._pending:
                tr._flush_pending()
            tr._add(self.name, dur, rec if self._record else None)
        return False


class Tracer:
    """Process-wide span recorder + per-name duration aggregator."""

    def __init__(self, max_spans: int = MAX_SPANS,
                 max_counter_samples: int = MAX_COUNTER_SAMPLES) -> None:
        # Its own waits are not traced: they would measure the tracer.
        self._lock = TrackedLock("obs.Tracer._lock", trace_waits=False)
        self._tl = threading.local()
        self._spans: List[dict] = []
        # ``record``'s intervals not yet in the buffer (appended without
        # the lock; drained under it).
        self._pending: deque = deque()
        self._counter_samples: List[dict] = []
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._epoch = time.perf_counter()
        self.max_spans = max_spans
        self.max_counter_samples = max_counter_samples
        self.dropped = 0
        self.dropped_counters = 0
        # Overrides the env gate when not None (harness/test control —
        # the chaos soak forces recording on for flight-trace spans
        # without mutating the process environment).
        self.force: Optional[bool] = None

    # ------------------------------------------------------------------ gates

    def gated(self) -> bool:
        """Whether either gate may be on: the disabled fast path's probe,
        the one a hot caller makes before any other tracer work."""
        return self.force is not None or hatch_set(TRACE_ENV) \
            or hatch_set(STAGE_ENV)

    def tracing(self) -> bool:
        if self.force is not None:
            return self.force
        return hatch_bool(TRACE_ENV)

    def timing(self) -> bool:
        return self.tracing() or hatch_bool(STAGE_ENV)

    # ------------------------------------------------------------------ spans

    def span(self, name: str, parent: Optional[int] = None, **attrs):
        """``parent`` (a span id) overrides the per-thread stack parent
        — used by worker-thread spans whose logical parent lives on
        another thread's stack."""
        if not self.gated():
            return NULL_SPAN  # the common (fully disabled) fast path
        if self.tracing():
            return Span(self, name, attrs, record=True,
                        explicit_parent=parent)
        if hatch_bool(STAGE_ENV):
            return Span(self, name, attrs, record=False)
        return NULL_SPAN

    def record(self, name: str, t0: float, t1: float,
               parent: Optional[int] = None, *, nested: bool = False,
               **attrs) -> None:
        """Record the finished interval [t0, t1] (absolute
        ``perf_counter`` endpoints) under ``name``, on ``span()``'s gates
        and with its totals, cap and ``dropped`` accounting.

        Takes no lock, so it is safe from a collector callback or from
        inside a lock's acquire: the interval joins the buffer at the
        next span close or read.  ``nested`` says the interval lies
        inside the calling thread's own work (a collector pause, a lock
        wait) and exports on its lane; otherwise it began elsewhere (a
        call's wait in a queue, a pod's wait for a round) and exports as
        an async slice of its own.  ``parent`` is a span id; the calling
        thread's open span is not taken as one."""
        if not self.gated():
            return
        keep = self.tracing()
        if not keep and not hatch_bool(STAGE_ENV):
            return
        th = threading.current_thread()
        # Lock-free by design (see above); deque appends are atomic.
        self._pending.append(  # posecheck: ignore[lock-discipline]
            (name, t0, t1, parent, attrs, keep, nested, th.ident, th.name))

    def _flush_pending(self) -> None:
        """Move ``record``'s intervals into the totals and the buffer.
        Caller holds ``_lock``."""
        pending = self._pending
        while pending:
            (name, t0, t1, parent, attrs, keep, nested, tid,
             tname) = pending.popleft()
            rec = None
            if keep:
                rec = {"name": name, "ts": t0 - self._epoch, "dur": t1 - t0,
                       "tid": tid, "tname": tname, "id": next(_ids),
                       "parent": parent, "attrs": attrs}
                if not nested:
                    rec["async"] = True
            self._add(name, t1 - t0, rec)

    def _add(self, name: str, dur: float, rec: Optional[dict]) -> None:
        """One finished interval into the totals and, given its record,
        the buffer or ``dropped``.  Caller holds ``_lock``."""
        self._totals[name] = self._totals.get(name, 0.0) + dur
        self._counts[name] = self._counts.get(name, 0) + 1
        if rec is not None:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self.dropped += 1

    @property
    def epoch(self) -> float:
        """The ``perf_counter`` time that recorded ``ts`` count from."""
        return self._epoch

    def current(self):
        """The innermost open recorded span on THIS thread (or the null
        span, so ``trace.current().set(k=v)`` is always safe)."""
        stack = getattr(self._tl, "stack", None)
        return stack[-1] if stack else NULL_SPAN

    def _stack(self) -> List[Span]:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = []
            self._tl.stack = stack
        return stack

    # ------------------------------------------------------------ aggregates

    def snapshot_totals(self) -> Dict[str, Tuple[float, int]]:
        """{name: (total_seconds, calls)} accumulated since last reset."""
        with self._lock:
            self._flush_pending()
            return {
                k: (self._totals[k], self._counts.get(k, 0))
                for k in self._totals
            }

    def reset_totals(self) -> None:
        with self._lock:
            self._flush_pending()
            self._totals.clear()
            self._counts.clear()

    def reset(self) -> None:
        """Clear totals AND the recorded span/counter buffers."""
        with self._lock:
            self._pending.clear()
            self._totals.clear()
            self._counts.clear()
            self._spans.clear()
            self._counter_samples.clear()
            self.dropped = 0
            self.dropped_counters = 0

    # ------------------------------------------------------------- counters

    def counter_series(self, name: str, t0: float, t1: float,
                       values) -> None:
        """Record a whole series distributed evenly over the window
        [t0, t1] (absolute ``perf_counter`` endpoints) — how a device
        solve's per-iteration convergence curve lands on the timeline:
        the host only knows the solve's wall window, so samples are
        laid out linearly across it.  No-op when recording is off."""
        if not self.tracing():
            return
        values = list(values)
        n = len(values)
        if n == 0:
            return
        span_s = max(t1 - t0, 0.0)
        step = span_s / max(n - 1, 1)
        recs = [
            {"name": name, "ts": (t0 + i * step) - self._epoch,
             "value": float(v)}
            for i, v in enumerate(values)
        ]
        with self._lock:
            room = self.max_counter_samples - len(self._counter_samples)
            if room >= n:
                self._counter_samples.extend(recs)
            else:
                self._counter_samples.extend(recs[:max(room, 0)])
                self.dropped_counters += n - max(room, 0)

    def counter_samples(self) -> List[dict]:
        with self._lock:
            return list(self._counter_samples)

    def drain_counter_samples(self) -> List[dict]:
        """Return AND clear the counter samples (the flight recorder's
        per-round window, like ``drain_spans``)."""
        with self._lock:
            out = self._counter_samples
            self._counter_samples = []
            return out

    # -------------------------------------------------------------- recorded

    def spans(self) -> List[dict]:
        with self._lock:
            self._flush_pending()
            return list(self._spans)

    def drain_spans(self) -> List[dict]:
        """Return AND clear the recorded spans (the per-round flight-
        recorder window; totals are untouched)."""
        with self._lock:
            self._flush_pending()
            out = self._spans
            self._spans = []
            return out

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        obj = chrome_trace(self.spans(), self.counter_samples())
        if path is not None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(obj, fh)
                fh.write("\n")
        return obj


# ------------------------------------------------------- chrome trace format


def chrome_trace(spans: List[dict],
                 counters: Optional[List[dict]] = None) -> dict:
    """Lower recorded spans to Chrome trace-event JSON (the Trace Event
    Format's complete ``"ph": "X"`` events), loadable in Perfetto.

    ``ts``/``dur`` are integer microseconds relative to the tracer
    epoch; nesting is positional (Perfetto nests same-tid events by
    interval containment), with explicit ``span_id``/``parent_id`` args
    kept for offline joins.  Thread-name metadata events give each
    recorded thread a labeled lane.

    ``counters`` (``Tracer.counter_samples()`` records) lower to
    ``"ph": "C"`` counter events — Perfetto renders each distinct name
    as its own counter track under the process, which is how the
    solver's convergence curves land next to the span lanes.

    A ``record``-ed interval that began elsewhere (its span carries
    ``async``) lowers to an async slice, a ``"b"``/``"e"`` pair keyed by
    its span id: such intervals overlap one another and the spans of the
    thread that recorded them, so they cannot nest on its lane.
    """
    pid = os.getpid()
    events: List[dict] = []
    slices: List[dict] = []
    thread_names: Dict[int, str] = {}
    for s in spans:
        tid = int(s["tid"] or 0)
        thread_names.setdefault(tid, str(s.get("tname", tid)))
        args = {k: _json_safe(v) for k, v in s.get("attrs", {}).items()}
        args["span_id"] = s["id"]
        if s.get("parent") is not None:
            args["parent_id"] = s["parent"]
        if s.get("async"):
            t0 = int(round(s["ts"] * 1e6))
            t1 = t0 + max(int(round(s["dur"] * 1e6)), 1)
            for ph, ts in (("b", t0), ("e", t1)):
                slices.append({"name": s["name"], "cat": "poseidon",
                               "ph": ph, "id": s["id"], "ts": ts,
                               "pid": pid, "tid": tid, "args": args})
            continue
        events.append({
            "name": s["name"],
            "cat": "poseidon",
            "ph": "X",
            "ts": int(round(s["ts"] * 1e6)),
            # Zero-length spans still render (and a child may not
            # outlast its parent only because of this floor — the
            # validator tolerates 1 us of slop).
            "dur": max(int(round(s["dur"] * 1e6)), 1),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    counter_events: List[dict] = []
    for c in counters or ():
        counter_events.append({
            "name": str(c["name"]),
            "cat": "poseidon",
            "ph": "C",
            "ts": int(round(c["ts"] * 1e6)),
            "pid": pid,
            # Counter tracks are per (pid, name) in Perfetto; tid 0
            # keeps them off the span lanes.
            "tid": 0,
            "args": {"value": float(c["value"])},
        })
    counter_events.sort(key=lambda e: (e["name"], e["ts"]))
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(thread_names.items())
    ]
    slices.sort(key=lambda e: (e["ts"], e["ph"] == "b"))
    return {
        "traceEvents": meta + events + slices + counter_events,
        "displayTimeUnit": "ms",
    }


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def validate_chrome_trace(obj: dict) -> List[str]:
    """Structural validation of a trace-event JSON object; returns the
    list of problems (empty = Perfetto-loadable by this format's rules).

    Checks: JSON-serializability, required complete-event fields, and —
    the property the timeline view depends on — that SAME-LANE spans
    are properly NESTED (a child interval lies within its enclosing
    span, never partially overlapping it).  Spans on DIFFERENT lanes may
    overlap freely (the pipelined round: band k's solve on the planner
    lane runs while band k+1's cost build runs on the worker lane), but
    the explicit ``parent_id`` links must still contain their children
    in time — a cross-thread child escaping its parent's interval is a
    bookkeeping bug, not concurrency.
    """
    problems: List[str] = []
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
        return problems
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    lanes: Dict[Tuple[int, int], List[Tuple[int, int, str]]] = {}
    open_slices: Dict[Tuple[Any, Any], Tuple[int, str]] = {}
    by_span_id: Dict[int, Tuple[int, int, str]] = {}
    linked: List[Tuple[int, int, str, int]] = []
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            continue
        if ph == "C":
            # Counter events: name/ts/pid plus a numeric args dict (the
            # series values Perfetto plots).  They live outside the
            # span-nesting rules entirely.
            for key in ("name", "ts", "pid"):
                if key not in e:
                    problems.append(f"counter event {i}: missing {key}")
            if not isinstance(e.get("ts", 0), int):
                problems.append(
                    f"counter event {i}: ts must be integer us"
                )
            cargs = e.get("args")
            if not isinstance(cargs, dict) or not cargs or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in cargs.values()
            ):
                problems.append(
                    f"counter event {i}: args must be a non-empty dict "
                    "of numeric series values"
                )
            continue
        if ph in ("b", "e"):
            # Async slices: each "b" closed by one later "e" of the same
            # category, id and name.
            key = (e.get("cat"), e.get("id"))
            ts = e.get("ts")
            if not isinstance(ts, int) or key[1] is None:
                problems.append(f"event {i}: async slice needs an id and "
                                "integer us ts")
            elif ph == "b":
                if key in open_slices:
                    problems.append(f"event {i}: async slice {key} "
                                    "opened twice")
                open_slices[key] = (ts, e.get("name", "?"))
            else:
                got = open_slices.pop(key, None)
                if got is None or got[1] != e.get("name", "?") \
                        or ts < got[0]:
                    problems.append(f"event {i}: async slice end {key} "
                                    "without its begin")
            continue
        if ph != "X":
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in e:
                problems.append(f"event {i}: missing {key}")
        ts, dur = e.get("ts", 0), e.get("dur", 0)
        if not isinstance(ts, int) or not isinstance(dur, int):
            problems.append(f"event {i}: ts/dur must be integer us")
            continue
        if dur < 0:
            problems.append(f"event {i}: negative dur")
            continue
        lanes.setdefault((e.get("pid", 0), e.get("tid", 0)), []).append(
            (ts, dur, e.get("name", "?"))
        )
        args = e.get("args", {})
        sid = args.get("span_id")
        if isinstance(sid, int):
            by_span_id[sid] = (ts, dur, e.get("name", "?"))
        pid_arg = args.get("parent_id")
        if isinstance(pid_arg, int):
            linked.append((ts, dur, e.get("name", "?"), pid_arg))
    for key, (_, name) in sorted(open_slices.items(), key=str):
        problems.append(f"async slice {name!r} {key} never ends")
    # Explicit parent links (lane-independent): a child must lie inside
    # its parent's interval.  2 us slop — BOTH exported durations are
    # floored at 1 us, so an instant child of an instant parent can
    # overshoot by up to two ticks.
    for ts, dur, name, parent in linked:
        got = by_span_id.get(parent)
        if got is None:
            problems.append(
                f"span {name!r} references unknown parent_id {parent}"
            )
            continue
        p_ts, p_dur, p_name = got
        if ts < p_ts or ts + dur > p_ts + p_dur + 2:
            problems.append(
                f"span {name!r} [{ts},{ts + dur}) escapes its parent "
                f"{p_name!r} [{p_ts},{p_ts + p_dur})"
            )
    for (pid, tid), lane in sorted(lanes.items()):
        lane.sort(key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[int, int, str]] = []
        for ts, dur, name in lane:
            # 1 us slop: the exporter floors dur at 1 us, which can push
            # an instant child one tick past its instant parent.
            while stack and ts >= stack[-1][0] + stack[-1][1]:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + stack[-1][1] + 1:
                problems.append(
                    f"tid {tid}: span {name!r} [{ts},{ts + dur}) "
                    f"partially overlaps {stack[-1][2]!r}"
                )
            stack.append((ts, dur, name))
    return problems


def counter_tracks(obj: dict) -> Dict[str, int]:
    """{counter-track name: sample count} of a trace-event JSON object
    — what ``make trace-smoke`` / ``make profile-smoke`` assert on."""
    tracks: Dict[str, int] = {}
    for e in obj.get("traceEvents", ()):
        if e.get("ph") == "C":
            name = str(e.get("name", "?"))
            tracks[name] = tracks.get(name, 0) + 1
    return tracks


def span_totals(spans: List[dict]) -> Dict[str, Tuple[float, int]]:
    """Aggregate recorded spans to the stagetimer shape
    ({name: (total_seconds, calls)}) — the parity check's other side."""
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for s in spans:
        totals[s["name"]] = totals.get(s["name"], 0.0) + s["dur"]
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    return {k: (totals[k], counts[k]) for k in totals}


# -------------------------------------------------------- module-level facade

_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def span(name: str, parent: Optional[int] = None, **attrs):
    """Open a span on the process tracer (context manager)."""
    return _TRACER.span(name, parent=parent, **attrs)


def record(name: str, t0: float, t1: float, parent: Optional[int] = None,
           *, nested: bool = False, **attrs) -> None:
    """Record a finished interval on the process tracer (``Tracer.record``)."""
    _TRACER.record(name, t0, t1, parent, nested=nested, **attrs)


def current():
    return _TRACER.current()


def tracing_enabled() -> bool:
    return _TRACER.tracing()


def timing_enabled() -> bool:
    return _TRACER.timing()


def snapshot_totals() -> Dict[str, Tuple[float, int]]:
    return _TRACER.snapshot_totals()


def reset_totals() -> None:
    _TRACER.reset_totals()


def reset() -> None:
    _TRACER.reset()


def spans() -> List[dict]:
    return _TRACER.spans()


def drain_spans() -> List[dict]:
    return _TRACER.drain_spans()


def counter_series(name: str, t0: float, t1: float, values) -> None:
    _TRACER.counter_series(name, t0, t1, values)


def counter_samples() -> List[dict]:
    return _TRACER.counter_samples()


def drain_counter_samples() -> List[dict]:
    return _TRACER.drain_counter_samples()


def export_chrome_trace(path: Optional[str] = None) -> dict:
    return _TRACER.export_chrome_trace(path)

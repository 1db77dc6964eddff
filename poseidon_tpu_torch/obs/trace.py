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
from typing import Any, Dict, List, Optional, Tuple

from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_set
from poseidon_tpu_torch.utils.locks import TrackedLock

TRACE_ENV = "POSEIDON_TRACE"
STAGE_ENV = "POSEIDON_STAGE_TIMERS"

# Span-buffer cap: a long-running traced service must not grow without
# bound.  Past the cap, spans are dropped (counted in ``dropped``) while
# totals keep accumulating — the aggregate view stays honest.
MAX_SPANS = 200_000
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
            tr._totals[self.name] = tr._totals.get(self.name, 0.0) + dur
            tr._counts[self.name] = tr._counts.get(self.name, 0) + 1
            if self._record:
                if len(tr._spans) < tr.max_spans:
                    tr._spans.append(rec)
                else:
                    tr.dropped += 1
        return False


class Tracer:
    """Process-wide span recorder + per-name duration aggregator."""

    def __init__(self, max_spans: int = MAX_SPANS,
                 max_counter_samples: int = MAX_COUNTER_SAMPLES) -> None:
        self._lock = TrackedLock("obs.Tracer._lock")
        self._tl = threading.local()
        self._spans: List[dict] = []
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
        if self.force is None and not hatch_set(TRACE_ENV) \
                and not hatch_set(STAGE_ENV):
            return NULL_SPAN  # the common (fully disabled) fast path
        if self.tracing():
            return Span(self, name, attrs, record=True,
                        explicit_parent=parent)
        if hatch_bool(STAGE_ENV):
            return Span(self, name, attrs, record=False)
        return NULL_SPAN

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
            return {
                k: (self._totals[k], self._counts.get(k, 0))
                for k in self._totals
            }

    def reset_totals(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()

    def reset(self) -> None:
        """Clear totals AND the recorded span/counter buffers."""
        with self._lock:
            self._totals.clear()
            self._counts.clear()
            self._spans.clear()
            self._counter_samples.clear()
            self.dropped = 0
            self.dropped_counters = 0

    # ------------------------------------------------------------- counters

    def counter(self, name: str, value, ts: Optional[float] = None) -> None:
        """Record one counter sample (a Perfetto counter-track point).

        ``ts`` is an absolute ``time.perf_counter()`` timestamp (the
        caller's own measurement — e.g. a solve window endpoint);
        defaults to now.  No-op unless span recording is on: counter
        tracks only make sense next to a span timeline."""
        if not self.tracing():
            return
        t = (ts if ts is not None else time.perf_counter()) - self._epoch
        rec = {"name": name, "ts": t, "value": float(value)}
        with self._lock:
            if len(self._counter_samples) < self.max_counter_samples:
                self._counter_samples.append(rec)
            else:
                self.dropped_counters += 1

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
            return list(self._spans)

    def drain_spans(self) -> List[dict]:
        """Return AND clear the recorded spans (the per-round flight-
        recorder window; totals are untouched)."""
        with self._lock:
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
    """
    pid = os.getpid()
    events: List[dict] = []
    thread_names: Dict[int, str] = {}
    for s in spans:
        tid = int(s["tid"] or 0)
        thread_names.setdefault(tid, str(s.get("tname", tid)))
        args = {k: _json_safe(v) for k, v in s.get("attrs", {}).items()}
        args["span_id"] = s["id"]
        if s.get("parent") is not None:
            args["parent_id"] = s["parent"]
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
    return {
        "traceEvents": meta + events + counter_events,
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


def counter(name: str, value, ts: Optional[float] = None) -> None:
    _TRACER.counter(name, value, ts=ts)


def counter_series(name: str, t0: float, t1: float, values) -> None:
    _TRACER.counter_series(name, t0, t1, values)


def counter_samples() -> List[dict]:
    return _TRACER.counter_samples()


def drain_counter_samples() -> List[dict]:
    return _TRACER.drain_counter_samples()


def export_chrome_trace(path: Optional[str] = None) -> dict:
    return _TRACER.export_chrome_trace(path)

"""Profiler and device-memory bridge for the solver plane (the port of
``poseidon_tpu/obs/profile.py``).

Two narrow seams between the scheduler's own telemetry and torch's:

- ``solve_profile(round_index)``: a hatch-gated ``torch.profiler``
  capture window.  With ``POSEIDON_JAX_PROFILE=<dir>`` set (the
  reference's name), the round planner wraps its solve window in a
  capture of CPU and CUDA activity written to ``<dir>/round_<n>`` as a
  Chrome trace, and stamps the artifact path on the ``round`` span
  (``profile_path`` attribute).  Unset (the default), the context
  manager is a no-op that never imports the profiler.  The service's
  ``profile_dir`` captures whole rounds through the same ``capture``.
  Spans the tracer recorded within a capture's window join its trace,
  moved onto the profiler's time base through one marker range, so
  Perfetto shows the program's spans beside its kernels.

- ``observe_device_memory(registry)``: per-CUDA-device memory gauges
  (in use, peak, limit) plus a live-block count, sampled at round
  boundaries by the service (``service/server.py``).  It reads only
  when torch is already imported AND CUDA is already initialised: a
  glue-only process must not pay a torch import, and reading a gauge
  must never be what initialises the card.

No clock reads here but the tracer's (``obs.trace.monotime``); capture
paths are keyed by round index, never wall time.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from contextlib import contextmanager

from poseidon_tpu_torch.obs import trace as _trace
from poseidon_tpu_torch.utils.hatches import hatch_str

log = logging.getLogger("poseidon_tpu_torch.obs.profile")

# Latched False after the first failed capture attempt, so a broken
# profiler (missing CUPTI, unwritable dir) degrades to one warning, not
# one per round.
_PROFILER_OK = True

TRACE_FILE = "trace.json"
# The marker range a capture opens at a known tracer time: where it lies
# in the profiler's trace aligns the tracer's spans with it.
SYNC_MARK = "poseidon.trace_sync"


def profile_dir() -> str:
    """The configured capture root ('' = profiling off)."""
    return hatch_str("POSEIDON_JAX_PROFILE")


@contextmanager
def capture(path: str):
    """One ``torch.profiler`` window (CPU activity, plus CUDA activity
    when CUDA is available) exported to ``<path>/trace.json`` on exit.
    Yields ``path`` while the capture runs, or None when the profiler
    could not start; failures to start or stop are contained here (a
    broken profiler must never fail a schedule round)."""
    global _PROFILER_OK
    if not _PROFILER_OK:
        yield None
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(path, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        t_open = _trace.monotime()
        with record_function(SYNC_MARK):
            pass
    except Exception as e:  # noqa: BLE001 - degrade, never fail the round
        _PROFILER_OK = False
        log.warning("torch profiler capture unavailable (%s: %s); "
                    "disabling for this process", type(e).__name__, e)
        yield None
        return
    try:
        yield path
    finally:
        try:
            prof.__exit__(None, None, None)
            t_close = _trace.monotime()
            out = os.path.join(path, TRACE_FILE)
            prof.export_chrome_trace(out)
            add_spans(out, t_open, t_close)
        except Exception as e:  # noqa: BLE001
            _PROFILER_OK = False
            log.warning("torch profiler capture failed to stop (%s: %s); "
                        "disabling for this process", type(e).__name__, e)


def add_spans(trace_path: str, t_open: float, t_close: float) -> int:
    """Add the tracer's spans that began at or after ``t_open`` and ended
    by ``t_close`` to the profiler's Chrome trace at ``trace_path``,
    whose ``SYNC_MARK`` range began at tracer time ``t_open``.  Returns
    the number of spans added (none unless the tracer records)."""
    tr = _trace.tracer()
    lo, hi = t_open - tr.epoch, t_close - tr.epoch
    spans = [s for s in tr.spans()
             if s["ts"] >= lo and s["ts"] + s["dur"] <= hi]
    if not spans:
        return 0
    with open(trace_path, encoding="utf-8") as fh:
        obj = json.load(fh)
    events = obj.setdefault("traceEvents", [])
    mark = next((e for e in events
                 if e.get("name") == SYNC_MARK and e.get("ph") == "X"), None)
    if mark is None:
        log.warning("profiler trace %s lacks its marker; spans not added",
                    trace_path)
        return 0
    # Microseconds to add to a span's tracer-relative ts.
    shift = float(mark["ts"]) - lo * 1e6
    for e in _trace.chrome_trace(spans)["traceEvents"]:
        if "ts" in e:
            e["ts"] = e["ts"] + shift
        events.append(e)
    with open(trace_path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    return len(spans)


@contextmanager
def solve_profile(round_index: int):
    """Capture window around one round's solve: yields the artifact
    directory ``<POSEIDON_JAX_PROFILE>/round_<n>`` when a capture is
    running, else None."""
    root = profile_dir()
    if not root:
        yield None
        return
    with capture(os.path.join(root, f"round_{int(round_index):06d}")) as p:
        yield p


def observe_device_memory(registry=None) -> int:
    """Feed per-device memory gauges into the Prometheus registry.

    Exports, per CUDA device (label ``device`` = ``cuda:<id>``):

    - ``poseidon_device_bytes_in_use`` (``torch.cuda.memory_allocated``),
      ``_peak_bytes_in_use`` (``max_memory_allocated``) and
      ``_bytes_limit`` (``mem_get_info``'s total);
    - ``poseidon_live_buffers`` (unlabeled): the caching allocator's
      live blocks over every device (``memory_stats()
      ["active.all.current"]``), the leak canary the resident-operand
      cache and warm frames are watched with.

    Returns the number of devices that reported.  Reads nothing unless
    torch is already imported and CUDA already initialised.
    """
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    from poseidon_tpu_torch.obs import metrics as obs_metrics

    reg = registry or obs_metrics.default_registry()
    reported = 0
    live = 0
    for idx in range(torch.cuda.device_count()):
        try:
            stats = {
                "poseidon_device_bytes_in_use":
                    torch.cuda.memory_allocated(idx),
                "poseidon_device_peak_bytes_in_use":
                    torch.cuda.max_memory_allocated(idx),
                "poseidon_device_bytes_limit":
                    torch.cuda.mem_get_info(idx)[1],
            }
            live += int(torch.cuda.memory_stats(idx).get(
                "active.all.current", 0))
        except Exception:  # noqa: BLE001 - a device without the API
            continue
        label = f"cuda:{idx}"
        for gauge_name, value in stats.items():
            reg.gauge(
                gauge_name,
                "CUDA device memory sampled at round boundaries",
                ("device",),
            ).set(float(value), label)
        reported += 1
    if reported:
        reg.gauge(
            "poseidon_live_buffers",
            "Live caching-allocator blocks in the process (leak canary "
            "for the resident-operand cache and warm frames)",
        ).set(float(live))
    return reported


def _reset_for_tests() -> None:
    global _PROFILER_OK
    _PROFILER_OK = True

"""Trace replay: cluster-trace-driven scheduling simulation.

The reference's data model carries trace-replay hooks
(``trace_job_id``/``trace_task_id``, task_desc.proto:98-99;
``trace_machine_id``, resource_desc.proto:80) because Firmament was
validated by replaying the Google cluster trace (README.md:4, OSDI'16).
The repo itself ships no replay harness — SURVEY.md section 4 flags that
as the gap this package fills: a synthetic Google-trace-shaped workload
generator plus a driver that replays it against the scheduler (in-process
planner or the full gRPC service) and reports per-round latency and
placement quality.  The port of the JAX package's ``replay/``; the
driver's planner solves on the CUDA card unless the caller passes
``device="cpu"``.  The driver's names load on first use, so the
numpy-only trace generator imports without torch.
"""

from poseidon_tpu_torch.replay.trace import TraceEvent, synthesize_trace
from poseidon_tpu_torch.replay.flight import (
    flight_trace_events,
    load_flight,
    redrive_flight,
)

__all__ = [
    "TraceEvent",
    "synthesize_trace",
    "ReplayDriver",
    "ReplayReport",
    "flight_trace_events",
    "load_flight",
    "redrive_flight",
]


def __getattr__(name: str):
    if name in ("ReplayDriver", "ReplayReport"):
        from poseidon_tpu_torch.replay import driver

        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

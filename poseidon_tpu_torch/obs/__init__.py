"""poseidon_tpu_torch.obs — the scheduler's own telemetry plane (the JAX
package's ``obs/``; no module here imports torch).

- ``obs.trace``   — a thread-safe hierarchical span tracer over the
  glue loop and RPC attempts, with Chrome-trace-event JSON export
  loadable in Perfetto, and a zero-overhead disabled path;
- ``obs.history`` — the bounded ring of the last rounds' metrics behind
  ``/debug/rounds``;
- ``obs.metrics`` — a Prometheus-style metrics registry
  (counters/gauges/histograms with text exposition served over HTTP),
  fed from ``RoundMetrics``, the glue ``LoopStats``, the client's retry
  machinery, and the lock ledger.
"""

from poseidon_tpu_torch.obs import metrics, trace

__all__ = ["metrics", "trace"]

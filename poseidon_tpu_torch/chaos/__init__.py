"""Chaos: deterministic fault injection for the whole scheduler stack
(the port of the JAX package's ``chaos/``; its server solves on the CUDA
card unless the caller passes ``device="cpu"``).

The reference Poseidon is production cluster glue — it has to survive API
watch drops, Firmament RPC failures, and partial enactment — but ships no
way to *prove* it does.  This package makes robustness a gated property
instead of an asserted one:

- ``plan``: a declarative, seed-reproducible ``FaultPlan`` — which fault
  fires in which round, drawn from a seeded RNG so every soak is
  re-runnable bit-for-bit;
- ``inject``: thin proxies around the production seams (``KubeAPI``
  watches/bind, the ``FirmamentClient`` RPC stubs, the planner's solve
  path) that fire the armed faults while the REAL code paths do the
  surviving — nothing is mocked around;
- ``recorder``: a flight recorder that snapshots a failing soak round
  (workload spec, fault plan, per-round deltas/metrics/digests) as a
  JSON trace the replay harness can load and re-drive offline;
- ``soak``: the harness — N rounds of the full glue+service stack under
  a named fault plan, asserting convergence, zero state divergence
  (fake-kube truth == scheduler view after every round), and the
  budget-0 ledger quartet on warm rounds (compile, transfer, numerics,
  lock order; check/ledger.py and utils/locks.py).

Fault plans read no wall clock and draw from seeded RNGs only.
"""

from poseidon_tpu_torch.chaos.plan import FAMILIES, Fault, FaultPlan, named_plan
from poseidon_tpu_torch.chaos.inject import (
    ChaoticKube,
    FaultInjector,
    InjectedBindError,
    InjectedRpcError,
    chaotic_client,
)
from poseidon_tpu_torch.chaos.recorder import FlightRecorder, FlightTrace
from poseidon_tpu_torch.chaos.soak import run_soak

__all__ = [
    "FAMILIES",
    "Fault",
    "FaultPlan",
    "named_plan",
    "ChaoticKube",
    "FaultInjector",
    "InjectedBindError",
    "InjectedRpcError",
    "chaotic_client",
    "FlightRecorder",
    "FlightTrace",
    "run_soak",
]

"""Trace-driven scenario harness: production-shaped workload
generators, full-stack drives in both loop modes, robustness scoring
under chaos-seeded cost perturbation, and flight-recorder replay.

- ``plan``: declarative, seeded ``ScenarioPlan`` (the FaultPlan twin);
- ``generate``: the named scenario registry (diurnal, flash_crowd,
  node_churn, rolling_restart, multi_tenant);
- ``drive``: a plan through the FULL glue loop with the shared harness
  gates (chaos/harness.py), sync or streaming;
- ``score``: robustness = objective-regression quantiles across
  perturbation seeds (the JAX package's docs/SCENARIOS.md has the
  metric definition).

The port of the JAX package's ``scenario/``: drives run the port's
server on the CUDA card unless the caller passes ``device="cpu"``.
"""

from poseidon_tpu_torch.scenario.generate import (
    SCENARIOS,
    SETTLE_ROUNDS,
    named_scenario,
)
from poseidon_tpu_torch.scenario.plan import (
    PodArrival,
    ScenarioPlan,
    ScenarioRound,
    workload_events,
)

# The drive's and the scorer's names load on first use, so the
# numpy-only plan and generators import without torch.
_LAZY = {
    "drive_scenario": "drive", "scenario_digest": "drive",
    "scenario_out_dir": "drive", "PerturbedCostModel": "score",
    "score_scenario": "score",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(
            f"poseidon_tpu_torch.scenario.{_LAZY[name]}"
        )
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SCENARIOS",
    "SETTLE_ROUNDS",
    "PodArrival",
    "PerturbedCostModel",
    "ScenarioPlan",
    "ScenarioRound",
    "drive_scenario",
    "named_scenario",
    "scenario_digest",
    "scenario_out_dir",
    "score_scenario",
    "workload_events",
]

"""Robustness scoring: scenarios under chaos-seeded cost perturbation.

The scorer re-drives a scenario with the planner's cost model wrapped
in a ``PerturbedCostModel``: every admissible cost cell gets a bounded,
deterministic noise term keyed on (perturbation seed, EC id, machine
uuid) — a pure per-cell hash, so the SAME (plan, perturbation seed)
always prices identically regardless of row/column order, and two
different seeds price like two different production cost surfaces.
Inadmissible arcs (INF_COST) are never touched, costs stay clipped to
the inner model's static ``max_cost`` bound (no fresh compile keys),
and EVERY correctness gate stays armed — byte-identity, the budget-0
ledger quartet, tier vocabulary.  Only the placements and the objective
are allowed to move.

The robustness metric is the objective-regression distribution across
perturbation seeds (the framing of "Robust Scheduling with GFlowNets",
PAPERS.md 2302.05446): for each seed, the relative objective regression
vs the unperturbed baseline; reported as p50/p90/max quantiles plus

    robustness_score = 1 / (1 + p90(|regression|))

so 1.0 means the schedule quality is insensitive to cost noise and the
score decays toward 0 as sensitivity grows.  A perturbed run that fails
ANY gate zeroes the score — a scheduler that diverges or recompiles
under cost noise is not robust, whatever its objective says.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List, Optional, Sequence, Union

import numpy as np

from poseidon_tpu_torch.costmodel.base import (
    CostMatrices,
    CostModel,
    NORMALIZED_COST,
)
from poseidon_tpu_torch.scenario.plan import ScenarioPlan
from poseidon_tpu_torch.utils.hatches import hatch_float, hatch_int

log = logging.getLogger("poseidon.scenario.score")

# Cost cells at or above this are inadmissibility sentinels, never
# perturbed (ops/transport.INF_COST is 1 << 28; every finite model cost
# is clipped to max_cost() <= 8 * NORMALIZED_COST, far below).
_ADMISSIBLE_BELOW = 1 << 28


def perturb_amplitude() -> float:
    """Perturbation amplitude as a fraction of NORMALIZED_COST
    (hatch-controlled)."""
    return hatch_float("POSEIDON_SCENARIO_AMPLITUDE")


def perturb_seed_count() -> int:
    """How many chaos-seeded perturbation runs a score uses
    (hatch-controlled)."""
    return hatch_int("POSEIDON_SCENARIO_SEEDS")


def _uuid_keys(uuids: Sequence[str]) -> np.ndarray:
    """Stable uint64 key per machine uuid (content hash, never
    Python's randomized ``hash``)."""
    return np.array(
        [
            int.from_bytes(
                hashlib.blake2b(u.encode(), digest_size=8).digest(),
                "little",
            )
            for u in uuids
        ],
        dtype=np.uint64,
    )


def _cell_noise(ec_ids: np.ndarray, uuid_keys: np.ndarray, seed: int,
                amplitude: float) -> np.ndarray:
    """int32 [E, M] noise in [-amplitude, +amplitude] * NORMALIZED_COST,
    a pure function of (seed, EC id, machine uuid) per cell — row/column
    slicing or reordering cannot change any cell's value."""
    with np.errstate(over="ignore"):
        row = ec_ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        col = uuid_keys * np.uint64(0xC2B2AE3D27D4EB4F)
        mix = (
            row[:, None] ^ col[None, :]
        ) + np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * np.uint64(
            0xD6E8FEB86659FD93
        )
        # splitmix64-style finalizer: decorrelate the low bits.
        mix ^= mix >> np.uint64(30)
        mix *= np.uint64(0xBF58476D1CE4E5B9)
        mix ^= mix >> np.uint64(27)
        mix *= np.uint64(0x94D049BB133111EB)
        mix ^= mix >> np.uint64(31)
    frac = (mix >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return np.rint(
        (frac * 2.0 - 1.0) * amplitude * NORMALIZED_COST
    ).astype(np.int32)


class PerturbedCostModel(CostModel):
    """A cost model wrapper adding deterministic per-cell noise.

    ``delta_plane`` is forced off: the wrapper prices full builds only,
    so the delta-plane cache can never mix perturbed and unperturbed
    cells.  Capacity, arc capacity, and the unscheduled-cost vector are
    forwarded untouched — the perturbation moves preferences, not
    feasibility."""

    def __init__(self, inner: CostModel, *, seed: int,
                 amplitude: Optional[float] = None) -> None:
        self.inner = inner
        self.seed = int(seed)
        self.amplitude = (
            float(amplitude) if amplitude is not None
            else perturb_amplitude()
        )
        self.name = f"{inner.name}+perturb{self.seed}"

    delta_plane = False

    def build(self, ecs, machines) -> CostMatrices:
        cm = self.inner.build(ecs, machines)
        noise = _cell_noise(
            ecs.ec_ids, _uuid_keys(machines.uuids), self.seed,
            self.amplitude,
        )
        costs = cm.costs.copy()
        admissible = costs < _ADMISSIBLE_BELOW
        perturbed = np.clip(
            costs.astype(np.int64) + noise.astype(np.int64),
            0, self.inner.max_cost(),
        ).astype(np.int32)
        costs[admissible] = perturbed[admissible]
        return CostMatrices(
            costs=costs,
            unsched_cost=cm.unsched_cost,
            capacity=cm.capacity,
            arc_capacity=cm.arc_capacity,
        )

    def build_unsched(self, ecs) -> np.ndarray:
        return self.inner.build_unsched(ecs)

    def build_capacity(self, machines) -> np.ndarray:
        return self.inner.build_capacity(machines)

    def max_cost(self) -> int:
        return self.inner.max_cost()


def score_scenario(
    plan: Union[ScenarioPlan, str],
    *,
    machines: Optional[int] = None,
    rounds: Optional[int] = None,
    seed: int = 0,
    streaming: bool = False,
    baseline: Optional[dict] = None,
    perturb_seeds: Optional[Sequence[int]] = None,
    amplitude: Optional[float] = None,
    device: Optional[str] = None,
) -> dict:
    """Robustness score for one scenario (see module docstring).

    ``baseline`` may pass in an existing unperturbed drive result (the
    bench rung reuses its identity-leg drive) — otherwise one is driven
    here.  ``perturb_seeds`` defaults to ``1..POSEIDON_SCENARIO_SEEDS``.
    ``device`` is every drive's server device (the card unless
    ``"cpu"``).
    """
    from poseidon_tpu_torch.scenario.drive import drive_scenario
    from poseidon_tpu_torch.scenario.generate import named_scenario

    if isinstance(plan, str):
        plan = named_scenario(
            plan, machines=machines or 32, rounds=rounds or 8, seed=seed
        )
    amplitude = (
        float(amplitude) if amplitude is not None else perturb_amplitude()
    )
    seeds = (
        tuple(perturb_seeds) if perturb_seeds is not None
        else tuple(range(1, perturb_seed_count() + 1))
    )
    base = baseline or drive_scenario(
        plan, streaming=streaming, device=device
    )
    runs: List[dict] = [
        drive_scenario(
            plan, streaming=streaming, perturb_seed=s,
            amplitude=amplitude, device=device,
        )
        for s in seeds
    ]
    base_obj = max(int(base.get("objective", 0)), 1)
    regressions = [
        (int(r.get("objective", 0)) - base_obj) / base_obj for r in runs
    ]
    abs_reg = [abs(x) for x in regressions]
    gates_ok = bool(base.get("ok")) and all(r.get("ok") for r in runs)
    p90 = float(np.percentile(abs_reg, 90)) if abs_reg else 0.0
    # How far the noise moves the PLACEMENTS, not just the price tag:
    # fraction of rounds whose placement digest left the baseline's.
    moved = []
    for r in runs:
        pairs = list(zip(base.get("digests") or [],
                         r.get("digests") or []))
        if pairs:
            moved.append(
                sum(1 for a, b in pairs if a != b) / len(pairs)
            )
    out = {
        "ok": gates_ok,
        "scenario": plan.name,
        "seed": plan.seed,
        "mode": base.get("mode"),
        "amplitude": amplitude,
        "perturb_seeds": list(seeds),
        "objective_base": int(base.get("objective", 0)),
        "objectives": [int(r.get("objective", 0)) for r in runs],
        "regressions": [round(x, 6) for x in regressions],
        "regression_p50": round(
            float(np.percentile(abs_reg, 50)) if abs_reg else 0.0, 6
        ),
        "regression_p90": round(p90, 6),
        "regression_max": round(max(abs_reg) if abs_reg else 0.0, 6),
        "placement_divergence": round(
            float(np.mean(moved)) if moved else 0.0, 4
        ),
        "robustness_score": (
            round(1.0 / (1.0 + p90), 4) if gates_ok else 0.0
        ),
        "gates_ok": gates_ok,
    }
    if not gates_ok:
        out["failures"] = [
            {"perturb_seed": s, "failure": r.get("failure")}
            for s, r in zip(seeds, runs) if not r.get("ok")
        ] + ([{"perturb_seed": None, "failure": base.get("failure")}]
             if not base.get("ok") else [])
    return out

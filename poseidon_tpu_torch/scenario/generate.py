"""Composable generators for the named, production-shaped scenarios.

Each generator is a pure function of (machines, rounds, seed): the same
inputs always materialize the same ``ScenarioPlan`` bit-for-bit (the
randomized determinism suite pins this).  All generators draw pod
request shapes from the harness's ``POD_SHAPES`` — the narrow factor
range that keeps every round inside the precompiled solver size bands,
so the warm-round budget-0 compile gate holds across every scenario.

The committed registry (``named_scenario``):

================  =========================================================
scenario          shape
================  =========================================================
diurnal           sinusoidal arrival rate over the day-curve period with
                  completions tracking the trough — the baseline
                  production load curve
flash_crowd       quiet baseline, then a one-round arrival burst (one
                  owner-grouped crowd job) decaying over two rounds
node_churn        steady churn while an autoscaler adds fresh nodes and
                  drain+cordons old ones (fleet size roughly constant)
rolling_restart   a fixed fleet of deployments restarted in waves: each
                  round completes the oldest K pods and resubmits K
                  replacements
multi_tenant      three tenants on a zoned fleet under quota weights:
                  gang-scheduled batch jobs (zone a), anti-affinity
                  spread serving replicas (zone b), unconstrained
                  best-effort fill (any zone)
================  =========================================================

Every plan ends with two settle rounds (no arrivals, completions keep
draining) so the end-of-drive "everything placed" gate is meaningful
under the same contract as the chaos soak.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from poseidon_tpu_torch.chaos.harness import POD_SHAPES
from poseidon_tpu_torch.scenario.plan import (
    KVPairs,
    PodArrival,
    ScenarioPlan,
    ScenarioRound,
    kv,
)

SETTLE_ROUNDS = 2

SCENARIOS: Tuple[str, ...] = (
    "diurnal", "flash_crowd", "node_churn", "rolling_restart",
    "multi_tenant",
)


def _rng(name: str, seed: int) -> np.random.Generator:
    """Seeded per-scenario stream: the name is folded in through a
    stable content hash (never Python's randomized ``hash``) so two
    scenarios sharing a seed do not share a stream."""
    name_key = int(hashlib.sha256(name.encode()).hexdigest()[:8], 16)
    return np.random.default_rng([seed, name_key])


def _shape(rng: np.random.Generator) -> Tuple[int, int]:
    return POD_SHAPES[int(rng.integers(len(POD_SHAPES)))]


def _arrival(name: str, rng: np.random.Generator, *, owner: str = "",
             labels: KVPairs = (), node_selector: KVPairs = (),
             pod_affinity: KVPairs = (),
             pod_anti_affinity: KVPairs = ()) -> PodArrival:
    cpu, ram = _shape(rng)
    return PodArrival(
        name=name, cpu=cpu, ram=ram, owner=owner, labels=labels,
        node_selector=node_selector, pod_affinity=pod_affinity,
        pod_anti_affinity=pod_anti_affinity,
    )


def _settle(rounds: List[ScenarioRound], *, completions: int = 0,
            deletions: int = 0) -> None:
    """Append the two settle rounds every plan ends with."""
    for _ in range(SETTLE_ROUNDS):
        rounds.append(ScenarioRound(
            round_index=len(rounds), completions=completions,
            deletions=deletions,
        ))


def gen_diurnal(machines: int, rounds: int, seed: int) -> ScenarioPlan:
    """Sinusoidal load curve: arrivals per round ride one full diurnal
    period across the active rounds; completions lag two rounds so the
    live population breathes with the curve but stays bounded."""
    rng = _rng("diurnal", seed)
    base_pop = machines * 2
    rate = max(machines // 2, 4)
    period = max(rounds - 1, 4)
    plan_rounds: List[ScenarioRound] = []
    arrivals_hist: List[int] = []
    for r in range(rounds):
        if r == 0:
            n = base_pop
        else:
            phase = 2.0 * math.pi * (r - 1) / period
            n = max(int(round(rate * (1.0 + 0.8 * math.sin(phase)))), 1)
        arrivals = tuple(
            _arrival(
                f"diurnal-r{r}-{i}", rng,
                owner=f"diurnal-job-r{r}-{i % 3}" if i % 4 == 0 else "",
            )
            for i in range(n)
        )
        completions = arrivals_hist[r - 2] if r >= 2 else 0
        deletions = arrivals_hist[r - 3] if r >= 3 else 0
        arrivals_hist.append(n)
        plan_rounds.append(ScenarioRound(
            round_index=r, arrivals=arrivals, completions=completions,
            deletions=deletions,
        ))
    _settle(plan_rounds, completions=rate, deletions=rate)
    return ScenarioPlan(
        name="diurnal", seed=seed, machines=machines,
        rounds=tuple(plan_rounds),
    )


def gen_flash_crowd(machines: int, rounds: int, seed: int) -> ScenarioPlan:
    """Flash crowd: a quiet baseline churn, then one round admits a
    burst several times the steady rate (owner-grouped into a handful
    of crowd jobs), decaying over the following two rounds; the crowd
    cohort then completes in bulk."""
    rng = _rng("flash_crowd", seed)
    quiet = max(machines // 8, 2)
    burst_round = max(rounds // 2, 2)
    burst = machines * 3
    plan_rounds: List[ScenarioRound] = []
    for r in range(rounds):
        if r == 0:
            n, tag = machines * 2, "base"
        elif r == burst_round:
            n, tag = burst, "crowd"
        elif r == burst_round + 1:
            n, tag = burst // 2, "crowd"
        elif r == burst_round + 2:
            n, tag = burst // 4, "crowd"
        else:
            n, tag = quiet, "base"
        arrivals = tuple(
            _arrival(
                f"flash-{tag}-r{r}-{i}", rng,
                owner=(
                    f"flash-crowd-r{r}-{i % 4}" if tag == "crowd" else ""
                ),
            )
            for i in range(n)
        )
        # The crowd drains as fast as it came: completions shadow the
        # burst two rounds back, so capacity recovers before the end
        # gate.
        if r >= 2 and r - 2 >= burst_round:
            completions = (
                burst if r - 2 == burst_round
                else burst // 2 if r - 2 == burst_round + 1
                else burst // 4 if r - 2 == burst_round + 2
                else quiet
            )
        else:
            completions = quiet if r >= 2 else 0
        plan_rounds.append(ScenarioRound(
            round_index=r, arrivals=arrivals, completions=completions,
            deletions=completions if r >= 3 else 0,
        ))
    _settle(plan_rounds, completions=burst // 4, deletions=burst // 4)
    return ScenarioPlan(
        name="flash_crowd", seed=seed, machines=machines,
        rounds=tuple(plan_rounds),
    )


def gen_node_churn(machines: int, rounds: int, seed: int) -> ScenarioPlan:
    """Autoscaler node churn: steady workload churn while the fleet
    rolls — every other round adds a fresh node, alternating rounds
    drain+cordon one of the originals, holding capacity roughly
    constant while machine add/remove paths run every round."""
    rng = _rng("node_churn", seed)
    churn = max(machines // 4, 4)
    plan_rounds: List[ScenarioRound] = []
    added = 0
    drained = 0
    # Never drain more than a quarter of the fleet: the end gate needs
    # headroom to place everything after the churn stops.
    max_drains = max(machines // 4, 1)
    for r in range(rounds):
        n = machines * 2 if r == 0 else churn
        arrivals = tuple(
            _arrival(f"nodechurn-r{r}-{i}", rng)
            for i in range(n)
        )
        add_nodes: Tuple[str, ...] = ()
        drain_nodes: Tuple[str, ...] = ()
        if r >= 2 and r % 2 == 0:
            add_nodes = (f"m{machines + added:04d}",)
            added += 1
        if r >= 3 and r % 2 == 1 and drained < min(added, max_drains):
            drain_nodes = (f"m{drained:04d}",)
            drained += 1
        plan_rounds.append(ScenarioRound(
            round_index=r, arrivals=arrivals,
            completions=churn if r >= 2 else 0,
            deletions=churn if r >= 3 else 0,
            drain_nodes=drain_nodes, add_nodes=add_nodes,
        ))
    _settle(plan_rounds, completions=churn, deletions=churn)
    return ScenarioPlan(
        name="node_churn", seed=seed, machines=machines,
        rounds=tuple(plan_rounds),
    )


def gen_rolling_restart(machines: int, rounds: int,
                        seed: int) -> ScenarioPlan:
    """Rolling-restart storm: a fixed fleet of deployment pods is
    restarted in waves — each active round completes the K oldest
    Running pods and resubmits K replacements, so the live population
    holds steady while every round exercises the full finish+resubmit
    lifecycle at storm rate."""
    rng = _rng("rolling_restart", seed)
    base_pop = machines * 3
    wave = max(machines // 2, 4)
    plan_rounds: List[ScenarioRound] = []
    for r in range(rounds):
        if r == 0:
            arrivals = tuple(
                _arrival(
                    f"restart-base-{i}", rng,
                    owner=f"restart-deploy-{i % 4}",
                )
                for i in range(base_pop)
            )
            completions = 0
        else:
            arrivals = tuple(
                _arrival(
                    f"restart-r{r}-{i}", rng,
                    owner=f"restart-deploy-{i % 4}",
                )
                for i in range(wave)
            )
            completions = wave
        plan_rounds.append(ScenarioRound(
            round_index=r, arrivals=arrivals, completions=completions,
            deletions=wave if r >= 2 else 0,
        ))
    _settle(plan_rounds, completions=wave, deletions=wave)
    return ScenarioPlan(
        name="rolling_restart", seed=seed, machines=machines,
        rounds=tuple(plan_rounds),
    )


def _zones(machines: int) -> Dict[str, Dict[str, str]]:
    """Three equal zones over the initial fleet (multi_tenant)."""
    labels: Dict[str, Dict[str, str]] = {}
    for i in range(machines):
        labels[f"m{i:04d}"] = {"zone": f"z{i % 3}"}
    return labels


def gen_multi_tenant(machines: int, rounds: int,
                     seed: int) -> ScenarioPlan:
    """Mixed multi-tenant fleet on zoned machines, quota-weighted:

    - tenant-batch (quota 50%): gang-scheduled jobs (``gangScheduling``
      label, one owner per gang) pinned to zone z0 by nodeSelector;
    - tenant-serving (quota 30%): replica sets spread by
      pod_anti_affinity on their own app label, pinned to zone z1;
    - tenant-be (quota 20%): unconstrained best-effort fill, any zone.

    Quota is admission-shaped: each tenant's arrivals are capped at its
    weight of the per-round budget, so the generated demand respects
    the fleet split the way a quota admission controller would."""
    rng = _rng("multi_tenant", seed)
    budget = max(machines, 12)  # pods per active round, all tenants
    quotas = {"batch": 0.5, "serving": 0.3, "be": 0.2}
    zone_nodes = max(machines // 3, 1)
    gang_size = min(4, max(zone_nodes // 2, 2))
    plan_rounds: List[ScenarioRound] = []
    gang_seq = 0
    app_seq = 0
    for r in range(rounds):
        scale = 2 if r == 0 else 1
        arrivals: List[PodArrival] = []
        # tenant-batch: whole gangs only (a partial gang would violate
        # the atomic-placement contract this scenario exists to drive).
        n_batch = int(budget * quotas["batch"] * scale)
        for _ in range(max(n_batch // gang_size, 1)):
            owner = f"mt-batch-gang-{gang_seq}"
            gang_seq += 1
            cpu, ram = _shape(rng)
            for m in range(gang_size):
                arrivals.append(PodArrival(
                    name=f"mt-batch-r{r}-{owner.rsplit('-', 1)[-1]}-{m}",
                    cpu=cpu, ram=ram, owner=owner,
                    labels=kv({
                        "tenant": "batch", "gangScheduling": "true",
                    }),
                    node_selector=kv({"zone": "z0"}),
                ))
        # tenant-serving: small replica sets, one app label each,
        # anti-affinity against themselves -> at most one replica per
        # machine (spread), zone-pinned.
        n_serving = int(budget * quotas["serving"] * scale)
        replicas = min(3, zone_nodes)
        for _ in range(max(n_serving // replicas, 1)):
            app = f"mt-app-{app_seq}"
            app_seq += 1
            cpu, ram = _shape(rng)
            for m in range(replicas):
                arrivals.append(PodArrival(
                    name=f"mt-serve-r{r}-{app.rsplit('-', 1)[-1]}-{m}",
                    cpu=cpu, ram=ram,
                    labels=kv({"tenant": "serving", "app": app}),
                    node_selector=kv({"zone": "z1"}),
                    pod_anti_affinity=kv({"app": app}),
                ))
        # tenant-be: unconstrained fill.
        n_be = int(budget * quotas["be"] * scale)
        for i in range(max(n_be, 1)):
            arrivals.append(_arrival(
                f"mt-be-r{r}-{i}", rng,
                labels=kv({"tenant": "be"}),
            ))
        plan_rounds.append(ScenarioRound(
            round_index=r, arrivals=tuple(arrivals),
            completions=budget if r >= 2 else 0,
            deletions=budget if r >= 3 else 0,
        ))
    _settle(plan_rounds, completions=budget, deletions=budget)
    return ScenarioPlan(
        name="multi_tenant", seed=seed, machines=machines,
        rounds=tuple(plan_rounds),
        node_labels=tuple(
            (name, kv(labels))
            for name, labels in sorted(_zones(machines).items())
        ),
    )


_GENERATORS: Dict[str, Callable[[int, int, int], ScenarioPlan]] = {
    "diurnal": gen_diurnal,
    "flash_crowd": gen_flash_crowd,
    "node_churn": gen_node_churn,
    "rolling_restart": gen_rolling_restart,
    "multi_tenant": gen_multi_tenant,
}


def named_scenario(name: str, *, machines: int = 32, rounds: int = 8,
                   seed: int = 0) -> ScenarioPlan:
    """The committed scenario registry."""
    try:
        gen = _GENERATORS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(SCENARIOS)}"
        ) from None
    return gen(machines, rounds, seed)

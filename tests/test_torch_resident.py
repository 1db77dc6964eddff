"""The device-resident operand cache (``POSEIDON_RESIDENT``) against the
JAX package's ``_RESIDENT``.

A seeded warm re-solve sequence runs with the cache forced on in both
packages, on the CPU: a cold solve, warm re-solves after a few columns'
costs and capacities change (the diff branch), one re-solve past the
``M_pad / 4`` gate (the wholesale branch), solves at five more padded
shapes (the LRU of four), and a return to the first shape.  Every
solution field is bit-equal, each solve scatters the same columns, and
the host copies equal the JAX cache's; the port's resident tensor equals
its host copy after every solve (the fold).

The JAX package is imported inside the parity tests only, so the card
test runs without JAX (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import transport as T

FIELDS = ("flows", "unsched", "prices", "objective", "gap_bound",
          "iterations", "bf_sweeps", "phase_iters")
E = 12


def _instance(rng, M):
    costs = rng.integers(1, 2000, (E, M)).astype(np.int32)
    supply = rng.integers(5, 40, E).astype(np.int32)
    cap = rng.integers(1, 4, M).astype(np.int32)
    unsched = np.full(E, 6000, np.int32)
    return costs, supply, cap, unsched


def _perturb(rng, inst, ncols):
    costs, supply, cap, unsched = (a.copy() for a in inst)
    cols = rng.choice(costs.shape[1], ncols, replace=False)
    costs[:, cols] = rng.integers(1, 2000, (E, ncols))
    cap[cols] = rng.integers(1, 4, ncols)
    return costs, supply, cap, unsched


def _sequence(seed):
    """(instance, warm?) steps of the sequence, from one seed."""
    rng = np.random.default_rng(seed)
    base = _instance(rng, 200)
    steps = [(base, False)]
    cur = base
    for ncols in (1, 3, 6):  # diff branch (M_pad 256: gate at 64)
        cur = _perturb(rng, cur, ncols)
        steps.append((cur, True))
    cur = _perturb(rng, cur, 100)  # wholesale branch
    steps.append((cur, True))
    for M in (260, 330, 420, 520, 700):  # five more shapes: LRU of 4
        steps.append((_instance(rng, M), False))
    steps.append((_perturb(rng, cur, 2), True))  # first shape evicted
    return steps


def _drive(mod, steps, **kw):
    scattered = []
    real = mod._resident_scatter_cols

    def spy(dev_big, idx, payload):
        if isinstance(idx, torch.Tensor):
            idx_h = idx.cpu().numpy()
        else:
            idx_h = np.asarray(idx)
        scattered.append(np.unique(idx_h).tolist())
        return real(dev_big, idx, payload)

    mod._resident_scatter_cols = spy
    sols, events, hosts = [], [], []
    prev = None
    try:
        for inst, warm in steps:
            costs, supply, cap, unsched = inst
            warm_kw = {}
            if warm and prev is not None and prev.flows.shape == costs.shape:
                warm_kw = dict(init_flows=prev.flows, init_prices=prev.prices,
                               init_unsched=prev.unsched)
            n0 = len(scattered)
            prev = mod.solve_transport(costs, supply, cap, unsched,
                                       **warm_kw, **kw)
            sols.append(prev)
            events.append(scattered[n0:])
            hosts.append({k: v["host"].copy()
                          for k, v in mod._RESIDENT.items()})
            if mod is T:
                for v in T._RESIDENT.values():
                    assert np.array_equal(v["dev"].cpu().numpy(), v["host"])
    finally:
        mod._resident_scatter_cols = real
    return sols, events, hosts


@pytest.fixture()
def J(monkeypatch):
    from poseidon_tpu.ops import transport as J

    monkeypatch.setenv("POSEIDON_RESIDENT", "1")
    monkeypatch.setattr(J, "_RESIDENT", {})
    monkeypatch.setattr(T, "_RESIDENT", {})
    return J


@pytest.mark.parametrize("seed", [0, 1])
def test_warm_resolve_sequence_matches_reference(J, seed):
    steps = _sequence(seed)
    j_sols, j_events, j_hosts = _drive(J, steps)
    t_sols, t_events, t_hosts = _drive(T, steps, device="cpu")
    for i, (a, b) in enumerate(zip(j_sols, t_sols)):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), (i, f)
    assert t_events == j_events
    # Both branches and the LRU were exercised.
    assert any(ev and len(ev[0]) <= 6 for ev in t_events)
    assert t_events[4] == []  # wholesale: a full upload, no scatter
    assert len(t_hosts[-2]) == 4 and (16, 256) not in t_hosts[-2]
    for jh, th in zip(j_hosts, t_hosts):
        assert list(th) == list(jh)
        for k in jh:
            assert np.array_equal(th[k], jh[k])


def test_cache_off_uploads_whole_and_matches(monkeypatch):
    steps = _sequence(2)[:4]
    monkeypatch.setattr(T, "_RESIDENT", {})
    monkeypatch.setenv("POSEIDON_RESIDENT", "1")
    on, _, _ = _drive(T, steps, device="cpu")
    monkeypatch.setenv("POSEIDON_RESIDENT", "0")
    monkeypatch.setattr(T, "_RESIDENT", {})
    off, events, hosts = _drive(T, steps, device="cpu")
    assert all(ev == [] for ev in events) and hosts[-1] == {}
    for a, b in zip(on, off):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f


def test_cache_policy_is_on_for_cuda_only(monkeypatch):
    monkeypatch.delenv("POSEIDON_RESIDENT", raising=False)
    assert T.accel_policy("POSEIDON_RESIDENT", "cuda") is True
    assert T.accel_policy("POSEIDON_RESIDENT", "cpu") is False
    monkeypatch.setenv("POSEIDON_RESIDENT", "0")
    assert T.accel_policy("POSEIDON_RESIDENT", "cuda") is False


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resident_tensor_stays_equal_to_its_host_copy_on_card(
        cuda_device, monkeypatch):
    monkeypatch.setattr(T, "_RESIDENT", {})
    monkeypatch.delenv("POSEIDON_RESIDENT", raising=False)
    steps = _sequence(3)
    on, events, _ = _drive(T, steps, device=cuda_device)
    for v in T._RESIDENT.values():
        assert v["dev"].device.type == "cuda"
        assert np.array_equal(v["dev"].cpu().numpy(), v["host"])
    assert any(events)
    monkeypatch.setenv("POSEIDON_RESIDENT", "0")
    off, _, _ = _drive(T, steps, device=cuda_device)
    for a, b in zip(on, off):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f

"""The port's transportation solve against the JAX package's, bit for bit.

Same seeded numpy instances into both packages; every field of the result
must be EQUAL (int32 throughout, exact tolerance): flows, unsched, prices,
objective, gap_bound, iterations, bf_sweeps, phase_iters, and the
convergence-telemetry curve (both packages at their default, telemetry
on; tests/test_torch_telemetry.py holds the rings themselves).  The JAX side
runs its lax path (POSEIDON_FUSED=0, POSEIDON_TILED=0) or, for the kernel
routes, its Pallas kernels in interpret mode (POSEIDON_FUSED=1 /
POSEIDON_TILED=1, as its own kernel tests run them).  The port runs on the
CPU, where the fused and per-iteration wrappers run their plain versions;
the CUDA kernels themselves are held against those plain versions on the
card (tests/test_torch_kernels.py and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from poseidon_tpu.ops import transport as J
from poseidon_tpu.ops import transport_fused as J_fused
from poseidon_tpu.ops import transport_tiled as J_tiled
from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.ops import transport_fused as T_fused
from poseidon_tpu_torch.ops import transport_tiled as T_tiled

FIELDS = ("objective", "gap_bound", "iterations", "bf_sweeps",
          "phase_iters", "entry_phase")


def _instance(E, M, seed, contended=False):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = J.INF_COST
    supply = rng.integers(1, 9, size=E).astype(np.int32)
    cap = (
        np.full(M, max(1, int(supply.sum()) // (2 * M) + 1), np.int32)
        if contended
        else rng.integers(1, 12, size=M).astype(np.int32)
    )
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    return costs, supply, cap, unsched, arc


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.flows, b.flows)
    np.testing.assert_array_equal(a.unsched, b.unsched)
    np.testing.assert_array_equal(a.prices, b.prices)
    for name in FIELDS:
        assert getattr(a, name) == getattr(b, name), name
    assert (a.telemetry is None) == (b.telemetry is None)
    if a.telemetry is not None:
        assert a.telemetry.digest() == b.telemetry.digest()


def _new_routes(before):
    return [k for k, n in T._Telemetry.routes.items()
            if n > before.get(k, 0)]


@pytest.fixture()
def lax_path(monkeypatch):
    monkeypatch.setenv("POSEIDON_FUSED", "0")
    monkeypatch.setenv("POSEIDON_TILED", "0")


def _both(fn_name, *args, **kw):
    a = getattr(J, fn_name)(*args, **kw)
    b = getattr(T, fn_name)(*args, device="cpu", **kw)
    _assert_equal(a, b)
    return a, b


@pytest.mark.parametrize("seed", range(3))
def test_cold_with_arc_caps(lax_path, seed):
    costs, supply, cap, unsched, arc = _instance(24, 96, seed)
    a, _ = _both("solve_transport", costs, supply, cap, unsched,
                 arc_capacity=arc)
    assert a.gap_bound == 0.0 and a.iterations > 0


@pytest.mark.parametrize("seed", range(2))
def test_cold_without_arc_caps(lax_path, seed):
    costs, supply, cap, unsched, _ = _instance(16, 80, seed + 10)
    _both("solve_transport", costs, supply, cap, unsched)


def test_contended(lax_path):
    costs, supply, cap, unsched, arc = _instance(16, 64, 7, contended=True)
    a, _ = _both("solve_transport", costs, supply, cap, unsched,
                 arc_capacity=arc)
    assert a.iterations > 0 and a.unsched.sum() > 0


def test_warm_start_after_drift(lax_path):
    costs, supply, cap, unsched, arc = _instance(16, 64, 11)
    first = J.solve_transport(costs, supply, cap, unsched, arc_capacity=arc)
    rng = np.random.default_rng(12)
    costs2 = np.where(
        costs < J.INF_COST,
        np.clip(costs + rng.integers(-40, 41, costs.shape), 0, 999),
        costs,
    ).astype(np.int32)
    _both("solve_transport", costs2, supply, cap, unsched, first.prices,
          arc_capacity=arc, init_flows=first.flows,
          init_unsched=first.unsched, eps_start=41 * 100)


@pytest.mark.parametrize("shape", [(0, 12), (5, 0), (0, 0)])
def test_degenerate_shapes(lax_path, shape):
    E, M = shape
    _both("solve_transport", np.zeros((E, M), np.int32),
          np.full(E, 3, np.int32), np.ones(M, np.int32),
          np.full(E, 7, np.int32))


@pytest.mark.parametrize("seed", range(2))
def test_selective(lax_path, seed):
    # A sparse round: little supply against many columns reduces.
    costs, supply, cap, unsched, arc = _instance(12, 900, seed + 20)
    supply[:] = np.minimum(supply, 2)
    _both("solve_transport_selective", costs, supply, cap, unsched,
          arc_capacity=arc, slack=8)


def test_adaptive_cadence_and_unroll(lax_path, monkeypatch):
    """The accelerator defaults (adaptive global-update cadence, four
    iterations per host read) forced on both sides."""
    monkeypatch.setenv("POSEIDON_ADAPTIVE_BF", "1")
    monkeypatch.setenv("POSEIDON_ITER_UNROLL", "4")
    costs, supply, cap, unsched, arc = _instance(40, 300, 3, contended=True)
    a, _ = _both("solve_transport", costs, supply, cap, unsched,
                 arc_capacity=arc)
    assert a.iterations > 0


def test_fused_route_vs_pallas_interpret(monkeypatch):
    """The port's fused route (its wrapper runs the plain ladder on CPU
    tensors) against the JAX fused Pallas kernel in interpret mode."""
    monkeypatch.setenv("POSEIDON_FUSED", "1")
    costs, supply, cap, unsched, arc = _instance(16, 64, 7, contended=True)
    assert J_fused.fits_vmem(16, 64) and T_fused.fits_vmem(16, 64)
    before = dict(T._Telemetry.routes)
    _both("solve_transport", costs, supply, cap, unsched, arc_capacity=arc)
    assert _new_routes(before) == [("fused", 16, 64)]


def test_tiled_iteration_vs_pallas_interpret():
    """One push/excess/relabel iteration: the port's per-iteration
    wrapper (plain on CPU) against the JAX tiled Pallas kernel in
    interpret mode, at [16, 1024] (two 512-column tiles), with and
    without the local relabel."""
    import jax.numpy as jnp

    E, M = 16, 1024
    costs, supply, cap, unsched, arc = _instance(E, M, 5)
    scale = 100
    rng = np.random.default_rng(6)
    C = np.where(costs >= J.INF_COST, J.INF_COST, costs * scale)
    C = C.astype(np.int32)
    U = (unsched * scale).astype(np.int32)
    Uem = np.minimum(np.minimum(supply[:, None], cap[None, :]), arc)
    F = np.minimum(rng.integers(0, 3, size=(E, M)), Uem).astype(np.int32)
    F[costs >= J.INF_COST] = 0
    Ffb = np.zeros(E, np.int32)
    Fmt = np.minimum(F.sum(0), cap).astype(np.int32)
    pe = -rng.integers(0, 50 * scale, size=E).astype(np.int32)
    pm = -rng.integers(0, 50 * scale, size=M).astype(np.int32)
    pt = np.int32(-20 * scale)
    total = int(supply.sum())
    exc_e = (supply - F.sum(1) - Ffb).astype(np.int32)
    exc_m = (F.sum(0) - Fmt).astype(np.int32)
    exc_t = np.int32(Fmt.sum() + Ffb.sum() - total)
    eps = 400

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))

    ops = dict(C=t(C), U=t(U), Uem=t(Uem), supply=t(supply), cap=t(cap),
               adm=t(costs) < J.INF_COST, total=total)
    st = T._phase_status(t(exc_e), t(exc_m), t(exc_t.reshape(1)),
                         torch.zeros(1, dtype=torch.int32))
    for relabel in (True, False):
        ref = J_tiled._tiled_iteration(
            jnp.asarray(C), jnp.asarray(Uem), jnp.asarray(U[:, None]),
            jnp.asarray(supply[:, None]), jnp.asarray(cap[None, :]),
            jnp.asarray(F), jnp.asarray(Ffb[:, None]),
            jnp.asarray(Fmt[None, :]), jnp.asarray(pe[:, None]),
            jnp.asarray(pm[None, :]), jnp.int32(pt),
            jnp.asarray(exc_e[:, None]), jnp.asarray(exc_m[None, :]),
            jnp.int32(exc_t), eps, 1 if relabel else 0, total,
            interpret=True,
        )
        got = T_tiled.TiledIteration()(
            t(F), t(Ffb), t(Fmt), t(pe), t(pm), t(np.array([pt])),
            t(exc_e), t(exc_m), t(exc_t.reshape(1)), st, eps=eps,
            do_relabel=relabel, **ops,
        )
        names = ("F", "Ffb", "Fmt", "pe", "pm", "pt", "exc_e", "exc_m",
                 "exc_t")
        for name, r, g in zip(names, ref, got[:9]):
            np.testing.assert_array_equal(
                np.asarray(r).reshape(-1), g.numpy().reshape(-1),
                err_msg=name,
            )
        assert int(np.abs(np.asarray(ref[0]) - F).sum()) > 0  # it pushed


def test_tiled_route_full_solve_vs_pallas_interpret(monkeypatch):
    """A whole solve through the per-iteration route on both sides: the
    fused gate is shrunk in both packages so [16, 1024] routes past it,
    as the reference's own tiled tests do."""
    monkeypatch.setenv("POSEIDON_TILED", "1")
    monkeypatch.setenv("POSEIDON_FUSED", "0")
    monkeypatch.setenv("POSEIDON_HOST_CERT", "0")
    monkeypatch.setattr(J_fused, "VMEM_ELEM_BUDGET", 1024)
    monkeypatch.setattr(T_fused, "VMEM_ELEM_BUDGET", 1024)
    J._solve_device_packed.clear_cache()
    costs, supply, cap, unsched, arc = _instance(16, 1024, 8)
    before = dict(T._Telemetry.routes)
    try:
        a, _ = _both("solve_transport", costs, supply, cap, unsched,
                     arc_capacity=arc)
    finally:
        J._solve_device_packed.clear_cache()
    assert _new_routes(before) == [("tiled", 16, 1024)]
    assert a.iterations > 0


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.solve_transport(np.zeros((2, 2), np.int32), np.ones(2, np.int32),
                          np.ones(2, np.int32), np.ones(2, np.int32))


def test_adaptive_ladder_hatch_matches(lax_path, monkeypatch):
    """POSEIDON_ADAPTIVE_LADDER in both packages: on, a warm start the
    host certificate rejects enters the ladder at its certified epsilon;
    "0" restores the caller's drift-bound entry.  Each setting is
    bit-equal across the packages, and the two settings differ."""
    costs, supply, cap, unsched, arc = _instance(16, 64, 11)
    first = J.solve_transport(costs, supply, cap, unsched, arc_capacity=arc)
    rng = np.random.default_rng(12)
    costs2 = np.where(
        costs < J.INF_COST,
        np.clip(costs + rng.integers(-40, 41, costs.shape), 0, 999),
        costs,
    ).astype(np.int32)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("POSEIDON_ADAPTIVE_LADDER", flag)
        out[flag], _ = _both(
            "solve_transport", costs2, supply, cap, unsched, first.prices,
            arc_capacity=arc, init_flows=first.flows,
            init_unsched=first.unsched, eps_start=1 << 20)
    assert out["1"].objective == out["0"].objective
    assert out["1"].phase_iters != out["0"].phase_iters

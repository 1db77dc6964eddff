"""The port's one-program coarse-to-fine wave solve (B5) against the
JAX package's.

Both packages run their program with ``POSEIDON_COARSE_FUSED=1`` (a CPU
run of either defers to its host two-dispatch coarse start otherwise) on
seeded instances of at least ``COARSE_MIN_MACHINES`` machines: every
field of the solution is bit-equal, and the declines agree.  The middle
of the pipeline (dual lift, disaggregation scan, certificate, the full
ladder's schedule) is held to the reference's on crafted coarse results
with tied and inadmissible members and a ragged block padding, by
replacing each package's ladder with one that returns the crafted result
and records what the full ladder is handed.

The JAX package is imported inside the tests, so on the card this file
runs without the repository's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_coarse.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops import transport as T
from poseidon_tpu_torch.ops import transport_coarse as TC

FIELDS = ("objective", "gap_bound", "iterations", "bf_sweeps", "phase_iters",
          "entry_phase", "eps_certified", "telemetry")


def _instance(E, M, seed, *, cap_hi=4, arc=True):
    """A contended wave-shaped instance: load-shaped costs, 5%
    inadmissible arcs, supply well past the narrow columns."""
    rng = np.random.default_rng(seed)
    load = rng.integers(0, 400, size=M)
    base = rng.integers(50, 800, size=E)
    costs = (base[:, None] + load[None, :]).astype(np.int32)
    costs[rng.random((E, M)) < 0.05] = T.INF_COST
    supply = rng.integers(150, 400, size=E).astype(np.int32)
    cap = rng.integers(1, cap_hi, size=M).astype(np.int32)
    unsched = np.full(E, 5000, dtype=np.int32)
    arc_cap = (rng.integers(1, 6, size=(E, M)).astype(np.int32) if arc
               else None)
    return costs, supply, cap, unsched, arc_cap


@pytest.fixture()
def fused_on(monkeypatch):
    monkeypatch.setenv("POSEIDON_COARSE_FUSED", "1")


def _both(costs, supply, cap, unsched, arc, **kw):
    from poseidon_tpu.ops import transport as J
    from poseidon_tpu.ops.transport_coarse import (
        solve_transport_coarse_fused as j_solve,
    )

    j0, t0 = J.device_call_count(), T.device_call_count()
    js = j_solve(costs, supply, cap, unsched, arc_capacity=arc,
                 max_cost_hint=8000, **kw)
    ts = TC.solve_transport_coarse_fused(costs, supply, cap, unsched,
                                         arc_capacity=arc,
                                         max_cost_hint=8000, device="cpu",
                                         **kw)
    calls = (J.device_call_count() - j0, T.device_call_count() - t0)
    return js, ts, calls


def _assert_same(js, ts):
    for f in ("flows", "unsched", "prices"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), f)
    for f in FIELDS:
        assert getattr(js, f) == getattr(ts, f), f


@pytest.mark.parametrize("E,M,seed,arc", [
    (8, 1000, 0, True), (12, 1200, 3, True), (6, 2048, 5, False),
])
def test_fused_solve_bit_equal(fused_on, E, M, seed, arc):
    js, ts, calls = _both(*_instance(E, M, seed, arc=arc))
    assert js is not None and ts is not None
    _assert_same(js, ts)
    assert ts.gap_bound == 0.0 and ts.telemetry is None
    # One device call in each package for the whole program.
    assert calls == (1, 1)


def test_pinned_scale_bit_equal(fused_on):
    """A pinned scale (the pruned path's full-instance scale) is the one
    both programs run at."""
    inst = _instance(8, 1000, 7)
    derived, _ = T.derive_scale(inst[0], inst[3], 8000,
                                *T.padded_shape(8, 1000))
    js, ts, _ = _both(*inst, scale=derived // 2)
    assert ts is not None
    _assert_same(js, ts)


def test_forced_program_bit_equal(fused_on):
    """``force`` reaches the program past the gates and the greedy
    certificate (an uncontested instance that would decline)."""
    E, M = 8, 1200
    costs = np.full((E, M), 3000, dtype=np.int32)
    for e in range(E):
        costs[e, e * 100:(e + 1) * 100] = 10 + e
    args = (costs, np.full(E, 50, np.int32), np.full(M, 4, np.int32),
            np.full(E, 6000, np.int32), None)
    js, ts, _ = _both(*args)
    assert js is None and ts is None
    js, ts, _ = _both(*args, force=True)
    assert ts is not None
    _assert_same(js, ts)


@pytest.mark.parametrize("case", ["thin", "narrow", "certified",
                                  "coarse_unconverged", "ragged_groups"])
def test_declines_and_groups_identical(fused_on, case, monkeypatch):
    reads = []
    real = TC._host_read
    monkeypatch.setattr(TC, "_host_read",
                        lambda t: reads.append(tuple(t.shape)) or real(t))
    costs, supply, cap, unsched, arc = _instance(8, 1000, 1)
    kw = {}
    if case == "thin":
        supply = np.ones(8, dtype=np.int32)  # below 4 * groups
    elif case == "narrow":  # below COARSE_MIN_MACHINES
        costs, cap, arc = costs[:, :800], cap[:800], arc[:, :800]
    elif case == "certified":  # uncontested: the greedy start certifies
        costs = np.full((8, 1000), 3000, dtype=np.int32)
        for e in range(8):
            costs[e, e * 100:(e + 1) * 100] = 10 + e
        # Past the thin gate (4 * 128 groups), so the greedy start runs.
        supply = np.full(8, 130, dtype=np.int32)
        cap, arc = np.full(1000, 4, dtype=np.int32), None
    elif case == "coarse_unconverged":
        # The first phase's refine fires (it needs 64 iterations of
        # budget left) and the coarse ladder runs out before it
        # converges.
        kw["max_iter_total"] = 70
    else:  # 100 groups: M2 = 100 * 11 > m_pad = 1024, dead columns
        kw["groups"] = 100
    outcomes0 = Counter(T._Telemetry.coarse_outcomes)
    js, ts, calls = _both(costs, supply, cap, unsched, arc, **kw)
    if case == "ragged_groups":
        assert ts is not None
        _assert_same(js, ts)
    else:
        assert js is None and ts is None
    assert calls[0] == calls[1]
    if case == "coarse_unconverged":
        assert reads == [(4,)]  # declined at the seam, nothing more read
    # The program records what it did.
    outcome = {"thin": TC.DECLINED_SMALL, "narrow": TC.DECLINED_SMALL,
               "certified": TC.DECLINED_GREEDY,
               "coarse_unconverged": TC.DECLINED_UNCONVERGED,
               "ragged_groups": TC.RAN}[case]
    assert T._Telemetry.coarse_outcomes - outcomes0 == Counter({outcome: 1})


def test_uncertified_result_declines_and_is_recorded(fused_on, monkeypatch):
    """A full ladder whose result does not certify (``gap_bound``
    infinite) declines after the flow read, and says so."""
    real = TC._host_finalize

    def uncertified(*a, **k):
        sol = real(*a, **k)
        sol.gap_bound = float("inf")
        return sol

    monkeypatch.setattr(TC, "_host_finalize", uncertified)
    outcomes0 = Counter(T._Telemetry.coarse_outcomes)
    costs, supply, cap, unsched, arc = _instance(8, 1000, 0)
    assert TC.solve_transport_coarse_fused(
        costs, supply, cap, unsched, arc_capacity=arc, max_cost_hint=8000,
        device="cpu") is None
    assert T._Telemetry.coarse_outcomes - outcomes0 == Counter(
        {TC.DECLINED_UNCERTIFIED: 1})


def test_host_reads_of_the_program(fused_on, monkeypatch):
    """Outside the ladders' own status reads the program reads three
    times: the seam's 4 ints between the two ladders, the small result
    and the flows; both inner shapes are counted as routes."""
    reads = []
    real = TC._host_read
    monkeypatch.setattr(TC, "_host_read",
                        lambda t: reads.append(tuple(t.shape)) or real(t))
    routes0 = dict(T._Telemetry.routes)
    costs, supply, cap, unsched, arc = _instance(8, 1000, 0)
    sol = TC.solve_transport_coarse_fused(costs, supply, cap, unsched,
                                          arc_capacity=arc,
                                          max_cost_hint=8000, device="cpu")
    assert sol is not None
    assert reads == [(4,), (8 + 8 + 1024 + 1 + 3 + T.NUM_PHASES,),
                     (8, 1024)]
    new = {k for k, n in T._Telemetry.routes.items()
           if n > routes0.get(k, 0)}
    assert new == {("lax", 8, 128), ("lax", 8, 1024)}


def test_fused_rejects_flow_mass_overflow(fused_on):
    """The full instance is validated: int32 flow-mass overflow raises in
    both packages, as in solve_transport."""
    costs, supply, _cap, unsched, arc = _instance(8, 1000, 3)
    huge = np.full(1000, 1 << 30, dtype=np.int32)
    from poseidon_tpu.ops.transport_coarse import (
        solve_transport_coarse_fused as j_solve,
    )

    with pytest.raises(ValueError):
        j_solve(costs, supply, huge, unsched, arc_capacity=arc)
    with pytest.raises(ValueError):
        TC.solve_transport_coarse_fused(costs, supply, huge, unsched,
                                        arc_capacity=arc, device="cpu")


# ------------------------------------------------- the middle of the band

def _crafted(case, seed=0, *, K=None, B=None):
    """Operands of one band's middle: a padded [E, M2] plane, its column
    sort, and a crafted coarse result (flows, prices).  By default 128
    groups over m_pad = 1024 (100 for ``ragged``) and 1000 live columns;
    with ``K`` and ``B`` given, M2 = K * B with its last 1/40 dead."""
    rng = np.random.default_rng(seed)
    E = 8
    if K is None:
        m_pad, K = 1024, 100 if case == "ragged" else 128
        B = -(-m_pad // K)
        M = 1000
    else:
        M = K * B - K * B // 40
    M2 = K * B
    costs = np.full((E, M2), T.INF_COST, dtype=np.int32)
    if case == "ties":
        costs[:, :M] = rng.integers(0, 4, size=(E, M))  # many equal costs
    else:
        costs[:, :M] = rng.integers(0, 900, size=(E, M))
    inadm = 0.3 if case == "inadmissible" else 0.05
    live = costs[:, :M]
    live[rng.random((E, M)) < inadm] = T.INF_COST
    arc = np.zeros((E, M2), dtype=np.int32)
    arc[:, :M] = rng.integers(1, 5, size=(E, M))
    cap = np.zeros(M2, dtype=np.int32)
    cap[:M] = rng.integers(1, 6, size=M)
    supply = rng.integers(100, 300, size=E).astype(np.int32)
    unsched = np.full(E, 3000, dtype=np.int32)
    perm = T.coarse_sort_order(costs).astype(np.int32)
    inv_perm = np.argsort(perm).astype(np.int32)
    Fc = rng.integers(0, 40, size=(E, K)).astype(np.int32)
    Fc[rng.random((E, K)) < 0.5] = 0
    prices_c = np.concatenate([rng.integers(-9000, 0, size=E + K),
                               [-50]]).astype(np.int32)
    return dict(costs=costs, arc=arc, cap=cap, supply=supply,
                unsched=unsched, perm=perm, inv_perm=inv_perm, Fc=Fc,
                prices_c=prices_c, K=K, B=B)


def _reference_middle(d, scale):
    """What the reference's band hands its full ladder (lifted prices,
    F0, fb0, the epsilon schedule) for the crafted coarse result."""
    import jax.numpy as jnp
    from poseidon_tpu.ops import transport_coarse as JC

    E = d["costs"].shape[0]
    seen = []

    def fake(*args, **kw):
        if not seen:  # the coarse ladder: the crafted result
            seen.append(None)
            return (jnp.asarray(d["Fc"]), jnp.zeros(E, jnp.int32),
                    jnp.asarray(d["prices_c"]), jnp.int32(5),
                    jnp.int32(2), jnp.bool_(True),
                    jnp.zeros(4, jnp.int32))
        seen.append([np.asarray(a) for a in args[5:9]])
        F0 = args[6]
        return (F0, args[7], args[5], jnp.int32(0), jnp.int32(0),
                jnp.bool_(True), jnp.zeros(4, jnp.int32))

    real = JC._solve_device
    JC._solve_device = fake
    try:
        z = jnp.zeros((E, d["K"]), jnp.int32)
        JC.coarse_to_fine_band(
            jnp.asarray(d["costs"]), jnp.asarray(d["arc"]),
            jnp.asarray(d["cap"]), jnp.asarray(d["supply"]),
            jnp.asarray(d["unsched"]), jnp.asarray(d["perm"]),
            jnp.asarray(d["inv_perm"]), z, z[0], z, z,
            jnp.zeros(E + d["K"] + 1, jnp.int32), z[:, 0],
            jnp.ones(4, jnp.int32), jnp.int32(1 << 20), jnp.int32(4096),
            jnp.int32(4), jnp.int32(64), groups=d["K"], block=d["B"],
            max_iter=64, scale=scale,
        )
    finally:
        JC._solve_device = real
    return seen[1]


def _port_middle(d, scale, monkeypatch):
    E = d["costs"].shape[0]
    seen = []

    def fake(impl, *args, **kw):
        if not seen:
            seen.append(None)
            stats = torch.tensor([5, 2, 1, 0, 0, 0, 0], dtype=torch.int32)
            return (torch.from_numpy(d["Fc"]), torch.zeros(E, dtype=torch.int32),
                    torch.from_numpy(d["prices_c"]), stats)
        seen.append([args[5].numpy(), args[6].numpy(), args[7].numpy(),
                     np.asarray(args[8])])
        return args[6], args[7], args[5], torch.zeros(7, dtype=torch.int32)

    monkeypatch.setattr(TC, "solve_route", fake)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
         for k in ("costs", "arc", "cap", "supply", "unsched", "perm",
                   "inv_perm")}
    z = torch.zeros((E, d["K"]), dtype=torch.int32)
    TC.coarse_to_fine_band(
        t["costs"], t["arc"], t["cap"], t["supply"], t["unsched"], t["perm"],
        t["inv_perm"], z, z[0], z, z,
        torch.zeros(E + d["K"] + 1, dtype=torch.int32), z[:, 0], [1] * 4,
        1 << 20, 4096, 4, 64, groups=d["K"], block=d["B"], max_iter=64,
        scale=scale, total=int(d["supply"].sum()),
    )
    return seen[1]


@pytest.mark.parametrize("case", ["ties", "inadmissible", "ragged"])
def test_band_middle_matches_reference(case, monkeypatch):
    """Lift, disaggregation, certificate and the full ladder's schedule,
    from the same coarse result, equal the reference's; the plain scan
    alone equals the one inside the band."""
    d = _crafted(case)
    if case == "ragged":
        assert d["K"] * d["B"] > 1024  # dead columns past m_pad
    ref = _reference_middle(d, scale=16)
    got = _port_middle(d, 16, monkeypatch)
    for name, a, b in zip(("lifted", "F0", "fb0", "eps_sched"), ref, got):
        np.testing.assert_array_equal(a, b, name)
    assert ref[1].any()  # the crafted flows were handed out
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
         for k in ("costs", "arc", "cap", "Fc", "perm", "inv_perm",
                   "supply")}
    F0, fb0 = TC.disaggregate_plain(
        t["costs"], t["arc"], t["cap"], t["Fc"], t["perm"], t["inv_perm"],
        t["supply"], groups=d["K"], block=d["B"])
    np.testing.assert_array_equal(F0.numpy(), ref[1])
    np.testing.assert_array_equal(fb0.numpy(), ref[2])


@pytest.mark.parametrize("case,K,B", [("ties", 128, 1),
                                      ("inadmissible", 32, 32),
                                      ("ties", 31, 33),
                                      ("inadmissible", 4, 256)])
def test_plain_scan_matches_reference_at_kernel_edges(case, K, B):
    """The yardstick of the disaggregation kernel, the plain scan, equals
    the reference's scan inside its band at the edges of the kernel's
    layout: one member per group, a full warp of members, one past it,
    and eight per lane."""
    d = _crafted(case, seed=B, K=K, B=B)
    ref = _reference_middle(d, scale=16)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
         for k in ("costs", "arc", "cap", "Fc", "perm", "inv_perm",
                   "supply")}
    F0, fb0 = TC.disaggregate_plain(
        t["costs"], t["arc"], t["cap"], t["Fc"], t["perm"], t["inv_perm"],
        t["supply"], groups=K, block=B)
    np.testing.assert_array_equal(F0.numpy(), ref[1])
    np.testing.assert_array_equal(fb0.numpy(), ref[2])
    assert ref[1].any()


@pytest.mark.parametrize("seed", range(3))
def test_device_certificate_matches_host(seed):
    """``_certified_eps_device`` equals the host ``_certified_eps`` (the
    port's and the reference's) and the reference's device certificate
    on arbitrary feasible states."""
    import jax.numpy as jnp
    from poseidon_tpu.ops import transport as J
    from poseidon_tpu.ops.transport_coarse import (
        _certified_eps_device as j_cert,
    )

    rng = np.random.default_rng(seed)
    E, M = 16, 96
    costs = rng.integers(0, 3000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = T.INF_COST
    supply = rng.integers(1, 30, size=E).astype(np.int32)
    cap = rng.integers(1, 6, size=M).astype(np.int32)
    unsched = rng.integers(3000, 6000, size=E).astype(np.int32)
    arc = rng.integers(1, 5, size=(E, M)).astype(np.int32)
    scale = 128
    flows = T.greedy_flows(costs, supply, cap, arc)
    left = (supply.astype(np.int64) - flows.sum(axis=1)).astype(np.int32)
    prices = np.concatenate([rng.integers(-5000, 0, size=E),
                             rng.integers(-5000, 0, size=M),
                             [-100]]).astype(np.int32)
    kw = dict(costs=costs, supply=supply, capacity=cap, unsched_cost=unsched,
              scale=scale, arc_capacity=arc)
    want = T._certified_eps(flows, left, prices, **kw)
    assert J._certified_eps(flows, left, prices, **kw) == want
    Cs = np.where(costs >= T.INF_COST, T.INF_COST,
                  costs * scale).astype(np.int32)
    Uem = np.minimum(np.minimum(supply[:, None], cap[None, :]), arc)
    got = TC._certified_eps_device(
        torch.from_numpy(flows), torch.from_numpy(left),
        torch.from_numpy(prices), C=torch.from_numpy(Cs),
        U=torch.from_numpy(unsched * scale), Uem=torch.from_numpy(Uem),
        capacity=torch.from_numpy(cap), supply=torch.from_numpy(supply),
        E=E, M=M)
    ref = int(j_cert(jnp.asarray(flows), jnp.asarray(left),
                     jnp.asarray(prices), C=jnp.asarray(Cs),
                     U=jnp.asarray(unsched * scale), Uem=jnp.asarray(Uem),
                     capacity=jnp.asarray(cap), supply=jnp.asarray(supply),
                     E=E, M=M))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,)
    assert int(got[0]) == want == ref


def test_host_aggregate_matches_reference():
    from poseidon_tpu.ops.transport_coarse import host_aggregate as j_agg

    d = _crafted("ragged", seed=4)
    a = TC.host_aggregate(d["costs"], d["cap"], d["arc"], d["perm"], d["K"],
                          d["B"])
    b = j_agg(d["costs"], d["cap"], d["arc"], d["perm"], d["K"], d["B"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_wrapper_runs_the_plain_scan_on_cpu_tensors():
    """On CPU tensors the kernel's wrapper is the plain scan, and no
    launch is counted."""
    d = _crafted("ties", seed=2)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
         for k in ("costs", "arc", "cap", "Fc", "perm", "inv_perm",
                   "supply")}
    before = dict(_kernels.LAUNCHES)
    args = (t["costs"], t["arc"], t["cap"], t["Fc"], t["perm"], t["inv_perm"],
            t["supply"])
    a = TC.coarse_disaggregate(*args, groups=d["K"], block=d["B"])
    b = TC.disaggregate_plain(*args, groups=d["K"], block=d["B"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert _kernels.LAUNCHES == before


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    """The program's entry point runs on CUDA unless asked for the CPU:
    without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    costs, supply, cap, unsched, arc = _instance(8, 1000, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.solve_transport_coarse_fused(costs, supply, cap, unsched,
                                        arc_capacity=arc)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "block"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """On a tensor that is not on the CPU the wrapper takes its kernel
    path, whose operand checks reject what the kernel does not take
    before anything is built or launched: a wrong Fc, or a group larger
    than the kernel's shared memory holds."""
    E, K, B = 4, 8, 2
    if bad == "block":
        K, B = 1, TC.MAX_BLOCK + 1

    def z(*shape, dtype=torch.int32, device="meta"):
        return torch.zeros(shape, dtype=dtype, device=device)

    args = [z(E, K * B), z(E, K * B), z(K * B), z(E, K), z(K * B),
            z(K * B), z(E)]
    args[3] = {"dtype": z(E, K, dtype=torch.int64),
               "shape": z(E, K + 1),
               "device": z(E, K, device="cpu"),
               "block": z(E, K)}[bad]
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(TypeError if bad == "dtype" else ValueError,
                       match="block" if bad == "block" else "Fc"):
        TC.coarse_disaggregate(*args, groups=K, block=B)
    assert _kernels.LAUNCHES == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _edge_case(B, seed, cost_hi=200):
    """A [16, 24 x B] plane at the edges of the kernel's layout: row 0's
    members all tie, row 1 wants more than every member's caps, group 0
    has no admissible member, and the rest is random with 20%
    inadmissible members and costs below ``cost_hi``."""
    rng = np.random.default_rng(seed)
    E, K = 16, 24
    M2 = K * B
    costs = rng.integers(0, cost_hi, size=(E, M2)).astype(np.int32)
    costs[rng.random((E, M2)) < 0.2] = T.INF_COST
    costs[0] = 7
    d = dict(arc=rng.integers(1, 5, size=(E, M2)).astype(np.int32),
             cap=rng.integers(0, 6, size=M2).astype(np.int32),
             Fc=rng.integers(0, 3 * B, size=(E, K)).astype(np.int32),
             K=K, B=B)
    d["Fc"][rng.random((E, K)) < 0.3] = 0
    d["Fc"][:2] = [[2 * B], [1 << 20]]
    d["perm"] = T.coarse_sort_order(costs).astype(np.int32)
    d["inv_perm"] = np.argsort(d["perm"]).astype(np.int32)
    costs[:, d["perm"][:B]] = T.INF_COST
    d["costs"] = costs
    d["supply"] = (d["Fc"].astype(np.int64).sum(1) + 5).astype(np.int32)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "inadmissible", "ragged", "wide",
                                  "B=1", "B=31", "B=32", "B=33", "B=64",
                                  "B=255", "B=256", "B=257", "B=1000",
                                  "B=MAX_BLOCK", "costs past 2^23"])
def test_disaggregate_kernel_on_card(cuda_device, case):
    """The kernel against the plain scan on the card, bit-equal, with one
    launch counted: B from 8 to 256 (the wide case: [64, 65536] in 256
    groups), and at the edges of the layout (one member a group, one
    warp of members and one past it, eight a lane, past the sort in
    registers, the wrapper's largest group) with an all-ties row, a row
    wanting more than its caps and a group with no admissible member; and
    costs too wide for the 32-bit sort key."""
    if case == "B=MAX_BLOCK":
        d = _edge_case(TC.MAX_BLOCK, seed=12)
    elif case.startswith("B="):
        d = _edge_case(int(case[2:]), seed=int(case[2:]))
    elif case == "costs past 2^23":
        d = _edge_case(40, seed=23, cost_hi=T.INF_COST)
    elif case == "wide":
        rng = np.random.default_rng(9)
        E, K, B = 64, 256, 256
        M2 = K * B
        costs = rng.integers(0, 50, size=(E, M2)).astype(np.int32)
        costs[rng.random((E, M2)) < 0.1] = T.INF_COST
        d = dict(costs=costs,
                 arc=rng.integers(1, 5, size=(E, M2)).astype(np.int32),
                 cap=rng.integers(1, 6, size=M2).astype(np.int32),
                 supply=rng.integers(100, 3000, size=E).astype(np.int32),
                 Fc=rng.integers(0, 300, size=(E, K)).astype(np.int32),
                 K=K, B=B)
        d["perm"] = T.coarse_sort_order(costs).astype(np.int32)
        d["inv_perm"] = np.argsort(d["perm"]).astype(np.int32)
    else:
        d = _crafted(case, seed=6)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(cuda_device)
         for k in ("costs", "arc", "cap", "Fc", "perm", "inv_perm",
                   "supply")}
    args = (t["costs"], t["arc"], t["cap"], t["Fc"], t["perm"], t["inv_perm"],
            t["supply"])
    n0 = _kernels.LAUNCHES["coarse_disaggregate"]
    a = TC.coarse_disaggregate(*args, groups=d["K"], block=d["B"])
    b = TC.disaggregate_plain(*args, groups=d["K"], block=d["B"])
    assert _kernels.LAUNCHES["coarse_disaggregate"] == n0 + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a[0].any())

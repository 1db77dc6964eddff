"""The port's kernel wrappers: their contract on the CPU, and each CUDA
kernel against its plain version on the card.

This file imports neither JAX nor the JAX package, so on the card it runs
without the repository's conftest (which imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The ``cuda`` tests decide in a fixture whether a card is present and skip
where there is none.
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops import transport as T


def _packed(E, M, seed):
    """Packed operands of a contended cold solve, as solve_transport
    would dispatch them."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = T.INF_COST
    supply = rng.integers(20, 60, size=E).astype(np.int32)
    cap = rng.integers(1, 4, size=M).astype(np.int32)
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    big = np.stack([costs, arc, np.zeros_like(costs)])
    scale, eps_sched, _ = T._host_validate(costs, supply, cap, unsched,
                                           None, None, 8000)
    vec = np.concatenate([
        supply, cap, unsched, np.zeros(E + M + 1, np.int32),
        np.zeros(E, np.int32), eps_sched,
        np.asarray([8192, 4, 64, 1], np.int32),
    ]).astype(np.int32)
    return big, vec, int(scale)


def _mid_solve(E, M, seed, device, *, phase=1, iters=8):
    """Operands and a state of the plain ladder inside epsilon phase
    ``phase`` (after its refine and ``iters`` iterations), with the
    phase's epsilon and its excesses."""
    big, vec, scale = _packed(E, M, seed)
    bd = torch.from_numpy(big).to(device)
    vd = torch.from_numpy(vec).to(device)
    ops, state = T._prepare_operands(
        bd[0], vd[:E], vd[E:E + M], vd[E + M:2 * E + M], bd[1],
        vd[2 * E + M:3 * E + 2 * M + 1], bd[2],
        vd[3 * E + 2 * M + 1:4 * E + 2 * M + 1], scale=scale)
    ops["total"] = int(vec[:E].astype(np.int64).sum())
    eps_sched = [int(x) for x in vec[4 * E + 2 * M + 1:][:T.NUM_PHASES]]
    kw = dict(ops=ops, iterate=T._pr_iteration,
              global_update=T._global_update,
              sweeps=torch.zeros(1, dtype=torch.int32, device=device),
              total_iters=0, max_iter_total=8192, global_every=4,
              bf_max=64, adaptive=1, unroll=4, stage="test")
    for p in range(phase):
        state, _ = T._pr_phase(state, eps_sched[p], max_iter=8192, **kw)
    state, _ = T._pr_phase(state, eps_sched[phase], max_iter=iters, **kw)
    exc = T._excesses(*state[:3], supply=ops["supply"], total=ops["total"])
    return ops, state, exc, eps_sched[phase]


def _global_updates(update, ops, state, exc, eps, bf_max):
    """(pe, pm, pt, sweeps) of one global update through ``update``."""
    acc = torch.zeros(1, dtype=torch.int32, device=state[0].device)
    gu_ops = {k: ops[k] for k in ("C", "U", "Uem", "supply", "cap", "adm")}
    out = update(*state, *exc, acc, eps=eps, bf_max=bf_max, **gu_ops)
    return [t.cpu().numpy() for t in (*out, acc)]


@pytest.mark.parametrize("impl", ["fused", "tiled", "global_update"])
def test_wrappers_run_plain_versions_on_cpu_tensors(impl):
    """On CPU tensors a route's wrapper is its plain version: same bits
    as the plain ladder (the global update's wrapper: the same prices and
    sweeps as ``_global_update``), and no kernel launch counted."""
    from poseidon_tpu_torch.ops import transport_tiled as TT

    before = dict(_kernels.LAUNCHES)
    if impl == "global_update":
        args = _mid_solve(16, 128, 1, "cpu")
        for bf_max in (64, 0):
            got = _global_updates(TT.GlobalUpdate(), *args, bf_max)
            ref = _global_updates(T._global_update, *args, bf_max)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        assert int(got[3][0]) > 0
    else:
        big, vec, scale = _packed(16, 128, 1)
        F, small = T._solve_device_packed(big, vec, max_iter=8192,
                                          scale=scale, impl=impl,
                                          device="cpu")
        F0, small0 = T._solve_device_packed(big, vec, max_iter=8192,
                                            scale=scale, impl="lax",
                                            device="cpu")
        np.testing.assert_array_equal(F.numpy(), F0.numpy())
        np.testing.assert_array_equal(small, small0)
    assert _kernels.LAUNCHES == before


def _meta_operands(E, M):
    """Operands and a state of the per-iteration route on the ``meta``
    device: not CPU tensors, so the wrappers take their kernel path, and
    no data, so only their checks run."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="meta")

    ops = dict(C=z(E, M), U=z(E), Uem=z(E, M), supply=z(E), cap=z(M),
               adm=z(E, M).bool())
    state = [z(E, M), z(E), z(M), z(E), z(M), z(1), z(E), z(M), z(1)]
    return ops, state


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device"])
@pytest.mark.parametrize("target", ["check", "tiled_iteration",
                                    "global_update"])
def test_operand_check_rejects_what_the_kernels_do_not_take(target, bad):
    """The operand check, and each wrapper of the per-iteration route
    through it, rejects a tensor its kernel does not take before anything
    is built or launched."""
    from poseidon_tpu_torch.ops import transport_tiled as TT

    exc = TypeError if bad == "dtype" else ValueError
    if target == "check":
        t = torch.zeros((4, 8), dtype=torch.int32)
        if bad == "dtype":
            t = t.to(torch.int64)
        elif bad == "shape":
            t = t[:, :4].contiguous()
        elif bad == "layout":
            t = t.t().contiguous().t()
        dev = torch.device("meta") if bad == "device" else t.device
        with pytest.raises(exc):
            _kernels.check(t, "x", (4, 8), dev)
        return
    E, M = 4, 8
    ops, state = _meta_operands(E, M)
    pe = state[3]
    state[3] = {
        "dtype": pe.to(torch.int64),
        "shape": torch.zeros(E + 1, dtype=torch.int32, device="meta"),
        "layout": torch.zeros(2 * E, dtype=torch.int32, device="meta")[::2],
        "device": torch.zeros(E, dtype=torch.int32),
    }[bad]
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(exc, match="pe"):
        if target == "tiled_iteration":
            TT.TiledIteration()(
                *state, torch.zeros(T.STATUS_INTS, dtype=torch.int32,
                                    device="meta"),
                eps=1, do_relabel=True, total=0, **ops)
        else:
            TT.GlobalUpdate()(
                *state, torch.zeros(1, dtype=torch.int32, device="meta"),
                eps=1, bf_max=64, **ops)
    assert _kernels.LAUNCHES == before


def test_tiled_iteration_never_writes_its_inputs(monkeypatch):
    """B2's wrapper writes each iteration into one of two buffer sets
    that it owns, never into a tensor it was given: in the phase loop's
    pattern (outputs fed back; a skipped global update hands back the
    previous iteration's prices, so the inputs span both sets) every
    call's outputs are new objects, and the fixed operands are checked
    once per solve, the state only where the wrapper did not write it."""
    from types import SimpleNamespace

    from poseidon_tpu_torch.ops import transport_tiled as TT

    launches = []
    fake = SimpleNamespace(
        pt_tiled_iteration=lambda *a: launches.append(a) or 0,
        pt_tiled_iteration_ws_ints=lambda E, M: 16,
    )
    monkeypatch.setattr(_kernels, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    checked = []
    real_check = _kernels.check
    monkeypatch.setattr(
        _kernels, "check",
        lambda t, name, *a: checked.append(name) or real_check(t, name, *a))
    E, M = 4, 8
    ops, state = _meta_operands(E, M)
    st = torch.zeros(T.STATUS_INTS, dtype=torch.int32, device="meta")
    step = TT.TiledIteration()
    kw = dict(eps=1, do_relabel=True, total=0, **ops)
    ins = (*state, st)
    seen = []
    for k in range(6):
        outs = step(*ins, **kw)
        assert not {id(t) for t in outs} & {id(t) for t in ins}, k
        seen.append(outs)
        if k == 2:  # a skipped global update: the entering prices stay
            ins = (*outs[:3], *ins[3:6], *outs[6:])
        else:
            ins = outs
    assert len(launches) == 6
    # Two sets, and a third after the skip, whose inputs span both.
    assert len({id(outs[0]) for outs in seen}) == 3
    assert checked.count("C") == 1
    assert checked.count("F") == 1 and checked.count("pe") == 1


def test_failed_launch_raises():
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _kernels.launch_check(2, "fused_ladder")


def test_fused_ladder_shared_memory_covers_the_gate():
    """B1 holds pe and the two Bellman-Ford distance buffers ([E] int32
    each) and its stages' segment partials (four int32 buffers with one
    slot per unit, at most one unit per thread of its 1024-thread block)
    in dynamic shared memory sized from E: at every padded shape the
    route's gate admits, that size covers them and fits one H100 block
    (227 KB).  On the card, chip_smoke.py holds this size to the one the
    kernel computes."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    m_pads = sorted({T.bucket_size(n) for n in range(1, 41_000)})
    e_pads = [8 << k for k in range(10)]
    admitted = [(e, m) for e in e_pads for m in m_pads if TF.fits_vmem(e, m)]
    assert (8, 20480) in admitted and (1024, 128) in admitted
    assert max(e for e, _ in admitted) == 1024
    assert max(m for _, m in admitted) == 20480
    for e, _m in admitted:
        need = 4 * 3 * e + 4 * 4 * 1024
        assert need < TF.ladder_smem_bytes(e) <= 227 * 1024


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl,E,M", [
    ("fused", 64, 1024),
    # B1's row and column segments at their edges: E and M not multiples
    # of 32, the gate's two extremes, and the wave's coarse shape.
    ("fused", 40, 300),
    ("fused", 64, 1000),
    ("fused", 8, 20480),
    ("fused", 1024, 128),
    ("fused", 128, 256),
    ("tiled", 64, 1024),
    # B2's 16 x 256 tiles at their edges (E and M not multiples of
    # them), the wave's padded band and the gate's edge.
    ("tiled", 40, 1000),
    ("tiled", 100, 10000),
    ("tiled", 128, 10240),
    ("tiled", 256, 10240),
])
def test_kernel_matches_plain_on_card(cuda_device, impl, E, M):
    """Each route's whole solve against the plain ladder on the card:
    every output field bit-equal (sweeps included), and the route's
    kernels actually launched: B1, or B2 with its global update."""
    big, vec, scale = _packed(E, M, 3)
    keys = (["fused_ladder"] if impl == "fused"
            else ["tiled_iteration", "global_update"])
    n0 = {k: _kernels.LAUNCHES[k] for k in keys}
    F, small = T._solve_device_packed(big, vec, max_iter=8192, scale=scale,
                                      impl=impl, device=cuda_device)
    F0, small0 = T._solve_device_packed(big, vec, max_iter=8192,
                                        scale=scale, impl="lax",
                                        device=cuda_device)
    np.testing.assert_array_equal(F.cpu().numpy(), F0.cpu().numpy())
    np.testing.assert_array_equal(small, small0)
    for k in keys:
        assert _kernels.LAUNCHES[k] > n0[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("impl,E,M,cap", [
    ("fused", 128, 256, 512),
    ("fused", 64, 1000, 128),
    ("fused", 128, 1280, 512),
    ("tiled", 40, 1000, 128),
    ("tiled", 128, 10240, 512),
    ("tiled", 128, 10240, 128),
])
def test_kernel_ring_matches_plain_on_card(cuda_device, impl, E, M, cap):
    """Each route with the convergence-telemetry ring: its whole small
    result (the ring at the reference's offsets included) bit-equal to
    the plain ladder's with the ring, at the default cap and at 128,
    where longer solves wrap; and its results with the ring equal to its
    results without it, with the same host reads."""
    big, vec, scale = _packed(E, M, 3)
    kw = dict(max_iter=8192, scale=scale, device=cuda_device)
    r0 = T.host_read_count()
    F, small = T._solve_device_packed(big, vec, impl=impl, telem_cap=cap,
                                      **kw)
    reads_on = T.host_read_count() - r0
    F0, small0 = T._solve_device_packed(big, vec, impl="lax",
                                        telem_cap=cap, **kw)
    np.testing.assert_array_equal(F.cpu().numpy(), F0.cpu().numpy())
    np.testing.assert_array_equal(small, small0)
    r0 = T.host_read_count()
    F_off, off = T._solve_device_packed(big, vec, impl=impl, telem_cap=0,
                                        **kw)
    assert T.host_read_count() - r0 == reads_on
    np.testing.assert_array_equal(F_off.cpu().numpy(), F.cpu().numpy())
    np.testing.assert_array_equal(off, small[:off.size])
    o = 2 * E + M + 1
    t = T.decode_telemetry(small[off.size:].reshape(T.TELEM_ROWS, cap),
                           int(small[o]))
    assert t.samples() == min(int(small[o]), cap) > 0
    assert int(t.iters[-1]) == int(small[o]) - 1


@pytest.mark.cuda
def test_global_update_marks_the_ring_on_card(cuda_device):
    """The global-update kernel sets its column's fired bit and sweeps
    as the plain update does, and touches nothing else of the ring."""
    from poseidon_tpu_torch.ops import transport_tiled as TT

    args = _mid_solve(128, 10240, 5, cuda_device, phase=1)
    rings = []
    for update in (TT.GlobalUpdate(), T._global_update):
        ring = torch.full((T.TELEM_ROWS, 128), 7, dtype=torch.int32,
                          device=cuda_device)
        _global_updates(lambda *a, **k: update(*a, ring=ring, ring_slot=77,
                                               **k), *args, 64)
        rings.append(ring.cpu().numpy())
    np.testing.assert_array_equal(rings[0], rings[1])
    assert rings[0][T._TR_GU, 77] == 1 and rings[0][T._TR_BF, 77] > 0


def _pruned_packed(E, M, seed):
    """Packed operands of a pruned-plane solve: the shortlist of a
    slack-rich wave-shaped [E, M] plane (``plan_shortlist`` at the wave
    gate), solved at the full plane's pinned scale, as the planner's
    pruned path dispatches it."""
    from poseidon_tpu_torch.ops import transport_pruned as TP

    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    supply = rng.integers(10, 30, size=E).astype(np.int32)
    cap = rng.integers(1, 4, size=M).astype(np.int32)
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    plan = TP.plan_shortlist(costs, supply, cap, arc)
    assert plan is not None and plan.sel.size <= M // 2
    scale, _ = T.derive_scale(costs, unsched, 8000, *T.padded_shape(E, M))
    sel = plan.sel
    costs_r, cap_r, arc_r = costs[:, sel], cap[sel], arc[:, sel]
    W = sel.size
    scale, eps_sched, _ = T._host_validate(costs_r, supply, cap_r, unsched,
                                           scale, None, 8000)
    # C order, as solve_transport packs it (the column gather is not).
    big = np.ascontiguousarray(
        np.stack([costs_r, arc_r, np.zeros_like(costs_r)]))
    vec = np.concatenate([
        supply, cap_r, unsched, np.zeros(E + W + 1, np.int32),
        np.zeros(E, np.int32), eps_sched,
        np.asarray([8192, 4, 64, 1], np.int32),
    ]).astype(np.int32)
    return big, vec, int(scale)


@pytest.mark.cuda
def test_pruned_plane_solve_matches_plain_on_card(cuda_device):
    """A pruned-plane solve — the shortlist of a [128, 10240] plane — on
    B2's route against the plain ladder: every output bit-equal, and B2
    with its global update launched (the reduced width is past B1's
    gate)."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    big, vec, scale = _pruned_packed(128, 10240, 7)
    assert not TF.fits_vmem(*big.shape[1:])
    n0 = {k: _kernels.LAUNCHES[k]
          for k in ("tiled_iteration", "global_update")}
    F, small = T._solve_device_packed(big, vec, max_iter=8192, scale=scale,
                                      impl="tiled", device=cuda_device)
    F0, small0 = T._solve_device_packed(big, vec, max_iter=8192,
                                        scale=scale, impl="lax",
                                        device=cuda_device)
    np.testing.assert_array_equal(F.cpu().numpy(), F0.cpu().numpy())
    np.testing.assert_array_equal(small, small0)
    for k, n in n0.items():
        assert _kernels.LAUNCHES[k] > n, k


@pytest.mark.cuda
@pytest.mark.parametrize("E,M", [(100, 10000), (128, 10240), (256, 16384),
                                 (256, 65536)])
@pytest.mark.parametrize("phase,bf_max", [(0, 64), (1, 64), (1, 0)])
def test_global_update_matches_plain_on_card(cuda_device, E, M, phase,
                                             bf_max):
    """The global-update kernel against ``_global_update`` on a
    mid-solve state: (pe, pm, pt) and the sweep count bit-equal, with the
    sweeps run to convergence and cut at bf_max = 0; one launch, no host
    read.  Both launch plans: at the wave's widths every tile's block
    holds its length tiles in shared memory; wider, the length planes
    live in the workspace, and at [256, 65536] (2048 tiles, more blocks
    of 256 threads than an H100's 132 SMs can hold) a block walks
    several tiles."""
    from poseidon_tpu_torch.ops import transport_tiled as TT

    blocks, smem_tiles = TT.global_update_plan(E, M)
    tiles = -(-M // 32)
    assert smem_tiles == (M <= 10240)
    assert (blocks < tiles) == (M == 65536), (blocks, tiles)
    args = _mid_solve(E, M, 5, cuda_device, phase=phase)
    n0, r0 = _kernels.LAUNCHES["global_update"], T.host_read_count()
    got = _global_updates(TT.GlobalUpdate(), *args, bf_max)
    assert _kernels.LAUNCHES["global_update"] == n0 + 1
    assert T.host_read_count() == r0
    ref = _global_updates(T._global_update, *args, bf_max)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_tiled_route_split_by_stage(monkeypatch):
    """The per-iteration route's solve is timed and its host reads
    counted by stage (iterate, global update, the rest), and its
    iterations and sweeps are summed by route, agreeing with the
    solution.  On CPU tensors the plain global update reads the host once
    per group of sweeps; the iterations read nothing."""
    from poseidon_tpu_torch.ops import transport_fused as TF
    from poseidon_tpu_torch.utils import stagetimer

    monkeypatch.setenv("POSEIDON_TILED", "1")
    monkeypatch.setenv("POSEIDON_FUSED", "0")
    monkeypatch.setenv("POSEIDON_HOST_CERT", "0")
    # The stage timers are the tracer's aggregate mode, off by default.
    monkeypatch.setenv("POSEIDON_STAGE_TIMERS", "1")
    monkeypatch.setattr(TF, "VMEM_ELEM_BUDGET", 1024)
    big, vec, _ = _packed(16, 1024, 2)
    E, M = 16, 1024
    stagetimer.reset()
    reads0 = dict(T._Telemetry.stage_reads)
    iters0 = T._Telemetry.route_iters["tiled"]
    sweeps0 = T._Telemetry.route_sweeps["tiled"]
    sol = T.solve_transport(big[0], vec[:E], vec[E:E + M],
                            vec[E + M:2 * E + M], arc_capacity=big[1],
                            device="cpu")
    assert T._Telemetry.route_iters["tiled"] - iters0 == sol.iterations > 0
    assert T._Telemetry.route_sweeps["tiled"] - sweeps0 == sol.bf_sweeps > 0
    times = stagetimer.snapshot()
    reads = {k: T._Telemetry.stage_reads[k] - reads0.get(k, 0)
             for k in T._Telemetry.stage_reads}
    for part in ("iterate", "global_update", "other"):
        assert times[f"solve.device.tiled.{part}"][1] > 0, part
    assert reads["solve.device.tiled.iterate"] == 0
    assert reads["solve.device.tiled.global_update"] > 0
    assert reads["solve.device.tiled.other"] > 0

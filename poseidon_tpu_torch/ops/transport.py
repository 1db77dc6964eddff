"""The scheduling round's transportation solve: EC -> machine min-cost
max-flow by cost-scaling push-relabel, with the device ladder in torch
(the PyTorch/CUDA port of ``poseidon_tpu/ops/transport.py``).

Tasks collapse into equivalence classes (ECs) whose members share arc
costs, so the round's min-cost max-flow is a dense transportation problem:
supplies at ECs, capacitated machines, a cost matrix ``C[E, M]`` and a
per-EC unscheduled fallback arc that keeps every instance feasible.  The
solver is Goldberg-Tarjan cost-scaling push-relabel run synchronously:
every node with positive excess acts in parallel each iteration, which is
safe because a push and its counter-push cannot both be admissible while
prices are frozen, and relabels fire only on active nodes with no
admissible arc.

Host side (numpy, copied from the reference line for line): input
validation, scale and epsilon ladder, greedy and coarse warm starts, the
exact reduced-cost certificate (``_host_finalize``), the selective
column-reduced wrapper.  Device side (torch): the plain ladder
(``_solve_device`` = ``_pr_phase`` + ``_pr_iteration`` +
``_global_update``), and the routes to the hand-written CUDA kernels: the
fused whole-ladder kernel (``transport_fused``, shapes inside the fused
gate) and the per-iteration kernel with its global-update kernel
(``transport_tiled``, the wider bands).
Every route is bit-identical to the plain ladder, which is bit-identical
to the reference's lax path.

Exactness: eps-optimality with integer costs scaled by ``SCALE`` and a
final epsilon of 1 implies optimality whenever ``SCALE > n``;
``choose_scale`` picks the largest int32-safe scale and the certificate
reports a gap bound of ``n / SCALE`` raw cost units otherwise.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.utils.hatches import hatch_bool, hatch_int, hatch_raw
from poseidon_tpu_torch.utils.numerics import certify_i32_total
from poseidon_tpu_torch.utils.stagetimer import stage as _stage

# Raw (cost-model) costs must fit in COST_CAP; admissibility masking uses
# INF_COST.  Working costs are raw * SCALE.
COST_CAP = 1 << 14
INF_COST = 1 << 28
_NEG = -(1 << 30)
_POS = 1 << 30
# Public sentinel for "no per-arc bound" in arc_capacity inputs.
UNBOUNDED_ARC_CAP = _POS

# Warm-start price hygiene: potentials only matter up to a uniform shift,
# so returned prices are re-anchored at max=0, and incoming warm prices are
# anchored then floor-clamped to this spread.  Without the clamp, nodes
# that starved in a previous round carry potentials at/below the relabel
# floor (_NEG // 2); such a node can never relabel again (the floor clamp
# raises its candidate back), so it stays active forever and every phase
# burns its full max_iter.  Working costs are bounded by
# 2**27 (choose_scale), so a 2**28 spread keeps all live structure.
PRICE_SPREAD_CAP = 1 << 28


def bucket_size(n: int, lo: int = 32) -> int:
    """Quarter-octave geometric bucket for a padded axis extent.

    The padded shape fixes the cost scale and the kernel route (the
    reference also keys its compiled programs on it), so per-round churn
    in EC/machine counts lands on a small fixed set of padded sizes; the
    port pads identically.  Powers of two up to 256, then
    {1.25, 1.5, 1.75, 2} x 2^k — worst-case 25% padding waste above 256,
    and a count must move a quarter-octave to change shape.
    """
    if n <= lo:
        return lo
    if n <= 256:
        return 1 << (n - 1).bit_length()
    k = (n - 1).bit_length() - 1  # 2^k < n <= 2^(k+1)
    base = 1 << k
    for frac in (1.25, 1.5, 1.75, 2.0):
        b = int(base * frac)
        if n <= b:
            return b
    raise AssertionError("unreachable")


def padded_shape(num_ecs: int, num_machines: int) -> tuple:
    """The (E_pad, M_pad) the solver will actually run at.

    Shared with the planner's incremental-epsilon heuristic, which must
    reproduce the solver's scale derivation exactly.
    """
    e_pad = max(8, 1 << max(num_ecs - 1, 0).bit_length())
    return e_pad, bucket_size(num_machines)


def choose_scale(num_ecs: int, num_machines: int,
                 max_cost: int = COST_CAP) -> int:
    """Largest cost scale that is safe for int32 push-relabel arithmetic.

    Exact optimality needs scale > n (ECs + machines + source/sink).
    Potentials stay within a few multiples of the max *working* cost
    (max_cost * scale), which must clear int32 with generous headroom —
    so the tighter the instance's actual cost range, the larger (more
    exact) the scale can be.
    """
    n = num_ecs + num_machines + 3
    safe = (1 << 29) // (4 * max(int(max_cost), 1))
    return int(min(n + 1, safe))


@dataclass
class TransportSolution:
    flows: np.ndarray       # int32 [E, M] units of EC e placed on machine m
    unsched: np.ndarray     # int32 [E]    units left unscheduled
    prices: np.ndarray      # int32 [E+M+1] final potentials (warm start)
    objective: int          # raw-cost objective (int64 host arithmetic)
    gap_bound: float        # certified optimality gap in raw cost units
    iterations: int         # total push/relabel iterations across phases
    bf_sweeps: int = 0      # Bellman-Ford sweeps inside global updates
    phase_iters: tuple = () # per-epsilon-phase iteration split (diagnostic)
    # Exact certified epsilon of the returned state (_certified_eps in
    # _host_finalize; 0 = not computed, e.g. non-converged states).  The
    # adaptive ladder reads it off rejected host-cert candidates to
    # enter the device ladder at the start's TRUE violation.
    eps_certified: int = 0
    # How many rungs of the cold epsilon ladder the start skipped
    # (0 = full cold ladder, NUM_PHASES = answered with no device
    # ladder at all) — the "ladder entry phase" telemetry series.
    entry_phase: int = 0
    # Per-iteration convergence curve captured on the device
    # (POSEIDON_SOLVE_TELEMETRY; decode_telemetry).  None when the ring
    # is off or the solve was answered without a device ladder.
    telemetry: Optional["SolveTelemetry"] = None


# ------------------------------------------------------ solve telemetry ring
# Row layout of the convergence-telemetry ring, one layout for the plain
# ladder and every kernel route (the reference's, row for row).  The ring
# is an int32 [TELEM_ROWS, cap] buffer; global iteration ``it`` writes
# column ``it % cap``, so a solve shorter than cap keeps its whole curve
# and a longer one its last cap samples.
TELEM_ROWS = 8
_TR_ITER = 0      # global iteration index (across phases)
_TR_EXCESS = 1    # total ACTIVE excess entering the iteration
_TR_ROWS = 2      # EC rows with positive excess
_TR_COLS = 3      # machine columns with positive excess
_TR_EPS = 4       # the phase's epsilon rung
_TR_GU = 5        # 1 when this iteration ran the global update
_TR_BF = 6        # Bellman-Ford sweeps spent this iteration
_TR_SAT = 7       # 1 when the active-excess total saturated (clamped to
#                   INT32_MAX instead of wrapping)


def solve_telemetry_cap() -> int:
    """Ring capacity (samples); 0 = telemetry off, and then no ring is
    threaded through any route.  Rounded up to a multiple of 128, as the
    reference's kernels lay it out."""
    if not hatch_bool("POSEIDON_SOLVE_TELEMETRY"):
        return 0
    cap = hatch_int("POSEIDON_SOLVE_TELEMETRY_CAP", 512)
    if cap <= 0:
        return 0
    return -(-cap // 128) * 128


@dataclass
class SolveTelemetry:
    """Decoded per-iteration convergence curve of one device solve.

    Arrays are aligned sample-wise (oldest first).  ``total_iters`` can
    exceed ``samples()`` when the ring wrapped; the arrays then hold the
    LAST ``cap`` iterations."""

    iters: np.ndarray          # global iteration index per sample
    active_excess: np.ndarray  # total active excess entering the iteration
    active_rows: np.ndarray    # EC rows with positive excess
    active_cols: np.ndarray    # machine columns with positive excess
    eps: np.ndarray            # epsilon rung of the sample's phase
    gu_fired: np.ndarray       # 1 where the global update ran
    bf_sweeps: np.ndarray      # Bellman-Ford sweeps spent that iteration
    # 1 where the active-excess total saturated: those active_excess
    # samples are lower bounds, not exact totals.
    saturated: np.ndarray = None  # type: ignore[assignment]
    total_iters: int = 0
    cap: int = 0

    def samples(self) -> int:
        return int(self.iters.size)

    def gu_firings(self) -> int:
        return int(self.gu_fired.sum())

    def saturated_samples(self) -> int:
        if self.saturated is None:
            return 0
        return int(self.saturated.sum())

    def wrapped(self) -> bool:
        return self.total_iters > self.samples()

    def decay_half_life(self) -> float:
        """Iterations for the active excess to first drop to half its
        initial sample (0.0 when it never did within the window)."""
        return float(self._iters_to_fraction(0.5))

    def iters_to_drain(self, frac: float = 0.9) -> int:
        """Iterations until ``frac`` of the initial active excess had
        drained; ``total_iters`` when the window never crossed it."""
        got = self._iters_to_fraction(1.0 - frac)
        return int(got if got else self.total_iters)

    def _iters_to_fraction(self, keep: float) -> int:
        if self.samples() == 0:
            return 0
        exc0 = int(self.active_excess[0])
        if exc0 <= 0:
            return 0
        below = np.nonzero(self.active_excess <= exc0 * keep)[0]
        if below.size == 0:
            return 0
        return int(self.iters[below[0]] - self.iters[0])

    def digest(self, max_points: int = 64) -> dict:
        """JSON-safe downsampled curve and summary scalars: every
        ``stride``-th sample plus the last one."""
        n = self.samples()
        if n <= max_points:
            idx = np.arange(n)
        else:
            stride = -(-n // max_points)
            idx = np.arange(0, n, stride)
            if idx[-1] != n - 1:
                idx = np.append(idx, n - 1)
        return {
            "samples": n,
            "total_iters": int(self.total_iters),
            "cap": int(self.cap),
            "wrapped": self.wrapped(),
            "gu_firings": self.gu_firings(),
            "saturated_samples": self.saturated_samples(),
            "bf_sweeps": int(self.bf_sweeps.sum()),
            "decay_half_life": self.decay_half_life(),
            "iters_to_90": self.iters_to_drain(0.9),
            "iters": [int(v) for v in self.iters[idx]],
            "active_excess": [int(v) for v in self.active_excess[idx]],
            "active_rows": [int(v) for v in self.active_rows[idx]],
            "active_cols": [int(v) for v in self.active_cols[idx]],
            "eps": [int(v) for v in self.eps[idx]],
        }


def decode_telemetry(ring, total_iters: int) -> Optional[SolveTelemetry]:
    """Host-side decode of a read ring (``None`` when the ring is empty
    or no iteration ran).  With ``total_iters > cap`` the ring wrapped and
    the oldest live sample sits at column ``total_iters % cap``."""
    ring = np.asarray(ring)
    if ring.size == 0 or ring.shape[1] == 0:
        return None
    cap = int(ring.shape[1])
    total_iters = int(total_iters)
    if total_iters <= 0:
        return None
    if total_iters <= cap:
        idx = np.arange(total_iters)
    else:
        idx = (np.arange(cap) + total_iters % cap) % cap
    return SolveTelemetry(
        iters=ring[_TR_ITER, idx],
        active_excess=ring[_TR_EXCESS, idx],
        active_rows=ring[_TR_ROWS, idx],
        active_cols=ring[_TR_COLS, idx],
        eps=ring[_TR_EPS, idx],
        gu_fired=ring[_TR_GU, idx],
        bf_sweeps=ring[_TR_BF, idx],
        saturated=ring[_TR_SAT, idx],
        total_iters=total_iters,
        cap=cap,
    )


class _Telemetry:
    """Process-wide solve counters.

    ``device_calls`` counts device ladder runs (callers difference it
    around a round), ``host_cert_returns`` the solves answered by the host
    certificate alone, ``host_reads`` every device-to-host read the solve
    path makes (the eager counterpart of the reference's loop-condition
    syncs), and ``routes`` counts device solves by ``(impl, E_pad,
    M_pad)`` so a driver can show which implementation served each shape.
    ``route_iters`` and ``route_sweeps`` sum the iterations and
    Bellman-Ford sweeps of the device solves by ``impl``, and
    ``stage_reads`` counts host reads by phase-loop stage
    (``solve.device.<impl>.iterate``, ``.global_update``, ``.other``).
    ``coarse_outcomes`` counts the one-program coarse start's runs
    (``transport_coarse``) by what each did: ran, or why it declined.
    """

    device_calls = 0
    host_cert_returns = 0
    host_reads = 0
    routes: Counter = Counter()
    route_iters: Counter = Counter()
    route_sweeps: Counter = Counter()
    stage_reads: Counter = Counter()
    coarse_outcomes: Counter = Counter()


def device_call_count() -> int:
    return _Telemetry.device_calls



def host_read_count() -> int:
    return _Telemetry.host_reads


def _host_read(t: torch.Tensor) -> np.ndarray:
    """THE device-to-host boundary of the solve path (counted).

    The sanctioned seam (the reference's ``host_fetch``): ``.cpu()`` is
    no sync the transfer ledger counts, and with numerics validation on
    (``check.ledger.numerics_enabled``) every value read is checked for
    finiteness and int32 headroom."""
    _Telemetry.host_reads += 1
    out = t.cpu().numpy()
    _ledger.maybe_validate_fetched(out, site="host_read")
    return out


# ------------------------------------------------------------ device policy

@contextmanager
def _loop_stage(name: str, device):
    """A phase-loop stage: host (and, when enabled, device) seconds in the
    stage timer, and the host reads it made in ``stage_reads``."""
    r0 = _Telemetry.host_reads
    with _stage(name, device):
        yield
    _Telemetry.stage_reads[name] += _Telemetry.host_reads - r0


def resolve_device(device=None) -> torch.device:
    """The solve's device: CUDA unless the caller asks for the CPU.  No
    card and no explicit CPU request is an error, never a fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU"
        )
    return dev


def accel_policy(env_var: str, device) -> bool:
    """Three-state gate shared by the kernel routes, the adaptive cadence
    and band merging: the env var forces on ("1") or off ("0"); unset
    means "the solve's device is CUDA"."""
    env = hatch_raw(env_var) or ""
    if env == "0":
        return False
    if env == "1":
        return True
    return torch.device(device).type == "cuda"


def adaptive_bf_flag(device) -> int:
    """The adaptive global-update cadence flag the ladders consume (one
    derivation for every route, so kernel and plain runs stay bit-equal)."""
    return 1 if accel_policy("POSEIDON_ADAPTIVE_BF", device) else 0


def iter_unroll(device) -> int:
    """Push/relabel iterations per host read of the phase status.  The
    ``active`` gate makes iterations past convergence exact no-ops, so the
    value changes only how often the host syncs, never a result."""
    default = 4 if torch.device(device).type == "cuda" else 1
    return max(1, hatch_int("POSEIDON_ITER_UNROLL", default))


def _use_fused(e_pad: int, m_pad: int, device) -> bool:
    """Route this solve through the fused ladder kernel (B1)?  The gate is
    the reference's accelerator policy, shape for shape."""
    from poseidon_tpu_torch.ops.transport_fused import fits_vmem

    return fits_vmem(e_pad, m_pad) and accel_policy("POSEIDON_FUSED", device)


def _use_tiled(e_pad: int, m_pad: int, device) -> bool:
    """Route this solve through the per-iteration kernel (B2)?  The tier
    above the fused gate: instances past it with few enough EC rows."""
    from poseidon_tpu_torch.ops.transport_fused import fits_vmem
    from poseidon_tpu_torch.ops.transport_tiled import fits_tile

    if fits_vmem(e_pad, m_pad) or not fits_tile(e_pad):
        return False
    return accel_policy("POSEIDON_TILED", device)


# ------------------------------------------------------- device ladder ops
# Plain torch versions of the reference's lax body (``_pr_phase`` and
# ``_global_update``): int32 everywhere the reference is int32, sums with
# an explicit int32 dtype (torch widens integer sums to int64 otherwise),
# floor division for the global update's arc lengths.  Every lax.while_loop
# condition of the reference is a host read here (``_host_read``).

I32 = torch.int32


def _relabel_to(maxcand, has_adm, excess, p, eps):
    """Relabel active nodes with no admissible arc: new potential = max
    candidate - eps, moving only down and never below the floor."""
    new_p = torch.clamp(maxcand - eps, min=_NEG // 2)
    do = (excess > 0) & ~has_adm & (maxcand > _NEG // 2) & (new_p < p)
    return torch.where(do, new_p, p)


_DINF = 1 << 24  # "unreached" marker for global-update distances

# Adaptive global-update cadence: the update gap doubles (up to
# global_every * _ADAPT_GAP_CAP) while the active excess halves between
# updates and snaps back to the base cadence on any stall.
_ADAPT_GAP_CAP = 4

# Saturation rail of the active-excess total (the adaptive cadence's
# progress signal): totals at or above 2^30 clamp to INT32_MAX.  The port
# sums exactly in int64; the reference decides the clamp with a float32
# shadow sum, so the two agree everywhere below 2^30.
_EXCESS_SAT = (1 << 31) - 1
_EXCESS_SAT_THRESH = 1 << 30


def _gu_fire(adaptive: int, it: int, next_gu: int, global_every: int) -> bool:
    """Does iteration ``it`` run the global update?  Fixed cadence unless
    ``adaptive``.  (The fused kernel carries the same rule on device.)"""
    if adaptive > 0:
        return it >= next_gu
    return it % global_every == 0


def _gu_advance(tot_excess: int, it: int, gap: int, last_exc: int,
                global_every: int):
    """Adaptive-schedule state after a fired update: ``(next_gu, gap,
    last_exc)``.  A window that at least halved the active excess earns a
    doubled gap (capped); anything else resets to the base cadence."""
    if tot_excess <= last_exc // 2:
        gap_f = min(gap * 2, global_every * _ADAPT_GAP_CAP)
    else:
        gap_f = global_every
    return it + gap_f, gap_f, tot_excess


def _excesses(F, Ffb, Fmt, *, supply, total: int):
    """Node excesses from the flow state (``exc_t`` as a [1] tensor)."""
    exc_e = supply - F.sum(1, dtype=I32) - Ffb
    exc_m = F.sum(0, dtype=I32) - Fmt
    exc_t = (Fmt.sum(dtype=I32) + Ffb.sum(dtype=I32) - total).reshape(1)
    return exc_e, exc_m, exc_t


def _active_excess(exc_e, exc_m, exc_t):
    """Saturating total ACTIVE (positive) excess as an int32 [1] tensor,
    and its saturation flag as a bool [1] tensor."""
    s = (
        exc_e.clamp(min=0).sum(dtype=torch.int64)
        + exc_m.clamp(min=0).sum(dtype=torch.int64)
        + exc_t.clamp(min=0).sum(dtype=torch.int64)
    ).reshape(1)
    sat = s >= _EXCESS_SAT_THRESH
    return torch.where(sat, _EXCESS_SAT, s).to(I32), sat


# The int32 phase status the loop reads once per unroll group.  Every
# entry describes the state ENTERING the next iteration: whether any node
# has positive excess, the saturating total active excess, the iterations
# counted so far, and, for that iteration's telemetry sample, the EC rows
# and machine columns with positive excess and the saturation flag.
_ST_ACTIVE, _ST_EXCESS, _ST_ITERS, _ST_ROWS, _ST_COLS, _ST_SAT = range(6)
STATUS_INTS = 6


def _phase_status(exc_e, exc_m, exc_t, iters):
    """The status (above) of the state with these excesses; ``iters`` is
    a [1] tensor."""
    rows = (exc_e > 0).sum(dtype=I32).reshape(1)
    cols = (exc_m > 0).sum(dtype=I32).reshape(1)
    act = (rows > 0) | (cols > 0) | (exc_t > 0)
    tot, sat = _active_excess(exc_e, exc_m, exc_t)
    return torch.cat([act.to(I32), tot, iters, rows, cols, sat.to(I32)])


def _telem_write(ring, st, base: int, eps: int) -> None:
    """Write the telemetry sample of the iteration entering with status
    ``st`` into column ``(base + iterations so far) % cap`` of ``ring``,
    in place and with no host read, when ``st`` says it is active: the
    plain version of the kernels' ring write.  The global-update rows are
    written 0; ``_global_update`` sets them when the update runs."""
    it = st[_ST_ITERS:_ST_ITERS + 1] + base
    col = torch.remainder(it, ring.shape[1]).long()
    zero = torch.zeros(1, dtype=I32, device=ring.device)
    vals = torch.cat([
        it, st[_ST_EXCESS:_ST_EXCESS + 1], st[_ST_ROWS:_ST_ROWS + 1],
        st[_ST_COLS:_ST_COLS + 1],
        torch.full((1,), eps, dtype=I32, device=ring.device), zero, zero,
        st[_ST_SAT:_ST_SAT + 1],
    ])
    old = ring.index_select(1, col).reshape(-1)
    active = st[_ST_ACTIVE:_ST_ACTIVE + 1] > 0
    ring.index_copy_(1, col, torch.where(active, vals, old)[:, None])


def _global_update(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, sweeps_acc,
                   *, C, U, Uem, supply, cap, adm, eps: int, bf_max: int,
                   ring=None, ring_slot: int = 0):
    """Goldberg-style global price update (the reference's
    ``_global_update``): Bellman-Ford distances to a deficit node over the
    residual graph under lengths ``floor(rc / eps) + 1``, then potentials
    drop by ``eps * d``.  Jacobi sweeps, four per host read of the
    ``changed`` flag.  Returns ``(pe, pm, pt)`` and adds the sweeps it ran
    to ``sweeps_acc`` (an int32 [1] tensor, the solve's count), as the
    per-iteration route's kernel (``transport_tiled.GlobalUpdate``) does on
    the device.  With a telemetry ``ring`` it marks column ``ring_slot``
    (the firing iteration's) as fired, with its sweeps."""

    def lengths(rc):
        return torch.div(rc, eps, rounding_mode="floor") + 1

    rc_em = torch.where(adm, C + pe[:, None] - pm[None, :], 0)
    l_em = torch.where(adm, lengths(rc_em), _DINF)
    l_me = torch.where(adm, lengths(-rc_em), _DINF)
    l_efb = lengths(U + pe - pt)
    l_tfb = lengths(-(U + pe - pt))
    l_mt = lengths(pm - pt)
    l_tm = lengths(-(pm - pt))

    has_em = (Uem - F) > 0
    has_me = F > 0
    has_efb = (supply - Ffb) > 0
    has_tfb = Ffb > 0
    has_mt = (cap - Fmt) > 0
    has_tm = Fmt > 0

    inf = torch.full_like(exc_e, _DINF)
    d_e = torch.where(exc_e < 0, 0, inf)
    d_m = torch.where(exc_m < 0, 0, torch.full_like(exc_m, _DINF))
    d_t = torch.where(exc_t < 0, 0, torch.full_like(exc_t, _DINF))

    def sweep(d_e, d_m, d_t):
        via_m = torch.where(has_em, l_em + d_m[None, :], _DINF).amin(1)
        via_t = torch.where(has_efb, l_efb + d_t, _DINF)
        d_e_new = torch.minimum(d_e, torch.minimum(via_m, via_t))
        via_e = torch.where(has_me, l_me + d_e[:, None], _DINF).amin(0)
        via_t_m = torch.where(has_mt, l_mt + d_t, _DINF)
        d_m_new = torch.minimum(d_m, torch.minimum(via_e, via_t_m))
        via_m_t = torch.where(has_tm, l_tm + d_m, _DINF).amin()
        via_e_t = torch.where(has_tfb, l_tfb + d_e, _DINF).amin()
        d_t_new = torch.minimum(d_t, torch.minimum(via_m_t, via_e_t))
        return d_e_new, d_m_new, d_t_new

    # Four sweeps per convergence check; extra sweeps after convergence
    # are exact no-ops (relaxation is monotone), and the check admits one
    # group past bf_max exactly like the reference's loop condition.
    BF_UNROLL = 4
    sweeps = 0
    changed = True
    while changed and sweeps <= bf_max:
        d0 = (d_e, d_m, d_t)
        for _ in range(BF_UNROLL):
            d_e, d_m, d_t = sweep(d_e, d_m, d_t)
        flag = (
            (d_e != d0[0]).any() | (d_m != d0[1]).any() | (d_t != d0[2]).any()
        )
        changed = bool(_host_read(flag))
        sweeps += BF_UNROLL

    sweeps_acc += sweeps
    if ring is not None:
        ring[_TR_GU, ring_slot] = 1
        ring[_TR_BF, ring_slot] = sweeps
    if changed:
        # Unconverged: skip the update (it only accelerates; the host
        # certificate re-derives optimality regardless).
        return pe, pm, pt
    finite_max = torch.maximum(
        torch.maximum(
            torch.where(d_e < _DINF, d_e, 0).amax(),
            torch.where(d_m < _DINF, d_m, 0).amax(),
        ),
        torch.where(d_t < _DINF, d_t, 0).amax(),
    )
    dbig = finite_max + 1
    d_e = torch.where(d_e >= _DINF, dbig, d_e)
    d_m = torch.where(d_m >= _DINF, dbig, d_m)
    d_t = torch.where(d_t >= _DINF, dbig, d_t)
    # Apply only when overflow-safe.
    ok = finite_max < (1 << 26) // max(eps, 1)
    pe_new = torch.where(ok, torch.clamp(pe - eps * d_e, min=_NEG // 2), pe)
    pm_new = torch.where(ok, torch.clamp(pm - eps * d_m, min=_NEG // 2), pm)
    pt_new = torch.where(ok, torch.clamp(pt - eps * d_t, min=_NEG // 2), pt)
    return pe_new, pm_new, pt_new


def _pr_iteration(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st, *,
                  eps: int, do_relabel: bool, C, U, Uem, supply, cap, adm,
                  total: int, ring=None, ring_base: int = 0):
    """One synchronous push sweep, the new excesses and (with
    ``do_relabel``) the local relabel: the plain version of the
    per-iteration kernel (B2).  Prices are frozen during the push; pushes
    allocate across admissible arcs in arc order through inclusive
    cumsums.  A state with no positive excess maps to itself exactly (every
    push and relabel is gated on positive excess), which is what lets the
    phase loop run several iterations per host read.  Returns the new
    state plus the advanced phase status ``st``.  With a telemetry
    ``ring`` it first writes this iteration's sample (``_telem_write``,
    ``ring_base`` = the earlier phases' iterations)."""
    if ring is not None:
        _telem_write(ring, st, ring_base, eps)
    rc_em = torch.where(adm, C + pe[:, None] - pm[None, :], _POS)
    rc_fb = U + pe - pt
    rc_mt = pm - pt

    # EC rows: machine arcs in column order, then the fallback arc.
    res_em = torch.where((rc_em < 0) & (exc_e[:, None] > 0), Uem - F, 0)
    before = torch.cumsum(res_em, 1, dtype=I32) - res_em
    ec_push = torch.clamp(torch.minimum(res_em, exc_e[:, None] - before),
                          min=0)
    left_e = exc_e - ec_push.sum(1, dtype=I32)
    fb_push = torch.where((rc_fb < 0) & (left_e > 0),
                          torch.minimum(supply - Ffb, left_e), 0)

    # Machine rows: the sink arc first, then reverse arcs in EC order.
    mt_push = torch.where((rc_mt < 0) & (exc_m > 0),
                          torch.minimum(cap - Fmt, exc_m), 0)
    left_m = exc_m - mt_push
    res_me = torch.where((rc_em > 0) & (left_m[None, :] > 0), F, 0)
    before_me = torch.cumsum(res_me, 0, dtype=I32) - res_me
    me_push = torch.clamp(
        torch.minimum(res_me, left_m[None, :] - before_me), min=0
    )

    # Sink row: reverse arcs to machines, then to EC fallbacks.
    M = Fmt.shape[0]
    res_t = torch.where(torch.cat([-rc_mt, -rc_fb]) < 0,
                        torch.cat([Fmt, Ffb]), 0) * (exc_t > 0)
    before_t = torch.cumsum(res_t, 0, dtype=I32) - res_t
    t_push = torch.clamp(torch.minimum(res_t, exc_t - before_t), min=0)

    F_new = F + ec_push - me_push
    Ffb_new = Ffb + fb_push - t_push[M:]
    Fmt_new = Fmt + mt_push - t_push[:M]
    exc_e, exc_m, exc_t = _excesses(F_new, Ffb_new, Fmt_new, supply=supply,
                                    total=total)

    if do_relabel:
        # Only active nodes with no admissible arc move, strictly down;
        # admissibility from the SAME rc tensors as the push, with the
        # post-push residuals.
        has_em = (Uem - F_new) > 0
        fb_open = supply - Ffb_new > 0
        has_adm_e = ((rc_em < 0) & has_em).any(1) | ((rc_fb < 0) & fb_open)
        maxcand_e = torch.maximum(
            torch.where(has_em & adm, pm[None, :] - C, _NEG).amax(1),
            torch.where(fb_open, pt - U, _NEG),
        )
        pe_new = _relabel_to(maxcand_e, has_adm_e, exc_e, pe, eps)

        mt_open = cap - Fmt_new > 0
        has_adm_m = ((rc_mt < 0) & mt_open) | ((rc_em > 0) & (F_new > 0)).any(0)
        maxcand_m = torch.maximum(
            torch.where(mt_open, pt, _NEG),
            torch.where((F_new > 0) & adm, pe[:, None] + C, _NEG).amax(0),
        )
        pm_new = _relabel_to(maxcand_m, has_adm_m, exc_m, pm, eps)

        res_t2 = torch.cat([Fmt_new, Ffb_new])
        rc_t = torch.cat([-rc_mt, -rc_fb])
        has_adm_t = ((rc_t < 0) & (res_t2 > 0)).any().reshape(1)
        maxcand_t = torch.where(
            res_t2 > 0, torch.cat([pm, pe + U]), _NEG
        ).amax().reshape(1)
        pt_new = _relabel_to(maxcand_t, has_adm_t, exc_t, pt, eps)
        pe, pm, pt = pe_new, pm_new, pt_new

    counted = st[_ST_ITERS:_ST_ITERS + 1] + st[_ST_ACTIVE:_ST_ACTIVE + 1]
    st = _phase_status(exc_e, exc_m, exc_t, counted)
    return F_new, Ffb_new, Fmt_new, pe, pm, pt, exc_e, exc_m, exc_t, st


def _pr_phase(state, eps: int, *, ops: dict, iterate, global_update,
              sweeps, total_iters: int, max_iter: int, max_iter_total: int,
              global_every: int, bf_max: int, adaptive: int, unroll: int,
              stage: str, ring=None):
    """One epsilon phase: refine the carried flows to the new eps, then
    synchronous push/relabel until every excess is zero.

    ``iterate`` is one push/excess/relabel step (``_pr_iteration`` or the
    per-iteration kernel's wrapper) and ``global_update`` the global price
    update (``_global_update`` or its kernel's wrapper), which runs on the
    post-push state exactly where the reference runs it in place of the
    local relabel and adds its Bellman-Ford sweeps to the int32 [1] device
    tensor ``sweeps``; nothing here reads that count.  The host reads the
    phase status once per group of ``unroll`` iterations; iterations past
    convergence are exact no-ops that the device-side iteration count does
    not count, and a global update due mid-group reads the status first,
    so results and counts are those of the reference's loop.  The loop's stages are timed
    as ``<stage>.iterate``, ``.global_update`` and ``.other`` (refine,
    excesses, status reads).  With a telemetry ``ring`` (int32 [TELEM_ROWS,
    cap]) each active iteration's sample is written on the device: the
    entering state's by ``iterate``, and the fired bit and sweeps by
    ``global_update``, whose iteration the host knows exactly, since it
    reads the status before any update.  Returns the new state and the
    phase's iterations.
    """
    F, Ffb, Fmt, pe, pm, pt = state
    dev = F.device
    C, U, Uem, supply, cap, adm, total = (
        ops["C"], ops["U"], ops["Uem"], ops["supply"], ops["cap"],
        ops["adm"], ops["total"],
    )
    # Refinement: restore eps-optimality at the new eps with minimal
    # disturbance to the carried flows.  It must not fire once the
    # cross-phase budget is (nearly) spent: nothing would be left to
    # repair the excesses it creates.
    with _loop_stage(f"{stage}.other", dev):
        if total_iters + 64 < max_iter_total:
            def refine(rc, flow, hi):
                return torch.where(rc < -eps, hi,
                                   torch.where(rc > eps, 0, flow))

            rc_em = torch.where(adm, C + pe[:, None] - pm[None, :], _POS)
            F = refine(rc_em, F, Uem)
            Ffb = refine(U + pe - pt, Ffb, supply)
            Fmt = refine(pm - pt, Fmt, cap)

        exc_e, exc_m, exc_t = _excesses(F, Ffb, Fmt, supply=supply,
                                        total=total)
        st = _phase_status(exc_e, exc_m, exc_t,
                           torch.zeros(1, dtype=I32, device=dev))

    def budget_ok(i):
        return i < max_iter and total_iters + i < max_iter_total

    it = 0
    next_gu, gap, last_exc = 0, global_every, 0
    done = False
    while not done and budget_ok(it):
        with _loop_stage(f"{stage}.other", dev):
            active, tot, it = (int(v) for v in _host_read(st)[:3])
        if not active or not budget_ok(it):
            break
        for k in range(unroll):
            if not budget_ok(it):
                break
            fire = _gu_fire(adaptive, it, next_gu, global_every)
            if fire and k > 0:
                # The update's decision and its cadence state need the
                # entering state's activity and excess total.
                with _loop_stage(f"{stage}.other", dev):
                    active, tot, it = (int(v) for v in _host_read(st)[:3])
                if not active:
                    done = True
                    break
            with _loop_stage(f"{stage}.iterate", dev):
                (F, Ffb, Fmt, pe2, pm2, pt2, exc_e, exc_m, exc_t,
                 st) = iterate(
                    F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, st,
                    eps=eps, do_relabel=not fire, C=C, U=U, Uem=Uem,
                    supply=supply, cap=cap, adm=adm, total=total,
                    ring=ring, ring_base=total_iters,
                )
            if fire:
                slot = (0 if ring is None
                        else (total_iters + it) % ring.shape[1])
                with _loop_stage(f"{stage}.global_update", dev):
                    pe, pm, pt = global_update(
                        F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t,
                        sweeps, C=C, U=U, Uem=Uem, supply=supply, cap=cap,
                        adm=adm, eps=eps, bf_max=bf_max, ring=ring,
                        ring_slot=slot,
                    )
                next_gu, gap, last_exc = _gu_advance(
                    tot, it, gap, last_exc, global_every
                )
            else:
                pe, pm, pt = pe2, pm2, pt2
            it += 1
    with _loop_stage(f"{stage}.other", dev):
        it = int(_host_read(st[_ST_ITERS]))
    return (F, Ffb, Fmt, pe, pm, pt), it


def _prepare_operands(costs, supply, capacity, unsched_cost, arc_cap,
                      init_prices, init_flows, init_fb, *, scale: int):
    """Scaled costs, arc capacities and the clipped warm state (the
    reference's traced preamble, shared by every route)."""
    E, M = costs.shape
    C = torch.where(costs >= INF_COST, INF_COST, costs * scale)
    U = unsched_cost * scale
    Uem = torch.minimum(
        torch.minimum(supply[:, None], capacity[None, :]), arc_cap
    )
    pe = init_prices[:E].clone()
    pm = init_prices[E:E + M].clone()
    pt = init_prices[E + M:E + M + 1].clone()
    # Clip the warm assignment into the current instance: a row whose
    # carried flow exceeds its (possibly shrunken) supply drops wholesale.
    F0 = torch.minimum(torch.clamp(init_flows, min=0), Uem)
    F0 = torch.where(costs < INF_COST, F0, 0)
    F0 = torch.where((F0.sum(1, dtype=I32) <= supply)[:, None], F0, 0)
    Ffb0 = torch.minimum(torch.clamp(init_fb, min=0),
                         supply - F0.sum(1, dtype=I32))
    Fmt0 = torch.minimum(F0.sum(0, dtype=I32), capacity)
    return (
        dict(C=C, U=U, Uem=Uem, supply=supply, cap=capacity,
             adm=costs < INF_COST),
        (F0.contiguous(), Ffb0, Fmt0, pe, pm, pt),
    )


def _solve_device(costs, supply, capacity, unsched_cost, arc_cap,
                  init_prices, init_flows, init_fb, eps_sched,
                  max_iter_total: int, global_every: int, bf_max: int,
                  adaptive_bf: int = 0, *, max_iter: int, scale: int,
                  total: int, iterate=None, global_update=None,
                  stage: str = "solve.device.lax", telem_cap: int = 0):
    """The plain torch ladder (the reference's ``_solve_device``): every
    phase of ``eps_sched`` through ``_pr_phase``.  Tensors are int32 on
    one device; budgets and knobs are host ints; ``total`` is the host's
    certified total supply.  ``iterate`` and ``global_update`` default to
    ``_pr_iteration`` and ``_global_update``.

    Returns ``(F, Ffb, prices, stats)``: ``stats`` is int32
    ``[iters, bf_sweeps, clean, phase_iters..., ring...]`` on the device,
    where ``ring`` is the flattened [TELEM_ROWS, telem_cap] telemetry ring
    (absent when ``telem_cap`` is 0: no ring is threaded then).
    """
    E, M = costs.shape
    ops, state = _prepare_operands(
        costs, supply, capacity, unsched_cost, arc_cap, init_prices,
        init_flows, init_fb, scale=scale,
    )
    ops["total"] = total
    unroll = iter_unroll(costs.device)
    iters = 0
    sweeps = torch.zeros(1, dtype=I32, device=costs.device)
    ring = (torch.zeros((TELEM_ROWS, telem_cap), dtype=I32,
                        device=costs.device) if telem_cap else None)
    phase_iters = []
    for eps in eps_sched:
        state, it = _pr_phase(
            state, int(eps), ops=ops, iterate=iterate or _pr_iteration,
            global_update=global_update or _global_update, sweeps=sweeps,
            total_iters=iters, max_iter=max_iter,
            max_iter_total=max_iter_total, global_every=global_every,
            bf_max=bf_max, adaptive=adaptive_bf, unroll=unroll, stage=stage,
            ring=ring,
        )
        iters += it
        phase_iters.append(it)
    F, Ffb, Fmt, pe, pm, pt = state
    exc_e, exc_m, exc_t = _excesses(F, Ffb, Fmt, supply=supply, total=total)
    clean = ~((exc_e != 0).any() | (exc_m != 0).any() | (exc_t != 0).any())
    stats = torch.cat([
        torch.tensor([iters], dtype=I32, device=F.device), sweeps,
        clean.to(I32).reshape(1),
        torch.tensor(phase_iters, dtype=I32, device=F.device),
    ] + ([] if ring is None else [ring.reshape(-1)]))
    return F, Ffb, torch.cat([pe, pm, pt]), stats


def route_for(e_pad: int, m_pad: int, device) -> str:
    """The ladder route a solve at padded shape ``(e_pad, m_pad)`` takes:
    ``fused`` (B1), ``tiled`` (B2's route) or the plain ``lax`` ladder."""
    if _use_fused(e_pad, m_pad, device):
        return "fused"
    if _use_tiled(e_pad, m_pad, device):
        return "tiled"
    return "lax"


def solve_route(impl: str, *args, **kw):
    """``_solve_device`` through route ``impl`` on device tensors (the
    arguments and result of ``_solve_device``)."""
    if impl == "fused":
        from poseidon_tpu_torch.ops.transport_fused import solve_device_fused

        return solve_device_fused(*args, **kw)
    if impl == "tiled":
        from poseidon_tpu_torch.ops.transport_tiled import solve_device_tiled

        return solve_device_tiled(*args, **kw)
    return _solve_device(*args, **kw)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """THE host-to-device boundary of a solve's operands: a copy of ``a``
    on ``device`` (a copy on the CPU too, so no device tensor ever
    aliases a host buffer the caller keeps mutating)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _solve_device_packed(big, vec: np.ndarray, *, max_iter: int,
                         scale: int, impl: str, device, telem_cap: int = 0):
    """Packed-I/O front of the three routes (``fused``, ``tiled``, plain
    ``lax``).  ``big`` is ``[3, E, M]`` int32 (costs, arc capacity, init
    flows), a host array or an operand already on ``device`` (the
    resident cache's), and ``vec`` the 1-D int32 host vector (supply |
    capacity | unsched cost | prices | fallback | eps schedule |
    max_iter_total, global_every, bf_max, adaptive_bf).  No route writes
    into ``big``'s planes.  Returns the flow
    matrix on the device and ONE host read of the small result vector
    (fallback | prices | iters, bf, clean, unchanged | per-phase
    iterations | the flattened telemetry ring, empty when ``telem_cap`` is
    0), the reference's layout, so the decode ports line for line."""
    _, E, M = big.shape
    o = 0
    cuts = {}
    for name, n in (("supply", E), ("capacity", M), ("unsched", E),
                    ("prices", E + M + 1), ("fb", E),
                    ("eps", NUM_PHASES)):
        cuts[name] = (o, o + n)
        o += n
    max_iter_total, global_every, bf_max, adaptive_bf = (
        int(v) for v in vec[o:o + 4]
    )
    eps_sched = [int(v) for v in vec[slice(*cuts["eps"])]]
    total = int(vec[slice(*cuts["supply"])].astype(np.int64).sum())
    big_d = big if isinstance(big, torch.Tensor) else _upload(big, device)
    vec_d = _upload(vec, device)

    def v(name):
        return vec_d[slice(*cuts[name])]

    F, Ffb, prices, stats = solve_route(
        impl, big_d[0], v("supply"), v("capacity"), v("unsched"), big_d[1],
        v("prices"), big_d[2], v("fb"), eps_sched, max_iter_total,
        global_every, bf_max, adaptive_bf, max_iter=max_iter, scale=scale,
        total=total, telem_cap=telem_cap)
    # A certified warm round often returns the warm start bit-for-bit: the
    # host already owns that matrix, so flag it and skip the [E, M] read.
    unchanged = (F == big_d[2]).all().to(I32).reshape(1)
    small = torch.cat([Ffb, prices, stats[:3], unchanged, stats[3:]])
    return F, _host_read(small)


# ---------------------------------------------------------------- resident
# Device-resident operand cache (the reference's B4): between churn
# rounds only the columns whose machines gained or lost load change, yet
# the [3, E, M] operand is the largest upload of every solve.  The cache
# keeps the last uploaded operand per padded shape (a host copy and the
# device tensor) and uploads only the changed columns, written in place
# on the device; a solve's flow result is folded into the resident
# plane 2 on the device, so a warm re-solve's init flows diff clean.
_RESIDENT: dict = {}
_RESIDENT_MAX_SHAPES = 4
# When more than M_pad // DIVISOR columns changed, a wholesale upload is
# cheaper than the scatter payload and its index bookkeeping.
_RESIDENT_DIFF_DIVISOR = 4


def _resident_scatter_cols(dev_big: torch.Tensor, idx: torch.Tensor,
                           payload: torch.Tensor) -> torch.Tensor:
    """Replace columns ``idx`` of the resident [3, E, M] operand with
    ``payload`` [3, E, k], in place.  ``idx`` may repeat its last entry
    (the bucketed padding); duplicates carry identical column data, so
    the copy is deterministic."""
    return dev_big.index_copy_(2, idx, payload)


def _resident_set_flows(dev_big: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Fold a solve's flow result into resident plane 2, on the device
    (the next warm solve's init flows are already there)."""
    dev_big[2].copy_(F)
    return dev_big


def _resident_swap(big: np.ndarray, device) -> torch.Tensor:
    """The device operand for ``big``, uploading only what changed since
    the last solve at this padded shape.  A full upload on first sight
    of a shape (or of a shape last seen on another device) and on a
    wholesale change."""
    dev = torch.device(device)
    key = big.shape[1:]
    entry = _RESIDENT.pop(key, None)
    # Keyed on the device as the caller names it ("cuda" is not equal to
    # the "cuda:0" a tensor reports).
    if entry is not None and entry["device"] != dev:
        entry = None
    if entry is None:
        while len(_RESIDENT) >= _RESIDENT_MAX_SHAPES:
            _RESIDENT.pop(next(iter(_RESIDENT)))  # LRU: oldest first
        entry = {"host": big.copy(), "dev": _upload(big, dev), "device": dev}
        _RESIDENT[key] = entry
        return entry["dev"]
    _RESIDENT[key] = entry  # re-insert: move-to-end keeps hot shapes
    M_pad = key[1]
    changed = np.nonzero((entry["host"] != big).any(axis=(0, 1)))[0]
    k = len(changed)
    if k == 0:
        return entry["dev"]
    if k > M_pad // _RESIDENT_DIFF_DIVISOR:
        entry["host"] = big.copy()
        entry["dev"] = _upload(big, dev)
        return entry["dev"]
    # The index width is bucketed as the reference buckets it for its
    # compile keys (torch needs no bucketing; keeping it makes the
    # uploaded bytes the reference's), padded by repeating the last
    # changed column, which is idempotent under the copy.
    k_pad = 1 << max(int(k - 1).bit_length(), 5)
    k_pad = min(k_pad, M_pad)
    idx = np.full(k_pad, changed[-1], dtype=np.int32)
    idx[:k] = changed
    payload = np.ascontiguousarray(big[:, :, idx])
    entry["dev"] = _resident_scatter_cols(
        entry["dev"], _upload(idx, dev).long(), _upload(payload, dev)
    )
    entry["host"][:, :, changed] = big[:, :, changed]
    return entry["dev"]


def _resident_fold_result(key, F_dev: torch.Tensor,
                          F_full: np.ndarray) -> None:
    """After a flow-changing solve, keep the resident operand's plane 2
    in step with the result so the NEXT warm solve's init flows diff
    clean."""
    entry = _RESIDENT.get(key)
    if entry is None:
        return
    entry["dev"] = _resident_set_flows(entry["dev"], F_dev)
    entry["host"][2] = F_full


# The epsilon ladder always has this many phases.  Ladder factor 4096:
# eps0 <= max_working_cost/2 <= 2^26 < 4096^3 always reaches 1 within 4
# entries (the 5th covers oversized incremental eps starts); phases
# whose epsilon repeats are near-no-ops (the refine keeps all flows and
# no node is active).  On planner waves at 1k machines the reference
# counted 3323 iterations at 256^k and 2468 at 4096^k, with 16384^k and
# 65536^k regressing: with full-width pushes each phase redistributes in
# ~100-190 iterations, so fewer meaningful phases win until the
# single-phase jump overloads the refine.  4 phases always reach eps=1:
# every ladder start —
# cold eps0 <= 2^26, drift/dual eps <= ~2^29 — is below 4096^3, so the
# k=3 entry is 1 and a 5th phase was a guaranteed no-op still paying
# its refine and scan step.
LADDER_FACTOR = 4096
NUM_PHASES = 4


def eps_schedule(eps0: int) -> np.ndarray:
    """The NUM_PHASES-rung descending epsilon ladder from ``eps0`` —
    the one schedule rule (_host_validate derives through it; the
    adaptive entry re-derives with a tightened eps0)."""
    return np.asarray(
        [max(1, int(eps0) // LADDER_FACTOR**k) for k in range(NUM_PHASES)],
        dtype=np.int32,
    )


def ladder_entry_phase(eps0_cold: int, eps0: int) -> int:
    """How many rungs of the cold ladder a start at ``eps0`` skips
    (0 = full cold ladder; NUM_PHASES - 1 = entered at the exact rung).
    The 'ladder entry phase' series in RoundMetrics / bench artifacts —
    callers report NUM_PHASES for solves answered with no device ladder
    at all (host-certificate returns)."""
    k = 0
    c = max(int(eps0_cold), 1)
    for j in range(1, NUM_PHASES):
        if eps0 <= max(c // LADDER_FACTOR**j, 1):
            k = j
    return k


def derive_scale(costs, unsched_cost, max_cost_hint, num_ecs, num_machines):
    """The cost scale a solve of this instance will run at — the single
    source of truth shared by _host_validate (which applies it) and the
    selective wrapper (whose full-instance certificate must use the
    bit-identical value)."""
    finite = costs[costs < INF_COST]
    max_raw = int(max(finite.max() if finite.size else 0,
                      unsched_cost.max(initial=0),
                      max_cost_hint or 0, 1))
    max_raw_q = 1 << (max_raw - 1).bit_length() if max_raw > 1 else 1
    max_raw_q = min(max_raw_q, COST_CAP)
    return choose_scale(num_ecs, num_machines, max_raw_q), max_raw_q


def _host_validate(costs, supply, capacity, unsched_cost, scale, eps_start,
                   max_cost_hint=None):
    """Input validation + scale/epsilon-schedule derivation (host side).

    Returns
    ``(scale, eps_sched, eps0_cold)`` — ``eps0_cold`` is the epsilon a
    COLD ladder of this instance starts at (``max_c // 2``), the
    reference the adaptive entry-phase telemetry measures skipped rungs
    against.  The scale is derived from the cost bound
    rounded UP to a power of two, so per-round drift in the raw cost
    range does not move it.  ``max_cost_hint`` (the cost model's static
    bound) pins the derivation outright — with it, the scale depends
    only on the padded shape.
    """
    finite = costs[costs < INF_COST]
    if finite.size and finite.max() > COST_CAP:
        raise ValueError(f"raw costs must be <= {COST_CAP}")
    if unsched_cost.max(initial=0) > COST_CAP:
        raise ValueError(f"unscheduled costs must be <= {COST_CAP}")
    if (finite.size and finite.min() < 0) or unsched_cost.min(initial=0) < 0:
        raise ValueError("costs must be non-negative")
    # int32 headroom for the full-width push's per-row cumsum: every
    # residual is bounded by its column capacity (Uem <= cap_m), so the
    # worst row sum is total column capacity plus total supply (the sink
    # row carries both layers).  Column capacities are task slots — a
    # cluster would need ~2 billion slots to trip this.
    flow_mass = (
        int(capacity.astype(np.int64).sum())
        + int(supply.astype(np.int64).sum())
    )
    if flow_mass >= (1 << 31):
        raise ValueError(
            "total slot capacity + supply exceeds int32 flow arithmetic "
            f"range ({flow_mass} >= 2^31); shard the instance or reduce "
            "per-machine task slots"
        )

    E, M = costs.shape
    derived, max_raw_q = derive_scale(costs, unsched_cost, max_cost_hint,
                                      E, M)
    if scale is None:
        scale = derived

    # Epsilon schedule from the (quantized) cost magnitude.  A warm
    # incremental re-solve starts the ladder at eps_start (the scaled
    # magnitude of the cost drift since the last round).
    max_c = max(max_raw_q * scale, 1)
    # Caller eps_start is clamped to the cold start: a larger value is
    # pointless (cold covers it) and arithmetically unsafe (eps scales
    # distances in the global update's int32 price arithmetic).  Any
    # in-range value reaches rung 1 within NUM_PHASES (max_c/2 <= 2^26
    # << 4096^3).  Internal producers (drift / dual gates) stay far
    # below this bound on their own.
    eps0 = (
        max_c // 2 if eps_start is None
        else max(1, min(int(eps_start), max_c // 2))
    )
    return scale, eps_schedule(eps0), max(max_c // 2, 1)


def greedy_flows(costs, supply, capacity, arc_capacity=None) -> np.ndarray:
    """Cheapest-arc-first feasible flow — the cold-start initializer.

    Rows claim capacity along their cheapest admissible columns until
    their supply is met.  The result is feasible (never exceeds column,
    arc, or supply bounds) and lands most units where an optimum would,
    so a cold solve warm-started from it refines instead of routing from
    scratch: measured 811 -> 283 iterations on a contended 100x1000
    wave (identical objective — the solver still proves optimality).
    O(E * (M + k log k)) host numpy with k ~ supply per row; leftovers
    (arc caps, or genuinely exhausted capacity) start as unscheduled
    excess and are re-routed by the solver.
    """
    E, M = costs.shape
    F = np.zeros((E, M), dtype=np.int32)
    cap_left = capacity.astype(np.int64).copy()
    for e in range(E):
        s = int(supply[e])
        if s <= 0:
            continue
        row = costs[e]
        # Cheapest s+64 columns usually suffice; avoids a full M log M
        # sort.  Under TIED costs, though, every row partitions to the
        # SAME shortlist, early rows saturate it, and later rows would
        # starve while the plane still holds plenty of capacity — on a
        # uniform-cost gang band this left ~95% of rows unplaced, an
        # uncertifiable start that cost a real coarse dispatch.  Retry
        # passes re-partition over the still-open columns (saturated
        # ones masked to INF); each pass either places a unit or proves
        # the row done, so the loop is bounded and rows that never
        # starve see the original single pass bit-for-bit.
        k = min(M, s + 64)
        masked = None
        for _retry in range(64):  # cap bounds adversarial arc-cap cases
            src = row if masked is None else masked
            if k < M:
                idx = np.argpartition(src, k - 1)[:k]
                idx = idx[np.argsort(src[idx], kind="stable")]
            else:
                idx = np.argsort(src, kind="stable")
            placed_any = False
            for m in idx:
                if s <= 0:
                    break
                if src[m] >= INF_COST:
                    break  # sorted: everything after is inadmissible too
                take = min(int(cap_left[m]), s)
                if arc_capacity is not None:
                    take = min(take, int(arc_capacity[e, m]) - int(F[e, m]))
                if take > 0:
                    F[e, m] += take
                    cap_left[m] -= take
                    s -= take
                    placed_any = True
            if s <= 0 or k >= M:
                break  # done, or the full sorted scan already saw it all
            if masked is not None and not placed_any:
                break  # a pass over open-only columns stalled: arc-blocked
            open_cols = cap_left > 0
            if not open_cols.any():
                break
            masked = np.where(open_cols, row, INF_COST).astype(row.dtype)
    return F



# Coarse warm start (fresh waves): machines aggregate into this many
# supernodes; 256 is small enough that the coarse solve is cheap and
# inside the fused kernel's gate, large enough that within-group cost
# spread — the
# lift's certified epsilon — stays a small fraction of the cold eps0.
# Mid-size instances (padded machine axis under 2048, i.e. raw M up to
# ~1.79k) use 128 groups instead, keeping the aggregation ratio >= ~7
# members/group (at 1k machines, K=128 cut 588 -> 78 iterations).
COARSE_GROUPS = 256
# Below this machine count the aggregation ratio falls under ~7
# members/group at the 128-group floor and the full solve is already
# cheap.  896 = 7 * 128; the measured 1k-machine win (588 -> 78
# iterations at ratio 7.8) sits just above it.
COARSE_MIN_MACHINES = 896


def coarse_group_count(m_pad: int, groups=None) -> int:
    """Group count for an instance whose PADDED machine axis is
    ``m_pad``: the configured cap, but at least ~7 members per group
    (COARSE_MIN_MACHINES = 7 * 128 is the floor), quantized to 128 or
    256 and keyed on the padded width, as the reference keys it."""
    cap = COARSE_GROUPS if groups is None else groups
    return min(cap, 128 if m_pad < 2048 else 256)


def coarse_sort_order(costs) -> np.ndarray:
    """The coarse grouping key: sort columns by admissible column mean,
    dead columns (no admissible rows) last.

    The cpu_mem cost is ~ per-machine load plus request-shaped terms, so
    the admissible column mean captures the machine axis; chunking the
    sorted order into equal-count groups lands same-load machines
    together.  (Capacity-aware keys measured worse in the reference.)
    """
    adm = costs < INF_COST
    colmean = np.where(adm, costs, 0).sum(axis=0) / np.maximum(
        adm.sum(axis=0), 1
    )
    dead = ~adm.any(axis=0)
    return np.lexsort((colmean, dead))


def coarse_group_columns(costs, groups: int) -> np.ndarray:
    """Group machine columns into supernodes of similar cost columns
    (equal-count chunks of `coarse_sort_order`)."""
    M = costs.shape[1]
    order = coarse_sort_order(costs)
    gid = np.empty(M, dtype=np.int64)
    bounds = np.linspace(0, M, groups + 1).astype(int)
    for g in range(groups):
        gid[order[bounds[g]:bounds[g + 1]]] = g
    return gid


def coarse_precheck(costs, supply, capacity, arc_capacity, unsched_cost,
                    max_cost_hint, groups=None, scale=None):
    """Size gates + greedy certificate for the coarse start.

    Returns ``None`` when the instance is too small/thin for a coarse
    start, else a dict with the group count, padded shape, scale, and
    the greedy+dual start (``certified`` True when that start is
    already near-optimal — the coarse start then declines in favor of
    one plain dispatch seeded with it).

    ``scale`` pins the cost scale (the pruned-plane path solves reduced
    planes at the FULL instance's scale, and every epsilon this precheck
    certifies must be in those units); ``None`` derives it from the
    given plane, as the dense path always has.
    """
    E, M = costs.shape
    if E == 0 or M < COARSE_MIN_MACHINES:
        return None
    e_pad, m_pad = padded_shape(E, M)
    K = coarse_group_count(m_pad, groups)
    if M < 4 * K or int(supply.sum()) < 4 * K:
        return None
    d_scale, max_raw_q = derive_scale(
        costs, unsched_cost, max_cost_hint, e_pad, m_pad
    )
    if scale is None:
        scale = d_scale
    gf, gleft, gprices, geps, certified = greedy_dual_precheck(
        costs, supply, capacity, arc_capacity, unsched_cost,
        max_cost_hint, e_pad, m_pad, scale,
    )
    return {
        "groups": K, "e_pad": e_pad, "m_pad": m_pad,
        "scale": scale, "max_raw_q": max_raw_q,
        "gf": gf, "gleft": gleft, "gprices": gprices, "geps": geps,
        "certified": certified,
    }


def _coarse_aggregate(costs, capacity, arc_capacity, gid, groups):
    """[E, M] -> [E, K]: admissible-mean costs, summed capacities."""
    E, M = costs.shape
    adm = costs < INF_COST
    arc64 = (arc_capacity.astype(np.int64) if arc_capacity is not None
             else np.full((E, M), UNBOUNDED_ARC_CAP, dtype=np.int64))
    arc64 = np.where(adm, arc64, 0)
    # One-hot group membership lets every reduction be a matmul.
    # float64 ON PURPOSE: numpy integer matmul bypasses BLAS; every
    # summand here is <= ~2^36 (group size x max cost / arc cap), far
    # inside f64's 2^53 exact-integer range, so dgemm is exact and fast.
    onehot = np.zeros((M, groups), dtype=np.float64)
    onehot[np.arange(M), gid] = 1.0
    n_adm = adm.astype(np.float64) @ onehot                    # [E, K]
    csum = np.where(adm, costs.astype(np.float64), 0.0) @ onehot
    Cg = np.full((E, groups), INF_COST, dtype=np.int32)
    has = n_adm > 0
    # Bounded: a mean of admissible costs never exceeds the max cost,
    # and every admissible cost is < INF_COST = 2^28 — far inside i32.
    Cg[has] = np.round(csum[has] / n_adm[has]).astype(np.int32)  # posecheck: ignore[numerics]
    capg = capacity.astype(np.float64) @ onehot
    capg = np.minimum(capg, np.iinfo(np.int32).max // 4).astype(np.int32)
    arcg = np.minimum(arc64.astype(np.float64) @ onehot,
                      np.iinfo(np.int32).max // 4)
    return Cg, capg, arcg.astype(np.int32)


def _coarse_disaggregate(flows_g, costs, capacity, arc_capacity, gid,
                         groups):
    """Distribute each (row, supernode) flow onto the group's member
    columns, cheapest member first, respecting column and arc caps.
    Undistributable remainders (arc caps tighter than the aggregate
    suggested) simply stay unscheduled-side; the ladder re-routes them.
    """
    E, M = costs.shape
    adm = costs < INF_COST
    flows = np.zeros((E, M), dtype=np.int32)
    col_left = capacity.astype(np.int64).copy()
    arc64 = (arc_capacity.astype(np.int64) if arc_capacity is not None
             else np.full((E, M), UNBOUNDED_ARC_CAP, dtype=np.int64))
    members = [np.nonzero(gid == g)[0] for g in range(groups)]
    for e, g in zip(*np.nonzero(flows_g > 0)):
        want = int(flows_g[e, g])
        ms = members[g]
        order = ms[np.argsort(costs[e, ms], kind="stable")]
        for mcol in order.tolist():
            if want == 0:
                break
            if not adm[e, mcol]:
                break  # sorted: the rest of the group is INF too
            u = int(min(want, col_left[mcol], arc64[e, mcol]))
            if u > 0:
                flows[e, mcol] += u
                col_left[mcol] -= u
                want -= u
    return flows


def greedy_dual_precheck(costs, supply, capacity, arc_capacity,
                         unsched_cost, max_cost_hint, e_pad, m_pad, scale):
    """Shared cold-start certificate check.

    Returns ``(gf, gleft, gprices, geps, certified)``: the greedy flows
    + auction duals + their exact certified epsilon, and whether that
    start is near-optimal (within 4 scale units — it then confirms in
    ~0 device iterations, so any further start engineering is a pure
    extra cost).  One definition so the coarse warm start and the
    selective wrapper cannot diverge on the gate.
    """
    gf, gleft, gprices, geps = maybe_greedy_start(
        True, None, None, None, None, costs, supply, capacity,
        arc_capacity, unsched_cost, max_cost_hint, e_pad, m_pad,
        scale=scale,
    )
    certified = gprices is not None and geps <= 4 * scale
    return gf, gleft, gprices, geps, certified


def coarse_warm_start(costs, supply, capacity, unsched_cost, arc_capacity,
                      solve, *, max_cost_hint=None, groups=None,
                      pre=None):
    """Fresh-wave warm start from an exactly solved aggregated instance.

    The ~500-iteration fresh-wave solve is dominated by redistribution
    the greedy+alternation cold start cannot price under contention; the
    duals of the EXACT optimum of the machine-aggregated instance carry
    that load-shaped equilibrium structure.  Procedure: group columns
    (coarse_group_columns), solve [E, K] through the caller's dispatch
    (``solve``), lift duals group->members, disaggregate the coarse
    primal cheapest-member-first, and certify the lift's exact epsilon
    with the host certificate.  Measured (CPU): 588 -> 78 iterations at
    1k/10k, 604 -> 75 at 4k/40k, identical objectives, certified
    optimal.

    Returns ``(init_prices, init_flows, init_unsched, eps)`` or ``None``
    (instance too small / coarse solve unconverged / certified eps above
    the cold-start gate — callers then run the plain cold ladder).
    """
    E, M = costs.shape
    if pre is None:
        pre = coarse_precheck(
            costs, supply, capacity, arc_capacity, unsched_cost,
            max_cost_hint, groups,
        )
    if pre is None:
        return None
    groups, scale, max_raw_q = pre["groups"], pre["scale"], pre["max_raw_q"]
    gf, gleft, gprices, geps = (
        pre["gf"], pre["gleft"], pre["gprices"], pre["geps"]
    )
    # When the greedy+auction-dual start is already near-optimal
    # (uncontested instance — certifies in ~0 iterations), the coarse
    # solve is a pure extra dispatch.  Reuse that start directly instead
    # (bit-identical to what the cold solve would derive internally).
    if pre["certified"]:
        return gprices, gf, gleft, geps
    gid = coarse_group_columns(costs, groups)
    Cg, capg, arcg = _coarse_aggregate(
        costs, capacity, arc_capacity, gid, groups
    )
    # Decline fallback: the greedy start already computed above (when
    # its own gate passed) — handing it back saves the cold solve from
    # recomputing the identical O(E*M) host work.  geps in (4*scale,
    # gate] converges well inside the caller's warm budget (measured
    # 334-604 iterations at every scale).
    fallback = (
        (gprices, gf, gleft, geps) if gprices is not None else None
    )
    sol_c = solve(
        Cg, supply, capg, unsched_cost, arc_capacity=arcg, scale=scale,
        max_cost_hint=max_cost_hint,
    )
    if sol_c.gap_bound != 0.0:
        return fallback  # an uncertified coarse solve has no usable duals
    pe = sol_c.prices[:E]
    pm = sol_c.prices[E:E + groups][gid]
    pt = sol_c.prices[E + groups]
    lifted = np.concatenate([pe, pm, [pt]]).astype(np.int32)
    flows = _coarse_disaggregate(
        sol_c.flows, costs, capacity, arc_capacity, gid, groups
    )
    left = (supply.astype(np.int64) - flows.sum(axis=1)).astype(np.int32)
    eps = _certified_eps(
        flows, left, lifted, costs=costs, supply=supply,
        capacity=capacity, unsched_cost=unsched_cost, scale=scale,
        arc_capacity=arc_capacity,
    )
    # Same gate as maybe_greedy_start: a start at (or above) half the
    # cold ladder's eps0 is pure noise.
    if eps > max(scale, max_raw_q * scale // 4):
        return fallback
    return lifted, flows, left, eps


def maybe_greedy_start(greedy_init, init_flows, init_prices, init_unsched,
                       eps_start, costs, supply, capacity, arc_capacity,
                       unsched_cost, max_cost_hint, e_pad, m_pad,
                       scale=None):
    """Shared cold-start policy for both solver wrappers.

    One definition on purpose: every wrapper must derive the same
    initial state.  Returns ``(init_flows, init_unsched, init_prices,
    eps_start)`` unchanged unless this is a true cold solve (no warm
    state at all) with greedy_init on.

    A greedy flow alone is useless past the first epsilon phase: with
    zero prices every loaded arc has rc = C*scale > eps, so the next
    refine empties it all.  The fix is the flow's own AUCTION DUALS —
    pe[e] = -scale * (row e's marginal cost: its most expensive greedy
    arc, or its unscheduled cost if greedy left units over), pm = pt = 0
    (machines with spare sink capacity price at the sink's potential) —
    under which every loaded arc has rc <= 0 and survives refines.  The
    ladder then starts at the worst remaining dual violation (cheap
    residual arcs another row contested away, or marginals above the
    fallback): small for sparse rounds, where the solve now starts
    near-done instead of re-deriving prices from scratch.
    """
    if not (
        greedy_init
        and init_flows is None
        and init_prices is None
        and init_unsched is None
        and eps_start is None
    ):
        return init_flows, init_unsched, init_prices, eps_start
    E, M = costs.shape
    init_flows = greedy_flows(costs, supply, capacity, arc_capacity)
    leftover = (
        supply.astype(np.int64) - init_flows.sum(axis=1)
    )
    init_unsched = leftover.astype(np.int32)

    # The scale must be the one the solve will run at — the caller's
    # pinned value when given (the selective wrapper pins the FULL
    # instance's scale onto the reduced solve), else _host_validate's
    # derivation over the padded shape.  Mispriced duals start the
    # ladder far from the true violation.
    d_scale, max_raw_q = derive_scale(costs, unsched_cost, max_cost_hint,
                                      e_pad, m_pad)
    if scale is None:
        scale = d_scale
    init_prices = equilibrium_prices(
        init_flows, leftover, costs=costs, supply=supply,
        capacity=capacity, arc_capacity=arc_capacity,
        unsched_cost=unsched_cost, scale=scale,
    )

    # The exact worst violation of these duals over every arc class —
    # the same certificate the solver's own gap bound uses.
    eps_g = _certified_eps(
        init_flows, init_unsched, init_prices, costs=costs,
        supply=supply, capacity=capacity, unsched_cost=unsched_cost,
        scale=scale, arc_capacity=arc_capacity,
    )
    # Gate: a dual start above half the cold ladder's eps0 would start
    # the ladder at (or above) where cold starts anyway — pure noise.
    # Below that the equilibrium duals measured strictly better or equal
    # at every scale (10k churn -18% iterations, 10k wave1 659 -> 572,
    # 1k cold 378 -> 334; the earlier "cold iterations DOUBLED" was the
    # pre-alternation construction).  The one-scale-unit floor keeps
    # narrow cost ranges (small max_raw_q) from losing near-exact
    # starts to the arithmetic.
    if eps_g > max(scale, max_raw_q * scale // 4):
        return init_flows, init_unsched, None, None
    return init_flows, init_unsched, init_prices, eps_g


def equilibrium_prices(init_flows, leftover, *, costs, supply, capacity,
                       arc_capacity, unsched_cost, scale):
    """Canonical equilibrium duals for a feasible primal state, derived
    from the FLOWS alone (int32 ``[pe, pm, pt]`` price vector).

    The construction is a pure function of the primal: two equally-
    optimal flow states produce the same duals, which makes downstream
    certificate checks robust to WHICH equilibrium a solve landed on
    (the churn zero-dispatch certificate used to re-solve ~960
    iterations when the wave picked the "other" optimal dual surface).
    Shared by the cold greedy start
    (``maybe_greedy_start``) and the warm host-certificate retry.

    Machine potentials: a column whose residual arcs undercut row
    marginals (a machine freed below the fill frontier) prices down by
    that demand, bounded by the slack of its own loaded arcs (a loaded
    arc AT its row's marginal pins the column).  This absorbs the
    column-structured part of the gap — after a churn round the freed
    machines are cheaper than the frontier for EVERY row, which no
    row-potential choice can express.

    A few rounds of alternation toward equilibrium duals.  Per column,
    eps-feasibility is the interval  max_loaded(Cs+pe) <= pm <=
    min_resid(Cs+pe): loaded arcs need rc = Cs+pe-pm <= 0, residual
    arcs rc >= 0.  Per row, utility re-prices against the current
    machine potentials.  Greedy's row-order assignment needs the
    alternation: an early row that hogged a freed machine pins the
    column's interval until the row's own utility is re-priced.
    Conflicting intervals (true contention) keep the loaded bound;
    the residual violation is then exactly what the certificate and
    the epsilon ladder resolve.

    Two evaluation engines, identical arithmetic: gathered per-
    admissible-arc reductions when admissibility is sparse (the
    constrained rounds whose full-width passes used to dominate the
    round), full-matrix numpy otherwise.  Loaded and residual arcs
    are both subsets of the admissible set, so the sparse reductions
    see every cell the dense masks select.
    """
    E, M = costs.shape
    leftover = np.asarray(leftover, dtype=np.int64)
    BIG = np.int64(1) << 60
    sup64 = supply.astype(np.int64)
    cap64 = capacity.astype(np.int64)
    sp = _adm_nonzero(costs)
    if sp is not None:
        r, c = sp
        C64_v = costs[r, c].astype(np.int64)
        fl_v = init_flows[r, c].astype(np.int64)
        used_v = fl_v > 0
        ru, cu = r[used_v], c[used_v]
        marginal = np.full(E, -1, dtype=np.int64)
        np.maximum.at(marginal, ru, C64_v[used_v])
        marginal = np.where(leftover > 0, unsched_cost.astype(np.int64),
                            marginal)
        marginal = np.clip(marginal, 0, None)
        uem_v = np.minimum(sup64[r], cap64[c])
        if arc_capacity is not None:
            uem_v = np.minimum(uem_v, arc_capacity[r, c].astype(np.int64))
        resid_v = uem_v - fl_v > 0
        rr, cr = r[resid_v], c[resid_v]
        Cs_u = C64_v[used_v] * scale
        Cs_r = C64_v[resid_v] * scale
        has_flow = np.zeros(E, dtype=bool)
        has_flow[ru] = True
        pm0 = np.zeros(M, dtype=np.int64)
        pe0 = -scale * marginal
        for _ in range(2):
            lo = np.full(M, -BIG, dtype=np.int64)     # loaded bound
            np.maximum.at(lo, cu, Cs_u + pe0[ru])
            hi = np.full(M, BIG, dtype=np.int64)      # residual bound
            np.minimum.at(hi, cr, Cs_r + pe0[rr])
            # (Dead columns fall out as max(-BIG, min(BIG, 0)) = 0.)
            pm0 = np.maximum(lo, np.minimum(hi, 0))
            net = np.full(E, BIG, dtype=np.int64)
            np.minimum.at(net, ru, Cs_u - pm0[cu])
            pe0 = np.where(has_flow, -net, -scale * marginal)
            # A partially-fed row (leftover > 0) is, at equilibrium,
            # priced by the FALLBACK it actually pays (pe = pt - u*s;
            # marginal is the unscheduled cost for these rows): letting
            # the loaded-arc utility override it leaves the loaded
            # fallback arc with a large positive reduced cost, so a
            # capacity-starved row — the one case where greedy is
            # provably optimal and every admissible arc is saturated —
            # never certified (observed: the oversized-gang band paid a
            # coarse dispatch for a start that was already exact).
            pe0 = np.where(leftover > 0,
                           np.minimum(pe0, -scale * marginal), pe0)
    else:
        C64 = costs.astype(np.int64)
        used = init_flows > 0
        marginal = np.where(used, C64, -1).max(axis=1)      # [E]
        marginal = np.where(leftover > 0, unsched_cost.astype(np.int64),
                            marginal)
        marginal = np.clip(marginal, 0, None)
        adm = costs < INF_COST
        Uem = np.minimum(sup64[:, None], cap64[None, :])
        if arc_capacity is not None:
            Uem = np.minimum(Uem, arc_capacity.astype(np.int64))
        resid = adm & (Uem - init_flows > 0)
        Cs = np.where(adm, C64 * scale, BIG)
        has_flow = used.any(axis=1)
        pm0 = np.zeros(M, dtype=np.int64)
        pe0 = -scale * marginal
        for _ in range(2):
            q = Cs + pe0[:, None]                         # [E, M]
            lo = np.where(used, q, -BIG).max(axis=0)      # loaded bound
            hi = np.where(resid, q, BIG).min(axis=0)      # residual bound
            pm0 = np.maximum(lo, np.minimum(hi, 0))
            # Row utility: best net cost among its loaded arcs (rows
            # without flow keep their greedy/fallback marginal).
            net = np.where(used, Cs - pm0[None, :], BIG).min(axis=1)
            pe0 = np.where(has_flow, -net, -scale * marginal)
            # Partially-fed rows price at the fallback they pay (see the
            # sparse engine above for the full rationale).
            pe0 = np.where(leftover > 0,
                           np.minimum(pe0, -scale * marginal), pe0)
    pm0 = np.clip(pm0, -(PRICE_SPREAD_CAP - 1), PRICE_SPREAD_CAP - 1)
    pe0 = np.clip(pe0, -(PRICE_SPREAD_CAP - 1), PRICE_SPREAD_CAP - 1)
    # Sink potential: machines with spare sink capacity need
    # pm - pt >= -eps, so pt sits at their minimum.
    spare = init_flows.sum(axis=0, dtype=np.int64) < cap64
    pt0 = int(pm0[spare].min(initial=0))
    return np.concatenate([pe0, pm0, np.int64([pt0])]).astype(np.int32)


def exact_equilibrium_prices(init_flows, leftover, *, costs, supply,
                             capacity, arc_capacity, unsched_cost, scale,
                             max_passes=512):
    """Exact canonical duals for an OPTIMAL primal state, or None.

    Where ``equilibrium_prices`` is a fixed two-pass heuristic tuned to
    gate cold greedy starts, this is the full normalization the warm
    host-certificate retry needs: Bellman-Ford shortest-path potentials
    over the residual graph (rows, columns, sink; forward arcs at
    ``Cs``, reverse arcs where flow is loaded at ``-Cs``, fallback and
    sink arcs matching ``_certified_eps``'s conventions exactly).  When
    the flows are optimal the residual graph has no negative cycle, the
    relaxation reaches a fixpoint, and the resulting potentials make
    every residual reduced cost non-negative — an exact certificate by
    construction, independent of WHICH equally-optimal dual surface the
    producing solve returned.  A pure, deterministic function of the
    primal: two equally-optimal flow states yield the same potentials.

    Returns None when the relaxation has not stabilised within
    ``max_passes`` (a non-optimal primal, or an adversarially long
    shortest-path tree) — callers keep whatever certificate the shipped
    duals earned.  Each pass is one O(E*M) min-reduction (gathered
    per-admissible-arc on sparse-admissibility rounds); warm steady
    states stabilise in a handful of passes.
    """
    E, M = costs.shape
    leftover = np.asarray(leftover, dtype=np.int64)
    sup64 = supply.astype(np.int64)
    cap64 = capacity.astype(np.int64)
    us_s = unsched_cost.astype(np.int64) * scale
    fb_loaded = leftover > 0
    fb_resid = sup64 - leftover > 0
    d_e = np.zeros(E, dtype=np.int64)
    d_m = np.zeros(M, dtype=np.int64)
    d_t = np.int64(0)
    sp = _adm_nonzero(costs)
    if sp is not None:
        r, c = sp
        Cs_v = costs[r, c].astype(np.int64) * scale
        fl_v = init_flows[r, c].astype(np.int64)
        uem_v = np.minimum(sup64[r], cap64[c])
        if arc_capacity is not None:
            uem_v = np.minimum(uem_v, arc_capacity[r, c].astype(np.int64))
        fwd_v = uem_v - fl_v > 0
        rev_v = fl_v > 0
        rf, cf, Cf = r[fwd_v], c[fwd_v], Cs_v[fwd_v]
        rr, cr, Cr = r[rev_v], c[rev_v], Cs_v[rev_v]
        fmt = init_flows.sum(axis=0, dtype=np.int64)
        mt_resid = cap64 - fmt > 0
        mt_loaded = fmt > 0
        for _ in range(max_passes):
            pe_prev, pm_prev, pt_prev = d_e.copy(), d_m.copy(), d_t
            np.minimum.at(d_m, cf, Cf + d_e[rf])
            np.minimum.at(d_e, rr, d_m[cr] - Cr)
            if fb_resid.any():
                d_t = min(d_t, np.int64((us_s + d_e)[fb_resid].min()))
            d_e = np.where(fb_loaded, np.minimum(d_e, d_t - us_s), d_e)
            if mt_resid.any():
                d_t = min(d_t, np.int64(d_m[mt_resid].min()))
            d_m = np.where(mt_loaded, np.minimum(d_m, d_t), d_m)
            if (d_t == pt_prev and np.array_equal(d_e, pe_prev)
                    and np.array_equal(d_m, pm_prev)):
                break
        else:
            return None
    else:
        C64 = costs.astype(np.int64)
        adm = costs < INF_COST
        Uem = np.minimum(sup64[:, None], cap64[None, :])
        if arc_capacity is not None:
            Uem = np.minimum(Uem, arc_capacity.astype(np.int64))
        fl = init_flows.astype(np.int64)
        BIG = np.int64(1) << 60
        Cs_fwd = np.where(adm & (Uem - fl > 0), C64 * scale, BIG)
        Cs_rev = np.where(adm & (fl > 0), C64 * scale, -BIG)
        fmt = fl.sum(axis=0)
        mt_resid = cap64 - fmt > 0
        mt_loaded = fmt > 0
        for _ in range(max_passes):
            pe_prev, pm_prev, pt_prev = d_e, d_m, d_t
            d_m = np.minimum(d_m, (Cs_fwd + d_e[:, None]).min(axis=0))
            d_e = np.minimum(d_e, (d_m[None, :] - Cs_rev).min(axis=1))
            if fb_resid.any():
                d_t = min(d_t, np.int64((us_s + d_e)[fb_resid].min()))
            d_e = np.where(fb_loaded, np.minimum(d_e, d_t - us_s), d_e)
            if mt_resid.any():
                d_t = min(d_t, np.int64(d_m[mt_resid].min()))
            d_m = np.where(mt_loaded, np.minimum(d_m, d_t), d_m)
            if (d_t == pt_prev and np.array_equal(d_e, pe_prev)
                    and np.array_equal(d_m, pm_prev)):
                break
        else:
            return None
    # Anchor at max=0 (potentials are shift-invariant) so the spread cap
    # clips only genuinely wide surfaces; a clipped surface simply fails
    # the certificate re-check and the caller keeps the original.
    top = np.int64(max(int(d_e.max()), int(d_m.max()), int(d_t)))
    d_e, d_m, d_t = d_e - top, d_m - top, d_t - top
    lo_cap = -(PRICE_SPREAD_CAP - 1)
    d_e = np.clip(d_e, lo_cap, None)
    d_m = np.clip(d_m, lo_cap, None)
    d_t = max(d_t, np.int64(lo_cap))
    return np.concatenate([d_e, d_m, np.int64([d_t])]).astype(np.int32)


def normalize_prices(p: np.ndarray) -> np.ndarray:
    """Anchor potentials at max=0 and floor the spread.

    Potentials only matter up to a uniform shift, so the anchor preserves
    every reduced cost exactly; the floor clamp bounds the spread a warm
    start can inject (see PRICE_SPREAD_CAP).  Applied to every returned
    price vector (so cross-round drift cannot accumulate) and to every
    incoming warm start (so frames produced before this invariant existed
    are still safe).
    """
    p = np.asarray(p, dtype=np.int32)
    if p.size == 0:
        return p
    shifted = p.astype(np.int64) - int(p.max())
    return np.maximum(shifted, -PRICE_SPREAD_CAP).astype(np.int32)


# Sparse-admissibility gate for the host-side O(E*M) helpers: gathered
# (per-admissible-arc) evaluation replaces full-matrix passes only when
# the matrix is large AND admissible arcs are a small minority — heavily
# constrained rounds (pod affinity pinning each EC to a handful of
# machines) at cluster scale.  Dense rounds keep the existing full-width
# code paths untouched.
_SPARSE_MIN_SIZE = 1 << 22
_SPARSE_FACTOR = 16


def sparse_adm_cells(adm: np.ndarray):
    """``(rows, cols)`` of an admissibility mask when sparse (gathered)
    evaluation pays, else None (callers run their dense path).  The one
    definition of the gate — the cost build (costmodel/cpu_mem.py) and
    the planner's column caps (graph/instance.py) share it, so retuning
    the thresholds cannot leave the paths gated differently."""
    if adm.size < _SPARSE_MIN_SIZE:
        return None
    if int(np.count_nonzero(adm)) * _SPARSE_FACTOR >= adm.size:
        return None
    return np.nonzero(adm)


def _adm_nonzero(costs):
    """``sparse_adm_cells`` over a cost matrix's admissible arcs.  One
    bool pass + count — noise next to the full-matrix passes it saves
    when it fires."""
    if costs.size < _SPARSE_MIN_SIZE:
        return None
    return sparse_adm_cells(costs < INF_COST)


def _certified_eps(flows, unsched, prices, *, costs, supply, capacity,
                   unsched_cost, scale, arc_capacity=None):
    """Smallest eps for which the final state is verifiably eps-optimal.

    Recomputed on host from the actual residual reduced costs, so the
    optimality certificate never *assumes* the kernel's invariants held —
    the relabel/global-update floor clamps can locally break
    eps-optimality in pathological states, and this check is what keeps
    gap_bound honest regardless.  O(E*M) numpy (O(admissible arcs) on
    sparse-admissibility rounds — same arithmetic on the same cells),
    trivial next to the solve.
    """
    E, M = costs.shape
    pe = prices[:E].astype(np.int64)
    pm = prices[E:E + M].astype(np.int64)
    pt = int(prices[E + M])
    worst = 0
    sp = _adm_nonzero(costs)
    if sp is not None:
        r, c = sp
        rc_v = costs[r, c].astype(np.int64) * scale + pe[r] - pm[c]
        uem_v = np.minimum(supply.astype(np.int64)[r],
                           capacity.astype(np.int64)[c])
        if arc_capacity is not None:
            uem_v = np.minimum(uem_v, arc_capacity[r, c].astype(np.int64))
        fl_v = flows[r, c].astype(np.int64)
        fwd_v = uem_v - fl_v > 0
        if fwd_v.any():
            worst = max(worst, int(-(rc_v[fwd_v].min(initial=0))))
        rev_v = fl_v > 0
        if rev_v.any():
            worst = max(worst, int(rc_v[rev_v].max(initial=0)))
        fmt = flows.sum(axis=0, dtype=np.int64)
    else:
        C = costs.astype(np.int64) * scale
        adm = costs < INF_COST
        rc = C + pe[:, None] - pm[None, :]
        Uem = np.minimum(supply.astype(np.int64)[:, None],
                         capacity.astype(np.int64)[None, :])
        if arc_capacity is not None:
            Uem = np.minimum(Uem, arc_capacity.astype(np.int64))
        fl = flows.astype(np.int64)
        fwd = adm & (Uem - fl > 0)
        if fwd.any():
            worst = max(worst, int(-(rc[fwd].min(initial=0))))
        rev = adm & (fl > 0)
        if rev.any():
            worst = max(worst, int(rc[rev].max(initial=0)))
        fmt = fl.sum(axis=0)
    rc_fb = unsched_cost.astype(np.int64) * scale + pe - pt
    # Fallback forward residual: supply - Ffb; Ffb == unsched here.
    fb_resid = supply.astype(np.int64) - unsched.astype(np.int64) > 0
    if fb_resid.any():
        worst = max(worst, int(-(rc_fb[fb_resid].min(initial=0))))
    fb_loaded = unsched > 0
    if fb_loaded.any():
        worst = max(worst, int(rc_fb[fb_loaded].max(initial=0)))
    # Machine->sink arcs (cost 0): Fmt == column sum at a clean exit.
    rc_mt = pm - pt
    mt_resid = capacity.astype(np.int64) - fmt > 0
    if mt_resid.any():
        worst = max(worst, int(-(rc_mt[mt_resid].min(initial=0))))
    mt_loaded = fmt > 0
    if mt_loaded.any():
        worst = max(worst, int(rc_mt[mt_loaded].max(initial=0)))
    return max(1, worst)


def _host_finalize(flows, unsched, prices, iters, *,
                   costs, supply, capacity, unsched_cost,
                   scale, clean=True, arc_capacity=None,
                   bf_sweeps=0, phase_iters=()) -> TransportSolution:
    """Device results -> repaired, certified TransportSolution (host side).

    ``clean`` is the device's own convergence certificate (zero excess at
    exit).  The feasibility repairs below are still needed — the returned
    arrays must be safe to commit — but they are NOT the convergence
    signal: an iteration-budget abort can leave a host-feasible state that
    only the device flag exposes.
    """
    E, M = costs.shape
    flows = np.asarray(flows)
    unsched = np.asarray(unsched)

    # Detect max_iter exhaustion: the returned state may then violate
    # conservation or capacity.  Repair to a feasible (suboptimal) solution
    # and report an unbounded gap instead of silently claiming exactness.
    converged = bool(clean)
    over_cap = flows.sum(axis=0) - capacity
    if (over_cap > 0).any():
        converged = False
        flows = flows.copy()  # device arrays surface as read-only views
        for mcol in np.nonzero(over_cap > 0)[0]:
            excess = int(over_cap[mcol])
            for erow in np.nonzero(flows[:, mcol])[0]:
                take = min(excess, int(flows[erow, mcol]))
                flows[erow, mcol] -= take
                excess -= take
                if excess == 0:
                    break
    residual = supply - flows.sum(axis=1) - unsched
    if (residual != 0).any():
        converged = False
        flows = flows.copy()
        unsched = np.clip(unsched + residual, 0, None).astype(np.int32)
        # Rows still over-assigned (negative residual beyond unsched): shed.
        over = flows.sum(axis=1) + unsched - supply
        for erow in np.nonzero(over > 0)[0]:
            excess = int(over[erow])
            for mcol in np.nonzero(flows[erow])[0]:
                take = min(excess, int(flows[erow, mcol]))
                flows[erow, mcol] -= take
                excess -= take
                if excess == 0:
                    break

    fb_cost = int(
        (unsched_cost.astype(np.int64) * unsched.astype(np.int64)).sum()
    )
    if costs.size >= _SPARSE_MIN_SIZE:
        # Loaded arcs are a vanishing fraction of a large matrix: one
        # nonzero scan + gather beats three full int64 passes.
        nzr, nzc = np.nonzero(flows)
        cost_v = costs[nzr, nzc].astype(np.int64)
        cost_v[cost_v >= INF_COST] = 0  # inadmissible never carry flow
        objective = int(
            (cost_v * flows[nzr, nzc].astype(np.int64)).sum()
        ) + fb_cost
    else:
        raw = costs.astype(np.int64)
        raw[costs >= INF_COST] = 0
        objective = int((raw * flows.astype(np.int64)).sum()) + fb_cost
    n = E + M + 3
    eps_actual = 0
    if not converged:
        gap_bound = float("inf")
    else:
        eps_actual = _certified_eps(
            flows, unsched, np.asarray(prices), costs=costs, supply=supply,
            capacity=capacity, unsched_cost=unsched_cost, scale=scale,
            arc_capacity=arc_capacity,
        )
        if eps_actual <= 1:
            gap_bound = 0.0 if scale > n else n / float(scale)
        else:
            # A floor clamp perturbed eps-optimality somewhere: still a
            # certified bound, just looser (cost <= opt + n * eps).
            gap_bound = n * eps_actual / float(scale)
    return TransportSolution(
        flows=flows,
        unsched=unsched,
        prices=normalize_prices(prices),
        objective=objective,
        gap_bound=gap_bound,
        iterations=int(iters),
        bf_sweeps=int(bf_sweeps),
        phase_iters=phase_iters,
        # The exact certified eps of THIS state (pre-normalize prices —
        # normalization is a uniform shift, so reduced costs and the
        # certificate are unchanged).  The adaptive ladder reads it off
        # rejected host-cert candidates.
        eps_certified=int(eps_actual),
    )


def _repair_start_candidate(init_flows, init_unsched, init_prices, *,
                            costs, supply, capacity, unsched_cost, scale,
                            arc_capacity=None):
    """Host-certified answer for warm starts stranded on forbidden arcs.

    The gang-repair re-solve (and selector churn) hands back a warm frame
    whose flow sits on arcs the CURRENT costs forbid (freshly INF'd rows)
    or whose arc bound tightened.  The device would clip that flow at
    solve init and re-route the excess — but dispatching for it costs a
    device solve (and a poisoned warm state can burn the entire warm
    iteration budget before the cold retry answers in zero iterations).
    Mirror the clip on host instead: drop the stranded
    flow, refill the fallback, and re-price only what the clip touched —
    rows that gained fallback load pin to the fallback equilibrium
    (pe <= pt - u*s), columns whose flow vanished re-price by the same
    conservative residual-arc lift the column-reduction path uses.  The
    result is accepted ONLY when the full reduced-cost certificate then
    passes exactly (gap_bound == 0), so any start whose freed capacity
    genuinely attracts other rows still dispatches.  Returns the repaired
    ``TransportSolution`` candidate, or ``None`` when the clipped start
    cannot be made feasible without the solver.
    """
    E, M = costs.shape
    fl = np.where(costs < INF_COST, init_flows, 0).astype(np.int32)
    if arc_capacity is not None:
        fl = np.minimum(fl, arc_capacity).astype(np.int32)
    rowsum = fl.sum(axis=1, dtype=np.int64)
    un64 = supply.astype(np.int64) - rowsum
    if (un64 < 0).any():
        return None  # over-supplied rows: the kernel's clip owns this
    un = un64.astype(np.int32)
    pe = init_prices[:E].astype(np.int64)
    pm = init_prices[E:E + M].astype(np.int64)
    pt = int(init_prices[E + M])
    gained_fb = un64 > np.asarray(init_unsched).astype(np.int64)
    if gained_fb.any():
        pe = np.where(
            gained_fb,
            np.minimum(pe, pt - unsched_cost.astype(np.int64) * scale),
            pe,
        )
    freed = (fl.sum(axis=0) == 0) & (np.asarray(init_flows).sum(axis=0) > 0)
    if freed.any():
        keep = np.nonzero(~freed)[0]
        pm = _lift_excluded_prices(
            pe, pm[keep], pt, keep, costs=costs, capacity=capacity,
            scale=scale,
        )
    prices = np.concatenate([pe, pm, np.int64([pt])])
    prices = np.clip(prices, _NEG // 2, _POS).astype(np.int32)
    return _host_finalize(
        fl, un, prices, 0, costs=costs, supply=supply, capacity=capacity,
        unsched_cost=unsched_cost, scale=scale, clean=True,
        arc_capacity=arc_capacity,
    )



def solve_transport(
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    unsched_cost: np.ndarray,
    init_prices: Optional[np.ndarray] = None,
    *,
    arc_capacity: Optional[np.ndarray] = None,
    init_flows: Optional[np.ndarray] = None,
    init_unsched: Optional[np.ndarray] = None,
    eps_start: Optional[int] = None,
    max_iter_per_phase: int = 8192,
    max_iter_total: Optional[int] = None,
    scale: Optional[int] = None,
    max_cost_hint: Optional[int] = None,
    global_update_every: int = 4,
    bf_max: int = 64,
    greedy_init: bool = True,
    eps_exact: bool = False,
    device=None,
) -> TransportSolution:
    """Solve the EC->machine transportation problem on ``device`` (CUDA
    unless the caller passes ``device="cpu"``).

    ``eps_exact`` declares the caller's ``eps_start`` to be the start
    state's EXACT certified epsilon (coarse lifts compute it with
    ``_certified_eps``) rather than a conservative drift bound: the
    pre-dispatch host certificate would then recompute the same value and
    miss by construction, so the O(E*M) attempt is skipped.

    Every unit of supply ends up either on a machine or on the per-EC
    unscheduled fallback arc, so the instance is always feasible and this
    computes a true min-cost max-flow of the Firmament network.  Cold
    solves start from the host greedy assignment (``greedy_flows``).

    ``max_iter_total`` bounds the iterations summed over all epsilon
    phases; exhaustion returns a repaired-feasible solution with
    ``gap_bound = inf``.
    """
    dev = resolve_device(device)
    if global_update_every < 1:
        # No global updates at all is non-convergent: fail fast.
        raise ValueError(
            f"global_update_every must be >= 1, got {global_update_every}"
        )
    costs = np.asarray(costs, dtype=np.int32)
    supply = np.asarray(supply, dtype=np.int32)
    capacity = np.asarray(capacity, dtype=np.int32)
    unsched_cost = np.asarray(unsched_cost, dtype=np.int32)
    # Device reductions over flows/supplies accumulate in int32; flow
    # conservation bounds every such sum by the total supply, so this one
    # host-boundary certificate covers them all.
    certify_i32_total(supply, site="solve_transport.supply")
    E, M = costs.shape
    if E == 0 or M == 0:
        # Degenerate rounds (idle cluster / no machines yet): everything
        # that exists goes unscheduled, with no device solve.
        return TransportSolution(
            flows=np.zeros((E, M), dtype=np.int32),
            unsched=supply.copy(),
            prices=np.zeros(E + M + 1, dtype=np.int32),
            objective=int(
                (unsched_cost.astype(np.int64) * supply.astype(np.int64)).sum()
            ),
            gap_bound=0.0,
            iterations=0,
        )
    # Pad EC rows to a power of two (min 8) and machine columns to a
    # quarter-octave bucket (bucket_size), exactly as the reference does:
    # the padded shape fixes the scale and the kernel route.  Padded rows
    # have zero supply; padded columns have zero capacity and no
    # admissible arcs — both inert.
    E_pad, M_pad = padded_shape(E, M)
    # The three [E_pad, M_pad] operands are planes of ONE buffer (one
    # upload; see _solve_device_packed); host code works on the views.
    big = np.empty((3, E_pad, M_pad), dtype=np.int32)
    costs_p, arc_p, flows_p = big[0], big[1], big[2]
    costs_p.fill(INF_COST)
    costs_p[:E, :M] = costs
    supply_p = np.zeros(E_pad, dtype=np.int32)
    supply_p[:E] = supply
    unsched_p = np.ones(E_pad, dtype=np.int32)
    unsched_p[:E] = unsched_cost
    capacity_p = np.zeros(M_pad, dtype=np.int32)
    capacity_p[:M] = capacity

    if arc_capacity is not None:
        arc_capacity = np.asarray(arc_capacity, dtype=np.int32)
        if (arc_capacity < 0).any():
            raise ValueError("arc_capacity must be non-negative")
    was_warm = init_flows is not None or init_prices is not None
    with _stage("solve.greedy_start"):
        init_flows, init_unsched, init_prices, eps_start = maybe_greedy_start(
            greedy_init, init_flows, init_prices, init_unsched, eps_start,
            costs, supply, capacity, arc_capacity, unsched_cost,
            max_cost_hint, E_pad, M_pad, scale=scale,
        )
    with _stage("solve.validate"):
        scale, eps_sched, eps0_cold = _host_validate(
            costs_p, supply_p, capacity_p, unsched_p, scale, eps_start,
            max_cost_hint,
        )
    prices_p = np.zeros(E_pad + M_pad + 1, dtype=np.int32)
    if init_prices is not None:
        # Normalized warm prices are <= 0 with max 0, so the zero-filled
        # padded rows/columns sit exactly at the anchor and stay inert.
        init_prices = normalize_prices(init_prices)
        prices_p[:E] = init_prices[:E]
        prices_p[E_pad:E_pad + M] = init_prices[E:E + M]
        prices_p[E_pad + M_pad] = init_prices[E + M]

    if arc_capacity is not None:
        arc_p.fill(0)
        arc_p[:E, :M] = arc_capacity
    else:
        arc_p.fill(0)
        arc_p[:E, :M] = UNBOUNDED_ARC_CAP

    flows_p.fill(0)
    if init_flows is not None:
        flows_p[:E, :M] = init_flows
    fb_p = np.zeros(E_pad, dtype=np.int32)
    if init_unsched is not None:
        fb_p[:E] = init_unsched

    # Host short-circuit: when the start state (remapped warm frame or
    # the greedy cold start) is already feasible AND certifies EXACTLY
    # (eps_actual <= 1 — the same _certified_eps the device path's
    # finalize uses for gap_bound == 0), the device would return it
    # bit-for-bit with iters=0.  At 10k/100k every steady churn and
    # restart round is such a round.  The check is one O(E*M) host pass
    # and _host_finalize already implements it: any
    # repair it performs flips converged False, so gap_bound == 0.0
    # certifies both feasibility and exactness.  Misses cost the pass
    # and proceed to the dispatch unchanged — bit-identical results
    # either way.
    # Cold rounds only attempt it when the greedy start's own exact
    # certificate (eps_start == geps from maybe_greedy_start) already
    # proves it would pass — the fresh-wave common case (contended,
    # geps >> 1) then pays nothing.  Warm frames always attempt: their
    # eps_start is a drift BOUND, not the start's certificate.
    if (
        init_flows is not None
        and init_unsched is not None
        and init_prices is not None
        and (was_warm or (eps_start is not None and eps_start <= 1))
        and not (eps_exact and eps_start is not None and eps_start > 1)
        and hatch_bool("POSEIDON_HOST_CERT")
    ):
        with _stage("solve.host_cert"):
            # Flow stranded on an arc the CURRENT costs forbid (gang
            # repair re-solves with freshly INF'd rows; selector churn
            # can do the same) is invisible to the epsilon certificate
            # (inadmissible arcs are excluded from reduced-cost checks)
            # but the device WOULD push it off — the raw start must not
            # be certified then.  Same blindness applies to a TIGHTENED
            # finite arc bound: the device clamps the start to Uem and
            # re-places the excess; the epsilon certificate's forward
            # mask just skips saturated arcs.  Such starts get the
            # kernel's own clip mirrored on host plus a targeted
            # re-price (_repair_start_candidate) — still accepted only
            # on an exact certificate, so a clip whose freed capacity
            # genuinely attracts other rows dispatches as before.
            on_forbidden = bool(
                init_flows[costs >= INF_COST].any()
            ) or (
                arc_capacity is not None
                and bool((init_flows > arc_capacity).any())
            )
            if on_forbidden:
                cand = _repair_start_candidate(
                    init_flows, init_unsched, init_prices,
                    costs=costs, supply=supply, capacity=capacity,
                    unsched_cost=unsched_cost, scale=scale,
                    arc_capacity=arc_capacity,
                )
            else:
                cand = _host_finalize(
                    init_flows, init_unsched, init_prices, 0,
                    costs=costs, supply=supply, capacity=capacity,
                    unsched_cost=unsched_cost, scale=scale, clean=True,
                    arc_capacity=arc_capacity,
                )
            if (
                cand is not None
                and not on_forbidden
                and 0.0 < cand.gap_bound < float("inf")
            ):
                # Equilibrium-robust retry: equally-optimal solves agree
                # on the FLOWS but not on which dual surface they return,
                # and the certificate above checks the shipped duals —
                # so a wave that landed on the "other" equilibrium made
                # the next churn round's exact-cert miss and re-solve
                # ~960 iterations for an unchanged optimum (one churn
                # round in five).  Re-deriving
                # CANONICAL duals from the primal alone and certifying
                # those makes the outcome a function of the flows only.
                # The flows are untouched, so an accept changes neither
                # placements nor objective; a miss keeps the ORIGINAL
                # candidate (its eps_certified describes the prices the
                # solve will actually start from — the adaptive ladder
                # entry below needs exactly that).
                canonical = exact_equilibrium_prices(
                    init_flows, init_unsched, costs=costs, supply=supply,
                    capacity=capacity, arc_capacity=arc_capacity,
                    unsched_cost=unsched_cost, scale=scale,
                )
                if canonical is not None:
                    cand2 = _host_finalize(
                        init_flows, init_unsched, canonical, 0,
                        costs=costs, supply=supply, capacity=capacity,
                        unsched_cost=unsched_cost, scale=scale,
                        clean=True, arc_capacity=arc_capacity,
                    )
                    if cand2 is not None and cand2.gap_bound == 0.0:
                        cand = cand2
        if cand is not None and cand.gap_bound == 0.0:
            _Telemetry.host_cert_returns += 1
            # Callers own their return value; without a repair the
            # finalize hands back the warm frame's own arrays (the
            # packed path's unchanged-case copies for the same reason).
            return TransportSolution(
                flows=cand.flows.copy(), unsched=cand.unsched.copy(),
                prices=cand.prices, objective=cand.objective,
                gap_bound=0.0, iterations=0,
                eps_certified=cand.eps_certified,
                entry_phase=NUM_PHASES,
            )
        if (
            cand is not None
            and not on_forbidden
            and cand.gap_bound != float("inf")
            and 1 < cand.eps_certified
            and hatch_bool("POSEIDON_ADAPTIVE_LADDER")
        ):
            # Adaptive ladder entry: the rejected certificate candidate
            # already priced the start EXACTLY (its eps_certified is the
            # worst reduced-cost violation over every arc class — the
            # precise eps at which the shipped start satisfies
            # eps-complementary-slackness), while the caller's eps_start
            # is only a drift BOUND (|cost drift| * scale + 1) that can
            # sit orders of magnitude above it.  Entering the ladder at
            # the certified eps is sound by definition of eps-optimality
            # and skips the rungs the bound would burn re-proving what
            # the host just measured.  Repaired candidates are excluded:
            # their certificate describes the repaired state, not the
            # shipped one.  POSEIDON_ADAPTIVE_LADDER=0 restores the
            # drift-bound entry bit-exactly.
            if eps_start is None or cand.eps_certified < eps_start:
                eps_start = int(min(cand.eps_certified, eps0_cold))
                eps_sched = eps_schedule(max(eps_start, 1))

    if max_iter_total is None:
        max_iter_total = NUM_PHASES * max_iter_per_phase
    _Telemetry.device_calls += 1
    vec = np.concatenate([
        supply_p, capacity_p, unsched_p, prices_p, fb_p,
        np.asarray(eps_sched, dtype=np.int32),
        np.asarray(
            [max_iter_total, global_update_every, bf_max,
             adaptive_bf_flag(dev)],
            dtype=np.int32,
        ),
    ])
    impl = route_for(E_pad, M_pad, dev)
    _Telemetry.routes[(impl, E_pad, M_pad)] += 1
    _ledger.note_solve_key((impl, E_pad, M_pad, int(scale)))
    telem_cap = solve_telemetry_cap()
    # Device-resident operand cache (CUDA default): upload only the
    # columns that changed since the last solve at this padded shape.
    use_resident = accel_policy("POSEIDON_RESIDENT", dev)
    with _stage("solve.upload", dev):
        if use_resident:
            big_op = _resident_swap(big, dev)
        else:
            big_op = _upload(big, dev)
    with _stage("solve.device"), _stage(f"solve.device.{impl}", dev):
        F_dev, small = _solve_device_packed(
            big_op, vec, max_iter=max_iter_per_phase, scale=int(scale),
            impl=impl, device=dev, telem_cap=telem_cap,
        )
    o = E_pad
    unsched = small[:E]
    prices_full = small[o:o + E_pad + M_pad + 1]
    o += E_pad + M_pad + 1
    iters, bf, clean, unchanged = (int(small[o]), int(small[o + 1]),
                                   bool(small[o + 2]), bool(small[o + 3]))
    _Telemetry.route_iters[impl] += iters
    _Telemetry.route_sweeps[impl] += bf
    phase_iters = small[o + 4:o + 4 + NUM_PHASES]
    telemetry = None
    if telem_cap:
        ring_flat = small[o + 4 + NUM_PHASES:
                          o + 4 + NUM_PHASES + TELEM_ROWS * telem_cap]
        telemetry = decode_telemetry(
            ring_flat.reshape(TELEM_ROWS, telem_cap), iters)
    if unchanged:
        # The solve returned the warm start bit-for-bit; reuse the host's
        # own copy instead of reading [E_pad, M_pad] back.  Copy: callers
        # own their return value, while flows_p views the operand buffer.
        flows = flows_p[:E, :M].copy()
    else:
        # The full padded matrix: the resident fold needs all of it.
        with _stage("solve.fetch_flows"):
            F_full = _host_read(F_dev)
        flows = F_full[:E, :M]
        if use_resident:
            # Fold the result into resident plane 2 so the next warm
            # solve's init flows diff clean (no re-upload).
            _resident_fold_result((E_pad, M_pad), F_dev, F_full)
    prices_out = np.concatenate([
        prices_full[:E], prices_full[E_pad:E_pad + M],
        prices_full[E_pad + M_pad:],
    ])
    sol = _host_finalize(
        flows, unsched, prices_out, iters,
        costs=costs, supply=supply, capacity=capacity,
        unsched_cost=unsched_cost, scale=scale, clean=clean,
        arc_capacity=arc_capacity, bf_sweeps=bf,
        phase_iters=tuple(int(x) for x in phase_iters),
    )
    # Telemetry: how many cold-ladder rungs the start skipped (the
    # device ladder actually entered at eps_sched[0]).
    sol.entry_phase = ladder_entry_phase(eps0_cold, int(eps_sched[0]))
    sol.telemetry = telemetry
    return sol


def _lift_excluded_prices(pe, pm_sel, pt, sel, *, costs, capacity, scale,
                          min_e=None):
    """Potentials for columns excluded from a reduced solve.

    An excluded column carries no flow, so its potential only has to keep
    its residual arcs 1-optimal: ``pm <= min_e(C + pe) + 1`` (forward
    EC->machine arcs) and ``pm >= pt - 1`` (machine->sink).  Setting
    ``pm = max(min_e(C + pe), pt - 1)`` satisfies both whenever they are
    jointly satisfiable; when they are not, the column was genuinely
    attractive and the full certificate flags it (-> full-solve
    fallback).  Vectorized over all M columns; the selected entries are
    then overwritten with the solver's own potentials.

    ``min_e`` lets a caller that already computed the per-column
    admissible minimum of ``C * scale + pe`` (the pruned path's
    certificate cache refreshes from the same pass) hand it in instead
    of paying the O(E*M) reduction twice.
    """
    if min_e is None:
        C = costs.astype(np.int64) * scale
        cand = np.where(
            costs < INF_COST, C + pe.astype(np.int64)[:, None],
            np.int64(_POS),
        )
        min_e = cand.min(axis=0)                  # [M]
    pm = np.maximum(min_e, pt - 1)
    pm = np.where(min_e >= _POS, pt, pm)          # no admissible arcs
    pm = np.where(capacity > 0, pm, 0)            # dead columns are inert
    pm[sel] = pm_sel
    return np.clip(pm, _NEG // 2, _POS).astype(np.int64)


def solve_transport_selective(
    costs: np.ndarray,
    supply: np.ndarray,
    capacity: np.ndarray,
    unsched_cost: np.ndarray,
    init_prices: Optional[np.ndarray] = None,
    *,
    arc_capacity: Optional[np.ndarray] = None,
    init_flows: Optional[np.ndarray] = None,
    init_unsched: Optional[np.ndarray] = None,
    slack: int = 64,
    max_cost_hint: Optional[int] = None,
    **kw,
) -> TransportSolution:
    """Column-selected solve for sparse rounds, certified on the full
    instance.

    A steady-state churn round carries a few hundred units of supply
    against thousands of machine columns; any optimal solution only
    touches each row's cheapest feasible columns.  This solves the
    instance restricted to the union of every row's
    ``supply_e + slack`` cheapest admissible columns (plus any
    warm-flow columns), then PROVES the lifted solution optimal for the
    FULL instance with the host reduced-cost certificate
    (_certified_eps) — excluded columns get pricing-argument
    potentials.  If the certificate fails (a contested cheap column
    forced flow outside the union) or the reduction would not shrink
    the instance, it falls back to the full solve.  Exactness is never
    assumed: every returned gap_bound is certificate-backed.
    """
    costs = np.asarray(costs, dtype=np.int32)
    supply = np.asarray(supply, dtype=np.int32)
    capacity = np.asarray(capacity, dtype=np.int32)
    unsched_cost = np.asarray(unsched_cost, dtype=np.int32)
    E, M = costs.shape
    # A caller-pinned scale (the coarse warm start solves its aggregated
    # instance at the FULL instance's scale) must win over the
    # derivation below — and must not reach the inner solve_transport
    # calls twice (once positionally here, once via **kw).  Same for
    # greedy_init (forwarded explicitly below).
    pinned_scale = kw.pop("scale", None)
    greedy = kw.pop("greedy_init", True)
    # The exactness declaration holds for the FULL instance's state
    # only: a column-sliced reduced start can certify BELOW the full
    # state's eps (fewer arcs), so the reduced solve must keep its
    # host-certificate attempt.
    eps_exact = kw.pop("eps_exact", False)
    # Pre-check state: on the gate-fail path the greedy start is handed
    # to the full-width fallback instead of being recomputed there.
    pre_state = None
    scale_full = pinned_scale

    def full():
        if pre_state is not None:
            gf, gleft, gprices, geps = pre_state
            return solve_transport(
                costs, supply, capacity, unsched_cost, gprices,
                arc_capacity=arc_capacity, init_flows=gf,
                init_unsched=gleft, eps_start=geps, scale=scale_full,
                max_cost_hint=max_cost_hint, greedy_init=False, **kw,
            )
        return solve_transport(
            costs, supply, capacity, unsched_cost, init_prices,
            arc_capacity=arc_capacity, init_flows=init_flows,
            init_unsched=init_unsched, max_cost_hint=max_cost_hint,
            scale=pinned_scale, greedy_init=greedy, eps_exact=eps_exact,
            **kw,
        )

    k = int(supply.max(initial=0)) + slack
    if E == 0 or M == 0 or k >= M:
        return full()
    if (greedy and init_prices is None and init_flows is None
            and init_unsched is None and kw.get("eps_start") is None):
        kw.pop("eps_start", None)  # replaced by the certified geps below
        # Cold steady-state pre-check: the column reduction makes the
        # union columns everyone's cheapest, so the REDUCED instance can
        # be cost-contended where the full one is not — at 10k/100k
        # churn, 554 iterations reduced vs zero full-width (identical
        # objective), because
        # the full instance's greedy+auction-dual start is already
        # near-optimal.  When that start certifies within a few scale
        # units, hand it straight to the full-width solve; the reduction
        # only runs when there is real work it could shrink.
        e_pad_f, m_pad_f = padded_shape(E, M)
        if scale_full is None:
            scale_full, _ = derive_scale(
                costs, unsched_cost, max_cost_hint, e_pad_f, m_pad_f
            )
        gf, gleft, gprices, geps, certified = greedy_dual_precheck(
            costs, supply, capacity, arc_capacity, unsched_cost,
            max_cost_hint, e_pad_f, m_pad_f, scale_full,
        )
        pre_state = (gf, gleft, gprices, geps)
        if certified:
            return full()
    # Union of per-row cheapest-k columns (+ warm-flow columns).  Rows
    # share their cheap columns under load-shaped costs, so the union is
    # typically far smaller than E*k.
    part = np.argpartition(costs, k - 1, axis=1)[:, :k]
    mask = np.zeros(M, dtype=bool)
    mask[part.ravel()] = True
    if init_flows is not None:
        # Mirror the kernel's warm clip: rows whose carried flow exceeds
        # the (shrunken) supply are dropped wholesale at solve init, so
        # their columns must not widen the selection — a stale frame
        # from a full-population round would otherwise force the union
        # to (nearly) the full width.
        fl = np.asarray(init_flows)
        fits = fl.sum(axis=1) <= supply
        if fits.any():
            mask |= fl[fits].sum(axis=0) > 0
    # Round the selection itself UP to a power-of-FOUR width (128, 512,
    # 2048, ...) by adding the globally cheapest unselected columns: the
    # union's size varies round to round, and a coarse ladder keeps the
    # steady state on one or two solve shapes (extra columns only enlarge
    # the union, never unsound).

    target = 128
    while target < int(mask.sum()):
        target *= 4
    col_min = np.where(
        (costs < INF_COST).any(axis=0), costs.min(axis=0), INF_COST
    )
    order = np.argsort(col_min, kind="stable")

    def widen_to(t):
        extra = order[~mask[order]][: t - int(mask.sum())]
        mask[extra] = True

    # Contention pre-check: under broad contention (wave rounds — total
    # demand near the union's capacity) flow is forced beyond every
    # row's cheap columns, the certificate fails, and the reduced solve
    # is pure waste (measured ~46% of a wave band's iterations).  The
    # union must hold the supply with comfortable slack; rather than
    # falling straight back to the full width, widen the selection a
    # rung at a time (adding the globally cheapest columns — exactly
    # the ones a capacity-squeezed optimum reaches for next).
    need = 2 * int(supply.astype(np.int64).sum())

    def capacity_of(t):
        if mask.sum() < t:
            widen_to(t)
        return int(capacity.astype(np.int64)[mask].sum())

    while target * 4 < M * 3 and capacity_of(target) < need:
        target *= 4
    if target * 4 >= M * 3:
        return full()
    sel = np.nonzero(mask)[0]

    # The reduced solve runs at the FULL instance's scale so the 1/n
    # optimality bound certifies against the full node count
    # (derive_scale is the shared derivation — the certificate is only
    # sound if both sides use the bit-identical value).  The pre-check
    # above already derived it for cold rounds; warm rounds derive here.
    if scale_full is not None:
        scale = scale_full
    else:
        e_pad, m_pad = padded_shape(E, M)
        scale, _ = derive_scale(costs, unsched_cost, max_cost_hint,
                                e_pad, m_pad)

    prices_r = None
    if init_prices is not None:
        p = np.asarray(init_prices, dtype=np.int32)
        prices_r = np.concatenate([p[:E], p[E:E + M][sel], p[E + M:]])
    sol_r = solve_transport(
        costs[:, sel], supply, capacity[sel], unsched_cost, prices_r,
        arc_capacity=(
            arc_capacity[:, sel] if arc_capacity is not None else None
        ),
        init_flows=(
            np.asarray(init_flows)[:, sel] if init_flows is not None
            else None
        ),
        init_unsched=init_unsched, scale=scale,
        max_cost_hint=max_cost_hint, greedy_init=greedy, **kw,
    )
    if sol_r.gap_bound == float("inf"):
        return full()

    flows = np.zeros((E, M), dtype=np.int32)
    flows[:, sel] = sol_r.flows
    pe = sol_r.prices[:E]
    pt = int(sol_r.prices[E + sel.size])
    pm = _lift_excluded_prices(
        pe, sol_r.prices[E:E + sel.size].astype(np.int64), pt, sel,
        costs=costs, capacity=capacity, scale=scale,
    )
    prices_full = np.concatenate([
        pe.astype(np.int64), pm, np.int64([pt])
    ]).astype(np.int32)

    eps_actual = _certified_eps(
        flows, sol_r.unsched, prices_full, costs=costs, supply=supply,
        capacity=capacity, unsched_cost=unsched_cost, scale=scale,
        arc_capacity=arc_capacity,
    )
    if eps_actual > 1:
        # A column outside the union was genuinely attractive: the
        # reduction was unsound for this instance — solve in full.  The
        # wasted reduced-solve work stays visible in the telemetry.
        import dataclasses

        sol = full()
        return dataclasses.replace(
            sol, iterations=sol.iterations + sol_r.iterations,
            bf_sweeps=sol.bf_sweeps + sol_r.bf_sweeps,
        )
    n = E + M + 3
    return TransportSolution(
        flows=flows,
        unsched=sol_r.unsched,
        prices=normalize_prices(prices_full),
        objective=sol_r.objective,
        gap_bound=0.0 if scale > n else n / float(scale),
        iterations=sol_r.iterations,
        bf_sweeps=sol_r.bf_sweeps,
        phase_iters=sol_r.phase_iters,
        entry_phase=sol_r.entry_phase,
        telemetry=sol_r.telemetry,
    )

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``poseidon_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: the three CUDA sources built with ``nvcc`` from ``ops/csrc``
   (one process each, all started together), their ``-Xptxas -v``
   register and spill reports, and B1's shared-memory size checked
   against its Python mirror;
3. kernels: each kernel against its plain torch version on the card, at
   the main path's shapes (B1 also at its gate's two extremes, B2 also at
   a ragged shape and on a pruned plane's shortlist), with exact (zero)
   tolerance, the convergence-telemetry ring included (B1's ring and B2's
   route's, held against the plain ladder's ring, and each route's
   results with the ring equal to its results without it, with the same
   host reads), and timed with the ring on and off; B1 beside its
   previous design's time and its one-SM floor (its plane passes' bytes
   at the rate one SM reads L2, measured by a probe kernel, or its
   operations at one SM's share of the int32 rate) and its bound counted
   from each input read once; B2 with the CUDA kernels it
   launches per iteration (at most 3); the global update on mid-solve
   states covering its three exits and both launch plans (length tiles
   in shared memory, length planes in the workspace), with no host read,
   its ring marks equal to the plain update's, and its bound counted from
   each input read once;
4. main path: the port's gRPC server answers ``Schedule()`` for a
   10,000-machine / 100,000-pod cluster (one fresh wave, three churn
   rounds) with the planner tiers and the convergence telemetry at their
   defaults (pruned planes with the certificate cache, delta-maintained
   cost planes, cross-band pipelining, overlapped assignment; the ring
   on); every round must certify and logs its tier and telemetry counts,
   each device solve's route and padded shape, and its stage split; the
   same script with the plain versions forced must produce
   byte-identical deltas and equal telemetry counts; one more fresh wave
   with the telemetry off must produce the same deltas and host reads,
   and its device time is printed beside the telemetry-on wave's; then
   the dense path (the tiers off:
   the wave and one churn round) with the kernels, whose wave must match
   the main path's objective and placed count (plus a contended wave if
   no path reached the per-iteration kernel).  Each path's kernel
   launches are counted separately; every kernel of a route a path took
   must have launched in it, and every kernel in some path; B2's route
   on the wave must run the global-update kernel with no host read and
   at most 3 CUDA kernels per iteration, and its split by stage is
   printed;
5. the kernels again at the main path's own wave solves (the captured
   operands of its widest B1 and B2 solves), against their plain
   versions, after the path's launches were read.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  ``--compare N`` prints,
as JSON lines, one B2 iteration's device time at each B2 kernel case and
then the per-iteration route's split of each of N fresh-wave drives (no
churn, no plain run); run in two trees in turn, it compares them in one
call.  ``--compare N ring`` turns the telemetry ring on and off between
the drives (on, off, off, on, ...).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

# Seeded instances: the kernel phase's synthetic shapes and the main
# path's cluster recipe (3 machine shapes, 100 task shapes, seed 0).
SEED = 0
MACHINES = 10_000
TASKS = 100_000
TASK_SHAPES = 100
CHURN_ROUNDS = 3
# The dense drive (the planner tiers off) runs the wave and one churn
# round.
DENSE_CHURN_ROUNDS = 1
# The planner tiers the reference runs by default; "0" turns each off.
TIER_HATCHES = ("POSEIDON_PRUNED", "POSEIDON_CERT_CACHE",
                "POSEIDON_COST_DELTA", "POSEIDON_PIPELINE_BANDS",
                "POSEIDON_OVERLAP_ASSIGN")
TIER_FIELDS = ("solve_tier", "pruned_bands", "pruned_width",
               "pruned_price_out_rounds", "pruned_escalations",
               "pruned_cert_accepts", "cost_delta_hits",
               "cost_rows_rebuilt", "cost_cols_rebuilt",
               "pipeline_overlap_s")
# The convergence-telemetry roll-up of each round (RoundMetrics).
TELEM_FIELDS = ("telem_samples", "telem_gu_firings", "telem_decay_half_life",
                "telem_iters_to_90")
# The ring's capacity in the kernel cases: the default, as on the main path.
RING_CAP = 512
# Peak rates for the lower bound on a kernel's time (H100 SXM data sheet).
# HBM bytes/s; and the int32 rate: the sheet's 67 TFLOP/s fp32 counts an
# FMA as two operations on 128 fp32 lanes per SM, and an SM has 64 int32
# lanes doing one operation per clock each, a quarter of that rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 operations per [E, M] cell, counted from the kernel sources (each
# add, compare, logical and, select, min, max and floor-divide as one):
# a push/relabel iteration's passes over the planes (push_sweep in
# fused_ladder.cu; the same pushes, excess sums and relabels in
# tiled_iteration.cu); one Bellman-Ford sweep of B1 (global_update in
# fused_ladder.cu, counted with the arc lengths recomputed in the sweep);
# a phase's refine and excess sums.
OPS_PER_CELL_ITER = 60
OPS_PER_CELL_BF = 20
OPS_PER_CELL_PHASE = 10
# The route's global update (global_update.cu) computes each arc's two
# lengths once per update (the reduced cost, two floor-divides, the
# closed-arc tests and selects), then per cell and sweep does two
# relaxations (a closed-arc test, an add, a select and a min each).
OPS_PER_CELL_GU_LENGTHS = 15
OPS_PER_CELL_GU_SWEEP = 8
NUM_PHASES = 4
# B1's whole-solve times under its previous design (one thread per machine
# column walking all E rows in sequence), measured by this script on
# NVIDIA H100 80GB HBM3 at 700.00 W; the gate-extreme cases came later.
# Printed beside each case's time for comparison, never in the record.
PREVIOUS_B1_MS = {"coarse": 217.697, "churn": 64.346, "contended": 56.311}
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------- phase 1

def device_info() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return {"kind": name, "count": count, "smi": smi}


# --------------------------------------------------------------- phase 2

def build_kernels() -> float:
    from poseidon_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.lib()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    for src in _kernels._SOURCES:
        for line in _kernels.ptxas_report(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    check_smem()
    return secs


def check_smem() -> None:
    """B1 sizes its dynamic shared memory in C at launch; the Python
    mirror that the CPU tests hold to the route's gate must agree with it
    at every E the gate admits."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport_fused as TF

    so = _kernels.lib()
    e = 8
    while TF.fits_vmem(e, 32):
        c_bytes = so.pt_fused_ladder_smem_bytes(e)
        if c_bytes != TF.ladder_smem_bytes(e):
            fail(f"B1 shared memory at E={e}: kernel {c_bytes} bytes, "
                 f"mirror {TF.ladder_smem_bytes(e)}")
        e *= 2
    log(f"  B1 shared memory: {TF.ladder_smem_bytes(8)} to "
        f"{TF.ladder_smem_bytes(e // 2)} bytes for E = 8 to {e // 2}, "
        "kernel and mirror agree")


# One block streaming a buffer from L2 (16-byte loads that bypass L1):
# the rate one SM can read L2 at, which floors a one-block kernel.
_L2_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(1024, 1)
l2_stream(const int4* __restrict__ src, long n4, int reps, int* out) {
  int acc = 0;
  for (int r = 0; r < reps; ++r) {
#pragma unroll 4
    for (long i = threadIdx.x; i < n4; i += blockDim.x) {
      int4 v = __ldcg(src + i);
      acc += v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x7fffffff) out[0] = acc;
}
extern "C" int l2_probe(const void* src, long n4, int reps, int* out,
                        void* stream) {
  l2_stream<<<1, 1024, 0, (cudaStream_t)stream>>>((const int4*)src, n4,
                                                  reps, out);
  return (int)cudaGetLastError();
}
"""


def one_sm_l2_rate() -> float:
    """Bytes per second that one 1024-thread block reads from L2, over a
    512 KB buffer (C, Uem, F and P at [128, 256])."""
    import ctypes

    from poseidon_tpu_torch.ops import _kernels

    out_dir = _kernels.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "l2_probe.cu"
    src.write_text(_L2_PROBE_SRC)
    so = out_dir / "l2_probe.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                    "-o", str(so), str(src)], check=True, timeout=300)
    fn = ctypes.CDLL(str(so)).l2_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbytes, reps = 512 * 1024, 200
    buf = torch.ones(nbytes // 4, dtype=torch.int32, device=DEVICE)
    out = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    stream = torch.cuda.current_stream(DEVICE).cuda_stream

    def run():
        if fn(buf.data_ptr(), nbytes // 16, reps, out.data_ptr(), stream):
            fail("the L2 probe did not launch")

    ms = _time_cuda(run, 5)
    rate = nbytes * reps / (ms / 1e3)
    log(f"  one SM reads L2 at {rate / 1e9:.1f} GB/s (1024 threads, "
        f"16-byte loads, {nbytes // 1024} KB buffer)")
    return rate


# --------------------------------------------------------------- phase 3

def _instance(E, M, seed, *, supply_lo, supply_hi, cap_lo, cap_hi):
    from poseidon_tpu_torch.ops.transport import INF_COST

    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = INF_COST
    supply = rng.integers(supply_lo, supply_hi, size=E).astype(np.int32)
    cap = rng.integers(cap_lo, cap_hi, size=M).astype(np.int32)
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 64, size=(E, M)).astype(np.int32)
    return costs, supply, cap, unsched, arc


def _pack(costs, supply, cap, unsched, arc, *, flows=None, prices=None,
          eps_start=None, max_iter_total=8192, scale=None):
    """The packed operands solve_transport would dispatch for this
    instance (padding, scale — derived, or pinned by ``scale`` — epsilon
    ladder, knobs)."""
    from poseidon_tpu_torch.ops import transport as T

    E, M = costs.shape
    e_pad, m_pad = T.padded_shape(E, M)
    big = np.zeros((3, e_pad, m_pad), dtype=np.int32)
    big[0].fill(T.INF_COST)
    big[0, :E, :M] = costs
    big[1, :E, :M] = arc
    if flows is not None:
        big[2] = flows
    sup_p = np.zeros(e_pad, np.int32)
    sup_p[:E] = supply
    cap_p = np.zeros(m_pad, np.int32)
    cap_p[:M] = cap
    uns_p = np.ones(e_pad, np.int32)
    uns_p[:E] = unsched
    scale, eps_sched, _ = T._host_validate(
        big[0], sup_p, cap_p, uns_p, scale, eps_start, 8000)
    prices_p = (np.zeros(e_pad + m_pad + 1, np.int32) if prices is None
                else prices)
    vec = np.concatenate([
        sup_p, cap_p, uns_p, prices_p, np.zeros(e_pad, np.int32),
        eps_sched.astype(np.int32),
        np.asarray([max_iter_total, 4, 64, 1], np.int32),
    ])
    return big, vec, int(scale)


def _run_route(big, vec, scale, impl, telem_cap=RING_CAP):
    from poseidon_tpu_torch.ops import transport as T

    F, small = T._solve_device_packed(
        big, vec, max_iter=8192, scale=scale, impl=impl, device=DEVICE,
        telem_cap=telem_cap,
    )
    return F.cpu().numpy(), small


def _ring_checks(label, big, vec, scale, impl):
    """A route with the telemetry ring against the plain ladder with it
    (flows and the whole small result, the ring included), and against
    itself without it (same flows, the same small result minus the ring,
    the same host reads).  Returns (max_abs_err, the route's solve ms
    with the ring on and off, timed in turns: off, on, on, off), and
    fails on any difference."""
    from poseidon_tpu_torch.ops import transport as T

    r0 = T.host_read_count()
    Fk, sk = _run_route(big, vec, scale, impl)
    reads_on = T.host_read_count() - r0
    Fp, sp = _run_route(big, vec, scale, "lax")
    r0 = T.host_read_count()
    Fo, so = _run_route(big, vec, scale, impl, telem_cap=0)
    reads_off = T.host_read_count() - r0
    err = _max_err([Fk, sk], [Fp, sp])
    err_onoff = _max_err([Fk, sk[:so.size]], [Fo, so])
    if sk.size != so.size + 8 * RING_CAP:
        fail(f"{impl} {label}: the small result holds no ring")
    if err_onoff != 0:
        fail(f"{impl} {label}: results differ with the ring on and off")
    if reads_on != reads_off:
        fail(f"{impl} {label}: {reads_on} host reads with the ring, "
             f"{reads_off} without")
    times = [_time_cuda(lambda c=c: _run_route(big, vec, scale, impl, c), 3)
             for c in (0, RING_CAP, RING_CAP, 0)]
    return (err, (times[1] + times[2]) / 2, (times[0] + times[3]) / 2,
            reads_on, Fk, sk)


def _time_cuda(fn, reps):
    fn()
    if DEVICE.type != "cuda":  # rehearsal on the CPU: host clock
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1000 / reps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _time_device(fn, reps):
    """Device milliseconds per call of ``fn``: a sleep kernel holds the
    stream while the host enqueues all ``reps`` calls, so the events time
    the device alone.  Also returns the host's enqueue milliseconds per
    call."""
    fn()
    if DEVICE.type != "cuda":  # rehearsal on the CPU: host clock
        ms = _time_cuda(fn, reps)
        return ms, ms
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    h = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - h) * 1000 / reps
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host_ms


def _max_err(a_list, b_list) -> int:
    err = 0
    for a, b in zip(a_list, b_list):
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if a.shape != b.shape:
            return 1 << 62
        if a.size:
            err = max(err, int(np.abs(a - b).max()))
    return err


def check_fused(cases, l2_rate) -> list:
    """B1 against the plain ladder: whole-solve outputs at each shape,
    timed beside the previous design's time and the one-SM floor (the
    plane passes' bytes at ``l2_rate``, or the operations at one SM's
    share of the card's int32 rate, whichever is longer).  The bound
    counts each input read once and each output written once."""
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    rows = []
    for label, big, vec, scale in cases:
        err, ms, ms_off, reads, Fk, sk = _ring_checks(label, big, vec,
                                                      scale, "fused")
        E, M = big.shape[1:]
        o = E + E + M + 1
        iters, bf = int(sk[o]), int(sk[o + 1])
        plain_ms = _time_cuda(lambda: _run_route(big, vec, scale, "lax"), 1)
        # Bytes of the bound: each input read once (C, Uem and F; U,
        # supply, Ffb and pe; cap, Fmt and pm; pt and the 10 knobs), each
        # output written once (F; Ffb and pe; Fmt and pm; pt, the stats
        # and the ring).  The later passes re-read the planes from L2 and
        # the workspace is the kernel's own.
        nbytes = 4 * (4 * E * M + 6 * E + 5 * M + 12 + 3 + NUM_PHASES
                      + 8 * RING_CAP)
        ops = E * M * (OPS_PER_CELL_ITER * iters + OPS_PER_CELL_BF * bf
                       + OPS_PER_CELL_PHASE * NUM_PHASES)
        # One SM's floor: the plane passes' bytes (C, Uem and F read and F
        # written in every push/relabel iteration, C, Uem and F read in
        # every Bellman-Ford sweep) at the rate one SM reads L2, or the
        # operations at one SM's share of the int32 rate.
        pass_bytes = 4 * E * M * (4 * iters + 3 * bf)
        floor_bytes = pass_bytes / l2_rate * 1e3
        floor_ops = ops / (INT32_OPS_PER_S / sms) * 1e3
        floor_ms = max(floor_bytes, floor_ops)
        prev = PREVIOUS_B1_MS.get(label)
        rows.append(dict(shape=[E, M], label=label, err=err, iters=iters,
                         bf=bf, ms=ms, ms_ring_off=ms_off, plain_ms=plain_ms,
                         bytes=nbytes, ops=ops, one_sm_floor_ms=floor_ms,
                         host_reads=reads))
        log(f"  B1 {label} [{E}, {M}]: max_abs_err {err} (ring included), "
            f"iters {iters}, bf {bf}, clean {int(sk[o + 2])}; kernel "
            f"{ms:.3f} ms with the ring, {ms_off:.3f} ms without "
            f"({(ms - ms_off) / ms_off * 100:+.2f}%), {reads} host reads "
            "either way; "
            f"(previous design, recorded, not this run: "
            f"{'none' if prev is None else f'{prev:.3f} ms'}), "
            f"plain {plain_ms:.3f} ms, one-SM floor {floor_ms:.3f} ms "
            f"(L2 bytes {floor_bytes:.3f} ms, int32 operations "
            f"{floor_ops:.3f} ms)")
        if err != 0:
            fail(f"B1 differs from its plain version at {label}")
        if not int(sk[o + 2]):
            fail(f"B1 solve at {label} did not converge")
    return rows


def _prepared(big, vec, scale):
    """The prepared device operands and state of a packed solve, and its
    epsilon schedule."""
    from poseidon_tpu_torch.ops import transport as T

    E, M = big.shape[1:]
    bd = torch.from_numpy(big).to(DEVICE)
    vd = torch.from_numpy(vec).to(DEVICE)
    sup, cap, uns = vd[:E], vd[E:E + M], vd[E + M:2 * E + M]
    prices = vd[2 * E + M:3 * E + 2 * M + 1]
    fb = vd[3 * E + 2 * M + 1:4 * E + 2 * M + 1]
    ops, state = T._prepare_operands(
        bd[0], sup, cap, uns, bd[1], prices, bd[2], fb, scale=scale)
    ops["total"] = int(vec[:E].astype(np.int64).sum())
    o = 4 * E + 2 * M + 1
    return ops, state, [int(x) for x in vec[o:o + NUM_PHASES]]


def _b2_kernel_count():
    """CUDA kernels launched so far by B2's library (None off the card)."""
    from poseidon_tpu_torch.ops import _kernels

    if DEVICE.type != "cuda":
        return None
    return _kernels.lib().pt_tiled_iteration_kernels()


def _b2_start(big, vec, scale):
    """A B2 case's operands, its first iteration's arguments (the prepared
    state, its excesses and phase status) and the first phase's epsilon."""
    from poseidon_tpu_torch.ops import transport as T

    ops, state, eps_sched = _prepared(big, vec, scale)
    exc = T._excesses(*state[:3], supply=ops["supply"], total=ops["total"])
    st = T._phase_status(*exc, torch.zeros(1, dtype=torch.int32,
                                            device=DEVICE))
    return ops, (*state, *exc, st), eps_sched[0]


B2_REPS = 20


def _time_b2(step, ops, args, eps, ring=None):
    """One B2 iteration (with the relabel) through ``step``, called
    ``B2_REPS`` times after one warm-up call as one object is in a solve,
    writing its telemetry sample into ``ring`` when given: device ms and
    host enqueue ms per call (``_time_device``)."""
    return _time_device(
        lambda: step(*args, eps=eps, do_relabel=True, ring=ring, **ops),
        B2_REPS)


def _ring():
    return torch.zeros((8, RING_CAP), dtype=torch.int32, device=DEVICE)


def check_tiled(cases) -> list:
    """B2 against the plain iteration: whole solves through both (their
    global updates through the global-update kernel and the plain update),
    plus one iteration from the prepared state, with and without the
    relabel, timed on the device (one object for all calls, as in a
    solve) with the host's enqueue time and the CUDA kernels it
    launched."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops.transport_tiled import TiledIteration

    rows = []
    for label, big, vec, scale in cases:
        err, solve_ms, solve_ms_off, reads, Fk, sk = _ring_checks(
            label, big, vec, scale, "tiled")
        E, M = big.shape[1:]
        o = E + E + M + 1
        iters, bf = int(sk[o]), int(sk[o + 1])
        ops, args, eps = _b2_start(big, vec, scale)
        for relabel in (True, False):
            rk, rp = _ring(), _ring()
            a = TiledIteration()(*args, eps=eps, do_relabel=relabel,
                                 ring=rk, ring_base=3, **ops)
            b = T._pr_iteration(*args, eps=eps, do_relabel=relabel,
                                ring=rp, ring_base=3, **ops)
            err = max(err, _max_err([t.cpu().numpy() for t in (*a, rk)],
                                    [t.cpu().numpy() for t in (*b, rp)]))
            if bool(rk.any()) != bool(int(args[-1][0])):
                fail(f"B2 {label}: the iteration's ring sample does not "
                     "follow its entering status")
        k0 = _b2_kernel_count()
        # Ring off, on, on, off.
        t_off_a = _time_b2(TiledIteration(), ops, args, eps)
        t_on_a = _time_b2(TiledIteration(), ops, args, eps, _ring())
        t_on_b = _time_b2(TiledIteration(), ops, args, eps, _ring())
        t_off_b = _time_b2(TiledIteration(), ops, args, eps)
        ms, host_ms = ((t_on_a[0] + t_on_b[0]) / 2,
                       (t_on_a[1] + t_on_b[1]) / 2)
        ms_off = (t_off_a[0] + t_off_b[0]) / 2
        per_iter = (None if k0 is None
                    else (_b2_kernel_count() - k0) / (4 * (B2_REPS + 1)))
        plain_ms = _time_cuda(lambda: T._pr_iteration(
            *args, eps=eps, do_relabel=True, ring=_ring(), **ops), 20)
        nbytes = 4 * 4 * E * M  # C, Uem, F read once; F written once
        ops_n = OPS_PER_CELL_ITER * E * M
        rows.append(dict(shape=[E, M], label=label, err=err, iters=iters,
                         bf=bf, ms=ms, ms_ring_off=ms_off, plain_ms=plain_ms,
                         host_ms=host_ms, kernels_per_iteration=per_iter,
                         solve_ms=solve_ms, solve_ms_ring_off=solve_ms_off,
                         host_reads=reads, bytes=nbytes, ops=ops_n))
        log(f"  B2 {label} [{E}, {M}]: max_abs_err {err} (ring included), "
            f"solve iters {iters}, bf {bf}, clean {int(sk[o + 2])}; one "
            f"iteration: kernel {ms:.4f} ms on the device with the ring, "
            f"{ms_off:.4f} ms without ({host_ms:.4f} ms host enqueue, "
            f"{per_iter} CUDA kernels), plain {plain_ms:.4f} ms; the "
            f"route's solve {solve_ms:.3f} ms with the ring, "
            f"{solve_ms_off:.3f} ms without, {reads} host reads either way")
        if err != 0:
            fail(f"B2 differs from its plain version at {label}")
        if not int(sk[o + 2]):
            fail(f"B2 solve at {label} did not converge")
        if per_iter is not None and per_iter > 3:
            fail(f"B2 launched {per_iter} CUDA kernels per iteration")
    return rows


def _mid_solve_states(big, vec, scale):
    """States of the plain ladder in its first and second epsilon phases,
    each after its refine and 8 iterations (global updates included),
    with the phase's epsilon; and the first again at epsilon 2^27, where
    the overflow guard (finite_max < 2^26 // eps = 0) refuses the update,
    while the lengths stay non-negative (the state is eps-optimal for a
    smaller epsilon), so the sweeps converge."""
    from poseidon_tpu_torch.ops import transport as T

    ops, state, eps_sched = _prepared(big, vec, scale)
    kw = dict(ops=ops, iterate=T._pr_iteration,
              global_update=T._global_update,
              sweeps=torch.zeros(1, dtype=torch.int32, device=DEVICE),
              total_iters=0, max_iter_total=8192, global_every=4,
              bf_max=64, adaptive=1, unroll=4, stage="chip_smoke.states")
    s0, _ = T._pr_phase(state, eps_sched[0], max_iter=8, **kw)
    end0, _ = T._pr_phase(state, eps_sched[0], max_iter=8192, **kw)
    s1, _ = T._pr_phase(end0, eps_sched[1], max_iter=8, **kw)
    return ops, [("phase 0", eps_sched[0], s0), ("phase 1", eps_sched[1], s1),
                 ("phase 0 at eps 2^27", 1 << 27, s0)]


def check_global_update(cases) -> list:
    """The global-update kernel against the plain ``_global_update`` on
    mid-solve states: (pe, pm, pt) and the sweep count bit-equal.  Each
    shape must cover three exits: converged and applied, converged with
    the overflow guard refusing, and unconverged at bf_max (bf_max 0
    stops after one group of sweeps that still moved).  Timed per update
    on the device; the kernel must make no host read.  Each case records
    its launch plan (blocks, length tiles in shared memory or not)."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops.transport_tiled import (
        GlobalUpdate,
        global_update_plan,
    )

    rows = []
    for label, big, vec, scale in cases:
        E, M = big.shape[1:]
        plan = global_update_plan(E, M) if DEVICE.type == "cuda" else None
        ops, states = _mid_solve_states(big, vec, scale)
        gu_ops = {k: ops[k] for k in ("C", "U", "Uem", "supply", "cap",
                                      "adm")}
        exits = {}
        for where, eps, s in states:
            exc = T._excesses(*s[:3], supply=ops["supply"],
                              total=ops["total"])
            full_sweeps = None
            for bf_max in (64, 0):
                args = (*s, *exc)
                acc_k = torch.zeros(1, dtype=torch.int32, device=DEVICE)
                acc_p = torch.zeros(1, dtype=torch.int32, device=DEVICE)
                ring_k, ring_p = _ring(), _ring()
                step = GlobalUpdate()
                reads0 = T.host_read_count()
                out_k = step(*args, acc_k, eps=eps, bf_max=bf_max,
                             ring=ring_k, ring_slot=9, **gu_ops)
                reads = T.host_read_count() - reads0
                out_p = T._global_update(*args, acc_p, eps=eps,
                                         bf_max=bf_max, ring=ring_p,
                                         ring_slot=9, **gu_ops)
                err = _max_err(
                    [t.cpu().numpy() for t in (*out_k, acc_k, ring_k)],
                    [t.cpu().numpy() for t in (*out_p, acc_p, ring_p)])
                sweeps = int(acc_p.cpu()[0])
                applied = any(bool((a != b).any())
                              for a, b in zip(out_p, s[3:6]))
                if bf_max == 64:
                    full_sweeps = sweeps
                # Not applied: refused if the loop ended converged (before
                # bf_max, or the full run's first group moved nothing),
                # unconverged if the full run went on past this group.
                if applied:
                    kind = "applied"
                elif sweeps <= bf_max or full_sweeps == sweeps:
                    kind = "refused"
                elif full_sweeps > sweeps:
                    kind = "unconverged"
                else:
                    kind = "ambiguous"
                acc_t = torch.zeros(1, dtype=torch.int32, device=DEVICE)
                ms, host_ms = _time_device(lambda: step(
                    *args, acc_t, eps=eps, bf_max=bf_max, ring=ring_k,
                    ring_slot=9, **gu_ops), 10)
                plain_ms = _time_cuda(lambda: T._global_update(
                    *args, acc_t, eps=eps, bf_max=bf_max, **gu_ops), 2)
                # Bytes: each input read once (C, Uem and F; U, supply,
                # Ffb, pe, exc_e; cap, Fmt, pm, exc_m; pt, exc_t and the
                # sweep count), each output written once (pe, pm, pt, the
                # sweep count).  The length planes are the kernel's own.
                nbytes = 4 * (3 * E * M + 6 * E + 5 * M + 5)
                ops_n = E * M * (OPS_PER_CELL_GU_LENGTHS
                                 + OPS_PER_CELL_GU_SWEEP * sweeps)
                row = dict(shape=[E, M], label=f"{label} {where} bf_max "
                           f"{bf_max} ({kind})", exit=kind, err=err,
                           sweeps=sweeps, ms=ms, plain_ms=plain_ms,
                           host_ms=host_ms, host_reads=reads, bytes=nbytes,
                           ops=ops_n, plan=plan)
                rows.append(row)
                exits.setdefault(kind, row)
                bound = max(nbytes / HBM_BYTES_PER_S,
                            ops_n / INT32_OPS_PER_S) * 1e3
                log(f"  global update {row['label']} [{E}, {M}] eps {eps}: "
                    f"max_abs_err {err}, sweeps {sweeps}, kernel {ms:.4f} "
                    f"ms ({ms / sweeps:.5f} ms per sweep; host enqueue "
                    f"{host_ms:.4f} ms, host reads {reads}; plan {plan}), "
                    f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
                    f"({ms / bound:.1f}x)")
                if err != 0:
                    fail(f"global update differs from its plain version at "
                         f"{row['label']}")
                if reads != 0 and DEVICE.type == "cuda":
                    fail(f"global update made {reads} host reads")
        missing = {"applied", "refused", "unconverged"} - set(exits)
        if missing:
            fail(f"global update at {label}: exits {sorted(missing)} not "
                 "covered")
    # The record's lead case: an applied update at the wave's shape.
    rows.sort(key=lambda r: r["exit"] != "applied")
    return rows


def kernel_cases():
    """B1 at the wave's coarse shape, the churn width at the gate's edge,
    a contended instance and the gate's two extremes (fewest ECs at the
    widest plane, most ECs at the narrowest); B2 at the wave's padded
    width, cold and warm, at the gate's edge, and ragged (the wave's size
    unpadded, E and M not multiples of B2's tiles).  The global update
    runs on the cold and edge cases' mid-solve states, and on those of a
    wider band, [256, 16384], past the width at which every tile's block
    can hold its length tiles in shared memory at once (the other plan)."""
    fused = []
    for label, (E, M), kw in (
        ("coarse", (128, 256), dict(supply_lo=500, supply_hi=1500,
                                    cap_lo=200, cap_hi=600)),
        ("churn", (128, 1280), dict(supply_lo=1, supply_hi=9,
                                    cap_lo=1, cap_hi=12)),
        ("contended", (64, 1024), dict(supply_lo=40, supply_hi=120,
                                       cap_lo=1, cap_hi=6)),
        ("wide", (8, 20480), dict(supply_lo=500, supply_hi=1500,
                                  cap_lo=1, cap_hi=12)),
        ("tall", (1024, 128), dict(supply_lo=1, supply_hi=9,
                                   cap_lo=10, cap_hi=60)),
    ):
        inst = _instance(E, M, SEED, **kw)
        fused.append((label,) + _pack(*inst))
    tiled = []
    wave = dict(supply_lo=500, supply_hi=1500, cap_lo=4, cap_hi=12)
    inst = _instance(128, 10240, SEED, **wave)
    big, vec, scale = _pack(*inst)
    tiled.append(("cold", big, vec, scale))
    # Warm: the cold optimum as the start of a drifted instance.
    F, small = _run_route(big, vec, scale, "lax")
    E, M = big.shape[1:]
    prices = small[E:2 * E + M + 1]
    rng = np.random.default_rng(SEED + 1)
    costs2 = inst[0].copy()
    adm = costs2 < 1000
    costs2[adm] = np.clip(costs2[adm] + rng.integers(-3, 4, adm.sum()), 0,
                          999)
    tiled.append(("warm",) + _pack(costs2, *inst[1:], flows=F,
                                   prices=prices, eps_start=8 * scale + 1))
    inst = _instance(256, 10240, SEED, **wave)
    tiled.append(("edge",) + _pack(*inst))
    # Ragged: the wave's size with E and M not multiples of B2's tiles,
    # unpadded.
    costs, supply, cap, unsched, arc = _instance(100, 10000, SEED, **wave)
    big = np.stack([costs, arc, np.zeros_like(costs)])
    from poseidon_tpu_torch.ops import transport as T

    scale, eps_sched, _ = T._host_validate(costs, supply, cap, unsched,
                                           None, None, 8000)
    vec = np.concatenate([
        supply, cap, unsched, np.zeros(100 + 10000 + 1, np.int32),
        np.zeros(100, np.int32), eps_sched.astype(np.int32),
        np.asarray([8192, 4, 64, 1], np.int32),
    ]).astype(np.int32)
    tiled.append(("ragged", big, vec, int(scale)))
    tiled.append(("pruned",) + _pruned_case(128, 10240))
    gu = [c for c in tiled if c[0] in ("cold", "edge")]
    gu.append(("wide",) + _pack(*_instance(256, 16384, SEED, **wave)))
    return fused, tiled, gu


def _pruned_case(E, M):
    """A pruned-plane solve as the planner's pruned path dispatches it:
    the shortlist (``plan_shortlist`` at the wave gate) of a slack-rich
    [E, M] plane, at the full plane's pinned scale."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops import transport_pruned as TP

    costs, supply, cap, unsched, arc = _instance(
        E, M, SEED, supply_lo=10, supply_hi=30, cap_lo=1, cap_hi=4)
    plan = TP.plan_shortlist(costs, supply, cap, arc)
    if plan is None:
        fail(f"the shortlist planner declined the [{E}, {M}] plane")
    scale, _ = T.derive_scale(costs, unsched, 8000, *T.padded_shape(E, M))
    sel = plan.sel
    big, vec, _ = _pack(costs[:, sel], supply, cap[sel], unsched,
                        arc[:, sel], scale=scale)
    return big, vec, scale


def kernel_phase():
    fused_cases, tiled_cases, gu_cases = kernel_cases()
    log("kernels: B1 fused ladder vs plain ladder")
    l2_rate = one_sm_l2_rate()
    fused = check_fused(fused_cases, l2_rate)
    log("kernels: B2 per-iteration kernels vs plain iteration")
    tiled = check_tiled(tiled_cases)
    log("kernels: global-update kernel vs plain global update")
    gu = check_global_update(gu_cases)
    plans = {r["plan"][1] for r in gu}
    if DEVICE.type == "cuda" and plans != {0, 1}:
        fail(f"the global-update cases took plans {sorted(plans)}: both "
             "the shared-memory and the workspace plan must run")
    return fused, tiled, gu, l2_rate


# --------------------------------------------------------------- phase 4

def _node(uuid, cpu, ram, slots):
    from poseidon_tpu_torch.protos import firmament_pb2 as fpb

    rtnd = fpb.ResourceTopologyNodeDescriptor()
    rd = rtnd.resource_desc
    rd.uuid = uuid
    rd.type = fpb.ResourceDescriptor.RESOURCE_MACHINE
    rd.resource_capacity.cpu_cores = cpu
    rd.resource_capacity.ram_cap = ram
    rd.task_capacity = slots
    pu = rtnd.children.add()
    pu.resource_desc.uuid = uuid + "-pu0"
    pu.resource_desc.type = fpb.ResourceDescriptor.RESOURCE_PU
    pu.parent_id = uuid
    return rtnd


def _task(uid, job, cpu, ram):
    from poseidon_tpu_torch.protos import firmament_pb2 as fpb

    req = fpb.TaskDescription()
    td = req.task_descriptor
    td.uid = uid
    td.job_id = job
    td.resource_request.cpu_cores = cpu
    td.resource_request.ram_cap = ram
    req.job_descriptor.uuid = job
    return req


def _send(method, requests, ok_type, batch=2048):
    """Unary RPCs, pipelined in batches of futures; every reply must be
    the OK answer ``ok_type``."""
    for b in range(0, len(requests), batch):
        futs = [method.future(r) for r in requests[b:b + batch]]
        for f in futs:
            if f.result().type != ok_type:
                fail(f"unexpected reply {f.result()}")


def _population():
    """bench.py's recipe: 3 machine shapes (64 slots each), TASK_SHAPES
    task shapes of uniform multiplicity, seed SEED."""
    from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

    shapes = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]
    nodes = [
        _node(generate_uuid(f"bench-m{i}"), *shapes[i % 3], 64)
        for i in range(MACHINES)
    ]
    rng = np.random.default_rng(SEED)
    ec_cpu = rng.integers(100, 4000, size=TASK_SHAPES)
    ec_ram = rng.integers(1 << 18, 1 << 22, size=TASK_SHAPES)
    ec_of_task = rng.integers(0, TASK_SHAPES, size=TASKS)
    tasks = []
    for i in range(TASKS):
        e = int(ec_of_task[i])
        tasks.append((task_uid(f"bench-job-s{SEED}", i), f"bench-job-{e}",
                      int(ec_cpu[e]), int(ec_ram[e])))
    return nodes, tasks


def _contended():
    """bench.contended_cluster's recipe scaled to MACHINES machines: demand
    just past comfortable capacity, so no start certifies on the host."""
    from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

    nodes = [_node(generate_uuid(f"cc-m{i}"), 4000, 1 << 24, 8)
             for i in range(MACHINES)]
    tasks = []
    per_ec = MACHINES * 8 * 6 // (10 * 24)
    for e in range(24):
        for i in range(per_ec):
            tasks.append((task_uid(f"cc-{e}", i), f"cc-{e}", 300 + 37 * e,
                          1 << 18))
    return nodes, tasks


def route_split(reads0, iters0, sweeps0) -> dict:
    """The per-iteration route's (B2's) device solve split by stage, from
    the stage timers since their last reset: host (enqueue) seconds,
    device seconds (CUDA events around each stage), calls and host reads
    per stage, and each route's iterations and Bellman-Ford sweeps."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.utils import stagetimer

    host = stagetimer.snapshot()
    dev = stagetimer.device_snapshot()
    out = {"stages": {}, "route_iters": {}, "route_sweeps": {}}
    for name in ("solve.device.tiled", "solve.device.tiled.iterate",
                 "solve.device.tiled.global_update",
                 "solve.device.tiled.other", "solve.device.fused"):
        out["stages"][name] = {
            "host_s": host.get(name, (0.0, 0))[0],
            "device_s": dev.get(name, (0.0, 0))[0],
            "calls": host.get(name, (0.0, 0))[1],
            "host_reads": T._Telemetry.stage_reads[name] - reads0[name],
        }
    for impl in ("fused", "tiled", "lax"):
        out["route_iters"][impl] = T._Telemetry.route_iters[impl] \
            - iters0[impl]
        out["route_sweeps"][impl] = T._Telemetry.route_sweeps[impl] \
            - sweeps0[impl]
    return out


def _channel(srv):
    import grpc

    return grpc.insecure_channel(srv.address, options=[
        # A 100k-pod wave's SchedulingDeltas pass 4 MB.
        ("grpc.max_receive_message_length", 256 << 20),
    ])


def load_cluster(label, nodes, tasks):
    """Load the cluster over gRPC into a fresh server of the port and
    save it as the server's restart checkpoint (its ``checkpoint_path``,
    under build/, before any round); returns the checkpoint's path.
    Every drive then starts its server from that checkpoint, as a
    restarted service does, so the 110k-RPC load runs once per cluster."""
    from pathlib import Path

    from poseidon_tpu_torch.protos import firmament_pb2 as fpb
    from poseidon_tpu_torch.protos.services import (
        FIRMAMENT_METHODS,
        FIRMAMENT_SERVICE,
        make_stubs,
    )
    from poseidon_tpu_torch.service.server import FirmamentTPUServer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{label}.json"
    for stale in (path, Path(str(path) + ".warm.npz")):
        stale.unlink(missing_ok=True)
    cfg = FirmamentTPUConfig(device=DEVICE.type, checkpoint_path=str(path))
    with FirmamentTPUServer(cfg, address="127.0.0.1:0") as srv, \
            _channel(srv) as ch:
        stubs = make_stubs(ch, FIRMAMENT_SERVICE, FIRMAMENT_METHODS)
        t0 = time.perf_counter()
        _send(stubs.NodeAdded, nodes, fpb.NODE_ADDED_OK)
        _send(stubs.TaskSubmitted, [_task(*t) for t in tasks],
              fpb.TASK_SUBMITTED_OK)
        t1 = time.perf_counter()
        srv.servicer.save_checkpoint()
        log(f"  [{label}] loaded {len(nodes)} machines, {len(tasks)} pods "
            f"over gRPC in {t1 - t0:.1f} s; checkpoint saved in "
            f"{time.perf_counter() - t1:.1f} s")
    if not path.exists():
        fail(f"[{label}] the server saved no checkpoint")
    return path


def drive(label, ckpt, tasks, churn_rounds, capture=None):
    """Start the port's server from the cluster checkpoint ``ckpt``
    (``load_cluster``), run a fresh wave and ``churn_rounds`` churn
    rounds over gRPC (each removing and resubmitting 1% of ``tasks``).
    Returns per-round records (serialized deltas, metrics with the
    planner tiers' counts, wall seconds, launches, host reads, each
    device solve's route and padded shape, and B2's route split by
    stage).  ``capture``, a list, receives the packed operands of the
    wave's device solves, for the kernels to be held against their plain
    versions at those shapes afterwards."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.protos import firmament_pb2 as fpb
    from poseidon_tpu_torch.protos.services import (
        FIRMAMENT_METHODS,
        FIRMAMENT_SERVICE,
        make_stubs,
    )
    from poseidon_tpu_torch.service.server import FirmamentTPUServer
    from poseidon_tpu_torch.utils import stagetimer
    from poseidon_tpu_torch.utils.config import FirmamentTPUConfig

    rounds = []
    rng = np.random.default_rng(SEED + 1)
    cfg = FirmamentTPUConfig(precompile=True, device=DEVICE.type,
                             checkpoint_path=str(ckpt))
    t0 = time.perf_counter()
    with FirmamentTPUServer(cfg, address="127.0.0.1:0") as srv, \
            _channel(srv) as ch:
        stubs = make_stubs(ch, FIRMAMENT_SERVICE, FIRMAMENT_METHODS)
        srv.servicer.ensure_precompiled()
        st = srv.servicer.state
        log(f"  [{label}] server restored {len(st.machines)} machines, "
            f"{len(st.tasks)} pods from the checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        live = list(tasks)
        for r in range(churn_rounds + 1):
            if r > 0:  # churn: remove and resubmit 1% of the pods
                pick = rng.choice(len(live), size=len(live) // 100,
                                  replace=False)
                _send(stubs.TaskRemoved,
                      [fpb.TaskUID(task_uid=live[k][0]) for k in pick],
                      fpb.TASK_REMOVED_OK)
                _send(stubs.TaskSubmitted, [_task(*live[k]) for k in pick],
                      fpb.TASK_SUBMITTED_OK)
            _kernels.reset_launches()
            stagetimer.reset()
            reads0 = T.host_read_count()
            routes0 = dict(T._Telemetry.routes)
            split0 = (Counter(T._Telemetry.stage_reads),
                      Counter(T._Telemetry.route_iters),
                      Counter(T._Telemetry.route_sweeps))
            k0 = _b2_kernel_count()
            packed = T._solve_device_packed
            if capture is not None and r == 0:
                def spy(big, vec, **kw):
                    capture.append((kw["impl"], big.copy(), vec.copy(),
                                    kw["scale"]))
                    return packed(big, vec, **kw)

                T._solve_device_packed = spy
            t0 = time.perf_counter()
            try:
                out = stubs.Schedule(fpb.ScheduleRequest())
            finally:
                T._solve_device_packed = packed
            wall = time.perf_counter() - t0
            k1 = _b2_kernel_count()
            m = srv.servicer.planner.last_metrics
            rec = dict(
                kind="wave" if r == 0 else f"churn{r}",
                deltas=out.SerializeToString(), wall_s=wall,
                placed=m.placed, unscheduled=m.unscheduled,
                iterations=m.iterations, bf_sweeps=m.bf_sweeps,
                objective=m.objective, gap_bound=m.gap_bound,
                converged=m.converged, device_calls=m.device_calls,
                launches=dict(_kernels.LAUNCHES),
                host_reads=T.host_read_count() - reads0,
                routes={f"{k[0]}[{k[1]}, {k[2]}]": n - routes0.get(k, 0)
                        for k, n in sorted(T._Telemetry.routes.items())
                        if n > routes0.get(k, 0)},
                tiers={f: getattr(m, f) for f in TIER_FIELDS},
                telem={f: getattr(m, f) for f in TELEM_FIELDS},
                stages={k: v[0] for k, v in stagetimer.snapshot().items()},
                split=route_split(*split0),
                b2_kernels=None if k0 is None else k1 - k0,
            )
            rounds.append(rec)
            log(f"  [{label}] {rec['kind']}: {wall:.3f} s wall, placed "
                f"{m.placed}, unscheduled {m.unscheduled}, objective "
                f"{m.objective}, iterations {m.iterations}, bf "
                f"{m.bf_sweeps}, device solves {m.device_calls}, launches "
                f"{rec['launches']}, host reads {rec['host_reads']}, gap "
                f"{m.gap_bound}, solves by route [E_pad, M_pad] "
                f"{rec['routes']}")
            log(f"    tiers: {json.dumps(rec['tiers'])}")
            log(f"    telemetry: {json.dumps(rec['telem'])}")
            log("    stages (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(
                    rec["stages"].items(), key=lambda kv: -kv[1])))
            if rec["split"]["stages"]["solve.device.tiled"]["calls"]:
                log("    B2 route split: " + json.dumps(rec["split"]))
            if m.gap_bound != 0.0 or not m.converged:
                fail(f"[{label}] {rec['kind']} did not certify "
                     f"(gap_bound {m.gap_bound})")
    return rounds


def _set_plain(plain: bool) -> None:
    for k in ("POSEIDON_FUSED", "POSEIDON_TILED"):
        if plain:
            os.environ[k] = "0"
        else:
            os.environ.pop(k, None)


def _set_telemetry(on: bool) -> None:
    """The convergence-telemetry ring at its default (on), or off."""
    if on:
        os.environ.pop("POSEIDON_SOLVE_TELEMETRY", None)
    else:
        os.environ["POSEIDON_SOLVE_TELEMETRY"] = "0"


def _set_tiers(on: bool) -> None:
    """The planner tiers at their defaults (on), or each turned off."""
    for k in TIER_HATCHES:
        if on:
            os.environ.pop(k, None)
        else:
            os.environ[k] = "0"


KERNEL_NAMES = ("fused_ladder", "tiled_iteration", "global_update")
# The kernels a solve route launches.
ROUTE_KERNELS = {"fused": ("fused_ladder",),
                 "tiled": ("tiled_iteration", "global_update")}


def _path_launches(rounds) -> dict:
    return {k: sum(r["launches"][k] for r in rounds) for k in KERNEL_NAMES}


def _check_path(name, rounds) -> None:
    """Every kernel of the routes this path's solves took was launched,
    and counted, in this path's run."""
    launched = _path_launches(rounds)
    for r in rounds:
        for route in r["routes"]:
            for k in ROUTE_KERNELS.get(route.split("[")[0], ()):
                if launched[k] == 0:
                    fail(f"[{name}] {r['kind']} solved on {route} but "
                         f"{k} was never launched")


def main_path(capture):
    """The main path — the planner tiers at their defaults — with the
    kernels, then again with the plain versions forced (the deltas must
    match byte for byte, and the telemetry counts); its wave again with
    the telemetry off (the same deltas and host reads; ``ring_cost``
    holds the two waves' device and wall seconds); then the dense path,
    the tiers off, with the kernels.  Where the paths' waves never
    reached the per-iteration kernel, a contended wave stands in for it.
    ``capture`` receives the main path's wave solves (see ``drive``)."""
    from poseidon_tpu_torch.utils import stagetimer

    nodes, tasks = _population()
    ckpt = load_cluster("population", nodes, tasks)
    del nodes
    results = {}
    _set_tiers(True)
    _set_plain(False)
    log("main path (tiers on): wave, kernels")
    stagetimer.set_device_timing(True)
    kern = drive("tiers-on", ckpt, tasks, CHURN_ROUNDS, capture=capture)
    stagetimer.set_device_timing(False)
    _check_path("tiers-on", kern)
    _set_plain(True)
    log("main path (tiers on): wave, plain versions forced")
    plain = drive("tiers-on", ckpt, tasks, CHURN_ROUNDS)
    _set_plain(False)
    for a, b in zip(kern, plain):
        if a["deltas"] != b["deltas"]:
            fail(f"[tiers-on] {a['kind']}: deltas differ between the "
                 "kernel and plain runs")
        if a["telem"] != b["telem"]:
            fail(f"[tiers-on] {a['kind']}: telemetry counts differ between "
                 f"the kernel and plain runs: {a['telem']} vs {b['telem']}")
    if not kern[0]["telem"]["telem_samples"]:
        fail("[tiers-on] the wave captured no telemetry sample")
    log(f"  [tiers-on] deltas byte-identical and telemetry counts equal to "
        f"the plain run over {len(kern)} rounds")
    results["tiers_on"] = kern

    _set_telemetry(False)
    log("main path (tiers on): wave, kernels, telemetry off")
    stagetimer.set_device_timing(True)
    off = drive("telemetry-off", ckpt, tasks, 0)
    stagetimer.set_device_timing(False)
    _set_telemetry(True)
    _check_path("telemetry-off", off)
    w_on, w_off = kern[0], off[0]
    if w_on["deltas"] != w_off["deltas"]:
        fail("the wave's deltas differ with the telemetry on and off")
    if w_on["host_reads"] != w_off["host_reads"]:
        fail(f"the wave made {w_on['host_reads']} host reads with the "
             f"telemetry on, {w_off['host_reads']} with it off")
    if any(w_off["telem"].values()):
        fail(f"the telemetry-off wave reported {w_off['telem']}")

    def device_s(rec, stage):
        return rec["split"]["stages"][stage]["device_s"]

    ring_cost = {
        "solve.device_s": [w_on["stages"].get("solve.device", 0.0),
                           w_off["stages"].get("solve.device", 0.0)],
        "b2_route_device_s": [device_s(w_on, "solve.device.tiled"),
                              device_s(w_off, "solve.device.tiled")],
        "b1_route_device_s": [device_s(w_on, "solve.device.fused"),
                              device_s(w_off, "solve.device.fused")],
        "wall_s": [w_on["wall_s"], w_off["wall_s"]],
        "host_reads": [w_on["host_reads"], w_off["host_reads"]],
    }
    log("  the wave with the telemetry on / off (same deltas): "
        + json.dumps(ring_cost))
    results["telemetry_off"] = off

    _set_tiers(False)
    log("dense path (tiers off): wave, kernels")
    stagetimer.set_device_timing(True)
    dense = drive("dense", ckpt, tasks, DENSE_CHURN_ROUNDS)
    stagetimer.set_device_timing(False)
    _set_tiers(True)
    _check_path("dense", dense)
    results["dense"] = dense
    w_on, w_off = kern[0], dense[0]
    log(f"  waves: tiers on objective {w_on['objective']} placed "
        f"{w_on['placed']}; tiers off objective {w_off['objective']} "
        f"placed {w_off['placed']}")
    if (w_on["objective"], w_on["placed"]) != \
            (w_off["objective"], w_off["placed"]):
        fail("the tiers-on and tiers-off waves differ in objective or "
             "placed count")

    if not any(r["launches"]["tiled_iteration"]
               for rs in results.values() for r in rs):
        log("  no wave reached the per-iteration kernel; adding a "
            "contended 10k-machine wave")
        nodes, tasks = _contended()
        results["contended"] = drive(
            "contended", load_cluster("contended", nodes, tasks), tasks, 0)
        _check_path("contended", results["contended"])
    launches = {name: _path_launches(rs) for name, rs in results.items()}
    log(f"  launches by path: {json.dumps(launches)}")
    if kern[0]["launches"]["fused_ladder"] == 0:
        fail("the fresh wave launched no fused ladder kernel")
    for k in KERNEL_NAMES:
        if not any(n[k] for n in launches.values()):
            fail(f"no path launched {k}")
    # B2's route on a wave (the first path's wave that took it): its
    # global updates ran as the kernel, with no host read, and each
    # iteration launched at most three CUDA kernels.
    b2 = next(rs[0] for rs in results.values()
              if rs[0]["launches"]["tiled_iteration"])
    if b2["launches"]["global_update"] == 0:
        fail("B2's route on the wave launched no global-update kernel")
    gu_reads = b2["split"]["stages"]["solve.device.tiled.global_update"][
        "host_reads"]
    per_iter = (None if b2["b2_kernels"] is None else
                b2["b2_kernels"] / b2["launches"]["tiled_iteration"])
    log(f"  B2's route on the wave: {b2['launches']['tiled_iteration']} "
        f"iterations, {per_iter} CUDA kernels per iteration, "
        f"{b2['launches']['global_update']} global updates with "
        f"{gu_reads} host reads")
    if gu_reads != 0:
        fail(f"the wave's global updates made {gu_reads} host reads")
    if per_iter is not None and per_iter > 3:
        fail(f"B2 launched {per_iter} CUDA kernels per iteration")
    return results, launches, ring_cost


def main_path_cases(capture):
    """The main path's own wave solves, as kernel cases: each route's
    widest solve other than the coarse [E, 256] start (a kernel case of
    its own)."""
    best = {}
    for impl, big, vec, scale in capture:
        E, M = big.shape[1:]
        if impl == "lax" or M == 256:
            continue
        if impl not in best or M > best[impl][1].shape[2]:
            best[impl] = ("main-path wave", big, vec, scale)
    return best


def kernels_record(fused, tiled, gu, launches):
    """The kernels line.  ``launches`` is ``{path: {kernel: n}}``, each
    path's count read just after its own drive; a row's ``launches`` is
    their sum over the paths, ``launches_by_path`` the split.  Every
    kernel carries the convergence-telemetry ring (B1 and B2 write the
    samples, the global update its fired bit and sweeps); ``ms`` is with
    the ring, ``ms_ring_off`` without it, where timed."""
    def row(name, source, replaces, unit, cases, n):
        lead = cases[0]
        bound_bytes = lead["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = lead["ops"] / INT32_OPS_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[n] for p in launches.values()),
            "launches_by_path": {k: p[n] for k, p in launches.items()},
            "launch_unit": unit,
            "max_abs_err": max(c["err"] for c in cases),
            "equal": all(c["err"] == 0 for c in cases),
            "telemetry_ring": True,
            "ms": lead["ms"], "ms_ring_off": lead.get("ms_ring_off"),
            "plain_ms": lead["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
            "cases": [{k: c[k] for k in ("label", "shape", "err", "ms",
                                         "ms_ring_off", "plain_ms",
                                         "one_sm_floor_ms", "host_ms",
                                         "kernels_per_iteration", "sweeps",
                                         "plan", "solve_ms",
                                         "solve_ms_ring_off", "host_reads")
                       if k in c}
                      | {"bound_ms": max(c["bytes"] / HBM_BYTES_PER_S,
                                         c["ops"] / INT32_OPS_PER_S) * 1e3}
                      for c in cases],
        }

    return {"kernels": [
        row("fused_ladder", "poseidon_tpu_torch/ops/csrc/fused_ladder.cu",
            "poseidon_tpu/ops/transport_fused.py:113",
            "one kernel launch: a whole epsilon ladder", fused,
            "fused_ladder"),
        row("tiled_iteration",
            "poseidon_tpu_torch/ops/csrc/tiled_iteration.cu",
            "poseidon_tpu/ops/transport_tiled.py:73",
            "one push/relabel iteration: a sequence of three CUDA kernels",
            tiled, "tiled_iteration"),
        row("global_update",
            "poseidon_tpu_torch/ops/csrc/global_update.cu",
            "poseidon_tpu/ops/transport.py:548",
            "one cooperative launch: a whole global update", gu,
            "global_update"),
    ]}


# --------------------------------------------------------------- main

def compare(runs: int, ring_turns: bool = False) -> int:
    """``--compare N``: one B2 iteration's device time at each B2 kernel
    case (``_time_b2``), then N fresh-wave drives with the kernels (no
    churn, no plain run), each printed as a JSON line with B2's route
    split; run in two trees in turn to compare them in one call.
    ``--compare N ring`` turns the telemetry ring on and off between the
    drives (on, off, off, on, ...), to compare the two in one process."""
    from poseidon_tpu_torch.ops.transport_tiled import TiledIteration
    from poseidon_tpu_torch.utils import stagetimer

    info = device_info()
    build_kernels()
    times = {}
    for label, big, vec, scale in kernel_cases()[1]:
        ms, host_ms = _time_b2(TiledIteration(), *_b2_start(big, vec, scale))
        times[label] = {"shape": list(big.shape[1:]), "ms": ms,
                        "host_ms": host_ms}
    print(json.dumps({"b2_times": times, "smi": info["smi"]}), flush=True)
    # Warm-up: a small solve through each kernel route loads every kernel
    # and torch op the wave's routes use, so the first drive is not
    # charged for first use.
    inst = _instance(16, 1024, SEED, supply_lo=40, supply_hi=120, cap_lo=1,
                     cap_hi=6)
    for impl in ("fused", "tiled"):
        _run_route(*_pack(*inst), impl)
    stagetimer.set_device_timing(True)
    nodes, tasks = _population()
    ckpt = load_cluster("population", nodes, tasks)
    for i in range(runs):
        ring = not ring_turns or i % 4 in (0, 3)
        _set_telemetry(ring)
        rec = drive("wave", ckpt, tasks, 0)[0]
        print(json.dumps({"route_split": rec["split"],
                          "solve_device_s": rec["stages"].get("solve.device"),
                          "telemetry": ring, "wall_s": rec["wall_s"],
                          "smi": info["smi"]}), flush=True)
    _set_telemetry(True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--compare"]:
        return compare(int(argv[1]), argv[2:3] == ["ring"])
    info = device_info()
    build_kernels()
    fused, tiled, gu, l2_rate = kernel_phase()
    capture = []
    results, launches, ring_cost = main_path(capture)
    # The kernels at the main path's own wave shapes (after the path's
    # launches were read, so these comparisons are not counted).
    cases = main_path_cases(capture)
    del capture
    if "fused" in cases:
        log("kernels: B1 at the main path's wave shape")
        fused += check_fused([cases["fused"]], l2_rate)
    if "tiled" in cases:
        log("kernels: B2 at the main path's wave shape")
        tiled += check_tiled([cases["tiled"]])
    # Output check: the wave placed pods and every round certified (the
    # drive fails otherwise); the churn rounds re-placed the churned pods.
    wave = results["tiers_on"]
    if wave[0]["placed"] <= 0:
        fail("the fresh wave placed nothing")
    # What the ring costs, as measured in this run.
    cost = {"card": info["smi"], "wave_on_off": ring_cost}
    for name, rows in (("b1", fused), ("b2_iteration", tiled)):
        cost[name] = {f"{r['label']} {r['shape']}": [r["ms"], r["ms_ring_off"]]
                      for r in rows}
    cost["b2_route_solve"] = {f"{r['label']} {r['shape']}":
                              [r["solve_ms"], r["solve_ms_ring_off"]]
                              for r in tiled}
    log("ring cost, ms or s with the ring on / off: " + json.dumps(cost))
    print(info["smi"], flush=True)
    print(json.dumps(kernels_record(fused, tiled, gu, launches)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

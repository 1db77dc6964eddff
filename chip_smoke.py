#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``poseidon_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: the five CUDA sources built with ``nvcc`` from ``ops/csrc``
   (one process each, all started together), their ``-Xptxas -v``
   register and spill reports, B1's shared-memory size checked against
   its Python mirror, and the native graph core built with ``g++``;
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
   each input read once; the coarse program's disaggregation kernel
   (F0 and fb0) at the wave's [128, 256 x 40], a ragged plane, a
   pinned-scale reduced plane, B = 256, many tied costs and B = 33, with
   its bound counted from what the function needs on this data (the
   costs and arcs of the members of the pairs with flow, F0 written
   once; member updates and a comparison sort's count); and the whole
   coarse-to-fine program (B5) on a seeded [128, 10240] wave instance
   against the plain pipeline forced, every field of the solution equal;
   the chained wave's greedy-rows kernel (B7's scan) against its plain
   loop, bit-equal, on seeded [128, 256] and [32, 128] instances, one with
   cost ties and one where the capacity runs out partway through rows,
   timed by device time beside its bound; and the whole chained two-band
   program (B7) on a seeded [128 + 32, 10240] wave against itself with
   the plain versions forced: both bands' flows, the stat vector with the
   committed deltas, band 2's cost plane and both certified solutions
   bit-equal;
4. main path: the port's gRPC server answers ``Schedule()`` for a
   10,000-machine / 100,000-pod cluster (one fresh wave, three churn
   rounds) with the planner tiers, the convergence telemetry, the fused
   coarse program and the native graph core at their defaults (pruned
   planes with the certificate cache, delta-maintained cost planes,
   cross-band pipelining, overlapped assignment; the ring on), each
   drive's server running its precompile at the live cluster's machine
   bucket before the first round (the plain-forced drive none); every
   round must certify and logs its tier and telemetry counts, each
   device solve's route and padded shape, what the coarse start did per
   band, its seam and host reads, and its stage split; the wave's band 1
   must run the fused program with one seam read, and every drive's
   server must have the native core loaded (but the one that turns it
   off); the same script with the plain versions forced (plain ladders
   and plain scan) must produce byte-identical deltas and equal counts;
   one fresh wave with ``POSEIDON_COARSE_FUSED=0`` (the host two-dispatch
   coarse start) must match the main wave's objective and placed count
   and write telemetry samples; that wave again with the telemetry off
   must produce the same deltas and host reads, and its device time is
   printed beside the ring-on wave's; one wave and one churn round with
   the native core off must produce the main drive's deltas; then the
   dense path (the tiers off: the wave and one churn round) with the
   kernels, whose wave must match the main path's objective and placed
   count (plus a contended wave if no path reached the per-iteration
   kernel).  Each path's kernel launches are counted separately; every
   kernel of a route a path took must have launched in it (the
   disaggregation kernel wherever the fused program ran), and every
   kernel in some path; B2's route on the wave must run the
   global-update kernel with no host read and at most 3 CUDA kernels per
   iteration, and its split by stage is printed; then the chained drive
   (``POSEIDON_CHAINED=1``, a server restored from the same checkpoint):
   the wave must run the chained program in one device call, certify,
   place every pod and give the deltas of its plain-forced run byte for
   byte (the greedy rows' plain loop swapped in, as the scan's is); its
   objective is printed beside the per-band wave's, one churn round runs
   on its warm frames, and the server's device-memory gauges (in use and
   limit) must read nonzero after the wave;
5. the kernels again at the main path's own wave solves (the captured
   operands of its widest B2 solve, of its first disaggregation and of
   the chained wave's band-2 greedy rows), against their plain versions,
   after the path's launches were read; then one ``POSEIDON_JAX_PROFILE``
   window around a 200-machine round on the card must write its
   torch.profiler trace under build/chip_smoke/profile;
6. the device-resident operand cache: a seeded [128, 10240] instance
   through ``solve_transport`` (cold, five warm re-solves after 1% of the
   columns' capacities and costs change, one past the cache's wholesale
   gate, then five more padded shapes for its LRU of four), with
   ``POSEIDON_RESIDENT`` at its default and off: every solution field
   equal, fewer bytes uploaded per warm solve with the cache on, the
   resident tensors equal to their host copies; per solve the bytes
   uploaded, ``solve.upload``'s host and device time and ``solve.device``;
   before it, the mesh-sharded solve (B6) on logical shards of the card
   (a mesh listing ``cuda:0`` k times): ``make_solver_mesh(2)`` on this
   machine is the one-device solve, and the tier gate finds no mesh of
   the card's own; the contended cluster (``_contended``: 10,000
   machines of 8 slots, 48,000 pods in 24 shapes) with the sharded tier
   off (``POSEIDON_COARSE_FUSED=0``), then on (``POSEIDON_SHARDED_BANDS=1``
   with a mesh of 4 logical shards swapped into the planner) with
   contiguous shards (deltas byte-identical to the tier-off drive's, the
   wave's tier ``sharded`` on 4 shards) and strided (the same objective
   and placed count), each a wave and one churn round; then k = 2, 4, 8
   shards on that drive's band and on the main path's wave band
   ([32, 10240] and [128, 10240]): contiguous every field bit-equal to
   the one-device solve with the kernels, with the plain ladder's host
   reads, strided the same objective, certified; each timed by host
   clock beside the one-device solves and the ladder's bound;
7. the glue drive: a FakeKube holding the main path's cluster shapes at
   a quarter of its size (2,500 nodes, 25,000 pods) brought in by the
   port's watchers through its
   client to its server on the card, the checkpoint saved, then the wave
   and three churn rounds (1% of the pods deleted and recreated), each
   ``schedule_once()``: every round certifies and binds every pod, and
   FakeKube's bindings equal the scheduler's view; the glue's and the
   server's ``/metrics`` carry the loop and round series; a
   ``MetricsAgent`` push lands; then a server restored from the glue's
   checkpoint drives the wave directly with byte-identical deltas;
8. the harness phases: ``replay`` (BASELINE config 5, the reference's
   trace replay at 10,000 machines, 12,500 jobs and 5 rounds, with the
   kernels and with the plain versions forced: every round certified,
   each round's deltas byte-identical, ``summary()`` equal but for its
   time fields), ``pressure`` (the reference's pressure replay, 2,500
   machines with 10% removed mid-trace and the whole workload
   re-entering every round, 20 rounds, the first 8 against a
   plain-forced run; then the same trace with twice the jobs, which must
   preempt and migrate), ``soak`` (the chaos soak's smoke plan at 200
   machines through the full stack on the card, every gate passed with
   the ledger quartet at 0 in warm rounds, then rerun to the same
   digests, then run with the host certificate off, which answers its
   solves at this size, so that they run on the card: same gates, same
   digests; before it one CUDA ``.item()`` must count one implicit
   transfer) and ``scenario`` (the five named scenarios at 200 machines,
   synchronous, streaming and with the host certificate off, all with
   equal digests, each scored above 0); each checks its server's
   device, and counts each round's kernel launches apart from its
   servers' precompile (the drives with the certificate off must solve
   on the card and launch every kernel of the routes they took).

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  ``--compare N`` prints,
as JSON lines, one B2 iteration's device time at each B2 kernel case and
then each round of N drives (a fresh wave and one churn round, no plain
run) with its stages and the per-iteration route's split; run in two
trees in turn, it compares them in one call.  ``--compare N ring`` (or
``coarse``, ``native``) turns the telemetry ring (the fused coarse
program, the native graph core) on and off between the drives (on, off,
off, on, ...).  ``--compare N disagg [SEAM]`` times the disaggregation
kernel alone: its first launch in the process, then its cases (and the
wave seam a full run saves under ``build/chip_smoke/``) N times; a copy
of this script in an earlier tree's root times that tree's kernel.
``--phases replay,pressure,soak,scenario`` (any subset) runs those
phases alone, with no kernel comparison and no result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

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
               "pipeline_overlap_s", "sharded_bands", "shard_devices",
               "shard_imbalance")
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
# The global update's and the greedy rows' times under their previous
# designs (the global update: 320 blocks of 256 threads at [128, 10240], one
# grid barrier per sweep plus two; the greedy rows: one block walking the
# rows with three __syncthreads each): the means of the two turns of
# ``compare_trees.py`` on a tree of that design, in the same call as the
# new kernels' turns, on NVIDIA H100 80GB HBM3 at 700.00 W.  Printed
# beside each case's time, never in the record.
PREVIOUS_GU_MS = {
    "cold phase 1 bf_max 64 (applied)": 0.0804,
    "cold phase 0 bf_max 64 (refused)": 0.0796,
    "cold phase 0 bf_max 0 (unconverged)": 0.0444,
    "cold phase 1 bf_max 0 (unconverged)": 0.0454,
    "cold phase 0 at eps 2^27 bf_max 64 (refused)": 0.0794,
    "cold phase 0 at eps 2^27 bf_max 0 (unconverged)": 0.0444,
    "edge phase 1 bf_max 64 (applied)": 0.1153,
    "edge phase 0 bf_max 64 (refused)": 0.1154,
    "edge phase 0 bf_max 0 (unconverged)": 0.0655,
    "edge phase 1 bf_max 0 (unconverged)": 0.0655,
    "edge phase 0 at eps 2^27 bf_max 64 (refused)": 0.1150,
    "edge phase 0 at eps 2^27 bf_max 0 (unconverged)": 0.0652,
    "wide phase 1 bf_max 64 (applied)": 0.1975,
    "wide phase 0 bf_max 64 (refused)": 0.1971,
    "wide phase 0 bf_max 0 (unconverged)": 0.1209,
    "wide phase 1 bf_max 0 (unconverged)": 0.1219,
    "wide phase 0 at eps 2^27 bf_max 64 (refused)": 0.1962,
    "wide phase 0 at eps 2^27 bf_max 0 (unconverged)": 0.1211,
}
PREVIOUS_GREEDY_MS = {"seeded [128, 256]": 0.1032, "seeded [32, 128]": 0.0259,
                      "ties [32, 256]": 0.0273,
                      "capacity out mid-row [32, 256]": 0.0274}
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
    from poseidon_tpu_torch.native import bindings
    from poseidon_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.lib()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    t0 = time.perf_counter()
    if not bindings.native_available():
        fail(f"the native graph core did not build: {bindings.native_error()}")
    log(f"  native graph core: {time.perf_counter() - t0:.2f} s (g++ "
        f"{' '.join(bindings.GXX_FLAGS)}) -> {bindings.library_path().name}")
    for src in _kernels._SOURCES:
        for line in _kernels.ptxas_report(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    check_smem()
    return secs


def check_smem() -> None:
    """B1 sizes its dynamic shared memory in C at launch; the Python
    mirror that the CPU tests hold to the route's gate must agree with it
    at every E the gate admits.  The disaggregation kernel's shared
    memory, read against the card's opt-in limit, is logged."""
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
    # The cluster path: its size a CTA at every shape the gate sends it,
    # kernel against mirror, and a cluster of each size it takes must fit
    # the card.
    from poseidon_tpu_torch.ops import transport as T

    m_pads = sorted({T.bucket_size(n) for n in range(1, 41_000)})
    routed = {}
    for e in (8 << k for k in range(10)):
        for m in m_pads:
            k = TF.ladder_ctas(e, m) if TF.fits_vmem(e, m) else 1
            if k == 1:
                continue
            c_bytes = so.pt_fused_ladder_cluster_smem_bytes(e, m, k)
            if c_bytes != TF.cluster_smem_bytes(e, m, k):
                fail(f"B1 cluster shared memory at [{e}, {m}] over {k} "
                     f"CTAs: kernel {c_bytes} bytes, mirror "
                     f"{TF.cluster_smem_bytes(e, m, k)}")
            routed[(e, m)] = (k, c_bytes)
    for k in sorted({k for k, _ in routed.values()}):
        e, m = max((em for em, v in routed.items() if v[0] == k),
                   key=lambda em: routed[em][1])
        n = so.pt_fused_ladder_max_clusters(e, m, k)
        if n < 1:
            fail(f"no cluster of {k} CTAs fits the card at [{e}, {m}]")
        log(f"  B1 cluster path: {k} CTAs at "
            f"{sum(v[0] == k for v in routed.values())} shapes, up to "
            f"{routed[(e, m)][1]} bytes a CTA at [{e}, {m}] ({n} such "
            "clusters fit the card); kernel and mirror agree")
    # The column cluster likewise, at every shape its gate takes.
    slabbed = {}
    for e in (8 << k for k in range(10)):
        for m in m_pads:
            if not TF.fits_vmem(e, m) or TF.ladder_ctas(e, m) > 1:
                continue
            k = TF.ladder_slab_ctas(e, m)
            if k == 1:
                continue
            c_bytes = so.pt_fused_ladder_columns_smem_bytes(e, m, k)
            if c_bytes != TF.slab_smem_bytes(e, m, k):
                fail(f"B1 column cluster shared memory at [{e}, {m}] over "
                     f"{k} CTAs: kernel {c_bytes} bytes, mirror "
                     f"{TF.slab_smem_bytes(e, m, k)}")
            slabbed[(e, m)] = (k, c_bytes)
    for k in sorted({k for k, _ in slabbed.values()}):
        e, m = max((em for em, v in slabbed.items() if v[0] == k),
                   key=lambda em: slabbed[em][1])
        n = so.pt_fused_ladder_columns_max_clusters(e, m, k)
        if n < 1:
            fail(f"no column cluster of {k} CTAs fits the card at [{e}, {m}]")
        log(f"  B1 column cluster: {k} CTAs at "
            f"{sum(v[0] == k for v in slabbed.values())} shapes, up to "
            f"{slabbed[(e, m)][1]} bytes a CTA at [{e}, {m}] ({n} such "
            "clusters fit the card); kernel and mirror agree")
    from poseidon_tpu_torch.ops import transport_coarse as TC

    top = TC.MAX_BLOCK
    if so.pt_coarse_disaggregate_smem_bytes(top) == 0:
        fail(f"the disaggregation kernel cannot take B = {top}, the "
             "wrapper's limit, on this card")
    log("  disaggregation shared memory: " + ", ".join(
        f"B = {b}: {so.pt_coarse_disaggregate_smem_bytes(b)} bytes"
        for b in (1, 40, 256, 257, top)) + f"; the wrapper takes B up to "
        f"{top}")


# One block streaming a buffer from L2 (16-byte loads that bypass L1):
# the rate one SM can read L2 at, which floors a one-block kernel; and an
# empty kernel, whose launch floors any kernel.
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
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
_PROBES = []


def _probe_lib():
    """The probes' library (the L2 stream and the empty kernel), built
    once per process."""
    import ctypes

    from poseidon_tpu_torch.ops import _kernels

    if not _PROBES:
        out_dir = _kernels.build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / "l2_probe.cu"
        src.write_text(_L2_PROBE_SRC)
        so = out_dir / "l2_probe.so"
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-o", str(so), str(src)], check=True, timeout=300)
        lib = ctypes.CDLL(str(so))
        lib.l2_probe.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.l2_probe.restype = lib.empty_launch.restype = ctypes.c_int
        _PROBES.append(lib)
    return _PROBES[0]


def empty_launch_ms(reps) -> float:
    """Device milliseconds of an empty one-warp kernel on the current
    stream, by ``_time_device`` over ``reps`` launches."""
    if DEVICE.type != "cuda":
        return 0.0
    fn = _probe_lib().empty_launch
    stream = torch.cuda.current_stream(DEVICE).cuda_stream

    def run():
        if fn(stream):
            fail("the empty kernel did not launch")

    return _time_device(run, reps)[0]


def one_sm_l2_rate() -> float:
    """Bytes per second that one 1024-thread block reads from L2, over a
    512 KB buffer (C, Uem, F and P at [128, 256])."""
    fn = _probe_lib().l2_probe
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
    counts each input read once and each output written once.  Where the
    gate sends the shape to the cluster path, the one-SM kernel runs it
    too: both bit-equal to the plain ladder, both timed, and the cluster
    path's floor (the operations at its k SMs' share of the int32 rate)
    beside the one-SM floor."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    rows = []
    for label, big, vec, scale in cases:
        E, M = big.shape[1:]
        ctas = TF.ladder_ctas(E, M) if TF.fits_vmem(E, M) else 1
        counter, path, barriers = ("fused_ladder_cluster", "row cluster",
                                   TF.CLUSTER_BARRIERS)
        if ctas == 1 and TF.fits_vmem(E, M):
            ctas = TF.ladder_slab_ctas(E, M)
            counter, path, barriers = ("fused_ladder_columns",
                                       "column cluster", TF.SLAB_BARRIERS)
        one_sm = None
        if ctas > 1:
            with _b1_path(1):
                one_sm = _ring_checks(label, big, vec, scale, "fused")
        n0 = _kernels_launches(counter)
        err, ms, ms_off, reads, Fk, sk = _ring_checks(label, big, vec,
                                                      scale, "fused")
        if ctas > 1 and _kernels_launches(counter) == n0:
            fail(f"B1 {label}: the gate sent [{E}, {M}] to a cluster path "
                 f"but no launch was counted in {counter}")
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
        row = dict(shape=[E, M], label=label, err=err, iters=iters,
                   bf=bf, ms=ms, ms_ring_off=ms_off, plain_ms=plain_ms,
                   bytes=nbytes, ops=ops, one_sm_floor_ms=floor_ms,
                   host_reads=reads, ctas=ctas)
        if one_sm is not None:
            err1, ms1, ms1_off, reads1, F1, s1 = one_sm
            cluster_floor_ms = ops / (ctas * INT32_OPS_PER_S / sms) * 1e3
            row.update(one_sm_err=err1, one_sm_ms=ms1,
                       one_sm_ms_ring_off=ms1_off, path=path,
                       cluster_floor_ms=cluster_floor_ms,
                       cluster_barriers=dict(barriers))
            log(f"  B1 {label} [{E}, {M}] one-SM kernel: max_abs_err "
                f"{err1} (ring included), {ms1:.3f} ms with the ring, "
                f"{ms1_off:.3f} without; {path} ({ctas} CTAs) "
                f"{ms:.3f} / {ms_off:.3f} ms, {ms1 / ms:.2f}x; cluster "
                f"floor {cluster_floor_ms:.3f} ms (int32 operations at "
                f"{ctas} SMs' share); cluster barriers {barriers}")
            if err1 != 0 or _max_err([F1, s1], [Fk, sk]) != 0:
                fail(f"B1's one-SM kernel and {path} differ at {label}")
            if reads1 != reads:
                fail(f"B1 {label}: {reads1} host reads on the one-SM "
                     f"kernel, {reads} on the {path}")
        rows.append(row)
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


@contextlib.contextmanager
def _b1_path(slab):
    """B1's gates pinned: the row cluster shut, the column cluster at
    ``slab`` CTAs (1: the one-SM kernel)."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    gates = TF.ladder_ctas, TF.ladder_slab_ctas
    TF.ladder_ctas = lambda e, m: 1
    TF.ladder_slab_ctas = lambda e, m: slab
    try:
        yield
    finally:
        TF.ladder_ctas, TF.ladder_slab_ctas = gates


def _b1_kernel_ms(fn, reps) -> float:
    """Device milliseconds of B1's launch per call of ``fn`` (a solve that
    launches B1 once): CUDA events around the wrapper's launch alone."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    real, events = TF.fused_ladder, []

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    fn()
    TF.fused_ladder = timed
    try:
        for _ in range(reps):
            fn()
    finally:
        TF.fused_ladder = real
    torch.cuda.synchronize()
    if len(events) != reps:
        fail(f"B1 timing: {len(events)} launches in {reps} solves")
    return sum(a.elapsed_time(b) for a, b in events) / reps


# The planes the row cluster leaves to the column cluster or the one-SM
# kernel: 8 rows (the backlog's band 1 pads its ~6 rows to 8) at the
# widths timed for the column cluster's crossover, of which the backlog
# runs [8, 256] and [8, 10240] every round; and taller planes whose row
# shares do not fit a CTA.
SKINNY_SHAPES = tuple((8, m) for m in (64, 128, 256, 512, 1024, 2048, 4096,
                                       10240)) + ((16, 5120), (32, 4096),
                                                  (64, 2048))
SKINNY_BACKLOG = ((8, 256), (8, 10240))
# A full run's planes: the backlog's two and one taller plane, each the
# column gate routes, checked for bit-equality alone (``--b1`` times them
# all).
SKINNY_ROUTED = SKINNY_BACKLOG + ((32, 4096),)
SKINNY_SMS = 16


def check_skinny(shapes=SKINNY_SHAPES, timed=True) -> list:
    """B1 on the planes the row cluster leaves, each path forced in turn
    on one seeded instance a shape: the one-SM kernel and the column
    cluster at each size whose slabs fit.  Each bit-equal to the plain
    ladder with the ring (the column cluster also without it).  With
    ``timed``, each path is timed (B1's launch on the card by CUDA events,
    and the whole solve) and, at the backlog's two shapes, B2's tiled
    route too for reference.  The bound: the int32 operations at
    ``SKINNY_SMS`` SMs' share of the card's rate."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    rows = []
    for E, M in shapes:
        inst = _instance(E, M, SEED + 7, supply_lo=500, supply_hi=1500,
                         cap_lo=1, cap_hi=12)
        big, vec, scale = _pack(*inst)
        Fp, sp = _run_route(big, vec, scale, "lax")
        o = E + E + M + 1
        iters, bf = int(sp[o]), int(sp[o + 1])
        ops = E * M * (OPS_PER_CELL_ITER * iters + OPS_PER_CELL_BF * bf
                       + OPS_PER_CELL_PHASE * NUM_PHASES)
        row = dict(shape=[E, M], iters=iters, bf=bf, ops=ops,
                   gate=TF.ladder_slab_ctas(E, M),
                   bound_ms=ops / (SKINNY_SMS * INT32_OPS_PER_S / sms) * 1e3,
                   paths={})
        paths = [("one_sm", 1)] + [
            (f"columns_{k}", k) for k in TF.CLUSTER_CTAS
            if TF.slab_smem_bytes(E, M, k) <= TF.SMEM_LIMIT]
        reps = 3 if E * M >= 32768 else 10
        for name, k in paths:
            with _b1_path(k):
                n0 = _kernels_launches("fused_ladder_columns")
                F, sk = _run_route(big, vec, scale, "fused")
                if _kernels_launches("fused_ladder_columns") - n0 != (k > 1):
                    fail(f"B1 [{E}, {M}] {name}: the column counter moved "
                         f"{_kernels_launches('fused_ladder_columns') - n0}")
                err = _max_err([F, sk], [Fp, sp])
                if k > 1:
                    Fo, so = _run_route(big, vec, scale, "fused", telem_cap=0)
                    err = max(err, _max_err([Fo, so], [F, sk[:so.size]]))
                def run():
                    return _run_route(big, vec, scale, "fused")

                row["paths"][name] = dict(
                    err=err,
                    kernel_ms=_b1_kernel_ms(run, reps) if timed else None,
                    solve_ms=_time_cuda(run, reps) if timed else None)
            if err != 0:
                fail(f"B1 [{E}, {M}] {name} differs from the plain ladder")
        if timed and (E, M) in SKINNY_BACKLOG:
            Ft, st = _run_route(big, vec, scale, "tiled")
            row["paths"]["tiled"] = dict(
                err=_max_err([Ft, st], [Fp, sp]), kernel_ms=None,
                solve_ms=_time_cuda(
                    lambda: _run_route(big, vec, scale, "tiled"), reps))
            if row["paths"]["tiled"]["err"] != 0:
                fail(f"B2 [{E}, {M}] differs from the plain ladder")
        one = row["paths"]["one_sm"]["kernel_ms"]
        log(f"  B1 [{E}, {M}]: iters {iters}, bf {bf}, gate "
            f"{row['gate']} CTAs, bound {row['bound_ms']:.4f} ms at "
            f"{SKINNY_SMS} SMs; " + "; ".join(
                f"{n} err {v['err']}" + ("" if not timed else " kernel "
                + ("-" if v["kernel_ms"] is None else
                   f"{v['kernel_ms']:.3f} ms ({one / v['kernel_ms']:.2f}x)")
                + f" solve {v['solve_ms']:.3f} ms")
                for n, v in row["paths"].items()))
        rows.append(row)
    return rows


def _kernels_launches(name) -> int:
    from poseidon_tpu_torch.ops import _kernels

    return _kernels.LAUNCHES[name]


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
    on the device; the kernel must make no host read and run at most one
    grid barrier per two sweeps.  Each case records its launch plan
    (blocks, length planes in shared memory or not, columns a block owns)
    and its barriers; each state, its fixed cost and cost per sweep from
    its bf_max 0 and bf_max 64 rows."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops.transport_tiled import (
        GlobalUpdate,
        global_update_plan,
    )

    rows = []
    for label, big, vec, scale in cases:
        E, M = big.shape[1:]
        plan = (list(global_update_plan(E, M)) if DEVICE.type == "cuda"
                else None)
        ops, states = _mid_solve_states(big, vec, scale)
        gu_ops = {k: ops[k] for k in ("C", "U", "Uem", "supply", "cap",
                                      "adm")}
        exits = {}
        for where, eps, s in states:
            exc = T._excesses(*s[:3], supply=ops["supply"],
                              total=ops["total"])
            full_sweeps = None
            by_bf = {}
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
                barriers = step.barriers()  # of this one update
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
                           ops=ops_n, plan=plan, barriers=barriers)
                rows.append(row)
                exits.setdefault(kind, row)
                by_bf[bf_max] = row
                bound = max(nbytes / HBM_BYTES_PER_S,
                            ops_n / INT32_OPS_PER_S) * 1e3
                prev = PREVIOUS_GU_MS.get(row["label"])
                log(f"  global update {row['label']} [{E}, {M}] eps {eps}: "
                    f"max_abs_err {err}, sweeps {sweeps}, grid barriers "
                    f"{barriers}, kernel {ms:.4f} ms ({ms / sweeps:.5f} ms "
                    f"per sweep; host enqueue {host_ms:.4f} ms, host reads "
                    f"{reads}; plan {plan}), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.5f} ms ({ms / bound:.1f}x)"
                    + (f"; previous design {prev:.4f} ms" if prev else ""))
                if err != 0:
                    fail(f"global update differs from its plain version at "
                         f"{row['label']}")
                if reads != 0 and DEVICE.type == "cuda":
                    fail(f"global update made {reads} host reads")
                if DEVICE.type == "cuda" and barriers > max(sweeps // 2, 1):
                    fail(f"global update ran {barriers} grid barriers for "
                         f"{sweeps} sweeps at {row['label']}")
            # The update's fixed cost and its cost per sweep, from the two
            # cut-offs on the same state.
            full, cut = by_bf[64], by_bf[0]
            if full["sweeps"] > cut["sweeps"]:
                per = (full["ms"] - cut["ms"]) / (full["sweeps"]
                                                  - cut["sweeps"])
                fixed = cut["ms"] - per * cut["sweeps"]
                full["split"] = cut["split"] = {"fixed_ms": fixed,
                                                "per_sweep_ms": per}
                log(f"  global update {label} {where} [{E}, {M}]: fixed "
                    f"{fixed:.4f} ms + {per:.5f} ms per sweep (bf_max 0 and "
                    f"64 on the same state)")
        missing = {"applied", "refused", "unconverged"} - set(exits)
        if missing:
            fail(f"global update at {label}: exits {sorted(missing)} not "
                 "covered")
    # The record's lead case: an applied update at the wave's shape.
    rows.sort(key=lambda r: r["exit"] != "applied")
    return rows


def kernel_cases():
    """B1 at the wave's coarse shape, the churn width at the gate's edge,
    a contended instance, the gate's two extremes (fewest ECs at the
    widest plane, most ECs at the narrowest) and the burst's second band
    [32, 2560]; B2 at the wave's padded
    width, cold and warm, at the gate's edge, and ragged (the wave's size
    unpadded, E and M not multiples of B2's tiles).  The global update
    runs on the cold and edge cases' mid-solve states, and on those of a
    wider band, [256, 16384], past the width at which a block holds both
    length planes of its columns in shared memory (the workspace plan)."""
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
        ("band 2", (32, 2560), dict(supply_lo=500, supply_hi=1500,
                                    cap_lo=1, cap_hi=12)),
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


# The int32 operations the disaggregation's function needs for each
# (row, group) pair with coarse flow, whatever algorithm computes it: per
# member, its key and caps (a compare, two selects, a min), its take (a
# subtract, a min, a max), the capacity update and its share of the scan
# (an add each way); and the stable ordering of the B members, B *
# ceil(log2 B) comparisons (a comparison sort's count).  The kernel's own
# O(B^2) rank is its choice, not the function's need, so it is not
# counted.
OPS_PER_MEMBER_DISAGG = 10


def disagg_ops(pairs: int, B: int) -> int:
    return pairs * B * (OPS_PER_MEMBER_DISAGG + max(B - 1, 0).bit_length())


def _disagg_case(E, K, B, seed, *, m_live=None, ties=False, inadm=0.1,
                 fc_hi=60, fc_zero=0.6, cost_hi=1000):
    """One disaggregation input at [E, K * B]: a padded plane (dead
    columns past ``m_live``: INF cost, zero capacity) with costs below
    ``cost_hi`` (4 with ``ties``), its column sort as the program computes
    it, and a coarse flow of the given sparsity."""
    from poseidon_tpu_torch.ops import transport as T

    rng = np.random.default_rng(seed)
    M2 = K * B
    m_live = M2 if m_live is None else m_live
    costs = np.full((E, M2), T.INF_COST, dtype=np.int32)
    costs[:, :m_live] = rng.integers(0, 4 if ties else cost_hi,
                                     size=(E, m_live))
    live = costs[:, :m_live]
    live[rng.random((E, m_live)) < inadm] = T.INF_COST
    arc = np.zeros((E, M2), dtype=np.int32)
    arc[:, :m_live] = rng.integers(1, 64, size=(E, m_live))
    cap = np.zeros(M2, dtype=np.int32)
    cap[:m_live] = rng.integers(1, 12, size=m_live)
    Fc = rng.integers(0, fc_hi, size=(E, K)).astype(np.int32)
    Fc[rng.random((E, K)) < fc_zero] = 0
    perm = T.coarse_sort_order(costs).astype(np.int32)
    return dict(costs=costs, arc=arc, cap=cap, Fc=Fc, perm=perm,
                inv_perm=np.argsort(perm).astype(np.int32),
                supply=(Fc.sum(1) + rng.integers(0, 50, size=E)).astype(
                    np.int32), K=K, B=B)


DISAGG_OPERANDS = ("costs", "arc", "cap", "Fc", "perm", "inv_perm", "supply")


def _disagg_args(d):
    return tuple(torch.from_numpy(np.ascontiguousarray(d[k])).to(DEVICE)
                 for k in DISAGG_OPERANDS)


def disagg_cases():
    """The wave's [128, 256 x 40]; a ragged plane (10,000 live columns in
    200 groups of 52: M2 = 10,400 past the padded 10,240); a pinned-scale
    reduced plane [32, 2560]; B = 256 at [64, 65536]; many tied costs
    with 30% inadmissible members; B = 33, one past a warp, at the wave's
    [128, 256 x 33]; the wave's shape with costs past 2^23."""
    return [
        ("wave", _disagg_case(128, 256, 40, SEED)),
        ("ragged", _disagg_case(100, 200, 52, SEED + 1, m_live=10_000)),
        ("pruned plane", _disagg_case(32, 256, 10, SEED + 2)),
        ("B=256", _disagg_case(64, 256, 256, SEED + 3, fc_hi=400)),
        ("ties", _disagg_case(128, 256, 40, SEED + 4, ties=True, inadm=0.3)),
        ("B=33", _disagg_case(128, 256, 33, SEED + 6)),
        ("wide costs", _disagg_case(128, 256, 40, SEED + 7,
                                    cost_hi=1 << 27)),
    ]


def check_coarse_disaggregate(cases) -> list:
    """The disaggregation kernel against the plain scan on the card: F0
    and fb0 bit-equal, timed with CUDA events beside the plain scan and
    the bound; the kernel's time is the device's (``_time_device``: a
    call's host work, some 0.05 ms, exceeds the kernel's, so events around
    back-to-back calls would time the host), its host time per call
    beside it.  The bytes are what this data needs: the costs and arcs of
    the members of each (row, group) pair with coarse flow, cap and perm,
    Fc and the supply read once, F0 and fb0 written once; the operations
    are the member updates and a comparison sort's B * ceil(log2 B)
    comparisons for each such pair (``disagg_ops``)."""
    from poseidon_tpu_torch.ops import transport_coarse as TC

    rows = []
    for label, d in cases:
        args = _disagg_args(d)
        kw = dict(groups=d["K"], block=d["B"])
        a = TC.coarse_disaggregate(*args, **kw)
        b = TC.disaggregate_plain(*args, **kw)
        err = _max_err([x.cpu().numpy() for x in a],
                       [x.cpu().numpy() for x in b])
        ms, host_ms = _time_device(
            lambda: TC.coarse_disaggregate(*args, **kw), 20)
        plain_ms = _time_cuda(lambda: TC.disaggregate_plain(*args, **kw), 1)
        E, M2 = d["costs"].shape
        K, B = d["K"], d["B"]
        pairs = int((d["Fc"] > 0).sum())
        nbytes = 4 * (2 * pairs * B + 2 * M2 + E * K + E + E * M2 + E)
        ops = disagg_ops(pairs, B)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        rows.append(dict(shape=[E, M2], label=f"{label} K {K} B {B}",
                         err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         bytes=nbytes, ops=ops, pairs=pairs))
        log(f"  disaggregation {label} [{E}, {K} x {B}]: max_abs_err {err} "
            f"(F0, fb0), {pairs} (row, group) pairs with flow; kernel "
            f"{ms:.4f} ms (host {host_ms:.4f} ms a call), plain "
            f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({ms / bound:.1f}x)")
        if err != 0:
            fail(f"the disaggregation kernel differs from the plain scan at "
                 f"{label}")
        if not bool(a[0].any()):
            fail(f"the disaggregation case {label} handed out no flow")
    return rows


def _coarse_instance():
    """A seeded contended [128, 10240] wave instance for the coarse
    program (supply past capacity, so the greedy start does not
    certify)."""
    return _instance(128, 10240, SEED + 5, supply_lo=500, supply_hi=1500,
                     cap_lo=4, cap_hi=12)


SOLUTION_FIELDS = ("objective", "gap_bound", "iterations", "bf_sweeps",
                   "phase_iters", "entry_phase", "eps_certified")


# Bindings the plain and native-off drives replace, as the process found
# them (``_swap(owner, name, None)`` puts one back).
_ORIGINALS = {}


def _swap(owner, name, value) -> None:
    """Bind ``owner.name`` to ``value``, or with ``None`` back to what it
    was before its first swap."""
    _ORIGINALS.setdefault((owner, name), getattr(owner, name))
    setattr(owner, name, _ORIGINALS[(owner, name)] if value is None
            else value)


def _set_plain_pipeline(plain: bool) -> None:
    """The plain ladders, the plain disaggregation scan and the plain
    greedy rows forced, or every route at its default.  The ladders have
    their hatches; the scan and the greedy rows have none, so the
    programs' bindings of the kernels' wrappers are swapped for the plain
    versions (looked up at each call, so a spy on them sees the call)."""
    from poseidon_tpu_torch.ops import transport_chained as TCH
    from poseidon_tpu_torch.ops import transport_coarse as TC

    for k in ("POSEIDON_FUSED", "POSEIDON_TILED"):
        _set_env(k, "0" if plain else None)

    def plain_scan(*a, **k):
        return TC.disaggregate_plain(*a, **k)

    _swap(TC, "coarse_disaggregate", plain_scan if plain else None)
    _swap(TCH, "greedy_rows", TCH.greedy_rows_plain if plain else None)


def _set_native(on: bool) -> None:
    """``ClusterState`` at its default (the native graph core), or every
    state built while off with the reference's ``use_native=False``."""
    from poseidon_tpu_torch.graph.state import ClusterState

    init = _ORIGINALS.get((ClusterState, "__init__"), ClusterState.__init__)

    def python_view(self, use_native=True):
        init(self, use_native=False)

    _swap(ClusterState, "__init__", None if on else python_view)


def check_coarse_program() -> dict:
    """The whole coarse-to-fine program (B5) on the card against the
    plain pipeline forced (plain ladders, plain scan) on a seeded [128,
    10240] wave instance: every field of the solution bit-equal."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops import transport_coarse as TC

    costs, supply, cap, unsched, arc = _coarse_instance()
    out = {}
    for mode in ("kernels", "plain"):
        _set_plain_pipeline(mode == "plain")
        _kernels.reset_launches()
        routes0 = dict(T._Telemetry.routes)
        t0 = time.perf_counter()
        sol = TC.solve_transport_coarse_fused(
            costs, supply, cap, unsched, arc_capacity=arc,
            max_cost_hint=8000, max_iter_total=8192, device=DEVICE)
        secs = time.perf_counter() - t0
        if sol is None:
            fail(f"the coarse program declined the seeded wave ({mode})")
        routes = {f"{k[0]}[{k[1]}, {k[2]}]": n - routes0.get(k, 0)
                  for k, n in T._Telemetry.routes.items()
                  if n > routes0.get(k, 0)}
        out[mode] = dict(sol=sol, secs=secs, routes=routes,
                         launches=dict(_kernels.LAUNCHES))
    _set_plain_pipeline(False)
    k, p = out["kernels"], out["plain"]
    err = _max_err([k["sol"].flows, k["sol"].unsched, k["sol"].prices],
                   [p["sol"].flows, p["sol"].unsched, p["sol"].prices])
    diff = [f for f in SOLUTION_FIELDS
            if getattr(k["sol"], f) != getattr(p["sol"], f)]
    log(f"  B5 {list(costs.shape)}: kernels {k['secs']:.3f} s ({k['routes']}, "
        f"launches {k['launches']}), plain pipeline {p['secs']:.3f} s "
        f"({p['routes']}); iterations {k['sol'].iterations}, phase "
        f"{k['sol'].phase_iters}, gap {k['sol'].gap_bound}, max_abs_err "
        f"{err}, fields differing {diff}")
    if err or diff:
        fail("the coarse program differs from the plain pipeline")
    if k["sol"].gap_bound != 0.0:
        fail("the coarse program's solution is not certified")
    if not k["launches"]["coarse_disaggregate"] or any(p["launches"].values()):
        fail(f"launches: kernels {k['launches']}, plain {p['launches']}")
    return {"kernels_s": k["secs"], "plain_s": p["secs"],
            "iterations": k["sol"].iterations, "routes": k["routes"]}


# ----------------------------------------------------------- B7 (chained)

# int32 operations per [E, K] cell of the greedy rows, counted from
# csrc/greedy_seed.cu (the admissibility test, the offer's min, the take's
# subtract, min and max, the capacity update), plus a block scan's
# ceil(log2 K) adds per cell.
OPS_PER_CELL_GREEDY = 6


def _greedy_case(E, K, seed, *, ties=False, tight=False):
    """A band-2 coarse instance for the greedy rows at [E, K]: 10% of
    the cells inadmissible; ``ties`` draws the costs from four values;
    ``tight`` makes the column capacity run out partway through rows."""
    from poseidon_tpu_torch.ops import transport as T

    rng = np.random.default_rng(seed)
    C = rng.integers(0, 4 if ties else 900, size=(E, K)).astype(np.int32)
    C[rng.random((E, K)) < 0.1] = T.INF_COST
    return dict(C=C, arc=rng.integers(0, 40, size=(E, K)).astype(np.int32),
                cap=rng.integers(0, 4 if tight else 200,
                                 size=K).astype(np.int32),
                supply=rng.integers(0, 60, size=E).astype(np.int32))


GREEDY_OPERANDS = ("C", "arc", "cap", "supply")


def _greedy_args(d):
    """The wrapper's operands on the card, with the row order computed
    as the program computes it (a stable argsort, outside the kernel)."""
    from poseidon_tpu_torch.ops import transport as T

    t = [torch.from_numpy(np.ascontiguousarray(d[k])).to(DEVICE)
         for k in GREEDY_OPERANDS]
    order = torch.argsort(torch.where(t[0] < T.INF_COST, t[0], T.INF_COST),
                          dim=1, stable=True).to(torch.int32)
    return (*t, order)


def greedy_cases():
    """Seeded [128, 256] and [32, 128] instances, one with cost ties and
    one where the capacity runs out partway through rows."""
    return [
        ("seeded", _greedy_case(128, 256, SEED)),
        ("seeded", _greedy_case(32, 128, SEED + 1)),
        ("ties", _greedy_case(32, 256, SEED + 2, ties=True)),
        ("capacity out mid-row", _greedy_case(32, 256, SEED + 3,
                                              tight=True)),
    ]


def check_greedy_seed(cases) -> list:
    """The greedy-rows kernel against the plain row loop on the card, F0
    bit-equal, timed by device time (``_time_device``) beside the plain
    loop and the bound: C, the order and F0 read or written once per
    cell, the arc capacities of the admissible cells, the capacity and
    the supply; ``OPS_PER_CELL_GREEDY`` plus a scan's ceil(log2 K) adds
    per cell.  Beside the bound (far below one launch), an empty launch's
    device time in this process."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops import transport_chained as TCH

    rows = []
    # The floor no single launch beats: an empty kernel's device time on
    # the same stream, timed as the kernel is.
    floor_ms = empty_launch_ms(20)
    for label, d in cases:
        args = _greedy_args(d)
        a = TCH.greedy_rows(*args)
        b = TCH.greedy_rows_plain(*args)
        err = _max_err([a.cpu().numpy()], [b.cpu().numpy()])
        ms, host_ms = _time_device(lambda: TCH.greedy_rows(*args), 20)
        plain_ms = _time_cuda(lambda: TCH.greedy_rows_plain(*args), 1)
        E, K = d["C"].shape
        adm = int((d["C"] < T.INF_COST).sum())
        nbytes = 4 * (3 * E * K + adm + K + E)
        ops = E * K * (OPS_PER_CELL_GREEDY + max(K - 1, 0).bit_length())
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        F0 = a.cpu().numpy()
        short = int(((F0.sum(1) > 0) & (F0.sum(1) < d["supply"])).sum())
        rows.append(dict(shape=[E, K], label=label, err=err, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms, bytes=nbytes,
                         ops=ops, floor_ms=floor_ms))
        prev = PREVIOUS_GREEDY_MS.get(f"{label} {[E, K]}")
        log(f"  greedy rows {label} [{E}, {K}]: max_abs_err {err}, "
            f"{int(F0.sum())} units placed, {short} rows cut short by the "
            f"capacity; kernel {ms:.4f} ms (host {host_ms:.4f} ms a call), "
            f"plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
            f"({ms / bound:.1f}x), empty launch {floor_ms:.4f} ms"
            + (f"; previous design {prev:.4f} ms" if prev else ""))
        if err != 0:
            fail(f"the greedy-rows kernel differs from the plain loop at "
                 f"{label}")
        if label == "capacity out mid-row" and not short:
            fail("the capacity-bound greedy case cut no row short")
    return rows


def _chained_instance():
    """A seeded two-band wave at [100 + 20, 10000] (padded [128 + 32,
    10240]): band 1's planes and band 2's ``extract_band_operands``."""
    from poseidon_tpu_torch.costmodel.base import ECTable, MachineTable
    from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel
    from poseidon_tpu_torch.costmodel.device_build import (
        extract_band_operands,
    )
    from poseidon_tpu_torch.ops import transport as T

    rng = np.random.default_rng(SEED + 8)
    E1, E2, M = 100, 20, 10_000
    cpu_cap = rng.choice([16000, 32000, 64000], size=M).astype(np.int64)
    ram_cap = cpu_cap << 12
    mt = MachineTable(
        uuids=[f"c{m}" for m in range(M)], cpu_capacity=cpu_cap,
        ram_capacity=ram_cap,
        cpu_used=(cpu_cap * rng.random(M) * 0.3).astype(np.int64),
        ram_used=(ram_cap * rng.random(M) * 0.3).astype(np.int64),
        cpu_util=rng.random(M).astype(np.float32),
        mem_util=rng.random(M).astype(np.float32),
        slots_free=np.full(M, 8, dtype=np.int32),
        labels=[{} for _ in range(M)],
    )
    ec2 = ECTable(
        ec_ids=np.arange(E2, dtype=np.uint64),
        cpu_request=rng.integers(100, 600, size=E2).astype(np.int64),
        ram_request=rng.integers(1 << 18, 1 << 20, size=E2).astype(np.int64),
        supply=rng.integers(500, 2000, size=E2).astype(np.int32),
        priority=np.zeros(E2, dtype=np.int32),
        task_type=np.zeros(E2, dtype=np.int32),
        max_wait_rounds=np.zeros(E2, dtype=np.int32),
        selectors=[() for _ in range(E2)],
    )
    model = CpuMemCostModel()
    # Load-shaped band-1 costs (a row term plus a machine term), as a
    # cost model gives them.
    costs1 = (rng.integers(50, 800, size=E1)[:, None]
              + rng.integers(0, 400, size=M)[None, :]).astype(np.int32)
    costs1[rng.random((E1, M)) < 0.05] = T.INF_COST
    return dict(
        costs1=costs1,
        supply1=rng.integers(100, 300, size=E1).astype(np.int32),
        col_cap1=rng.integers(0, 4, size=M).astype(np.int32),
        unsched1=np.full(E1, 2000, dtype=np.int32),
        arc_cap1=rng.integers(1, 3, size=(E1, M)).astype(np.int32),
        req1_cpu=rng.integers(4000, 9000, size=E1).astype(np.int32),
        req1_ram=rng.integers(1 << 21, 1 << 22, size=E1).astype(np.int32),
        ops2=extract_band_operands(ec2, mt, model), supply2=ec2.supply,
        max_cost_hint=model.max_cost(),
    )


def _ladder_bounds(bounds: list):
    """A spy for the programs' ladders (``transport_coarse.solve_route``,
    which ``coarse_to_fine_band`` calls): appends the bound of each
    ladder's launches, from its shape, iterations, sweeps and global
    updates, counted as ``check_fused``, ``check_tiled`` and
    ``check_global_update`` count one launch (no ring).  It reads each
    ladder's stats, so it runs apart from the timed runs."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport_coarse as TC

    real = TC.solve_route

    def spy(impl, *args, **kw):
        gu0 = _kernels.LAUNCHES["global_update"]
        out = real(impl, *args, **kw)
        E, M = args[0].shape
        iters, bf = (int(x) for x in out[3][:2].cpu())
        if impl == "fused":
            nbytes = 4 * (4 * E * M + 6 * E + 5 * M + 15 + NUM_PHASES)
            ops = E * M * (OPS_PER_CELL_ITER * iters + OPS_PER_CELL_BF * bf
                           + OPS_PER_CELL_PHASE * NUM_PHASES)
        else:
            gu = _kernels.LAUNCHES["global_update"] - gu0
            nbytes = 4 * (4 * E * M * iters
                          + (3 * E * M + 6 * E + 5 * M + 5) * gu)
            ops = E * M * (OPS_PER_CELL_ITER * iters
                           + OPS_PER_CELL_GU_LENGTHS * gu
                           + OPS_PER_CELL_GU_SWEEP * bf)
        bounds.append(max(nbytes / HBM_BYTES_PER_S,
                          ops / INT32_OPS_PER_S) * 1e3)
        return out

    return spy


def check_chained_program() -> dict:
    """The whole chained program (B7) on the card against itself with the
    plain versions forced (plain ladders, plain scan, plain greedy rows)
    on a seeded [128 + 32, 10240] wave: both bands' flows, the stat
    vector (fallbacks, prices, iterations, sweeps, convergence bits,
    phase iterations and the three delta vectors), band 2's cost plane
    and every field of both bands' certified solutions bit-equal.  A
    third run with the kernels sums its ladders' launch bounds
    (``_ladder_bounds``) and must give the same flows."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport_chained as TCH
    from poseidon_tpu_torch.ops import transport_coarse as TC

    inst = _chained_instance()
    band1 = {k: inst[k] for k in ("costs1", "supply1", "col_cap1",
                                  "unsched1", "arc_cap1")}
    out = {}
    bounds = []
    for mode in ("kernels", "plain", "bound"):
        _set_plain_pipeline(mode == "plain")
        _kernels.reset_launches()
        if mode == "bound":
            _swap(TC, "solve_route", _ladder_bounds(bounds))
        t0 = time.perf_counter()
        w = TCH.pack_wave(*band1.values(), inst["req1_cpu"],
                          inst["req1_ram"], inst["ops2"], inst["supply2"],
                          max_cost_hint=inst["max_cost_hint"],
                          device=DEVICE)
        if w is None:
            fail(f"the chained program declined the seeded wave ({mode})")
        flows, small, costsB = TCH.run_program(w, DEVICE)
        E2, M = inst["ops2"]["adm0"].shape
        costs2 = costsB.cpu().numpy()[:E2, :M]
        sols = TCH.finish_wave(w, flows, small, costs2, **band1,
                               ops2=inst["ops2"], supply2=inst["supply2"])
        secs = time.perf_counter() - t0
        if sols is None:
            fail(f"the chained program did not certify the seeded wave "
                 f"({mode})")
        out[mode] = dict(flows=flows, small=small, costs2=costs2, sols=sols,
                         secs=secs, launches=dict(_kernels.LAUNCHES),
                         shape=[w.e1_pad, w.e2_pad, w.M2])
    _swap(TC, "solve_route", None)
    _set_plain_pipeline(False)
    k, p = out["kernels"], out["plain"]
    err = _max_err([k["flows"], k["small"], k["costs2"]],
                   [p["flows"], p["small"], p["costs2"]])
    for a, b in zip(k["sols"], p["sols"]):
        err = max(err, _max_err([a.flows, a.unsched, a.prices],
                                [b.flows, b.unsched, b.prices]))
    diff = [f for f in SOLUTION_FIELDS for a, b in zip(k["sols"], p["sols"])
            if getattr(a, f) != getattr(b, f)]
    s1, s2 = k["sols"]
    bound_ms = sum(bounds)
    log(f"  B7 [{k['shape'][0]} + {k['shape'][1]}, {k['shape'][2]}]: "
        f"kernels {k['secs']:.3f} s (launches {k['launches']}), plain "
        f"{p['secs']:.3f} s, bound {bound_ms:.3f} ms (its four ladders' "
        f"launches: {', '.join(f'{b:.3f}' for b in bounds)}); iterations "
        f"{s1.iterations} + {s2.iterations}, "
        f"sweeps {s1.bf_sweeps} + {s2.bf_sweeps}, objective "
        f"{s1.objective + s2.objective}; max_abs_err {err} (flows, stat "
        f"vector with the deltas, band 2's costs, both solutions), fields "
        f"differing {diff}")
    if err or diff or _max_err([k["flows"]], [out["bound"]["flows"]]):
        fail("the chained program differs from its plain-forced run")
    if not (k["launches"]["greedy_seed"] and
            k["launches"]["coarse_disaggregate"]) or \
            any(p["launches"].values()):
        fail(f"launches: kernels {k['launches']}, plain {p['launches']}")
    return {"kernels_s": k["secs"], "plain_s": p["secs"],
            "bound_ms": bound_ms, "shape": k["shape"],
            "iterations": [s1.iterations, s2.iterations]}


def _gauges() -> dict:
    """The device-memory gauges the server exported (the default
    registry's exposition), by name."""
    from poseidon_tpu_torch.obs import metrics as obs_metrics

    out = {}
    for line in obs_metrics.default_registry().expose().splitlines():
        name = line.split("{")[0].split(" ")[0]
        if name.startswith("poseidon_device_") or \
                name == "poseidon_live_buffers":
            out[line.rsplit(" ", 1)[0]] = float(line.rsplit(" ", 1)[1])
    return out


def chained_phase(ckpt, tasks, per_band_wave) -> tuple:
    """The chained drive: a server restored from the main path's
    checkpoint with ``POSEIDON_CHAINED=1``, the fresh wave and one churn
    round with the kernels, then the wave with the plain versions forced
    (the greedy rows' plain loop swapped in; it captures the wave's
    band-2 coarse instance for ``check_greedy_seed``).  The waves must
    run the chained program in one device call, certify, place every pod
    and give byte-identical deltas; the device-memory gauges must read
    after the wave.  Returns ``(rounds, captured instance, info)``."""
    from poseidon_tpu_torch.ops import transport_chained as TCH

    _set_env("POSEIDON_CHAINED", "1")
    log("chained wave (POSEIDON_CHAINED=1): wave and one churn round, "
        "kernels")
    kern = drive("chained", ckpt, tasks, 1, precompile=False)
    gauges = _gauges()
    _set_plain_pipeline(True)
    captured = {}

    def record(*args):
        if not captured:
            captured.update(zip(GREEDY_OPERANDS + ("order",),
                                (t.cpu().numpy() for t in args)))
        return TCH.greedy_rows_plain(*args)

    _swap(TCH, "greedy_rows", record)
    log("chained wave: wave, plain versions forced")
    plain = drive("chained-plain", ckpt, tasks, 0, precompile=False)
    _set_plain_pipeline(False)
    _set_env("POSEIDON_CHAINED", None)
    _check_path("chained", kern)
    wave = kern[0]
    if wave["chained"] != [TCH.RAN]:
        fail(f"the chained wave did not run the chained program: "
             f"{wave['chained'] or 'the planner gate declined'}")
    if plain[0]["chained"] != [TCH.RAN]:
        fail(f"the plain-forced chained wave: {plain[0]['chained']}")
    if wave["device_calls"] != 1:
        fail(f"the chained wave made {wave['device_calls']} device calls")
    if wave["placed"] != TASKS or wave["unscheduled"]:
        fail(f"the chained wave placed {wave['placed']} of {TASKS}")
    _same_rounds("chained", kern[:1], plain,
                 ("placed", "unscheduled", "objective", "iterations",
                  "bf_sweeps", "device_calls", "chained"))
    if any(any(r["launches"].values()) for r in plain):
        fail("the plain-forced chained wave launched a kernel")
    if not captured:
        fail("the chained wave captured no greedy-rows instance")
    in_use = [v for k, v in gauges.items()
              if k.startswith("poseidon_device_bytes_in_use")]
    limit = [v for k, v in gauges.items()
             if k.startswith("poseidon_device_bytes_limit")]
    if not (in_use and limit and all(in_use) and all(limit)):
        fail(f"the device-memory gauges did not read: {gauges}")
    log(f"  [chained] wave in one device call, deltas byte-identical to "
        f"the plain-forced run; objective {wave['objective']} (the "
        f"per-band wave's {per_band_wave['objective']}), wall "
        f"{wave['wall_s']:.3f} s (per-band {per_band_wave['wall_s']:.3f} "
        f"s); churn: {kern[1]['chained'] or 'no chain attempt'}; "
        f"device-memory gauges {json.dumps(gauges)}")
    info = {"wave_s": wave["wall_s"], "plain_wave_s": plain[0]["wall_s"],
            "objective": wave["objective"],
            "per_band_objective": per_band_wave["objective"],
            "per_band_wave_s": per_band_wave["wall_s"],
            "iterations": wave["iterations"], "host_reads":
            wave["host_reads"], "gauges": gauges}
    return kern, captured, info


def profile_phase() -> dict:
    """One ``POSEIDON_JAX_PROFILE`` window on the card: a planner round
    on a small contended cluster (200 machines, the host certificate off
    so that the solve runs on the card) writes a torch.profiler trace
    under build/chip_smoke/profile; the trace must exist, and its CUDA
    kernel events are counted."""
    import shutil

    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph.instance import RoundPlanner
    from poseidon_tpu_torch.graph.state import ClusterState, MachineInfo
    from poseidon_tpu_torch.graph.state import TaskInfo
    from poseidon_tpu_torch.obs import profile as obs_profile
    from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

    root = HARNESS_OUT / "profile"
    shutil.rmtree(root, ignore_errors=True)
    st = ClusterState()
    for i in range(200):
        cpu, ram = MACHINE_SHAPES[i % 3]
        st.node_added(MachineInfo(uuid=generate_uuid(f"pf-m{i}"),
                                  cpu_capacity=cpu, ram_capacity=ram,
                                  task_slots=8))
    rng = np.random.default_rng(SEED + 9)
    for i in range(2000):
        e = int(rng.integers(0, 20))
        st.task_submitted(TaskInfo(uid=task_uid("pf", i), job_id=f"pf-{e}",
                                   cpu_request=200 + 150 * e,
                                   ram_request=(1 << 18) * (1 + e % 4)))
    _set_env("POSEIDON_JAX_PROFILE", str(root))
    _set_env("POSEIDON_HOST_CERT", "0")
    t0 = time.perf_counter()
    _, m = RoundPlanner(st, get_cost_model("cpu_mem"),
                        device=DEVICE).schedule_round()
    secs = time.perf_counter() - t0
    _set_env("POSEIDON_JAX_PROFILE", None)
    _set_env("POSEIDON_HOST_CERT", None)
    trace = root / "round_000000" / obs_profile.TRACE_FILE
    if not trace.exists():
        fail(f"the profile window wrote no trace at {trace}")
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"  profile window: {trace.relative_to(HARNESS_OUT.parent.parent)} "
        f"({trace.stat().st_size} bytes, {len(events)} events, {kernels} "
        f"CUDA kernel events); round {secs:.3f} s, {m.device_calls} device "
        f"solves, placed {m.placed}")
    if m.device_calls < 1:
        fail("the profiled round made no device solve")
    return {"trace_bytes": trace.stat().st_size, "events": len(events),
            "cuda_kernel_events": kernels, "round_s": secs}


def kernel_phase():
    fused_cases, tiled_cases, gu_cases = kernel_cases()
    log("kernels: B1 fused ladder vs plain ladder")
    l2_rate = one_sm_l2_rate()
    fused = check_fused(fused_cases, l2_rate)
    log("kernels: B1 on planes the column gate routes, each path")
    skinny = check_skinny(SKINNY_ROUTED, timed=False)
    log("kernels: B2 per-iteration kernels vs plain iteration")
    tiled = check_tiled(tiled_cases)
    log("kernels: global-update kernel vs plain global update")
    gu = check_global_update(gu_cases)
    plans = {r["plan"][1] for r in gu}
    if DEVICE.type == "cuda" and plans != {1, 2}:
        fail(f"the global-update cases took plans {sorted(plans)}: both "
             "the shared-memory plan (2) and the workspace plan (1, the "
             "reverse length plane in the workspace) must run")
    log("kernels: coarse disaggregation kernel vs plain scan")
    disagg = check_coarse_disaggregate(disagg_cases())
    log("kernels: the coarse-to-fine program (B5) vs the plain pipeline")
    program = check_coarse_program()
    log("kernels: the chained wave's greedy rows (B7) vs the plain loop")
    greedy = check_greedy_seed(greedy_cases())
    log("kernels: the chained two-band program (B7) vs the plain versions")
    chained = check_chained_program()
    return (fused, skinny, tiled, gu, disagg, greedy, program, chained,
            l2_rate)


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


# bench.py's three machine shapes: (cpu, ram).
MACHINE_SHAPES = [(16000, 64 << 20), (32000, 128 << 20), (64000, 256 << 20)]


def _task_shapes():
    """The TASK_SHAPES task shapes (cpu, ram) and each task's shape, seed
    SEED."""
    rng = np.random.default_rng(SEED)
    ec_cpu = rng.integers(100, 4000, size=TASK_SHAPES)
    ec_ram = rng.integers(1 << 18, 1 << 22, size=TASK_SHAPES)
    ec_of_task = rng.integers(0, TASK_SHAPES, size=TASKS)
    return ec_cpu, ec_ram, ec_of_task


def _population():
    """bench.py's recipe: 3 machine shapes (64 slots each), TASK_SHAPES
    task shapes of uniform multiplicity, seed SEED."""
    from poseidon_tpu_torch.utils.ids import generate_uuid, task_uid

    nodes = [
        _node(generate_uuid(f"bench-m{i}"), *MACHINE_SHAPES[i % 3], 64)
        for i in range(MACHINES)
    ]
    ec_cpu, ec_ram, ec_of_task = _task_shapes()
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


def _pack_route_args(args, kw):
    """A ladder's device operands (``transport.solve_route``'s) as the
    packed host arrays ``_solve_device_packed`` takes: (big, vec, scale)."""
    (costs, supply, capacity, unsched, arc, prices, flows, fb, eps_sched,
     max_iter_total, global_every, bf_max, adaptive_bf) = args
    big = np.stack([t.cpu().numpy() for t in (costs, arc, flows)])
    vec = np.concatenate(
        [t.cpu().numpy() for t in (supply, capacity, unsched, prices, fb)]
        + [np.asarray(list(eps_sched), np.int32),
           np.asarray([max_iter_total, global_every, bf_max, adaptive_bf],
                      np.int32)]).astype(np.int32)
    return big, vec, int(kw["scale"])


class _CoarseWatch:
    """Spies on the planner's coarse start for one drive: per band, what
    the coarse start did (the fused program ran, or declined and why, as
    the program records it in ``_Telemetry.coarse_outcomes``; or the
    host path, or none), the seam reads (the program's 4-int read between
    its two ladders) and, with ``capture``, every ladder's operands (the
    program's two and any through ``transport._solve_device_packed``) and
    the inputs of the first plain disaggregation scan (capture runs in
    the plain drive, whose operands are the kernel drive's bits)."""

    def __init__(self):
        from poseidon_tpu_torch.graph import instance as PI
        from poseidon_tpu_torch.ops import transport as T
        from poseidon_tpu_torch.ops import transport_coarse as TC

        self.PI, self.T, self.TC = PI, T, TC
        self.real = dict(pre=PI.coarse_precheck,
                         fused=PI.solve_transport_coarse_fused,
                         read=TC._host_read, route=T.solve_route,
                         plain=TC.disaggregate_plain)
        self.events, self.seam_reads = [], 0
        self.capture = self.seam = None

    def _bind(self, pre, fused, read, route, plain):
        PI, T, TC = self.PI, self.T, self.TC
        PI.coarse_precheck, PI.solve_transport_coarse_fused = pre, fused
        TC._host_read, TC.disaggregate_plain = read, plain
        T.solve_route = TC.solve_route = route

    def __enter__(self):
        real, T = self.real, self.T

        def pre(*a, **k):
            out = real["pre"](*a, **k)
            self.events.append(
                "no coarse start (too small or thin)" if out is None
                else "no coarse start (the greedy start certifies)"
                if out["certified"] else "host two-dispatch coarse start")
            return out

        def fused(*a, **k):
            n0 = Counter(T._Telemetry.coarse_outcomes)
            sol = real["fused"](*a, **k)
            what = list((T._Telemetry.coarse_outcomes - n0).elements())
            self.events[-1] = "; ".join(f"fused program {w}" for w in what)
            return sol

        def read(t):
            if tuple(t.shape) == (4,):
                self.seam_reads += 1
            return real["read"](t)

        def route(impl, *args, **kw):
            if self.capture is not None:
                self.capture.append(_pack_route_args(args, kw))
            return real["route"](impl, *args, **kw)

        def plain(*args, **kw):
            if self.capture is not None and self.seam is None:
                self.seam = dict(zip(
                    ("costs", "arc", "cap", "Fc", "perm", "inv_perm",
                     "supply"), (t.cpu().numpy() for t in args)))
                self.seam.update(K=kw["groups"], B=kw["block"])
            return real["plain"](*args, **kw)

        self._bind(pre, fused, read, route, plain)
        return self

    def __exit__(self, *exc):
        r = self.real
        self._bind(r["pre"], r["fused"], r["read"], r["route"], r["plain"])

    def take(self):
        out = (list(self.events), self.seam_reads)
        self.events, self.seam_reads = [], 0
        return out


class _GcClock:
    """The collector's pauses (``gc.callbacks``): their seconds summed,
    the longest and the count of full (generation 2) collections since the
    last ``take``."""

    def __init__(self):
        self.t0, self.total, self.longest, self.full = None, 0.0, 0.0, 0

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            d = time.perf_counter() - self.t0
            self.total += d
            self.longest = max(self.longest, d)
            self.full += info.get("generation") == 2
            self.t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def take(self):
        out = {"gc_s": self.total, "gc_longest_s": self.longest,
               "gc_full": self.full}
        self.total, self.longest, self.full = 0.0, 0.0, 0
        return out


def drive(label, ckpt, tasks, churn_rounds, capture=None, native=True,
          precompile=True):
    """Start the port's server from the cluster checkpoint ``ckpt``
    (``load_cluster``), run a fresh wave and ``churn_rounds`` churn
    rounds over gRPC (each removing and resubmitting 1% of ``tasks``).
    Returns per-round records (serialized deltas, metrics with the
    planner tiers' counts, wall seconds, launches, host reads, each
    device solve's route and padded shape, what the coarse start did per
    band, the seam reads, the collector's pauses, and B2's route split by
    stage).  The server's
    state must have the native graph core loaded, or not, as ``native``
    says.  ``capture``, a dict, receives the wave's ladder operands
    (``"solves"``: packed ``(big, vec, scale)``) and the inputs of its
    first disaggregation (``"seam"``), for the kernels to be held against
    their plain versions there afterwards.  The server runs its
    precompile (every solve key of the live cluster's machine bucket)
    before the first round, unless ``precompile`` is False."""
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
    cfg = FirmamentTPUConfig(precompile=precompile, device=DEVICE.type,
                             checkpoint_path=str(ckpt), max_machines=0)
    t0 = time.perf_counter()
    with FirmamentTPUServer(cfg, address="127.0.0.1:0") as srv, \
            _channel(srv) as ch, _CoarseWatch() as watch, \
            _GcClock() as gcc:
        stubs = make_stubs(ch, FIRMAMENT_SERVICE, FIRMAMENT_METHODS)
        t1 = time.perf_counter()
        keys = srv.servicer.ensure_precompiled()
        t2 = time.perf_counter()
        st = srv.servicer.state
        log(f"  [{label}] server restored {len(st.machines)} machines, "
            f"{len(st.tasks)} pods from the checkpoint in "
            f"{t1 - t0:.1f} s; precompile {keys} solve keys in "
            f"{t2 - t1:.1f} s; native graph core "
            f"{'loaded' if st.native_loaded else 'not loaded'}")
        if st.native_loaded != native:
            fail(f"[{label}] the native graph core is "
                 f"{'' if st.native_loaded else 'not '}loaded")
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
            watch.take()
            gcc.take()
            reads0 = T.host_read_count()
            chained0 = Counter(T._Telemetry.chained_outcomes)
            routes0 = dict(T._Telemetry.routes)
            split0 = (Counter(T._Telemetry.stage_reads),
                      Counter(T._Telemetry.route_iters),
                      Counter(T._Telemetry.route_sweeps))
            k0 = _b2_kernel_count()
            if capture is not None and r == 0:
                watch.capture = []
            t0 = time.perf_counter()
            out = stubs.Schedule(fpb.ScheduleRequest())
            wall = time.perf_counter() - t0
            k1 = _b2_kernel_count()
            if watch.capture is not None:
                capture["solves"], capture["seam"] = watch.capture, watch.seam
                watch.capture = None
            coarse, seam_reads = watch.take()
            gc_pauses = gcc.take()
            m = srv.servicer.planner.last_metrics
            stages = {k: v[0] for k, v in stagetimer.snapshot().items()}
            rec = dict(
                kind="wave" if r == 0 else f"churn{r}",
                deltas=out.SerializeToString(), wall_s=wall,
                placed=m.placed, unscheduled=m.unscheduled,
                iterations=m.iterations, bf_sweeps=m.bf_sweeps,
                objective=m.objective, gap_bound=m.gap_bound,
                converged=m.converged, device_calls=m.device_calls,
                launches=dict(_kernels.LAUNCHES),
                host_reads=T.host_read_count() - reads0,
                seam_reads=seam_reads, coarse=coarse, gc=gc_pauses,
                chained=sorted((T._Telemetry.chained_outcomes
                                - chained0).elements()),
                routes={f"{k[0]}[{k[1]}, {k[2]}]": n - routes0.get(k, 0)
                        for k, n in sorted(T._Telemetry.routes.items())
                        if n > routes0.get(k, 0)},
                tiers={f: getattr(m, f) for f in TIER_FIELDS},
                telem={f: getattr(m, f) for f in TELEM_FIELDS},
                stages=stages,
                split=route_split(*split0),
                b2_kernels=None if k0 is None else k1 - k0,
            )
            rounds.append(rec)
            log(f"  [{label}] {rec['kind']}: {wall:.3f} s wall, placed "
                f"{m.placed}, unscheduled {m.unscheduled}, objective "
                f"{m.objective}, iterations {m.iterations}, bf "
                f"{m.bf_sweeps}, device solves {m.device_calls}, launches "
                f"{rec['launches']}, host reads {rec['host_reads']} (seam "
                f"reads {seam_reads}), gap {m.gap_bound}, solves by route "
                f"[E_pad, M_pad] {rec['routes']}")
            if rec["chained"]:
                log(f"    chained wave: {rec['chained']}")
            log(f"    coarse start by band: {coarse or 'none attempted'}; "
                f"round.view_build {stages.get('round.view_build', 0.0):.4f}"
                f" s, round.assign {stages.get('round.assign', 0.0):.4f} s;"
                f" collector {json.dumps(gc_pauses)}")
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


# The hatches as the process found them: ``_set_env(name, None)`` returns
# a hatch to this value (unset on the card, where every default holds).
ENV0 = dict(os.environ)


def _set_env(name: str, value) -> None:
    """Set a hatch, or with ``None`` return it to the value the process
    started with."""
    if value is None:
        value = ENV0.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _set_telemetry(on: bool) -> None:
    """The convergence-telemetry ring at its default (on), or off."""
    _set_env("POSEIDON_SOLVE_TELEMETRY", None if on else "0")


def _set_tiers(on: bool) -> None:
    """The planner tiers at their defaults (on), or each turned off."""
    for k in TIER_HATCHES:
        _set_env(k, None if on else "0")


KERNEL_NAMES = ("fused_ladder", "tiled_iteration", "global_update",
                "coarse_disaggregate", "greedy_seed", "fused_ladder_cluster",
                "fused_ladder_columns")
# Counted by path, but no path need launch it: the column cluster runs
# only where a band pads to under 16 rows.
OPTIONAL_KERNELS = ("fused_ladder_columns",)
# The kernels a solve route launches.
ROUTE_KERNELS = {"fused": ("fused_ladder",),
                 "tiled": ("tiled_iteration", "global_update")}
# Per-round counts that must agree between two drives of the same path
# (and the solves' routes, where both drives run the kernels).
ROUND_COUNTS = ("placed", "unscheduled", "objective", "iterations",
                "bf_sweeps", "device_calls", "seam_reads", "coarse",
                "tiers", "telem")


def _path_launches(rounds) -> dict:
    return {k: sum(r["launches"][k] for r in rounds) for k in KERNEL_NAMES}


def _check_path(name, rounds) -> None:
    """Every kernel of the routes this path's solves took was launched,
    and counted, in this path's run; so was the disaggregation kernel
    wherever the fused coarse program ran."""
    launched = _path_launches(rounds)
    for r in rounds:
        for route in r["routes"]:
            for k in ROUTE_KERNELS.get(route.split("[")[0], ()):
                if launched[k] == 0:
                    fail(f"[{name}] {r['kind']} solved on {route} but "
                         f"{k} was never launched")
        if "fused program ran" in r["coarse"] and \
                r["launches"]["coarse_disaggregate"] == 0:
            fail(f"[{name}] {r['kind']}: the fused coarse program ran but "
                 "the disaggregation kernel was never launched")
        if "ran" in r.get("chained", ()) and not (
                r["launches"]["greedy_seed"]
                and r["launches"]["coarse_disaggregate"]):
            fail(f"[{name}] {r['kind']}: the chained program ran but the "
                 f"greedy or the disaggregation kernel was never launched: "
                 f"{r['launches']}")


def _counts(rec, counts):
    """A round's counts, without the tiers' one timing
    (``pipeline_overlap_s``)."""
    out = {c: rec[c] for c in counts}
    if "tiers" in out:
        out["tiers"] = {k: v for k, v in out["tiers"].items()
                        if k != "pipeline_overlap_s"}
    return out


def _same_rounds(name, a_rounds, b_rounds, counts=ROUND_COUNTS) -> None:
    """Two drives' rounds: byte-identical deltas and equal counts."""
    for a, b in zip(a_rounds, b_rounds):
        if a["deltas"] != b["deltas"]:
            fail(f"[{name}] {a['kind']}: deltas differ")
        ca, cb = _counts(a, counts), _counts(b, counts)
        diff = {c: (ca[c], cb[c]) for c in counts if ca[c] != cb[c]}
        if diff:
            fail(f"[{name}] {a['kind']}: counts differ: {diff}")


def main_path(capture):
    """The main path — the planner tiers, the telemetry ring, the fused
    coarse program and the native graph core at their defaults — with the
    kernels, then again with the plain versions forced (plain ladders and
    plain scan; the deltas must match byte for byte, and the counts);
    one wave with ``POSEIDON_COARSE_FUSED=0`` (the host two-dispatch
    coarse start: the same objective and placed count, and the wave's
    telemetry samples), and that wave again with the telemetry off (the
    same deltas and host reads; ``ring_cost`` holds the two waves' device
    and wall seconds); one wave and one churn round with the native core
    off (deltas byte-identical to the main drive's); then the dense path,
    the tiers off, with the kernels.  Where the paths' waves never
    reached the per-iteration kernel, a contended wave stands in for it.
    ``capture`` receives the main path's wave solves (see ``drive``),
    taken in the plain run, whose operands are the same bits, and the
    chained drive's band-2 greedy instance (``chained_phase``, after the
    dense path), whose numbers come back as the fourth result."""
    from poseidon_tpu_torch.utils import stagetimer

    nodes, tasks = _population()
    ckpt = load_cluster("population", nodes, tasks)
    del nodes
    results = {}
    _set_tiers(True)
    _set_plain_pipeline(False)
    log("main path (defaults): wave, kernels")
    stagetimer.set_device_timing(True)
    kern = drive("main", ckpt, tasks, CHURN_ROUNDS)
    stagetimer.set_device_timing(False)
    _check_path("main", kern)
    _set_plain_pipeline(True)
    log("main path (defaults): wave, plain versions forced")
    # No precompile here: its probes on the plain ladders cost minutes at
    # this width and change no delta.
    plain = drive("main-plain", ckpt, tasks, CHURN_ROUNDS, capture=capture,
                  precompile=False)
    _set_plain_pipeline(False)
    _same_rounds("main", kern, plain)
    if any(any(r["launches"].values()) for r in plain):
        fail("the plain run launched a kernel")
    wave = kern[0]
    if wave["coarse"][:1] != ["fused program ran"] or \
            wave["seam_reads"] != 1:
        fail(f"the wave's band 1 did not run the fused coarse program with "
             f"one seam read: {wave['coarse']}, {wave['seam_reads']}")
    log(f"  [main] deltas byte-identical and counts equal to the plain run "
        f"over {len(kern)} rounds; the wave's coarse start: "
        f"{wave['coarse']}, {wave['seam_reads']} seam read")
    results["main"] = kern

    _set_env("POSEIDON_COARSE_FUSED", "0")
    log("coarse fused off: wave, kernels")
    stagetimer.set_device_timing(True)
    twod = drive("coarse-fused-off", ckpt, tasks, 0)
    stagetimer.set_device_timing(False)
    _check_path("coarse-fused-off", twod)
    if (twod[0]["objective"], twod[0]["placed"]) != \
            (wave["objective"], wave["placed"]):
        fail("the fused and two-dispatch coarse waves differ in objective "
             "or placed count")
    if not twod[0]["telem"]["telem_samples"]:
        fail("[coarse-fused-off] the wave captured no telemetry sample")
    if twod[0]["seam_reads"] or "fused program ran" in twod[0]["coarse"]:
        fail("[coarse-fused-off] the fused coarse program ran")
    results["coarse_fused_off"] = twod

    _set_telemetry(False)
    log("coarse fused off: wave, kernels, telemetry off")
    stagetimer.set_device_timing(True)
    off = drive("telemetry-off", ckpt, tasks, 0)
    stagetimer.set_device_timing(False)
    _set_telemetry(True)
    _set_env("POSEIDON_COARSE_FUSED", None)
    _check_path("telemetry-off", off)
    w_on, w_off = twod[0], off[0]
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
    log("  the two-dispatch wave with the telemetry on / off (same "
        "deltas): " + json.dumps(ring_cost))
    results["telemetry_off"] = off

    _set_native(False)
    log("native graph core off: wave and one churn round, kernels")
    nat = drive("native-off", ckpt, tasks, 1, native=False)
    _set_native(True)
    _check_path("native-off", nat)
    _same_rounds("native-off", kern, nat, ROUND_COUNTS + ("routes",))
    log("  [native-off] deltas byte-identical to the main drive's; "
        "round.view_build core on / off: " + json.dumps(
            [[r["stages"].get("round.view_build") for r in rs[:2]]
             for rs in (kern, nat)]))
    results["native_off"] = nat

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

    results["chained"], capture["greedy"], chained = chained_phase(
        ckpt, tasks, kern[0])

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
    if kern[0]["launches"]["coarse_disaggregate"] == 0:
        fail("the fresh wave launched no disaggregation kernel")
    for k in KERNEL_NAMES:
        if k not in OPTIONAL_KERNELS and not any(
                n[k] for n in launches.values()):
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
    return results, launches, ring_cost, chained


# ------------------------------------------------------ sharded phase

# Logical shards of the card for the direct solves (a mesh that lists
# cuda:0 k times), and for the sharded tier's drives.
SHARD_COUNTS = (2, 4, 8)
TIER_SHARDS = 4
# The counts two drives of the same cluster must share when one runs the
# sharded tier and the other the one-device dense solve.  The tiers'
# fields differ by the tier's name and counts, and the device calls and
# host reads by design: the sharded solve, as the reference's, runs no
# host certificate before its dispatch, so it dispatches (and iterates 0
# times) where the one-device solve certifies a start on the host.
SHARD_ROUND_COUNTS = ("placed", "unscheduled", "objective", "iterations",
                      "bf_sweeps", "seam_reads", "coarse", "telem")


def _wide_operands(capture):
    """The main path's captured band-1 wave ladder (the widest
    ``[128, M]`` solve) as ``solve_transport``'s host arguments: the
    padded planes and vectors, its warm start, epsilon, scale and
    budgets."""
    from poseidon_tpu_torch.ops.transport import NUM_PHASES as NP

    best = None
    for big, vec, scale in capture.get("solves") or []:
        if big.shape[1] == 128 and (best is None
                                    or big.shape[2] > best[0].shape[2]):
            best = (big, vec, scale)
    if best is None:
        fail("the main path's wave captured no [128, M] ladder")
    big, vec, scale = best
    E, M = big.shape[1:]
    parts, o = {}, 0
    for name, n in (("supply", E), ("capacity", M), ("unsched", E),
                    ("prices", E + M + 1), ("fb", E), ("eps", NP)):
        parts[name] = vec[o:o + n]
        o += n
    max_iter_total, global_every, bf_max = (int(v) for v in vec[o:o + 3])
    args = (big[0], parts["supply"], parts["capacity"], parts["unsched"],
            parts["prices"])
    kw = dict(arc_capacity=big[1], init_flows=big[2],
              init_unsched=parts["fb"], eps_start=int(parts["eps"][0]),
              eps_exact=True, scale=int(scale), max_iter_total=max_iter_total,
              global_update_every=global_every, bf_max=bf_max,
              greedy_init=False)
    return args, kw


def _timed_solve(fn, *args, **kw):
    """``fn(*args, **kw)``, its host-clock seconds (the card synchronized
    on both sides), its host reads and its global updates (the block
    ladder's, which a sharded solve runs, counted by a spy on
    ``transport._block_global_update``)."""
    from poseidon_tpu_torch.ops import transport as T

    gus = [0]
    real = T._block_global_update

    def counted(*a, **k):
        gus[0] += 1
        return real(*a, **k)

    _swap(T, "_block_global_update", counted)
    try:
        if DEVICE.type == "cuda":
            torch.cuda.synchronize()
        r0 = T.host_read_count()
        t0 = time.perf_counter()
        sol = fn(*args, **kw)
        if DEVICE.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        _swap(T, "_block_global_update", None)
    return sol, secs, T.host_read_count() - r0, gus[0]


def _solution_diff(a, b) -> list:
    """The fields two solutions differ in (the arrays, the scalars and
    the telemetry ring's shared rows)."""
    diff = [f for f in SOLUTION_FIELDS if getattr(a, f) != getattr(b, f)]
    diff += [f for f in ("flows", "unsched", "prices")
             if not np.array_equal(getattr(a, f), getattr(b, f))]
    ta, tb = a.telemetry, b.telemetry
    if (ta is None) != (tb is None):
        diff.append("telemetry")
    elif ta is not None:
        diff += [f"telemetry.{f}" for f in (
            "iters", "active_excess", "active_rows", "active_cols", "eps",
            "gu_fired", "bf_sweeps", "saturated")
            if not np.array_equal(getattr(ta, f), getattr(tb, f))]
    return diff


def check_sharded_solves(label, args, kw) -> dict:
    """The sharded solve (B6) on k = SHARD_COUNTS logical shards of the
    card against the one-device solve with the kernels: contiguous
    (``POSEIDON_SHARD_STRIDED=0``) every field bit-equal, with the host
    reads of the one-device solve with the plain versions forced; strided
    the same objective, certified.  Each timed by host clock; the bound
    is the ladder's launches' bounds (its iterations as B2's, its global
    updates and sweeps as the global update's), which splitting the work
    over one card does not change."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops import transport_sharded as TS

    E, M = args[0].shape
    # The start's epsilon declared exact, so the one-device solve skips
    # its host certificate and runs the ladder the sharded solve runs.
    kw = dict({k: v for k, v in kw.items() if k != "mesh"}, eps_exact=True)
    one, one_s, one_reads, _ = _timed_solve(T.solve_transport, *args,
                                            device=DEVICE, **kw)
    _set_plain_pipeline(True)
    plain, plain_s, plain_reads, _ = _timed_solve(T.solve_transport, *args,
                                                  device=DEVICE, **kw)
    _set_plain_pipeline(False)
    if _solution_diff(one, plain):
        fail(f"[{label}] the one-device solve with the kernels and with the "
             f"plain versions differ: {_solution_diff(one, plain)}")
    if one.gap_bound != 0.0:
        fail(f"[{label}] the one-device solve did not certify")
    rows = []
    for k in SHARD_COUNTS:
        mesh = TS.SolverMesh([DEVICE] * k)
        row = {"k": k}
        for strided in ("0", "1"):
            _set_env("POSEIDON_SHARD_STRIDED", strided)
            sh, secs, reads, gus = _timed_solve(
                TS.solve_transport_sharded, *args, mesh=mesh, **kw)
            lanes = (None if sh.telemetry is None
                     else sh.telemetry.shard_excess)
            if lanes is None or lanes.shape[0] != k:
                fail(f"[{label}] k={k}: the ring carries no per-shard lanes")
            if strided == "0":
                diff = _solution_diff(one, sh)
                if diff:
                    fail(f"[{label}] k={k} contiguous differs from the "
                         f"one-device solve in {diff}")
                if reads != plain_reads:
                    fail(f"[{label}] k={k}: {reads} host reads, the plain "
                         f"ladder {plain_reads}")
                row.update(contiguous_s=secs, host_reads=reads,
                           global_updates=gus,
                           lane_totals=[int(v) for v in lanes.sum(1)])
            else:
                if (sh.objective, sh.gap_bound) != (one.objective, 0.0):
                    fail(f"[{label}] k={k} strided: objective "
                         f"{sh.objective}, gap {sh.gap_bound}, the "
                         f"one-device solve's {one.objective}")
                row.update(strided_s=secs, strided_iterations=sh.iterations,
                           strided_lane_totals=[int(v)
                                                for v in lanes.sum(1)])
        rows.append(row)
    _set_env("POSEIDON_SHARD_STRIDED", None)
    gu = rows[0]["global_updates"]
    iters, bf = one.iterations, one.bf_sweeps
    nbytes = 4 * (4 * E * M * iters + (3 * E * M + 6 * E + 5 * M + 5) * gu)
    ops = E * M * (OPS_PER_CELL_ITER * iters + OPS_PER_CELL_GU_LENGTHS * gu
                   + OPS_PER_CELL_GU_SWEEP * bf)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    out = {"label": label, "shape": [int(E), int(M)],
           "iterations": iters, "bf_sweeps": bf, "global_updates": gu,
           "one_device_kernels_s": one_s, "one_device_plain_s": plain_s,
           "host_reads": {"kernels": one_reads, "plain": plain_reads},
           "bound_ms": bound_ms,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= ops / INT32_OPS_PER_S else "operations"),
           "shards": rows}
    e_pad, m_pad = T.padded_shape(E, M)
    out["padded"] = [e_pad, m_pad]
    log(f"  [{label}] [{E}, {M}] padded [{e_pad}, {m_pad}]: {iters} "
        f"iterations, {bf} sweeps, {gu} "
        f"global updates; one device {one_s:.3f} s with the kernels "
        f"({one_reads} host reads), {plain_s:.3f} s plain ({plain_reads}); "
        + "; ".join(f"k={r['k']} {r['contiguous_s']:.3f} s contiguous, "
                    f"{r['strided_s']:.3f} s strided"
                    for r in rows)
        + f"; bound {bound_ms:.4f} ms; every contiguous field bit-equal")
    return out


def sharded_phase(wide) -> dict:
    """The sharded solve and tier on the card: the card's own mesh (one
    device: ``make_solver_mesh(2)`` is the one-device solve, and the tier
    gate finds no mesh), then the contended cluster (``_contended``) with
    the tier off (``POSEIDON_COARSE_FUSED=0``, so its coarse start is the
    host two-dispatch start the tier also takes) and on with a mesh of
    TIER_SHARDS logical shards of the card swapped into the planner,
    contiguous (deltas byte-identical to the tier-off drive's) and
    strided (the same objective, placed count and certification); then
    the direct solves (``check_sharded_solves``) on that drive's captured
    band and on the main path's wave band ``wide``."""
    from poseidon_tpu_torch.costmodel import get_cost_model
    from poseidon_tpu_torch.graph import instance as PI
    from poseidon_tpu_torch.graph.state import ClusterState
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.ops import transport_sharded as TS

    out = {}
    n_cards = torch.cuda.device_count() if DEVICE.type == "cuda" else 1
    mesh2 = TS.make_solver_mesh(2, device=DEVICE)
    inst = _instance(16, 1024, SEED, supply_lo=40, supply_hi=120, cap_lo=1,
                     cap_hi=6)
    kw = dict(arc_capacity=inst[4])
    diff = _solution_diff(TS.solve_transport_sharded(*inst[:4], mesh=mesh2,
                                                     **kw),
                          T.solve_transport(*inst[:4], device=DEVICE, **kw))
    if mesh2.size != min(2, n_cards) or diff:
        fail(f"make_solver_mesh(2) on this machine: {mesh2}, the solve "
             f"differs from solve_transport in {diff}")
    _set_env("POSEIDON_SHARDED_BANDS", "1")
    own = PI.RoundPlanner(ClusterState(), get_cost_model("cpu_mem"),
                          device=DEVICE)._sharded_band_mesh(10240)
    if n_cards == 1 and own is not None:
        fail(f"the card's own mesh serves the sharded tier: {own}")
    _set_env("POSEIDON_SHARDED_BANDS", None)
    log(f"  make_solver_mesh(2) here: {mesh2}, its solve equals "
        f"solve_transport; the card's own tier mesh at 10240 columns: {own}")

    nodes, tasks = _contended()
    ckpt = load_cluster("contended-sharded", nodes, tasks)
    del nodes
    _set_env("POSEIDON_COARSE_FUSED", "0")
    log("sharded tier (a): the tier off, coarse fused off")
    a = drive("shard-off", ckpt, tasks, 1, precompile=False)
    _check_path("shard-off", a)
    mesh = TS.SolverMesh([DEVICE] * TIER_SHARDS)
    _swap(PI.RoundPlanner, "_sharded_tier_mesh", lambda self: mesh)
    _set_env("POSEIDON_SHARDED_BANDS", "1")
    calls = []
    real = TS.solve_transport_sharded

    def record(*args, **kw):
        sol = real(*args, **kw)
        calls.append((args, kw, sol.iterations))
        return sol

    _swap(TS, "solve_transport_sharded", record)
    runs = {}
    for name, strided in (("contiguous", "0"), ("strided", "1")):
        _set_env("POSEIDON_SHARD_STRIDED", strided)
        log(f"sharded tier ({'b' if strided == '0' else 'c'}): "
            f"POSEIDON_SHARDED_BANDS=1, {name} shards, {TIER_SHARDS} "
            f"logical shards of the card")
        runs[name] = drive(f"shard-{name}", ckpt, tasks, 1,
                           precompile=False)
        if runs[name][0]["tiers"]["sharded_bands"] == 0 and \
                "POSEIDON_SHARDED_MIN_CONTENTION" not in out:
            # The default gate declined this cluster's band: lower the
            # contention gate for the tier's drives only, as the
            # reference's own parity round does.
            out["POSEIDON_SHARDED_MIN_CONTENTION"] = "1"
            _set_env("POSEIDON_SHARDED_MIN_CONTENTION", "1")
            log("  the default gate declined the band; contention gate "
                "lowered to 1% for the tier's drives")
            calls.clear()
            runs[name] = drive(f"shard-{name}", ckpt, tasks, 1,
                               precompile=False)
    _swap(TS, "solve_transport_sharded", None)
    _swap(PI.RoundPlanner, "_sharded_tier_mesh", None)
    for hatch in ("POSEIDON_SHARDED_BANDS", "POSEIDON_SHARD_STRIDED",
                  "POSEIDON_SHARDED_MIN_CONTENTION", "POSEIDON_COARSE_FUSED"):
        _set_env(hatch, None)
    b, c = runs["contiguous"], runs["strided"]
    for name, rs in runs.items():
        w = rs[0]["tiers"]
        if (w["solve_tier"], w["shard_devices"]) != ("sharded", TIER_SHARDS):
            fail(f"[shard-{name}] the wave's tier: {w}")
        # A round's imbalance is read off its sharded solve's lanes, so a
        # round whose sharded solve iterated 0 times (its start certified)
        # reports 0; some round of the drive must have read them.
        if max(r["tiers"]["shard_imbalance"] for r in rs) < 1.0:
            fail(f"[shard-{name}] no round read the per-shard lanes: "
                 f"{[r['tiers'] for r in rs]}")
    _check_path("shard-contiguous", b)
    _check_path("shard-strided", c)
    _same_rounds("shard-contiguous", a, b, SHARD_ROUND_COUNTS)
    # Strided shards may break cost ties in another order, so after the
    # wave the two drives' clusters (and churn instances) differ: the
    # wave's objective and placed count are held equal, and every round
    # certifies (``drive`` fails otherwise).
    ra, rc = a[0], c[0]
    if (ra["objective"], ra["placed"]) != (rc["objective"], rc["placed"]):
        fail(f"[shard-strided] wave: objective {rc['objective']} placed "
             f"{rc['placed']}, the tier-off drive's {ra['objective']} "
             f"{ra['placed']}")
    log("  [shard-contiguous] deltas byte-identical to the tier-off "
        "drive's; [shard-strided] the wave's objective and placed count "
        "equal, every round certified")
    out["launches"] = {f"shard-{name}": _path_launches(rs)
                       for name, rs in (("off", a), ("contiguous", b),
                                        ("strided", c))}
    out["tier"] = {name: [{"kind": r["kind"], "wall_s": r["wall_s"],
                           "iterations": r["iterations"],
                           "objective": r["objective"],
                           "placed": r["placed"], "routes": r["routes"],
                           "host_reads": r["host_reads"],
                           "tiers": r["tiers"],
                           "solve.device": r["stages"].get("solve.device")}
                          for r in rs]
                   for name, rs in (("off", a), ("contiguous", b),
                                    ("strided", c))}
    # The tier drives' full-width sharded solve that iterated most
    # (the band's ladder, not a start the sharded path re-checks in 0
    # iterations).
    wide_calls = [c for c in calls if c[0][0].shape[1] >= 8192]
    if not wide_calls:
        fail("the tier's drives captured no full-width sharded solve")
    args, kw, _ = max(wide_calls, key=lambda c: c[2])
    out["direct"] = [check_sharded_solves("contended band", args, kw),
                     check_sharded_solves("main-path wave band", *wide)]
    return out


# ------------------------------------------------------ resident phase

# The resident phase's warm re-solve sequence: one [128, 10240] instance
# solved cold, then warm after 1% of its columns change (capacities and
# costs), then warm past the cache's wholesale gate (M_pad / 4 columns),
# then once at each of five more padded shapes (the cache keeps four).
RESIDENT_SHAPE = (128, 10240)
RESIDENT_WARM = 5
RESIDENT_WHOLESALE_COLS = 3000
RESIDENT_MORE_SHAPES = (1500, 2600, 3600, 4700, 6000)
SOLUTION_ARRAYS = ("flows", "unsched", "prices", "phase_iters")


def _resident_steps():
    """(label, costs, supply, cap, unsched, warm) of the sequence."""
    E, M = RESIDENT_SHAPE
    rng = np.random.default_rng(SEED + 9)
    costs, supply, cap, unsched, _ = _instance(
        E, M, SEED + 9, supply_lo=40, supply_hi=400, cap_lo=1, cap_hi=8)
    steps = [("cold", costs, supply, cap, unsched, False)]

    def change(costs, cap, n):
        costs, cap = costs.copy(), cap.copy()
        cols = rng.choice(M, size=n, replace=False)
        costs[:, cols] = rng.integers(0, 1000, size=(E, n))
        cap[cols] = rng.integers(1, 8, size=n)
        return costs, cap

    for i in range(RESIDENT_WARM):
        costs, cap = change(costs, cap, M // 100)
        steps.append((f"warm{i + 1}", costs, supply, cap, unsched, True))
    costs, cap = change(costs, cap, RESIDENT_WHOLESALE_COLS)
    steps.append(("wholesale", costs, supply, cap, unsched, True))
    for m in RESIDENT_MORE_SHAPES:
        c, s_, k, u, _ = _instance(E, m, SEED + m, supply_lo=40,
                                   supply_hi=400, cap_lo=1, cap_hi=8)
        steps.append((f"shape M={m}", c, s_, k, u, False))
    return steps


def _resident_run(steps):
    """Solve the sequence through ``solve_transport`` on the card; per
    solve the operand bytes uploaded (counted at the upload seam,
    ``transport._upload``), ``solve.upload``'s host and device seconds and
    ``solve.device``'s."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.utils import stagetimer

    real_upload = T._upload
    sent = [0]

    def upload(a, device):
        sent[0] += a.nbytes
        return real_upload(a, device)

    T._upload = upload
    T._RESIDENT.clear()
    sols, rows = [], []
    prev = None
    try:
        for label, costs, supply, cap, unsched, warm in steps:
            kw = {}
            if warm:
                kw = dict(init_flows=prev.flows, init_prices=prev.prices,
                          init_unsched=prev.unsched)
            stagetimer.reset()
            sent[0] = 0
            calls0 = T.device_call_count()
            prev = T.solve_transport(costs, supply, cap, unsched,
                                     device=DEVICE, **kw)
            if DEVICE.type == "cuda":
                torch.cuda.synchronize()
            host = stagetimer.snapshot()
            dev = stagetimer.device_snapshot()
            sols.append(prev)
            rows.append({
                "label": label, "shape": list(T.padded_shape(*costs.shape)),
                "bytes": sent[0],
                "device_solves": T.device_call_count() - calls0,
                "upload_host_s": host.get("solve.upload", (0.0, 0))[0],
                "upload_device_s": dev.get("solve.upload", (0.0, 0))[0],
                "solve_device_s": host.get("solve.device", (0.0, 0))[0],
                "iterations": prev.iterations,
            })
    finally:
        T._upload = real_upload
    return sols, rows


def resident_phase() -> dict:
    """The device-resident operand cache on the card: the sequence with
    ``POSEIDON_RESIDENT`` at its default (on on CUDA) and then off, every
    solution field equal between the two; warm solves upload fewer bytes
    with the cache on; the resident tensors equal their host copies after
    the sequence.  The host certificate is off in this phase so that
    every solve uploads its operand."""
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.utils import stagetimer

    steps = _resident_steps()
    _set_env("POSEIDON_HOST_CERT", "0")
    stagetimer.set_device_timing(True)
    try:
        _set_env("POSEIDON_RESIDENT", None)
        if not T.accel_policy("POSEIDON_RESIDENT", DEVICE):
            fail("the resident cache is off by default on the card")
        on, rows_on = _resident_run(steps)
        resident = {k: v for k, v in T._RESIDENT.items()}
        for key, entry in resident.items():
            if entry["dev"].device.type != "cuda":
                fail(f"resident operand {key} is not on the card")
            if not np.array_equal(entry["dev"].cpu().numpy(),
                                  entry["host"]):
                fail(f"resident operand {key} differs from its host copy")
        _set_env("POSEIDON_RESIDENT", "0")
        off, rows_off = _resident_run(steps)
        if T._RESIDENT:
            fail("the resident cache filled with POSEIDON_RESIDENT=0")
    finally:
        _set_env("POSEIDON_RESIDENT", None)
        _set_env("POSEIDON_HOST_CERT", None)
        stagetimer.set_device_timing(False)
    for (label, *_), a, b in zip(steps, on, off):
        for f in SOLUTION_FIELDS:
            if getattr(a, f) != getattr(b, f):
                fail(f"[resident] {label}: {f} differs with the cache on "
                     "and off")
        for f in SOLUTION_ARRAYS:
            if not np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))):
                fail(f"[resident] {label}: {f} differs with the cache on "
                     "and off")
    for a, b in zip(rows_on, rows_off):
        if a["device_solves"] != 1 or b["device_solves"] != 1:
            fail(f"[resident] {a['label']}: not one device solve")
        if a["label"].startswith("warm") and a["bytes"] >= b["bytes"]:
            fail(f"[resident] {a['label']}: {a['bytes']} bytes uploaded "
                 f"with the cache on, {b['bytes']} with it off")
        log(f"  [resident] {a['label']} {a['shape']}: bytes on/off "
            f"{a['bytes']}/{b['bytes']}; solve.upload host "
            f"{a['upload_host_s'] * 1e3:.3f}/{b['upload_host_s'] * 1e3:.3f}"
            f" ms, device {a['upload_device_s'] * 1e3:.3f}/"
            f"{b['upload_device_s'] * 1e3:.3f} ms; solve.device "
            f"{a['solve_device_s'] * 1e3:.3f}/"
            f"{b['solve_device_s'] * 1e3:.3f} ms; iterations "
            f"{a['iterations']}")
    kept = sorted(tuple(k) for k in resident)
    log(f"  [resident] every solution field equal with the cache on and "
        f"off over {len(steps)} solves; resident shapes kept {kept}, each "
        f"equal to its host copy")
    return {"on": rows_on, "off": rows_off, "kept": kept}


# ---------------------------------------------------------- glue drive

# The glue drive's cluster: the main path's shapes (three node shapes,
# TASK_SHAPES pod shapes, seed SEED) at a quarter of its size, which keeps
# the load through the watchers inside the run's time limit.
GLUE_MACHINES = 2_500
GLUE_TASKS = 25_000
GLUE_CHURN_ROUNDS = 3
# Seconds the watchers get to bring the whole cluster in (the load runs
# 27.5k RPCs through the watchers' workers) or a churn round's changes.
GLUE_LOAD_TIMEOUT_S = 900.0
GLUE_CHURN_TIMEOUT_S = 300.0
GLUE_SPANS = ("glue.flush_resubmits", "glue.schedule_rpc", "glue.enact",
              "glue.reconcile")


def _glue_cluster():
    """``_population``'s cluster cut to GLUE_MACHINES nodes and
    GLUE_TASKS pods as Kubernetes objects in a FakeKube: the same three
    node shapes and TASK_SHAPES pod shapes (its first GLUE_TASKS pods),
    each pod owned by its shape's job."""
    from poseidon_tpu_torch.glue.fake_kube import FakeKube, Node, Pod

    kube = FakeKube()
    for i in range(GLUE_MACHINES):
        cpu, ram = MACHINE_SHAPES[i % 3]
        kube.add_node(Node(name=f"bench-m{i}", cpu_capacity=cpu,
                           ram_capacity=ram))
    ec_cpu, ec_ram, ec_of_task = _task_shapes()
    for i in range(GLUE_TASKS):
        e = int(ec_of_task[i])
        kube.create_pod(Pod(name=f"bench-p{i}", owner_uid=f"bench-job-{e}",
                            cpu_request=int(ec_cpu[e]),
                            ram_request=int(ec_ram[e])))
    return kube


def _glue_check_round(label, kube, glue, state):
    """Every pod bound, and FakeKube's bindings equal to the scheduler's
    view (task -> machine) one for one."""
    from poseidon_tpu_torch.graph.state import TaskState

    truth = {}
    for p in kube.pods.values():
        if p.phase != "Running" or not p.node_name:
            fail(f"[glue] {label}: pod {p.key} is {p.phase}, not bound")
        truth[p.key] = p.node_name
    view = {}
    for uid, task in state.tasks.items():
        if task.state != TaskState.RUNNING:
            continue
        pod = glue.shared.task_for_uid(uid)
        node = glue.shared.node_for_resource(task.scheduled_to)
        if pod is None or node is None:
            fail(f"[glue] {label}: the scheduler runs task {uid} on "
                 f"{task.scheduled_to}, which the glue cannot resolve")
        view[pod.key] = node
    if view != truth:
        diff = sorted(set(view.items()) ^ set(truth.items()))[:5]
        fail(f"[glue] {label}: FakeKube's bindings ({len(truth)}) differ "
             f"from the scheduler's view ({len(view)}): {diff}")


def _scrape(address):
    import urllib.request

    with urllib.request.urlopen(f"http://{address}/metrics",
                                timeout=30) as r:
        return r.read().decode()


def glue_drive():
    """The glue process on the main path's cluster shapes at a quarter
    of its size: a FakeKube with GLUE_MACHINES nodes and GLUE_TASKS pods
    (2,500 and 25,000), the port's server on the
    card, the port's ``Poseidon`` glue (``run_loop=False``) against it
    over 127.0.0.1 with the port's client.  The watchers bring the whole
    cluster in; the server saves its checkpoint before any round; then
    the wave and GLUE_CHURN_ROUNDS churn rounds (1% of the running pods
    deleted and recreated through FakeKube), each ``schedule_once()``.
    Every round certifies and binds every pod, with FakeKube's truth
    equal to the scheduler's view; one scrape of the glue's and the
    server's ``/metrics`` shows the loop and round series; one
    ``MetricsAgent`` push lands in the knowledge base.  Then a server
    restored from the glue's checkpoint drives the wave directly
    (``drive``): its deltas must be byte-identical to the glue's wave."""
    from poseidon_tpu_torch.glue.metrics_agent import MetricsAgent
    from poseidon_tpu_torch.glue.poseidon import Poseidon
    from poseidon_tpu_torch.obs import trace as obs_trace
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.protos import firmament_pb2 as fpb
    from poseidon_tpu_torch.protos import stats_pb2 as spb
    from poseidon_tpu_torch.service.server import FirmamentTPUServer
    from poseidon_tpu_torch.utils import stagetimer
    from poseidon_tpu_torch.utils.config import (
        FirmamentTPUConfig,
        PoseidonConfig,
    )

    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    ckpt = out / "glue.json"
    for stale in (ckpt, Path(str(ckpt) + ".warm.npz")):
        stale.unlink(missing_ok=True)
    t0 = time.perf_counter()
    kube = _glue_cluster()
    log(f"  [glue] FakeKube built: {len(kube.nodes)} nodes, "
        f"{len(kube.pods)} pods in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 2)
    cfg = FirmamentTPUConfig(precompile=True, device=DEVICE.type,
                             checkpoint_path=str(ckpt), max_machines=0,
                             metrics_address="127.0.0.1:0")
    rounds = []
    with FirmamentTPUServer(cfg, address="127.0.0.1:0") as srv, \
            _CoarseWatch() as watch, _GcClock() as gcc:
        st = srv.servicer.state
        if not st.native_loaded:
            fail("[glue] the server's native graph core is not loaded")
        gcfg = PoseidonConfig(firmament_address=srv.address,
                              scheduling_interval=3600,
                              metrics_address="127.0.0.1:0")
        glue = Poseidon(kube, config=gcfg, stats_address="127.0.0.1:0",
                        run_loop=False)
        t0 = time.perf_counter()
        # The stage timers off for the load, which they would slow.
        _timers(False)
        glue.start(health_timeout=60)
        try:
            if not glue.drain_watchers(timeout=GLUE_LOAD_TIMEOUT_S):
                fail(f"[glue] the watchers did not bring the cluster in "
                     f"within {GLUE_LOAD_TIMEOUT_S:.0f} s")
            load_s = time.perf_counter() - t0
            if (len(st.machines), len(st.tasks)) != (GLUE_MACHINES,
                                                     GLUE_TASKS):
                fail(f"[glue] the server holds {len(st.machines)} machines,"
                     f" {len(st.tasks)} pods after the load")
            t1 = time.perf_counter()
            srv.servicer.save_checkpoint()
            t2 = time.perf_counter()
            # The precompile at the loaded cluster's machine bucket, as
            # the drive harness runs it once the fleet registered.
            keys = srv.servicer.ensure_precompiled()
            log(f"  [glue] watchers brought {GLUE_MACHINES} nodes, "
                f"{GLUE_TASKS} pods "
                f"in over gRPC in {load_s:.1f} s; checkpoint saved in "
                f"{t2 - t1:.1f} s; precompile {keys} solve keys in "
                f"{time.perf_counter() - t2:.1f} s")
            # The tracer in timing mode for the rounds: the glue's span
            # totals per round.
            _timers(True)
            for r in range(GLUE_CHURN_ROUNDS + 1):
                kind = "wave" if r == 0 else f"churn{r}"
                churn_s = 0.0
                if r > 0:
                    running = sorted(kube.pods)
                    pick = rng.choice(len(running), size=len(running) // 100,
                                      replace=False)
                    t1 = time.perf_counter()
                    for k in pick:
                        p = kube.pods[running[k]]
                        kube.delete_pod(p.namespace, p.name)
                        kube.create_pod(type(p)(
                            name=p.name, namespace=p.namespace,
                            owner_uid=p.owner_uid,
                            cpu_request=p.cpu_request,
                            ram_request=p.ram_request))
                    if not glue.drain_watchers(timeout=GLUE_CHURN_TIMEOUT_S):
                        fail(f"[glue] {kind}: the watchers did not drain")
                    churn_s = time.perf_counter() - t1
                _kernels.reset_launches()
                stagetimer.reset()
                obs_trace.reset_totals()
                watch.take()
                gcc.take()
                routes0 = dict(T._Telemetry.routes)
                t1 = time.perf_counter()
                deltas = glue.schedule_once()
                wall = time.perf_counter() - t1
                spans = obs_trace.snapshot_totals()
                launches = dict(_kernels.LAUNCHES)
                coarse, seam_reads = watch.take()
                glue._observe_metrics()
                m = srv.servicer.planner.last_metrics
                if m.gap_bound != 0.0 or not m.converged:
                    fail(f"[glue] {kind} did not certify (gap_bound "
                         f"{m.gap_bound})")
                if not glue.drain_watchers(timeout=GLUE_CHURN_TIMEOUT_S):
                    fail(f"[glue] {kind}: the binding events did not drain")
                _glue_check_round(kind, kube, glue, st)
                rec = dict(
                    kind=kind, wall_s=wall, churn_s=churn_s,
                    deltas=fpb.SchedulingDeltas(
                        deltas=deltas).SerializeToString(),
                    placed=m.placed, objective=m.objective,
                    iterations=m.iterations, launches=launches,
                    coarse=coarse, seam_reads=seam_reads,
                    routes={f"{k[0]}[{k[1]}, {k[2]}]": n - routes0.get(k, 0)
                            for k, n in sorted(T._Telemetry.routes.items())
                            if n > routes0.get(k, 0)},
                    spans={k: spans.get(k, (0.0, 0))[0] for k in GLUE_SPANS},
                    stages={k: v[0]
                            for k, v in stagetimer.snapshot().items()},
                    gc=gcc.take(), loop=dict(vars(glue.loop_stats)),
                )
                rounds.append(rec)
                log(f"  [glue] {kind}: schedule_once {wall:.3f} s (churn "
                    f"through the watchers {churn_s:.1f} s), placed "
                    f"{m.placed}, objective {m.objective}, iterations "
                    f"{m.iterations}, launches {launches}, solves by route "
                    f"{rec['routes']}, coarse start {coarse}; every pod "
                    f"bound, FakeKube equal to the scheduler's view")
                log("    glue spans (s): " + json.dumps(rec["spans"]))
                log("    server stages (s): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(
                        rec["stages"].items(), key=lambda kv: -kv[1])))
            glue_text = _scrape(glue.metrics_server.address)
            srv_text = _scrape(srv.metrics_server.address)
            for name, text in (("glue", glue_text), ("server", srv_text)):
                for series in ("poseidon_loop_rounds_total "
                               f"{GLUE_CHURN_ROUNDS + 1}",
                               f"poseidon_round_placed {rounds[-1]['placed']}",
                               "poseidon_client_rpc_attempts_total"):
                    if series not in text:
                        fail(f"[glue] the {name}'s /metrics lacks {series!r}")
            pod = next(iter(kube.pods.values()))
            node = kube.nodes[pod.node_name]

            def source():
                return ([spb.NodeStats(hostname=node.name,
                                       cpu_utilization=0.5,
                                       mem_utilization=0.25)],
                        [spb.PodStats(name=pod.name, namespace=pod.namespace,
                                      cpu_usage=50, mem_usage=1 << 10)])

            kb0 = (sum(len(e.samples) for e in st.node_kb.values()),
                   sum(len(e.samples) for e in st.task_kb.values()))
            agent = MetricsAgent(source, glue.stats_server.address)
            try:
                pushed = agent.push_once()
            finally:
                agent.stop()
            kb1 = (sum(len(e.samples) for e in st.node_kb.values()),
                   sum(len(e.samples) for e in st.task_kb.values()))
            if pushed != (1, 1) or kb1 != (kb0[0] + 1, kb0[1] + 1):
                fail(f"[glue] the MetricsAgent push did not land: "
                     f"{pushed}, knowledge base {kb0} -> {kb1}")
            log(f"  [glue] /metrics of the glue ({len(glue_text)} bytes) and "
                f"the server ({len(srv_text)} bytes) show the loop and round "
                f"series; one MetricsAgent push landed in the knowledge base")
        finally:
            glue.stop()
            _timers(True)
    del kube
    _check_path("glue", rounds)
    direct = drive("glue-restored", ckpt, [], 0)
    if direct[0]["deltas"] != rounds[0]["deltas"]:
        fail("the wave driven from the glue's checkpoint differs from the "
             "glue's wave")
    log(f"  [glue] the wave driven directly from the glue's checkpoint: "
        f"deltas byte-identical to the glue's wave "
        f"({len(rounds[0]['deltas'])} bytes); wall {direct[0]['wall_s']:.3f}"
        f" s against the glue's {rounds[0]['wall_s']:.3f} s")
    return {"load_s": load_s, "rounds": rounds, "restored": direct}


# ------------------------------------- replay, soak and scenario phases

# BASELINE config 5, the reference's trace replay (bench.py:586-592 with
# its defaults): 10,000 machines, 12,500 jobs (~100,000 tasks) over a
# 50 s horizon, 5 rounds of 10 s.
REPLAY = dict(machines=10_000, jobs=12_500, horizon_s=50.0, seed=3,
              rounds=5)
# The reference's pressure replay at the config-5 recipe's machine count
# (bench.py:601-610): min(max(M // 4, 200), 2500) machines, 10% of them
# removed mid-trace, the whole workload re-entering every round.  Its
# demand stays below the shrunken fleet, so it migrates but never
# preempts (in both packages); the same trace with twice the jobs
# outgrows the fleet and forces PREEMPT too.
PRESSURE = dict(machines=2500, jobs=3125, horizon_s=200.0, seed=4,
                remove_frac=0.10, rounds=20, parity_rounds=8)
PRESSURE_CAPACITY_JOBS = 2 * PRESSURE["jobs"]
# The smoke soak at the reference's own soak scale (bench.py:1801).
SOAK = dict(machines=200, rounds=8, plan="smoke", seed=0)
# The five named scenarios at the soak's scale.
SCENARIO = dict(machines=200, rounds=6, seed=0)
HARNESS_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"


def _summary_sans_time(summary: dict) -> dict:
    """``summary()`` without its time fields and the precompile's key
    count (a plain-forced run skips the precompile)."""
    return {k: v for k, v in summary.items()
            if not k.endswith("_s") and k != "precompile_shapes"}


def _replay(label, events, rounds, *, reschedule=False, precompile=True):
    """One ``ReplayDriver`` run of ``events`` on the card for ``rounds``
    rounds (its precompile first, unless ``precompile`` is False).
    Returns the report, per-round records (the deltas as serialized
    ``SchedulingDeltas``, the round's metrics, its kernel launches, its
    solves by route and the solve keys it saw first), the rounds'
    launches and the precompile's.  Every round must certify."""
    from poseidon_tpu_torch.check.ledger import CompileLedger
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport as T
    from poseidon_tpu_torch.replay import ReplayDriver
    from poseidon_tpu_torch.service.converters import deltas_to_proto

    driver = ReplayDriver(events, round_interval_s=10.0,
                          reschedule_running=reschedule, device=DEVICE.type,
                          precompile=precompile)
    if driver.planner.device.type != DEVICE.type:
        fail(f"[{label}] the replay's planner is on {driver.planner.device}")
    recs = []
    schedule_round = driver.planner.schedule_round
    marks = {}

    def counted_round():
        marks["launches"] = dict(_kernels.LAUNCHES)
        marks["routes"] = dict(T._Telemetry.routes)
        with CompileLedger(budget=None) as led:
            deltas, m = schedule_round()
        recs.append(dict(
            first_sights=list(led.compiled_names),
            deltas=deltas_to_proto(deltas).SerializeToString(),
            metrics=m.to_dict(),
            launches={k: v - marks["launches"][k]
                      for k, v in _kernels.LAUNCHES.items()},
            routes={f"{k[0]}[{k[1]}, {k[2]}]": n - marks["routes"].get(k, 0)
                    for k, n in sorted(T._Telemetry.routes.items())
                    if n > marks["routes"].get(k, 0)},
        ))
        if m.gap_bound != 0.0 or not m.converged:
            fail(f"[{label}] round {len(recs) - 1} did not certify "
                 f"(gap_bound {m.gap_bound})")
        return deltas, m

    driver.planner.schedule_round = counted_round
    _kernels.reset_launches()
    t0 = time.perf_counter()
    report = driver.run(max_rounds=rounds)
    wall = time.perf_counter() - t0
    launches = _path_launches(recs)
    pre = {k: n - launches[k] for k, n in _kernels.LAUNCHES.items()}
    summary = report.summary()
    log(f"  [{label}] {report.rounds} rounds in {wall:.1f} s (precompile "
        f"{summary['precompile_s']} s, {summary['precompile_shapes']} solve "
        f"keys, launches {pre}); the rounds' launches {launches}")
    for r, rec in enumerate(recs):
        m = rec["metrics"]
        log(f"    round {r}: {m['total_seconds']:.3f} s, solve "
            f"{m['solve_seconds']:.3f} s, tasks {m['num_tasks']}, ECs "
            f"{m['num_ecs']}, machines {m['num_machines']}, placed "
            f"{m['placed']}, preempted {m['preempted']}, migrated "
            f"{m['migrated']}, tier {m['solve_tier']}, fresh compiles "
            f"{m['fresh_compiles']}, implicit transfers "
            f"{m['implicit_transfers']}, launches {rec['launches']}, solves "
            f"by route {rec['routes']}"
            + (f", first sights {rec['first_sights']}"
               if rec["first_sights"] else ""))
    return report, recs, launches, pre


def _check_routes(label, recs, launches) -> None:
    """Every kernel of a route the run's solves took was launched in it."""
    for r, rec in enumerate(recs):
        for route in rec["routes"]:
            for k in ROUTE_KERNELS.get(route.split("[")[0], ()):
                if launches[k] == 0:
                    fail(f"[{label}] round {r} solved on {route} but {k} "
                         "was never launched")


def _same_replay(label, a_recs, b_recs) -> None:
    for r, (a, b) in enumerate(zip(a_recs, b_recs)):
        if a["deltas"] != b["deltas"]:
            fail(f"[{label}] round {r}: deltas differ from the plain run")


def replay_phase() -> dict:
    """BASELINE config 5's replay on the card with the kernels, then with
    the plain versions forced: every round certified, each round's deltas
    byte-identical, ``summary()`` equal but for its time fields, and the
    kernels launched on their run."""
    from poseidon_tpu_torch.replay import synthesize_trace

    c = REPLAY
    events = synthesize_trace(c["machines"], c["jobs"],
                              horizon_s=c["horizon_s"], seed=c["seed"])
    jobs = sum(1 for e in events if e.kind == "job_submit")
    tasks = sum(e.payload[1] for e in events if e.kind == "job_submit")
    log(f"  trace: {c['machines']} machines, {jobs} jobs, {tasks} tasks "
        f"over {c['horizon_s']} s")
    _set_plain_pipeline(False)
    report, recs, launches, pre = _replay("replay", events, c["rounds"])
    # The plain-forced run skips the precompile, as every plain run here
    # does: its probes on the plain ladders cost minutes and change no
    # delta.
    _set_plain_pipeline(True)
    p_report, p_recs, p_launches, _ = _replay("replay-plain", events,
                                              c["rounds"], precompile=False)
    _set_plain_pipeline(False)
    if any(p_launches.values()):
        fail(f"[replay] the plain run launched a kernel: {p_launches}")
    if not any(launches.values()):
        fail("[replay] the kernels' rounds launched no kernel")
    _check_routes("replay", recs, launches)
    if len(recs) != c["rounds"] or len(p_recs) != c["rounds"]:
        fail(f"[replay] ran {len(recs)} / {len(p_recs)} rounds")
    _same_replay("replay", recs, p_recs)
    s, ps = report.summary(), p_report.summary()
    if _summary_sans_time(s) != _summary_sans_time(ps):
        fail(f"[replay] summaries differ: {s} / {ps}")
    if s["placed"] <= 0:
        fail("[replay] placed nothing")
    log(f"  [replay] deltas byte-identical to the plain run over "
        f"{len(recs)} rounds; summary equal but for its time fields and "
        "the precompile's key count")
    log("  [replay] summary: " + json.dumps(
        {k: s[k] for k in ("round_p50_s", "round_p99_s", "solve_p50_s",
                           "precompile_s", "precompile_shapes", "placed",
                           "final_unscheduled")}))
    return {"summary": s, "plain_summary": ps, "rounds": recs,
            "launches": launches, "precompile_launches": pre,
            "tasks": tasks}


def _pressure(label, jobs) -> dict:
    """One pressure replay with the kernels, then its first rounds again
    with the plain versions forced (no precompile: the comparison is the
    deltas): every round certified, those rounds' deltas byte-identical,
    and some of the fleet's tasks MIGRATEd."""
    from poseidon_tpu_torch.replay import synthesize_trace

    c = PRESSURE
    events = synthesize_trace(c["machines"], jobs,
                              horizon_s=c["horizon_s"], seed=c["seed"],
                              remove_frac=c["remove_frac"])
    _set_plain_pipeline(False)
    report, recs, launches, pre = _replay(label, events, c["rounds"],
                                          reschedule=True)
    _set_plain_pipeline(True)
    _, p_recs, p_launches, _ = _replay(f"{label}-plain", events,
                                       c["parity_rounds"], reschedule=True,
                                       precompile=False)
    _set_plain_pipeline(False)
    if any(p_launches.values()):
        fail(f"[{label}] the plain run launched a kernel: {p_launches}")
    if not any(launches.values()):
        fail(f"[{label}] the kernels' rounds launched no kernel")
    _check_routes(label, recs, launches)
    if len(p_recs) != c["parity_rounds"]:
        fail(f"[{label}] the plain run ran {len(p_recs)} rounds")
    _same_replay(label, recs[:c["parity_rounds"]], p_recs)
    if report.migrated <= 0:
        fail(f"[{label}] migrated nothing")
    s = report.summary()
    log(f"  [{label}] {jobs} jobs: preempted {report.preempted}, migrated "
        f"{report.migrated}; the first {c['parity_rounds']} rounds' deltas "
        f"byte-identical to the plain run's; summary: {json.dumps(s)}")
    return {"summary": s, "rounds": recs, "launches": launches,
            "precompile_launches": pre}


def pressure_phase() -> dict:
    """The reference's pressure replay (10% of 2,500 machines removed
    mid-trace, the whole workload re-entering every round) on the card,
    then the same trace with twice the jobs: every round certified, the
    first rounds' deltas byte-identical to a plain-forced run of them,
    MIGRATE in both and PREEMPT where the demand outgrows the fleet."""
    ref = _pressure("pressure", PRESSURE["jobs"])
    cap = _pressure("pressure-capacity", PRESSURE_CAPACITY_JOBS)
    s = cap["summary"]
    if s["preempted"] <= 0 or s["migrated"] <= 0:
        fail(f"[pressure-capacity] preempted {s['preempted']}, migrated "
             f"{s['migrated']}: both must be positive")
    return {"summary": ref["summary"], "rounds": ref["rounds"],
            "capacity": {"summary": s, "rounds": cap["rounds"]},
            "launches": _add(ref["launches"], cap["launches"]),
            "precompile_launches": _add(ref["precompile_launches"],
                                        cap["precompile_launches"])}


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


class _RoundCounts:
    """Each planner round's kernel launches, device solves, host
    certificates and solves by route, for every round run inside it: a
    wrap of ``RoundPlanner.schedule_round`` on the class, so the rounds of
    the servers a harness builds for itself are counted and their
    precompile, which runs no round, is not."""

    def __enter__(self):
        from poseidon_tpu_torch.graph.instance import RoundPlanner
        from poseidon_tpu_torch.ops import _kernels
        from poseidon_tpu_torch.ops import transport as T

        self._orig = orig = RoundPlanner.schedule_round
        self.rounds = rounds = []

        def counted(planner):
            l0 = dict(_kernels.LAUNCHES)
            r0 = dict(T._Telemetry.routes)
            d0 = T._Telemetry.device_calls
            h0 = T._Telemetry.host_cert_returns
            out = orig(planner)
            rounds.append(dict(
                launches={k: _kernels.LAUNCHES[k] - l0[k]
                          for k in KERNEL_NAMES},
                device_solves=T._Telemetry.device_calls - d0,
                host_certs=T._Telemetry.host_cert_returns - h0,
                routes={f"{k[0]}[{k[1]}, {k[2]}]": n - r0.get(k, 0)
                        for k, n in sorted(T._Telemetry.routes.items())
                        if n > r0.get(k, 0)},
            ))
            return out

        RoundPlanner.schedule_round = counted
        return self

    def __exit__(self, *exc):
        from poseidon_tpu_torch.graph.instance import RoundPlanner

        RoundPlanner.schedule_round = self._orig

    def take(self) -> list:
        """The rounds counted since the last take."""
        out = list(self.rounds)
        self.rounds.clear()
        return out


def _harness_drive(label, counts, fn, *, device_solves=False):
    """One harness drive (``fn()``, a soak or a scenario drive, or a
    scenario's scoring) on the card: a drive's server on the card, its
    rounds' launches, device solves and host certificates apart from its
    precompile's launches.  With ``device_solves`` its rounds must have
    solved on the card, and launched every kernel of each route taken.
    Returns ``fn()``'s result and those counts."""
    from poseidon_tpu_torch.ops import _kernels

    l0 = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    rounds = counts.take()
    launches = _path_launches(rounds)
    pre = {k: _kernels.LAUNCHES[k] - l0[k] - launches[k]
           for k in KERNEL_NAMES}
    if "device" in res and res["device"] != DEVICE.type:
        fail(f"[{label}] the server solved on {res['device']}")
    out = {"wall_s": wall, "rounds": len(rounds), "launches": launches,
           "precompile_launches": pre,
           "device_solves": sum(r["device_solves"] for r in rounds),
           "host_certs": sum(r["host_certs"] for r in rounds),
           "routes": dict(sum((Counter(r["routes"]) for r in rounds),
                              Counter()))}
    if device_solves:
        if not out["device_solves"] or not any(launches.values()):
            fail(f"[{label}] the rounds made no device solve: {out}")
        _check_routes(label, rounds, launches)
    log(f"  [{label}] {wall:.1f} s; {out['rounds']} rounds, device solves "
        f"{out['device_solves']}, host certificates {out['host_certs']}, "
        f"solves by route {out['routes']}, launches {launches} "
        f"(precompile {pre})")
    return res, out


def _transfer_control() -> None:
    """The transfer ledger counts on the card: one ``.item()`` of a CUDA
    tensor counts 1, the sanctioned ``_host_read`` of it 0."""
    from poseidon_tpu_torch.check.ledger import TransferLedger
    from poseidon_tpu_torch.ops import transport as T

    t = torch.tensor([5], dtype=torch.int32, device=DEVICE)
    with TransferLedger(budget=None) as led:
        v = t.item()
    with TransferLedger(budget=None) as led_seam:
        w = T._host_read(t).tolist()
    if (v, w, led.implicit_transfers, led_seam.implicit_transfers) != \
            (5, [5], 1, 0):
        fail(f"[soak] the transfer ledger's control: .item() counted "
             f"{led.implicit_transfers} (1 expected), _host_read "
             f"{led_seam.implicit_transfers} (0 expected)")
    log("  [soak] transfer ledger control: a CUDA .item() counts 1, "
        "_host_read 0")


def soak_phase() -> dict:
    """The smoke soak on the card (the full stack under the smoke fault
    plan: every gate, the budget-0 ledger quartet in warm rounds among
    them), then the same soak again with the first run's digests
    expected: the rerun must reproduce them.  At 200 machines the host
    certificate answers every solve of those runs, so a third run turns
    it off (``POSEIDON_HOST_CERT=0``): every solve on the card, the same
    gates and the same digests."""
    from poseidon_tpu_torch.chaos import run_soak

    c = SOAK
    out = str(HARNESS_OUT / "soak")
    _transfer_control()

    def soak(**kw):
        return run_soak(machines=c["machines"], rounds=c["rounds"],
                        plan=c["plan"], seed=c["seed"], out_dir=out,
                        device=DEVICE.type, **kw)

    quartet_keys = ("warm_fresh_compiles", "warm_implicit_transfers",
                    "warm_numeric_anomalies", "warm_lock_order_edges")
    runs = {}
    with _RoundCounts() as counts:
        for name, hatch, expect, dev in (
                ("soak", None, False, False),
                ("soak-rerun", None, True, False),
                ("soak-device", "0", True, True)):
            _set_env("POSEIDON_HOST_CERT", hatch)
            try:
                kw = ({"expect_digests": runs["soak"][0]["digests"]}
                      if expect else {})
                res, info = _harness_drive(name, counts,
                                           lambda: soak(**kw),
                                           device_solves=dev)
            finally:
                _set_env("POSEIDON_HOST_CERT", None)
            if not res["ok"]:
                fail(f"[{name}] failed: {res.get('failure')} (flight "
                     f"trace {res.get('trace_path')})")
            if expect and not (res.get("reproduced")
                               and res["digests"]
                               == runs["soak"][0]["digests"]):
                fail(f"[{name}] did not reproduce the digests: "
                     f"{res.get('digest_mismatches')}")
            quartet = {k: res[k] for k in quartet_keys}
            if any(quartet.values()):
                fail(f"[{name}] the warm rounds broke a budget of 0: "
                     f"{quartet}")
            info["quartet"] = quartet
            info["tiers"] = res["tiers"]
            runs[name] = (res, info)
    first, info = runs["soak"]
    fired = sorted({e["kind"] for e in first["fired"]})
    log(f"  [soak] {first['rounds_run']} rounds, every gate passed in all "
        f"three runs; warm-round ledgers {json.dumps(info['quartet'])}; "
        f"tiers {first['tiers']}; faults fired {fired}; the rerun and the "
        f"device-solved run reproduced all {len(first['digests'])} digests")
    return {"runs": {k: v[1] for k, v in runs.items()}, "fired": fired,
            "launches": _sum_launches(v[1] for v in runs.values()),
            "precompile_launches": _sum_launches(
                (v[1] for v in runs.values()), "precompile_launches"),
            "lock_contention_ns": first["lock_contention_ns"]}


def _sum_launches(infos, key="launches") -> dict:
    out = {k: 0 for k in KERNEL_NAMES}
    for info in infos:
        out = _add(out, info[key])
    return out


def scenario_phase() -> dict:
    """The five named scenarios on the card, each driven synchronous and
    streaming (every gate passed, equal placement and delta digests) and
    scored over the perturbation seeds (every score positive: no
    perturbed drive failed a gate).  At 200 machines the host certificate
    answers most solves, so each scenario is driven once more with it off
    (``POSEIDON_HOST_CERT=0``): every solve on the card, every gate
    passed, the synchronous drive's digests."""
    from poseidon_tpu_torch.scenario import (
        SCENARIOS,
        drive_scenario,
        named_scenario,
        score_scenario,
    )

    c = SCENARIO
    _set_env("POSEIDON_SCENARIO_OUT", str(HARNESS_OUT / "scenario"))
    rows = {}
    try:
        with _RoundCounts() as counts:
            for name in SCENARIOS:
                plan = named_scenario(name, machines=c["machines"],
                                      rounds=c["rounds"], seed=c["seed"])
                tag = f"scenario {name}"
                sync, i_sync = _harness_drive(
                    f"{tag} synchronous", counts,
                    lambda: drive_scenario(plan, device=DEVICE.type))
                stream, i_stream = _harness_drive(
                    f"{tag} streaming", counts,
                    lambda: drive_scenario(plan, streaming=True,
                                           device=DEVICE.type))
                _set_env("POSEIDON_HOST_CERT", "0")
                try:
                    dev, i_dev = _harness_drive(
                        f"{tag} device-solved", counts,
                        lambda: drive_scenario(plan, device=DEVICE.type),
                        device_solves=True)
                finally:
                    _set_env("POSEIDON_HOST_CERT", None)
                for mode, res in (("synchronous", sync),
                                  ("streaming", stream),
                                  ("device-solved", dev)):
                    if not res["ok"]:
                        fail(f"[{tag}] the {mode} drive failed: "
                             f"{res.get('failure')} (flight trace "
                             f"{res.get('trace_path')})")
                    if (res["digests"], res["delta_digests"]) != \
                            (sync["digests"], sync["delta_digests"]):
                        fail(f"[{tag}] the {mode} drive's digests differ "
                             "from the synchronous drive's")
                score, i_score = _harness_drive(
                    f"{tag} scoring", counts,
                    lambda: score_scenario(plan, baseline=sync,
                                           device=DEVICE.type))
                if not score["robustness_score"] > 0:
                    fail(f"[{tag}] robustness score "
                         f"{score['robustness_score']}: "
                         f"{score.get('failures')}")
                drives = {"synchronous": i_sync, "streaming": i_stream,
                          "device_solved": i_dev, "scoring": i_score}
                rows[name] = {
                    "arrivals": plan.total_arrivals(),
                    "objective": sync["objective"], "tiers": sync["tiers"],
                    "robustness_score": score["robustness_score"],
                    "regression_p90": score["regression_p90"],
                    "placement_divergence": score["placement_divergence"],
                    "drives": drives,
                    "launches": _sum_launches(drives.values()),
                    "precompile_launches": _sum_launches(
                        drives.values(), "precompile_launches"),
                }
                log(f"  [{tag}] {plan.total_arrivals()} arrivals; "
                    "synchronous, streaming and device-solved digests "
                    f"equal; score {score['robustness_score']} (p90 "
                    f"regression {score['regression_p90']}, placement "
                    f"divergence {score['placement_divergence']})")
    finally:
        _set_env("POSEIDON_SCENARIO_OUT", None)
    return {"scenarios": rows,
            "launches": _sum_launches(rows.values()),
            "precompile_launches": _sum_launches(rows.values(),
                                                 "precompile_launches")}


HARNESS_PHASES = ("replay", "pressure", "soak", "scenario")


def harness_phases(names=HARNESS_PHASES) -> dict:
    """The replay, pressure, soak and scenario phases, in that order."""
    fns = {"replay": replay_phase, "pressure": pressure_phase,
           "soak": soak_phase, "scenario": scenario_phase}
    out = {}
    for name in names:
        log(f"{name} phase")
        t0 = time.perf_counter()
        out[name] = fns[name]()
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"  [{name}] phase took {out[name]['phase_s']:.1f} s")
    return out


def main_path_cases(capture):
    """The main path's own wave solves, as kernel cases: the widest solve
    each kernel route takes other than the coarse [E, 256] start (a kernel
    case of its own), and the wave's first disaggregation."""
    from poseidon_tpu_torch.ops import transport as T

    best = {}
    for big, vec, scale in capture.get("solves") or []:
        E, M = big.shape[1:]
        impl = T.route_for(E, M, DEVICE)
        if impl == "lax" or M == 256:
            continue
        if impl not in best or M > best[impl][1].shape[2]:
            best[impl] = ("main-path wave", big, vec, scale)
    if capture.get("seam") is not None:
        best["disagg"] = ("main-path wave seam", capture["seam"])
    return best


def kernels_record(fused, skinny, tiled, gu, disagg, greedy, launches):
    """The kernels line.  ``launches`` is ``{path: {kernel: n}}``, each
    path's count read just after its own drive; a row's ``launches`` is
    their sum over the paths, ``launches_by_path`` the split.  The ladder
    kernels carry the convergence-telemetry ring (B1 and B2 write the
    samples, the global update its fired bit and sweeps); ``ms`` is with
    the ring, ``ms_ring_off`` without it, where timed.  The
    disaggregation kernel has no ring."""
    def row(name, source, replaces, unit, cases, n, ring=True):
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
            "telemetry_ring": ring,
            "ms": lead["ms"], "ms_ring_off": lead.get("ms_ring_off"),
            "plain_ms": lead["plain_ms"],
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None,
            "cases": [{k: c[k] for k in ("label", "shape", "err", "ms",
                                         "ms_ring_off", "plain_ms",
                                         "one_sm_floor_ms", "host_ms",
                                         "kernels_per_iteration", "sweeps",
                                         "plan", "barriers", "split",
                                         "floor_ms", "solve_ms",
                                         "solve_ms_ring_off", "host_reads",
                                         "pairs")
                       if k in c}
                      | {"bound_ms": max(c["bytes"] / HBM_BYTES_PER_S,
                                         c["ops"] / INT32_OPS_PER_S) * 1e3}
                      for c in cases],
        }

    b1 = row("fused_ladder", "poseidon_tpu_torch/ops/csrc/fused_ladder.cu",
             "poseidon_tpu/ops/transport_fused.py:113",
             "one kernel launch: a whole epsilon ladder", fused,
             "fused_ladder")
    # B1's launches by path also by cluster, and the column gate's planes.
    for n in ("fused_ladder_cluster", "fused_ladder_columns"):
        b1[f"launches_by_path.{n}"] = {k: p[n] for k, p in launches.items()}
    b1["skinny_cases"] = skinny
    return {"kernels": [
        b1,
        row("tiled_iteration",
            "poseidon_tpu_torch/ops/csrc/tiled_iteration.cu",
            "poseidon_tpu/ops/transport_tiled.py:73",
            "one push/relabel iteration: a sequence of three CUDA kernels",
            tiled, "tiled_iteration"),
        row("global_update",
            "poseidon_tpu_torch/ops/csrc/global_update.cu",
            "poseidon_tpu/ops/transport.py:548",
            "one cooperative launch: a whole global update (one block per "
            "SM owning its columns' length planes and distances, two "
            "Jacobi sweeps per grid barrier)", gu, "global_update"),
        row("coarse_disaggregate",
            "poseidon_tpu_torch/ops/csrc/coarse_disaggregate.cu",
            "poseidon_tpu/ops/transport_coarse.py:226",
            "one call: two CUDA kernels (init: F0 zeroed, the supply "
            "copied; then the coarse program's whole disaggregation, one "
            "block per column group: producer warps sort the active rows "
            "into a shared-memory ring, one warp walks the row chain)",
            disagg, "coarse_disaggregate",
            ring=False),
        row("greedy_seed", "poseidon_tpu_torch/ops/csrc/greedy_seed.cu",
            "poseidon_tpu/ops/transport_chained.py:111",
            "one kernel launch: the chained wave's band-2 greedy rows (one "
            "block: producer warps stream the rows' ordered arcs into a "
            "shared-memory ring, one warp walks the rows with a warp scan "
            "each)", greedy, "greedy_seed", ring=False),
    ]}


# --------------------------------------------------------------- main

# ``--compare N <name>`` turns one default on and off between the drives:
# a hatch, or the state's native core.
COMPARE_HATCHES = {"ring": "POSEIDON_SOLVE_TELEMETRY",
                   "coarse": "POSEIDON_COARSE_FUSED"}
COMPARE_TOGGLES = tuple(COMPARE_HATCHES) + ("native",)
# The main path's wave seam (the inputs of its first disaggregation), saved
# by a full run for ``--compare N disagg``.
SEAM_FILE = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
    "wave_seam.npz"


def _warm_disaggregate() -> None:
    """One launch of the disaggregation kernel at each of its builds (1,
    2, 4 or 8 members a lane: B = 8, 40, 100, 200), so that no drive is
    charged for a first launch (loading the module: milliseconds of host
    time)."""
    from poseidon_tpu_torch.ops import transport_coarse as TC

    for B in (8, 40, 100, 200):
        d = _disagg_case(8, 16, B, SEED)
        TC.coarse_disaggregate(*_disagg_args(d), groups=d["K"], block=B)


def compare_disagg(runs: int, seam=None) -> int:
    """``--compare N disagg [SEAM]``: the disaggregation kernel alone.
    First the host milliseconds of the process's first launch (the wave
    case; the wrapper call, then to the end of the kernel), then the
    kernel cases (and the main path's wave seam, read from ``SEAM``, the
    file a full run saves as ``SEAM_FILE``) N times, each held to the
    plain scan and timed as the full run does (the same ``disaggregation
    <label>`` lines), with a JSON line of times per pass.  The wrapper's
    arguments have not changed since the kernel was first ported, so a
    copy of this script in an earlier tree's root times that tree's
    kernel: run both in turn to compare them in one call."""
    from poseidon_tpu_torch.ops import _kernels
    from poseidon_tpu_torch.ops import transport_coarse as TC

    info = device_info()
    _kernels.lib()
    cases = disagg_cases()
    if seam is not None:
        d = dict(np.load(seam))
        d["K"], d["B"] = int(d["K"]), int(d["B"])
        cases.append(("main-path wave seam", d))
    label, d = cases[0]
    args = _disagg_args(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TC.coarse_disaggregate(*args, groups=d["K"], block=d["B"])
    call_ms = (time.perf_counter() - t0) * 1000
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1000
    log(f"  disaggregation first launch ({label}): wrapper call "
        f"{call_ms:.3f} ms of host time, {done_ms:.3f} ms to the kernel's "
        "end")
    print(json.dumps({"first_launch": {"case": label, "call_ms": call_ms,
                                       "done_ms": done_ms},
                      "smi": info["smi"]}), flush=True)
    for i in range(runs):
        rows = check_coarse_disaggregate(cases)
        print(json.dumps({"disagg_ms": {r["label"]: r["ms"] for r in rows},
                          "host_ms": {r["label"]: r["host_ms"] for r in rows},
                          "bound_ms": {r["label"]: max(
                              r["bytes"] / HBM_BYTES_PER_S,
                              r["ops"] / INT32_OPS_PER_S) * 1e3
                              for r in rows},
                          "pass": i, "smi": info["smi"]}), flush=True)
    return 0


def compare(runs: int, toggle=None) -> int:
    """``--compare N``: one B2 iteration's device time at each B2 kernel
    case (``_time_b2``), then N drives with the kernels (a fresh wave and
    one churn round, no plain run), each round printed as a JSON line
    with its wall, stages and B2's route split; run in two trees in turn
    to compare them in one call.  ``--compare N ring`` (or ``coarse``,
    ``native``) turns the telemetry ring (the fused coarse program, the
    native graph core) on and off between the drives (on, off, off, on,
    ...), to compare the two in one process."""
    from poseidon_tpu_torch.ops.transport_tiled import TiledIteration
    from poseidon_tpu_torch.utils import stagetimer

    info = device_info()
    _timers(True)
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
    _warm_disaggregate()
    stagetimer.set_device_timing(True)
    nodes, tasks = _population()
    ckpt = load_cluster("population", nodes, tasks)
    if toggle is not None and toggle not in COMPARE_TOGGLES:
        fail(f"--compare toggles one of {COMPARE_TOGGLES}, not {toggle}")
    hatch = COMPARE_HATCHES.get(toggle)
    for i in range(runs):
        on = toggle is None or i % 4 in (0, 3)
        if hatch is not None:
            _set_env(hatch, None if on else "0")
        _set_native(on or toggle != "native")
        recs = drive("compare", ckpt, tasks, 1,
                     native=on or toggle != "native")
        for rec in recs:
            print(json.dumps({
                "kind": rec["kind"], "toggle": toggle, "on": on,
                "wall_s": rec["wall_s"], "iterations": rec["iterations"],
                "host_reads": rec["host_reads"], "coarse": rec["coarse"],
                "stages": rec["stages"], "gc": rec["gc"],
                "route_split": rec["split"], "smi": info["smi"]}),
                flush=True)
    if hatch is not None:
        _set_env(hatch, None)
    _set_native(True)
    return 0


def _timers(on: bool) -> None:
    """The stage timers (the tracer's aggregate mode) on or off."""
    _set_env("POSEIDON_STAGE_TIMERS", "1" if on else "0")


def _harness_report(info, harness) -> dict:
    """The harness phases' numbers for the log, tagged with the card.
    A phase's ``launches`` are its rounds' (the kernels line's path
    counts), ``precompile_launches`` its servers' precompiles'."""
    out = {"card": info["smi"]}
    for name, res in harness.items():
        row = {"phase_s": res["phase_s"], "launches": res["launches"]}
        if "summary" in res:
            row["summary"] = res["summary"]
            row["rounds"] = [
                {k: r["metrics"][k] for k in (
                    "total_seconds", "solve_seconds", "num_tasks",
                    "num_ecs", "placed", "preempted", "migrated",
                    "solve_tier", "fresh_compiles", "implicit_transfers",
                    "numeric_anomalies", "lock_contention_ns")}
                for r in res["rounds"]]
        if "capacity" in res:
            row["capacity_summary"] = res["capacity"]["summary"]
        for k in ("precompile_launches", "plain_summary", "runs",
                  "fired", "scenarios"):
            if k in res:
                row[k] = res[k]
        out[name] = row
    return out


def main(argv) -> int:
    if argv[:1] == ["--compare"] and argv[2:3] == ["disagg"]:
        return compare_disagg(int(argv[1]), (argv[3:4] or [None])[0])
    if argv[:1] == ["--compare"]:
        return compare(int(argv[1]), (argv[2:3] or [None])[0])
    info = device_info()
    _timers(True)
    build_kernels()
    if argv[:1] == ["--b1"]:
        # B1's checks alone: its kernel cases on every path the gates
        # take, then the planes the row cluster leaves (the column
        # cluster against the one-SM kernel and B2), one JSON line.
        check_fused(kernel_cases()[0], one_sm_l2_rate())
        log("b1 rows: " + json.dumps({"card": info["smi"],
                                      "rows": check_skinny()}))
        return 0
    if argv[:1] == ["--phases"]:
        # A subset of the replay, pressure, soak and scenario phases
        # alone (no kernel comparison, no result line).
        harness = harness_phases(argv[1].split(","))
        log("harness phases: " + json.dumps(_harness_report(info, harness)))
        return 0
    t0 = time.perf_counter()
    (fused, skinny, tiled, gu, disagg, greedy, program, chained_program,
     l2_rate) = kernel_phase()
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    capture = {}
    results, launches, ring_cost, chained = main_path(capture)
    log("kernels: the greedy rows at the chained wave's band-2 instance")
    greedy = check_greedy_seed([("chained wave band 2",
                                 capture.pop("greedy"))]) + greedy
    log("profile window: POSEIDON_JAX_PROFILE around one round's solve")
    profile = profile_phase()
    # The kernels at the main path's own wave shapes (after the path's
    # launches were read, so these comparisons are not counted).
    cases = main_path_cases(capture)
    wide = _wide_operands(capture)
    del capture
    if "fused" in cases:
        log("kernels: B1 at the main path's wave shape")
        fused += check_fused([cases["fused"]], l2_rate)
    if "tiled" in cases:
        log("kernels: B2 at the main path's wave shape")
        tiled += check_tiled([cases["tiled"]])
    if "disagg" not in cases:
        fail("the main path's wave captured no disaggregation")
    SEAM_FILE.parent.mkdir(parents=True, exist_ok=True)
    np.savez(SEAM_FILE, **cases["disagg"][1])
    log("kernels: the disaggregation at the main path's seam")
    disagg += check_coarse_disaggregate([cases["disagg"]])
    log(f"sharded solve and tier: {SHARD_COUNTS} logical shards of the card")
    sharded = sharded_phase(wide)
    del wide
    launches.update(sharded.pop("launches"))
    log("sharded phase: " + json.dumps({"card": info["smi"], **sharded}))
    log("resident operand cache: a warm re-solve sequence at [128, 10240], "
        "the cache on and off")
    resident = resident_phase()
    log("glue drive: FakeKube -> watchers -> client -> server, "
        f"{GLUE_MACHINES} nodes / {GLUE_TASKS} pods")
    glue = glue_drive()
    launches["glue"] = _path_launches(glue["rounds"])
    launches["glue-restored"] = _path_launches(glue["restored"])
    harness = harness_phases()
    for name in HARNESS_PHASES:
        launches[name] = harness[name]["launches"]
    # Output check: the wave placed pods and every round certified (the
    # drive fails otherwise); the churn rounds re-placed the churned pods.
    wave = results["main"]
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
    # The slice's stages by drive: the wave's device solve, view build,
    # assignment and wall, and the churn rounds' view build and wall.
    summary = {"card": info["smi"], "b5_program": program,
               "b7_program": chained_program, "chained_wave": chained,
               "profile": profile}
    for name, rs in results.items():
        summary[name] = [
            {"kind": r["kind"], "wall_s": r["wall_s"],
             "iterations": r["iterations"], "host_reads": r["host_reads"],
             "seam_reads": r["seam_reads"], "coarse": r["coarse"],
             **{k: r["stages"].get(k) for k in (
                 "solve.device", "solve.device.fused", "solve.device.tiled",
                 "solve.device.coarse_lift",
                 "solve.device.coarse_disaggregate",
                 "solve.device.coarse_certificate", "round.view_build",
                 "round.assign", "round.solve_band", "round.cost_build")},
             **r["gc"]}
            for r in rs]
    log("stages by drive: " + json.dumps(summary))
    log("resident phase, per solve, cache on / off: " + json.dumps(
        {"card": info["smi"], "kept": resident["kept"], "solves": [
            {"label": a["label"], "shape": a["shape"],
             "bytes": [a["bytes"], b["bytes"]],
             "upload_host_s": [a["upload_host_s"], b["upload_host_s"]],
             "upload_device_s": [a["upload_device_s"], b["upload_device_s"]],
             "solve_device_s": [a["solve_device_s"], b["solve_device_s"]]}
            for a, b in zip(resident["on"], resident["off"])]}))
    log("glue drive: " + json.dumps(
        {"card": info["smi"], "load_s": glue["load_s"], "rounds": [
            {"kind": r["kind"], "schedule_once_s": r["wall_s"],
             "churn_s": r["churn_s"], "placed": r["placed"],
             "spans": r["spans"], "loop": r["loop"], **r["gc"],
             **{k: r["stages"].get(k) for k in (
                 "solve.device", "round.view_build", "round.assign",
                 "round.solve_band", "round.cost_build")}}
            for r in glue["rounds"]],
         "restored_wave_s": glue["restored"][0]["wall_s"]}))
    log("harness phases: " + json.dumps(_harness_report(info, harness)))
    print(info["smi"], flush=True)
    print(json.dumps(kernels_record(fused, skinny, tiled, gu, disagg,
                                    greedy, launches)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

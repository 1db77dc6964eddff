// Fused epsilon-ladder kernel (B1): the whole cost-scaling push-relabel
// ladder of one transportation solve in ONE launch.
//
// Replaces: poseidon_tpu/ops/transport_fused.py::_phase_ladder_kernel (the
// Pallas TPU kernel launched by solve_device_fused).  Same arithmetic, same
// update order, int32 throughout, so results are bit-equal to the plain
// torch ladder (ops/transport.py::_solve_device) and to the reference.
//
// What it computes: for each of the 4 epsilon phases, refine the carried
// flows to the new eps, then synchronous push/relabel iterations until no
// node has positive excess (or a budget trips).  Pushes are allocated by
// inclusive row prefixes (EC rows, over machines) and column prefixes
// (machine columns, over ECs); the sink row's 1-D prefix runs over
// [machines, ECs].  The Bellman-Ford global update runs in place of the
// local relabel on the fixed or adaptive cadence, four Jacobi sweeps per
// convergence check.
//
// Bound on the H100.  The card's bound counts C, Uem and F read and F
// written in every push/relabel iteration and C, Uem and F read in every
// Bellman-Ford sweep, over 3.35 TB/s of HBM: 0.5215 ms at the wave's
// coarse shape [128, 256] (827 iterations, 3340 sweeps), bound by bytes.
// One launch must carry the state across phases and iterations, and each
// stage needs all of the one before it, so the kernel is one block on one
// SM with __syncthreads() as its only barrier.  Its floor is then one
// SM's: the same bytes at the rate one SM reads L2, or the counted int32
// operations at one SM's share of the card's int32 rate, whichever is
// longer (chip_smoke.py measures the rate and prints both).  At [128, 256]
// the operations bind, some 60x the card's bound.  The design aims at that
// floor: every stage keeps all 32 warps busy with independent loads in
// flight, instead of a chain of dependent L2 round trips, and the
// Bellman-Ford sweeps do as little arithmetic per cell as they can.
//
// Design (one 1024-thread block, 32 warps):
// - The [E, M] planes stay in global memory, L2-resident: C, Uem, F and P
//   are 512 KB at [128, 256] and 2.6 MB at [128, 1280], more than the
//   227 KB of one SM's shared memory.  C, Uem, U, sup and cap, which the
//   kernel never writes, are read through the read-only path (__ldg); an
//   array the kernel writes is never read that way.
// - Column stages (the excess sums, the push sweep's column pass, the
//   Bellman-Ford column pass) run one thread per (machine column, row
//   segment) unit, lane = column (ColUnits).  A column's rows split into
//   as many segments as keep all 1024 threads busy: 4 at [128, 256], 1
//   from M = 1024 up.  Segment sums and minima meet in shared memory; the
//   push sweep's prefix down a column is a two-pass segmented scan
//   (segment sums, then each segment walked from the exclusive sum of the
//   segments above it).
// - Row stages (the push sweep's row pass, the post-push row pass, the
//   Bellman-Ford row pass) run one warp per (EC row, column segment)
//   unit, lanes across 32-column chunks, warp scans with a carried prefix
//   (RowUnits).  A row splits only when E < 32, so that every warp works;
//   its prefix is then a two-pass segmented scan as well.
// - Splitting a sum or a prefix is exact, because an integer sum does not
//   depend on how it is split; the OR and max reductions do not depend on
//   order at all.
// - Segments and chunks are walked in batches, all of a batch's loads
//   issued before any of its arithmetic or stores (walk), so a batch costs
//   one L2 round trip instead of one per row.
// - A global update's flows and prices stay frozen through its sweeps, so
//   it computes each arc's forward and reverse length once, into two
//   scratch planes; a sweep then reads those two planes and adds and takes
//   minima, instead of reading C, Uem and F and dividing in every cell.
//   Its floor-divides multiply by a per-eps magic number (PtDivisor, exact)
//   instead of the card's emulated integer divide.
// - pe and the two Bellman-Ford distance buffers de live in shared memory
//   (every column stage reads them once per cell); pe is copied in at the
//   start and back at the end.  The dynamic shared memory is sized from E
//   at launch (ladder_smem_bytes, mirrored in ops/transport_fused.py).
// - Back-to-back block reductions are fused into one reduction of a small
//   struct (each reduction costs four barriers).
// - The convergence-telemetry ring (the reference kernel's telem_cap
//   output) is an optional global [8, cap] int32 buffer, apart from the
//   workspace.  The entering-state reduction counts the rows and columns
//   with positive excess in the one int that held its OR (rows in the low
//   16 bits, columns in the high 15: E < 2^16 and M < 2^15 inside the
//   gate, checked at launch), so it holds no more registers than before;
//   thread 0 parks the sample's values in shared memory, so none stays
//   live in registers across the push sweep and the update, and writes
//   the iteration's sample after the update or the local relabel.
//   Nothing in the kernel reads the ring; with a null ring pointer no
//   store is made.
//
// Cluster path (fused_ladder_cluster_kernel, the entry point's ctas > 1):
// the same ladder as one launch of a thread-block cluster of k CTAs (8,
// or 16 where 8 do not fit), each on its own SM, with the planes in the
// cluster's distributed shared memory instead of L2.  Same arithmetic,
// same update order, int32 throughout: flows, prices, stats and ring are
// bit-equal to the one-SM kernel's and to the plain ladder's, and so are
// the iterations and sweeps, since integer sums, minima, maxima and ORs
// do not depend on how they are split.
// - CTA r holds rows [r S, r S + S) (S = ceil(E / k)) of C, Uem, F, the
//   pushes P (shared with the global update's forward lengths) and the
//   reverse lengths, 20 bytes a cell, with its rows' [S] vectors; every
//   CTA holds every [M] vector and computes every column's finish alike,
//   so no column result needs a second exchange.  F, pe, Ffb, Fmt, pm and
//   pt are loaded at entry and written back at exit.  512 threads a CTA
//   (128 registers, no spills).
// - Row stages (the push sweep's row pass, the post-push row pass, the
//   Bellman-Ford row pass) stay inside a CTA: a lane takes four adjacent
//   columns (16-byte loads; M a multiple of 4), one warp scan a
//   128-column chunk.
// - Column stages run one thread per (column, row segment) of the CTA's
//   slab (ColUnits); the CTA's partials per column go to the other CTAs
//   as reductions into their shared memory (red.shared::cluster: add, min,
//   max, or), which they read and reset after the next cluster barrier.
//   The push sweep's column prefix is the one-SM kernel's two-pass
//   segmented scan with the CTAs as the outer segments: pass 1 adds each
//   slab's sum of res into the CTAs below it, pass 2 walks each slab from
//   that carry.  The sink row's EC part does the same over the slabs.
// - Block reductions become cluster reductions: warp 0 of each CTA
//   reduces its CTA's partial and stores it into a slot of every CTA;
//   after the barrier each CTA combines its k slots in rank order.  The
//   push sweep's sink reduction carries the next iteration's entering
//   state (flows and excesses do not change until the next push).
// - Cluster barriers (barrier.cluster, split into arrive and wait where a
//   stage can run between): 3 a push/relabel iteration (the column
//   prefix's carries, with the sink row's machine scan inside; the
//   columns' partials, with the post-push row pass inside; the sink and
//   entering-state reduction), 1 a Bellman-Ford sweep (the column minima
//   and the sink's partial together), 1 a global update (its convergence
//   check), 2 an epsilon phase (the excesses and the entering state).
//   The local relabel needs none: every CTA holds what it reads.
// - Bound: the operations at k SMs' share of the card's int32 rate.  At
//   [128, 256] over 8 CTAs the kernel runs 6.4-7.6 ms a burst instance
//   against 24.4-28.7 ms for the one-SM kernel, and 21.2 ms against 71.2
//   on the seeded case (827 iterations, 3340 sweeps); per iteration about
//   24,000 cycles, of which the three barriers take some 4,000 and the
//   cross-CTA reductions and row passes most of the rest (clock64 stage
//   profile, NVIDIA H100 80GB HBM3, 700 W).
// - Which path (ops/transport_fused.py::ladder_ctas, from the shape
//   alone): the cluster where E >= 16, M is a multiple of 4 and the
//   shares of the planes fit a CTA's 227 KB (cluster_layout).  From 16
//   rows the cluster path was 1.2x to 10x faster at every shape timed
//   ([16, 128] 1.47 against 1.97 ms, [16, 2048] 17.8 against 26.3,
//   [1024, 128] 24.8 against 249.7); at 8 rows it was no faster on wide
//   planes ([8, 1024] 1.36 against 1.37 ms, [8, 2048] 10.6 against 10.8 at
//   8 CTAs).  Where the cluster path declines, a third path may take the
//   shape: a cluster that splits the columns instead
//   (fused_ladder_columns.cu, ops/transport_fused.py::ladder_slab_ctas);
//   the one-SM kernel serves what both decline.
//
// The helpers the paths share (the fused reductions' values, the row
// stages' units, a column's sink arc, the reduced cost, the cluster
// barrier) are in ladder.cuh.

#include <cooperative_groups.h>

#include <cstddef>

#include "common.cuh"
#include "ladder.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Planes {
  const int* C;    // [E, M] scaled costs, PT_INF_COST = inadmissible (read-only)
  const int* U;    // [E] scaled unscheduled costs (read-only)
  const int* sup;  // [E] (read-only)
  const int* cap;  // [M] (read-only)
  const int* Uem;  // [E, M] per-arc capacity (read-only)
  int* F;          // [E, M] flows (state, in place)
  int* Ffb;        // [E]
  int* Fmt;        // [M]
  int* pe;         // [E] shared memory during the run
  int* pm;         // [M]
  int* pt;         // [1]
  int* P;          // [E, M] scratch: EC-side pushes of the current iteration
  int* Lf;         // [E, M] scratch: forward arc lengths of a global update
  int* Lr;         // [E, M] scratch: reverse arc lengths of a global update
  int* exc_e;      // [E]
  int* exc_m;      // [M]
  int* fbp;        // [E] fallback pushes
  int* tpm;        // [M] sink pushes to machines
  int* tpe;        // [E] sink pushes to EC fallbacks
  int* cand_e;     // [E] relabel candidates
  int* hadm_e;     // [E]
  int* cand_m;     // [M]
  int* hadm_m;     // [M]
  int* de0;        // [E] BF distances, double buffered (shared memory)
  int* de1;
  int* dm0;        // [M]
  int* dm1;
  int* part;       // [4][kThreads] column-stage partials (shared memory)
  int* ring;       // [8, ring_cap] telemetry samples, or null
  int E, M, ring_cap;
};

// Block scalars and the block-reduction scratch (32 slots of up to 16
// bytes).
struct Shared {
  long long red[64];
  int pt;
  int exc_t;
  int hadm_t;  // sink relabel inputs of the current iteration
  int cand_t;
  // The telemetry sample of the current iteration (_TR_* order).
  int tel[8];
};

// Dynamic shared memory: Shared | part | pe[E] | de0[E] | de1[E].
constexpr int kSharedBytes = 1024;
constexpr int kPartInts = 4 * kThreads;
static_assert(sizeof(Shared) <= kSharedBytes, "Shared outgrew its slot");

size_t ladder_smem_bytes(int E) {
  return kSharedBytes + sizeof(int) * (kPartInts + 3 * (size_t)E);
}

template <typename T>
__device__ __forceinline__ T* scratch(Shared& s) {
  static_assert(sizeof(T) <= 16, "reduction slots hold 16 bytes");
  return reinterpret_cast<T*>(s.red);
}

// Work units of the column stages: (machine column m, row segment r)
// pairs, u = r * M + m, one thread each, so a warp's lanes take
// consecutive columns and every plane load of a warp is coalesced.  Each
// column's E rows split into `segs` contiguous segments: the largest power
// of two <= E with segs * M <= kThreads, at least 1.  A narrow plane thus
// keeps every thread busy on a segment of one column, and a wide one gives
// each thread whole columns that need no partner.  With segs > 1 the
// units' partials meet in shared memory (segs * M <= kThreads ints per
// buffer), and one thread per column finishes it after one barrier.
template <int T>
struct ColUnitsOf {
  int E, M, segs, seg, n;
  __device__ ColUnitsOf(int E_, int M_) : E(E_), M(M_) {
    segs = 1;
    while (segs * 2 <= E && segs * 2 * M <= T) segs *= 2;
    seg = (E + segs - 1) / segs;
    n = segs * M;
  }
  // Unit u's column, segment and rows [e0, e1).
  __device__ void at(int u, int& m, int& r, int& e0, int& e1) const {
    r = u / M;
    m = u - r * M;
    e0 = min(r * seg, E);
    e1 = min(e0 + seg, E);
  }
};
using ColUnits = ColUnitsOf<kThreads>;

using RowUnits = RowUnitsOf<kWarps>;

// Walk items [i0, i1) in batches of N: every load of a batch is issued
// before any of its uses (arithmetic, stores), so a batch costs one round
// trip to L2 rather than one per item.
template <int N, typename Load, typename Use>
__device__ __forceinline__ void walk(int i0, int i1, Load load, Use use) {
  for (int b = i0; b < i1; b += N) {
    decltype(load(0)) v[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (b + i < i1) v[i] = load(b + i);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (b + i < i1) use(b + i, v[i]);
  }
}

__device__ __forceinline__ ColHead col_head(const Planes& p, int m, int pt) {
  return col_head_of(p.exc_m[m], p.pm[m], p.Fmt[m], __ldg(p.cap + m), pt);
}

__device__ __forceinline__ int rc_em_at(const Planes& p, int idx, int pe_e, int pm_m) {
  return rc_em(__ldg(p.C + idx), pe_e, pm_m);
}

// Excesses from the flow state: exc_e, exc_m, and the scalar exc_t.
__device__ void excesses(const Planes& p, int total, Shared& s) {
  const int E = p.E, M = p.M;
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = w; e < E; e += kWarps) {
    int acc = 0;
    for (int m = lane; m < M; m += 32) acc += p.F[e * M + m];
    acc = pt_warp_reduce(acc, PtSum());
    if (lane == 0) p.exc_e[e] = __ldg(p.sup + e) - acc - p.Ffb[e];
  }
  // Machine columns: segment sums, summed per column.
  const ColUnits cu(E, M);
  for (int u = threadIdx.x; u < cu.n; u += kThreads) {
    int m, r, e0, e1;
    cu.at(u, m, r, e0, e1);
    int acc = 0;
    walk<8>(e0, e1, [&](int e) { return p.F[e * M + m]; }, [&](int, int f) { acc += f; });
    if (cu.segs == 1) p.exc_m[m] = acc - p.Fmt[m];
    else p.part[u] = acc;
  }
  if (cu.segs > 1) {
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += kThreads) {
      int acc = 0;
      for (int r = 0; r < cu.segs; ++r) acc += p.part[r * M + m];
      p.exc_m[m] = acc - p.Fmt[m];
    }
  }
  int part = 0;
  for (int m = threadIdx.x; m < M; m += kThreads) part += p.Fmt[m];
  for (int e = threadIdx.x; e < E; e += kThreads) part += p.Ffb[e];
  int tot = pt_block_reduce(part, PtSum(), 0, scratch<int>(s));
  if (threadIdx.x == 0) s.exc_t = tot - total;
  __syncthreads();
}

// Global price update (reference _global_update) on the post-push state
// with the frozen prices.  Returns the BF sweeps spent.
__device__ int global_update(const Planes& p, int eps, int bf_max, Shared& s) {
  const int E = p.E, M = p.M;
  const int pt = s.pt;
  const PtDivisor dv(eps);
  const ColUnits cu(E, M);
  int* de = p.de0; int* de_n = p.de1;
  int* dm = p.dm0; int* dm_n = p.dm1;
  // Flows and prices stay frozen through the sweeps, so each arc's length
  // is computed once, with the same arithmetic: Lf for the forward arc
  // (EC -> machine, open while Uem - F > 0) and Lr for the reverse arc
  // (open while F > 0), PT_CLOSED for an arc that is not open.  No open
  // arc's length is PT_CLOSED (INT_MIN): the host hands over prices within
  // +-2^28 and the kernel only lowers them, to no less than -2^29, so
  // x = c + pe - pm stays within +-2^30 and floor(+-x / eps) + 1 > INT_MIN.
  {
    const PtDivisor dM(M);
    const int mine = (E * M - (int)threadIdx.x + kThreads - 1) / kThreads;
    walk<4>(0, mine,
            [&](int k) {
              int i = threadIdx.x + k * kThreads;
              int e = pt_floordiv(i, dM), m = i - e * M;
              int c = __ldg(p.C + i);
              int f = p.F[i];
              bool adm = c < PT_INF_COST;
              int x = c + p.pe[e] - p.pm[m];
              int lf = adm ? pt_floordiv(x, dv) + 1 : PT_DINF;
              int lr = adm ? pt_floordiv(-x, dv) + 1 : PT_DINF;
              return make_int2(__ldg(p.Uem + i) - f > 0 ? lf : PT_CLOSED,
                               f > 0 ? lr : PT_CLOSED);
            },
            [&](int k, int2 v) {
              int i = threadIdx.x + k * kThreads;
              p.Lf[i] = v.x;
              p.Lr[i] = v.y;
            });
  }
  for (int e = threadIdx.x; e < E; e += kThreads) de[e] = p.exc_e[e] < 0 ? 0 : PT_DINF;
  for (int m = threadIdx.x; m < M; m += kThreads) dm[m] = p.exc_m[m] < 0 ? 0 : PT_DINF;
  int dt = s.exc_t < 0 ? 0 : PT_DINF;
  __syncthreads();
  // Row and column minima: segments of each line, finished per line.
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const RowUnits ru(E, M);
  int* row_part = p.part + kThreads;
  int* col_part = p.part;
  int sweeps = 0;
  bool changed = true;
  while (changed && sweeps <= bf_max) {
    int any = 0;            // this thread's rows/columns moved (any sweep)
    bool dt_moved = false;  // the sink moved (block-uniform)
    Sweep red{PT_DINF, 0};
    for (int k = 0; k < 4; ++k) {
      // EC rows: via machines (forward arcs) and via the fallback arc.
      auto row_finish = [&](int e, int best) {
        int rfb = __ldg(p.U + e) + p.pe[e] - pt;
        int via_t = (__ldg(p.sup + e) - p.Ffb[e] > 0) ? pt_floordiv(rfb, dv) + 1 + dt : PT_DINF;
        int nv = min(de[e], min(best, via_t));
        de_n[e] = nv;
        if (nv != de[e]) any = 1;
      };
      for (int u = w; u < ru.n; u += kWarps) {
        int e, q, c0, c1;
        ru.at(u, e, q, c0, c1);
        int best = PT_DINF;
        const int m1 = min(c1 * 32, M);
#pragma unroll 4
        for (int m = c0 * 32 + lane; m < m1; m += 32) {
          int l = p.Lf[e * M + m];
          best = l != PT_CLOSED ? min(best, l + dm[m]) : best;
        }
        best = pt_warp_reduce(best, PtMin());
        if (lane == 0) {
          if (ru.segs == 1) row_finish(e, best);
          else row_part[u] = best;
        }
      }
      // Machine columns: via reverse arcs to ECs and via the sink arc.
      auto col_finish = [&](int m, int best) {
        int via_t = (__ldg(p.cap + m) - p.Fmt[m] > 0) ? pt_floordiv(p.pm[m] - pt, dv) + 1 + dt
                                                     : PT_DINF;
        int nv = min(dm[m], min(best, via_t));
        dm_n[m] = nv;
        if (nv != dm[m]) any = 1;
      };
      for (int u = threadIdx.x; u < cu.n; u += kThreads) {
        int m, r, e0, e1;
        cu.at(u, m, r, e0, e1);
        int best = PT_DINF;
#pragma unroll 8
        for (int e = e0; e < e1; ++e) {
          int l = p.Lr[e * M + m];
          best = l != PT_CLOSED ? min(best, l + de[e]) : best;
        }
        if (cu.segs == 1) col_finish(m, best);
        else col_part[u] = best;
      }
      if (ru.segs > 1 || cu.segs > 1) {
        __syncthreads();
        if (ru.segs > 1) {
          for (int e = threadIdx.x; e < E; e += kThreads) {
            int best = row_part[e];
            for (int r = 1; r < ru.segs; ++r) best = min(best, row_part[r * E + e]);
            row_finish(e, best);
          }
        }
        if (cu.segs > 1) {
          for (int m = threadIdx.x; m < M; m += kThreads) {
            int best = col_part[m];
            for (int r = 1; r < cu.segs; ++r) best = min(best, col_part[r * M + m]);
            col_finish(m, best);
          }
        }
      }
      // Sink: via reverse machine arcs and reverse fallback arcs.  One
      // fused reduction carries the sink minimum and the change flag; its
      // barriers also publish de_n and dm_n for the next sweep.
      int tb = PT_DINF;
      for (int m = threadIdx.x; m < M; m += kThreads)
        if (p.Fmt[m] > 0) tb = min(tb, pt_floordiv(-(p.pm[m] - pt), dv) + 1 + dm[m]);
      for (int e = threadIdx.x; e < E; e += kThreads)
        if (p.Ffb[e] > 0) tb = min(tb, pt_floordiv(-(__ldg(p.U + e) + p.pe[e] - pt), dv) + 1 + de[e]);
      red = pt_block_reduce(Sweep{tb, any}, SweepOp(), Sweep{PT_DINF, 0}, scratch<Sweep>(s));
      int dt_n = min(dt, red.tb);
      if (dt_n != dt) dt_moved = true;
      dt = dt_n;
      int* tmp = de; de = de_n; de_n = tmp;
      tmp = dm; dm = dm_n; dm_n = tmp;
    }
    changed = red.any != 0 || dt_moved;
    sweeps += 4;
  }
  int fm = 0;
  for (int e = threadIdx.x; e < E; e += kThreads) if (de[e] < PT_DINF) fm = max(fm, de[e]);
  for (int m = threadIdx.x; m < M; m += kThreads) if (dm[m] < PT_DINF) fm = max(fm, dm[m]);
  if (dt < PT_DINF) fm = max(fm, dt);
  fm = pt_block_reduce(fm, PtMax(), 0, scratch<int>(s));
  bool ok = !changed && fm < (1 << 26) / max(eps, 1);
  if (ok) {
    int dbig = fm + 1;
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int d = de[e] >= PT_DINF ? dbig : de[e];
      p.pe[e] = max(p.pe[e] - eps * d, PT_NEG_HALF);
    }
    for (int m = threadIdx.x; m < M; m += kThreads) {
      int d = dm[m] >= PT_DINF ? dbig : dm[m];
      p.pm[m] = max(p.pm[m] - eps * d, PT_NEG_HALF);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = dt >= PT_DINF ? dbig : dt;
      s.pt = max(s.pt - eps * d, PT_NEG_HALF);
    }
  }
  __syncthreads();
  return sweeps;
}

// One push sweep + new excesses + relabel candidates (prices frozen).
__device__ void push_sweep(const Planes& p, int total, Shared& s) {
  const int E = p.E, M = p.M;
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = s.pt;
  const int exc_t = s.exc_t;
  // EC rows: machine arcs in column order, then the fallback arc.  With
  // segs > 1 the row prefix is a two-pass segmented scan: segment sums of
  // res, then each segment scanned from the exclusive sum of the segments
  // before it.  A unit's chunks are walked in batches, each batch's loads
  // issued before its scans and stores.
  const RowUnits ru(E, M);
  int* rres_part = p.part;            // segment sums of res
  int* rpush_part = p.part + kWarps;  // segment sums of the pushes
  auto row_res = [&](int e, int xe, int pe_e, int ch) {
    int m = ch * 32 + lane;
    int res = 0;
    if (m < M) {
      int idx = e * M + m;
      int rc = rc_em_at(p, idx, pe_e, p.pm[m]);
      int r = __ldg(p.Uem + idx) - p.F[idx];
      res = (rc < 0 && xe > 0) ? r : 0;
    }
    return res;
  };
  auto fb_finish = [&](int e, int pushed) {
    int left = p.exc_e[e] - pushed;
    int rfb = __ldg(p.U + e) + p.pe[e] - pt;
    p.fbp[e] = (rfb < 0 && left > 0) ? min(__ldg(p.sup + e) - p.Ffb[e], left) : 0;
  };
  if (ru.segs > 1) {
    for (int u = w; u < ru.n; u += kWarps) {
      int e, q, c0, c1;
      ru.at(u, e, q, c0, c1);
      int xe = p.exc_e[e], pe_e = p.pe[e];
      int sum = 0;
      walk<8>(c0, c1, [&](int ch) { return row_res(e, xe, pe_e, ch); },
              [&](int, int res) { sum += res; });
      sum = pt_warp_reduce(sum, PtSum());
      if (lane == 0) rres_part[u] = sum;
    }
    __syncthreads();
  }
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    int xe = p.exc_e[e], pe_e = p.pe[e];
    int carry = 0, pushed = 0;
    for (int j = 0; j < q; ++j) carry += rres_part[j * E + e];
    walk<8>(c0, c1, [&](int ch) { return row_res(e, xe, pe_e, ch); },
            [&](int ch, int res) {
              int m = ch * 32 + lane;
              int incl = pt_warp_incl_scan(res);
              int before = carry + incl - res;
              int push = max(min(res, xe - before), 0);
              if (m < M) p.P[e * M + m] = push;
              pushed += push;
              carry += __shfl_sync(PT_FULL, incl, 31);
            });
    pushed = pt_warp_reduce(pushed, PtSum());
    if (lane == 0) {
      if (ru.segs == 1) fb_finish(e, pushed);
      else rpush_part[u] = pushed;
    }
  }
  if (ru.segs > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int pushed = 0;
      for (int q = 0; q < ru.segs; ++q) pushed += rpush_part[q * E + e];
      fb_finish(e, pushed);
    }
  }
  // Sink row over [machines, ECs] (pre-push Fmt / Ffb): each thread takes
  // a contiguous run of the row, and one block scan of the runs' sums
  // gives each run its carry.
  {
    const int n = M + E;
    const int run = (n + kThreads - 1) / kThreads;
    const int i0 = min((int)threadIdx.x * run, n), i1 = min(i0 + run, n);
    auto sink_res = [&](int i) {
      if (exc_t <= 0) return 0;
      if (i < M) return (-(p.pm[i] - pt) < 0) ? p.Fmt[i] : 0;
      int e = i - M;
      return (-(__ldg(p.U + e) + p.pe[e] - pt) < 0) ? p.Ffb[e] : 0;
    };
    int local = 0;
    walk<8>(i0, i1, sink_res, [&](int, int res) { local += res; });
    int tot;
    int before = pt_block_incl_scan(local, scratch<int>(s), &tot) - local;
    walk<8>(i0, i1, sink_res, [&](int i, int res) {
      int push = max(min(res, exc_t - before), 0);
      before += res;
      if (i < M) p.tpm[i] = push;
      else p.tpe[i - M] = push;
    });
  }
  __syncthreads();
  // Machine columns: the sink arc first, then reverse arcs in EC order;
  // apply both sides' pushes and gather the column relabel candidates.
  // With segs > 1 the reverse-arc prefix down a column is a two-pass
  // segmented scan: segment sums of res, then each segment re-walked from
  // the exclusive sum of the segments above it.
  const ColUnits cu(E, M);
  int* res_part = p.part;                 // segment sums of res
  int* sum_part = p.part + kThreads;      // segment sums of the new flows
  int* cand_part = p.part + 2 * kThreads;
  int* hadm_part = p.part + 3 * kThreads;
  auto col_finish = [&](int m, const ColHead& h, int colsum, int cand, int hadm) {
    int fmt_new = h.fmt + h.mt_push - p.tpm[m];
    p.Fmt[m] = fmt_new;
    p.exc_m[m] = colsum - fmt_new;
    bool mt_open = h.cap - fmt_new > 0;
    p.hadm_m[m] = ((h.rc_mt < 0 && mt_open) || hadm) ? 1 : 0;
    p.cand_m[m] = max(mt_open ? pt : PT_NEG, cand);
  };
  if (cu.segs > 1) {
    // Pass 1: each segment's sum of res.
    for (int u = threadIdx.x; u < cu.n; u += kThreads) {
      int m, r, e0, e1;
      cu.at(u, m, r, e0, e1);
      const ColHead h = col_head(p, m, pt);
      int seg = 0;
      walk<8>(e0, e1,
              [&](int e) {
                int idx = e * M + m;
                return make_int2(p.F[idx], rc_em_at(p, idx, p.pe[e], h.pm));
              },
              [&](int, int2 v) { seg += (v.y > 0 && h.left > 0) ? v.x : 0; });
      res_part[u] = seg;
    }
    // Every segment sum is in place.  No pass-2 write below can reach a
    // pass-1 read: each unit reads and writes only its own segment of F,
    // and all of pass 1 precedes this barrier.
    __syncthreads();
  }
  // Pass 2: walk each segment from its carry, in EC order.
  for (int u = threadIdx.x; u < cu.n; u += kThreads) {
    int m, r, e0, e1;
    cu.at(u, m, r, e0, e1);
    const ColHead h = col_head(p, m, pt);
    int before = 0;
    for (int j = 0; j < r; ++j) before += res_part[j * M + m];
    int colsum = 0, cand = PT_NEG, hadm = 0;
    walk<4>(e0, e1,
            [&](int e) {
              int idx = e * M + m;
              return make_int3(p.F[idx], __ldg(p.C + idx), p.P[idx]);
            },
            [&](int e, int3 v) {
              int f = v.x, c = v.y;
              bool adm = c < PT_INF_COST;
              int pe_e = p.pe[e];
              int rc = adm ? c + pe_e - h.pm : PT_POS;
              int res = (rc > 0 && h.left > 0) ? f : 0;
              int push = max(min(res, h.left - before), 0);
              before += res;
              int fn = f + v.z - push;
              p.F[e * M + m] = fn;
              colsum += fn;
              if (rc > 0 && fn > 0) hadm = 1;
              if (fn > 0 && adm) cand = max(cand, pe_e + c);
            });
    if (cu.segs == 1) {
      col_finish(m, h, colsum, cand, hadm);
    } else {
      sum_part[u] = colsum;
      cand_part[u] = cand;
      hadm_part[u] = hadm;
    }
  }
  if (cu.segs > 1) {
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += kThreads) {
      int colsum = 0, cand = PT_NEG, hadm = 0;
      for (int r = 0; r < cu.segs; ++r) {
        colsum += sum_part[r * M + m];
        cand = max(cand, cand_part[r * M + m]);
        hadm |= hadm_part[r * M + m];
      }
      col_finish(m, col_head(p, m, pt), colsum, cand, hadm);
    }
  }
  __syncthreads();
  // EC rows, post-push: fallback flow, excess, relabel candidates.  Each
  // row unit gathers its new flows' sum, relabel candidate and
  // admissibility (the Sink fields: sum, or, max) in one warp reduction.
  Sink* row_part = reinterpret_cast<Sink*>(p.part);
  auto row_finish = [&](int e, Sink k) {
    int sup = __ldg(p.sup + e), u = __ldg(p.U + e);
    int ffb = p.Ffb[e] + p.fbp[e] - p.tpe[e];
    p.Ffb[e] = ffb;
    p.exc_e[e] = sup - k.sum - ffb;
    bool fb_open = sup - ffb > 0;
    int rfb = u + p.pe[e] - pt;
    p.hadm_e[e] = (k.hadm || (rfb < 0 && fb_open)) ? 1 : 0;
    p.cand_e[e] = max(k.cand, fb_open ? pt - u : PT_NEG);
  };
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    int pe_e = p.pe[e];
    Sink k{0, 0, PT_NEG};
    const int m1 = min(c1 * 32, M);
    for (int m = c0 * 32 + lane; m < m1; m += 32) {
      int idx = e * M + m;
      int fn = p.F[idx];
      int c = __ldg(p.C + idx);
      bool adm = c < PT_INF_COST;
      int pm_m = p.pm[m];
      int rc = adm ? c + pe_e - pm_m : PT_POS;
      bool has_em = __ldg(p.Uem + idx) - fn > 0;
      k.sum += fn;
      if (rc < 0 && has_em) k.hadm = 1;
      if (has_em && adm) k.cand = max(k.cand, pm_m - c);
    }
    k = pt_warp_reduce(k, SinkOp());
    if (lane == 0) {
      if (ru.segs == 1) row_finish(e, k);
      else row_part[u] = k;
    }
  }
  if (ru.segs > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      Sink k = row_part[e];
      for (int q = 1; q < ru.segs; ++q) k = SinkOp()(k, row_part[q * E + e]);
      row_finish(e, k);
    }
  }
  __syncthreads();
  // Sink: new excess and relabel candidates (old prices, new flows), in
  // one fused reduction.
  Sink k{0, 0, PT_NEG};
  for (int m = threadIdx.x; m < M; m += kThreads) {
    int f = p.Fmt[m];
    k.sum += f;
    if (-(p.pm[m] - pt) < 0 && f > 0) k.hadm = 1;
    if (f > 0) k.cand = max(k.cand, p.pm[m]);
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int f = p.Ffb[e];
    int u = __ldg(p.U + e);
    k.sum += f;
    if (-(u + p.pe[e] - pt) < 0 && f > 0) k.hadm = 1;
    if (f > 0) k.cand = max(k.cand, p.pe[e] + u);
  }
  k = pt_block_reduce(k, SinkOp(), Sink{0, 0, PT_NEG}, scratch<Sink>(s));
  if (threadIdx.x == 0) {
    s.exc_t = k.sum - total;
    s.hadm_t = k.hadm;
    s.cand_t = k.cand;
  }
  __syncthreads();
}

__device__ void local_relabel(const Planes& p, int eps, Shared& s) {
  for (int e = threadIdx.x; e < p.E; e += kThreads)
    p.pe[e] = pt_relabel(p.cand_e[e], p.hadm_e[e] != 0, p.exc_e[e], p.pe[e], eps);
  for (int m = threadIdx.x; m < p.M; m += kThreads)
    p.pm[m] = pt_relabel(p.cand_m[m], p.hadm_m[m] != 0, p.exc_m[m], p.pm[m], eps);
  __syncthreads();
  if (threadIdx.x == 0) s.pt = pt_relabel(s.cand_t, s.hadm_t != 0, s.exc_t, s.pt, eps);
  __syncthreads();
}

// knobs: [eps_0..eps_3, max_iter, max_iter_total, global_every, bf_max,
//         total supply, adaptive_bf]
// stats: [iters, bf_sweeps, clean, phase_iters_0..3]
__global__ void __launch_bounds__(kThreads, 1)
fused_ladder_kernel(Planes g, const int* knobs, int* stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int E = g.E, M = g.M;
  // The run's planes: g's, with pe and the BF distances de in shared
  // memory.
  Planes p = g;
  p.part = reinterpret_cast<int*>(smem + kSharedBytes);
  p.pe = p.part + kPartInts;
  p.de0 = p.pe + E;
  p.de1 = p.de0 + E;
  for (int e = threadIdx.x; e < E; e += kThreads) p.pe[e] = g.pe[e];
  const int max_iter = knobs[4], max_iter_total = knobs[5];
  const int global_every = knobs[6], bf_max = knobs[7];
  const int total = knobs[8], adaptive = knobs[9];
  if (threadIdx.x == 0) s.pt = p.pt[0];
  __syncthreads();
  int tot_it = 0, tot_bf = 0;
  for (int k = 0; k < PT_NUM_PHASES; ++k) {
    const int eps = knobs[k];
    const int pt0 = s.pt;
    if (tot_it + 64 < max_iter_total) {  // refine to the new eps
      for (int i = threadIdx.x; i < E * M; i += kThreads) {
        int e = i / M, m = i - e * M;
        int rc = rc_em_at(p, i, p.pe[e], p.pm[m]);
        if (rc < -eps) p.F[i] = __ldg(p.Uem + i);
        else if (rc > eps) p.F[i] = 0;
      }
      for (int e = threadIdx.x; e < E; e += kThreads) {
        int rc = __ldg(p.U + e) + p.pe[e] - pt0;
        if (rc < -eps) p.Ffb[e] = __ldg(p.sup + e);
        else if (rc > eps) p.Ffb[e] = 0;
      }
      for (int m = threadIdx.x; m < M; m += kThreads) {
        int rc = p.pm[m] - pt0;
        if (rc < -eps) p.Fmt[m] = __ldg(p.cap + m);
        else if (rc > eps) p.Fmt[m] = 0;
      }
      __syncthreads();
    }
    excesses(p, total, s);
    int it = 0, bf = 0;
    int next_gu = 0, gap = global_every, last_exc = 0;
    while (true) {
      // Entering state: activity and the saturating active-excess total,
      // in one fused reduction.
      Enter en{0, 0};
      for (int e = threadIdx.x; e < E; e += kThreads) {
        int x = p.exc_e[e];
        en.pos += max(x, 0);
        en.cnt += x > 0;
      }
      for (int m = threadIdx.x; m < M; m += kThreads) {
        int x = p.exc_m[m];
        en.pos += max(x, 0);
        en.cnt += x > 0 ? kColUnit : 0;
      }
      en = pt_block_reduce(en, EnterOp(), Enter{0, 0}, scratch<Enter>(s));
      const int exc_t = s.exc_t;
      bool active = (en.cnt != 0 || exc_t > 0) && it < max_iter && tot_it + it < max_iter_total;
      if (!active) break;
      const long long pos = en.pos + max(exc_t, 0);
      int tot_excess = pt_saturate(pos);
      bool fired = adaptive > 0 ? it >= next_gu : it % global_every == 0;
      if (p.ring != nullptr && threadIdx.x == 0) {
        // The sample of the entering state (the reference's _telem_vals).
        s.tel[kTrIter] = tot_it + it;
        s.tel[kTrExcess] = tot_excess;
        s.tel[kTrRows] = en.cnt & (kColUnit - 1);
        s.tel[kTrCols] = en.cnt >> 16;
        s.tel[kTrEps] = eps;
        s.tel[kTrGu] = fired ? 1 : 0;
        s.tel[kTrBf] = 0;
        s.tel[kTrSat] = pos >= PT_EXCESS_SAT_THRESH ? 1 : 0;
      }
      push_sweep(p, total, s);
      if (fired) {
        const int sweeps = global_update(p, eps, bf_max, s);
        bf += sweeps;
        if (p.ring != nullptr && threadIdx.x == 0) s.tel[kTrBf] = sweeps;
        int gap_f = tot_excess <= last_exc / 2 ? min(gap * 2, global_every * 4) : global_every;
        next_gu = it + gap_f;
        gap = gap_f;
        last_exc = tot_excess;
      } else {
        local_relabel(p, eps, s);
      }
      if (p.ring != nullptr && threadIdx.x == 0) {
        const int cap = p.ring_cap;
        int* r = p.ring + s.tel[kTrIter] % cap;
#pragma unroll
        for (int row = 0; row < 8; ++row) r[row * cap] = s.tel[row];
      }
      ++it;
    }
    if (threadIdx.x == 0) stats[3 + k] = it;
    tot_it += it;
    tot_bf += bf;
  }
  excesses(p, total, s);
  int nz = 0;
  for (int e = threadIdx.x; e < E; e += kThreads) nz |= p.exc_e[e] != 0;
  for (int m = threadIdx.x; m < M; m += kThreads) nz |= p.exc_m[m] != 0;
  nz = pt_block_reduce(nz, PtOr(), 0, scratch<int>(s));
  for (int e = threadIdx.x; e < E; e += kThreads) g.pe[e] = p.pe[e];
  if (threadIdx.x == 0) {
    stats[0] = tot_it;
    stats[1] = tot_bf;
    stats[2] = (nz == 0 && s.exc_t == 0) ? 1 : 0;
    p.pt[0] = s.pt;
  }
}

// ------------------------------------------------------------ cluster path
// The same ladder over a thread-block cluster of k CTAs (see the header
// note): CTA r holds rows [r * S, r * S + S) of the planes (S = ceil(E /
// k)) in its shared memory, and every CTA holds every [M] vector.

constexpr int kMaxCtas = 16;
// A CTA's threads: half the one-SM kernel's, so that no thread spills
// (128 registers each) and a block barrier waits on 16 warps.
constexpr int kClThreads = 512;
constexpr int kClWarps = kClThreads / 32;
// Warps a row stage spreads a CTA's rows over (RowUnitsOf): a row splits
// only below 16 rows a CTA.  A row stage's lane takes four adjacent
// columns (one 16-byte load a plane), so a chunk is 128 columns.
constexpr int kClRowWarps = 16;
constexpr int kQuad = 4;
using ClRowUnits = RowUnitsOf<kClRowWarps, 32 * kQuad>;
using ClColUnits = ColUnitsOf<kClThreads>;

// A cluster reduction's value (up to 32 bytes).
struct alignas(16) Slot { unsigned char b[32]; };

// The cluster path's block scalars.  A cluster reduction runs in warp 0
// of each CTA: it reduces the CTA's partial and stores it into
// slot[parity][its rank] of every CTA; after the cluster barrier every
// thread combines its CTA's k slots in rank order.  Consecutive
// reductions alternate the parity, so a reduction's slots are written
// again only after the next barrier, by which every CTA has read them.
struct ClShared {
  Slot slot[2][kMaxCtas];
  int tel[8];  // the telemetry sample (rank 0)
};
constexpr int kClSharedBytes = 1152;
static_assert(sizeof(ClShared) <= kClSharedBytes, "ClShared outgrew its slot");

// Offsets, in ints from the start of the dynamic shared memory, of the
// cluster path's arrays (set on the host by cluster_layout).
struct ClLayout {
  // [S, M]: this CTA's rows of C, Uem and F; the push sweep's P, which a
  // global update reuses for its forward lengths Lf; the reverse lengths.
  int C, Uem, F, PL, Lr;
  // [S]: this CTA's rows.
  int U, sup, pe, Ffb, exc_e, fbp, tpe, cand_e, hadm_e, de0, de1;
  // [M]: every column, in every CTA.  A global update's dm0, dm1 and rg
  // share one span with the push sweep's tpm, cand_m, hadm_m and r2s,
  // which are dead from the sweep's column finish on when the update runs.
  int cap, pm, Fmt, exc_m, tpm, cand_m, hadm_m, dm0, dm1;
  // What the other CTAs combine into this one with reductions, read and
  // reset to the identity after the cluster barrier: r1 [M + 1], column
  // sums (all CTAs' in the excesses, the CTAs' above in the push sweep's
  // column prefix) and [M] the sink-row sums of the CTAs above; r2s, r2c
  // and r2h [M], the push sweep's column partials (flow sum, candidate,
  // admissible arc); rg [2, M], a Bellman-Ford sweep's column minima, by
  // parity.
  int r1, r2s, r2c, r2h, rg;
  int part;   // [4 * kClWarps] row-segment partials
  int cpart;  // [4, kClThreads] column-segment partials (ColUnits)
  int ints;   // the whole size
};

ClLayout cluster_layout(int E, int M, int k) {
  const int S = (E + k - 1) / k;
  ClLayout L;
  int o = kClSharedBytes / 4;
  // Every array starts on 16 bytes (the row stages' four-column loads).
  auto take = [&](int n) { int at = o; o += (n + 3) & ~3; return at; };
  L.C = take(S * M); L.Uem = take(S * M); L.F = take(S * M);
  L.PL = take(S * M); L.Lr = take(S * M);
  L.U = take(S); L.sup = take(S); L.pe = take(S); L.Ffb = take(S);
  L.exc_e = take(S); L.fbp = take(S); L.tpe = take(S); L.cand_e = take(S);
  L.hadm_e = take(S); L.de0 = take(S); L.de1 = take(S);
  L.cap = take(M); L.pm = take(M); L.Fmt = take(M); L.exc_m = take(M);
  const int span = take(4 * M);
  L.tpm = span; L.cand_m = span + M; L.hadm_m = span + 2 * M; L.r2s = span + 3 * M;
  L.dm0 = span; L.dm1 = span + M; L.rg = span + 2 * M;
  L.r1 = take(M + 1); L.r2c = take(M); L.r2h = take(M);
  L.part = take(4 * kClWarps);
  L.cpart = take(4 * kClThreads);
  L.ints = o;
  return L;
}

size_t cluster_smem_bytes(int E, int M, int k) {
  return sizeof(int) * (size_t)cluster_layout(E, M, k).ints;
}

namespace cl {

namespace cg = cooperative_groups;

extern __shared__ __align__(16) int sm[];

constexpr int kMinIdentity = 0x7fffffff;  // rg's identity

// A CTA's place in the cluster and the cluster-uniform scalars, held by
// every thread (each computes them alike).
struct Ctx {
  int rank, k, rows, e0, M;
  int m0, m1;  // the columns this CTA counts in a cluster-wide sum
  int sp;      // slot parity of the next reduction
  int pt, exc_t, hadm_t, cand_t;
};

__device__ __forceinline__ ClShared& shared() { return *reinterpret_cast<ClShared*>(sm); }

// Threads a column's combine spreads its sends over (each takes every
// spread-th target CTA), where the CTA has more threads than columns.
__device__ __forceinline__ int spread(int M) { return max(kClThreads / M, 1); }

// Combine v into CTA `rank`'s int at offset `off`: a reduction in the
// other CTA's shared memory that the sender does not wait on (red, not
// atom), ordered before the sender's next cluster barrier arrival.
__device__ __forceinline__ unsigned cluster_addr(int off, int rank) {
  unsigned local = (unsigned)__cvta_generic_to_shared(sm + off), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void red_add(int off, int rank, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;"
               :: "r"(cluster_addr(off, rank)), "r"(v) : "memory");
}
__device__ __forceinline__ void red_min(int off, int rank, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.min.s32 [%0], %1;"
               :: "r"(cluster_addr(off, rank)), "r"(v) : "memory");
}
__device__ __forceinline__ void red_max(int off, int rank, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.max.s32 [%0], %1;"
               :: "r"(cluster_addr(off, rank)), "r"(v) : "memory");
}
__device__ __forceinline__ void red_or(int off, int rank, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.or.b32 [%0], %1;"
               :: "r"(cluster_addr(off, rank)), "r"(v) : "memory");
}

// A cluster reduction of warp 0's values (the other warps' are not
// read): every thread calls it and gets the result.  The values must be
// in place before warp 0 reads them; the barrier publishes nothing else.
template <typename T, typename Op>
__device__ T cluster_reduce(Ctx& c, T v, Op op, T identity) {
  static_assert(sizeof(T) <= sizeof(Slot), "a slot holds 32 bytes");
  ClShared& s = shared();
  if ((threadIdx.x >> 5) == 0) {
    v = pt_warp_reduce(v, op);
    const int lane = threadIdx.x & 31;
    if (lane < c.k)
      *cg::this_cluster().map_shared_rank(reinterpret_cast<T*>(&s.slot[c.sp][c.rank]), lane) = v;
  }
  cluster_barrier();
  T r = identity;
  for (int j = 0; j < c.k; ++j) r = op(r, *reinterpret_cast<const T*>(&s.slot[c.sp][j]));
  c.sp ^= 1;
  return r;
}

// The push sweep's sink reduction fused with the next iteration's
// entering state (flows and excesses do not change until the next push).
struct SinkEnter { long long pos; int sum, hadm, cand, cnt; };
struct SinkEnterOp {
  __device__ SinkEnter operator()(SinkEnter a, SinkEnter b) const {
    return {a.pos + b.pos, a.sum + b.sum, a.hadm | b.hadm, max(a.cand, b.cand), a.cnt + b.cnt};
  }
};

// Warp 0's lanes' share of the entering state: this CTA's rows and its
// columns.
__device__ __forceinline__ void enter_add(const ClLayout& L, const Ctx& c, long long& pos, int& cnt) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < c.rows; e += 32) {
    int x = sm[L.exc_e + e];
    pos += max(x, 0);
    cnt += x > 0;
  }
  for (int m = c.m0 + lane; m < c.m1; m += 32) {
    int x = sm[L.exc_m + m];
    pos += max(x, 0);
    cnt += x > 0 ? kColUnit : 0;
  }
}

// Slab and vectors in from global memory; the push sweep's reduction
// buffers set to their identities.
__device__ void load(const Planes& g, const ClLayout& L, const Ctx& c) {
  const int M = c.M, n = c.rows * M;
  const size_t base = (size_t)c.e0 * M;
  for (int i = threadIdx.x; i < n; i += kClThreads) {
    sm[L.C + i] = __ldg(g.C + base + i);
    sm[L.Uem + i] = __ldg(g.Uem + base + i);
    sm[L.F + i] = g.F[base + i];
  }
  for (int e = threadIdx.x; e < c.rows; e += kClThreads) {
    const int ge = c.e0 + e;
    sm[L.U + e] = __ldg(g.U + ge);
    sm[L.sup + e] = __ldg(g.sup + ge);
    sm[L.pe + e] = g.pe[ge];
    sm[L.Ffb + e] = g.Ffb[ge];
  }
  for (int m = threadIdx.x; m < M; m += kClThreads) {
    sm[L.cap + m] = __ldg(g.cap + m);
    sm[L.pm + m] = g.pm[m];
    sm[L.Fmt + m] = g.Fmt[m];
    sm[L.r1 + m] = 0;
    sm[L.r2s + m] = 0;
    sm[L.r2c + m] = PT_NEG;
    sm[L.r2h + m] = 0;
  }
  if (threadIdx.x == 0) sm[L.r1 + M] = 0;
}

// Refine to eps (the one-SM kernel's refine, on the slab and the [M]
// vectors).
__device__ void refine(const ClLayout& L, const Ctx& c, int eps, int pt0) {
  const int M = c.M;
  for (int i = threadIdx.x; i < c.rows * M; i += kClThreads) {
    int e = i / M, m = i - e * M;
    int rc = rc_em(sm[L.C + i], sm[L.pe + e], sm[L.pm + m]);
    if (rc < -eps) sm[L.F + i] = sm[L.Uem + i];
    else if (rc > eps) sm[L.F + i] = 0;
  }
  for (int e = threadIdx.x; e < c.rows; e += kClThreads) {
    int rc = sm[L.U + e] + sm[L.pe + e] - pt0;
    if (rc < -eps) sm[L.Ffb + e] = sm[L.sup + e];
    else if (rc > eps) sm[L.Ffb + e] = 0;
  }
  for (int m = threadIdx.x; m < M; m += kClThreads) {
    int rc = sm[L.pm + m] - pt0;
    if (rc < -eps) sm[L.Fmt + m] = sm[L.cap + m];
    else if (rc > eps) sm[L.Fmt + m] = 0;
  }
  __syncthreads();
}

// Excesses from the flow state: exc_e (this CTA's rows), exc_m (every
// column, from the CTAs' column sums) and c.exc_t.  One cluster barrier.
__device__ void excesses(const ClLayout& L, Ctx& c, int total) {
  const int M = c.M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = w; e < c.rows; e += kClWarps) {
    int acc = 0;
    for (int m = lane; m < M; m += 32) acc += sm[L.F + e * M + m];
    acc = pt_warp_reduce(acc, PtSum());
    if (lane == 0) sm[L.exc_e + e] = sm[L.sup + e] - acc - sm[L.Ffb + e];
  }
  // Machine columns: segment sums, summed per column, into r1 of every
  // CTA.
  const ClColUnits cu(c.rows, M);
  int* cpart = sm + L.cpart;
  auto send = [&](int m, int acc, int t, int T) {
    if (acc != 0)
      for (int j = t; j < c.k; j += T) red_add(L.r1 + m, j, acc);
  };
  for (int u = threadIdx.x; u < cu.n; u += kClThreads) {
    int m, r, e0, e1;
    cu.at(u, m, r, e0, e1);
    int acc = 0;
    for (int e = e0; e < e1; ++e) acc += sm[L.F + e * M + m];
    if (cu.segs == 1) send(m, acc, 0, 1);
    else cpart[u] = acc;
  }
  if (cu.segs > 1) {
    __syncthreads();
    const int T = spread(M);
    for (int v = threadIdx.x; v < T * M; v += kClThreads) {
      const int t = v / M, m = v - t * M;
      int acc = 0;
      for (int r = 0; r < cu.segs; ++r) acc += cpart[r * M + m];
      send(m, acc, t, T);
    }
  }
  int part = 0;
  if (w == 0) {
    for (int e = lane; e < c.rows; e += 32) part += sm[L.Ffb + e];
    for (int m = c.m0 + lane; m < c.m1; m += 32) part += sm[L.Fmt + m];
  }
  c.exc_t = cluster_reduce(c, part, PtSum(), 0) - total;
  for (int m = threadIdx.x; m < M; m += kClThreads) {
    sm[L.exc_m + m] = sm[L.r1 + m] - sm[L.Fmt + m];
    sm[L.r1 + m] = 0;
  }
  __syncthreads();
}


// Four adjacent ints of the shared memory (16-byte aligned).
__device__ __forceinline__ int4 quad(int off) { return *reinterpret_cast<const int4*>(sm + off); }
__device__ __forceinline__ void set_quad(int off, int4 v) { *reinterpret_cast<int4*>(sm + off) = v; }
__device__ __forceinline__ int at4(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ ColHead col_head_cl(const ClLayout& L, int m, int pt) {
  return col_head_of(sm[L.exc_m + m], sm[L.pm + m], sm[L.Fmt + m], sm[L.cap + m], pt);
}

// The row prefix pushes along this CTA's EC rows (the one-SM kernel's row
// pass, segments and all): P and fbp.  A lane takes four adjacent
// columns of a 128-column chunk: their res, their own inclusive prefix,
// and one warp scan of the lanes' sums a chunk.
__device__ void push_rows(const ClLayout& L, const Ctx& c) {
  const int M = c.M, pt = c.pt, rows = c.rows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ClRowUnits ru(rows, M);
  int* rres_part = sm + L.part;
  int* rpush_part = sm + L.part + kClWarps;
  // The res of the lane's four columns of chunk ch (0 past M).
  auto row_res = [&](int e, int xe, int pe_e, int ch) {
    const int m = (ch * 32 + lane) * kQuad;
    int4 r = make_int4(0, 0, 0, 0);
    if (m < M && xe > 0) {
      const int idx = e * M + m;
      const int4 cst = quad(L.C + idx), u = quad(L.Uem + idx), f = quad(L.F + idx);
      const int4 pm = quad(L.pm + m);
      r.x = rc_em(cst.x, pe_e, pm.x) < 0 ? u.x - f.x : 0;
      r.y = rc_em(cst.y, pe_e, pm.y) < 0 ? u.y - f.y : 0;
      r.z = rc_em(cst.z, pe_e, pm.z) < 0 ? u.z - f.z : 0;
      r.w = rc_em(cst.w, pe_e, pm.w) < 0 ? u.w - f.w : 0;
    }
    return r;
  };
  auto fb_finish = [&](int e, int pushed) {
    int left = sm[L.exc_e + e] - pushed;
    int rfb = sm[L.U + e] + sm[L.pe + e] - pt;
    sm[L.fbp + e] = (rfb < 0 && left > 0) ? min(sm[L.sup + e] - sm[L.Ffb + e], left) : 0;
  };
  if (ru.segs > 1) {
    for (int u = w; u < ru.n; u += kClWarps) {
      int e, q, c0, c1;
      ru.at(u, e, q, c0, c1);
      int xe = sm[L.exc_e + e], pe_e = sm[L.pe + e];
      int sum = 0;
      for (int ch = c0; ch < c1; ++ch) {
        const int4 r = row_res(e, xe, pe_e, ch);
        sum += r.x + r.y + r.z + r.w;
      }
      sum = pt_warp_reduce(sum, PtSum());
      if (lane == 0) rres_part[u] = sum;
    }
    __syncthreads();
  }
  for (int u = w; u < ru.n; u += kClWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    int xe = sm[L.exc_e + e], pe_e = sm[L.pe + e];
    int carry = 0, pushed = 0;
    for (int j = 0; j < q; ++j) carry += rres_part[j * rows + e];
    for (int ch = c0; ch < c1; ++ch) {
      const int m = (ch * 32 + lane) * kQuad;
      const int4 r = row_res(e, xe, pe_e, ch);
      const int s1 = r.x, s2 = s1 + r.y, s3 = s2 + r.z, s4 = s3 + r.w;
      const int incl = pt_warp_incl_scan(s4);
      const int before = carry + incl - s4;  // res of the row's columns before m
      int4 p;
      p.x = max(min(r.x, xe - before), 0);
      p.y = max(min(r.y, xe - (before + s1)), 0);
      p.z = max(min(r.z, xe - (before + s2)), 0);
      p.w = max(min(r.w, xe - (before + s3)), 0);
      if (m < M) set_quad(L.PL + e * M + m, p);
      pushed += p.x + p.y + p.z + p.w;
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
    pushed = pt_warp_reduce(pushed, PtSum());
    if (lane == 0) {
      if (ru.segs == 1) fb_finish(e, pushed);
      else rpush_part[u] = pushed;
    }
  }
  if (ru.segs > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < rows; e += kClThreads) {
      int pushed = 0;
      for (int q = 0; q < ru.segs; ++q) pushed += rpush_part[q * rows + e];
      fb_finish(e, pushed);
    }
  }
}

// One push sweep + new excesses + relabel candidates (prices frozen).
// Three cluster barriers: after the column prefix's pass-1 sums (split:
// the sink row's machine part runs between its halves), after the
// columns' pass-2 partials (split: the rows' post-push pass runs between
// its halves), and in the sink reduction fused with the next entering
// state, which it returns.
__device__ Enter push_sweep(const ClLayout& L, Ctx& c, int total, bool fired) {
  const int M = c.M, rows = c.rows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = c.pt, exc_t = c.exc_t;
  push_rows(L, c);
  // The sink row over [machines, ECs] (pre-push Fmt / Ffb) runs in the
  // last warp: this slab's sum of the EC part into r1[M] of the CTAs
  // below; inside the first barrier the machine part (the same in every
  // CTA) as a chain of warp scans; after it the slab's pushes from the
  // machine total plus the slabs above.
  constexpr int kSinkWarp = kClWarps - 1;
  auto sink_res_e = [&](int e) {
    if (exc_t <= 0) return 0;
    return (-(sm[L.U + e] + sm[L.pe + e] - pt) < 0) ? sm[L.Ffb + e] : 0;
  };
  int tm = 0;  // the machine part's total (the sink warp)
  if (w == kSinkWarp) {
    int acc = 0;
    for (int e = lane; e < rows; e += 32) acc += sink_res_e(e);
    acc = pt_warp_reduce(acc, PtSum());
    if (acc != 0 && lane > c.rank && lane < c.k) red_add(L.r1 + M, lane, acc);
  }
  // Machine columns, pass 1: each (column, row segment) unit's sum of
  // res; the slab's sum per column into r1 of the CTAs below.
  const ClColUnits cu(rows, M);
  int* res_part = sm + L.cpart;                 // segment sums of res
  int* sum_part = sm + L.cpart + kClThreads;      // segment sums of the new flows
  int* cand_part = sm + L.cpart + 2 * kClThreads;
  int* hadm_part = sm + L.cpart + 3 * kClThreads;
  auto send_res = [&](int m, int seg, int t, int T) {
    if (seg != 0)
      for (int j = c.rank + 1 + t; j < c.k; j += T) red_add(L.r1 + m, j, seg);
  };
  for (int u = threadIdx.x; u < cu.n; u += kClThreads) {
    int m, r, e0, e1;
    cu.at(u, m, r, e0, e1);
    const ColHead h = col_head_cl(L, m, pt);
    int seg = 0;
    for (int e = e0; e < e1; ++e) {
      int idx = e * M + m;
      int rc = rc_em(sm[L.C + idx], sm[L.pe + e], h.pm);
      seg += (rc > 0 && h.left > 0) ? sm[L.F + idx] : 0;
    }
    if (cu.segs == 1) send_res(m, seg, 0, 1);
    else res_part[u] = seg;
  }
  if (cu.segs > 1) {
    __syncthreads();
    const int T = spread(M);
    for (int v = threadIdx.x; v < T * M; v += kClThreads) {
      const int t = v / M, m = v - t * M;
      int seg = 0;
      for (int r = 0; r < cu.segs; ++r) seg += res_part[r * M + m];
      send_res(m, seg, t, T);
    }
  }
  cluster_arrive();
  if (w == kSinkWarp) {
    for (int b = 0; b < M; b += 32) {
      int i = b + lane;
      int res = (i < M && exc_t > 0 && -(sm[L.pm + i] - pt) < 0) ? sm[L.Fmt + i] : 0;
      int incl = pt_warp_incl_scan(res);
      int before = tm + incl - res;
      if (i < M) sm[L.tpm + i] = max(min(res, exc_t - before), 0);
      tm += __shfl_sync(PT_FULL, incl, 31);
    }
  }
  cluster_wait();
  // Pass 2: walk each segment from the sums of the slabs above and of the
  // segments above it; the column's partials into r2 of every CTA.
  auto send_col = [&](int m, int colsum, int cand, int hadm, int t, int T) {
    for (int j = t; j < c.k; j += T) {
      if (colsum != 0) red_add(L.r2s + m, j, colsum);
      if (cand != PT_NEG) red_max(L.r2c + m, j, cand);
      if (hadm) red_or(L.r2h + m, j, hadm);
    }
  };
  for (int u = threadIdx.x; u < cu.n; u += kClThreads) {
    int m, r, e0, e1;
    cu.at(u, m, r, e0, e1);
    const ColHead h = col_head_cl(L, m, pt);
    int before = sm[L.r1 + m];
    for (int j = 0; j < r; ++j) before += res_part[j * M + m];
    if (cu.segs == 1) sm[L.r1 + m] = 0;
    int colsum = 0, cand = PT_NEG, hadm = 0;
    for (int e = e0; e < e1; ++e) {
      int idx = e * M + m;
      int f = sm[L.F + idx], cst = sm[L.C + idx];
      bool adm = cst < PT_INF_COST;
      int pe_e = sm[L.pe + e];
      int rc = adm ? cst + pe_e - h.pm : PT_POS;
      int res = (rc > 0 && h.left > 0) ? f : 0;
      int push = max(min(res, h.left - before), 0);
      before += res;
      int fn = f + sm[L.PL + idx] - push;
      sm[L.F + idx] = fn;
      colsum += fn;
      if (rc > 0 && fn > 0) hadm = 1;
      if (fn > 0 && adm) cand = max(cand, pe_e + cst);
    }
    if (cu.segs == 1) {
      send_col(m, colsum, cand, hadm, 0, 1);
    } else {
      sum_part[u] = colsum;
      cand_part[u] = cand;
      hadm_part[u] = hadm;
    }
  }
  // The slab's sink pushes to its EC fallbacks, in row order.
  if (w == kSinkWarp) {
    int carry = tm + sm[L.r1 + M];
    __syncwarp();
    if (lane == 0) sm[L.r1 + M] = 0;
    for (int b = 0; b < rows; b += 32) {
      int e = b + lane;
      int res = e < rows ? sink_res_e(e) : 0;
      int incl = pt_warp_incl_scan(res);
      int before = carry + incl - res;
      if (e < rows) sm[L.tpe + e] = max(min(res, exc_t - before), 0);
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
  }
  __syncthreads();
  if (cu.segs > 1) {
    const int T = spread(M);
    for (int v = threadIdx.x; v < T * M; v += kClThreads) {
      const int t = v / M, m = v - t * M;
      if (t == 0) sm[L.r1 + m] = 0;
      int colsum = 0, cand = PT_NEG, hadm = 0;
      for (int r = 0; r < cu.segs; ++r) {
        colsum += sum_part[r * M + m];
        cand = max(cand, cand_part[r * M + m]);
        hadm |= hadm_part[r * M + m];
      }
      send_col(m, colsum, cand, hadm, t, T);
    }
  }
  // The CTA's partials are sent; its rows' post-push pass needs none of
  // the other CTAs', so it runs while they arrive.
  cluster_arrive();
  // EC rows, post-push (one-SM row pass): fallback flow, excess, relabel
  // candidates.
  const ClRowUnits ru(rows, M);
  Sink* row_part = reinterpret_cast<Sink*>(sm + L.part);
  auto row_finish = [&](int e, Sink k) {
    int sup = sm[L.sup + e], u = sm[L.U + e];
    int ffb = sm[L.Ffb + e] + sm[L.fbp + e] - sm[L.tpe + e];
    sm[L.Ffb + e] = ffb;
    sm[L.exc_e + e] = sup - k.sum - ffb;
    bool fb_open = sup - ffb > 0;
    int rfb = u + sm[L.pe + e] - pt;
    sm[L.hadm_e + e] = (k.hadm || (rfb < 0 && fb_open)) ? 1 : 0;
    sm[L.cand_e + e] = max(k.cand, fb_open ? pt - u : PT_NEG);
  };
  for (int u = w; u < ru.n; u += kClWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    int pe_e = sm[L.pe + e];
    Sink k{0, 0, PT_NEG};
    for (int ch = c0; ch < c1; ++ch) {
      const int m = (ch * 32 + lane) * kQuad;
      if (m >= M) continue;
      const int idx = e * M + m;
      const int4 f4 = quad(L.F + idx), c4 = quad(L.C + idx), u4 = quad(L.Uem + idx);
      const int4 pm4 = quad(L.pm + m);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const int fn = at4(f4, i), cst = at4(c4, i), pm_m = at4(pm4, i);
        const bool adm = cst < PT_INF_COST;
        const int rc = adm ? cst + pe_e - pm_m : PT_POS;
        const bool has_em = at4(u4, i) - fn > 0;
        k.sum += fn;
        if (rc < 0 && has_em) k.hadm = 1;
        if (has_em && adm) k.cand = max(k.cand, pm_m - cst);
      }
    }
    k = pt_warp_reduce(k, SinkOp());
    if (lane == 0) {
      if (ru.segs == 1) row_finish(e, k);
      else row_part[u] = k;
    }
  }
  if (ru.segs > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < rows; e += kClThreads) {
      Sink k = row_part[e];
      for (int q = 1; q < ru.segs; ++q) k = SinkOp()(k, row_part[q * rows + e]);
      row_finish(e, k);
    }
  }
  cluster_wait();
  // Every column: the CTAs' partials, then the sink arc (one-SM
  // col_finish).
  for (int m = threadIdx.x; m < M; m += kClThreads) {
    const int colsum = sm[L.r2s + m], cand = sm[L.r2c + m], hadm = sm[L.r2h + m];
    sm[L.r2s + m] = 0;
    sm[L.r2c + m] = PT_NEG;
    sm[L.r2h + m] = 0;
    const ColHead h = col_head_cl(L, m, pt);
    int fmt_new = h.fmt + h.mt_push - sm[L.tpm + m];
    sm[L.Fmt + m] = fmt_new;
    sm[L.exc_m + m] = colsum - fmt_new;
    bool mt_open = h.cap - fmt_new > 0;
    sm[L.hadm_m + m] = ((h.rc_mt < 0 && mt_open) || hadm) ? 1 : 0;
    sm[L.cand_m + m] = max(mt_open ? pt : PT_NEG, cand);
  }
  __syncthreads();
  // A global update follows: its column minima's buffers (over hadm_m
  // and r2s, read above) to their identity before the barrier that
  // precedes the other CTAs' first reductions into them.
  if (fired)
    for (int m = threadIdx.x; m < 2 * M; m += kClThreads) sm[L.rg + m] = kMinIdentity;
  // Sink: new excess and relabel candidates (old prices, new flows), and
  // the next entering state, in one cluster reduction.
  SinkEnter k{0, 0, 0, PT_NEG, 0};
  if (w == 0) {
    for (int m = c.m0 + lane; m < c.m1; m += 32) {
      int f = sm[L.Fmt + m], pm_m = sm[L.pm + m];
      k.sum += f;
      if (-(pm_m - pt) < 0 && f > 0) k.hadm = 1;
      if (f > 0) k.cand = max(k.cand, pm_m);
    }
    for (int e = lane; e < rows; e += 32) {
      int f = sm[L.Ffb + e], u = sm[L.U + e], pe_e = sm[L.pe + e];
      k.sum += f;
      if (-(u + pe_e - pt) < 0 && f > 0) k.hadm = 1;
      if (f > 0) k.cand = max(k.cand, pe_e + u);
    }
    enter_add(L, c, k.pos, k.cnt);
  }
  k = cluster_reduce(c, k, SinkEnterOp(), SinkEnter{0, 0, 0, PT_NEG, 0});
  c.exc_t = k.sum - total;
  c.hadm_t = k.hadm;
  c.cand_t = k.cand;
  return Enter{k.pos, k.cnt};
}

__device__ void local_relabel(const ClLayout& L, Ctx& c, int eps) {
  for (int e = threadIdx.x; e < c.rows; e += kClThreads)
    sm[L.pe + e] = pt_relabel(sm[L.cand_e + e], sm[L.hadm_e + e] != 0, sm[L.exc_e + e],
                              sm[L.pe + e], eps);
  for (int m = threadIdx.x; m < c.M; m += kClThreads)
    sm[L.pm + m] = pt_relabel(sm[L.cand_m + m], sm[L.hadm_m + m] != 0, sm[L.exc_m + m],
                              sm[L.pm + m], eps);
  c.pt = pt_relabel(c.cand_t, c.hadm_t != 0, c.exc_t, c.pt, eps);
  __syncthreads();
}

// Global price update (the one-SM global_update) on the post-push state
// with the frozen prices.  One cluster barrier a sweep: the CTAs' column
// minima (reductions) and the sink's partial cross together, and every CTA
// finishes every column.  Returns the BF sweeps spent.
__device__ int global_update(const ClLayout& L, Ctx& c, int eps, int bf_max) {
  const int M = c.M, rows = c.rows;
  const int pt = c.pt;
  const PtDivisor dv(eps);
  {
    const PtDivisor dM(M);
    for (int i = threadIdx.x; i < rows * M; i += kClThreads) {
      int e = pt_floordiv(i, dM), m = i - e * M;
      int cst = sm[L.C + i];
      int f = sm[L.F + i];
      bool adm = cst < PT_INF_COST;
      int x = cst + sm[L.pe + e] - sm[L.pm + m];
      int lf = adm ? pt_floordiv(x, dv) + 1 : PT_DINF;
      int lr = adm ? pt_floordiv(-x, dv) + 1 : PT_DINF;
      sm[L.PL + i] = sm[L.Uem + i] - f > 0 ? lf : PT_CLOSED;
      sm[L.Lr + i] = f > 0 ? lr : PT_CLOSED;
    }
  }
  int de = L.de0, de_n = L.de1, dm = L.dm0, dm_n = L.dm1;
  for (int e = threadIdx.x; e < rows; e += kClThreads) sm[de + e] = sm[L.exc_e + e] < 0 ? 0 : PT_DINF;
  for (int m = threadIdx.x; m < M; m += kClThreads) sm[dm + m] = sm[L.exc_m + m] < 0 ? 0 : PT_DINF;
  int dt = c.exc_t < 0 ? 0 : PT_DINF;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ClRowUnits ru(rows, M);
  const ClColUnits cu(rows, M);
  int* row_part = sm + L.part;
  int* col_part = sm + L.cpart;
  int sweeps = 0, par = 0;
  bool changed = true;
  while (changed && sweeps <= bf_max) {
    int any = 0;    // this thread's rows moved (any sweep of the four)
    int any_m = 0;  // this thread's columns moved
    bool dt_moved = false;
    Sweep red{PT_DINF, 0};
    for (int k4 = 0; k4 < 4; ++k4) {
      // EC rows: via machines (forward arcs) and via the fallback arc.
      auto row_finish = [&](int e, int best) {
        int rfb = sm[L.U + e] + sm[L.pe + e] - pt;
        int via_t = (sm[L.sup + e] - sm[L.Ffb + e] > 0) ? pt_floordiv(rfb, dv) + 1 + dt : PT_DINF;
        int nv = min(sm[de + e], min(best, via_t));
        sm[de_n + e] = nv;
        if (nv != sm[de + e]) any = 1;
      };
      for (int u = w; u < ru.n; u += kClWarps) {
        int e, q, c0, c1;
        ru.at(u, e, q, c0, c1);
        int best = PT_DINF;
        for (int ch = c0; ch < c1; ++ch) {
          const int m = (ch * 32 + lane) * kQuad;
          if (m >= M) continue;
          const int4 l4 = quad(L.PL + e * M + m), d4 = quad(dm + m);
#pragma unroll
          for (int i = 0; i < kQuad; ++i) {
            const int l = at4(l4, i);
            best = l != PT_CLOSED ? min(best, l + at4(d4, i)) : best;
          }
        }
        best = pt_warp_reduce(best, PtMin());
        if (lane == 0) {
          if (ru.segs == 1) row_finish(e, best);
          else row_part[u] = best;
        }
      }
      // Machine columns: this slab's minima via reverse arcs, per
      // (column, row segment) unit, finished per column into rg of every
      // CTA.
      const int rg = L.rg + par * M;
      auto send_min = [&](int m, int best, int t, int T) {
        // A minimum of PT_DINF or more cannot lower dm (<= PT_DINF).
        if (best < PT_DINF)
          for (int j = t; j < c.k; j += T) red_min(rg + m, j, best);
      };
      for (int u = threadIdx.x; u < cu.n; u += kClThreads) {
        int m, r, e0, e1;
        cu.at(u, m, r, e0, e1);
        int best = PT_DINF;
        for (int e = e0; e < e1; ++e) {
          int l = sm[L.Lr + e * M + m];
          best = l != PT_CLOSED ? min(best, l + sm[de + e]) : best;
        }
        if (cu.segs == 1) send_min(m, best, 0, 1);
        else col_part[u] = best;
      }
      if (ru.segs > 1) {
        __syncthreads();
        for (int e = threadIdx.x; e < rows; e += kClThreads) {
          int best = row_part[e];
          for (int r = 1; r < ru.segs; ++r) best = min(best, row_part[r * rows + e]);
          row_finish(e, best);
        }
      }
      const int any_rows = __syncthreads_or(any);
      if (cu.segs > 1) {
        const int T = spread(M);
        for (int v = threadIdx.x; v < T * M; v += kClThreads) {
          const int t = v / M, m = v - t * M;
          int best = col_part[m];
          for (int r = 1; r < cu.segs; ++r) best = min(best, col_part[r * M + m]);
          send_min(m, best, t, T);
        }
      }
      // Sink: via reverse machine arcs (this CTA's columns) and reverse
      // fallback arcs (its rows), in warp 0.
      int tb = PT_DINF;
      if (w == 0) {
        for (int m = c.m0 + lane; m < c.m1; m += 32)
          if (sm[L.Fmt + m] > 0) tb = min(tb, pt_floordiv(-(sm[L.pm + m] - pt), dv) + 1 + sm[dm + m]);
        for (int e = lane; e < rows; e += 32)
          if (sm[L.Ffb + e] > 0)
            tb = min(tb, pt_floordiv(-(sm[L.U + e] + sm[L.pe + e] - pt), dv) + 1 + sm[de + e]);
      }
      red = cluster_reduce(c, Sweep{tb, any_rows}, SweepOp(), Sweep{PT_DINF, 0});
      // Every column: the CTAs' minima, and via the sink arc.
      for (int m = threadIdx.x; m < M; m += kClThreads) {
        const int best = sm[rg + m];
        sm[rg + m] = kMinIdentity;
        int via_t = (sm[L.cap + m] - sm[L.Fmt + m] > 0)
                        ? pt_floordiv(sm[L.pm + m] - pt, dv) + 1 + dt : PT_DINF;
        int nv = min(sm[dm + m], min(best, via_t));
        sm[dm_n + m] = nv;
        if (nv != sm[dm + m]) any_m = 1;
      }
      int dt_n = min(dt, red.tb);
      if (dt_n != dt) dt_moved = true;
      dt = dt_n;
      int tmp = de; de = de_n; de_n = tmp;
      tmp = dm; dm = dm_n; dm_n = tmp;
      par ^= 1;
      if (k4 < 3) __syncthreads();
      else any_m = __syncthreads_or(any_m);
    }
    changed = red.any != 0 || any_m != 0 || dt_moved;
    sweeps += 4;
  }
  int fm = 0;
  if (w == 0) {
    for (int e = lane; e < rows; e += 32) if (sm[de + e] < PT_DINF) fm = max(fm, sm[de + e]);
    for (int m = c.m0 + lane; m < c.m1; m += 32) if (sm[dm + m] < PT_DINF) fm = max(fm, sm[dm + m]);
    if (dt < PT_DINF) fm = max(fm, dt);
  }
  fm = cluster_reduce(c, fm, PtMax(), 0);
  bool ok = !changed && fm < (1 << 26) / max(eps, 1);
  if (ok) {
    int dbig = fm + 1;
    for (int e = threadIdx.x; e < rows; e += kClThreads) {
      int d = sm[de + e] >= PT_DINF ? dbig : sm[de + e];
      sm[L.pe + e] = max(sm[L.pe + e] - eps * d, PT_NEG_HALF);
    }
    for (int m = threadIdx.x; m < M; m += kClThreads) {
      int d = sm[dm + m] >= PT_DINF ? dbig : sm[dm + m];
      sm[L.pm + m] = max(sm[L.pm + m] - eps * d, PT_NEG_HALF);
    }
    int d = dt >= PT_DINF ? dbig : dt;
    c.pt = max(c.pt - eps * d, PT_NEG_HALF);
  }
  __syncthreads();
  // r2s (under rg's second parity) back to its identity for the next
  // push sweep's column partials.
  for (int m = threadIdx.x; m < M; m += kClThreads) sm[L.r2s + m] = 0;
  return sweeps;
}

// knobs and stats as fused_ladder_kernel's.
__global__ void __launch_bounds__(kClThreads, 1)
fused_ladder_cluster_kernel(Planes g, ClLayout L, const int* knobs, int* stats) {
  cg::cluster_group cluster = cg::this_cluster();
  ClShared& s = shared();
  Ctx c;
  c.rank = (int)cluster.block_rank();
  c.k = (int)cluster.num_blocks();
  c.M = g.M;
  const int E = g.E, M = g.M;
  const int S = (E + c.k - 1) / c.k;
  c.e0 = min(c.rank * S, E);
  c.rows = min(S, E - c.e0);
  const int share = (M + c.k - 1) / c.k;
  c.m0 = min(c.rank * share, M);
  c.m1 = min(c.m0 + share, M);
  c.sp = 0;
  c.exc_t = c.hadm_t = 0;
  c.cand_t = PT_NEG;
  load(g, L, c);
  c.pt = g.pt[0];
  const bool tel = g.ring != nullptr && c.rank == 0 && threadIdx.x == 0;
  const int max_iter = knobs[4], max_iter_total = knobs[5];
  const int global_every = knobs[6], bf_max = knobs[7];
  const int total = knobs[8], adaptive = knobs[9];
  // Every CTA of the cluster runs and holds its slab before any touches
  // another's shared memory.
  cluster_barrier();
  int tot_it = 0, tot_bf = 0;
  for (int k = 0; k < PT_NUM_PHASES; ++k) {
    const int eps = knobs[k];
    if (tot_it + 64 < max_iter_total) refine(L, c, eps, c.pt);
    excesses(L, c, total);
    Enter en{0, 0};
    if (threadIdx.x < 32) enter_add(L, c, en.pos, en.cnt);
    en = cluster_reduce(c, en, EnterOp(), Enter{0, 0});
    int it = 0, bf = 0;
    int next_gu = 0, gap = global_every, last_exc = 0;
    while (true) {
      const int exc_t = c.exc_t;
      bool active = (en.cnt != 0 || exc_t > 0) && it < max_iter && tot_it + it < max_iter_total;
      if (!active) break;
      const long long pos = en.pos + max(exc_t, 0);
      int tot_excess = pt_saturate(pos);
      bool fired = adaptive > 0 ? it >= next_gu : it % global_every == 0;
      if (tel) {
        s.tel[kTrIter] = tot_it + it;
        s.tel[kTrExcess] = tot_excess;
        s.tel[kTrRows] = en.cnt & (kColUnit - 1);
        s.tel[kTrCols] = en.cnt >> 16;
        s.tel[kTrEps] = eps;
        s.tel[kTrGu] = fired ? 1 : 0;
        s.tel[kTrBf] = 0;
        s.tel[kTrSat] = pos >= PT_EXCESS_SAT_THRESH ? 1 : 0;
      }
      en = push_sweep(L, c, total, fired);
      if (fired) {
        const int sweeps = global_update(L, c, eps, bf_max);
        bf += sweeps;
        if (tel) s.tel[kTrBf] = sweeps;
        int gap_f = tot_excess <= last_exc / 2 ? min(gap * 2, global_every * 4) : global_every;
        next_gu = it + gap_f;
        gap = gap_f;
        last_exc = tot_excess;
      } else {
        local_relabel(L, c, eps);
      }
      if (tel) {
        const int cap = g.ring_cap;
        int* r = g.ring + s.tel[kTrIter] % cap;
#pragma unroll
        for (int row = 0; row < 8; ++row) r[row * cap] = s.tel[row];
      }
      ++it;
    }
    if (c.rank == 0 && threadIdx.x == 0) stats[3 + k] = it;
    tot_it += it;
    tot_bf += bf;
  }
  excesses(L, c, total);
  int nz = 0;
  if (threadIdx.x < 32) {
    for (int e = threadIdx.x; e < c.rows; e += 32) nz |= sm[L.exc_e + e] != 0;
    for (int m = c.m0 + threadIdx.x; m < c.m1; m += 32) nz |= sm[L.exc_m + m] != 0;
  }
  nz = cluster_reduce(c, nz, PtOr(), 0);
  // Back to global memory: each CTA its rows, rank 0 the [M] vectors.
  const size_t base = (size_t)c.e0 * M;
  for (int i = threadIdx.x; i < c.rows * M; i += kClThreads) g.F[base + i] = sm[L.F + i];
  for (int e = threadIdx.x; e < c.rows; e += kClThreads) {
    g.Ffb[c.e0 + e] = sm[L.Ffb + e];
    g.pe[c.e0 + e] = sm[L.pe + e];
  }
  if (c.rank == 0) {
    for (int m = threadIdx.x; m < M; m += kClThreads) {
      g.Fmt[m] = sm[L.Fmt + m];
      g.pm[m] = sm[L.pm + m];
    }
    if (threadIdx.x == 0) {
      stats[0] = tot_it;
      stats[1] = tot_bf;
      stats[2] = (nz == 0 && c.exc_t == 0) ? 1 : 0;
      g.pt[0] = c.pt;
    }
  }
}

}  // namespace cl

}  // namespace

// The launch's dynamic shared memory in bytes for E EC rows (mirrored by
// ops/transport_fused.py::ladder_smem_bytes).
extern "C" size_t pt_fused_ladder_smem_bytes(int E) { return ladder_smem_bytes(E); }

// The cluster path's dynamic shared memory a CTA, in bytes, for an
// [E, M] plane over `ctas` CTAs (mirrored by
// ops/transport_fused.py::cluster_smem_bytes).
extern "C" size_t pt_fused_ladder_cluster_smem_bytes(int E, int M, int ctas) {
  return cluster_smem_bytes(E, M, ctas);
}

// How many clusters of `ctas` CTAs, with the cluster path's shared memory
// at [E, M], the card can hold at once (cudaOccupancyMaxActiveClusters);
// 0 where it cannot launch one.
extern "C" int pt_fused_ladder_max_clusters(int E, int M, int ctas) {
  if (ctas < 2 || ctas > kMaxCtas) return 0;
  const size_t smem = cluster_smem_bytes(E, M, ctas);
  if (cluster_attributes(cl::fused_ladder_cluster_kernel, ctas, smem) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(ctas, kClThreads, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, cl::fused_ladder_cluster_kernel, &cfg) != cudaSuccess)
    n = 0;
  return n;
}

// Plain C entry point.  ``ctas`` is 1 for the one-SM kernel, or the CTAs
// of the cluster path (2 to 16).  ``ws`` is, for the one-SM kernel, an
// int32 workspace of 3 * E * M + 5 * E + 6 * M elements (the cluster path
// takes none: null); ``ring`` is null or a zeroed [8, ring_cap] int32
// telemetry ring of its own; all pointers are device pointers.
extern "C" int pt_fused_ladder(const int* C, const int* U, const int* sup,
                               const int* cap, const int* Uem, int* F,
                               int* Ffb, int* Fmt, int* pe, int* pm, int* pt,
                               const int* knobs, int* stats, int* ws,
                               int* ring, int E, int M, int ring_cap, int ctas,
                               void* stream) {
  Planes p = {};
  p.C = C; p.U = U; p.sup = sup; p.cap = cap; p.Uem = Uem;
  p.F = F; p.Ffb = Ffb; p.Fmt = Fmt; p.pe = pe; p.pm = pm; p.pt = pt;
  p.E = E; p.M = M;
  p.ring = ring_cap > 0 ? ring : nullptr;
  p.ring_cap = ring_cap;
  // The entering-state counts pack rows and columns into one int.
  if (E >= kColUnit || M >= (1 << 15)) return (int)cudaErrorInvalidValue;
  if (ctas != 1) {
    if (ctas < 2 || ctas > kMaxCtas || M % kQuad != 0) return (int)cudaErrorInvalidValue;
    const ClLayout L = cluster_layout(E, M, ctas);
    const size_t smem = sizeof(int) * (size_t)L.ints;
    cudaError_t err = cluster_attributes(cl::fused_ladder_cluster_kernel, ctas, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(ctas, kClThreads, smem, (cudaStream_t)stream, attr);
    err = cudaLaunchKernelEx(&cfg, cl::fused_ladder_cluster_kernel, p, L, knobs, stats);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  int* q = ws;
  p.P = q; q += (size_t)E * M;
  p.Lf = q; q += (size_t)E * M;
  p.Lr = q; q += (size_t)E * M;
  p.exc_e = q; q += E;
  p.fbp = q; q += E;
  p.tpe = q; q += E;
  p.cand_e = q; q += E;
  p.hadm_e = q; q += E;
  p.exc_m = q; q += M;
  p.tpm = q; q += M;
  p.cand_m = q; q += M;
  p.hadm_m = q; q += M;
  p.dm0 = q; q += M;
  p.dm1 = q; q += M;
  p.de0 = p.de1 = p.part = nullptr;  // set in shared memory by the kernel
  size_t smem = ladder_smem_bytes(E);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_ladder_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(p, knobs, stats);
  return (int)cudaGetLastError();
}

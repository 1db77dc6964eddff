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

#include <cstddef>

#include "common.cuh"

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

// Fused reductions: the entering state of an iteration (its positive
// excess, and the rows and columns that carry it packed in one int: rows
// in bits 0-15, columns from bit 16), the sink's relabel inputs, and one
// Bellman-Ford sweep's sink distance with the change flag.
struct Enter { long long pos; int cnt; };
struct EnterOp {
  __device__ Enter operator()(Enter a, Enter b) const {
    return {a.pos + b.pos, a.cnt + b.cnt};
  }
};
constexpr int kColUnit = 1 << 16;

struct Sink { int sum, hadm, cand; };
struct SinkOp {
  __device__ Sink operator()(Sink a, Sink b) const {
    return {a.sum + b.sum, a.hadm | b.hadm, max(a.cand, b.cand)};
  }
};
struct Sweep { int tb, any; };
struct SweepOp {
  __device__ Sweep operator()(Sweep a, Sweep b) const {
    return {min(a.tb, b.tb), a.any | b.any};
  }
};

// Work units of the column stages: (machine column m, row segment r)
// pairs, u = r * M + m, one thread each, so a warp's lanes take
// consecutive columns and every plane load of a warp is coalesced.  Each
// column's E rows split into `segs` contiguous segments: the largest power
// of two <= E with segs * M <= kThreads, at least 1.  A narrow plane thus
// keeps every thread busy on a segment of one column, and a wide one gives
// each thread whole columns that need no partner.  With segs > 1 the
// units' partials meet in shared memory (segs * M <= kThreads ints per
// buffer), and one thread per column finishes it after one barrier.
struct ColUnits {
  int E, M, segs, seg, n;
  __device__ ColUnits(int E_, int M_) : E(E_), M(M_) {
    segs = 1;
    while (segs * 2 <= E && segs * 2 * M <= kThreads) segs *= 2;
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

// Work units of the row stages that reduce along EC rows: (row e, column
// segment q) pairs, u = q * E + e, one warp each, its lanes across the
// segment's 32-column chunks (coalesced).  Each row's chunks split into
// `segs` contiguous segments: the largest power of two <= the chunk count
// with segs * E <= kWarps, at least 1, so that with fewer than 32 rows
// every warp still has work.  With segs > 1 the warps' partials meet in
// shared memory and one thread per row finishes it after one barrier.
struct RowUnits {
  int E, chunks, segs, seg, n;
  __device__ RowUnits(int E_, int M) : E(E_), chunks((M + 31) / 32) {
    segs = 1;
    while (segs * 2 <= chunks && segs * 2 * E <= kWarps) segs *= 2;
    seg = (chunks + segs - 1) / segs;
    n = segs * E;
  }
  // Unit u's row, segment and chunks [c0, c1).
  __device__ void at(int u, int& e, int& q, int& c0, int& c1) const {
    q = u / E;
    e = u - q * E;
    c0 = min(q * seg, chunks);
    c1 = min(c0 + seg, chunks);
  }
};

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

// A machine column's sink arc, ahead of its reverse arcs in the push
// sweep: the push to the sink and what is left to push back to ECs.
struct ColHead { int pm, fmt, cap, rc_mt, mt_push, left; };

__device__ __forceinline__ ColHead col_head(const Planes& p, int m, int pt) {
  ColHead h;
  int xm = p.exc_m[m];
  h.pm = p.pm[m];
  h.fmt = p.Fmt[m];
  h.cap = __ldg(p.cap + m);
  h.rc_mt = h.pm - pt;
  h.mt_push = (h.rc_mt < 0 && xm > 0) ? min(h.cap - h.fmt, xm) : 0;
  h.left = xm - h.mt_push;
  return h;
}

__device__ __forceinline__ int rc_em_at(const Planes& p, int idx, int pe_e, int pm_m) {
  int c = __ldg(p.C + idx);
  return c < PT_INF_COST ? c + pe_e - pm_m : PT_POS;
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

}  // namespace

// The launch's dynamic shared memory in bytes for E EC rows (mirrored by
// ops/transport_fused.py::ladder_smem_bytes).
extern "C" size_t pt_fused_ladder_smem_bytes(int E) { return ladder_smem_bytes(E); }

// Plain C entry point.  ``ws`` is an int32 workspace of
// 3 * E * M + 5 * E + 6 * M elements; ``ring`` is null or a zeroed
// [8, ring_cap] int32 telemetry ring of its own; all pointers are device
// pointers.
extern "C" int pt_fused_ladder(const int* C, const int* U, const int* sup,
                               const int* cap, const int* Uem, int* F,
                               int* Ffb, int* Fmt, int* pe, int* pm, int* pt,
                               const int* knobs, int* stats, int* ws,
                               int* ring, int E, int M, int ring_cap,
                               void* stream) {
  Planes p;
  p.C = C; p.U = U; p.sup = sup; p.cap = cap; p.Uem = Uem;
  p.F = F; p.Ffb = Ffb; p.Fmt = Fmt; p.pe = pe; p.pm = pm; p.pt = pt;
  p.E = E; p.M = M;
  p.ring = ring_cap > 0 ? ring : nullptr;
  p.ring_cap = ring_cap;
  // The entering-state counts pack rows and columns into one int.
  if (E >= kColUnit || M >= (1 << 15)) return (int)cudaErrorInvalidValue;
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

// Per-iteration push/relabel kernels (B2): one synchronous push sweep, the
// new excesses and the local relabel of one iteration, for the bands too
// wide for the fused ladder kernel (the 10k-machine wave: [128, 10240]).
//
// Replaces: poseidon_tpu/ops/transport_tiled.py::_iteration_kernel (the
// Pallas TPU kernel launched by _tiled_iteration, looped by
// _pr_phase_tiled).  Bit-equal to the plain torch iteration
// (ops/transport.py::_pr_iteration followed by _phase_status).
//
// Bound on the H100: bytes.  An iteration must read the C, Uem and F
// planes once and write F once: at [128, 10240] int32 that is 21 MB, about
// 6 us at 3.35 TB/s.  The planes fit the 50 MB L2, so repeated passes hit
// L2 rather than HBM.
//
// Design.  The TPU kernel walks 512-column tiles in grid order and carries
// the cross-tile prefixes in scratch; CUDA blocks run in no order.  Both
// push allocations read only the PRE-push state, so the iteration factors
// into three passes over 2-D tiles of kTileRows x kTileCols cells, each
// pass one launch with one block per tile (320 blocks at [128, 10240]):
//   1. pt_seg:   per tile, the row segment sums of res_em (the EC rows'
//                machine pushes, in column order) and the column segment
//                sums of res_me (the machines' reverse pushes, in EC
//                order); and the sink vector's chunk sums.
//   2. pt_push:  per tile, each row's and column's prefix before the tile
//                from those sums, then ec_push and me_push exactly; F' is
//                written once; per-tile partials of the row and column
//                sums of F', the row sums of ec_push, the admissibility
//                ORs and the relabel candidates' maxima.
//   3. pt_final: one thread per entry of [machines, ECs] (the sink's own
//                order) in chunks of kChunk: the sink pushes from the
//                chunk sums, the reductions of the partials into Fmt',
//                Ffb', the excesses and the machine and EC relabels; the
//                last block to finish reduces the chunks' scalars into
//                exc_t', the sink relabel and the phase status, and
//                writes the iteration's telemetry sample.
// The convergence-telemetry ring (the reference's phase-loop ring) rides
// the last launch: the phase status (ops/transport.py, _ST_*) carries,
// besides activity, the excess total and the count, the positive rows and
// columns and the saturation bit of the state it describes, so the last
// block of pt_final writes the sample of the iteration it just ran from
// the ENTERING status, gated by its active bit: iterations past
// convergence in an unroll group write nothing.  The global-update kernel
// sets the fired bit and sweeps of its iteration's column.  No launch and
// no host read is added.
// Integer sums do not depend on how they are split, and OR and max not on
// order, so every output is bit-equal to the plain iteration.  C, Uem and
// F are read in passes 1 and 2 (pass 2 re-reads its tile from L1/L2 in
// its three stages); F' is written once.  Each thread loads all of its
// cells of a row or column before it uses them (RowCells, ColCells), so
// a pass waits for L2 about once, not once per cell.

#include "common.cuh"

namespace {

constexpr int kTileRows = 16;
constexpr int kTileCols = 256;
constexpr int kThreads = 256;  // pt_seg / pt_push: one per tile column
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = kTileCols / 32;  // a row's 32-column slices
constexpr int kChunk = 64;     // pt_final: entries (and threads) per block

unsigned long long g_kernels = 0;  // CUDA kernels launched by this library

struct Iter {
  // inputs (pre-iteration state)
  const int* C; const int* Uem; const int* U; const int* sup; const int* cap;
  const int* F; const int* Ffb; const int* Fmt; const int* pe; const int* pm;
  const int* pt; const int* exc_e; const int* exc_m; const int* exc_t;
  const int* st;
  // outputs
  int* Fo; int* Ffbo; int* Fmto; int* peo; int* pmo; int* pto;
  int* exc_eo; int* exc_mo; int* exc_to; int* sto;
  // workspace (see pt_tiled_iteration_ws_ints)
  long long* bpos;                    // [chunks] positive-excess sums
  int* rowseg; int* colseg; int* sinkseg;
  int* r_ec; int* r_sum; int* r_adm; int* r_cand;  // [col tiles][E]
  int* c_sum; int* c_adm; int* c_cand;             // [row tiles][M]
  int* bpart;                         // [chunks][4] flow, adm, cand, cnt
  unsigned* ticket;                   // [1], 0 between launches
  int* ring;                          // [8, ring_cap] telemetry, or null
  int E, M, eps, do_relabel, total, col_tiles, row_tiles, chunks;
  int ring_base, ring_cap;            // earlier phases' iterations; capacity
};

// The sink's residual toward entry i of [machines, ECs] (0 when the sink
// has no positive excess).
__device__ __forceinline__ int sink_res(const Iter& q, int i, int pt) {
  if (q.exc_t[0] <= 0 || i >= q.M + q.E) return 0;
  if (i < q.M) return (-(q.pm[i] - pt) < 0) ? q.Fmt[i] : 0;
  const int e = i - q.M;
  return (-(q.U[e] + q.pe[e] - pt) < 0) ? q.Ffb[e] : 0;
}

// A machine's excess left after its push to the sink.
__device__ __forceinline__ int machine_mt_push(const Iter& q, int m, int pt) {
  const int xm = q.exc_m[m];
  return (q.pm[m] - pt < 0 && xm > 0) ? min(q.cap[m] - q.Fmt[m], xm) : 0;
}

__device__ __forceinline__ int reduced_cost(int c, int pe, int pm, int closed) {
  return c < PT_INF_COST ? c + pe - pm : closed;
}

// One EC row's cells in a tile, lane-strided (column c0 + 32 j + lane),
// loaded up front so the loads are all in flight before their uses.  A
// column past M loads column M - 1 and is masked by ``in``.
struct RowCells {
  int c[kSlices], u[kSlices], f[kSlices], pm[kSlices];
  __device__ RowCells(const Iter& q, const int* F, int e, int m0, int lane) {
    const size_t row = (size_t)e * q.M;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int m = min(m0 + 32 * j + lane, q.M - 1);
      c[j] = __ldg(q.C + row + m);
      u[j] = __ldg(q.Uem + row + m);
      f[j] = __ldg(F + row + m);
      pm[j] = __ldg(q.pm + m);
    }
  }
  __device__ static bool in(const Iter& q, int m0, int j, int lane) {
    return m0 + 32 * j + lane < q.M;
  }
};

// One machine column's cells in a tile (rows e0 .. e0 + kTileRows - 1),
// loaded up front.  A row past E loads row E - 1 and is masked.
struct ColCells {
  int c[kTileRows], f[kTileRows];
  __device__ ColCells(const Iter& q, int e0, int m) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const size_t i = (size_t)min(e0 + r, q.E - 1) * q.M + m;
      c[r] = __ldg(q.C + i);
      f[r] = __ldg(q.F + i);
    }
  }
};

__global__ void __launch_bounds__(kThreads) pt_seg(Iter q) {
  __shared__ int scratch[32];
  __shared__ int pe_s[kTileRows];
  const int E = q.E, M = q.M, pt = q.pt[0];
  const int mb = blockIdx.x, eb = blockIdx.y;
  const int m0 = mb * kTileCols, e0 = eb * kTileRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x < kTileRows && e0 + threadIdx.x < E) pe_s[threadIdx.x] = q.pe[e0 + threadIdx.x];
  __syncthreads();
  // EC rows of the tile: the sum of res_em over the tile's columns.
  for (int r = w; r < kTileRows && e0 + r < E; r += kWarps) {
    const int e = e0 + r, xe = q.exc_e[e], pe = pe_s[r];
    int sum = 0;
    if (xe > 0) {
      const RowCells x(q, q.F, e, m0, lane);
#pragma unroll
      for (int j = 0; j < kSlices; ++j)
        if (RowCells::in(q, m0, j, lane) && reduced_cost(x.c[j], pe, x.pm[j], PT_POS) < 0)
          sum += x.u[j] - x.f[j];
    }
    sum = pt_warp_reduce(sum, PtSum());
    if (lane == 0) q.rowseg[(size_t)mb * E + e] = sum;
  }
  // Machine columns of the tile: the sum of res_me over the tile's rows.
  const int m = m0 + threadIdx.x;
  if (m < M) {
    const int left = q.exc_m[m] - machine_mt_push(q, m, pt), pm = q.pm[m];
    int sum = 0;
    if (left > 0) {
      const ColCells x(q, e0, m);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        if (e0 + r < E && reduced_cost(x.c[r], pe_s[r], pm, PT_POS) > 0) sum += x.f[r];
    }
    q.colseg[(size_t)eb * M + m] = sum;
  }
  // The sink's chunk sums, spread over the blocks.
  const int nb = gridDim.x * gridDim.y, id = eb * gridDim.x + mb;
  for (int k = id; k < q.chunks; k += nb) {
    const int res = threadIdx.x < kChunk ? sink_res(q, k * kChunk + threadIdx.x, pt) : 0;
    const int sum = pt_block_reduce(res, PtSum(), 0, scratch);
    if (threadIdx.x == 0) q.sinkseg[k] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) pt_push(Iter q) {
  __shared__ int tile[kTileRows][kTileCols];  // ec_push, then F'
  __shared__ int pe_s[kTileRows];
  const int E = q.E, M = q.M, pt = q.pt[0];
  const int mb = blockIdx.x, eb = blockIdx.y;
  const int m0 = mb * kTileCols, e0 = eb * kTileRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x < kTileRows && e0 + threadIdx.x < E) pe_s[threadIdx.x] = q.pe[e0 + threadIdx.x];
  __syncthreads();
  // (a) EC rows: ec_push from the row's prefix before the tile plus the
  // prefix inside it, 32 columns at a time.
  for (int r = w; r < kTileRows && e0 + r < E; r += kWarps) {
    const int e = e0 + r, xe = q.exc_e[e], pe = pe_s[r];
    int pushed = 0;
    if (xe > 0) {
      const RowCells x(q, q.F, e, m0, lane);
      int carry = 0;
      for (int k = lane; k < mb; k += 32) carry += q.rowseg[(size_t)k * E + e];
      carry = pt_warp_reduce(carry, PtSum());
#pragma unroll
      for (int j = 0; j < kSlices; ++j) {
        const bool open = RowCells::in(q, m0, j, lane) &&
                          reduced_cost(x.c[j], pe, x.pm[j], PT_POS) < 0;
        const int res = open ? x.u[j] - x.f[j] : 0;
        const int incl = pt_warp_incl_scan(res);
        const int push = max(min(res, xe - (carry + incl - res)), 0);
        tile[r][32 * j + lane] = push;
        pushed += push;
        carry += __shfl_sync(PT_FULL, incl, 31);
      }
    } else {
      for (int c = lane; c < kTileCols; c += 32) tile[r][c] = 0;
    }
    pushed = pt_warp_reduce(pushed, PtSum());
    if (lane == 0) q.r_ec[(size_t)mb * E + e] = pushed;
  }
  __syncthreads();
  // (b) Machine columns: me_push from the column's prefix above the tile
  // plus the prefix inside it; F' = F + ec_push - me_push.
  const int m = m0 + threadIdx.x;
  if (m < M) {
    const ColCells x(q, e0, m);
    const int left = q.exc_m[m] - machine_mt_push(q, m, pt), pm = q.pm[m];
    int before = 0;
    for (int k = 0; k < eb; ++k) before += q.colseg[(size_t)k * M + m];
    int sum = 0, adm_any = 0, cand = PT_NEG;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (e0 + r < E) {
        const int f = x.f[r], c = x.c[r], pe = pe_s[r];
        const bool adm = c < PT_INF_COST;
        const int rc = adm ? c + pe - pm : PT_POS;
        const int res = (rc > 0 && left > 0) ? f : 0;
        const int push = max(min(res, left - before), 0);
        before += res;
        const int fn = f + tile[r][threadIdx.x] - push;
        q.Fo[(size_t)(e0 + r) * M + m] = fn;
        tile[r][threadIdx.x] = fn;
        sum += fn;
        if (rc > 0 && fn > 0) adm_any = 1;
        if (fn > 0 && adm) cand = max(cand, pe + c);
      }
    }
    const size_t o = (size_t)eb * M + m;
    q.c_sum[o] = sum;
    q.c_adm[o] = adm_any;
    q.c_cand[o] = cand;
  }
  __syncthreads();
  // (c) EC rows again, on F': row sums, admissibility and candidates.
  for (int r = w; r < kTileRows && e0 + r < E; r += kWarps) {
    const int e = e0 + r, pe = pe_s[r];
    const RowCells x(q, q.F, e, m0, lane);  // f unused: F' is in the tile
    int sum = 0, adm_any = 0, cand = PT_NEG;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      if (RowCells::in(q, m0, j, lane)) {
        const int fn = tile[r][32 * j + lane], cst = x.c[j], pm = x.pm[j];
        const bool adm = cst < PT_INF_COST;
        const bool has_em = x.u[j] - fn > 0;
        sum += fn;
        if ((adm ? cst + pe - pm : PT_POS) < 0 && has_em) adm_any = 1;
        if (has_em && adm) cand = max(cand, pm - cst);
      }
    }
    sum = pt_warp_reduce(sum, PtSum());
    adm_any = pt_warp_reduce(adm_any, PtOr());
    cand = pt_warp_reduce(cand, PtMax());
    if (lane == 0) {
      const size_t o = (size_t)mb * E + e;
      q.r_sum[o] = sum;
      q.r_adm[o] = adm_any;
      q.r_cand[o] = cand;
    }
  }
}

// The sink relabel's and the phase status's reductions.  ``cnt`` packs
// the nodes with positive excess into one int, EC rows in the low 10 bits
// and machine columns above (E < 2^10 and M < 2^21, checked at launch):
// a separate int for each widened the struct, which measured ~6 us more
// per iteration at [128, 10240] on an H100 (chip_smoke.py --compare).
constexpr int kColShift = 10;
constexpr int kColUnit = 1 << kColShift;
struct Scal {
  int flow, adm, cand, cnt;
  long long pos;
};
struct ScalOp {
  __device__ Scal operator()(Scal a, Scal b) const {
    return {a.flow + b.flow, a.adm | b.adm, max(a.cand, b.cand), a.cnt + b.cnt,
            a.pos + b.pos};
  }
};

__global__ void __launch_bounds__(kChunk) pt_final(Iter q) {
  __shared__ int scratch[32];
  __shared__ Scal sscratch[32];
  __shared__ bool last;
  const int E = q.E, M = q.M, pt = q.pt[0];
  const int k = blockIdx.x, i = k * kChunk + threadIdx.x;
  // The sink's pushes: its prefix before this chunk, then inside it.
  int before = 0;
  for (int j = threadIdx.x; j < k; j += kChunk) before += q.sinkseg[j];
  before = pt_block_reduce(before, PtSum(), 0, scratch);
  const int res = sink_res(q, i, pt);
  int chunk_tot;
  const int incl = pt_block_incl_scan(res, scratch, &chunk_tot);
  const int tpush = max(min(res, q.exc_t[0] - (before + incl - res)), 0);
  Scal v{0, 0, (int)PT_NEG, 0, 0};
  if (i < M) {
    // Machine m: its sink push, F' column reductions, excess and relabel.
    const int m = i, pm = q.pm[m], rc_mt = pm - pt;
    const int fmt = q.Fmt[m] + machine_mt_push(q, m, pt) - tpush;
    int sum = 0, adm_any = 0, cand = PT_NEG;
    for (int r = 0; r < q.row_tiles; ++r) {
      const size_t o = (size_t)r * M + m;
      sum += q.c_sum[o];
      adm_any |= q.c_adm[o];
      cand = max(cand, q.c_cand[o]);
    }
    const int xm = sum - fmt;
    q.Fmto[m] = fmt;
    q.exc_mo[m] = xm;
    const bool mt_open = q.cap[m] - fmt > 0;
    const bool has_adm = (rc_mt < 0 && mt_open) || adm_any;
    const int maxcand = max(mt_open ? pt : PT_NEG, cand);
    q.pmo[m] = q.do_relabel ? pt_relabel(maxcand, has_adm, xm, pm, q.eps) : pm;
    v = {fmt, (-rc_mt < 0 && fmt > 0) ? 1 : 0, fmt > 0 ? pm : PT_NEG, xm > 0 ? kColUnit : 0,
         xm > 0 ? (long long)xm : 0LL};
  } else if (i < M + E) {
    // EC e: its fallback push (after its machine pushes), F' row
    // reductions, excess and relabel.
    const int e = i - M, pe = q.pe[e], u = q.U[e], sup = q.sup[e];
    int ec = 0, sum = 0, adm_any = 0, cand = PT_NEG;
    for (int c = 0; c < q.col_tiles; ++c) {
      const size_t o = (size_t)c * E + e;
      ec += q.r_ec[o];
      sum += q.r_sum[o];
      adm_any |= q.r_adm[o];
      cand = max(cand, q.r_cand[o]);
    }
    const int left = q.exc_e[e] - ec, rfb = u + pe - pt, ffb = q.Ffb[e];
    const int fb = (rfb < 0 && left > 0) ? min(sup - ffb, left) : 0;
    const int ffbn = ffb + fb - tpush;
    const int xe = sup - sum - ffbn;
    q.Ffbo[e] = ffbn;
    q.exc_eo[e] = xe;
    const bool fb_open = sup - ffbn > 0;
    const bool has_adm = adm_any || (rfb < 0 && fb_open);
    const int maxcand = max(cand, fb_open ? pt - u : PT_NEG);
    q.peo[e] = q.do_relabel ? pt_relabel(maxcand, has_adm, xe, pe, q.eps) : pe;
    v = {ffbn, (-rfb < 0 && ffbn > 0) ? 1 : 0, ffbn > 0 ? pe + u : PT_NEG, xe > 0 ? 1 : 0,
         xe > 0 ? (long long)xe : 0LL};
  }
  v = pt_block_reduce(v, ScalOp(), Scal{0, 0, (int)PT_NEG, 0, 0}, sscratch);
  if (threadIdx.x == 0) {
    int* bp = q.bpart + 4 * k;
    bp[0] = v.flow;
    bp[1] = v.adm;
    bp[2] = v.cand;
    bp[3] = v.cnt;
    q.bpos[k] = v.pos;
    __threadfence();
    last = atomicAdd(q.ticket, 1u) == (unsigned)q.chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: the scalars of the whole vector.
  Scal t{0, 0, (int)PT_NEG, 0, 0};
  for (int j = threadIdx.x; j < q.chunks; j += kChunk) {
    const int* bp = q.bpart + 4 * j;
    t = ScalOp()(t, Scal{__ldcg(bp), __ldcg(bp + 1), __ldcg(bp + 2), __ldcg(bp + 3),
                         __ldcg(q.bpos + j)});
  }
  t = pt_block_reduce(t, ScalOp(), Scal{0, 0, (int)PT_NEG, 0, 0}, sscratch);
  if (threadIdx.x == 0) {
    const int xt = t.flow - q.total;
    q.exc_to[0] = xt;
    q.pto[0] = q.do_relabel ? pt_relabel(t.cand, t.adm != 0, xt, pt, q.eps) : pt;
    // Phase status of the new state: the entering iteration counted iff
    // it was active.
    const long long pos = t.pos + max(xt, 0);
    q.sto[kStIters] = q.st[kStIters] + q.st[kStActive];
    q.sto[kStActive] = (t.cnt > 0 || xt > 0) ? 1 : 0;
    q.sto[kStExcess] = pt_saturate(pos);
    q.sto[kStRows] = t.cnt & (kColUnit - 1);
    q.sto[kStCols] = t.cnt >> kColShift;
    q.sto[kStSat] = pos >= PT_EXCESS_SAT_THRESH ? 1 : 0;
    // The telemetry sample of the iteration just run, from its entering
    // status; a global update run in place of the relabel marks its
    // fired bit and sweeps afterwards.
    if (q.ring != nullptr && q.st[kStActive]) {
      const int g = q.ring_base + q.st[kStIters], cap = q.ring_cap;
      int* r = q.ring + g % cap;
      r[kTrIter * cap] = g;
      r[kTrExcess * cap] = q.st[kStExcess];
      r[kTrRows * cap] = q.st[kStRows];
      r[kTrCols * cap] = q.st[kStCols];
      r[kTrEps * cap] = q.eps;
      r[kTrGu * cap] = 0;
      r[kTrBf * cap] = 0;
      r[kTrSat * cap] = q.st[kStSat];
    }
    *q.ticket = 0;
  }
}

struct Shape {
  int col_tiles, row_tiles, chunks;
  Shape(int E, int M)
      : col_tiles((M + kTileCols - 1) / kTileCols),
        row_tiles((E + kTileRows - 1) / kTileRows),
        chunks((M + E + kChunk - 1) / kChunk) {}
};

}  // namespace

// Workspace ints one iteration needs at [E, M] (allocated once per solve;
// its last int, the ticket, must start at 0).  The first 2 * chunks ints
// hold int64 sums, so the workspace must be 8-byte aligned.
extern "C" long long pt_tiled_iteration_ws_ints(int E, int M) {
  const Shape s(E, M);
  return 2LL * s.chunks + (long long)s.col_tiles * E + (long long)s.row_tiles * M + s.chunks +
         4LL * s.col_tiles * E + 3LL * s.row_tiles * M + 4LL * s.chunks + 1;
}

// CUDA kernels launched by this library since it was loaded.
extern "C" unsigned long long pt_tiled_iteration_kernels() { return g_kernels; }

// Plain C entry point: the three launches of one iteration on ``stream``.
// All pointers are device pointers; ``ws`` is the workspace above; ``st``
// and ``sto`` are 6-int phase statuses; ``ring`` is null or the solve's
// [8, ring_cap] telemetry ring, and ``ring_base`` the iterations of its
// earlier phases.  Refuses E >= 2^10 or M >= 2^21 (the packed counts);
// otherwise returns cudaGetLastError().
extern "C" int pt_tiled_iteration(
    const int* C, const int* Uem, const int* U, const int* sup,
    const int* cap, const int* F, const int* Ffb, const int* Fmt,
    const int* pe, const int* pm, const int* pt, const int* exc_e,
    const int* exc_m, const int* exc_t, const int* st, int* Fo, int* Ffbo,
    int* Fmto, int* peo, int* pmo, int* pto, int* exc_eo, int* exc_mo,
    int* exc_to, int* sto, int* ws, int* ring, int E, int M, int eps,
    int do_relabel, int total, int ring_base, int ring_cap, void* stream) {
  if (E >= kColUnit || M >= (1 << (31 - kColShift))) return (int)cudaErrorInvalidValue;
  const Shape sh(E, M);
  Iter q;
  q.C = C; q.Uem = Uem; q.U = U; q.sup = sup; q.cap = cap;
  q.F = F; q.Ffb = Ffb; q.Fmt = Fmt; q.pe = pe; q.pm = pm; q.pt = pt;
  q.exc_e = exc_e; q.exc_m = exc_m; q.exc_t = exc_t; q.st = st;
  q.Fo = Fo; q.Ffbo = Ffbo; q.Fmto = Fmto; q.peo = peo; q.pmo = pmo;
  q.pto = pto; q.exc_eo = exc_eo; q.exc_mo = exc_mo; q.exc_to = exc_to;
  q.sto = sto;
  q.bpos = reinterpret_cast<long long*>(ws);
  int* v = ws + 2 * sh.chunks;
  q.rowseg = v; v += (size_t)sh.col_tiles * E;
  q.colseg = v; v += (size_t)sh.row_tiles * M;
  q.sinkseg = v; v += sh.chunks;
  q.r_ec = v; v += (size_t)sh.col_tiles * E;
  q.r_sum = v; v += (size_t)sh.col_tiles * E;
  q.r_adm = v; v += (size_t)sh.col_tiles * E;
  q.r_cand = v; v += (size_t)sh.col_tiles * E;
  q.c_sum = v; v += (size_t)sh.row_tiles * M;
  q.c_adm = v; v += (size_t)sh.row_tiles * M;
  q.c_cand = v; v += (size_t)sh.row_tiles * M;
  q.bpart = v; v += 4 * sh.chunks;
  q.ticket = reinterpret_cast<unsigned*>(v);
  q.ring = ring_cap > 0 ? ring : nullptr;
  q.ring_base = ring_base; q.ring_cap = ring_cap;
  q.E = E; q.M = M; q.eps = eps; q.do_relabel = do_relabel; q.total = total;
  q.col_tiles = sh.col_tiles; q.row_tiles = sh.row_tiles; q.chunks = sh.chunks;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tiles(sh.col_tiles, sh.row_tiles);
  pt_seg<<<tiles, kThreads, 0, s>>>(q);
  pt_push<<<tiles, kThreads, 0, s>>>(q);
  pt_final<<<sh.chunks, kChunk, 0, s>>>(q);
  g_kernels += 3;
  return (int)cudaGetLastError();
}

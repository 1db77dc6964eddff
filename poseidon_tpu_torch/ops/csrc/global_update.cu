// Bellman-Ford global price update of the per-iteration route (B3): the
// distances to a deficit node over the residual graph under the arc
// lengths floor(rc / eps) + 1, then every potential drops by eps * d.
//
// Replaces: nothing written in Pallas.  The reference leaves this function
// to XLA (poseidon_tpu/ops/transport.py::_global_update, called by
// transport_tiled._pr_phase_tiled inside a lax.while_loop on the device).
// Bit-equal to the plain torch version (ops/transport.py::_global_update):
// the same (pe, pm, pt) bits and the same sweep count.
//
// Bound on the H100: operations at the wave's [128, 10240] (the lengths
// once, two relaxations per cell and sweep); the sweeps themselves are
// latency: a chain of grid-wide exchanges of a few hundred values each.
//
// Design.  One persistent cooperative launch, one block per SM, runs the
// whole Bellman-Ford loop, convergence test included, so the update makes
// no host read (the reference's while_loop runs on the device too).
//   * Work split: block b owns ncb = T * 32 consecutive machine columns
//     (T tiles of 32) across all E rows, and keeps its columns' state on
//     the SM for the whole update: d_m, the sink arcs' lengths and, where
//     they fit (the wave's [128, 10240] and [256, 10240]), both length
//     planes of its columns in shared memory; wider, the forward plane
//     there and the reverse one in a per-block region of the workspace
//     ([256, 16384]), or both in the workspace.  Every block holds the row
//     vectors (d_e, the fallback arcs' lengths) and computes them itself,
//     so there is no set-up barrier.  The forward plane is stored column
//     by column ([ncb][E | 1]), the reverse one row by row ([E][ncb]), so
//     both passes read consecutive words across a warp.
//   * Lengths once per update: flows and prices are frozen through the
//     sweeps.  A closed arc's length is kFar (2^30): a candidate at or past
//     DINF always loses to the old distance (at most DINF), exactly as the
//     plain version's DINF does, so a relaxation is one add and one min
//     (the DPX add-min on Hopper).  Divides use the magic multiplier.
//   * Two Jacobi sweeps per grid barrier.  A sweep's column update needs
//     only the global d_e^k, d_t^k and the block's own d_m^k.  So before a
//     barrier a block has d_m^k and d_m^{k+1} and sends its partial row
//     minima P1[e] = min_m Lf + d_m^k, P2[e] = min_m Lf + d_m^{k+1} and the
//     sink's Q1, Q2 (reverse machine arcs); after it, every block derives
//     the same d_e^{k+1}, d_t^{k+1}, d_e^{k+2}, d_t^{k+2}, then one pass
//     over its reverse plane gives d_m^{k+2} and d_m^{k+3}.  Integer minima
//     do not depend on order, so this is exact Jacobi.  The two sweeps'
//     distances sit side by side (int2), one load serving both.
//   * A partial is sent only if it can still lower the value derived from
//     it (P1 below min(d_e^k, Lfb + d_t^k), P2 below that and the block's
//     own P1; the sink likewise): converged sweeps send almost nothing.
//   * The exchange: a 64-bit atomicMax of (tag << 32 | ~biased value) per
//     row, into one of two slots by exchange parity.  The tag counts the
//     workspace's exchanges, so a newer exchange always wins and a slot is
//     never reset: a stale tag reads as "nothing sent".  A slot is written
//     again two exchanges later, after every block has passed the barrier
//     that follows its last read.
//   * The barrier: after __syncthreads, thread 0 arrives with
//     red.release.gpu on a counter that only grows and polls it with
//     ld.acquire.gpu until it reaches the exchange's target; a wait past
//     kBarrierCycles (seconds) traps.  sweeps / 2 barriers per update.
//   * Convergence: a group of four sweeps is two exchanges.  d_e and d_t
//     are computed identically in every block, so their part of the
//     group's "changed" test is uniform; the columns' part (d_m^{s+3}
//     against d_m^s: a state that stands still for one sweep stands still
//     for good, so this equals the test at s+4) and their finite maximum
//     go out with the group's last exchange.  The loop condition (changed
//     && sweeps <= bf_max) is therefore uniform across the grid, and the
//     apply step needs no barrier of its own.
// The sweep count is added to a device counter (the solve's statistics),
// and, with the solve's telemetry ring, written with the fired bit into the
// column of the iteration the update belongs to (the host passes it: it
// reads the phase status before any update).

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;
constexpr int kSweepsPerCheck = 4;
constexpr int kFar = 1 << 30;
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -0x7fffffff - 1;
constexpr long long kBarrierCycles = 1LL << 34;
// The block reductions' two scratch buffers and the column pass's
// per-warp results.
constexpr int kRedInts = 2 * kWarps * 5 + kWarps * 4;

// Workspace header words (unsigned): the exchange tag base (the count of
// exchanges, hence of grid barriers, run on this workspace so far: the
// wrapper reads it for diagnostics), the barrier's arrival counter and its
// value at the launch's start.
enum { kHdTag, kHdArrive, kHdArriveBase, kHdPad, kHdInts };

struct Gu {
  const int* C; const int* Uem; const int* U; const int* sup; const int* cap;
  const int* F; const int* Ffb; const int* Fmt; const int* pe; const int* pm;
  const int* pt; const int* exc_e; const int* exc_m; const int* exc_t;
  int* peo; int* pmo; int* pto; int* sweeps_acc;
  unsigned* hdr;                 // [kHdInts]
  unsigned long long* slot;      // [2][2E + 4] exchange keys
  int* blk;                      // per-block length planes not in smem
  size_t blk_ints;               // ints of one block's region
  int* ring;                     // [8, ring_cap] telemetry ring, or null
  int E, M, eps, bf_max, ncb, ls, ring_slot, ring_cap;
};

// Where the length planes live (the launch plan's placement): both in
// shared memory, the forward one there and the reverse one in the
// workspace, or both in the workspace.
enum { kPlanesWs = 0, kPlanesLf = 1, kPlanesSmem = 2 };

// Shared-memory ints: d_e (two sweeps, as pairs), the block's columns' d_m
// (two sweeps, as pairs), the row and column passes' partials (pairs),
// the two fallback-arc lengths, the sink-arc lengths, kRedInts; then the
// planes that ``placement`` puts there (forward [ncb][ls], reverse
// [E][ncb]).  The row vectors always sit here: at GU_MAX_ROWS
// (transport_tiled.py) = 8192 rows they take 128 KB, leaving the planes
// to the workspace.
__host__ __device__ size_t smem_ints(int E, int ncb, int ls, int placement) {
  return 4 * (size_t)E + 4 * (size_t)ncb + 4 * kThreads + kRedInts +
         (placement >= kPlanesLf ? (size_t)ncb * ls : 0) +
         (placement == kPlanesSmem ? (size_t)E * ncb : 0);
}

// Ints of one block's workspace region: the planes not in shared memory.
__host__ __device__ size_t blk_ints(int E, int ncb, int ls, int placement) {
  return (placement < kPlanesLf ? (size_t)ncb * ls : 0) +
         (placement < kPlanesSmem ? (size_t)E * ncb : 0);
}

// Forward plane row stride: odd, so a warp writing 32 consecutive columns
// of one row hits 32 banks.
__host__ __device__ int plane_stride(int E) { return E | 1; }

__device__ __forceinline__ int addmin(int l, int d, int acc) {
  return __viaddmin_s32(l, d, acc);  // min(l + d, acc)
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A minimum sent under ``tag``: the larger key wins atomicMax, so the
// newest tag and, within it, the least value.
__device__ __forceinline__ unsigned long long min_key(unsigned tag, int v) {
  return ((unsigned long long)tag << 32) | (unsigned)~((unsigned)v ^ 0x80000000u);
}

// The value a slot holds for ``tag``; kFar (no effect) if nothing was sent.
__device__ __forceinline__ int key_min(unsigned long long k, unsigned tag) {
  return (unsigned)(k >> 32) == tag ? (int)(~(unsigned)k ^ 0x80000000u) : kFar;
}

// Grid-wide barrier of the cooperative launch: every block is resident,
// so spinning cannot deadlock.  __syncthreads orders the block's writes
// (the partials' atomics among them) before thread 0's release arrival,
// which follows its own ``before_arrive`` (the block's sink and group
// sends); its acquire poll and the second __syncthreads order the other
// blocks' writes before this block's reads.
template <typename Hook>
__device__ void grid_barrier(unsigned* counter, unsigned target, Hook before_arrive) {
  __syncthreads();
  if (threadIdx.x == 0) {
    before_arrive();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" :: "l"(counter), "r"(1u) : "memory");
    const long long t0 = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
      if (clock64() - t0 > kBarrierCycles) __trap();
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// Three minima and two maxima, reduced over the block with one
// __syncthreads; every thread gets the result.  ``red`` alternates between
// two scratch buffers (``parity``), so a buffer is rewritten only after a
// later reduction's barrier, when every thread has read it.
struct Red {
  int lo0, lo1, lo2, hi0, hi1;
};

__device__ __forceinline__ Red red_identity() {
  return Red{kIntMax, kIntMax, kIntMax, kIntMin, kIntMin};
}

__device__ __forceinline__ Red warp_red(Red v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.lo0 = min(v.lo0, __shfl_xor_sync(PT_FULL, v.lo0, o));
    v.lo1 = min(v.lo1, __shfl_xor_sync(PT_FULL, v.lo1, o));
    v.lo2 = min(v.lo2, __shfl_xor_sync(PT_FULL, v.lo2, o));
    v.hi0 = max(v.hi0, __shfl_xor_sync(PT_FULL, v.hi0, o));
    v.hi1 = max(v.hi1, __shfl_xor_sync(PT_FULL, v.hi1, o));
  }
  return v;
}

__device__ Red block_red(Red v, int* red, int& parity) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* buf = red + parity * kWarps * 5;
  parity ^= 1;
  v = warp_red(v);
  if (lane == 0) {
    buf[w * 5 + 0] = v.lo0; buf[w * 5 + 1] = v.lo1; buf[w * 5 + 2] = v.lo2;
    buf[w * 5 + 3] = v.hi0; buf[w * 5 + 4] = v.hi1;
  }
  __syncthreads();
  Red x = red_identity();
  if (lane < kWarps) {
    x = Red{buf[lane * 5 + 0], buf[lane * 5 + 1], buf[lane * 5 + 2],
            buf[lane * 5 + 3], buf[lane * 5 + 4]};
  }
  return warp_red(x);
}

// One pass over the block's reverse plane: for each of its columns c,
// best.x = min_e lr[e][c] + d[e].x and best.y = min_e lr[e][c] + d[e].y
// (d: a pair of row-distance vectors, one 8-byte load a row), handed to
// fin(c, best) by the thread that owns column c (the same thread every
// pass).  Column-split: R row segments of the block's columns, reduced
// through ``part``.
template <typename Fin>
__device__ __forceinline__ void col_pass(const int* lr, const int2* d, int E, int ncb,
                                         int2* part, Fin fin) {
  const int tid = threadIdx.x;
  if (ncb <= kThreads) {
    const int R = kThreads / ncb, c = tid % ncb, r = tid / ncb;
    if (r < R) {
      int2 best = make_int2(kIntMax, kIntMax);
      const int* lp = lr + r * ncb + c;
      const int step = R * ncb;
#pragma unroll 4
      for (int e = r; e < E; e += R, lp += step) {
        const int l = *lp;
        const int2 de = d[e];
        best.x = addmin(l, de.x, best.x);
        best.y = addmin(l, de.y, best.y);
      }
      part[r * ncb + c] = best;
    }
    __syncthreads();
    if (tid < ncb) {
      int2 best = part[tid];
#pragma unroll 8
      for (int s = 1; s < R; ++s) {
        const int2 o = part[s * ncb + tid];
        best.x = min(best.x, o.x);
        best.y = min(best.y, o.y);
      }
      fin(tid, best);
    }
  } else {
    for (int c = tid; c < ncb; c += kThreads) {
      int2 best = make_int2(kIntMax, kIntMax);
#pragma unroll 4
      for (int e = 0; e < E; ++e) {
        const int l = lr[(size_t)e * ncb + c];
        const int2 de = d[e];
        best.x = addmin(l, de.x, best.x);
        best.y = addmin(l, de.y, best.y);
      }
      fin(c, best);
    }
  }
}

// One pass over the block's forward plane: for each row e, the minima of
// lf[c][e] + dm[c].x and + dm[c].y (d_m^k and d_m^{k+1}, one 8-byte load
// a column) over the block's columns, handed to send(e, p).  Row-split: S
// column segments, reduced through ``part``.
template <typename Send>
__device__ __forceinline__ void row_pass(const int* lf, int ls, const int2* dm, int E, int ncb,
                                         int2* part, Send send) {
  const int tid = threadIdx.x;
  if (E <= kThreads) {
    const int EP = (E + 31) & ~31, S = kThreads / EP, e = tid % EP, s = tid / EP;
    if (s < S && e < E) {
      int2 p = make_int2(kIntMax, kIntMax);
      const int* lp = lf + s * ls + e;
      const int step = S * ls;
#pragma unroll 4
      for (int c = s; c < ncb; c += S, lp += step) {
        const int l = *lp;
        const int2 m = dm[c];
        p.x = addmin(l, m.x, p.x);
        p.y = addmin(l, m.y, p.y);
      }
      part[s * EP + e] = p;
    }
    __syncthreads();
    if (tid < E) {
      int2 p = part[tid];
#pragma unroll 8
      for (int r = 1; r < S; ++r) {
        const int2 o = part[r * EP + tid];
        p.x = min(p.x, o.x);
        p.y = min(p.y, o.y);
      }
      send(tid, p);
    }
  } else {
    for (int e = tid; e < E; e += kThreads) {
      int2 p = make_int2(kIntMax, kIntMax);
#pragma unroll 4
      for (int c = 0; c < ncb; ++c) {
        const int l = lf[(size_t)c * ls + e];
        const int2 m = dm[c];
        p.x = addmin(l, m.x, p.x);
        p.y = addmin(l, m.y, p.y);
      }
      send(e, p);
    }
  }
}

template <bool kLfSmem, bool kLrSmem>
__global__ void __launch_bounds__(kThreads, 1) pt_global_update(Gu q) {
  extern __shared__ __align__(16) int sm[];
  const int E = q.E, M = q.M, G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int ncb = q.ncb, ls = q.ls;
  int2* de = reinterpret_cast<int2*>(sm);  // [E] (d_e^{k+1}, d_e^{k+2}); .y: d_e^k between
  int2* dm = de + E;                        // [ncb] (d_m^k, d_m^{k+1}) of the block's columns
  // The passes' partials, one buffer each: a row pass's writes then never
  // meet the previous column pass's last reads, which no barrier follows.
  int2* part_row = dm + ncb;                // [kThreads]
  int2* part_col = part_row + kThreads;     // [kThreads]
  int* lfb = reinterpret_cast<int*>(part_col + kThreads);  // [E]
  int* ltfb = lfb + E;                      // [E]
  int* lmt = ltfb + E;                      // [ncb]
  int* ltm = lmt + ncb;                     // [ncb]
  int* red = ltm + ncb;                     // [2][kWarps][5]
  int* colred = red + 2 * kWarps * 5;       // [kWarps][4]
  // The length planes: forward [ncb][ls], reverse [E][ncb], each in shared
  // memory after the rest or in the block's region of the workspace.
  int* ws_blk = q.blk + (size_t)b * q.blk_ints;
  int* lf = kLfSmem ? red + kRedInts : ws_blk;
  int* lr = kLrSmem ? (kLfSmem ? lf + (size_t)ncb * ls : red + kRedInts)
                    : (kLfSmem ? ws_blk : lf + (size_t)ncb * ls);
  const int m0 = b * ncb;
  const int width = min(ncb, M - m0);
  const int pt = q.pt[0];
  const PtDivisor dv(q.eps);
  // Read before this block's first arrival, so before block 0 can move
  // them at the end.
  const unsigned tag0 = ld_relaxed(q.hdr + kHdTag);
  const unsigned arrive0 = ld_relaxed(q.hdr + kHdArriveBase);
  int parity = 0;

  // ---- set-up, in every block: the row vectors and d_e^0.
  for (int e = tid; e < E; e += kThreads) {
    const int ffb = q.Ffb[e], r = q.U[e] + q.pe[e] - pt;
    lfb[e] = q.sup[e] - ffb > 0 ? pt_floordiv(r, dv) + 1 : kFar;
    ltfb[e] = ffb > 0 ? pt_floordiv(-r, dv) + 1 : kFar;
    const int d = q.exc_e[e] < 0 ? 0 : PT_DINF;
    de[e] = make_int2(d, d);
  }
  // The block's columns: sink arcs and d_m^0 (past M: closed, unreached).
  for (int c = tid; c < ncb; c += kThreads) {
    int a = kFar, r = kFar, d = PT_DINF;
    if (c < width) {
      const int m = m0 + c, pm = q.pm[m], fmt = q.Fmt[m];
      a = q.cap[m] - fmt > 0 ? pt_floordiv(pm - pt, dv) + 1 : kFar;
      r = fmt > 0 ? pt_floordiv(-(pm - pt), dv) + 1 : kFar;
      d = q.exc_m[m] < 0 ? 0 : PT_DINF;
    }
    lmt[c] = a;
    ltm[c] = r;
    dm[c] = make_int2(d, d);
  }
  // Both length planes of the block's columns, read once from C, F, Uem:
  // R row segments of the block's columns (consecutive threads on
  // consecutive columns), or each thread a column when they outnumber the
  // threads.
  {
    const bool split = ncb <= kThreads;
    const int R = split ? kThreads / ncb : 1;
    const int c0 = split ? tid % ncb : tid, r0 = split ? tid / ncb : 0;
    const int cstep = split ? ncb : kThreads;
    for (int c = c0; r0 < R && c < ncb; c += cstep) {
      if (c >= width) {  // past M: closed
        for (int e = r0; e < E; e += R) {
          lf[(size_t)c * ls + e] = kFar;
          lr[(size_t)e * ncb + c] = kFar;
        }
        continue;
      }
      const int m = m0 + c, pm = q.pm[m];
      // Branch-free, so the unrolled rows' loads all go out together.
#pragma unroll 4
      for (int e = r0; e < E; e += R) {
        const size_t g = (size_t)e * M + m;
        const int cst = __ldg(q.C + g), fl = __ldg(q.F + g), u = __ldg(q.Uem + g);
        const int x = cst + __ldg(q.pe + e) - pm;
        const bool adm = cst < PT_INF_COST;
        lf[(size_t)c * ls + e] = adm && u - fl > 0 ? pt_floordiv(x, dv) + 1 : kFar;
        lr[(size_t)e * ncb + c] = adm && fl > 0 ? pt_floordiv(-x, dv) + 1 : kFar;
      }
    }
  }
  __syncthreads();

  int dt0 = q.exc_t[0] < 0 ? 0 : PT_DINF;
  // The column pass's results for the next exchange's sends: each warp
  // that finalizes columns reduces its threads' sink partials Q1, Q2, the
  // group's "moved" bit and finite maximum into colred[w]; thread 0 reads
  // them in the next barrier, after the __syncthreads that follows.
  const int col_warps = min(ncb, kThreads) / 32;
  auto col_publish = [&](Red v) {
    if ((int)(tid >> 5) < col_warps) {
      v = warp_red(v);
      if ((tid & 31) == 0) {
        int* o = colred + (tid >> 5) * 4;
        o[0] = v.lo0; o[1] = v.lo1; o[2] = v.hi0; o[3] = v.hi1;
      }
    }
  };
  // d_m^1 by one column pass (both halves of de hold d_e^0).  ``mvm``:
  // this thread's columns moved in the current group (up to its third
  // sweep).
  int mvm = 0;
  Red cr = red_identity();
  col_pass(lr, de, E, ncb, part_col, [&](int c, int2 best) {
    const int a = dm[c].x, nb = min(a, min(best.y, lmt[c] + dt0));
    dm[c].y = nb;
    mvm |= nb != a;
    cr.lo0 = min(cr.lo0, ltm[c] + a);
    cr.lo1 = min(cr.lo1, ltm[c] + nb);
  });
  col_publish(cr);
  // R1 = min_e Ltfb + d_e^0, for every thread.
  Red rr = red_identity();
  for (int e = tid; e < E; e += kThreads) rr.lo1 = min(rr.lo1, ltfb[e] + de[e].y);
  int R1 = block_red(rr, red, parity).lo1;

  // ---- exchanges: two Jacobi sweeps each, four per convergence group.
  unsigned j = 0;
  int sweeps = 0, mv_et = 0, fme = 0;
  bool changed = true;
  for (;;) {
    const unsigned tag = tag0 + j + 1;
    unsigned long long* sl = q.slot + (size_t)(j & 1) * (2 * (size_t)E + 4);
    const bool group_end = j & 1;
    const int ubt1 = min(dt0, R1);
    // Before the barrier: the block's partial row minima, sent only where
    // they can still lower d_e^{k+1} / d_e^{k+2}.
    row_pass(lf, ls, dm, E, ncb, part_row, [&](int e, int2 p) {
      const int ub1 = min(de[e].y, lfb[e] + dt0);
      if (p.x < ub1) atomicMax(sl + e, min_key(tag, p.x));
      if (p.y < min(ub1, p.x)) atomicMax(sl + E + e, min_key(tag, p.y));
    });
    grid_barrier(q.hdr + kHdArrive, arrive0 + (j + 1) * (unsigned)G, [&] {
      // The sink's partials and, at a group's end, its columns' data.
      int q1b = kIntMax, q2b = kIntMax, mvb = 0, fmb = kIntMin;
      for (int w = 0; w < col_warps; ++w) {
        const int* o = colred + w * 4;
        q1b = min(q1b, o[0]); q2b = min(q2b, o[1]);
        mvb = max(mvb, o[2]); fmb = max(fmb, o[3]);
      }
      if (q1b < ubt1) atomicMax(sl + 2 * E, min_key(tag, q1b));
      if (q2b < min(ubt1, q1b)) atomicMax(sl + 2 * E + 1, min_key(tag, q2b));
      if (group_end) {
        atomicMax(sl + 2 * E + 2, ((unsigned long long)tag << 32) | (unsigned)mvb);
        atomicMax(sl + 2 * E + 3,
                  ((unsigned long long)tag << 32) | ((unsigned)fmb ^ 0x80000000u));
      }
    });

    // After it: every block derives the same d_e^{k+1}, d_t^{k+1},
    // d_e^{k+2}, d_t^{k+2}.  The threads that hold rows read the slot, its
    // loads all out before any is used (one round trip to L2); the
    // block's reduction hands the scalars to the rest.
    rr = red_identity();
    if (tid < E) {
      const unsigned long long kq1 = ld_relaxed(sl + 2 * E), kq2 = ld_relaxed(sl + 2 * E + 1);
      const unsigned long long kmv = group_end ? ld_relaxed(sl + 2 * E + 2) : 0;
      const unsigned long long kfm = group_end ? ld_relaxed(sl + 2 * E + 3) : 0;
      unsigned long long kp1 = ld_relaxed(sl + tid), kp2 = ld_relaxed(sl + E + tid);
      const int dt1 = min(ubt1, key_min(kq1, tag));
      rr.lo0 = key_min(kq2, tag);
      rr.lo2 = dt1;
      if (group_end) {
        rr.hi0 = (int)(unsigned)kmv;
        rr.hi1 = (int)((unsigned)kfm ^ 0x80000000u);
      }
      for (int e = tid; e < E; e += kThreads) {
        if (e != tid) {
          kp1 = ld_relaxed(sl + e);
          kp2 = ld_relaxed(sl + E + e);
        }
        const int d0 = de[e].y, ub1 = min(d0, lfb[e] + dt0);
        const int d1 = min(ub1, key_min(kp1, tag));
        const int d2 = min(d1, min(key_min(kp2, tag), lfb[e] + dt1));
        de[e] = make_int2(d1, d2);
        rr.lo0 = min(rr.lo0, ltfb[e] + d1);
        rr.lo1 = min(rr.lo1, ltfb[e] + d2);
        rr.hi0 = max(rr.hi0, (int)(d2 != d0));
        rr.hi1 = max(rr.hi1, d2 < PT_DINF ? d2 : 0);
      }
    }
    rr = block_red(rr, red, parity);
    const int dt1 = rr.lo2, dt2 = min(dt1, rr.lo0);
    mv_et |= rr.hi0 > 0 || dt2 != dt0;
    dt0 = dt2;
    R1 = rr.lo1;
    if (group_end) {
      sweeps += kSweepsPerCheck;
      changed = mv_et != 0;
      mv_et = 0;
      if (!changed || sweeps > q.bf_max) {
        // Converged, the group held still: d_m^{s+3} (dm.y) is final, and
        // the reduction's maximum took in the columns' (the group's slot).
        fme = max(rr.hi1, dt2 < PT_DINF ? dt2 : 0);
        break;
      }
    }
    // d_m^{k+2} and d_m^{k+3} in one pass over the reverse plane, and the
    // next exchange's sink partials and group data.
    const bool group_start = group_end;
    cr = red_identity();
    // A new group starts its flag afresh, once per pass: a thread that
    // owns several columns folds them all in.
    if (group_start) mvm = 0;
    col_pass(lr, de, E, ncb, part_col, [&](int c, int2 best) {
      const int old = dm[c].y;
      const int a = min(old, min(best.x, lmt[c] + dt1));
      const int nb = min(a, min(best.y, lmt[c] + dt2));
      dm[c] = make_int2(a, nb);
      mvm |= (!group_start && a != old) || nb != a;
      cr.lo0 = min(cr.lo0, ltm[c] + a);
      cr.lo1 = min(cr.lo1, ltm[c] + nb);
      if (c < width) cr.hi1 = max(cr.hi1, nb < PT_DINF ? nb : 0);
    });
    cr.hi0 = mvm;
    col_publish(cr);
    __syncthreads();  // the new d_m, before the next row pass reads it
    ++j;
  }

  // ---- apply: skip when unconverged; fill unreached nodes with
  // finite_max + 1; apply only when eps * d cannot overflow.
  const int fm = fme;
  const bool ok = !changed && fm < (1 << 26) / max(q.eps, 1);
  const int dbig = fm + 1, eps = q.eps;
  for (int c = tid; c < width; c += kThreads) {
    const int m = m0 + c, p = q.pm[m];
    int d = ok ? dm[c].y : 0;
    d = d >= PT_DINF ? dbig : d;
    q.pmo[m] = ok ? max(p - eps * d, PT_NEG_HALF) : p;
  }
  for (int e = b + G * tid; e < E; e += G * kThreads) {
    const int p = q.pe[e];
    int d = ok ? de[e].y : 0;
    d = d >= PT_DINF ? dbig : d;
    q.peo[e] = ok ? max(p - eps * d, PT_NEG_HALF) : p;
  }
  if (b == 0 && tid == 0) {
    const int d = dt0 >= PT_DINF ? dbig : dt0;
    q.pto[0] = ok ? max(pt - eps * d, PT_NEG_HALF) : pt;
    q.sweeps_acc[0] += sweeps;
    if (q.ring != nullptr) {
      q.ring[kTrGu * q.ring_cap + q.ring_slot] = 1;
      q.ring[kTrBf * q.ring_cap + q.ring_slot] = sweeps;
    }
    // Every block has passed the last barrier, so has read the header.
    q.hdr[kHdTag] = tag0 + j + 1;
    q.hdr[kHdArriveBase] = arrive0 + (j + 1) * (unsigned)G;
  }
}

struct Plan {
  int grid, placement, ncb;
};

using Kernel = void (*)(Gu);

Kernel kernel_for(int placement) {
  return placement == kPlanesSmem ? pt_global_update<true, true>
         : placement == kPlanesLf ? pt_global_update<true, false>
                                  : pt_global_update<false, false>;
}

// The launch plan at [E, M]: one block per SM (or fewer, one per group of
// T tiles), each owning T = ceil(tiles / grid) tiles; the length planes in
// shared memory as far as they fit beside the rest, else in the
// workspace.
cudaError_t make_plan(int E, int M, Plan* p) {
  int dev, sms, optin, per_sm;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return rc;
  const int tiles = (M + kTileCols - 1) / kTileCols;
  const int ls = plane_stride(E);
  // One block per SM (1024 threads, up to 64 registers each).
  int T = (tiles + sms - 1) / sms;
  const int grid = (tiles + T - 1) / T;
  T = (tiles + grid - 1) / grid;
  const int ncb = T * kTileCols;
  for (int placement = kPlanesSmem; placement >= kPlanesWs; --placement) {
    const size_t bytes = sizeof(int) * smem_ints(E, ncb, ls, placement);
    if (bytes > (size_t)optin) continue;
    const Kernel kern = kernel_for(placement);
    rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes);
    if (rc != cudaSuccess) return rc;
    // A grid that cannot be co-resident is refused, never run.
    if (per_sm >= 1 && per_sm * sms >= grid) {
      *p = Plan{grid, placement, ncb};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

// The launch plan at [E, M]: plan[0] = blocks of the cooperative grid,
// plan[1] = where the length planes live (2: both in shared memory, 1: the
// forward plane there and the reverse one in the workspace, 0: both in the
// workspace), plan[2] = columns a block owns.  Returns a CUDA error code
// (0 on success).
extern "C" int pt_global_update_plan(int E, int M, int* plan) {
  Plan p;
  const cudaError_t rc = make_plan(E, M, &p);
  if (rc != cudaSuccess) return (int)rc;
  plan[0] = p.grid;
  plan[1] = p.placement;
  plan[2] = p.ncb;
  return 0;
}

// Workspace ints the update needs with E rows under ``plan`` (the
// wrapper allocates it zeroed once per solve: the tags and the barrier
// start at 0).
extern "C" long long pt_global_update_ws_ints(int E, const int* plan) {
  const long long slots = 2LL * 2 * (2LL * E + 4);  // [2][2E + 4] of 64 bits
  return kHdInts + slots +
         (long long)plan[0] * (long long)blk_ints(E, plan[2], plane_stride(E), plan[1]);
}

// Plain C entry point: one global update on ``stream`` as one cooperative
// launch under ``plan`` (pt_global_update_plan, three ints).  Writes (peo, pmo, pto)
// and adds the sweeps to sweeps_acc[0]; with a telemetry ``ring`` (null for
// none) it marks column ``ring_slot`` fired, with its sweeps.  Returns the
// launch's error code (a grid that cannot be co-resident is refused, never
// run).
extern "C" int pt_global_update_launch(
    const int* C, const int* Uem, const int* U, const int* sup, const int* cap,
    const int* F, const int* Ffb, const int* Fmt, const int* pe, const int* pm,
    const int* pt, const int* exc_e, const int* exc_m, const int* exc_t,
    int* peo, int* pmo, int* pto, int* sweeps_acc, int* ws, int* ring, int E,
    int M, int eps, int bf_max, const int* plan, int ring_slot, int ring_cap,
    void* stream) {
  Gu q;
  q.C = C; q.Uem = Uem; q.U = U; q.sup = sup; q.cap = cap;
  q.F = F; q.Ffb = Ffb; q.Fmt = Fmt; q.pe = pe; q.pm = pm; q.pt = pt;
  q.exc_e = exc_e; q.exc_m = exc_m; q.exc_t = exc_t;
  q.peo = peo; q.pmo = pmo; q.pto = pto; q.sweeps_acc = sweeps_acc;
  const int grid = plan[0], placement = plan[1];
  q.hdr = reinterpret_cast<unsigned*>(ws);
  q.slot = reinterpret_cast<unsigned long long*>(ws + kHdInts);
  q.blk = ws + kHdInts + 2 * 2 * (2 * (size_t)E + 4);
  q.E = E; q.M = M; q.eps = eps; q.bf_max = bf_max;
  q.ncb = plan[2]; q.ls = plane_stride(E);
  q.blk_ints = blk_ints(E, q.ncb, q.ls, placement);
  q.ring = ring_cap > 0 ? ring : nullptr;
  q.ring_slot = ring_slot; q.ring_cap = ring_cap;
  void* args[] = {&q};
  const Kernel kern = kernel_for(placement);
  // The kernel's shared-memory limit is per function, not per launch: set
  // it for this launch's size, which another shape's plan may have lowered.
  const size_t smem = sizeof(int) * smem_ints(E, q.ncb, q.ls, placement);
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (rc == cudaSuccess)
    rc = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), args, smem,
                                     (cudaStream_t)stream);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free launch error
    return (int)rc;
  }
  return (int)cudaGetLastError();
}

// B1's column cluster: the whole epsilon ladder of one solve as one launch
// of a thread-block cluster of k CTAs (8, or 16 where 8 do not fit), each
// on its own SM, that split the plane's machine columns among them.  The
// transpose of the row cluster (fused_ladder.cu, fused_ladder_cluster_
// kernel), for the skinny planes it cannot hold: under 16 rows one row a
// CTA left each CTA one row of work and every CTA recomputed every
// column, and at [8, 10240] a row share with every [M] vector is ~640 KB.
// Same arithmetic, same update order, int32 throughout: flows, prices,
// stats with the per-phase iterations and the telemetry ring are
// bit-equal to the one-SM kernel's and to the plain ladder's
// (ops/transport.py::_solve_device), since integer sums, minima, maxima
// and ORs do not depend on how they are split.
//
// Design (512 threads a CTA, 16 warps):
// - CTA r holds columns [r W, r W + W) (W = ceil(M / k) rounded up to 4)
//   of C, Uem, F, the pushes P (shared with a global update's forward
//   lengths) and the reverse lengths, 20 bytes a cell, with its columns'
//   [W] vectors (cap, pm, Fmt, exc_m, the sink pushes' prefix, the
//   relabel candidates, whose span a global update's distances reuse).
//   Every CTA holds every [E] vector and computes every row's finish
//   alike from the same exchanged partials, so no row result needs a
//   second exchange.  F, Fmt and pm are loaded at entry and written back
//   at exit; pe, Ffb and pt by rank 0.  (slab_layout, mirrored in
//   ops/transport_fused.py::slab_smem_bytes.)
// - Column stages are local: a thread owns whole columns (the excess
//   sums, the push sweep's column pass with its prefix down the column,
//   the Bellman-Ford column pass).
// - Row stages run one warp per (row, chunk segment) unit over the CTA's
//   columns, a lane four adjacent columns (int4 loads), and their
//   per-row partials cross the cluster.  A row's prefix over machines is
//   the two-pass segmented scan with the CTAs as the outer segments:
//   pass 1 sends each slab's E row sums of res, pass 2 walks the slab
//   from the sum of the slabs before it.  The sink row's machine part is
//   the same scan over the slabs; every CTA then scans the E-long EC part
//   alike from the machines' total.
// - An exchange: each CTA stores its n partials into slot [its rank] of
//   every CTA's buffer (st.shared::cluster), then the cluster barrier;
//   each CTA then combines the k slots in rank order.  Consecutive
//   exchanges alternate between two buffers, so a buffer is written again
//   only after the next barrier, by which every CTA has read it.  Work
//   that reads no buffer runs between a barrier's arrive and its wait.
// - Cluster barriers: 2 a push/relabel iteration (the rows' pass-1 sums
//   with the sink's machine sums; the rows' pushes and post-push
//   partials with the columns' sink and entering-state partials, after
//   which every CTA finishes the rows, the sink and the next entering
//   state alike), 1 a Bellman-Ford sweep (the rows' minima with the
//   columns' sink minimum and change flag), 1 a global update (its
//   convergence check), 1 an epsilon phase (the excesses with the
//   entering state).  The local relabel needs none.
// - Which path (ops/transport_fused.py::ladder_slab_ctas, from the shape
//   alone, where the row cluster declines): from 128 columns, M a
//   multiple of 4, the first of 8 or 16 CTAs whose slabs fit a CTA's
//   227 KB.  Against the one-SM kernel at 8 rows (seeded instances, B1's
//   launch alone; NVIDIA H100 80GB HBM3, 700 W): [8, 64] 1.06x over 8
//   CTAs, [8, 128] 1.23x, [8, 256] 1.29x, [8, 1024] 1.54x, [8, 4096]
//   3.71x, [8, 10240] 7.37x over 16 CTAs (15.4 against 113.5 ms); 8 CTAs
//   beat 16 wherever both fit at 8 rows.  Taller planes whose row shares
//   do not fit: 3.8x to 6.1x ([16, 5120], [32, 4096], [64, 2048]).  The
//   gate starts at 128 columns because [8, 64]'s few percent cost eight
//   SMs in place of one.

#include <cooperative_groups.h>

#include <cstddef>

#include "common.cuh"
#include "ladder.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCtas = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// A row stage's lane takes four adjacent columns, so a chunk is 128.
constexpr int kQuad = 4;
using Rows = RowUnitsOf<kWarps, 32 * kQuad>;

// The global operands (as the one-SM kernel's Planes; no workspace).
struct Global {
  const int* C;    // [E, M] (read-only)
  const int* U;    // [E] (read-only)
  const int* sup;  // [E] (read-only)
  const int* cap;  // [M] (read-only)
  const int* Uem;  // [E, M] (read-only)
  int* F;          // [E, M] flows (state, in place)
  int* Ffb;        // [E]
  int* Fmt;        // [M]
  int* pe;         // [E]
  int* pm;         // [M]
  int* pt;         // [1]
  int* ring;       // [8, ring_cap] telemetry samples, or null
  int E, M, ring_cap;
};

// The CTA's scalars that warp 0 hands every thread after an exchange.
struct Scalars {
  long long pos;             // the entering state's positive excess
  int cnt;                   // its rows | columns << 16 with positive excess
  int exc_t, hadm_t, cand_t;  // the sink's excess and relabel inputs
  int dt, any;               // a Bellman-Ford sweep's sink distance, change
  int nz;                    // some excess left (the end's check)
  int tel[8];                // the telemetry sample (rank 0)
};
constexpr int kScalarBytes = 128;
static_assert(sizeof(Scalars) <= kScalarBytes, "Scalars outgrew its slot");

int imax(int a, int b) { return a > b ? a : b; }

// Offsets, in ints from the start of the dynamic shared memory, of the
// column cluster's arrays (set on the host by slab_layout).
struct SlabLayout {
  int W;   // columns a CTA holds (a multiple of 4)
  int nx;  // ints a CTA sends in the widest exchange
  // [E, W]: this CTA's columns of C, Uem and F; the push sweep's P, which
  // a global update reuses for its forward lengths Lf; the reverse lengths.
  int C, Uem, F, PL, Lr;
  // [E]: every row, in every CTA.
  int U, sup, pe, Ffb, exc_e, tpe, cand_e, hadm_e, de0, de1;
  // [W]: this CTA's columns.  A global update's distances dm0 and dm1
  // share cand_m and hadm_m, dead while it runs.
  int cap, pm, Fmt, exc_m, tpm, cand_m, hadm_m, dm0, dm1;
  int part;   // [5, units] row-unit partials (units <= max(E, kWarps))
  int wpart;  // [8, kWarps] column stages' per-warp partials
  int xbuf;   // [2, k, nx] exchange slots, by parity and sender
  int ints;   // the whole size
};

SlabLayout slab_layout(int E, int M, int k) {
  SlabLayout L;
  L.W = (M + 4 * k - 1) / (4 * k) * 4;
  L.nx = 4 * E + 6;
  const int W = L.W, nx = L.nx;
  int o = kScalarBytes / 4;
  // Every array starts on 16 bytes (the row stages' four-column loads).
  auto take = [&](int n) { int at = o; o += (n + 3) & ~3; return at; };
  L.C = take(E * W); L.Uem = take(E * W); L.F = take(E * W);
  L.PL = take(E * W); L.Lr = take(E * W);
  L.U = take(E); L.sup = take(E); L.pe = take(E); L.Ffb = take(E);
  L.exc_e = take(E); L.tpe = take(E); L.cand_e = take(E); L.hadm_e = take(E);
  L.de0 = take(E); L.de1 = take(E);
  L.cap = take(W); L.pm = take(W); L.Fmt = take(W); L.exc_m = take(W);
  L.tpm = take(W); L.cand_m = take(W); L.hadm_m = take(W);
  L.dm0 = L.cand_m; L.dm1 = L.hadm_m;
  L.part = take(5 * imax(E, kWarps));
  L.wpart = take(8 * kWarps);
  L.xbuf = take(2 * k * nx);
  L.ints = o;
  return L;
}

size_t slab_smem_bytes(int E, int M, int k) {
  return sizeof(int) * (size_t)slab_layout(E, M, k).ints;
}

extern __shared__ __align__(16) int sm[];

__device__ __forceinline__ Scalars& scalars() { return *reinterpret_cast<Scalars*>(sm); }

// A CTA's place in the cluster and the cluster-uniform scalars, held by
// every thread (each computes them alike).
struct Ctx {
  int rank, k, E, M;
  int c0, cols;  // this CTA's columns [c0, c0 + cols) of the plane
  int par;       // buffer parity of the next exchange
  int pt, exc_t, hadm_t, cand_t;
};

__device__ __forceinline__ int4 quad(int off) { return *reinterpret_cast<const int4*>(sm + off); }
__device__ __forceinline__ void set_quad(int off, int4 v) { *reinterpret_cast<int4*>(sm + off) = v; }
__device__ __forceinline__ int at4(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- exchange

// Slot of sender j's value i in this CTA's buffer of parity p.
__device__ __forceinline__ int slot(const SlabLayout& L, const Ctx& c, int p, int j, int i) {
  return L.xbuf + (p * c.k + j) * L.nx + i;
}

// Store v into CTA `rank`'s int at offset `off` (st, not waited on:
// ordered before the sender's next cluster barrier arrival).
__device__ __forceinline__ void put(int off, int rank, int v) {
  unsigned local = (unsigned)__cvta_generic_to_shared(sm + off), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote), "r"(v) : "memory");
}

// The first half of an exchange: this CTA's n values, val(i), into its
// slot of every CTA's buffer, one (value, target) pair a thread; then the
// barrier's arrive.  The caller runs what reads no buffer, then
// cluster_wait(), then reads the slots of parity `p` (returned).
template <typename Val>
__device__ int send(const SlabLayout& L, Ctx& c, int n, Val val) {
  const int p = c.par;
  for (int t = threadIdx.x; t < n * c.k; t += kThreads) {
    const int j = t / n, i = t - j * n;
    put(slot(L, c, p, c.rank, i), j, val(i));
  }
  cluster_arrive();
  c.par ^= 1;
  return p;
}

// A long long as two ints (low, high), as the partials and exchanges
// hold it, and back.
__device__ __forceinline__ int lo32(long long v) { return (int)(unsigned)(unsigned long long)v; }
__device__ __forceinline__ int hi32(long long v) { return (int)(unsigned)((unsigned long long)v >> 32); }
__device__ __forceinline__ long long pair64(int lo, int hi) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

// The k senders' value i, combined in rank order: sums, over senders
// before this CTA or all; minima, maxima and ORs.
__device__ __forceinline__ int xsum(const SlabLayout& L, const Ctx& c, int p, int i, int upto) {
  int s = 0;
  for (int j = 0; j < upto; ++j) s += sm[slot(L, c, p, j, i)];
  return s;
}
__device__ __forceinline__ long long xsum64(const SlabLayout& L, const Ctx& c, int p, int i) {
  long long s = 0;
  for (int j = 0; j < c.k; ++j) s += pair64(sm[slot(L, c, p, j, i)], sm[slot(L, c, p, j, i + 1)]);
  return s;
}
template <typename Op>
__device__ __forceinline__ int xreduce(const SlabLayout& L, const Ctx& c, int p, int i, Op op,
                                       int identity) {
  int r = identity;
  for (int j = 0; j < c.k; ++j) r = op(r, sm[slot(L, c, p, j, i)]);
  return r;
}

// ---------------------------------------------------------------- stages

// Slab and vectors in from global memory.
__device__ void load(const Global& g, const SlabLayout& L, const Ctx& c) {
  const int E = c.E, W = L.W;
  for (int e = 0; e < E; ++e) {
    const size_t base = (size_t)e * c.M + c.c0;
    for (int m = threadIdx.x; m < c.cols; m += kThreads) {
      const int i = e * W + m;
      sm[L.C + i] = __ldg(g.C + base + m);
      sm[L.Uem + i] = __ldg(g.Uem + base + m);
      sm[L.F + i] = g.F[base + m];
    }
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    sm[L.U + e] = __ldg(g.U + e);
    sm[L.sup + e] = __ldg(g.sup + e);
    sm[L.pe + e] = g.pe[e];
    sm[L.Ffb + e] = g.Ffb[e];
  }
  for (int m = threadIdx.x; m < c.cols; m += kThreads) {
    sm[L.cap + m] = __ldg(g.cap + c.c0 + m);
    sm[L.pm + m] = g.pm[c.c0 + m];
    sm[L.Fmt + m] = g.Fmt[c.c0 + m];
  }
}

// Refine to eps (the one-SM kernel's refine, on the slab, every row and
// this CTA's columns).
__device__ void refine(const SlabLayout& L, const Ctx& c, int eps, int pt0) {
  for (int e = 0; e < c.E; ++e) {
    const int pe_e = sm[L.pe + e];
    for (int m = threadIdx.x; m < c.cols; m += kThreads) {
      const int i = e * L.W + m;
      int rc = rc_em(sm[L.C + i], pe_e, sm[L.pm + m]);
      if (rc < -eps) sm[L.F + i] = sm[L.Uem + i];
      else if (rc > eps) sm[L.F + i] = 0;
    }
  }
  for (int e = threadIdx.x; e < c.E; e += kThreads) {
    int rc = sm[L.U + e] + sm[L.pe + e] - pt0;
    if (rc < -eps) sm[L.Ffb + e] = sm[L.sup + e];
    else if (rc > eps) sm[L.Ffb + e] = 0;
  }
  for (int m = threadIdx.x; m < c.cols; m += kThreads) {
    int rc = sm[L.pm + m] - pt0;
    if (rc < -eps) sm[L.Fmt + m] = sm[L.cap + m];
    else if (rc > eps) sm[L.Fmt + m] = 0;
  }
  __syncthreads();
}

// The entering state and the sink's excess, as warp 0 hands them on.
struct ColPart { long long pos; int cnt, fsum, nz; };
struct ColPartOp {
  __device__ ColPart operator()(ColPart a, ColPart b) const {
    return {a.pos + b.pos, a.cnt + b.cnt, a.fsum + b.fsum, a.nz | b.nz};
  }
};

// Excesses from the flow state: exc_e (every row, from the CTAs' row
// sums), exc_m (this CTA's columns) and c.exc_t; returns the entering
// state, and in *nz whether some excess is left.  One cluster barrier.
__device__ Enter excesses(const SlabLayout& L, Ctx& c, int total, int* nz) {
  const int E = c.E, W = L.W;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const Rows ru(E, c.cols);
  int* rsum = sm + L.part;
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    int acc = 0;
    for (int ch = c0; ch < c1; ++ch) {
      const int m = (ch * 32 + lane) * kQuad;
      if (m < c.cols) {
        const int4 f = quad(L.F + e * W + m);
        acc += f.x + f.y + f.z + f.w;
      }
    }
    acc = pt_warp_reduce(acc, PtSum());
    if (lane == 0) rsum[u] = acc;
  }
  // This CTA's columns: exc_m, and their share of the sink's excess, the
  // entering state and the end's check.
  ColPart cp{0, 0, 0, 0};
  for (int m = threadIdx.x; m < c.cols; m += kThreads) {
    int s = 0;
    for (int e = 0; e < E; ++e) s += sm[L.F + e * W + m];
    const int fmt = sm[L.Fmt + m], x = s - fmt;
    sm[L.exc_m + m] = x;
    cp.fsum += fmt;
    cp.pos += max(x, 0);
    cp.cnt += x > 0 ? kColUnit : 0;
    cp.nz |= x != 0;
  }
  cp = pt_warp_reduce(cp, ColPartOp());
  int* wp = sm + L.wpart;
  if (lane == 0) {
    wp[w] = lo32(cp.pos);
    wp[kWarps + w] = hi32(cp.pos);
    wp[2 * kWarps + w] = cp.cnt;
    wp[3 * kWarps + w] = cp.fsum;
    wp[4 * kWarps + w] = cp.nz;
  }
  __syncthreads();
  // Sent: the rows' sums [E], then the columns' pos (two ints), cnt, the
  // sum of Fmt and the nonzero flag.
  const int p = send(L, c, E + 5, [&](int i) {
    if (i < E) {
      int s = 0;
      for (int q = 0; q < ru.segs; ++q) s += rsum[q * E + i];
      return s;
    }
    const int f = i - E;
    if (f < 2) {
      long long s = 0;
      for (int v = 0; v < kWarps; ++v) s += pair64(wp[v], wp[kWarps + v]);
      return f == 0 ? lo32(s) : hi32(s);
    }
    int s = 0;
    for (int v = 0; v < kWarps; ++v) s = f == 4 ? (s | wp[f * kWarps + v]) : s + wp[f * kWarps + v];
    return s;
  });
  cluster_wait();
  // Every row's excess, and the whole cluster's entering state, in warp 0.
  if (w == 0) {
    ColPart rp{0, 0, 0, 0};
    for (int e = lane; e < E; e += 32) {
      const int ffb = sm[L.Ffb + e];
      const int x = sm[L.sup + e] - xsum(L, c, p, e, c.k) - ffb;
      sm[L.exc_e + e] = x;
      rp.fsum += ffb;
      rp.pos += max(x, 0);
      rp.cnt += x > 0;
      rp.nz |= x != 0;
    }
    rp = pt_warp_reduce(rp, ColPartOp());
    if (lane == 0) {
      Scalars& s = scalars();
      s.pos = rp.pos + xsum64(L, c, p, E);
      s.cnt = rp.cnt + xsum(L, c, p, E + 2, c.k);
      s.exc_t = rp.fsum + xsum(L, c, p, E + 3, c.k) - total;
      s.nz = rp.nz | xreduce(L, c, p, E + 4, PtOr(), 0);
    }
  }
  __syncthreads();
  const Scalars& s = scalars();
  c.exc_t = s.exc_t;
  *nz = s.nz;
  return Enter{s.pos, s.cnt};
}

// The columns' and the rows' shares of the sink's relabel inputs and of
// the next entering state.
struct SinkEnter { long long pos; int sum, hadm, cand, cnt; };
struct SinkEnterOp {
  __device__ SinkEnter operator()(SinkEnter a, SinkEnter b) const {
    return {a.pos + b.pos, a.sum + b.sum, a.hadm | b.hadm, max(a.cand, b.cand), a.cnt + b.cnt};
  }
};

// One push sweep + new excesses + relabel candidates (prices frozen);
// returns the next iteration's entering state.  Two cluster barriers.
__device__ Enter push_sweep(const SlabLayout& L, Ctx& c, int total) {
  const int E = c.E, W = L.W, cols = c.cols;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = c.pt, exc_t = c.exc_t;
  const Rows ru(E, cols);
  const int nu = max(E, kWarps);
  int* rres = sm + L.part;                               // [units] sums of res
  int* rpush = sm + L.part + nu;                         // [units] sums of the pushes
  Sink* rsink = reinterpret_cast<Sink*>(sm + L.part + 2 * nu);  // [units] post-push
  int* wp = sm + L.wpart;
  // The res of the lane's four columns of chunk ch (0 past the slab).
  auto row_res = [&](int e, int xe, int pe_e, int ch) {
    const int m = (ch * 32 + lane) * kQuad;
    int4 r = make_int4(0, 0, 0, 0);
    if (m < cols && xe > 0) {
      const int idx = e * W + m;
      const int4 cst = quad(L.C + idx), u = quad(L.Uem + idx), f = quad(L.F + idx);
      const int4 pm = quad(L.pm + m);
      r.x = rc_em(cst.x, pe_e, pm.x) < 0 ? u.x - f.x : 0;
      r.y = rc_em(cst.y, pe_e, pm.y) < 0 ? u.y - f.y : 0;
      r.z = rc_em(cst.z, pe_e, pm.z) < 0 ? u.z - f.z : 0;
      r.w = rc_em(cst.w, pe_e, pm.w) < 0 ? u.w - f.w : 0;
    }
    return r;
  };
  // The sink row's res at this CTA's machine m (pre-push Fmt).
  auto sink_res_m = [&](int m) {
    return (exc_t > 0 && -(sm[L.pm + m] - pt) < 0) ? sm[L.Fmt + m] : 0;
  };
  // Pass 1: each row unit's sum of res; the slab's sum of the sink row's
  // machine part.
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    const int xe = sm[L.exc_e + e], pe_e = sm[L.pe + e];
    int sum = 0;
    for (int ch = c0; ch < c1; ++ch) {
      const int4 r = row_res(e, xe, pe_e, ch);
      sum += r.x + r.y + r.z + r.w;
    }
    sum = pt_warp_reduce(sum, PtSum());
    if (lane == 0) rres[u] = sum;
  }
  {
    int acc = 0;
    for (int m = threadIdx.x; m < cols; m += kThreads) acc += sink_res_m(m);
    acc = pt_warp_reduce(acc, PtSum());
    if (lane == 0) wp[w] = acc;
  }
  __syncthreads();
  int p = send(L, c, E + 1, [&](int i) {
    int s = 0;
    if (i < E)
      for (int q = 0; q < ru.segs; ++q) s += rres[q * E + i];
    else
      for (int v = 0; v < kWarps; ++v) s += wp[v];
    return s;
  });
  // Between the halves: warp 0 scans the sink row's machine part over
  // this CTA's columns, into tpm as each column's exclusive prefix.
  if (w == 0 && exc_t > 0) {
    int carry = 0;
    for (int b = 0; b < cols; b += 32 * kQuad) {
      const int m = b + lane * kQuad;
      int4 r = make_int4(0, 0, 0, 0);
      if (m < cols) r = make_int4(sink_res_m(m), sink_res_m(m + 1), sink_res_m(m + 2), sink_res_m(m + 3));
      const int s1 = r.x, s2 = s1 + r.y, s3 = s2 + r.z, s4 = s3 + r.w;
      const int incl = pt_warp_incl_scan(s4);
      const int before = carry + incl - s4;
      if (m < cols) set_quad(L.tpm + m, make_int4(before, before + s1, before + s2, before + s3));
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
  }
  cluster_wait();
  // The sink row's machines before this CTA's, and all of them.
  const int sink_before = xsum(L, c, p, E, c.rank);
  const int sink_machines = xsum(L, c, p, E, c.k);
  // Pass 2: each row unit walks its chunks from the sum of res of the
  // slabs before this CTA and of the units before it: the pushes P.
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    const int xe = sm[L.exc_e + e], pe_e = sm[L.pe + e];
    int carry = xsum(L, c, p, e, c.rank), pushed = 0;
    for (int j = 0; j < q; ++j) carry += rres[j * E + e];
    for (int ch = c0; ch < c1; ++ch) {
      const int m = (ch * 32 + lane) * kQuad;
      const int4 r = row_res(e, xe, pe_e, ch);
      const int s1 = r.x, s2 = s1 + r.y, s3 = s2 + r.z, s4 = s3 + r.w;
      const int incl = pt_warp_incl_scan(s4);
      const int before = carry + incl - s4;  // res of the row's columns before m
      int4 pu;
      pu.x = max(min(r.x, xe - before), 0);
      pu.y = max(min(r.y, xe - (before + s1)), 0);
      pu.z = max(min(r.z, xe - (before + s2)), 0);
      pu.w = max(min(r.w, xe - (before + s3)), 0);
      if (m < cols) set_quad(L.PL + e * W + m, pu);
      pushed += pu.x + pu.y + pu.z + pu.w;
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
    pushed = pt_warp_reduce(pushed, PtSum());
    if (lane == 0) rpush[u] = pushed;
  }
  __syncthreads();
  // This CTA's columns: the sink arc first, then reverse arcs in EC
  // order; both sides' pushes applied; the column relabel candidates; the
  // columns' shares of the sink's relabel inputs (old prices, new flows)
  // and of the next entering state.
  SinkEnter k{0, 0, 0, PT_NEG, 0};
  for (int m = threadIdx.x; m < cols; m += kThreads) {
    const ColHead h = col_head_of(sm[L.exc_m + m], sm[L.pm + m], sm[L.Fmt + m], sm[L.cap + m], pt);
    const int tp = exc_t > 0 ? max(min(sink_res_m(m), exc_t - (sink_before + sm[L.tpm + m])), 0) : 0;
    int before = 0, colsum = 0, cand = PT_NEG, hadm = 0;
    for (int e = 0; e < E; ++e) {
      const int idx = e * W + m;
      const int f = sm[L.F + idx], cst = sm[L.C + idx];
      const bool adm = cst < PT_INF_COST;
      const int pe_e = sm[L.pe + e];
      const int rc = adm ? cst + pe_e - h.pm : PT_POS;
      const int res = (rc > 0 && h.left > 0) ? f : 0;
      const int push = max(min(res, h.left - before), 0);
      before += res;
      const int fn = f + sm[L.PL + idx] - push;
      sm[L.F + idx] = fn;
      colsum += fn;
      if (rc > 0 && fn > 0) hadm = 1;
      if (fn > 0 && adm) cand = max(cand, pe_e + cst);
    }
    const int fmt_new = h.fmt + h.mt_push - tp;
    sm[L.Fmt + m] = fmt_new;
    const int x = colsum - fmt_new;
    sm[L.exc_m + m] = x;
    const bool mt_open = h.cap - fmt_new > 0;
    sm[L.hadm_m + m] = ((h.rc_mt < 0 && mt_open) || hadm) ? 1 : 0;
    sm[L.cand_m + m] = max(mt_open ? pt : PT_NEG, cand);
    k.sum += fmt_new;
    if (-(h.pm - pt) < 0 && fmt_new > 0) k.hadm = 1;
    if (fmt_new > 0) k.cand = max(k.cand, h.pm);
    k.pos += max(x, 0);
    k.cnt += x > 0 ? kColUnit : 0;
  }
  k = pt_warp_reduce(k, SinkEnterOp());
  if (lane == 0) {
    wp[w] = k.sum;
    wp[kWarps + w] = k.hadm;
    wp[2 * kWarps + w] = k.cand;
    wp[3 * kWarps + w] = lo32(k.pos);
    wp[4 * kWarps + w] = hi32(k.pos);
    wp[5 * kWarps + w] = k.cnt;
  }
  __syncthreads();
  // EC rows, post-push: each row unit's new flows' sum, relabel candidate
  // and admissible arc over this CTA's columns.
  for (int u = w; u < ru.n; u += kWarps) {
    int e, q, c0, c1;
    ru.at(u, e, q, c0, c1);
    const int pe_e = sm[L.pe + e];
    Sink s{0, 0, PT_NEG};
    for (int ch = c0; ch < c1; ++ch) {
      const int m = (ch * 32 + lane) * kQuad;
      if (m >= cols) continue;
      const int idx = e * W + m;
      const int4 f4 = quad(L.F + idx), c4 = quad(L.C + idx), u4 = quad(L.Uem + idx);
      const int4 pm4 = quad(L.pm + m);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const int fn = at4(f4, i), cst = at4(c4, i), pm_m = at4(pm4, i);
        const bool adm = cst < PT_INF_COST;
        const int rc = adm ? cst + pe_e - pm_m : PT_POS;
        const bool has_em = at4(u4, i) - fn > 0;
        s.sum += fn;
        if (rc < 0 && has_em) s.hadm = 1;
        if (has_em && adm) s.cand = max(s.cand, pm_m - cst);
      }
    }
    s = pt_warp_reduce(s, SinkOp());
    if (lane == 0) rsink[u] = s;
  }
  __syncthreads();
  // Sent: per row its pushes, new flows' sum, admissible arc and
  // candidate [4, E]; then the columns' sink sum, admissible arc and
  // candidate, positive excess (two ints) and count.
  p = send(L, c, 4 * E + 6, [&](int i) {
    if (i < 4 * E) {
      const int f = i / E, e = i - f * E;
      if (f == 0) {
        int s = 0;
        for (int q = 0; q < ru.segs; ++q) s += rpush[q * E + e];
        return s;
      }
      Sink s{0, 0, PT_NEG};
      for (int q = 0; q < ru.segs; ++q) s = SinkOp()(s, rsink[q * E + e]);
      return f == 1 ? s.sum : f == 2 ? s.hadm : s.cand;
    }
    const int f = i - 4 * E;
    if (f == 3 || f == 4) {
      long long s = 0;
      for (int v = 0; v < kWarps; ++v) s += pair64(wp[3 * kWarps + v], wp[4 * kWarps + v]);
      return f == 3 ? lo32(s) : hi32(s);
    }
    int s = f == 2 ? PT_NEG : 0;
    for (int v = 0; v < kWarps; ++v) {
      const int x = wp[f * kWarps + v];
      s = f == 0 || f == 5 ? s + x : f == 1 ? (s | x) : max(s, x);
    }
    return s;
  });
  // Between the halves: warp 0 takes the sink row's EC part, the same in
  // every CTA, from the machines' total (pre-push Ffb).
  if (w == 0) {
    int carry = sink_machines;
    for (int b = 0; b < E; b += 32) {
      const int e = b + lane;
      const int res = (e < E && exc_t > 0 && -(sm[L.U + e] + sm[L.pe + e] - pt) < 0) ? sm[L.Ffb + e] : 0;
      const int incl = pt_warp_incl_scan(res);
      const int before = carry + incl - res;
      if (e < E) sm[L.tpe + e] = max(min(res, exc_t - before), 0);
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
  }
  cluster_wait();
  // Every row's fallback push, fallback flow, excess and relabel
  // candidates; then the sink's and the next entering state's totals.
  if (w == 0) {
    SinkEnter r{0, 0, 0, PT_NEG, 0};
    for (int e = lane; e < E; e += 32) {
      const int pushed = xsum(L, c, p, e, c.k);
      const int sum = xsum(L, c, p, E + e, c.k);
      const int hadm = xreduce(L, c, p, 2 * E + e, PtOr(), 0);
      const int cand = xreduce(L, c, p, 3 * E + e, PtMax(), PT_NEG);
      const int sup = sm[L.sup + e], u = sm[L.U + e], pe_e = sm[L.pe + e];
      const int ffb0 = sm[L.Ffb + e];
      const int left = sm[L.exc_e + e] - pushed;
      const int rfb = u + pe_e - pt;
      const int fbp = (rfb < 0 && left > 0) ? min(sup - ffb0, left) : 0;
      const int ffb = ffb0 + fbp - sm[L.tpe + e];
      sm[L.Ffb + e] = ffb;
      const int x = sup - sum - ffb;
      sm[L.exc_e + e] = x;
      const bool fb_open = sup - ffb > 0;
      sm[L.hadm_e + e] = (hadm || (rfb < 0 && fb_open)) ? 1 : 0;
      sm[L.cand_e + e] = max(cand, fb_open ? pt - u : PT_NEG);
      r.sum += ffb;
      if (-(u + pe_e - pt) < 0 && ffb > 0) r.hadm = 1;
      if (ffb > 0) r.cand = max(r.cand, pe_e + u);
      r.pos += max(x, 0);
      r.cnt += x > 0;
    }
    r = pt_warp_reduce(r, SinkEnterOp());
    if (lane == 0) {
      const int b = 4 * E;
      Scalars& s = scalars();
      s.exc_t = r.sum + xsum(L, c, p, b, c.k) - total;
      s.hadm_t = r.hadm | xreduce(L, c, p, b + 1, PtOr(), 0);
      s.cand_t = max(r.cand, xreduce(L, c, p, b + 2, PtMax(), PT_NEG));
      s.pos = r.pos + xsum64(L, c, p, b + 3);
      s.cnt = r.cnt + xsum(L, c, p, b + 5, c.k);
    }
  }
  __syncthreads();
  const Scalars& s = scalars();
  c.exc_t = s.exc_t;
  c.hadm_t = s.hadm_t;
  c.cand_t = s.cand_t;
  return Enter{s.pos, s.cnt};
}

__device__ void local_relabel(const SlabLayout& L, Ctx& c, int eps) {
  for (int e = threadIdx.x; e < c.E; e += kThreads)
    sm[L.pe + e] = pt_relabel(sm[L.cand_e + e], sm[L.hadm_e + e] != 0, sm[L.exc_e + e],
                              sm[L.pe + e], eps);
  for (int m = threadIdx.x; m < c.cols; m += kThreads)
    sm[L.pm + m] = pt_relabel(sm[L.cand_m + m], sm[L.hadm_m + m] != 0, sm[L.exc_m + m],
                              sm[L.pm + m], eps);
  c.pt = pt_relabel(c.cand_t, c.hadm_t != 0, c.exc_t, c.pt, eps);
  __syncthreads();
}

// Global price update (the one-SM global_update) on the post-push state
// with the frozen prices.  One cluster barrier a sweep: the rows' minima
// over each CTA's columns, with the columns' sink minimum and change
// flag; every CTA finishes every row.  Returns the BF sweeps spent.
__device__ int global_update(const SlabLayout& L, Ctx& c, int eps, int bf_max) {
  const int E = c.E, W = L.W, cols = c.cols;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = c.pt;
  const PtDivisor dv(eps);
  for (int e = 0; e < E; ++e) {
    const int pe_e = sm[L.pe + e];
    for (int m = threadIdx.x; m < cols; m += kThreads) {
      const int i = e * W + m;
      const int cst = sm[L.C + i], f = sm[L.F + i];
      const bool adm = cst < PT_INF_COST;
      const int x = cst + pe_e - sm[L.pm + m];
      const int lf = adm ? pt_floordiv(x, dv) + 1 : PT_DINF;
      const int lr = adm ? pt_floordiv(-x, dv) + 1 : PT_DINF;
      sm[L.PL + i] = sm[L.Uem + i] - f > 0 ? lf : PT_CLOSED;
      sm[L.Lr + i] = f > 0 ? lr : PT_CLOSED;
    }
  }
  int de = L.de0, de_n = L.de1, dm = L.dm0, dm_n = L.dm1;
  for (int e = threadIdx.x; e < E; e += kThreads) sm[de + e] = sm[L.exc_e + e] < 0 ? 0 : PT_DINF;
  for (int m = threadIdx.x; m < cols; m += kThreads) sm[dm + m] = sm[L.exc_m + m] < 0 ? 0 : PT_DINF;
  int dt = c.exc_t < 0 ? 0 : PT_DINF;
  __syncthreads();
  const Rows ru(E, cols);
  int* rmin = sm + L.part;
  int* wp = sm + L.wpart;
  int sweeps = 0;
  bool changed = true;
  while (changed && sweeps <= bf_max) {
    int any = 0;            // some row or column moved (any sweep of the four)
    bool dt_moved = false;  // the sink moved
    for (int k4 = 0; k4 < 4; ++k4) {
      // EC rows via machines (forward arcs): each unit's minimum over
      // this CTA's columns.
      for (int u = w; u < ru.n; u += kWarps) {
        int e, q, c0, c1;
        ru.at(u, e, q, c0, c1);
        int best = PT_DINF;
        for (int ch = c0; ch < c1; ++ch) {
          const int m = (ch * 32 + lane) * kQuad;
          if (m >= cols) continue;
          const int4 l4 = quad(L.PL + e * W + m), d4 = quad(dm + m);
#pragma unroll
          for (int i = 0; i < kQuad; ++i) {
            const int l = at4(l4, i);
            best = l != PT_CLOSED ? min(best, l + at4(d4, i)) : best;
          }
        }
        best = pt_warp_reduce(best, PtMin());
        if (lane == 0) rmin[u] = best;
      }
      // This CTA's columns: via reverse arcs to ECs and via the sink arc;
      // and their share of the sink's minimum via reverse machine arcs.
      Sweep col{PT_DINF, 0};
      for (int m = threadIdx.x; m < cols; m += kThreads) {
        int best = PT_DINF;
        for (int e = 0; e < E; ++e) {
          const int l = sm[L.Lr + e * W + m];
          best = l != PT_CLOSED ? min(best, l + sm[de + e]) : best;
        }
        const int pm_m = sm[L.pm + m], fmt = sm[L.Fmt + m], dm_m = sm[dm + m];
        const int via_t = (sm[L.cap + m] - fmt > 0) ? pt_floordiv(pm_m - pt, dv) + 1 + dt : PT_DINF;
        const int nv = min(dm_m, min(best, via_t));
        sm[dm_n + m] = nv;
        if (nv != dm_m) col.any = 1;
        if (fmt > 0) col.tb = min(col.tb, pt_floordiv(-(pm_m - pt), dv) + 1 + dm_m);
      }
      col = pt_warp_reduce(col, SweepOp());
      if (lane == 0) {
        wp[w] = col.tb;
        wp[kWarps + w] = col.any;
      }
      __syncthreads();
      // Sent: the rows' minima [E], the columns' sink minimum and flag.
      const int p = send(L, c, E + 2, [&](int i) {
        if (i < E) {
          int best = PT_DINF;
          for (int q = 0; q < ru.segs; ++q) best = min(best, rmin[q * E + i]);
          return best;
        }
        int s = i == E ? PT_DINF : 0;
        for (int v = 0; v < kWarps; ++v)
          s = i == E ? min(s, wp[v]) : (s | wp[kWarps + v]);
        return s;
      });
      // Between the halves: warp 0 takes the sink's minimum via the
      // reverse fallback arcs, the same in every CTA.
      int tb_rows = PT_DINF;
      if (w == 0) {
        for (int e = lane; e < E; e += 32)
          if (sm[L.Ffb + e] > 0)
            tb_rows = min(tb_rows, pt_floordiv(-(sm[L.U + e] + sm[L.pe + e] - pt), dv) + 1 + sm[de + e]);
        tb_rows = pt_warp_reduce(tb_rows, PtMin());
      }
      cluster_wait();
      // Every row: the CTAs' minima, and via the fallback arc; the sink.
      if (w == 0) {
        int moved = 0;
        for (int e = lane; e < E; e += 32) {
          const int best = xreduce(L, c, p, e, PtMin(), PT_DINF);
          const int rfb = sm[L.U + e] + sm[L.pe + e] - pt;
          const int via_t = (sm[L.sup + e] - sm[L.Ffb + e] > 0) ? pt_floordiv(rfb, dv) + 1 + dt : PT_DINF;
          const int nv = min(sm[de + e], min(best, via_t));
          sm[de_n + e] = nv;
          if (nv != sm[de + e]) moved = 1;
        }
        moved = __any_sync(PT_FULL, moved);
        if (lane == 0) {
          Scalars& s = scalars();
          s.dt = min(dt, min(tb_rows, xreduce(L, c, p, E, PtMin(), PT_DINF)));
          s.any = moved | xreduce(L, c, p, E + 1, PtOr(), 0);
        }
      }
      __syncthreads();
      const int dt_n = scalars().dt;
      any |= scalars().any;
      if (dt_n != dt) dt_moved = true;
      dt = dt_n;
      int tmp = de; de = de_n; de_n = tmp;
      tmp = dm; dm = dm_n; dm_n = tmp;
    }
    changed = any != 0 || dt_moved;
    sweeps += 4;
  }
  // The largest finite distance: this CTA's columns, then every row and
  // the sink alike.
  int fm = 0;
  for (int m = threadIdx.x; m < cols; m += kThreads) if (sm[dm + m] < PT_DINF) fm = max(fm, sm[dm + m]);
  fm = pt_warp_reduce(fm, PtMax());
  if (lane == 0) wp[w] = fm;
  __syncthreads();
  const int p = send(L, c, 1, [&](int) {
    int s = 0;
    for (int v = 0; v < kWarps; ++v) s = max(s, wp[v]);
    return s;
  });
  cluster_wait();
  fm = xreduce(L, c, p, 0, PtMax(), 0);
  for (int e = 0; e < E; ++e) if (sm[de + e] < PT_DINF) fm = max(fm, sm[de + e]);
  if (dt < PT_DINF) fm = max(fm, dt);
  const bool ok = !changed && fm < (1 << 26) / max(eps, 1);
  if (ok) {
    const int dbig = fm + 1;
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const int d = sm[de + e] >= PT_DINF ? dbig : sm[de + e];
      sm[L.pe + e] = max(sm[L.pe + e] - eps * d, PT_NEG_HALF);
    }
    for (int m = threadIdx.x; m < cols; m += kThreads) {
      const int d = sm[dm + m] >= PT_DINF ? dbig : sm[dm + m];
      sm[L.pm + m] = max(sm[L.pm + m] - eps * d, PT_NEG_HALF);
    }
    const int d = dt >= PT_DINF ? dbig : dt;
    c.pt = max(c.pt - eps * d, PT_NEG_HALF);
  }
  __syncthreads();
  return sweeps;
}

// knobs: [eps_0..eps_3, max_iter, max_iter_total, global_every, bf_max,
//         total supply, adaptive_bf]
// stats: [iters, bf_sweeps, clean, phase_iters_0..3]
__global__ void __launch_bounds__(kThreads, 1)
fused_ladder_columns_kernel(Global g, SlabLayout L, const int* knobs, int* stats) {
  cg::cluster_group cluster = cg::this_cluster();
  Scalars& s = scalars();
  Ctx c;
  c.rank = (int)cluster.block_rank();
  c.k = (int)cluster.num_blocks();
  c.E = g.E;
  c.M = g.M;
  c.c0 = min(c.rank * L.W, g.M);
  c.cols = min(L.W, g.M - c.c0);
  c.par = 0;
  c.exc_t = c.hadm_t = 0;
  c.cand_t = PT_NEG;
  load(g, L, c);
  c.pt = g.pt[0];
  const bool tel = g.ring != nullptr && c.rank == 0 && threadIdx.x == 0;
  const int max_iter = knobs[4], max_iter_total = knobs[5];
  const int global_every = knobs[6], bf_max = knobs[7];
  const int total = knobs[8], adaptive = knobs[9];
  // Every CTA of the cluster runs and holds its slab before any stores
  // into another's shared memory.
  cluster_barrier();
  int tot_it = 0, tot_bf = 0, nz = 0;
  for (int k = 0; k < PT_NUM_PHASES; ++k) {
    const int eps = knobs[k];
    if (tot_it + 64 < max_iter_total) refine(L, c, eps, c.pt);
    Enter en = excesses(L, c, total, &nz);
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
      en = push_sweep(L, c, total);
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
  excesses(L, c, total, &nz);
  // Back to global memory: each CTA its columns, rank 0 the [E] vectors.
  for (int e = 0; e < c.E; ++e) {
    const size_t base = (size_t)e * c.M + c.c0;
    for (int m = threadIdx.x; m < c.cols; m += kThreads) g.F[base + m] = sm[L.F + e * L.W + m];
  }
  for (int m = threadIdx.x; m < c.cols; m += kThreads) {
    g.Fmt[c.c0 + m] = sm[L.Fmt + m];
    g.pm[c.c0 + m] = sm[L.pm + m];
  }
  if (c.rank == 0) {
    for (int e = threadIdx.x; e < c.E; e += kThreads) {
      g.Ffb[e] = sm[L.Ffb + e];
      g.pe[e] = sm[L.pe + e];
    }
    if (threadIdx.x == 0) {
      stats[0] = tot_it;
      stats[1] = tot_bf;
      stats[2] = (nz == 0 && c.exc_t == 0) ? 1 : 0;
      g.pt[0] = c.pt;
    }
  }
}

}  // namespace

// The column cluster's dynamic shared memory a CTA, in bytes, for an
// [E, M] plane over `ctas` CTAs (mirrored by
// ops/transport_fused.py::slab_smem_bytes).
extern "C" size_t pt_fused_ladder_columns_smem_bytes(int E, int M, int ctas) {
  return slab_smem_bytes(E, M, ctas);
}

// How many column clusters of `ctas` CTAs at [E, M] the card can hold at
// once (cudaOccupancyMaxActiveClusters); 0 where it cannot launch one.
extern "C" int pt_fused_ladder_columns_max_clusters(int E, int M, int ctas) {
  if (ctas < 2 || ctas > kMaxCtas) return 0;
  const size_t smem = slab_smem_bytes(E, M, ctas);
  if (cluster_attributes(fused_ladder_columns_kernel, ctas, smem) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(ctas, kThreads, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fused_ladder_columns_kernel, &cfg) != cudaSuccess) n = 0;
  return n;
}

// Plain C entry point: pt_fused_ladder's operands without its workspace,
// over a cluster of `ctas` CTAs (2 to 16; M a multiple of 4).  ``ring`` is
// null or a zeroed [8, ring_cap] int32 telemetry ring of its own; all
// pointers are device pointers.
extern "C" int pt_fused_ladder_columns(const int* C, const int* U, const int* sup,
                                       const int* cap, const int* Uem, int* F, int* Ffb,
                                       int* Fmt, int* pe, int* pm, int* pt,
                                       const int* knobs, int* stats, int* ring, int E,
                                       int M, int ring_cap, int ctas, void* stream) {
  // The entering-state counts pack rows and columns into one int.
  if (E < 1 || E >= kColUnit || M >= (1 << 15)) return (int)cudaErrorInvalidValue;
  if (ctas < 2 || ctas > kMaxCtas || M % kQuad != 0) return (int)cudaErrorInvalidValue;
  Global g = {};
  g.C = C; g.U = U; g.sup = sup; g.cap = cap; g.Uem = Uem;
  g.F = F; g.Ffb = Ffb; g.Fmt = Fmt; g.pe = pe; g.pm = pm; g.pt = pt;
  g.ring = ring_cap > 0 ? ring : nullptr;
  g.ring_cap = ring_cap;
  g.E = E; g.M = M;
  const SlabLayout L = slab_layout(E, M, ctas);
  const size_t smem = sizeof(int) * (size_t)L.ints;
  cudaError_t err = cluster_attributes(fused_ladder_columns_kernel, ctas, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(ctas, kThreads, smem, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_ladder_columns_kernel, g, L, knobs, stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

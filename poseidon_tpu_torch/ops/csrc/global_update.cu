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
// Bound on the H100: bytes.  The update reads C, Uem and F once and each
// sweep touches the arcs once; at [128, 10240] int32 the three planes are
// 15.7 MB, and they and the two length planes stay in the 50 MB L2.
//
// Design.  One persistent cooperative launch runs the whole Bellman-Ford
// loop, convergence test included, so the update makes no host read (the
// reference's while_loop runs on the device too).
//   * Lengths once per update: flows and prices are frozen through the
//     sweeps, so each arc's forward (EC -> machine) and reverse length is
//     computed once into two scratch planes, PT_CLOSED where the arc has no
//     residual capacity, and a sweep only adds and takes minima.  Divides
//     use the magic multiplier (PtDivisor).
//   * Work split: a block owns tiles of kTileCols machine columns across
//     all E rows.  A column's minimum stays inside its block, and so do the
//     column distances d_m.  A row's minimum and the sink's two minima
//     cross blocks through atomicMin on int32: integer minima do not depend
//     on order, so the result is bit-equal to the plain version's.
//   * Where one tile per block fits in shared memory with every tile's
//     block resident at once (the wave's [128, 10240] and [256, 10240]),
//     the block keeps its tile's two length planes there, and a sweep
//     reads no plane from L2 at all; otherwise the planes live in the
//     workspace and a block walks several tiles.
//   * Jacobi sweeps read the old distances.  d_e and d_t rotate through
//     three buffers: in sweep s blocks read buffer s % 3, lower buffer
//     (s + 1) % 3 (set to the unreached marker a sweep earlier), and reset
//     buffer (s + 2) % 3, which nobody reads any more.  One grid barrier
//     per sweep.
//   * Convergence: a block that lowers any distance in a group of four
//     sweeps marks the group's flag; after the group's last barrier every
//     block reads the same flag, so the loop condition (changed && sweeps
//     <= bf_max) is uniform across the grid.
// The sweep count is added to a device counter (the solve's statistics),
// and, with the solve's telemetry ring, written with the fired bit into the
// column of the iteration the update belongs to (the host passes it: it
// reads the phase status before any update).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;
constexpr int kColSegs = kThreads / kTileCols;
static_assert(kTileCols == 32, "the row pass maps one lane to each column");
constexpr int kSweepsPerCheck = 4;

struct Gu {
  const int* C; const int* Uem; const int* U; const int* sup; const int* cap;
  const int* F; const int* Ffb; const int* Fmt; const int* pe; const int* pm;
  const int* pt; const int* exc_e; const int* exc_m; const int* exc_t;
  int* peo; int* pmo; int* pto; int* sweeps_acc;
  // workspace (see pt_global_update_ws_ints)
  int* Lf; int* Lr;        // [E * M] forward / reverse arc lengths
  int* Lfb; int* Ltfb;     // [E] EC -> sink fallback arc and its reverse
  int* Lmt; int* Ltm;      // [M] machine -> sink arc and its reverse
  int* de;                 // [3][E]
  int* dm;                 // [2][M]
  int* dt;                 // [3]
  int* flag;               // [groups]
  int* fmax;               // [1]
  unsigned* bar;           // [2] grid barrier: arrivals, generation
  int* ring;               // [8, ring_cap] telemetry ring, or null
  int E, M, eps, bf_max, groups, tile_smem, ring_slot, ring_cap;
};

// Dynamic shared memory: d_e, and with ``tile_smem`` the block's tile of
// both length planes.
__host__ __device__ size_t smem_bytes(int E, int tile_smem) {
  return sizeof(int) * ((size_t)E + (tile_smem ? 2 * (size_t)E * kTileCols : 0));
}

// The length planes of tile t: (forward, reverse, row stride).
struct TilePlanes {
  int* lf; int* lr; size_t stride;
  __device__ TilePlanes(const Gu& q, int* smem_tile, int t) {
    if (q.tile_smem) {
      lf = smem_tile;
      lr = smem_tile + (size_t)q.E * kTileCols;
      stride = kTileCols;
    } else {
      lf = q.Lf + (size_t)t * kTileCols;
      lr = q.Lr + (size_t)t * kTileCols;
      stride = q.M;
    }
  }
};

// Grid-wide barrier.  The launch is cooperative, so every block is
// resident and spinning cannot deadlock.  The fences order each block's
// writes (published to thread 0 by __syncthreads) before its arrival and
// the other blocks' writes before its reads.  A wait past kBarrierCycles
// (seconds; no sweep takes so long) traps, so a fault ends the launch
// with an error instead of holding the card.
constexpr long long kBarrierCycles = 1LL << 34;

__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        if (clock64() - t0 > kBarrierCycles) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ int len_or_closed(bool open, int x, const PtDivisor& dv) {
  return open ? pt_floordiv(x, dv) + 1 : PT_CLOSED;
}

__device__ __forceinline__ int via(int l, int d) {
  return l != PT_CLOSED ? l + d : PT_DINF;
}

__global__ void __launch_bounds__(kThreads) pt_global_update(Gu q) {
  extern __shared__ int de_s[];  // [E] d_e of the sweep's old buffer
  int* const smem_tile = de_s + q.E;  // with tile_smem: [2][E][kTileCols]
  __shared__ int dm_s[kTileCols];
  __shared__ int part[kColSegs][kTileCols];
  __shared__ int scratch[32];
  const int E = q.E, M = q.M, G = gridDim.x, b = blockIdx.x;
  const int tiles = (M + kTileCols - 1) / kTileCols;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = q.pt[0];
  const PtDivisor dv(q.eps);

  // ---- set-up: lengths, initial distances, flags.
  for (int t = b; t < tiles; t += G) {
    const int c = threadIdx.x % kTileCols, seg = threadIdx.x / kTileCols;
    const int m = t * kTileCols + c;
    const TilePlanes tp(q, smem_tile, t);
    if (m < M) {
      const int pm = q.pm[m];
#pragma unroll 4
      for (int e = seg; e < E; e += kColSegs) {
        const size_t i = (size_t)e * M + m;
        const int cst = __ldg(q.C + i), f = __ldg(q.F + i), u = __ldg(q.Uem + i);
        const bool adm = cst < PT_INF_COST;
        const int x = cst + q.pe[e] - pm;
        const int lf = adm ? pt_floordiv(x, dv) + 1 : PT_DINF;
        const int lr = adm ? pt_floordiv(-x, dv) + 1 : PT_DINF;
        tp.lf[e * tp.stride + c] = u - f > 0 ? lf : PT_CLOSED;
        tp.lr[e * tp.stride + c] = f > 0 ? lr : PT_CLOSED;
      }
      if (seg == 0) {
        const int fmt = q.Fmt[m];
        q.Lmt[m] = len_or_closed(q.cap[m] - fmt > 0, pm - pt, dv);
        q.Ltm[m] = len_or_closed(fmt > 0, -(pm - pt), dv);
        q.dm[m] = q.exc_m[m] < 0 ? 0 : PT_DINF;
      }
    }
  }
  for (int e = b + G * (int)threadIdx.x; e < E; e += G * kThreads) {
    const int ffb = q.Ffb[e], r = q.U[e] + q.pe[e] - pt;
    q.Lfb[e] = len_or_closed(q.sup[e] - ffb > 0, r, dv);
    q.Ltfb[e] = len_or_closed(ffb > 0, -r, dv);
    q.de[e] = q.exc_e[e] < 0 ? 0 : PT_DINF;
    q.de[E + e] = PT_DINF;
  }
  if (b == 0) {
    for (int g = threadIdx.x; g < q.groups; g += kThreads) q.flag[g] = 0;
    if (threadIdx.x == 0) {
      q.dt[0] = q.exc_t[0] < 0 ? 0 : PT_DINF;
      q.dt[1] = PT_DINF;
      q.fmax[0] = 0;
    }
  }
  grid_sync(q.bar);

  // ---- Jacobi sweeps, four per convergence check.
  int sweeps = 0;
  bool changed = true;
  while (changed && sweeps <= q.bf_max) {
    const int group = sweeps / kSweepsPerCheck;
    for (int k = 0; k < kSweepsPerCheck; ++k) {
      const int s = sweeps + k;
      const int* de_old = q.de + (s % 3) * E;
      int* de_new = q.de + ((s + 1) % 3) * E;
      int* de_free = q.de + ((s + 2) % 3) * E;
      const int* dm_old = q.dm + (s & 1) * M;
      int* dm_new = q.dm + ((s + 1) & 1) * M;
      for (int e = threadIdx.x; e < E; e += kThreads) de_s[e] = __ldcg(de_old + e);
      const int dt_old = __ldcg(q.dt + s % 3);
      int moved = 0;
      int sink = PT_DINF;  // this block's candidates for the sink
      __syncthreads();
      // The rows this block owns (row e belongs to block e % G): their
      // own old distance and the fallback arc into the new buffer (which
      // starts unreached), the reverse fallback arc toward the sink, and
      // the reset of the free buffer.
      for (int e = b + G * (int)threadIdx.x; e < E; e += G * kThreads) {
        const int old = de_s[e];
        const int nv = min(old, via(q.Lfb[e], dt_old));
        if (nv < PT_DINF) atomicMin(de_new + e, nv);
        if (nv != old) moved = 1;
        sink = min(sink, via(q.Ltfb[e], old));
        de_free[e] = PT_DINF;
      }
      for (int t = b; t < tiles; t += G) {
        const int m0 = t * kTileCols;
        const int width = min(kTileCols, M - m0);
        const TilePlanes tp(q, smem_tile, t);
        int lmt = PT_CLOSED, ltm = PT_CLOSED;
        if (threadIdx.x < width) {
          dm_s[threadIdx.x] = dm_old[m0 + threadIdx.x];
          lmt = q.Lmt[m0 + threadIdx.x];
          ltm = q.Ltm[m0 + threadIdx.x];
        }
        __syncthreads();
        // EC rows: via this tile's machines (forward arcs).  One lane per
        // column (kTileCols == 32).
        {
          const int dm_l = lane < width ? dm_s[lane] : 0;
#pragma unroll 4
          for (int e = w; e < E; e += kWarps) {
            int best = lane < width ? via(tp.lf[e * tp.stride + lane], dm_l) : PT_DINF;
            best = pt_warp_reduce(best, PtMin());
            if (lane == 0 && best < de_s[e]) {
              atomicMin(de_new + e, best);
              moved = 1;
            }
          }
        }
        // Machine columns: via reverse arcs to ECs, in kColSegs row
        // segments, then via the sink arc.
        {
          const int c = threadIdx.x % kTileCols, seg = threadIdx.x / kTileCols;
          int best = PT_DINF;
          if (c < width) {
            const int* lr = tp.lr + c;
#pragma unroll 8
            for (int e = seg; e < E; e += kColSegs) best = min(best, via(lr[e * tp.stride], de_s[e]));
          }
          part[seg][c] = best;
        }
        __syncthreads();
        if (threadIdx.x < width) {
          const int c = threadIdx.x;
          int best = part[0][c];
          for (int r = 1; r < kColSegs; ++r) best = min(best, part[r][c]);
          const int old = dm_s[c];
          const int nv = min(old, min(best, via(lmt, dt_old)));
          dm_new[m0 + c] = nv;
          if (nv != old) moved = 1;
          sink = min(sink, via(ltm, old));
        }
        __syncthreads();  // dm_s and part are reused by the next tile
      }
      // Sink: via this block's reverse machine and fallback arcs; block 0
      // adds its old distance (the new buffer starts unreached) and resets
      // the free buffer.
      sink = pt_block_reduce(sink, PtMin(), (int)PT_DINF, scratch);
      if (threadIdx.x == 0) {
        if (sink < dt_old) {
          atomicMin(q.dt + (s + 1) % 3, sink);
          moved = 1;
        }
        if (b == 0) {
          if (dt_old < PT_DINF) atomicMin(q.dt + (s + 1) % 3, dt_old);
          q.dt[(s + 2) % 3] = PT_DINF;
        }
      }
      if (__syncthreads_or(moved) && threadIdx.x == 0) atomicOr(q.flag + group, 1);
      grid_sync(q.bar);
    }
    sweeps += kSweepsPerCheck;
    changed = __ldcg(q.flag + group) != 0;
  }

  // ---- apply: skip when unconverged; fill unreached nodes with
  // finite_max + 1; apply only when eps * d cannot overflow.
  const int* de_f = q.de + (sweeps % 3) * E;
  const int* dm_f = q.dm + (sweeps & 1) * M;
  const int dt_f = __ldcg(q.dt + sweeps % 3);
  int fm = 0;
  if (!changed) {
    for (int t = b; t < tiles; t += G)
      for (int c = threadIdx.x; c < kTileCols && t * kTileCols + c < M; c += kThreads) {
        const int d = dm_f[t * kTileCols + c];
        if (d < PT_DINF) fm = max(fm, d);
      }
    for (int e = b + G * (int)threadIdx.x; e < E; e += G * kThreads) {
      const int d = __ldcg(de_f + e);
      if (d < PT_DINF) fm = max(fm, d);
    }
    if (b == 0 && threadIdx.x == 0 && dt_f < PT_DINF) fm = max(fm, dt_f);
    fm = pt_block_reduce(fm, PtMax(), 0, scratch);
    if (threadIdx.x == 0 && fm > 0) atomicMax(q.fmax, fm);
    grid_sync(q.bar);
    fm = __ldcg(q.fmax);
  }
  const bool ok = !changed && fm < (1 << 26) / max(q.eps, 1);
  const int dbig = fm + 1, eps = q.eps;
  for (int t = b; t < tiles; t += G)
    for (int c = threadIdx.x; c < kTileCols && t * kTileCols + c < M; c += kThreads) {
      const int m = t * kTileCols + c, p = q.pm[m];
      int d = ok ? dm_f[m] : 0;
      d = d >= PT_DINF ? dbig : d;
      q.pmo[m] = ok ? max(p - eps * d, PT_NEG_HALF) : p;
    }
  for (int e = b + G * (int)threadIdx.x; e < E; e += G * kThreads) {
    const int p = q.pe[e];
    int d = ok ? __ldcg(de_f + e) : 0;
    d = d >= PT_DINF ? dbig : d;
    q.peo[e] = ok ? max(p - eps * d, PT_NEG_HALF) : p;
  }
  if (b == 0 && threadIdx.x == 0) {
    const int d = dt_f >= PT_DINF ? dbig : dt_f;
    q.pto[0] = ok ? max(pt - eps * d, PT_NEG_HALF) : pt;
    q.sweeps_acc[0] += sweeps;
    if (q.ring != nullptr) {
      q.ring[kTrGu * q.ring_cap + q.ring_slot] = 1;
      q.ring[kTrBf * q.ring_cap + q.ring_slot] = sweeps;
    }
  }
}

}  // namespace

// Workspace ints the update needs at [E, M] with this bf_max (the wrapper
// allocates it once per solve; the barrier's two words must start at 0).
extern "C" long long pt_global_update_ws_ints(int E, int M, int bf_max) {
  return 2LL * E * M + 2LL * E + 2LL * M + 3LL * E + 2LL * M + 3 +
         (bf_max / kSweepsPerCheck + 1) + 1 + 2;
}

// The launch plan at [E, M]: plan[0] = blocks of the cooperative grid,
// plan[1] = 1 if each block keeps its one tile in shared memory.  That
// needs every tile's block resident at once; otherwise the grid has one
// block per tile up to the resident limit and the planes stay in the
// workspace.  Returns a CUDA error code (0 on success).
extern "C" int pt_global_update_plan(int E, int M, int* plan) {
  int dev, sms, per_sm;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const int tiles = (M + kTileCols - 1) / kTileCols;
  const size_t tile_bytes = smem_bytes(E, 1);
  if (tile_bytes <= 227 * 1024) {
    rc = cudaFuncSetAttribute(pt_global_update, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_bytes);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pt_global_update, kThreads,
                                                         tile_bytes);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm * sms >= tiles) {
      plan[0] = tiles;
      plan[1] = 1;
      return 0;
    }
  }
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pt_global_update, kThreads,
                                                     smem_bytes(E, 0));
  if (rc != cudaSuccess) return (int)rc;
  plan[0] = min(tiles, per_sm * sms);
  plan[1] = 0;
  return 0;
}

// Plain C entry point: one global update on ``stream`` as one cooperative
// launch of ``grid`` blocks with ``tile_smem`` (pt_global_update_plan).  Writes
// (peo, pmo, pto) and adds the sweeps to sweeps_acc[0]; with a telemetry
// ``ring`` (null for none) it marks column ``ring_slot`` fired, with its
// sweeps.  Returns the launch's error code (a grid that cannot be
// co-resident is refused, never run).
extern "C" int pt_global_update_launch(
    const int* C, const int* Uem, const int* U, const int* sup, const int* cap,
    const int* F, const int* Ffb, const int* Fmt, const int* pe, const int* pm,
    const int* pt, const int* exc_e, const int* exc_m, const int* exc_t,
    int* peo, int* pmo, int* pto, int* sweeps_acc, int* ws, int* ring, int E,
    int M, int eps, int bf_max, int grid, int tile_smem, int ring_slot,
    int ring_cap, void* stream) {
  Gu q;
  q.C = C; q.Uem = Uem; q.U = U; q.sup = sup; q.cap = cap;
  q.F = F; q.Ffb = Ffb; q.Fmt = Fmt; q.pe = pe; q.pm = pm; q.pt = pt;
  q.exc_e = exc_e; q.exc_m = exc_m; q.exc_t = exc_t;
  q.peo = peo; q.pmo = pmo; q.pto = pto; q.sweeps_acc = sweeps_acc;
  const size_t EM = (size_t)E * M;
  q.Lf = ws; q.Lr = ws + EM;
  int* v = ws + 2 * EM;
  q.Lfb = v; v += E;
  q.Ltfb = v; v += E;
  q.Lmt = v; v += M;
  q.Ltm = v; v += M;
  q.de = v; v += 3 * E;
  q.dm = v; v += 2 * M;
  q.dt = v; v += 3;
  q.groups = bf_max / kSweepsPerCheck + 1;
  q.flag = v; v += q.groups;
  q.fmax = v; v += 1;
  q.bar = reinterpret_cast<unsigned*>(v);
  q.E = E; q.M = M; q.eps = eps; q.bf_max = bf_max; q.tile_smem = tile_smem;
  q.ring = ring_cap > 0 ? ring : nullptr;
  q.ring_slot = ring_slot; q.ring_cap = ring_cap;
  void* args[] = {&q};
  // The kernel's shared-memory limit is per function, not per launch: set
  // it for this launch's size, which another shape's plan may have lowered.
  const size_t smem = smem_bytes(E, tile_smem);
  cudaError_t rc = cudaFuncSetAttribute(pt_global_update,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == cudaSuccess)
    rc = cudaLaunchCooperativeKernel((const void*)pt_global_update, dim3(grid), dim3(kThreads),
                                     args, smem, (cudaStream_t)stream);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free launch error
    return (int)rc;
  }
  return (int)cudaGetLastError();
}

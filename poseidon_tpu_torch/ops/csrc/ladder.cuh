// What B1's kernels share (fused_ladder.cu: the one-SM kernel and the row
// cluster; fused_ladder_columns.cu: the column cluster): the arithmetic of
// the ladder's stages, the fused reductions' values, the row stages' work
// units, the cluster barrier and a cluster's launch.  Each kernel keeps
// its own layout.
#pragma once

#include "common.cuh"

namespace {

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

// Work units of the row stages that reduce along EC rows: (row e, column
// segment q) pairs, u = q * E + e, one warp each, its lanes across the
// segment's 32-column chunks (coalesced).  Each row's chunks split into
// `segs` contiguous segments: the largest power of two <= the chunk count
// with segs * E <= W (kWarps here), at least 1, so that with fewer than
// 32 rows every warp still has work.  With segs > 1 the warps' partials
// meet in shared memory and one thread per row finishes it after one
// barrier.  A chunk is CW columns (32 here: one per lane).
template <int W, int CW = 32>
struct RowUnitsOf {
  int E, chunks, segs, seg, n;
  __device__ RowUnitsOf(int E_, int M) : E(E_), chunks((M + CW - 1) / CW) {
    segs = 1;
    while (segs * 2 <= chunks && segs * 2 * E <= W) segs *= 2;
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

// A machine column's sink arc, ahead of its reverse arcs in the push
// sweep: the push to the sink and what is left to push back to ECs.
struct ColHead { int pm, fmt, cap, rc_mt, mt_push, left; };

__device__ __forceinline__ ColHead col_head_of(int xm, int pm, int fmt, int cap, int pt) {
  ColHead h;
  h.pm = pm;
  h.fmt = fmt;
  h.cap = cap;
  h.rc_mt = h.pm - pt;
  h.mt_push = (h.rc_mt < 0 && xm > 0) ? min(h.cap - h.fmt, xm) : 0;
  h.left = xm - h.mt_push;
  return h;
}

// The reduced cost of an EC -> machine arc of cost c.
__device__ __forceinline__ int rc_em(int c, int pe_e, int pm_m) {
  return c < PT_INF_COST ? c + pe_e - pm_m : PT_POS;
}

// The cluster barrier's two halves, for work that needs neither side:
// what a CTA wrote before arriving, its stores and reductions into the
// other CTAs' shared memory included, is seen by every CTA after it waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// A launch of one cluster of `ctas` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory each: the kernel's attributes (the
// shared memory past 48 KB; a cluster past the portable 8 CTAs), and the
// launch's configuration, its cluster dimension in attr[0].
template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, int ctas, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t cluster_config(int ctas, int threads, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

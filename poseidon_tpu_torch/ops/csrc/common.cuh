// Shared device helpers for the port's solver kernels: the int32 constants
// of ops/transport.py, floor division, warp/block scans and reductions.
#pragma once

#include <cuda_runtime.h>

#define PT_NEG (-(1 << 30))
#define PT_POS (1 << 30)
#define PT_NEG_HALF (-(1 << 29))
#define PT_INF_COST (1 << 28)
#define PT_DINF (1 << 24)
#define PT_EXCESS_SAT 0x7fffffff
#define PT_EXCESS_SAT_THRESH (1LL << 30)
#define PT_NUM_PHASES 4
#define PT_FULL 0xffffffffu

// Floor division for b > 0 (jnp.floor_divide / torch rounding_mode="floor").
__device__ __forceinline__ int pt_floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// _relabel_to: new potential = max candidate - eps, moving only down.
__device__ __forceinline__ int pt_relabel(int maxcand, bool has_adm, int excess,
                                          int p, int eps) {
  int new_p = max(maxcand - eps, PT_NEG_HALF);
  bool do_it = (excess > 0) && !has_adm && (maxcand > PT_NEG_HALF) && (new_p < p);
  return do_it ? new_p : p;
}

__device__ __forceinline__ int pt_warp_incl_scan(int v) {
  int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(PT_FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

struct PtSum {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct PtMax {
  template <typename T> __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct PtMin {
  template <typename T> __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct PtOr {
  template <typename T> __device__ T operator()(T a, T b) const { return a | b; }
};

template <typename T, typename Op>
__device__ __forceinline__ T pt_warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(PT_FULL, v, o));
  return __shfl_sync(PT_FULL, v, 0);
}

// Block-wide reduction; every thread of the block must call it and gets
// the result.  ``scratch`` holds at least 32 elements of T.  blockDim.x is
// a multiple of 32.
template <typename T, typename Op>
__device__ T pt_block_reduce(T v, Op op, T identity, T* scratch) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  v = pt_warp_reduce(v, op);
  __syncthreads();
  if (lane == 0) scratch[w] = v;
  __syncthreads();
  if (w == 0) {
    T x = lane < nw ? scratch[lane] : identity;
    x = pt_warp_reduce(x, op);
    if (lane == 0) scratch[0] = x;
  }
  __syncthreads();
  T r = scratch[0];
  __syncthreads();
  return r;
}

// Block-wide inclusive scan; ``*total`` receives the block's sum.
// ``scratch`` holds at least 32 ints.
static __device__ int pt_block_incl_scan(int v, int* scratch, int* total) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = pt_warp_incl_scan(v);
  __syncthreads();
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < nw ? scratch[lane] : 0;
    y = pt_warp_incl_scan(y);
    scratch[lane] = y;
  }
  __syncthreads();
  int off = w > 0 ? scratch[w - 1] : 0;
  *total = scratch[nw - 1];
  __syncthreads();
  return x + off;
}

// Saturating total of positive excess (the adaptive cadence's signal):
// exact int64 sum, clamped to INT32_MAX from 2^30 up.
__device__ __forceinline__ int pt_saturate(long long s) {
  return s >= PT_EXCESS_SAT_THRESH ? PT_EXCESS_SAT : (int)s;
}

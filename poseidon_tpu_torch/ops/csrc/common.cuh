// Shared device helpers for the port's solver kernels: the int32 constants
// of ops/transport.py, floor division, warp/block scans and reductions.
#pragma once

#include <cuda_runtime.h>

#include <cstring>
#define PT_NEG (-(1 << 30))
#define PT_POS (1 << 30)
#define PT_NEG_HALF (-(1 << 29))
#define PT_INF_COST (1 << 28)
#define PT_DINF (1 << 24)
#define PT_CLOSED (-2147483647 - 1)  // INT_MIN: marks an arc that is not open
#define PT_EXCESS_SAT 0x7fffffff
#define PT_EXCESS_SAT_THRESH (1LL << 30)
#define PT_NUM_PHASES 4
#define PT_FULL 0xffffffffu

// Rows of the convergence-telemetry ring, [8, cap] int32 (ops/transport.py,
// _TR_*), and entries of the phase loop's status (_ST_*).
enum { kTrIter, kTrExcess, kTrRows, kTrCols, kTrEps, kTrGu, kTrBf, kTrSat };
enum { kStActive, kStExcess, kStIters, kStRows, kStCols, kStSat };

// Floor division for b > 0 (jnp.floor_divide / torch rounding_mode="floor").
__device__ __forceinline__ int pt_floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// Floor division by a divisor that stays fixed for many calls (one
// epsilon phase), as a multiply-high by a precomputed magic number
// (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, fig. 4.1) instead of the card's emulated integer
// divide.  Exact for every int32 dividend and every divisor 1 <= d < 2^31:
// it returns pt_floordiv(a, d) bit for bit.
struct PtDivisor {
  unsigned magic;
  int sh1, sh2;
  __device__ explicit PtDivisor(int d) {
    int l = 32 - __clz(d - 1);  // ceil(log2(d))
    unsigned long long span = (1ull << l) - (unsigned long long)d;
    magic = (unsigned)(((span << 32) / (unsigned long long)d) + 1);
    sh1 = min(l, 1);
    sh2 = max(l - 1, 0);
  }
};

__device__ __forceinline__ int pt_floordiv(int a, const PtDivisor& d) {
  // floor(a / d) = a >= 0 ? a / d : -1 - (-1 - a) / d, with the unsigned
  // quotient n / d of n = a ^ sign computed by the magic number.
  int sign = a >> 31;
  unsigned n = (unsigned)(a ^ sign);
  unsigned t = __umulhi(d.magic, n);
  unsigned q = (t + ((n - t) >> d.sh1)) >> d.sh2;
  return sign ^ (int)q;
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

// Warp shuffles of a value made of whole 32-bit words (int, long long, or
// a small struct of such fields), one shuffle per word.
template <typename T>
__device__ __forceinline__ T pt_shfl_down(T v, int o) {
  static_assert(sizeof(T) % 4 == 0, "shuffled values are whole 32-bit words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __shfl_down_sync(PT_FULL, w[i], o);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ T pt_shfl_idx(T v, int src) {
  static_assert(sizeof(T) % 4 == 0, "shuffled values are whole 32-bit words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); ++i) w[i] = __shfl_sync(PT_FULL, w[i], src);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <typename T, typename Op>
__device__ __forceinline__ T pt_warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, pt_shfl_down(v, o));
  return pt_shfl_idx(v, 0);
}

// Block-wide reduction; every thread of the block must call it and gets
// the result.  ``scratch`` holds at least 32 elements of T.  blockDim.x is
// a multiple of 32.  T may be a small struct whose fields ``op`` combines
// each by its own operator: one such call replaces back-to-back reductions
// (four barriers each).
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

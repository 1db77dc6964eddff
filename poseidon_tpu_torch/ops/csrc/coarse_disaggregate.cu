// The coarse-to-fine wave solve's primal disaggregation
// (ops/transport_coarse.py, ``coarse_disaggregate``): the coarse flow of
// each (EC row, column group) handed out to the group's member columns,
// cheapest member first, under the live remaining column capacities.
//
// The reference computes it as a scan over the EC rows in order, each row
// parallel over the K groups: for row e and group g, with the members in
// stable order of their cost (inadmissible members last, ties by member
// index),
//
//   caps[j]   = adm[e, j] ? min(col_left[j], arc[e, j]) : 0
//   before[j] = sum of caps over the members ranked ahead of j
//   take[j]   = max(min(caps[j], want - before[j]), 0)
//   col_left[j] -= take[j]
//
// Groups never share a column, so each group is one block here: the
// group's col_left lives in shared memory and the block walks the rows in
// order.  A row with no coarse flow into the group takes nothing and
// leaves col_left as it was, so the block skips it.  For every other row
// the block ranks its members by (key, index), scatters caps into rank
// order, takes an exclusive block scan and writes each take to F0 at the
// member's original column.  F0 starts zeroed and fb0 starts at the
// supply; each row's takes are subtracted from fb0 with integer atomics,
// whose result does not depend on their order.
//
// All arithmetic is int32, as in the reference: every partial sum of caps
// is bounded by the total column capacity, which the host's validation
// keeps below 2^31.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

struct Args {
  const int* costs;  // [E, M2] raw costs, INF_COST where inadmissible
  const int* arc;    // [E, M2] arc capacities
  const int* cap;    // [M2] column capacities
  const int* Fc;     // [E, K] coarse flows
  const int* perm;   // [M2] sorted position -> original column
  int* F0;           // [E, M2] out (zeroed before the launch)
  int* fb0;          // [E] out (the supply before the launch)
  int E, M2, K, B;
};

// Exclusive scan of v[0, n) in place by the whole block; each thread owns
// one run of consecutive entries.  ``warp_tot`` holds 32 ints.
__device__ void block_exclusive_scan(int* v, int n, int* warp_tot) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int per = (n + nt - 1) / nt;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int run = 0;
  for (int i = lo; i < hi; ++i) run += v[i];
  // Inclusive scan of the runs' totals within the warp, then across warps.
  const int lane = t & 31, warp = t >> 5;
  int inc = run;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(PT_FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = (nt + 31) >> 5;
    int w = lane < nw ? warp_tot[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(PT_FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int acc = inc - run + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    int x = v[i];
    v[i] = acc;
    acc += x;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
disaggregate_kernel(Args a) {
  extern __shared__ int sm[];
  const int B = a.B;
  int* left = sm;          // [B] remaining capacity of each member
  int* col = left + B;     // [B] the member's original column
  int* key = col + B;      // [B] the row's ordering key
  int* caps = key + B;     // [B] the row's caps, member order
  int* rank = caps + B;    // [B] the member's rank in the row's order
  int* val = rank + B;     // [B] caps in rank order, then their prefixes
  __shared__ int s_want[kMaxThreads];
  __shared__ int warp_tot[32];

  const int g = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int M2 = a.M2;
  for (int j = t; j < B; j += nt) {
    int c = a.perm[(size_t)g * B + j];
    col[j] = c;
    left[j] = a.cap[c];
  }
  __syncthreads();

  for (int base = 0; base < a.E; base += nt) {
    const int rows = min(nt, a.E - base);
    if (t < rows) s_want[t] = a.Fc[(size_t)(base + t) * a.K + g];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int want = s_want[r];
      if (want <= 0) continue;  // block-uniform: takes nothing
      const int e = base + r;
      const int* crow = a.costs + (size_t)e * M2;
      const int* arow = a.arc + (size_t)e * M2;
      for (int j = t; j < B; j += nt) {
        int c = crow[col[j]];
        bool adm = c < PT_INF_COST;
        key[j] = adm ? c : PT_INF_COST;
        caps[j] = adm ? min(left[j], arow[col[j]]) : 0;
      }
      __syncthreads();
      // Stable rank: members with a smaller key, or an equal key and a
      // smaller index, come first (jnp.argsort(..., stable=True)).
      for (int j = t; j < B; j += nt) {
        const int kj = key[j];
        int rk = 0;
        for (int i = 0; i < B; ++i) {
          int ki = key[i];
          rk += (ki < kj) | ((ki == kj) & (i < j));
        }
        rank[j] = rk;
        val[rk] = caps[j];
      }
      __syncthreads();
      block_exclusive_scan(val, B, warp_tot);
      int taken = 0;
      for (int j = t; j < B; j += nt) {
        int take = max(min(caps[j], want - val[rank[j]]), 0);
        left[j] -= take;
        a.F0[(size_t)e * M2 + col[j]] = take;
        taken += take;
      }
      for (int d = 16; d > 0; d >>= 1)
        taken += __shfl_down_sync(PT_FULL, taken, d);
      if ((t & 31) == 0 && taken) atomicSub(a.fb0 + e, taken);
      __syncthreads();
    }
    __syncthreads();
  }
}

int threads_for(int B) {
  int nt = ((B + 31) / 32) * 32;
  return nt < 32 ? 32 : (nt > kMaxThreads ? kMaxThreads : nt);
}

}  // namespace

extern "C" size_t pt_coarse_disaggregate_smem_bytes(int B) {
  return (size_t)6 * B * sizeof(int);
}

// Plain C entry point.  Zeroes F0, copies the supply into fb0 and
// launches one block per column group; all pointers are device pointers
// of int32 tensors.
extern "C" int pt_coarse_disaggregate(const int* costs, const int* arc,
                                      const int* cap, const int* Fc,
                                      const int* perm, const int* supply,
                                      int* F0, int* fb0, int E, int M2, int K,
                                      int B, void* stream) {
  if (E <= 0 || K <= 0 || B <= 0 || (long long)K * B != M2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = pt_coarse_disaggregate_smem_bytes(B);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin - (kMaxThreads + 32) * sizeof(int))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        disaggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err =
      cudaMemsetAsync(F0, 0, (size_t)E * M2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(fb0, supply, (size_t)E * sizeof(int),
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  Args a{costs, arc, cap, Fc, perm, F0, fb0, E, M2, K, B};
  disaggregate_kernel<<<K, threads_for(B), smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The chained wave's greedy seed rows (B7's scan; replaces the lax.scan in
// poseidon_tpu/ops/transport_chained.py::_greedy_seed_device).
//
// Band 2's coarse instance is [E, K] (K <= 256 column groups).  Rows take
// capacity in order: row e offers its supply to its admissible columns in
// the row's cost order (order[e, :], a stable argsort computed outside the
// kernel), each column giving min(cap_left, arc) until the supply is met,
// and the row's takes come off cap_left before the next row starts.
//
// One block of K threads (rounded up to whole warps): cap_left lives in
// shared memory; per row, thread j loads ordered column order[e, j] and its
// offer, a block-wide exclusive scan gives the offers before it, and the
// thread writes take = clip(min(offer, want - before), 0) to F0[e, col] and
// subtracts it from cap_left[col]; a barrier ends the row.  Every cell of
// F0 is written, so F0 needs no initialisation.
//
// The sums are int32 in the reference and wrap on overflow; the scan adds
// in unsigned arithmetic, which wraps the same way in any order, so the
// result is bit-equal to the sequential int32 cumsum.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__global__ void greedy_rows_kernel(const int* __restrict__ C,
                                   const int* __restrict__ arc,
                                   const int* __restrict__ cap,
                                   const int* __restrict__ supply,
                                   const int* __restrict__ order,
                                   int* __restrict__ F0, int E, int K) {
  extern __shared__ int smem[];
  int* cap_left = smem;                           // [K]
  unsigned* warp_tot = (unsigned*)(smem + K);     // [32]
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = j; c < K; c += blockDim.x) cap_left[c] = cap[c];
  __syncthreads();
  for (int e = 0; e < E; ++e) {
    const long long row = (long long)e * K;
    int col = 0, offer = 0;
    if (j < K) {
      col = order[row + j];
      if (C[row + col] < PT_INF_COST) offer = min(cap_left[col], arc[row + col]);
    }
    // Block-wide inclusive scan of the offers: warp scans, then a scan of
    // the warp totals by warp 0.
    unsigned v = (unsigned)offer;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      unsigned n = __shfl_up_sync(PT_FULL, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      unsigned t = lane < nwarps ? warp_tot[lane] : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        unsigned n = __shfl_up_sync(PT_FULL, t, o);
        if (lane >= o) t += n;
      }
      if (lane < nwarps) warp_tot[lane] = t;
    }
    __syncthreads();
    const unsigned before = v - (unsigned)offer + (warp > 0 ? warp_tot[warp - 1] : 0u);
    if (j < K) {
      const int want_left = (int)((unsigned)supply[e] - before);
      const int take = max(min(offer, want_left), 0);
      F0[row + col] = take;
      cap_left[col] = (int)((unsigned)cap_left[col] - (unsigned)take);
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point: one block on the stream.  All pointers are device
// pointers of int32 tensors: C, arc, order and F0 [E, K], cap [K],
// supply [E].  Refuses K past one block's threads.
extern "C" int pt_greedy_seed(const int* C, const int* arc, const int* cap,
                              const int* supply, const int* order, int* F0,
                              int E, int K, void* stream) {
  if (E <= 0 || K <= 0 || K > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = ((K + 31) / 32) * 32;
  const size_t smem = (size_t)(K + 32) * sizeof(int);
  greedy_rows_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      C, arc, cap, supply, order, F0, E, K);
  return (int)cudaGetLastError();
}

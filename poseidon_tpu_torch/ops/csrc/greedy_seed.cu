// The chained wave's greedy seed rows (B7's scan; replaces the lax.scan in
// poseidon_tpu/ops/transport_chained.py::_greedy_seed_device).
//
// Band 2's coarse instance is [E, K] (K <= 1024 column groups).  Rows take
// capacity in order: row e offers its supply to its admissible columns in
// the row's cost order (order[e, :], a stable argsort computed outside the
// kernel), each column giving min(cap_left, arc) until the supply is met,
// and the row's takes come off cap_left before the next row starts.
//
// Bound on the H100: bytes (C, the order and F0 once per cell) at a few
// hundredths of a microsecond, far below one launch; the time is the
// chain of rows, which carry cap_left from one to the next.
//
// Design: one block, one consumer warp fed from a shared-memory ring.
//   * Only the row loop is sequential.  A row's order and its ordered
//     admissible arcs (C and arc at order[e, j]) do not depend on
//     cap_left, so producer warps stream rows ahead: each copies its row's
//     order, C and arc into private shared buffers with coalesced loads
//     (one round trip), then resolves the gather by column there and
//     writes the ordered (column, arc) pairs, inadmissible columns
//     flagged, into a ring stage; an mbarrier per stage says full,
//     another says empty.
//   * The consumer warp holds cap_left in shared memory.  Lane l takes Q
//     consecutive ordered positions (Q a power of two, 32 Q >= K, a
//     template argument, so they sit in registers and their loads go out
//     together): their offers min(cap_left, arc) and sum, a 5-step
//     __shfl_up_sync scan for the offers before each lane, then the takes,
//     take = clip(min(offer, want - before), 0); a take that is not 0 is
//     written into the stage's F0 row (which its producer zeroed) and
//     subtracted from cap_left.  No __syncthreads in the row loop.
//   * The producer that fills a stage next stores the stage's F0 row to
//     F0 first, contiguously (and each producer its stages' last rows at
//     the end), so the consumer never touches global memory in the row
//     loop.  Every cell of F0 is written, so F0 needs no initialisation.
//   * A stage holds the ordered pairs lane-major, so the consumer's lanes
//     read consecutive 8-byte words: no bank conflicts on its side.
//   * Up to 16 producer warps and 16 stages, fewer where K's rows would
//     not fit in shared memory (K = 1024: 4 producers).
//
// The sums are int32 in the reference and wrap on overflow; the scan adds
// in unsigned arithmetic, which wraps the same way in any order, so the
// result is bit-equal to the sequential int32 cumsum.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxStages = 16;
constexpr unsigned kInadmissible = 0x80000000u;
constexpr int kStageHead = 4;  // the row's supply, padded to 16 bytes
// A wait past kWaitCycles (seconds; no row takes so long) traps, so a
// fault ends the launch with an error instead of holding the card.
constexpr long long kWaitCycles = 1LL << 34;

__host__ __device__ int lane_positions(int K) {
  int q = 1;
  while (32 * q < K) q *= 2;
  return q;
}

// A ring stage's ints at K (Q positions a lane): the head, the ordered
// (column, arc) pairs lane-major (position j at pair (j % Q) * 32 + j / Q,
// so the consumer's lanes read consecutive pairs), and the row's F0
// (rounded up to 16 bytes, so every stage's pairs stay aligned).
__host__ __device__ int stage_ints(int K) {
  return kStageHead + 64 * lane_positions(K) + ((K + 3) & ~3);
}

// Shared bytes with P producer warps and S ring stages: the mbarriers
// (full, empty), the ring, cap_left and each producer's order, C and arc
// row.
__host__ __device__ size_t smem_bytes(int K, int P, int S) {
  return 2 * kMaxStages * sizeof(uint64_t) +
         sizeof(int) * ((size_t)S * stage_ints(K) + (size_t)K + (size_t)P * 3 * K);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A
// producer sleeps ``backoff_ns`` between polls, so waiting producers leave
// the issue slots to the consumer warp; the consumer polls without pause.
__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          unsigned backoff_ns = 0) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
    if (backoff_ns) __nanosleep(backoff_ns);
  }
}

// A stage's F0 row out to row e of F0, coalesced.
__device__ __forceinline__ void flush_row(int* F0, const int* st, int K, int e, int lane) {
  const int* f0 = st + kStageHead + 64 * lane_positions(K);
  int* out = F0 + (size_t)e * K;
#pragma unroll 4
  for (int c = lane; c < K; c += 32) out[c] = f0[c];
}

// Q ordered positions per consumer lane (a power of two, 32 * Q >= K).
template <int Q>
__global__ void __launch_bounds__(32 * 17, 1)
greedy_rows_kernel(const int* __restrict__ C, const int* __restrict__ arc,
                   const int* __restrict__ cap, const int* __restrict__ supply,
                   const int* __restrict__ order, int* __restrict__ F0, int E, int K, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = blockDim.x / 32 - 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  int* ring = reinterpret_cast<int*>(empty + kMaxStages);  // [S][stage_ints]
  const int SI = stage_ints(K);
  int* cap_left = ring + (size_t)S * SI;                     // [K]
  int* rows = cap_left + K;                                  // [P][3][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: before the roles split

  if (warp > 0) {
    // ---- producer warp p: rows p, p + P, ... (P divides S, so the
    // stages it fills are its own); its three rows' loads are
    // independent, so they go out together.
    const int p = warp - 1;
    int* o_row = rows + (size_t)p * 3 * K;
    int* c_row = o_row + K;
    int* a_row = c_row + K;
    for (int e = p; e < E; e += P) {
      const size_t base = (size_t)e * K;
#pragma unroll 4
      for (int j = lane; j < K; j += 32) {
        o_row[j] = __ldg(order + base + j);
        c_row[j] = __ldg(C + base + j);
        a_row[j] = __ldg(arc + base + j);
      }
      const int s = e % S, use = e / S;
      int* st = ring + (size_t)s * SI;
      if (use > 0) {
        // The stage's previous row is taken: its F0 row goes out first.
        mbar_wait(empty + s, (use - 1) & 1, 128);
        flush_row(F0, st, K, e - S, lane);
      }
      // The F0 row starts at 0: the consumer writes only the takes that
      // are not.
      for (int c = lane; c < K; c += 32) st[kStageHead + 64 * Q + c] = 0;
      if (lane == 0) st[0] = __ldg(supply + e);
      __syncwarp();  // the row copies, before the gather reads them
      int2* pairs = reinterpret_cast<int2*>(st + kStageHead);
#pragma unroll 4
      for (int j = lane; j < K; j += 32) {
        const int col = o_row[j];
        const bool adm = c_row[col] < PT_INF_COST;
        pairs[(j % Q) * 32 + j / Q] =
            make_int2((int)((unsigned)col | (adm ? 0u : kInadmissible)), a_row[col]);
      }
      __syncwarp();  // the stage's writes, and the row buffers' reads
      if (lane == 0) mbar_arrive(full + s);
    }
    // The last row of each of this warp's stages: out once it is taken.
    for (int e = max(E - S, 0); e < E; ++e) {
      if (e % P != p) continue;
      const int s = e % S;
      mbar_wait(empty + s, (e / S) & 1, 128);
      flush_row(F0, ring + (size_t)s * SI, K, e, lane);
    }
    return;
  }

  // ---- the consumer warp: lane l holds ordered positions [l Q, l Q + Q).
  for (int c = lane; c < K; c += 32) cap_left[c] = cap[c];
  __syncwarp();
  const int j0 = lane * Q;
  int s = 0, phase = 0;  // row e's stage and its use's parity
  for (int e = 0; e < E; ++e) {
    mbar_wait(full + s, phase);
    int* st = ring + (size_t)s * SI;
    const int2* pairs = reinterpret_cast<const int2*>(st + kStageHead);
    int* f0 = st + kStageHead + 64 * Q;
    const int want = st[0];
    int col[Q], offer[Q], left[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int2 pr = j0 + i < K ? pairs[i * 32 + lane] : make_int2((int)kInadmissible, 0);
      col[i] = pr.x;
      offer[i] = pr.y;
    }
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      left[i] = col[i] < 0 ? 0 : cap_left[col[i]];
      offer[i] = col[i] < 0 ? 0 : min(left[i], offer[i]);
      sum += (unsigned)offer[i];
    }
    // Offers before this lane's first position: exclusive warp scan.
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(PT_FULL, incl, o);
      if (lane >= o) incl += n;
    }
    unsigned before = incl - sum;
    // The takes that are not 0 (the rest of the row is 0 already, and
    // leaves cap_left as it was; an inadmissible column's take is 0).
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int take = max(min(offer[i], (int)((unsigned)want - before)), 0);
      before += (unsigned)offer[i];
      if (take != 0) {
        f0[col[i]] = take;
        cap_left[col[i]] = (int)((unsigned)left[i] - (unsigned)take);
      }
    }
    __syncwarp();  // the F0 row and cap_left written
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == S) s = 0, phase ^= 1;
  }
}

using Kernel = void (*)(const int*, const int*, const int*, const int*, const int*, int*, int,
                        int, int);

Kernel kernel_for(int K) {
  const int q = lane_positions(K);
  return q == 1 ? &greedy_rows_kernel<1> : q == 2 ? &greedy_rows_kernel<2>
         : q == 4 ? &greedy_rows_kernel<4> : q == 8 ? &greedy_rows_kernel<8>
         : q == 16 ? &greedy_rows_kernel<16> : &greedy_rows_kernel<32>;
}

}  // namespace

// Plain C entry point: one block on the stream.  All pointers are device
// pointers of int32 tensors: C, arc, order and F0 [E, K], cap [K],
// supply [E].  Refuses K past kMaxK (1024).  The block has 16 producer
// warps and 16 ring stages where they fit in shared memory, fewer past it
// (producers first; the producers always divide the stages).
extern "C" int pt_greedy_seed(const int* C, const int* arc, const int* cap,
                              const int* supply, const int* order, int* F0,
                              int E, int K, void* stream) {
  if (E <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  int dev, optin;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return (int)rc;
  int P = 16, S = kMaxStages;
  while (smem_bytes(K, P, S) > (size_t)optin && P > 4) P /= 2;
  while (smem_bytes(K, P, S) > (size_t)optin && S > P) S /= 2;
  const size_t smem = smem_bytes(K, P, S);
  const Kernel kern = kernel_for(K);
  rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return (int)rc;
  }
  kern<<<1, 32 * (1 + P), smem, (cudaStream_t)stream>>>(C, arc, cap, supply, order, F0, E, K,
                                                        S);
  return (int)cudaGetLastError();
}

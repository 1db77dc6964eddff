// The coarse-to-fine wave solve's primal disaggregation
// (ops/transport_coarse.py, ``coarse_disaggregate``): the coarse flow of
// each (EC row, column group) handed out to the group's member columns,
// cheapest member first, under the live remaining column capacities.  It
// replaces the reference's scan in poseidon_tpu/ops/transport_coarse.py
// (``coarse_to_fine_band``, the ``lax.scan`` of ``disagg_row``), an XLA
// program on the TPU.
//
// The function: for each EC row e in order, and each group g in parallel,
// with the members in stable order of their key (the cost, INF_COST if
// inadmissible; ties by member index),
//
//   caps[j]   = adm[e, j] ? min(col_left[j], arc[e, j]) : 0
//   before[j] = sum of caps over the members ranked ahead of j
//   take[j]   = max(min(caps[j], want - before[j]), 0)
//   col_left[j] -= take[j]
//
// F0 comes out in the original column order and fb0 = supply - rowsum(F0).
// All arithmetic is int32, as in the reference: every partial sum of caps
// is bounded by the total column capacity, which the host's validation
// keeps below 2^31.  Capacities and arc capacities are non-negative (the
// program's operands are), so a row with no coarse flow takes nothing and
// a row stops once its caps cover its want.
//
// What bounds it on this card.  The bytes are few (the costs and arcs of
// the members of the pairs with flow, F0 written once: ~10 MB on the
// wave, ~3 us at 3.35 TB/s) and so are the operations; what costs time is
// the chain: row e + 1 of a group reads the col_left that row e wrote, so
// a group's active rows are a sequence of dependent steps, each a few
// shared-memory and shuffle latencies.  The design takes everything that
// does not depend on col_left off that sequence and walks it in one warp:
//
//  * One block per column group (groups never share a column).  The
//    program's K is 128 or 256, so the K blocks already spread over the
//    132 SMs, two to an SM at K = 256.  Warp 0 walks the chain; warps
//    1..W (W = 7, fewer only when a large B leaves no room for seven ring
//    slots) rank rows.
//  * Producer p takes the group's active rows (Fc > 0, found by ballots
//    over the Fc column; no idle row is touched) whose ordinal is p
//    modulo W, gathers each row's member costs and arcs through perm and
//    sorts the members by a packed word, key << 32 | member (or, when the
//    row's costs fit 23 bits, cost << 8 | member in 32 bits, half the
//    shuffles; on the H100 the kernel ran 8-29% slower with the 64-bit
//    word alone wherever the 32-bit one applies): a strict total order,
//    so the sort gives exactly argsort(stable=True).  B <= 256 sorts in
//    registers, R = 1, 2, 4 or 8 members a lane, as a bitonic network
//    over shuffles and register pairs; a larger B sorts the same network
//    in shared memory, padded to a power of two.  The sorted row goes to
//    p's slot of a shared-memory ring as (member, arc) words in rank
//    order, inadmissible members dropped (their caps are 0: they take
//    nothing and add nothing to a prefix), with a header (row, want,
//    admissible count).
//  * Producer p and the chain hand p's slot back and forth through two
//    named barriers (``full`` and ``empty``, 64 threads each): an arrival
//    costs the producer nothing and publishes its writes, and a sync on a
//    row already there returns at once, with no polling.
//  * The chain warp keeps col_left and the members' columns in shared
//    memory.  Per row each lane takes R consecutive ranks: caps through the
//    rank's member, an inclusive scan over its own R, a 5-step shuffle scan
//    across the warp, the takes, col_left updated, nonzero takes stored to
//    F0 at the member's original column and the lane's row total
//    subtracted from fb0 by an integer atomic (the order of an integer sum
//    does not change it).  No block barrier and no load of costs or arcs
//    sits on the chain.
//
// One launch rather than a separate ranking pass: a group's chain starts
// as soon as its first row is sorted, and the rows never round-trip
// through device memory.  Its cost: the producers' scattered gathers and
// sorts share the SM with the chain warp and lengthen each of its steps;
// on the H100 a two-pass variant (a ranking kernel over the whole card
// into a workspace, then the chains alone) still measured slower.  Ahead
// of it, on the same stream, one small kernel zeroes F0 (16-byte stores)
// and copies the supply into fb0.
//
// Limits: the block's shared memory holds col_left, the columns and at
// least one slot; the launch reads the card's opt-in limit and refuses a
// B past it (on the H100's 227 KB, B up to 12670: one padded slot of
// 16384 words and 8 B bytes).

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kMaxProducers = 7;  // producer warps (and ring slots) a block
constexpr int kRegisterSortMax = 256;  // B <= 256: the sort in registers
constexpr u64 kPad = ~0ull;  // sorts after every member

struct Args {
  const int* costs;  // [E, M2] raw costs, INF_COST where inadmissible
  const int* arc;    // [E, M2] arc capacities
  const int* cap;    // [M2] column capacities
  const int* Fc;     // [E, K] coarse flows
  const int* perm;   // [M2] sorted position -> original column
  int* F0;           // [E, M2] out (zeroed before the launch)
  int* fb0;          // [E] out (the supply before the launch)
  int E, M2, K, B;
  int W, SE;         // producers (= ring slots), 64-bit words per slot
};

// Words a slot holds: the rank-ordered row, or the padded sort buffer.
__host__ __device__ inline size_t slot_entries(int B) {
  if (B <= kRegisterSortMax) return (size_t)((B + 1) & ~1);
  size_t p = 512;
  while (p < (size_t)B) p <<= 1;
  return p;
}

// Shared memory: W slots of SE words, W headers (int4), col_left[B] and
// the members' columns[B].
__host__ __device__ inline size_t smem_bytes(int B, int W) {
  return (size_t)W * slot_entries(B) * 8 + (size_t)W * 16 + (size_t)B * 8;
}

// The packed sort word: the key biased to unsigned, then the member.
__device__ inline u64 pack(int key, int j) {
  return ((u64)((unsigned)key ^ 0x80000000u) << 32) | (unsigned)j;
}

// The same order in 32 bits, where every admissible cost of the row is in
// [0, 2^23) and B <= 256: cost << 8 | member, inadmissible members
// 2^31 | member.
constexpr unsigned kNarrowCost = 1u << 23;
__device__ inline unsigned pack32(int c, bool adm, int j) {
  return (adm ? (unsigned)c << 8 : 1u << 31) | (unsigned)j;
}

__device__ inline u64 entry(int j, int arc) {
  return ((u64)(unsigned)arc << 32) | (unsigned)j;
}

// Ascending bitonic sort of 32 * R keys held as v[r] = element r*32+lane.
template <int R, class T>
__device__ void bitonic_registers(T (&v)[R], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      if (d >= 32) {
        const int rs = d >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & rs) continue;
          const bool up = ((r * 32 + lane) & k) == 0;
          const T x = v[r], y = v[r | rs];
          const bool swap = (x > y) == up;
          v[r] = swap ? y : x;
          v[r | rs] = swap ? x : y;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int idx = r * 32 + lane;
          const T o = __shfl_xor_sync(PT_FULL, v[r], d);
          const bool keep_min = (((idx & k) == 0) == ((idx & d) == 0));
          v[r] = keep_min ? (v[r] < o ? v[r] : o) : (v[r] > o ? v[r] : o);
        }
      }
    }
  }
}

// Ascending bitonic sort of P (a power of two) words in shared memory by
// one warp.
__device__ void bitonic_shared(u64* w, int P, int lane) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int i = 2 * t - (t & (d - 1));
        const u64 x = w[i], y = w[i + d];
        if ((x > y) == ((i & k) == 0)) {
          w[i] = y;
          w[i + d] = x;
        }
      }
      __syncwarp();
    }
  }
}

// Named barriers between producer p and the chain warp, 64 threads each
// (barrier 0 is __syncthreads'): ``full`` when p's slot holds a row,
// ``empty`` when the chain is done with it.  An arrival publishes the
// arriving warp's shared-memory writes to the warp that syncs.
__device__ inline int full_bar(int p) { return 1 + p; }
__device__ inline int empty_bar(int p) { return 1 + kMaxProducers + p; }

__device__ inline void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ inline void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

struct Ring {
  u64* ent;   // [W][SE]
  int4* hdr;  // [W]: row, want, admissible count
  int* left;  // [B] the chain's col_left
  int* col;   // [B] the member's original column
};

// A producer's walk over the group's active rows (Fc > 0) in windows of
// 32, the next window's Fc loaded ahead: it yields the rows whose ordinal
// among the active rows is p modulo W.
struct RowWalk {
  int base, seen;      // the window's first row; active rows before it
  unsigned act, mine;  // the window's active rows, and this producer's
  int w, wn;           // this lane's Fc in the window, and in the next
};

__device__ inline int fc_at(const Args& a, int e) {
  return e < a.E ? a.Fc[(size_t)e * a.K + blockIdx.x] : 0;
}

__device__ void start_walk(const Args& a, int lane, RowWalk& it) {
  it.base = -32;
  it.seen = 0;
  it.act = it.mine = 0;
  it.wn = fc_at(a, lane);
}

__device__ bool next_row(const Args& a, int p, int lane, RowWalk& it,
                         int& e, int& want) {
  while (it.mine == 0) {
    it.seen += __popc(it.act);
    it.base += 32;
    if (it.base >= a.E) return false;
    it.w = it.wn;
    it.wn = fc_at(a, it.base + 32 + lane);
    it.act = __ballot_sync(PT_FULL, it.w > 0);
    const int ord = it.seen + __popc(it.act & ((1u << lane) - 1));
    it.mine = __ballot_sync(PT_FULL, it.w > 0 && ord % a.W == p);
  }
  const int b = __ffs(it.mine) - 1;
  it.mine &= it.mine - 1;
  e = it.base + b;
  want = __shfl_sync(PT_FULL, it.w, b);
  return true;
}

// Producer p, B <= 32 R: each lane gathers members r*32+lane (their
// columns held in registers) and the warp sorts them; the sorted row goes
// to slot p once the chain is done with the slot's previous row.
template <int R>
__device__ void produce_registers(const Args& a, const Ring& q, int p,
                                  int lane) {
  const int B = a.B;
  const int* gperm = a.perm + (size_t)blockIdx.x * B;
  u64* slot = q.ent + (size_t)p * a.SE;
  int col[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    col[r] = r * 32 + lane < B ? gperm[r * 32 + lane] : 0;
  RowWalk it;
  start_walk(a, lane, it);
  int e, want;
  for (bool first = true; next_row(a, p, lane, it, e, want); first = false) {
    int c[R], av[R], n = 0;
    bool wide = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = r * 32 + lane < B;
      c[r] = in ? __ldg(a.costs + (size_t)e * a.M2 + col[r]) : PT_INF_COST;
      av[r] = in ? __ldg(a.arc + (size_t)e * a.M2 + col[r]) : 0;
      const bool adm = c[r] < PT_INF_COST;
      wide |= adm && (unsigned)c[r] >= kNarrowCost;
      n += __popc(__ballot_sync(PT_FULL, adm));
    }
    int jr[R];
    if (__any_sync(PT_FULL, wide)) {
      u64 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        v[r] = j < B ? pack(c[r] < PT_INF_COST ? c[r] : PT_INF_COST, j)
                     : kPad;
      }
      bitonic_registers<R>(v, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) jr[r] = (int)(unsigned)v[r];
    } else {
      unsigned v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        v[r] = j < B ? pack32(c[r], c[r] < PT_INF_COST, j) : ~0u;
      }
      bitonic_registers<R>(v, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) jr[r] = (int)(v[r] & 0xff);
    }
    if (!first) bar_sync(empty_bar(p));
    // Each member's arc staged at its member index, then read back in rank
    // order.
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r * 32 + lane < B) slot[r * 32 + lane] = entry(0, av[r]);
    __syncwarp();
    int ar[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      ar[r] = r * 32 + lane < n ? (int)(slot[jr[r]] >> 32) : 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r * 32 + lane < n) slot[r * 32 + lane] = entry(jr[r], ar[r]);
    if (lane == 0) q.hdr[p] = make_int4(e, want, n, 0);
    __syncwarp();
    bar_arrive(full_bar(p));
  }
}

// Producer p, B > 256: the row's keys sorted in its slot, padded to a
// power of two; the arcs gathered after the sort, in rank order.
__device__ void produce_shared(const Args& a, const Ring& q, int p,
                               int lane) {
  const int B = a.B;
  const int* gperm = a.perm + (size_t)blockIdx.x * B;
  u64* slot = q.ent + (size_t)p * a.SE;
  RowWalk it;
  start_walk(a, lane, it);
  int e, want;
  for (bool first = true; next_row(a, p, lane, it, e, want); first = false) {
    const int* crow = a.costs + (size_t)e * a.M2;
    const int* arow = a.arc + (size_t)e * a.M2;
    if (!first) bar_sync(empty_bar(p));
    int n = 0;
    for (int j = lane; j < a.SE; j += 32) {
      bool adm = false;
      u64 key = kPad;
      if (j < B) {
        const int c = __ldg(crow + gperm[j]);
        adm = c < PT_INF_COST;
        key = pack(adm ? c : PT_INF_COST, j);
      }
      slot[j] = key;
      n += __popc(__ballot_sync(PT_FULL, adm));
    }
    __syncwarp();
    bitonic_shared(slot, a.SE, lane);
    for (int r = lane; r < n; r += 32) {
      const int j = (int)(unsigned)slot[r];
      slot[r] = entry(j, __ldg(arow + gperm[j]));
    }
    if (lane == 0) q.hdr[p] = make_int4(e, want, n, 0);
    __syncwarp();
    bar_arrive(full_bar(p));
  }
}

// A chunk of a row as the chain reads it from its slot: the header, and
// this lane's R ranks (lane l: ranks base + l*R ...), member and arc.
// Ranks past the row's admissible count read as member 0 with arc 0: caps
// 0, no take.  The entries are read without waiting for the header.
template <int R>
struct ChainRow {
  int e, want, n;
  int j[R], arc[R];
};

template <int R>
__device__ void read_row(const Args& a, const Ring& q, int s, int base,
                         int lane, ChainRow<R>& row) {
  const int4 h = q.hdr[s];
  const u64* slot = q.ent + (size_t)s * a.SE;
  u64 x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = base + lane * R + r;
    x[r] = idx < a.SE ? slot[idx] : 0;
  }
  row.e = h.x;
  row.want = h.y;
  row.n = h.z;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = base + lane * R + r < row.n;
    row.j[r] = in ? (int)(unsigned)x[r] : 0;
    row.arc[r] = in ? (int)(x[r] >> 32) : 0;
  }
}

// A chunk's hand-out once its members' col_left (``lv``) and columns
// (``cl``) are read: caps, the scan (each lane's own R, then a 5-step
// shuffle scan across the warp), the takes.  ``carry`` is the caps ranked
// before the chunk; returns the chunk's total caps.
template <int R>
__device__ int hand_out(const Ring& q, const ChainRow<R>& row,
                        const int (&lv)[R], const int (&cl)[R], int carry,
                        int* F0row, int lane, int& taken) {
  int cp[R], pre[R], run = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cp[r] = min(lv[r], row.arc[r]);
    pre[r] = run;
    run += cp[r];
  }
  int inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(PT_FULL, inc, d);
    if (lane >= d) inc += y;
  }
  const int before = carry + inc - run;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int take = max(min(cp[r], row.want - (before + pre[r])), 0);
    if (take > 0) {
      q.left[row.j[r]] = lv[r] - take;
      F0row[cl[r]] = take;
      taken += take;
    }
  }
  return __shfl_sync(PT_FULL, inc, 31);
}

// The chain warp: every active row of the group in order, row i from
// slot i mod W.
template <int R>
__device__ void walk_chain(const Args& a, const Ring& q, int lane) {
  const int g = blockIdx.x, B = a.B;
  for (int j = lane; j < B; j += 32) {
    const int c = a.perm[(size_t)g * B + j];
    q.col[j] = c;
    q.left[j] = a.cap[c];
  }
  int rows = 0;
  for (int base = 0; base < a.E; base += 32)
    rows += __popc(__ballot_sync(PT_FULL, fc_at(a, base + lane) > 0));
  __syncwarp();
  if (rows == 0) return;
  ChainRow<R> cur;
  bar_sync(full_bar(0));
  read_row(a, q, 0, 0, lane, cur);
  for (int i = 0, s = 0; i < rows; ++i) {
    const int sn = s + 1 == a.W ? 0 : s + 1;
    int lv[R], cl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lv[r] = q.left[cur.j[r]];
      cl[r] = q.col[cur.j[r]];
    }
    int* F0row = a.F0 + (size_t)cur.e * a.M2;
    int taken = 0;
    int carry = hand_out<R>(q, cur, lv, cl, 0, F0row, lane, taken);
    // Ranks past the first chunk (B > 256 only), read from the slot.
    for (int base = 32 * R; base < cur.n && carry < cur.want;
         base += 32 * R) {
      ChainRow<R> part;
      read_row(a, q, s, base, lane, part);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lv[r] = q.left[part.j[r]];
        cl[r] = q.col[part.j[r]];
      }
      carry += hand_out<R>(q, part, lv, cl, carry, F0row, lane, taken);
    }
    __syncwarp();
    if (i + a.W < rows) bar_arrive(empty_bar(s));
    if (taken) atomicSub(a.fb0 + cur.e, taken);
    if (i + 1 < rows) {
      bar_sync(full_bar(sn));
      read_row(a, q, sn, 0, lane, cur);
    }
    s = sn;
  }
}

template <int R>
__global__ void __launch_bounds__(32 * (1 + kMaxProducers), 2)
disaggregate_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  Ring q;
  q.ent = (u64*)sm;
  q.hdr = (int4*)(q.ent + (size_t)a.W * a.SE);
  q.left = (int*)(q.hdr + a.W);
  q.col = q.left + a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    walk_chain<R>(a, q, lane);
  else if (a.B <= 32 * R)
    produce_registers<R>(a, q, warp - 1, lane);
  else
    produce_shared(a, q, warp - 1, lane);
}

// F0 zeroed (16-byte stores) and the supply copied into fb0, in one launch.
__global__ void init_kernel(int4* F0, long long n4, int* F0tail, int tail,
                            const int* supply, int* fb0, int E) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = t; i < n4; i += stride) F0[i] = make_int4(0, 0, 0, 0);
  if (t < tail) F0tail[t] = 0;
  for (long long i = t; i < E; i += stride) fb0[i] = supply[i];
}

// Producers (= ring slots) for B: seven, or as many as the block's shared
// memory holds; 0 when not even one slot fits.
int producers_for(int B, size_t optin) {
  int w = kMaxProducers;
  while (w > 0 && smem_bytes(B, w) > optin) --w;
  return w;
}

template <int R>
int launch(const Args& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        disaggregate_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  disaggregate_kernel<R><<<a.K, 32 * (1 + a.W), smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The current device's opt-in shared memory per block, and its SMs.
void device_limits(size_t& optin, int& sms) {
  int dev = 0, o = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  optin = (size_t)o;
  sms = n;
}

}  // namespace

// The block's shared memory for groups of B on the current device, 0 when
// not even one ring slot fits.
extern "C" size_t pt_coarse_disaggregate_smem_bytes(int B) {
  size_t optin;
  int sms;
  device_limits(optin, sms);
  const int W = B > 0 ? producers_for(B, optin) : 0;
  return W ? smem_bytes(B, W) : 0;
}

// Plain C entry point: two kernels on the stream, one zeroing F0 and
// copying the supply into fb0, then one block per column group.  Refuses a
// B whose ring the card's shared memory cannot hold.  All pointers are
// device pointers of int32 tensors.
extern "C" int pt_coarse_disaggregate(const int* costs, const int* arc,
                                      const int* cap, const int* Fc,
                                      const int* perm, const int* supply,
                                      int* F0, int* fb0, int E, int M2, int K,
                                      int B, void* stream) {
  if (E <= 0 || K <= 0 || B <= 0 || (long long)K * B != M2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  size_t optin;
  int sms;
  device_limits(optin, sms);
  const int W = producers_for(B, optin);
  if (W == 0) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)E * M2, n4 = cells / 4;
  const int tail = (int)(cells - n4 * 4);
  long long blocks = (n4 + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  init_kernel<<<(unsigned)blocks, 256, 0, s>>>((int4*)F0, n4, F0 + n4 * 4,
                                               tail, supply, fb0, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a{costs, arc, cap, Fc, perm, F0, fb0, E, M2, K, B, W,
         (int)slot_entries(B)};
  const size_t smem = smem_bytes(B, W);
  if (B <= 32) return launch<1>(a, smem, s);
  if (B <= 64) return launch<2>(a, smem, s);
  if (B <= 128) return launch<4>(a, smem, s);
  return launch<8>(a, smem, s);
}

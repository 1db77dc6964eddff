// Fused epsilon-ladder kernel (B1): the whole cost-scaling push-relabel
// ladder of one transportation solve in ONE launch.
//
// Replaces: poseidon_tpu/ops/transport_fused.py::_phase_ladder_kernel (the
// Pallas TPU kernel launched by solve_device_fused).  Same arithmetic, same
// update order, int32 throughout, so results are bit-equal to the plain
// torch ladder (ops/transport.py::_solve_device) and to the reference.
//
// What it computes: for each of the 4 epsilon phases, refine the carried
// flows to the new eps, then synchronous push/relabel iterations until no
// node has positive excess (or a budget trips).  Pushes are allocated by
// inclusive row prefixes (EC rows, over machines) and column prefixes
// (machine columns, over ECs); the sink row's 1-D prefix runs over
// [machines, ECs].  The Bellman-Ford global update runs in place of the
// local relabel on the fixed or adaptive cadence, four Jacobi sweeps per
// convergence check.
//
// Bound on the H100: every iteration touches the C, Uem and F planes a few
// times and every BF sweep twice; at the gate's edge ([128, 1280] int32)
// the live planes are ~3 MB and stay in the 50 MB L2, so the kernel is
// bound by its own serial stage latency, not by HBM bytes.
//
// Design (a single 1024-thread block): a single launch must carry state
// across phases and iterations, which needs synchronisation across every
// thread that touches the planes.  One block makes that __syncthreads().
// The ~20 live [E, M] planes of the TPU design do not fit one SM's shared
// memory at the gate's edge, so the planes stay in global memory (L2
// resident) and only scalars live in shared memory.  Row stages run one
// warp per EC row (warp scans with a carried prefix), column stages one
// thread per machine column (a sequential scan down the column, coalesced
// across threads).  A cooperative multi-block grid is the obvious next step
// for speed; this first version is the simple, exact one.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

struct Planes {
  const int* C;    // [E, M] scaled costs, PT_INF_COST = inadmissible
  const int* U;    // [E] scaled unscheduled costs
  const int* sup;  // [E]
  const int* cap;  // [M]
  const int* Uem;  // [E, M] per-arc capacity
  int* F;          // [E, M] flows (state, in place)
  int* Ffb;        // [E]
  int* Fmt;        // [M]
  int* pe;         // [E]
  int* pm;         // [M]
  int* pt;         // [1]
  int* P;          // [E, M] scratch: EC-side pushes of the current iteration
  int* exc_e;      // [E]
  int* exc_m;      // [M]
  int* fbp;        // [E] fallback pushes
  int* tpm;        // [M] sink pushes to machines
  int* tpe;        // [E] sink pushes to EC fallbacks
  int* cand_e;     // [E] relabel candidates
  int* hadm_e;     // [E]
  int* cand_m;     // [M]
  int* hadm_m;     // [M]
  int* de0;        // [E] BF distances, double buffered
  int* de1;
  int* dm0;        // [M]
  int* dm1;
  int E, M;
};

struct Shared {
  long long red_ll[32];
  int red_i[32];
  int pt;
  int exc_t;
  int hadm_t;  // sink relabel inputs of the current iteration
  int cand_t;
};

__device__ __forceinline__ int rc_em_at(const Planes& p, int idx, int pe_e, int pm_m) {
  int c = p.C[idx];
  return c < PT_INF_COST ? c + pe_e - pm_m : PT_POS;
}

// Excesses from the flow state: exc_e, exc_m, and the scalar exc_t.
__device__ void excesses(const Planes& p, int total, Shared& s) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = w; e < p.E; e += kThreads / 32) {
    int acc = 0;
    for (int m = lane; m < p.M; m += 32) acc += p.F[e * p.M + m];
    acc = pt_warp_reduce(acc, PtSum());
    if (lane == 0) p.exc_e[e] = p.sup[e] - acc - p.Ffb[e];
  }
  for (int m = threadIdx.x; m < p.M; m += kThreads) {
    int acc = 0;
    for (int e = 0; e < p.E; ++e) acc += p.F[e * p.M + m];
    p.exc_m[m] = acc - p.Fmt[m];
  }
  int part = 0;
  for (int m = threadIdx.x; m < p.M; m += kThreads) part += p.Fmt[m];
  for (int e = threadIdx.x; e < p.E; e += kThreads) part += p.Ffb[e];
  int tot = pt_block_reduce(part, PtSum(), 0, s.red_i);
  if (threadIdx.x == 0) s.exc_t = tot - total;
  __syncthreads();
}

// Global price update (reference _global_update) on the post-push state
// with the frozen prices.  Returns the BF sweeps spent.
__device__ int global_update(const Planes& p, int eps, int bf_max, Shared& s) {
  const int E = p.E, M = p.M;
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = s.pt;
  int* de = p.de0; int* de_n = p.de1;
  int* dm = p.dm0; int* dm_n = p.dm1;
  for (int e = threadIdx.x; e < E; e += kThreads) de[e] = p.exc_e[e] < 0 ? 0 : PT_DINF;
  for (int m = threadIdx.x; m < M; m += kThreads) dm[m] = p.exc_m[m] < 0 ? 0 : PT_DINF;
  int dt = s.exc_t < 0 ? 0 : PT_DINF;
  __syncthreads();
  int sweeps = 0;
  bool changed = true;
  while (changed && sweeps <= bf_max) {
    int any = 0;
    for (int k = 0; k < 4; ++k) {
      // EC rows: via machines (forward arcs) and via the fallback arc.
      for (int e = w; e < E; e += kThreads / 32) {
        int pe_e = p.pe[e];
        int best = PT_DINF;
        for (int m = lane; m < M; m += 32) {
          int idx = e * M + m;
          int c = p.C[idx];
          bool adm = c < PT_INF_COST;
          if (adm && p.Uem[idx] - p.F[idx] > 0) {
            int l = pt_floordiv(c + pe_e - p.pm[m], eps) + 1;
            best = min(best, l + dm[m]);
          } else if (p.Uem[idx] - p.F[idx] > 0) {
            best = min(best, PT_DINF + dm[m]);
          }
        }
        best = pt_warp_reduce(best, PtMin());
        if (lane == 0) {
          int rfb = p.U[e] + pe_e - pt;
          int via_t = (p.sup[e] - p.Ffb[e] > 0) ? pt_floordiv(rfb, eps) + 1 + dt : PT_DINF;
          int nv = min(de[e], min(best, via_t));
          de_n[e] = nv;
          if (nv != de[e]) any = 1;
        }
      }
      // Machine columns: via reverse arcs to ECs and via the sink arc.
      for (int m = threadIdx.x; m < M; m += kThreads) {
        int pm_m = p.pm[m];
        int best = PT_DINF;
        for (int e = 0; e < E; ++e) {
          int idx = e * M + m;
          if (p.F[idx] > 0) {
            int c = p.C[idx];
            int l = c < PT_INF_COST ? pt_floordiv(-(c + p.pe[e] - pm_m), eps) + 1 : PT_DINF;
            best = min(best, l + de[e]);
          }
        }
        int via_t = (p.cap[m] - p.Fmt[m] > 0) ? pt_floordiv(pm_m - pt, eps) + 1 + dt : PT_DINF;
        int nv = min(dm[m], min(best, via_t));
        dm_n[m] = nv;
        if (nv != dm[m]) any = 1;
      }
      // Sink: via reverse machine arcs and reverse fallback arcs.
      int tb = PT_DINF;
      for (int m = threadIdx.x; m < M; m += kThreads)
        if (p.Fmt[m] > 0) tb = min(tb, pt_floordiv(-(p.pm[m] - pt), eps) + 1 + dm[m]);
      for (int e = threadIdx.x; e < E; e += kThreads)
        if (p.Ffb[e] > 0) tb = min(tb, pt_floordiv(-(p.U[e] + p.pe[e] - pt), eps) + 1 + de[e]);
      tb = pt_block_reduce(tb, PtMin(), (int)PT_DINF, s.red_i);
      int dt_n = min(dt, tb);
      if (dt_n != dt) any = 1;
      dt = dt_n;
      int* t = de; de = de_n; de_n = t;
      t = dm; dm = dm_n; dm_n = t;
      __syncthreads();
    }
    changed = pt_block_reduce(any, PtOr(), 0, s.red_i) != 0;
    sweeps += 4;
  }
  int fm = 0;
  for (int e = threadIdx.x; e < E; e += kThreads) if (de[e] < PT_DINF) fm = max(fm, de[e]);
  for (int m = threadIdx.x; m < M; m += kThreads) if (dm[m] < PT_DINF) fm = max(fm, dm[m]);
  if (dt < PT_DINF) fm = max(fm, dt);
  fm = pt_block_reduce(fm, PtMax(), 0, s.red_i);
  bool ok = !changed && fm < (1 << 26) / max(eps, 1);
  if (ok) {
    int dbig = fm + 1;
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int d = de[e] >= PT_DINF ? dbig : de[e];
      p.pe[e] = max(p.pe[e] - eps * d, PT_NEG_HALF);
    }
    for (int m = threadIdx.x; m < M; m += kThreads) {
      int d = dm[m] >= PT_DINF ? dbig : dm[m];
      p.pm[m] = max(p.pm[m] - eps * d, PT_NEG_HALF);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = dt >= PT_DINF ? dbig : dt;
      s.pt = max(s.pt - eps * d, PT_NEG_HALF);
    }
  }
  __syncthreads();
  return sweeps;
}

// One push sweep + new excesses + relabel candidates (prices frozen).
__device__ void push_sweep(const Planes& p, int total, Shared& s) {
  const int E = p.E, M = p.M;
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int pt = s.pt;
  const int exc_t = s.exc_t;
  // EC rows: machine arcs in column order, then the fallback arc.
  for (int e = w; e < E; e += kThreads / 32) {
    int xe = p.exc_e[e];
    int pe_e = p.pe[e];
    int carry = 0, pushed = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      int m = m0 + lane;
      int idx = e * M + m;
      int res = 0;
      if (m < M) {
        int rc = rc_em_at(p, idx, pe_e, p.pm[m]);
        res = (rc < 0 && xe > 0) ? p.Uem[idx] - p.F[idx] : 0;
      }
      int incl = pt_warp_incl_scan(res);
      int before = carry + incl - res;
      int push = max(min(res, xe - before), 0);
      if (m < M) p.P[idx] = push;
      pushed += push;
      carry += __shfl_sync(PT_FULL, incl, 31);
    }
    pushed = pt_warp_reduce(pushed, PtSum());
    if (lane == 0) {
      int left = xe - pushed;
      int rfb = p.U[e] + pe_e - pt;
      p.fbp[e] = (rfb < 0 && left > 0) ? min(p.sup[e] - p.Ffb[e], left) : 0;
    }
  }
  // Sink row over [machines, ECs] (pre-push Fmt / Ffb).
  {
    int carry = 0;
    int n = M + E;
    for (int b = 0; b < n; b += kThreads) {
      int i = b + threadIdx.x;
      int res = 0;
      if (i < n && exc_t > 0) {
        if (i < M) res = (-(p.pm[i] - pt) < 0) ? p.Fmt[i] : 0;
        else {
          int e = i - M;
          res = (-(p.U[e] + p.pe[e] - pt) < 0) ? p.Ffb[e] : 0;
        }
      }
      int tot;
      int incl = pt_block_incl_scan(res, s.red_i, &tot);
      int before = carry + incl - res;
      int push = max(min(res, exc_t - before), 0);
      if (i < M) p.tpm[i] = push;
      else if (i < n) p.tpe[i - M] = push;
      carry += tot;
    }
  }
  __syncthreads();
  // Machine columns: the sink arc first, then reverse arcs in EC order;
  // apply both sides' pushes and gather the column relabel candidates.
  for (int m = threadIdx.x; m < M; m += kThreads) {
    int xm = p.exc_m[m];
    int pm_m = p.pm[m];
    int rc_mt = pm_m - pt;
    int fmt = p.Fmt[m];
    int capm = p.cap[m];
    int mt_push = (rc_mt < 0 && xm > 0) ? min(capm - fmt, xm) : 0;
    int left = xm - mt_push;
    int before = 0, colsum = 0, cand = PT_NEG;
    bool hadm = false;
    for (int e = 0; e < E; ++e) {
      int idx = e * M + m;
      int f = p.F[idx];
      int c = p.C[idx];
      bool adm = c < PT_INF_COST;
      int pe_e = p.pe[e];
      int rc = adm ? c + pe_e - pm_m : PT_POS;
      int res = (rc > 0 && left > 0) ? f : 0;
      int push = max(min(res, left - before), 0);
      before += res;
      int fn = f + p.P[idx] - push;
      p.F[idx] = fn;
      colsum += fn;
      if (rc > 0 && fn > 0) hadm = true;
      if (fn > 0 && adm) cand = max(cand, pe_e + c);
    }
    int fmt_new = fmt + mt_push - p.tpm[m];
    p.Fmt[m] = fmt_new;
    p.exc_m[m] = colsum - fmt_new;
    bool mt_open = capm - fmt_new > 0;
    p.hadm_m[m] = ((rc_mt < 0 && mt_open) || hadm) ? 1 : 0;
    p.cand_m[m] = max(mt_open ? pt : PT_NEG, cand);
  }
  __syncthreads();
  // EC rows, post-push: fallback flow, excess, relabel candidates.
  for (int e = w; e < E; e += kThreads / 32) {
    int pe_e = p.pe[e];
    int rowsum = 0, cand = PT_NEG, hadm = 0;
    for (int m = lane; m < M; m += 32) {
      int idx = e * M + m;
      int fn = p.F[idx];
      int c = p.C[idx];
      bool adm = c < PT_INF_COST;
      int pm_m = p.pm[m];
      int rc = adm ? c + pe_e - pm_m : PT_POS;
      bool has_em = p.Uem[idx] - fn > 0;
      rowsum += fn;
      if (rc < 0 && has_em) hadm = 1;
      if (has_em && adm) cand = max(cand, pm_m - c);
    }
    rowsum = pt_warp_reduce(rowsum, PtSum());
    cand = pt_warp_reduce(cand, PtMax());
    hadm = pt_warp_reduce(hadm, PtOr());
    if (lane == 0) {
      int ffb = p.Ffb[e] + p.fbp[e] - p.tpe[e];
      p.Ffb[e] = ffb;
      p.exc_e[e] = p.sup[e] - rowsum - ffb;
      bool fb_open = p.sup[e] - ffb > 0;
      int rfb = p.U[e] + pe_e - pt;
      p.hadm_e[e] = (hadm || (rfb < 0 && fb_open)) ? 1 : 0;
      p.cand_e[e] = max(cand, fb_open ? pt - p.U[e] : PT_NEG);
    }
  }
  __syncthreads();
  // Sink: new excess and relabel candidates (old prices, new flows).
  int sum = 0, hadm_t = 0, cand_t = PT_NEG;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    int f = p.Fmt[m];
    sum += f;
    if (-(p.pm[m] - pt) < 0 && f > 0) hadm_t = 1;
    if (f > 0) cand_t = max(cand_t, p.pm[m]);
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int f = p.Ffb[e];
    sum += f;
    if (-(p.U[e] + p.pe[e] - pt) < 0 && f > 0) hadm_t = 1;
    if (f > 0) cand_t = max(cand_t, p.pe[e] + p.U[e]);
  }
  sum = pt_block_reduce(sum, PtSum(), 0, s.red_i);
  hadm_t = pt_block_reduce(hadm_t, PtOr(), 0, s.red_i);
  cand_t = pt_block_reduce(cand_t, PtMax(), (int)PT_NEG, s.red_i);
  if (threadIdx.x == 0) {
    s.exc_t = sum - total;
    s.hadm_t = hadm_t;
    s.cand_t = cand_t;
  }
  __syncthreads();
}

__device__ void local_relabel(const Planes& p, int eps, Shared& s) {
  for (int e = threadIdx.x; e < p.E; e += kThreads)
    p.pe[e] = pt_relabel(p.cand_e[e], p.hadm_e[e] != 0, p.exc_e[e], p.pe[e], eps);
  for (int m = threadIdx.x; m < p.M; m += kThreads)
    p.pm[m] = pt_relabel(p.cand_m[m], p.hadm_m[m] != 0, p.exc_m[m], p.pm[m], eps);
  __syncthreads();
  if (threadIdx.x == 0) s.pt = pt_relabel(s.cand_t, s.hadm_t != 0, s.exc_t, s.pt, eps);
  __syncthreads();
}

// knobs: [eps_0..eps_3, max_iter, max_iter_total, global_every, bf_max,
//         total supply, adaptive_bf]
// stats: [iters, bf_sweeps, clean, phase_iters_0..3]
__global__ void __launch_bounds__(kThreads, 1)
fused_ladder_kernel(Planes p, const int* knobs, int* stats) {
  __shared__ Shared s;
  const int E = p.E, M = p.M;
  const int max_iter = knobs[4], max_iter_total = knobs[5];
  const int global_every = knobs[6], bf_max = knobs[7];
  const int total = knobs[8], adaptive = knobs[9];
  if (threadIdx.x == 0) s.pt = p.pt[0];
  __syncthreads();
  int tot_it = 0, tot_bf = 0;
  for (int k = 0; k < PT_NUM_PHASES; ++k) {
    const int eps = knobs[k];
    const int pt0 = s.pt;
    if (tot_it + 64 < max_iter_total) {  // refine to the new eps
      for (int i = threadIdx.x; i < E * M; i += kThreads) {
        int e = i / M, m = i - e * M;
        int rc = rc_em_at(p, i, p.pe[e], p.pm[m]);
        if (rc < -eps) p.F[i] = p.Uem[i];
        else if (rc > eps) p.F[i] = 0;
      }
      for (int e = threadIdx.x; e < E; e += kThreads) {
        int rc = p.U[e] + p.pe[e] - pt0;
        if (rc < -eps) p.Ffb[e] = p.sup[e];
        else if (rc > eps) p.Ffb[e] = 0;
      }
      for (int m = threadIdx.x; m < M; m += kThreads) {
        int rc = p.pm[m] - pt0;
        if (rc < -eps) p.Fmt[m] = p.cap[m];
        else if (rc > eps) p.Fmt[m] = 0;
      }
      __syncthreads();
    }
    excesses(p, total, s);
    int it = 0, bf = 0;
    int next_gu = 0, gap = global_every, last_exc = 0;
    while (true) {
      // Entering state: activity and the saturating active-excess total.
      long long pos = 0;
      for (int e = threadIdx.x; e < E; e += kThreads) pos += max(p.exc_e[e], 0);
      for (int m = threadIdx.x; m < M; m += kThreads) pos += max(p.exc_m[m], 0);
      pos = pt_block_reduce(pos, PtSum(), 0LL, s.red_ll);
      int anypos = 0;
      for (int e = threadIdx.x; e < E; e += kThreads) anypos |= p.exc_e[e] > 0;
      for (int m = threadIdx.x; m < M; m += kThreads) anypos |= p.exc_m[m] > 0;
      anypos = pt_block_reduce(anypos, PtOr(), 0, s.red_i);
      const int exc_t = s.exc_t;
      bool active = (anypos || exc_t > 0) && it < max_iter && tot_it + it < max_iter_total;
      if (!active) break;
      int tot_excess = pt_saturate(pos + max(exc_t, 0));
      bool fired = adaptive > 0 ? it >= next_gu : it % global_every == 0;
      push_sweep(p, total, s);
      if (fired) {
        bf += global_update(p, eps, bf_max, s);
        int gap_f = tot_excess <= last_exc / 2 ? min(gap * 2, global_every * 4) : global_every;
        next_gu = it + gap_f;
        gap = gap_f;
        last_exc = tot_excess;
      } else {
        local_relabel(p, eps, s);
      }
      ++it;
    }
    if (threadIdx.x == 0) stats[3 + k] = it;
    tot_it += it;
    tot_bf += bf;
  }
  excesses(p, total, s);
  int nz = 0;
  for (int e = threadIdx.x; e < E; e += kThreads) nz |= p.exc_e[e] != 0;
  for (int m = threadIdx.x; m < M; m += kThreads) nz |= p.exc_m[m] != 0;
  nz = pt_block_reduce(nz, PtOr(), 0, s.red_i);
  if (threadIdx.x == 0) {
    stats[0] = tot_it;
    stats[1] = tot_bf;
    stats[2] = (nz == 0 && s.exc_t == 0) ? 1 : 0;
    p.pt[0] = s.pt;
  }
}

}  // namespace

// Plain C entry point.  ``ws`` is an int32 workspace of
// E * M + 11 * E + 6 * M elements; all pointers are device pointers.
extern "C" int pt_fused_ladder(const int* C, const int* U, const int* sup,
                               const int* cap, const int* Uem, int* F,
                               int* Ffb, int* Fmt, int* pe, int* pm, int* pt,
                               const int* knobs, int* stats, int* ws, int E,
                               int M, void* stream) {
  Planes p;
  p.C = C; p.U = U; p.sup = sup; p.cap = cap; p.Uem = Uem;
  p.F = F; p.Ffb = Ffb; p.Fmt = Fmt; p.pe = pe; p.pm = pm; p.pt = pt;
  p.E = E; p.M = M;
  int* q = ws;
  p.P = q; q += (size_t)E * M;
  p.exc_e = q; q += E;
  p.fbp = q; q += E;
  p.tpe = q; q += E;
  p.cand_e = q; q += E;
  p.hadm_e = q; q += E;
  p.de0 = q; q += E;
  p.de1 = q; q += E;
  p.exc_m = q; q += M;
  p.tpm = q; q += M;
  p.cand_m = q; q += M;
  p.hadm_m = q; q += M;
  p.dm0 = q; q += M;
  p.dm1 = q; q += M;
  fused_ladder_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(p, knobs, stats);
  return (int)cudaGetLastError();
}

// Per-iteration push/relabel kernels (B2): one synchronous push sweep, the
// new excesses and the local relabel of one iteration, for the bands too
// wide for the fused ladder kernel (the 10k-machine wave: [128, 10240]).
//
// Replaces: poseidon_tpu/ops/transport_tiled.py::_iteration_kernel (the
// Pallas TPU kernel launched by _tiled_iteration, looped by
// _pr_phase_tiled).  Bit-equal to the plain torch iteration
// (ops/transport.py::_pr_iteration followed by _phase_status).
//
// Bound on the H100: HBM/L2 bytes.  An iteration must read the C, Uem and F
// planes once and write F once: at [128, 10240] int32 that is 21 MB, about
// 6 us at 3.35 TB/s.  The planes fit the 50 MB L2, so repeated passes hit
// L2 rather than HBM.
//
// Design.  The TPU kernel walks 512-column tiles in grid order and carries
// the cross-tile prefixes in scratch; CUDA blocks run in no order, so the
// prefixes are restructured by axis instead.  Both push allocations read
// the PRE-push flows, so they are independent:
//   1. pt_sink:   one block, the sink row's 1-D prefix over [Fmt, Ffb];
//   2. pt_rows:   one block per EC row, a block scan over the row in
//                 chunks with a carried prefix (ec_push, fb_push, Ffb');
//                 writes F' = F + ec_push;
//   3. pt_cols:   one thread per machine column, a sequential prefix down
//                 the column (mt_push, me_push); finishes F', Fmt', exc_m'
//                 and the column relabel (pm');
//   4. pt_rows2:  one block per EC row: row sums of F', exc_e' and the row
//                 relabel (pe');
//   5. pt_final:  one block: exc_t', the sink relabel (pt') and the phase
//                 status [active, total active excess, iterations].
// A short fixed sequence of hand-written kernels on one stream, with no
// torch op between them.  The global update stays torch ops, as it stays
// XLA in the reference.

#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;
constexpr int kOneBlock = 1024;

struct Iter {
  // inputs (pre-iteration state)
  const int* C; const int* Uem; const int* U; const int* sup; const int* cap;
  const int* F; const int* Ffb; const int* Fmt; const int* pe; const int* pm;
  const int* pt; const int* exc_e; const int* exc_m; const int* exc_t;
  const int* st;
  // outputs
  int* Fo; int* Ffbo; int* Fmto; int* peo; int* pmo; int* pto;
  int* exc_eo; int* exc_mo; int* exc_to; int* sto;
  // scratch
  int* tpm; int* tpe;
  int E, M, eps, do_relabel, total;
};

__global__ void pt_sink(Iter q) {
  __shared__ int scratch[32];
  const int M = q.M, n = q.M + q.E;
  const int pt = q.pt[0], exc_t = q.exc_t[0];
  int carry = 0;
  for (int b = 0; b < n; b += blockDim.x) {
    int i = b + threadIdx.x;
    int res = 0;
    if (i < n && exc_t > 0) {
      if (i < M) res = (-(q.pm[i] - pt) < 0) ? q.Fmt[i] : 0;
      else {
        int e = i - M;
        res = (-(q.U[e] + q.pe[e] - pt) < 0) ? q.Ffb[e] : 0;
      }
    }
    int tot;
    int incl = pt_block_incl_scan(res, scratch, &tot);
    int push = max(min(res, exc_t - (carry + incl - res)), 0);
    if (i < M) q.tpm[i] = push;
    else if (i < n) q.tpe[i - M] = push;
    carry += tot;
  }
}

__global__ void pt_rows(Iter q) {
  __shared__ int scratch[32];
  const int e = blockIdx.x, M = q.M;
  const int xe = q.exc_e[e], pe_e = q.pe[e], pt = q.pt[0];
  int carry = 0, pushed = 0;
  for (int b = 0; b < M; b += blockDim.x) {
    int m = b + threadIdx.x;
    size_t idx = (size_t)e * M + m;
    int res = 0, f = 0;
    if (m < M) {
      int c = q.C[idx];
      int rc = c < PT_INF_COST ? c + pe_e - q.pm[m] : PT_POS;
      f = q.F[idx];
      res = (rc < 0 && xe > 0) ? q.Uem[idx] - f : 0;
    }
    int tot;
    int incl = pt_block_incl_scan(res, scratch, &tot);
    int push = max(min(res, xe - (carry + incl - res)), 0);
    if (m < M) q.Fo[idx] = f + push;
    pushed += push;
    carry += tot;
  }
  pushed = pt_block_reduce(pushed, PtSum(), 0, scratch);
  if (threadIdx.x == 0) {
    int left = xe - pushed;
    int rfb = q.U[e] + pe_e - pt;
    int fb = (rfb < 0 && left > 0) ? min(q.sup[e] - q.Ffb[e], left) : 0;
    q.Ffbo[e] = q.Ffb[e] + fb - q.tpe[e];
  }
}

__global__ void pt_cols(Iter q) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= q.M) return;
  const int E = q.E, M = q.M, pt = q.pt[0];
  const int xm = q.exc_m[m], pm_m = q.pm[m];
  const int rc_mt = pm_m - pt;
  const int fmt = q.Fmt[m], capm = q.cap[m];
  const int mt_push = (rc_mt < 0 && xm > 0) ? min(capm - fmt, xm) : 0;
  const int left = xm - mt_push;
  int before = 0, colsum = 0, cand = PT_NEG;
  bool hadm = false;
  for (int e = 0; e < E; ++e) {
    size_t idx = (size_t)e * M + m;
    int f = q.F[idx];
    int c = q.C[idx];
    bool adm = c < PT_INF_COST;
    int pe_e = q.pe[e];
    int rc = adm ? c + pe_e - pm_m : PT_POS;
    int res = (rc > 0 && left > 0) ? f : 0;
    int push = max(min(res, left - before), 0);
    before += res;
    int fn = q.Fo[idx] - push;
    q.Fo[idx] = fn;
    colsum += fn;
    if (rc > 0 && fn > 0) hadm = true;
    if (fn > 0 && adm) cand = max(cand, pe_e + c);
  }
  const int fmt_new = fmt + mt_push - q.tpm[m];
  const int xm_new = colsum - fmt_new;
  q.Fmto[m] = fmt_new;
  q.exc_mo[m] = xm_new;
  const bool mt_open = capm - fmt_new > 0;
  const bool has_adm = (rc_mt < 0 && mt_open) || hadm;
  const int maxcand = max(mt_open ? pt : PT_NEG, cand);
  q.pmo[m] = q.do_relabel ? pt_relabel(maxcand, has_adm, xm_new, pm_m, q.eps) : pm_m;
}

__global__ void pt_rows2(Iter q) {
  __shared__ int scratch[32];
  const int e = blockIdx.x, M = q.M;
  const int pe_e = q.pe[e], pt = q.pt[0];
  int rowsum = 0, cand = PT_NEG, hadm = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    size_t idx = (size_t)e * M + m;
    int fn = q.Fo[idx];
    int c = q.C[idx];
    bool adm = c < PT_INF_COST;
    int pm_m = q.pm[m];
    int rc = adm ? c + pe_e - pm_m : PT_POS;
    bool has_em = q.Uem[idx] - fn > 0;
    rowsum += fn;
    if (rc < 0 && has_em) hadm = 1;
    if (has_em && adm) cand = max(cand, pm_m - c);
  }
  rowsum = pt_block_reduce(rowsum, PtSum(), 0, scratch);
  cand = pt_block_reduce(cand, PtMax(), (int)PT_NEG, scratch);
  hadm = pt_block_reduce(hadm, PtOr(), 0, scratch);
  if (threadIdx.x == 0) {
    int ffb = q.Ffbo[e];
    int xe = q.sup[e] - rowsum - ffb;
    q.exc_eo[e] = xe;
    bool fb_open = q.sup[e] - ffb > 0;
    int rfb = q.U[e] + pe_e - pt;
    bool has_adm = hadm || (rfb < 0 && fb_open);
    int maxcand = max(cand, fb_open ? pt - q.U[e] : PT_NEG);
    q.peo[e] = q.do_relabel ? pt_relabel(maxcand, has_adm, xe, pe_e, q.eps) : pe_e;
  }
}

__global__ void pt_final(Iter q) {
  __shared__ int scratch[32];
  __shared__ long long scratch_ll[32];
  const int E = q.E, M = q.M, pt = q.pt[0];
  int sum = 0, hadm = 0, cand = PT_NEG, anypos = 0;
  long long pos = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    int f = q.Fmto[m];
    sum += f;
    if (-(q.pm[m] - pt) < 0 && f > 0) hadm = 1;
    if (f > 0) cand = max(cand, q.pm[m]);
    int x = q.exc_mo[m];
    if (x > 0) { anypos = 1; pos += x; }
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int f = q.Ffbo[e];
    sum += f;
    if (-(q.U[e] + q.pe[e] - pt) < 0 && f > 0) hadm = 1;
    if (f > 0) cand = max(cand, q.pe[e] + q.U[e]);
    int x = q.exc_eo[e];
    if (x > 0) { anypos = 1; pos += x; }
  }
  sum = pt_block_reduce(sum, PtSum(), 0, scratch);
  hadm = pt_block_reduce(hadm, PtOr(), 0, scratch);
  cand = pt_block_reduce(cand, PtMax(), (int)PT_NEG, scratch);
  anypos = pt_block_reduce(anypos, PtOr(), 0, scratch);
  pos = pt_block_reduce(pos, PtSum(), 0LL, scratch_ll);
  if (threadIdx.x == 0) {
    int xt = sum - q.total;
    q.exc_to[0] = xt;
    q.pto[0] = q.do_relabel ? pt_relabel(cand, hadm != 0, xt, pt, q.eps) : pt;
    // Phase status: the entering iteration counted iff it was active.
    q.sto[2] = q.st[2] + q.st[0];
    q.sto[0] = (anypos || xt > 0) ? 1 : 0;
    q.sto[1] = pt_saturate(pos + max(xt, 0));
  }
}

}  // namespace

// Plain C entry point: the five-kernel sequence of one iteration on
// ``stream``.  All pointers are device pointers; ``tpm``/``tpe`` are
// int32 scratch of M and E elements.  Returns cudaGetLastError().
extern "C" int pt_tiled_iteration(
    const int* C, const int* Uem, const int* U, const int* sup,
    const int* cap, const int* F, const int* Ffb, const int* Fmt,
    const int* pe, const int* pm, const int* pt, const int* exc_e,
    const int* exc_m, const int* exc_t, const int* st, int* Fo, int* Ffbo,
    int* Fmto, int* peo, int* pmo, int* pto, int* exc_eo, int* exc_mo,
    int* exc_to, int* sto, int* tpm, int* tpe, int E, int M, int eps,
    int do_relabel, int total, void* stream) {
  Iter q;
  q.C = C; q.Uem = Uem; q.U = U; q.sup = sup; q.cap = cap;
  q.F = F; q.Ffb = Ffb; q.Fmt = Fmt; q.pe = pe; q.pm = pm; q.pt = pt;
  q.exc_e = exc_e; q.exc_m = exc_m; q.exc_t = exc_t; q.st = st;
  q.Fo = Fo; q.Ffbo = Ffbo; q.Fmto = Fmto; q.peo = peo; q.pmo = pmo;
  q.pto = pto; q.exc_eo = exc_eo; q.exc_mo = exc_mo; q.exc_to = exc_to;
  q.sto = sto; q.tpm = tpm; q.tpe = tpe;
  q.E = E; q.M = M; q.eps = eps; q.do_relabel = do_relabel; q.total = total;
  cudaStream_t s = (cudaStream_t)stream;
  pt_sink<<<1, kOneBlock, 0, s>>>(q);
  pt_rows<<<E, kRowThreads, 0, s>>>(q);
  pt_cols<<<(M + kColThreads - 1) / kColThreads, kColThreads, 0, s>>>(q);
  pt_rows2<<<E, kRowThreads, 0, s>>>(q);
  pt_final<<<1, kOneBlock, 0, s>>>(q);
  return (int)cudaGetLastError();
}

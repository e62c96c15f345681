// The fused-horizon chord kernel for Hopper (sm_90a): one fixed-dt BDF
// phase of the TRPL drift-diffusion-decay model, with chord Newton and the
// fused log-likelihood, in a single launch.
//
// Replaces: horizon_kernel._kernel of the JAX package
// (bayesian_inference_trpl_tpu/ops/pallas/horizon_kernel.py:447-746,
// launched by _call at :761-902), in its three chord modes: stride 1
// (solve_horizon_fused, the fine phase), stride S (solve_coarse_phase_fused,
// one rung of the ladder, with cubic log-space dense output at the S fine
// observation points of each coarse step) and off-grid, offgrid_k = K
// (solve_phase_offgrid_fused, :1195-1310: K observation slots per step
// scored from per-slot Lagrange weights over the same log-PL window, and a
// liveness row that forgives a Newton failure only after the last
// observation).  The three modes share the step loop; only the likelihood
// at the end of each step differs.
//
// Design: one thread block per sample and one thread per spatial cell
// (blockDim.x == L), the original CUDA design of the reference
// (pvSimPCR.py).  The whole phase runs in one launch: a loop over time
// inside the block takes the place of the TPU grid's sequential time axis.
// Shared memory holds, per sample, the rolling 6-slot N/P/E histories, the
// chord cache (the PCR elimination multipliers of every sweep plus the
// final pair-solve blocks, reused across steps until a refresh) and the PCR
// work arrays.  Reductions over L (residual norms, PL) are block
// reductions whose result is bitwise identical in every thread, so the
// chord decisions (skip, loop exit, refresh) are uniform across the block.
// Those decisions are therefore per sample; the JAX kernel takes them over
// its whole sample tile (see ops/horizon_kernel.py, ``group``).
//
// What bounds it on this card: FP32 (FP64) issue rate and __syncthreads
// latency, not memory.  Device-memory traffic is a few bytes per
// sample-step (one observation value per experiment, or 6 K values per
// experiment off-grid, which stay in L2); every state array stays in
// shared memory from the first step to the last.  Each Newton
// iteration is a chain of short data-parallel phases over 128 cells
// separated by block barriers (neighbour exchange, 6 PCR sweeps, block
// reductions), so latency between barriers dominates at this occupancy.
// Tensor cores, TMA, several samples per block and warp-level PCR are for
// later work.
//
// Arithmetic follows the JAX package's expression order, and the library
// is built with --fmad=false, so float64 results agree with the plain
// PyTorch version to rounding.

#include <cuda_runtime.h>

namespace {

template <typename T> struct Blk { T a, b, c, d; };   // 2x2 block (m11, m12, m21, m22)
template <typename T> struct Vec { T x, y; };

template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double tiny_of<double>() { return 2.2250738585072014e-308; }

__device__ __forceinline__ float log10_of(float x) { return log10f(x); }
__device__ __forceinline__ double log10_of(double x) { return log10(x); }

// Reciprocal for the block inverses: exact, or (approx_inv) a fast
// approximation refined by one Newton step.
__device__ __forceinline__ float fast_recip(float x) {
  float r = __fdividef(1.0f, x);
  return r * (2.0f - x * r);
}
__device__ __forceinline__ double fast_recip(double x) {
  double r = 1.0 / x;
  return r * (2.0 - x * r);
}

__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }

// max that propagates NaN, as jnp.maximum / torch.maximum do.
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T> __device__ __forceinline__ T onehot(int i, int k) {
  return i == k ? T(1) : T(0);
}

template <typename T> __device__ __forceinline__ Blk<T> bmul(Blk<T> A, Blk<T> B) {
  return {A.a * B.a + A.b * B.c, A.a * B.b + A.b * B.d,
          A.c * B.a + A.d * B.c, A.c * B.b + A.d * B.d};
}
template <typename T> __device__ __forceinline__ Vec<T> bmulvec(Blk<T> A, Vec<T> v) {
  return {A.a * v.x + A.b * v.y, A.c * v.x + A.d * v.y};
}
template <typename T> __device__ __forceinline__ Blk<T> binv(Blk<T> A, bool approx) {
  T det = A.a * A.d - A.b * A.c;
  T inv = approx ? fast_recip(det) : T(1) / det;
  return {A.d * inv, (-A.b) * inv, (-A.c) * inv, A.a * inv};
}
template <typename T> __device__ __forceinline__ Blk<T> bsub(Blk<T> A, Blk<T> B) {
  return {A.a - B.a, A.b - B.b, A.c - B.c, A.d - B.d};
}
template <typename T> __device__ __forceinline__ Blk<T> bneg(Blk<T> A) {
  return {-A.a, -A.b, -A.c, -A.d};
}
// Component c of block array M laid out [c][L] (stride L between components).
template <typename T> __device__ __forceinline__ Blk<T> bload(const T* M, int i, int L) {
  return {M[i], M[L + i], M[2 * L + i], M[3 * L + i]};
}
template <typename T> __device__ __forceinline__ void bstore(T* M, int i, int L, Blk<T> v) {
  M[i] = v.a; M[L + i] = v.b; M[2 * L + i] = v.c; M[3 * L + i] = v.d;
}

template <typename T> struct Args {
  const T *mat, *n0, *p0, *e0, *obs, *msk, *vmask, *pl0, *wtab, *bdf;
  T *sse, *esum;
  int *conv, *its, *maxit;
  T *n_out, *p_out, *e_out;
  int *fulls, *execs;
  int batch, L, T_steps, stride, offgrid_k, num_exp;
  int has_mask, normalize, ext_pl0, pred_order, max_iters, chord_budget, approx_inv;
  double tol, step_tol, log_scale, min_val, settle_guard, skip_accept_factor,
      skip_tighten, stall, step_tol_guard;
};

// Shared-memory layout, in elements of T.  ``slots`` likelihood
// accumulators per experiment: 1 (stride 1), S (stride S) or K (off-grid).
struct Layout {
  int nh, ph, eh, kc1, kc2, fin, sA, sB, sC, xN, xP, jn, jp, ed, r1, r2, red,
      bdf, acc, total;
  __host__ __device__ Layout(int L, int num_exp, int slots) {
    int ns = 0;
    for (int rf = 1; L > 2 * rf; rf *= 2) ns++;
    int nw = L / 32;
    int o = 0;
    nh = o; o += 6 * L;
    ph = o; o += 6 * L;
    eh = o; o += 6 * L;
    kc1 = o; o += ns * 4 * L;
    kc2 = o; o += ns * 4 * L;
    fin = o; o += 16 * (L / 2);
    sA = o; o += 4 * L;
    sB = o; o += 4 * L;
    sC = o; o += 4 * L;
    xN = o; o += L;
    xP = o; o += L;
    jn = o; o += L;
    jp = o; o += L;
    ed = o; o += 8 * L;
    r1 = o; o += L;
    r2 = o; o += L;
    red = o; o += 8 * nw;   // two buffers of 4 partials per warp
    bdf = o; o += 32;
    acc = o; o += 2 * num_exp * slots;
    total = o;
  }
};

// Block-wide sums / maxima of four values.  Warp butterflies give every
// lane the same bits; the per-warp partials are then combined in a fixed
// order by every thread, so all threads hold identical results.  Two
// alternating buffers make one barrier per reduction enough.
template <typename T>
__device__ __forceinline__ void block_reduce4(T v[4], T* red, int& parity, bool is_max) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; k++) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      T u = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = is_max ? nmax(v[k], u) : v[k] + u;
    }
  }
  T* buf = red + parity * 4 * nw;
  parity ^= 1;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; k++) buf[k * nw + w] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; k++) {
    T s = buf[k * nw];
    for (int j = 1; j < nw; j++) s = is_max ? nmax(s, buf[k * nw + j]) : s + buf[k * nw + j];
    v[k] = s;
  }
}

template <typename T> struct Mat {
  T n0, p0, dn, dp, rate, sr0, srL, cn, cp, tau_n, tau_p, lam;
};

// Everything the Jacobian pass reuses from the residual pass at the same
// iterate: edge quantities of edge i, recombination partials of node i and
// the (sample-wide) surface partials.
template <typename T> struct Aux {
  T g, nbar, pbar, v, dRdN, dRdP, s0N, s0P, sLN, sLP;
};

template <typename T> struct Block {
  T* sm;
  Layout lay;
  int i, L;
  int parity;
};

// Cheap residual pass at iterate (N, P) (models/newton.residuals_and_errors):
// returns the node residuals in FN/FP and the reference-metric relative
// errors (identical in all threads).  Publishes (N, P) in xN/xP.
template <typename T>
__device__ void residual(Block<T>& bk, const Mat<T>& mp, T a0, T N, T P, T bN, T bP,
                         T bE, T& FN, T& FP, T& errn, T& errp, Aux<T>& ax) {
  T* sm = bk.sm;
  const int i = bk.i, L = bk.L;
  T* xN = sm + bk.lay.xN;
  T* xP = sm + bk.lay.xP;
  T* jns = sm + bk.lay.jn;
  T* jps = sm + bk.lay.jp;
  xN[i] = N;
  xP[i] = P;
  __syncthreads();
  // Edge i couples nodes i-1 and i; edge 0 does not exist (zeroed).
  const T Nm = i > 0 ? xN[i - 1] : T(0);
  const T Pm = i > 0 ? xP[i - 1] : T(0);
  const T nbar = T(0.5) * (N + Nm);
  const T pbar = T(0.5) * (P + Pm);
  const T dN = N - Nm;
  const T dP = P - Pm;
  const T v = a0 + mp.lam * (mp.dn * nbar + mp.dp * pbar);
  const T g = (mp.lam * (mp.dp * dP - mp.dn * dN) - bE) / v;
  const T z0 = T(1) - onehot<T>(i, 0);
  const T jn = (mp.dn * (g * nbar + dN)) * z0;
  const T jp = (mp.dp * (g * pbar - dP)) * z0;
  jns[i] = jn;
  jps[i] = jp;
  // Bulk recombination and its partials.
  const T n0p0 = mp.n0 * mp.p0;
  const T np_ = N * P - n0p0;
  const T tp = N * mp.tau_p + P * mp.tau_n;
  const T tp2 = tp * tp;
  const T R = (mp.cn * N + mp.cp * P + mp.rate + T(1) / tp) * np_;
  const T dRdN = mp.rate * P + (P * tp - mp.tau_p * np_) / tp2 +
                 (mp.cn * N * P + mp.cp * (P * P) + mp.cn * np_);
  const T dRdP = mp.rate * N + (N * tp - mp.tau_n * np_) / tp2 +
                 (mp.cp * N * P + mp.cn * (N * N) + mp.cp * np_);
  // Surface recombination at nodes 0 and L-1 (sample-wide scalars).
  const T N0 = xN[0], P0 = xP[0], NL = xN[L - 1], PL = xP[L - 1];
  const T d0 = N0 + P0, dL = NL + PL;
  const T s0 = mp.sr0 * (N0 * P0 - n0p0) / d0;
  const T sL = mp.srL * (NL * PL - n0p0) / dL;
  ax.s0N = mp.sr0 * (P0 * P0 + n0p0) / (d0 * d0);
  ax.s0P = mp.sr0 * (N0 * N0 + n0p0) / (d0 * d0);
  ax.sLN = mp.srL * (PL * PL + n0p0) / (dL * dL);
  ax.sLP = mp.srL * (NL * NL + n0p0) / (dL * dL);
  __syncthreads();
  const T h0 = onehot<T>(i, 0), hL = onehot<T>(i, L - 1);
  const T jn_r = (i < L - 1 ? jns[i + 1] : T(0)) + (-sL) * hL;
  const T jn_l = jn + s0 * h0;
  const T jp_r = (i < L - 1 ? jps[i + 1] : T(0)) + sL * hL;
  const T jp_l = jp + (-s0) * h0;
  FN = a0 * N + bN - (jn_r - jn_l) + R;
  FP = a0 * P + bP + (jp_r - jp_l) + R;
  T bbN = -R + dRdN * N - bN;
  bbN = bbN + (-(s0 - ax.s0N * N0)) * h0;
  bbN = bbN + (-(sL - ax.sLN * NL)) * hL;
  T bbP = -R + dRdP * P - bP;
  bbP = bbP + (-(s0 - ax.s0P * P0)) * h0;
  bbP = bbP + (-(sL - ax.sLP * PL)) * hL;
  T v4[4] = {absv(FN), absv(FP), absv(bbN), absv(bbP)};
  block_reduce4(v4, sm + bk.lay.red, bk.parity, false);
  errn = v4[0] / v4[2];
  errp = v4[1] / v4[3];
  ax.g = g;
  ax.nbar = nbar;
  ax.pbar = pbar;
  ax.v = v;
  ax.dRdN = dRdN;
  ax.dRdP = dRdP;
}

// Full refresh: the exact Jacobian at the iterate of the last residual
// pass (models/newton.residuals_and_jacobian), then the PCR reduce
// (ops/block_tridiag.block_pcr_reduce) written into the chord cache.
template <typename T>
__device__ void refresh(Block<T>& bk, const Mat<T>& mp, T a0, const Aux<T>& ax, bool approx) {
  T* sm = bk.sm;
  const Layout& ly = bk.lay;
  const int i = bk.i, L = bk.L;
  const T g = ax.g, nbar = ax.nbar, pbar = ax.pbar;
  const T inv_v = T(1) / ax.v;
  const T gNm = mp.lam * mp.dn * (T(1) - T(0.5) * g) * inv_v;
  const T gNp = -mp.lam * mp.dn * (T(1) + T(0.5) * g) * inv_v;
  const T gPm = -mp.lam * mp.dp * (T(1) + T(0.5) * g) * inv_v;
  const T gPp = mp.lam * mp.dp * (T(1) - T(0.5) * g) * inv_v;
  const T z0 = T(1) - onehot<T>(i, 0);
  const T jnNm = (mp.dn * (gNm * nbar + T(0.5) * g - T(1))) * z0;
  const T jnNp = (mp.dn * (gNp * nbar + T(0.5) * g + T(1))) * z0;
  const T jnPm = (mp.dn * gPm * nbar) * z0;
  const T jnPp = (mp.dn * gPp * nbar) * z0;
  const T jpPm = (mp.dp * (gPm * pbar + T(0.5) * g + T(1))) * z0;
  const T jpPp = (mp.dp * (gPp * pbar + T(0.5) * g - T(1))) * z0;
  const T jpNm = (mp.dp * gNm * pbar) * z0;
  const T jpNp = (mp.dp * gNp * pbar) * z0;
  T* ed = sm + ly.ed;
  ed[0 * L + i] = jnNm;
  ed[1 * L + i] = jnPm;
  ed[2 * L + i] = jpPm;
  ed[3 * L + i] = jpNm;
  ed[4 * L + i] = jnNp;
  ed[5 * L + i] = jnPp;
  ed[6 * L + i] = jpPp;
  ed[7 * L + i] = jpNp;
  __syncthreads();
  auto sh = [&](int k) { return i < L - 1 ? ed[k * L + i + 1] : T(0); };
  const T h0 = onehot<T>(i, 0), hL = onehot<T>(i, L - 1);
  const T sNt = ax.s0N * h0 + ax.sLN * hL;
  const T sPt = ax.s0P * h0 + ax.sLP * hL;
  Blk<T> B = {a0 - sh(0) + jnNp + ax.dRdN + sNt,      // B_NN
              -sh(1) + jnPp + ax.dRdP + sPt,           // B_NP
              sh(3) - jpNp + ax.dRdN + sNt,            // B_PN
              a0 + sh(2) - jpPp + ax.dRdP + sPt};      // B_PP
  Blk<T> C = {-sh(4), -sh(5), sh(7), sh(6)};          // (C_NN, C_NP, C_PN, C_PP)
  Blk<T> A = {jnNm, jnPm, -jpNm, -jpPm};               // (A_NN, A_NP, A_PN, A_PP)
  T* sA = sm + ly.sA;
  T* sB = sm + ly.sB;
  T* sC = sm + ly.sC;
  bstore(sA, i, L, A);
  bstore(sB, i, L, B);
  bstore(sC, i, L, C);
  __syncthreads();
  const Blk<T> I = {T(1), T(0), T(0), T(1)}, Z = {T(0), T(0), T(0), T(0)};
  int s = 0;
  for (int rf = 1; L > 2 * rf; rf *= 2, s++) {
    const bool lo = i >= rf, hi = i + rf < L;
    const Blk<T> Bm = lo ? bload(sB, i - rf, L) : I;
    const Blk<T> Bp = hi ? bload(sB, i + rf, L) : I;
    const Blk<T> Cm = lo ? bload(sC, i - rf, L) : Z;
    const Blk<T> Am = lo ? bload(sA, i - rf, L) : Z;
    const Blk<T> Ap = hi ? bload(sA, i + rf, L) : Z;
    const Blk<T> Cp = hi ? bload(sC, i + rf, L) : Z;
    const Blk<T> k1 = bmul(A, binv(Bm, approx));
    const Blk<T> k2 = bmul(C, binv(Bp, approx));
    B = bsub(B, bmul(k1, Cm));
    B = bsub(B, bmul(k2, Ap));
    A = bneg(bmul(k1, Am));
    C = bneg(bmul(k2, Cp));
    bstore(sm + ly.kc1 + s * 4 * L, i, L, k1);
    bstore(sm + ly.kc2 + s * 4 * L, i, L, k2);
    __syncthreads();
    bstore(sA, i, L, A);
    bstore(sB, i, L, B);
    bstore(sC, i, L, C);
    __syncthreads();
  }
  const int half = L / 2;
  if (i < half) {
    const Blk<T> Bhi = bload(sB, i + half, L);
    const Blk<T> Ahi = bload(sA, i + half, L);
    const Blk<T> inv_Bhi = binv(Bhi, approx);
    const Blk<T> k = bmul(C, inv_Bhi);
    const Blk<T> inv_lhs = binv(bsub(B, bmul(k, Ahi)), approx);
    T* fin = sm + ly.fin;
    bstore(fin, i, half, k);
    bstore(fin + 4 * half, i, half, inv_lhs);
    bstore(fin + 8 * half, i, half, inv_Bhi);
    bstore(fin + 12 * half, i, half, Ahi);
  }
  __syncthreads();
}

// Solve J d = -F with the cached factorization
// (ops/block_tridiag.block_pcr_apply).  No divides.
template <typename T>
__device__ void apply(Block<T>& bk, T FN, T FP, T& dN, T& dP) {
  T* sm = bk.sm;
  const Layout& ly = bk.lay;
  const int i = bk.i, L = bk.L;
  T* r1 = sm + ly.r1;
  T* r2 = sm + ly.r2;
  Vec<T> r = {-FN, -FP};
  r1[i] = r.x;
  r2[i] = r.y;
  __syncthreads();
  int s = 0;
  for (int rf = 1; L > 2 * rf; rf *= 2, s++) {
    const Vec<T> rm = i >= rf ? Vec<T>{r1[i - rf], r2[i - rf]} : Vec<T>{T(0), T(0)};
    const Vec<T> rp = i + rf < L ? Vec<T>{r1[i + rf], r2[i + rf]} : Vec<T>{T(0), T(0)};
    const Vec<T> t1 = bmulvec(bload(sm + ly.kc1 + s * 4 * L, i, L), rm);
    const Vec<T> t2 = bmulvec(bload(sm + ly.kc2 + s * 4 * L, i, L), rp);
    r = {r.x - t1.x - t2.x, r.y - t1.y - t2.y};
    __syncthreads();
    r1[i] = r.x;
    r2[i] = r.y;
    __syncthreads();
  }
  const int half = L / 2;
  if (i < half) {
    const T* fin = sm + ly.fin;
    const Vec<T> rhi = {r1[i + half], r2[i + half]};
    const Vec<T> kv = bmulvec(bload(fin, i, half), rhi);
    const Vec<T> rhs = {r.x - kv.x, r.y - kv.y};
    const Vec<T> xlo = bmulvec(bload(fin + 4 * half, i, half), rhs);
    const Vec<T> av = bmulvec(bload(fin + 12 * half, i, half), xlo);
    const Vec<T> rhs_hi = {rhi.x - av.x, rhi.y - av.y};
    const Vec<T> xhi = bmulvec(bload(fin + 8 * half, i, half), rhs_hi);
    r1[i] = xlo.x;
    r2[i] = xlo.y;
    r1[i + half] = xhi.x;
    r2[i + half] = xhi.y;
  }
  __syncthreads();
  dN = r1[i];
  dP = r2[i];
}

// The likelihood at the end of each step: at observation point t+1
// (STRIDE1), at the S fine points of coarse step t by dense output
// (STRIDES), or at the K observation slots of step t (OFFGRID).
enum Mode { STRIDE1, STRIDES, OFFGRID };

template <int MODE> __host__ __device__ __forceinline__ int slots_of(int stride, int k) {
  return MODE == OFFGRID ? k : MODE == STRIDES ? stride : 1;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(1024) horizon_chord_kernel(const Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int S = slots_of<MODE>(a.stride, a.offgrid_k);   // accumulators per experiment
  Block<T> bk{reinterpret_cast<T*>(smem_raw), Layout(a.L, a.num_exp, S),
              (int)threadIdx.x, a.L, 0};
  T* sm = bk.sm;
  const Layout& ly = bk.lay;
  const int b = blockIdx.x, i = bk.i, L = bk.L;
  const int NE = a.num_exp, TS = a.T_steps;
  const bool approx = a.approx_inv != 0;

  const T* mrow = a.mat + (size_t)b * 12;
  const Mat<T> mp = {mrow[0], mrow[1], mrow[2], mrow[3], mrow[4],  mrow[5],
                     mrow[6], mrow[7], mrow[8], mrow[9], mrow[10], mrow[11]};
  const T tol = T(a.tol), step_tol = T(a.step_tol), log_scale = T(a.log_scale);
  const T minv = T(a.min_val) > tiny_of<T>() ? T(a.min_val) : tiny_of<T>();
  const T skip_tol = tol * T(a.skip_accept_factor) * T(a.skip_tighten);
  const T guard_full = tol * T(a.step_tol_guard);
  const T guard_chord = tol * T(a.settle_guard);
  const T stall = T(a.stall);

  T* nh = sm + ly.nh;
  T* ph = sm + ly.ph;
  T* eh = sm + ly.eh;
  T* bdf = sm + ly.bdf;
  T* acc_sse = sm + ly.acc;
  T* acc_esum = acc_sse + NE * S;
  const size_t row0 = (size_t)b * L + i;
  const T n_init = a.n0[row0], p_init = a.p0[row0];
  for (int s = 0; s < 6; s++) {
    nh[s * L + i] = s == 0 ? n_init : T(0);
    ph[s * L + i] = s == 0 ? p_init : T(0);
    eh[s * L + i] = s == 0 ? a.e0[row0] : T(0);
  }
  if (i < 30) bdf[i] = a.bdf[i];
  for (int k = i; k < 2 * NE * S; k += L) acc_sse[k] = T(0);

  // PL at the phase start (normalization anchor unless given, and the
  // dense-output window's newest node; on the phase's rescaled rate).
  const T n0p0 = mp.n0 * mp.p0;
  T v4[4] = {n_init * p_init, T(0), T(0), T(0)};
  block_reduce4(v4, sm + ly.red, bk.parity, false);
  const T pl00 = mp.rate * (v4[0] - T(L) * n0p0);
  const T pl0s = a.ext_pl0 ? a.pl0[b] : pl00;
  auto logpl = [&](T x) {
    if (a.normalize) return log10_of(nmax(x / pl0s, minv));
    return log10_of(nmax(x, minv)) + log_scale;
  };
  T lpw0 = T(0), lpw1 = T(0), lpw2 = T(0), lpw3 = MODE != STRIDE1 ? logpl(pl00) : T(0);

  bool conv = true, cval = false;
  int its = 0, maxit = 0, fulls = 0, execs = 0;
  T N = n_init, P = p_init, E = a.e0[row0];

  for (int t = 0; t < TS; t++) {
    const int row = t < 4 ? t : 4;
    const T a0 = bdf[row * 6];
    int sl[5];
#pragma unroll
    for (int m = 0; m < 5; m++) sl[m] = ((t - m) % 6 + 6) % 6;
    T bN = bdf[row * 6 + 1] * nh[sl[0] * L + i];
    T bP = bdf[row * 6 + 1] * ph[sl[0] * L + i];
    T bE = bdf[row * 6 + 1] * eh[sl[0] * L + i];
#pragma unroll
    for (int m = 1; m < 5; m++) {
      const T w = bdf[row * 6 + m + 1];
      bN = bN + w * nh[sl[m] * L + i];
      bP = bP + w * ph[sl[m] * L + i];
      bE = bE + w * eh[sl[m] * L + i];
    }
    N = nh[sl[0] * L + i];
    P = ph[sl[0] * L + i];
    if (a.pred_order) {
      // Extrapolated initial iterate with a positivity fallback
      // (models/solver.bdf_step; horizon_kernel.py:568-592).
      const T Nm = nh[sl[1] * L + i], Pm = ph[sl[1] * L + i];
      const T ramp = t > 0 ? T(1) : T(0);
      const T d1n = N - Nm, d1p = P - Pm;
      T Nx = N + ramp * d1n;
      T Px = P + ramp * d1p;
      if (a.pred_order == 2) {
        const T ramp2 = t > 1 ? T(1) : T(0);
        Nx = Nx + ramp2 * (d1n - (Nm - nh[sl[2] * L + i]));
        Px = Px + ramp2 * (d1p - (Pm - ph[sl[2] * L + i]));
      }
      if (a.pred_order == 3) {
        Nx = Nm > T(0) ? N * (N / Nm) : Nx;
        Px = Pm > T(0) ? P * (P / Pm) : Px;
      }
      N = Nx > T(0) ? Nx : N;
      P = Px > T(0) ? Px : P;
    }

    // ---- Chord Newton (horizon_kernel._newton_solve_chord).
    T FN, FP, errn, errp;
    Aux<T> ax;
    residual(bk, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
    bool done = errn < skip_tol && errp < skip_tol;
    int step_its = 0;
    if (!done) {
      bool full = !cval;
      for (int it = 0; it < a.max_iters && !done; it++) {
        execs++;
        if (full) {
          refresh(bk, mp, a0, ax, approx);
          cval = true;
          fulls++;
        }
        T dN, dP;
        apply(bk, FN, FP, dN, dP);
        const T upd = T(1);
        N = N + upd * (nmax(N + dN, T(0.05) * N) - N);
        P = P + upd * (nmax(P + dP, T(0.05) * P) - P);
        step_its++;
        T m4[4] = {absv(dN), absv(N), absv(dP), absv(P)};
        block_reduce4(m4, sm + ly.red, bk.parity, true);
        const T guard = full ? guard_full : guard_chord;
        const bool ok_step = m4[0] <= step_tol * m4[1] && m4[2] <= step_tol * m4[3] &&
                             errn < guard && errp < guard;
        T errn2, errp2;
        residual(bk, mp, a0, N, P, bN, bP, bE, FN, FP, errn2, errp2, ax);
        done = ok_step || (errn2 < skip_tol && errp2 < skip_tol);
        const bool bad = !done && (errn2 > stall * errn || errp2 > stall * errp);
        full = bad || it + 1 >= a.chord_budget;
        errn = errn2;
        errp = errp2;
      }
      done = done || (errn < tol && errp < tol);
    }
    // ---- E update (trpl.update_e); xN/xP hold the accepted iterate.
    {
      const T Nm = i > 0 ? sm[ly.xN + i - 1] : T(0);
      const T Pm = i > 0 ? sm[ly.xP + i - 1] : T(0);
      const T denom = mp.lam * (mp.dp * (P + Pm) + mp.dn * (N + Nm)) / T(2) + a0;
      const T num = mp.lam * (mp.dp * (P - Pm) - mp.dn * (N - Nm)) - bE;
      E = (num / denom) * (T(1) - onehot<T>(i, 0));
    }
    const int sn = (t + 1) % 6;
    nh[sn * L + i] = N;
    ph[sn * L + i] = P;
    eh[sn * L + i] = E;
    its += step_its;
    maxit = step_its > maxit ? step_its : maxit;

    // ---- Fused likelihood (see Mode).
    T p4[4] = {N * P, T(0), T(0), T(0)};
    block_reduce4(p4, sm + ly.red, bk.parity, false);
    const T lp = logpl(mp.rate * (p4[0] - T(L) * n0p0));
    T w_any = T(0);
    if (MODE == STRIDE1) {
      for (int e = i; e < NE; e += L) {
        const T err = lp - a.obs[(size_t)e * TS + t];
        if (a.has_mask) {
          const T m = a.msk[(size_t)e * TS + t];
          acc_sse[e] = acc_sse[e] + m * err * err;
          acc_esum[e] = acc_esum[e] + m * err;
        } else {
          acc_sse[e] = acc_sse[e] + err * err;
          acc_esum[e] = acc_esum[e] + err;
        }
      }
    } else if (MODE == OFFGRID) {
      // Slot k of experiment e: its 4 window weights lie K apart in the
      // (E, T, 4K) table; values and weights are (E, T, K).  Thread k owns
      // slot k's sums, so no barrier is needed until the final reduction.
      lpw0 = lpw1;
      lpw1 = lpw2;
      lpw2 = lpw3;
      lpw3 = lp;
      for (int e = 0; e < NE; e++) {
        for (int k = i; k < S; k += L) {
          const size_t o = ((size_t)e * TS + t) * S + k;
          const T* W = a.wtab + ((size_t)e * TS + t) * 4 * S + k;
          const T lpa = lpw0 * W[0] + lpw1 * W[S] + lpw2 * W[2 * S] + lpw3 * W[3 * S];
          const T err = lpa - a.obs[o];
          const T wg = a.vmask[o];
          acc_sse[e * S + k] = acc_sse[e * S + k] + wg * err * err;
          acc_esum[e * S + k] = acc_esum[e * S + k] + wg * err;
        }
      }
      // Liveness: only the steps after the run's last observation forgive
      // a Newton failure (an unobserved interior step feeds later points).
      done = done || !(a.msk[t] > T(0));
    } else {
      lpw0 = lpw1;
      lpw1 = lpw2;
      lpw2 = lpw3;
      lpw3 = lp;
      if (i < S) {
        const T* W = a.wtab + ((size_t)(t < 2 ? t : 2) * S + i) * 4;
        const T lpf = lpw0 * W[0] + lpw1 * W[1] + lpw2 * W[2] + lpw3 * W[3];
        for (int e = 0; e < NE; e++) {
          const size_t o = ((size_t)e * TS + t) * S + i;
          const T err = lpf - a.obs[o];
          if (a.has_mask) {
            const T vm = a.vmask[o];
            acc_sse[e * S + i] = acc_sse[e * S + i] + vm * err * err;
            acc_esum[e * S + i] = acc_esum[e * S + i] + vm * err;
          } else {
            acc_sse[e * S + i] = acc_sse[e * S + i] + err * err;
            acc_esum[e * S + i] = acc_esum[e * S + i] + err;
          }
        }
      }
    }
    if (MODE != OFFGRID && a.has_mask) {
      // Padding-only steps (zero weight in every experiment) cannot fail
      // a sample.
      w_any = a.msk[t];
      for (int e = 1; e < NE; e++) w_any = nmax(w_any, a.msk[(size_t)e * TS + t]);
      done = done || !(w_any > T(0));
    }
    conv = conv && done;
  }

  __syncthreads();
  for (int e = i; e < NE; e += L) {
    T s = acc_sse[e * S], q = acc_esum[e * S];
    for (int j = 1; j < S; j++) {
      s = s + acc_sse[e * S + j];
      q = q + acc_esum[e * S + j];
    }
    a.sse[(size_t)e * a.batch + b] = s;
    a.esum[(size_t)e * a.batch + b] = q;
  }
  a.n_out[row0] = N;
  a.p_out[row0] = P;
  a.e_out[row0] = E;
  if (i == 0) {
    a.conv[b] = conv ? 1 : 0;
    a.its[b] = its;
    a.maxit[b] = maxit;
    a.fulls[b] = fulls;
    a.execs[b] = execs;
  }
}

template <typename T, int MODE>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int mode = a.offgrid_k > 0 ? OFFGRID : a.stride > 1 ? STRIDES : STRIDE1;
  if (mode != MODE || (MODE == OFFGRID && a.stride != 1)) return (int)cudaErrorInvalidValue;
  if (a.batch == 0 || a.T_steps == 0) return 0;
  const Layout ly(a.L, a.num_exp, slots_of<MODE>(a.stride, a.offgrid_k));
  const size_t bytes = (size_t)ly.total * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      horizon_chord_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  horizon_chord_kernel<T, MODE><<<a.batch, a.L, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int entry(const void* mat, const void* n0, const void* p0, const void* e0,
          const void* obs, const void* msk, const void* vmask, const void* pl0,
          const void* wtab, const void* bdf, void* sse, void* esum, void* conv,
          void* its, void* maxit, void* n_out, void* p_out, void* e_out,
          void* fulls, void* execs, int batch, int L, int T_steps, int stride,
          int offgrid_k, int num_exp, int has_mask, int normalize, int ext_pl0, int pred_order,
          int max_iters, int chord_budget, int approx_inv, double tol,
          double step_tol, double log_scale, double min_val, double settle_guard,
          double skip_accept_factor, double skip_tighten, double stall,
          double step_tol_guard, void* stream) {
  Args<T> a;
  a.mat = (const T*)mat; a.n0 = (const T*)n0; a.p0 = (const T*)p0; a.e0 = (const T*)e0;
  a.obs = (const T*)obs; a.msk = (const T*)msk; a.vmask = (const T*)vmask;
  a.pl0 = (const T*)pl0; a.wtab = (const T*)wtab; a.bdf = (const T*)bdf;
  a.sse = (T*)sse; a.esum = (T*)esum;
  a.conv = (int*)conv; a.its = (int*)its; a.maxit = (int*)maxit;
  a.n_out = (T*)n_out; a.p_out = (T*)p_out; a.e_out = (T*)e_out;
  a.fulls = (int*)fulls; a.execs = (int*)execs;
  a.batch = batch; a.L = L; a.T_steps = T_steps; a.stride = stride;
  a.offgrid_k = offgrid_k; a.num_exp = num_exp;
  a.has_mask = has_mask; a.normalize = normalize; a.ext_pl0 = ext_pl0;
  a.pred_order = pred_order; a.max_iters = max_iters; a.chord_budget = chord_budget;
  a.approx_inv = approx_inv;
  a.tol = tol; a.step_tol = step_tol; a.log_scale = log_scale; a.min_val = min_val;
  a.settle_guard = settle_guard; a.skip_accept_factor = skip_accept_factor;
  a.skip_tighten = skip_tighten; a.stall = stall; a.step_tol_guard = step_tol_guard;
  return launch<T, MODE>(a, (cudaStream_t)stream);
}

}  // namespace

#define TRPL_ENTRY_ARGS                                                          \
  const void *mat, const void *n0, const void *p0, const void *e0,              \
      const void *obs, const void *msk, const void *vmask, const void *pl0,     \
      const void *wtab, const void *bdf, void *sse, void *esum, void *conv,     \
      void *its, void *maxit, void *n_out, void *p_out, void *e_out,            \
      void *fulls, void *execs, int batch, int L, int T_steps, int stride,      \
      int offgrid_k, int num_exp, int has_mask, int normalize, int ext_pl0, int pred_order,    \
      int max_iters, int chord_budget, int approx_inv, double tol,              \
      double step_tol, double log_scale, double min_val, double settle_guard,   \
      double skip_accept_factor, double skip_tighten, double stall,             \
      double step_tol_guard, void *stream
#define TRPL_ENTRY_CALL                                                          \
  mat, n0, p0, e0, obs, msk, vmask, pl0, wtab, bdf, sse, esum, conv, its, maxit, \
      n_out, p_out, e_out, fulls, execs, batch, L, T_steps, stride, offgrid_k,   \
      num_exp,                                                                   \
      has_mask, normalize, ext_pl0, pred_order, max_iters, chord_budget,         \
      approx_inv, tol, step_tol, log_scale, min_val, settle_guard,               \
      skip_accept_factor, skip_tighten, stall, step_tol_guard, stream

// Plain C interface, loaded with ctypes by ops/horizon_kernel.py: one
// launcher per mode (stride 1, stride S > 1, off-grid) and dtype.  Each returns the
// launch's cudaError_t (0 on success); the kernel runs on the given stream
// and does not synchronise.
extern "C" int trpl_horizon_chord_stride1_f32(TRPL_ENTRY_ARGS) {
  return entry<float, STRIDE1>(TRPL_ENTRY_CALL);
}
extern "C" int trpl_horizon_chord_stride1_f64(TRPL_ENTRY_ARGS) {
  return entry<double, STRIDE1>(TRPL_ENTRY_CALL);
}
extern "C" int trpl_horizon_chord_strides_f32(TRPL_ENTRY_ARGS) {
  return entry<float, STRIDES>(TRPL_ENTRY_CALL);
}
extern "C" int trpl_horizon_chord_strides_f64(TRPL_ENTRY_ARGS) {
  return entry<double, STRIDES>(TRPL_ENTRY_CALL);
}
extern "C" int trpl_horizon_chord_offgrid_f32(TRPL_ENTRY_ARGS) {
  return entry<float, OFFGRID>(TRPL_ENTRY_CALL);
}
extern "C" int trpl_horizon_chord_offgrid_f64(TRPL_ENTRY_ARGS) {
  return entry<double, OFFGRID>(TRPL_ENTRY_CALL);
}
extern "C" const char* trpl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Block-level exact Newton for one implicit BDF step of the TRPL
// drift-diffusion-decay model, shared by the horizon kernel
// (horizon_kernel.cu) and the per-step Newton kernel (newton_kernel.cu).
//
// One thread block owns one sample and one thread one spatial cell
// (blockDim.x == L, a power of two).  Shared memory holds the Newton work
// area (NewtonLayout): the neighbour-exchange rows, the Jacobian blocks,
// the PCR elimination multipliers of every sweep and the final pair-solve
// blocks, and the reduction buffers.  Reductions over L are block
// reductions whose result is bitwise identical in every thread, so every
// Newton decision is uniform across the block.
//
// Pieces, each the counterpart of a function of the plain PyTorch version:
//   residual      models/newton.residuals_and_errors (cheap check)
//   refresh       models/newton.residuals_and_jacobian + block_pcr_reduce
//   apply         ops/block_tridiag.block_pcr_apply
//   update_e_cell models/trpl.update_e
//   newton_full   models/newton.coupled_newton_step (check-then-solve full
//                 Newton; the JAX package's ops/pallas/horizon_kernel.py
//                 _newton_solve, :127-223)
//
// Arithmetic follows the JAX package's expression order; the library is
// built with --fmad=false, so float64 results agree with the plain version
// to rounding.

#pragma once

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

// The Newton work area in shared memory, in elements of T, from offset
// ``o``: the chord cache (kc1, kc2, fin), the Jacobian blocks (sA, sB, sC),
// the published iterate (xN, xP), edge fluxes and derivatives (jn, jp,
// ed), the PCR right-hand side (r1, r2) and the reduction buffers (red).
struct NewtonLayout {
  int kc1, kc2, fin, sA, sB, sC, xN, xP, jn, jp, ed, r1, r2, red, end;
  __host__ __device__ NewtonLayout(int L, int o) {
    int ns = 0;
    for (int rf = 1; L > 2 * rf; rf *= 2) ns++;
    const int nw = L / 32;
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
    end = o;
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

template <typename T> __device__ __forceinline__ Mat<T> load_mat(const T* row) {
  return {row[0], row[1], row[2], row[3], row[4],  row[5],
          row[6], row[7], row[8], row[9], row[10], row[11]};
}

// Everything the Jacobian pass reuses from the residual pass at the same
// iterate: edge quantities of edge i, recombination partials of node i and
// the (sample-wide) surface partials.
template <typename T> struct Aux {
  T g, nbar, pbar, v, dRdN, dRdP, s0N, s0P, sLN, sLP;
};

template <typename T> struct Block {
  T* sm;
  NewtonLayout lay;
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
  const NewtonLayout& ly = bk.lay;
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
  const NewtonLayout& ly = bk.lay;
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

// E update (models/trpl.update_e) at the accepted iterate, which the last
// residual pass published in xN/xP.
template <typename T>
__device__ __forceinline__ T update_e_cell(const Block<T>& bk, const Mat<T>& mp, T a0,
                                           T N, T P, T bE) {
  const int i = bk.i;
  const T Nm = i > 0 ? bk.sm[bk.lay.xN + i - 1] : T(0);
  const T Pm = i > 0 ? bk.sm[bk.lay.xP + i - 1] : T(0);
  const T denom = mp.lam * (mp.dp * (P + Pm) + mp.dn * (N + Nm)) / T(2) + a0;
  const T num = mp.lam * (mp.dp * (P - Pm) - mp.dn * (N - Nm)) - bE;
  return (num / denom) * (T(1) - onehot<T>(i, 0));
}

// Check-then-solve exact Newton from the predicted iterate (N, P), in
// place (models/newton.coupled_newton_step; the JAX kernel's
// _newton_solve).  A sample whose residual is ``skip_tol`` (tol x
// SKIP_ACCEPT_FACTOR) below tol is frozen without an update; one that
// merely passes tol gets one final polish update.  Every iteration
// assembles the Jacobian, reduces and applies the PCR, takes the
// positivity-clamped update and re-checks the residual; ``guard`` (tol x
// STEP_TOL_RESIDUAL_GUARD) bounds state-settled acceptance.  Returns
// whether the step converged; ``its`` gets the number of updates.  The
// decisions are the sample's own: the JAX kernel takes the skip and the
// loop exit over its tile, but a sample that is done there gets no update
// and keeps its flags, so its result is the same.
template <typename T>
__device__ bool newton_full(Block<T>& bk, const Mat<T>& mp, T a0, T& N, T& P, T bN, T bP,
                            T bE, T tol, T skip_tol, T guard, T step_tol, int max_iters,
                            bool approx, int& its) {
  T FN, FP, errn, errp;
  Aux<T> ax;
  residual(bk, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
  bool done = errn < skip_tol && errp < skip_tol;
  its = 0;
  if (done) return true;
  for (int it = 0; it < max_iters && !done; it++) {
    const bool polish = errn < tol && errp < tol;
    refresh(bk, mp, a0, ax, approx);
    T dN, dP;
    apply(bk, FN, FP, dN, dP);
    N = nmax(N + dN, T(0.05) * N);
    P = nmax(P + dP, T(0.05) * P);
    its++;
    T m4[4] = {absv(dN), absv(N), absv(dP), absv(P)};
    block_reduce4(m4, bk.sm + bk.lay.red, bk.parity, true);
    const bool ok_step = m4[0] <= step_tol * m4[1] && m4[2] <= step_tol * m4[3] &&
                         errn < guard && errp < guard;
    residual(bk, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
    done = polish || ok_step || (errn < skip_tol && errp < skip_tol);
  }
  return done || (errn < tol && errp < tol);
}

}  // namespace

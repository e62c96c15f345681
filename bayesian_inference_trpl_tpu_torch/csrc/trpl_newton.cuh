// Warp-level exact Newton for one implicit BDF step of the TRPL
// drift-diffusion-decay model, shared by the horizon kernel
// (horizon_kernel.cu) and the per-step Newton kernel (newton_kernel.cu).
//
// One warp owns one sample.  Lane l holds the cells i = l + 32 j,
// j = 0..L/32-1, in registers (the per-cell arrays below have one entry per
// j).  Neighbours move by shuffle: cell i - d for d < 32 is lane l - d of
// the same register, or at the wrap lane l - d + 32 of register j - 1; for
// d a multiple of 32 it is register j - d/32 of the same lane.  So no
// barrier is needed anywhere in the Newton body: a sample's decisions are
// its warp's alone, and the warps of one block never wait for each other.
// Lane-private shared memory holds only the chord cache (the PCR
// elimination multipliers of every sweep, reused until a refresh); the
// final pair-solve blocks stay in registers.
//
// Two instantiations of every function: JC = 4 cells per lane, the
// production width L = 128, with every per-cell array in registers; and
// JC = 0, any power of two L in [32, 1024] with the number of cells per
// lane read at run time (the arrays then live in local memory).
//
// Pieces, each the counterpart of a function of the plain PyTorch version:
//   residual      models/newton.residuals_and_errors (cheap check)
//   refresh       models/newton.residuals_and_jacobian + block_pcr_reduce
//   apply         ops/block_tridiag.block_pcr_apply
//   update_e      models/trpl.update_e
//   newton_full   models/newton.coupled_newton_step (check-then-solve full
//                 Newton; the JAX package's ops/pallas/horizon_kernel.py
//                 _newton_solve, :127-223)
//
// Every cell computes the JAX package's expressions in its order, and the
// library is built with --fmad=false, so float64 results agree with the
// plain version to rounding.  A reduction over L is a butterfly over each
// 32 consecutive cells (one register j), the partials combined in the order
// j = 0, 1, ...: a fixed order, whose result every lane holds bit for bit,
// so every Newton decision is the same in all lanes of a sample.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> struct Blk { T a, b, c, d; };   // 2x2 block (m11, m12, m21, m22)
template <typename T> struct Vec { T x, y; };
// A block as the chord cache stores it: one vector access per block.
template <typename T> struct alignas(4 * sizeof(T) > 16 ? 16 : 4 * sizeof(T)) CBlk {
  T a, b, c, d;
};

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

__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(kFullMask, v, src); }
__device__ __forceinline__ double shfl(double v, int src) { return __shfl_sync(kFullMask, v, src); }
template <typename T> __device__ __forceinline__ Vec<T> shfl(Vec<T> v, int src) {
  return {shfl(v.x, src), shfl(v.y, src)};
}
template <typename T> __device__ __forceinline__ Blk<T> shfl(Blk<T> v, int src) {
  return {shfl(v.a, src), shfl(v.b, src), shfl(v.c, src), shfl(v.d, src)};
}

// c ? a : b on values.  A plain ?: between two elements of a register
// array may be compiled as a choice between their addresses, which puts
// the array in local memory; selp cannot be.
__device__ __forceinline__ float pick(bool c, float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("{ .reg .pred p; setp.ne.b32 p, %3, 0; selp.f32 %0, %1, %2, p; }"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
  return r;
#else
  return c ? a : b;
#endif
}
__device__ __forceinline__ double pick(bool c, double a, double b) {
#ifdef __CUDA_ARCH__
  double r;
  asm("{ .reg .pred p; setp.ne.b32 p, %3, 0; selp.f64 %0, %1, %2, p; }"
      : "=d"(r) : "d"(a), "d"(b), "r"((int)c));
  return r;
#else
  return c ? a : b;
#endif
}
template <typename T> __device__ __forceinline__ Vec<T> pick(bool c, Vec<T> a, Vec<T> b) {
  return {pick(c, a.x, b.x), pick(c, a.y, b.y)};
}
template <typename T> __device__ __forceinline__ Blk<T> pick(bool c, Blk<T> a, Blk<T> b) {
  return {pick(c, a.a, b.a), pick(c, a.b, b.b), pick(c, a.c, b.c), pick(c, a.d, b.d)};
}

// PCR sweeps at width L: rf = 1, 2, 4, ... while L > 2 rf.
__host__ __device__ constexpr int sweeps_of(int L) {
  return L > 2 ? 1 + sweeps_of(L / 2) : 0;
}

// One sample's warp: the lane and the cells per lane (JC, or L/32 at run
// time when JC == 0).  CAP sizes the per-cell arrays.
template <int JC> struct Lane {
  static constexpr int CAP = JC > 0 ? JC : 32;
  static constexpr int HCAP = CAP > 1 ? CAP / 2 : 1;   // final pair-solve rows
  int lane, nj;
  __device__ __forceinline__ int J() const { return JC > 0 ? JC : nj; }
  __device__ __forceinline__ int L() const { return 32 * J(); }
  __device__ __forceinline__ int NS() const { return JC > 0 ? sweeps_of(32 * JC) : sweeps_of(32 * nj); }
  __device__ __forceinline__ int cell(int j) const { return lane + 32 * j; }
};

// out[j] = x at cell (lane + 32 j) - d, or ``edge`` where that is below
// cell 0.  out may alias x.
template <int JC, typename V>
__device__ __forceinline__ void below(const Lane<JC>& ln, const V* x, V* out, int d, V edge) {
  const int J = ln.J();
  if (d < 32) {
    const int src = (ln.lane - d) & 31;
    const bool same = ln.lane >= d;
    V prev = edge;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const V u = shfl(x[j], src);
      out[j] = same ? u : prev;
      prev = u;
    }
  } else {
    const int m = d >> 5;
#pragma unroll
    for (int j = J - 1; j >= 0; j--) {
      if (JC > 0) {
        // A select over the constant offsets: no register is indexed at
        // run time.
        V v = edge;
#pragma unroll
        for (int mm = 1; mm < J; mm++)
          if (j >= mm) v = pick(m == mm, x[j - mm], v);
        out[j] = v;
      } else {
        out[j] = j >= m ? x[j - m] : edge;
      }
    }
  }
}

// out[j] = x at cell (lane + 32 j) + d, or ``edge`` past cell L - 1.  out
// may alias x.
template <int JC, typename V>
__device__ __forceinline__ void above(const Lane<JC>& ln, const V* x, V* out, int d, V edge) {
  const int J = ln.J();
  if (d < 32) {
    const int src = (ln.lane + d) & 31;
    const bool same = ln.lane + d < 32;
    V next = edge;
#pragma unroll
    for (int j = J - 1; j >= 0; j--) {
      const V u = shfl(x[j], src);
      out[j] = same ? u : next;
      next = u;
    }
  } else {
    const int m = d >> 5;
#pragma unroll
    for (int j = 0; j < J; j++) {
      if (JC > 0) {
        V v = edge;
#pragma unroll
        for (int mm = 1; mm < J; mm++)
          if (j + mm < J) v = pick(m == mm, x[j + mm], v);
        out[j] = v;
      } else {
        out[j] = j + m < J ? x[j + m] : edge;
      }
    }
  }
}

// x at cell (lane + 32 jh) + L/2, for the final pair solve of the cells
// below L/2 (jh < J/2; with J = 1 the lanes below 16).
template <int JC, typename V>
__device__ __forceinline__ V upper(const Lane<JC>& ln, const V* x, int jh) {
  return ln.J() > 1 ? x[jh + ln.J() / 2] : shfl(x[0], (ln.lane + 16) & 31);
}

// The levels of warp_reduce's transposed butterflies: C values per lane at
// partner distance O; a lane keeps the upper half of its values where bit
// O of its index is set, the lower half where it is not, and adds its
// partner's copy of the half it keeps (own value first).  With one value
// left, the remaining levels are plain butterflies.
template <int C, int O, bool IS_MAX, typename T>
__device__ __forceinline__ void transposed_levels(T* a, int lane) {
  if constexpr (C > 1) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; i++) {
      const T send = pick(up, a[i], a[i + C / 2]);
      const T keep = pick(up, a[i + C / 2], a[i]);
      const T u = __shfl_xor_sync(kFullMask, send, O);
      a[i] = IS_MAX ? nmax(keep, u) : keep + u;
    }
    transposed_levels<C / 2, O / 2, IS_MAX>(a, lane);
  } else if constexpr (O > 0) {
    const T u = __shfl_xor_sync(kFullMask, a[0], O);
    a[0] = IS_MAX ? nmax(a[0], u) : a[0] + u;
    transposed_levels<1, O / 2, IS_MAX>(a, lane);
  }
}

// Sums (or NaN-propagating maxima) over the sample of NV per-cell values.
// The result is that of a butterfly over the 32 lanes per value and
// register j (lane l adds its partner l ^ o, own value first, o = 16, 8,
// ..., 1), the 32-cell partials then combined in order j = 0, 1, ...; every
// lane gets the same bits.  With J known at compile time the NV x J
// butterflies run transposed: at each level a lane keeps half of its values
// and swaps the other half with its partner, which adds exactly the pairs
// the butterflies add (2 (NV J) - 1 shuffles where the butterflies take
// 5 NV J), then each total is broadcast from the lane that holds it.
template <int NV, bool IS_MAX, int JC, typename T>
__device__ __forceinline__ void warp_reduce(const Lane<JC>& ln, T (*v)[Lane<JC>::CAP], T* out) {
  const int J = ln.J();
  if constexpr (JC > 0 && NV * JC <= 32) {
    constexpr int M = JC > 0 ? NV * JC : 1;
    constexpr int LOGM = M >= 32 ? 5 : M >= 16 ? 4 : M >= 8 ? 3 : M >= 4 ? 2 : M >= 2 ? 1 : 0;
    T a[M];
#pragma unroll
    for (int k = 0; k < NV; k++)
#pragma unroll
      for (int j = 0; j < JC; j++) a[k * JC + j] = v[k][j];
    transposed_levels<M, 16, IS_MAX>(a, ln.lane);
    // Lane l now holds the total of value l >> (5 - LOGM).
#pragma unroll
    for (int k = 0; k < NV; k++) {
      T s = shfl(a[0], (k * JC) << (5 - LOGM));
#pragma unroll
      for (int j = 1; j < JC; j++) {
        const T t = shfl(a[0], (k * JC + j) << (5 - LOGM));
        s = IS_MAX ? nmax(s, t) : s + t;
      }
      out[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; k++) {
#pragma unroll
      for (int j = 0; j < J; j++) {
#pragma unroll
        for (int lev = 0; lev < 5; lev++) {
          const int o = 16 >> lev;
          const T u = __shfl_xor_sync(kFullMask, v[k][j], o);
          v[k][j] = IS_MAX ? nmax(v[k][j], u) : v[k][j] + u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; k++) {
      T s = v[k][0];
#pragma unroll
      for (int j = 1; j < J; j++) s = IS_MAX ? nmax(s, v[k][j]) : s + v[k][j];
      out[k] = s;
    }
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
template <typename T, int CAP> struct Aux {
  T g[CAP], nbar[CAP], pbar[CAP], v[CAP], dRdN[CAP], dRdP[CAP];
  T s0N, s0P, sLN, sLP;
};

// The final pair-solve blocks of cells i < L/2 (refresh writes, apply reads).
template <typename T, int HCAP> struct Fin {
  Blk<T> k[HCAP], inv_lhs[HCAP], inv_bhi[HCAP], ahi[HCAP];
};

// Cheap residual pass at iterate (N, P) (models/newton.residuals_and_errors):
// the node residuals in FN/FP and the reference-metric relative errors
// (the same in every lane).
template <typename T, int JC>
__device__ __forceinline__ void residual(const Lane<JC>& ln, const Mat<T>& mp, T a0,
                                         const T* N, const T* P, const T* bN, const T* bP,
                                         const T* bE, T* FN, T* FP, T& errn, T& errp,
                                         Aux<T, Lane<JC>::CAP>& ax) {
  constexpr int CAP = Lane<JC>::CAP;
  const int J = ln.J(), L = ln.L();
  // Edge i couples nodes i-1 and i; edge 0 does not exist (zeroed).
  T Nm[CAP], Pm[CAP], jn[CAP], jp[CAP], R[CAP];
  below(ln, N, Nm, 1, T(0));
  below(ln, P, Pm, 1, T(0));
  const T n0p0 = mp.n0 * mp.p0;
#pragma unroll
  for (int j = 0; j < J; j++) {
    const int i = ln.cell(j);
    const T nbar = T(0.5) * (N[j] + Nm[j]);
    const T pbar = T(0.5) * (P[j] + Pm[j]);
    const T dN = N[j] - Nm[j];
    const T dP = P[j] - Pm[j];
    const T v = a0 + mp.lam * (mp.dn * nbar + mp.dp * pbar);
    const T g = (mp.lam * (mp.dp * dP - mp.dn * dN) - bE[j]) / v;
    const T z0 = T(1) - onehot<T>(i, 0);
    jn[j] = (mp.dn * (g * nbar + dN)) * z0;
    jp[j] = (mp.dp * (g * pbar - dP)) * z0;
    // Bulk recombination and its partials.
    const T np_ = N[j] * P[j] - n0p0;
    const T tp = N[j] * mp.tau_p + P[j] * mp.tau_n;
    const T tp2 = tp * tp;
    R[j] = (mp.cn * N[j] + mp.cp * P[j] + mp.rate + T(1) / tp) * np_;
    ax.dRdN[j] = mp.rate * P[j] + (P[j] * tp - mp.tau_p * np_) / tp2 +
                 (mp.cn * N[j] * P[j] + mp.cp * (P[j] * P[j]) + mp.cn * np_);
    ax.dRdP[j] = mp.rate * N[j] + (N[j] * tp - mp.tau_n * np_) / tp2 +
                 (mp.cp * N[j] * P[j] + mp.cn * (N[j] * N[j]) + mp.cp * np_);
    ax.g[j] = g;
    ax.nbar[j] = nbar;
    ax.pbar[j] = pbar;
    ax.v[j] = v;
  }
  // Surface recombination at nodes 0 and L-1 (sample-wide scalars).
  const T N0 = shfl(N[0], 0), P0 = shfl(P[0], 0);
  const T NL = shfl(N[J - 1], 31), PL = shfl(P[J - 1], 31);
  const T d0 = N0 + P0, dL = NL + PL;
  const T s0 = mp.sr0 * (N0 * P0 - n0p0) / d0;
  const T sL = mp.srL * (NL * PL - n0p0) / dL;
  ax.s0N = mp.sr0 * (P0 * P0 + n0p0) / (d0 * d0);
  ax.s0P = mp.sr0 * (N0 * N0 + n0p0) / (d0 * d0);
  ax.sLN = mp.srL * (PL * PL + n0p0) / (dL * dL);
  ax.sLP = mp.srL * (NL * NL + n0p0) / (dL * dL);
  T jnr[CAP], jpr[CAP];
  above(ln, jn, jnr, 1, T(0));
  above(ln, jp, jpr, 1, T(0));
  T v4[4][CAP];
#pragma unroll
  for (int j = 0; j < J; j++) {
    const int i = ln.cell(j);
    const T h0 = onehot<T>(i, 0), hL = onehot<T>(i, L - 1);
    const T jn_r = jnr[j] + (-sL) * hL;
    const T jn_l = jn[j] + s0 * h0;
    const T jp_r = jpr[j] + sL * hL;
    const T jp_l = jp[j] + (-s0) * h0;
    FN[j] = a0 * N[j] + bN[j] - (jn_r - jn_l) + R[j];
    FP[j] = a0 * P[j] + bP[j] + (jp_r - jp_l) + R[j];
    T bbN = -R[j] + ax.dRdN[j] * N[j] - bN[j];
    bbN = bbN + (-(s0 - ax.s0N * N0)) * h0;
    bbN = bbN + (-(sL - ax.sLN * NL)) * hL;
    T bbP = -R[j] + ax.dRdP[j] * P[j] - bP[j];
    bbP = bbP + (-(s0 - ax.s0P * P0)) * h0;
    bbP = bbP + (-(sL - ax.sLP * PL)) * hL;
    v4[0][j] = absv(FN[j]);
    v4[1][j] = absv(FP[j]);
    v4[2][j] = absv(bbN);
    v4[3][j] = absv(bbP);
  }
  T r4[4];
  warp_reduce<4, false>(ln, v4, r4);
  errn = r4[0] / r4[2];
  errp = r4[1] / r4[3];
}

// Full refresh: the exact Jacobian at the iterate of the last residual
// pass (models/newton.residuals_and_jacobian), then the PCR reduce
// (ops/block_tridiag.block_pcr_reduce): each sweep's multipliers k1/k2 go
// to the lane's chord cache ``kc`` (shared memory, [sweep][k1|k2][j][lane]),
// the final pair-solve blocks to ``fin``.
template <typename T, int JC>
__device__ __forceinline__ void refresh(const Lane<JC>& ln, const Mat<T>& mp, T a0,
                                        const Aux<T, Lane<JC>::CAP>& ax, bool approx,
                                        CBlk<T>* kc, Fin<T, Lane<JC>::HCAP>& fin) {
  constexpr int CAP = Lane<JC>::CAP;
  const int J = ln.J(), L = ln.L();
  // Edge derivatives: index 0-3 (jnNm, jnPm, jpPm, jpNm) and 4-7 (jnNp,
  // jnPp, jpPp, jpNp) of edge i; node i also needs those of edge i+1.
  T ed[8][CAP];
#pragma unroll
  for (int j = 0; j < J; j++) {
    const T g = ax.g[j], nbar = ax.nbar[j], pbar = ax.pbar[j];
    const T inv_v = T(1) / ax.v[j];
    const T gNm = mp.lam * mp.dn * (T(1) - T(0.5) * g) * inv_v;
    const T gNp = -mp.lam * mp.dn * (T(1) + T(0.5) * g) * inv_v;
    const T gPm = -mp.lam * mp.dp * (T(1) + T(0.5) * g) * inv_v;
    const T gPp = mp.lam * mp.dp * (T(1) - T(0.5) * g) * inv_v;
    const T z0 = T(1) - onehot<T>(ln.cell(j), 0);
    ed[0][j] = (mp.dn * (gNm * nbar + T(0.5) * g - T(1))) * z0;   // jnNm
    ed[4][j] = (mp.dn * (gNp * nbar + T(0.5) * g + T(1))) * z0;   // jnNp
    ed[1][j] = (mp.dn * gPm * nbar) * z0;                         // jnPm
    ed[5][j] = (mp.dn * gPp * nbar) * z0;                         // jnPp
    ed[2][j] = (mp.dp * (gPm * pbar + T(0.5) * g + T(1))) * z0;   // jpPm
    ed[6][j] = (mp.dp * (gPp * pbar + T(0.5) * g - T(1))) * z0;   // jpPp
    ed[3][j] = (mp.dp * gNm * pbar) * z0;                         // jpNm
    ed[7][j] = (mp.dp * gNp * pbar) * z0;                         // jpNp
  }
  T sh[8][CAP];
#pragma unroll
  for (int k = 0; k < 8; k++) above(ln, ed[k], sh[k], 1, T(0));
  Blk<T> A[CAP], B[CAP], C[CAP];
#pragma unroll
  for (int j = 0; j < J; j++) {
    const int i = ln.cell(j);
    const T h0 = onehot<T>(i, 0), hL = onehot<T>(i, L - 1);
    const T sNt = ax.s0N * h0 + ax.sLN * hL;
    const T sPt = ax.s0P * h0 + ax.sLP * hL;
    B[j] = {a0 - sh[0][j] + ed[4][j] + ax.dRdN[j] + sNt,      // B_NN
            -sh[1][j] + ed[5][j] + ax.dRdP[j] + sPt,           // B_NP
            sh[3][j] - ed[7][j] + ax.dRdN[j] + sNt,            // B_PN
            a0 + sh[2][j] - ed[6][j] + ax.dRdP[j] + sPt};      // B_PP
    C[j] = {-sh[4][j], -sh[5][j], sh[7][j], sh[6][j]};        // (C_NN, C_NP, C_PN, C_PP)
    A[j] = {ed[0][j], ed[1][j], -ed[3][j], -ed[2][j]};        // (A_NN, A_NP, A_PN, A_PP)
  }
  const Blk<T> I = {T(1), T(0), T(0), T(1)}, Z = {T(0), T(0), T(0), T(0)};
  // binv of a neighbour's block is the same function of the same bits
  // whichever lane computes it, so each cell inverts its own B once and
  // the inverse moves; past the ends the neighbour block is I.
  const Blk<T> inv_I = binv(I, approx);
  const int NS = ln.NS();
  // One copy of the sweep, its distance rf a run-time value, keeps the
  // code (and the build) small.
#pragma unroll 1
  for (int s = 0; s < NS; s++) {
    const int rf = 1 << s;
    Blk<T> iB[CAP], t[CAP], k1[CAP], k2[CAP];
#pragma unroll
    for (int j = 0; j < J; j++) iB[j] = binv(B[j], approx);
    below(ln, iB, t, rf, inv_I);
#pragma unroll
    for (int j = 0; j < J; j++) k1[j] = bmul(A[j], t[j]);
    above(ln, iB, t, rf, inv_I);
#pragma unroll
    for (int j = 0; j < J; j++) k2[j] = bmul(C[j], t[j]);
    below(ln, C, t, rf, Z);                                     // C at i - rf
#pragma unroll
    for (int j = 0; j < J; j++) B[j] = bsub(B[j], bmul(k1[j], t[j]));
    above(ln, A, t, rf, Z);                                     // A at i + rf
#pragma unroll
    for (int j = 0; j < J; j++) B[j] = bsub(B[j], bmul(k2[j], t[j]));
    below(ln, A, t, rf, Z);                                     // A at i - rf
#pragma unroll
    for (int j = 0; j < J; j++) A[j] = bneg(bmul(k1[j], t[j]));
    above(ln, C, t, rf, Z);                                     // C at i + rf
#pragma unroll
    for (int j = 0; j < J; j++) C[j] = bneg(bmul(k2[j], t[j]));
    CBlk<T>* row = kc + (size_t)s * 2 * L + ln.lane;
#pragma unroll
    for (int j = 0; j < J; j++) {
      row[32 * j] = {k1[j].a, k1[j].b, k1[j].c, k1[j].d};
      row[L + 32 * j] = {k2[j].a, k2[j].b, k2[j].c, k2[j].d};
    }
  }
  const int JH = J > 1 ? J / 2 : 1;
#pragma unroll
  for (int jh = 0; jh < JH; jh++) {
    const Blk<T> Bhi = upper(ln, B, jh);
    const Blk<T> Ahi = upper(ln, A, jh);
    const Blk<T> inv_Bhi = binv(Bhi, approx);
    const Blk<T> k = bmul(C[jh], inv_Bhi);
    fin.k[jh] = k;
    fin.inv_lhs[jh] = binv(bsub(B[jh], bmul(k, Ahi)), approx);
    fin.inv_bhi[jh] = inv_Bhi;
    fin.ahi[jh] = Ahi;
  }
}

// Solve J d = -F with the cached factorization
// (ops/block_tridiag.block_pcr_apply).  No divides.
template <typename T, int JC>
__device__ __forceinline__ void apply(const Lane<JC>& ln, const CBlk<T>* kc,
                                      const Fin<T, Lane<JC>::HCAP>& fin, const T* FN,
                                      const T* FP, T* dN, T* dP) {
  constexpr int CAP = Lane<JC>::CAP;
  const int J = ln.J(), L = ln.L();
  const Vec<T> zero = {T(0), T(0)};
  Vec<T> r[CAP];
#pragma unroll
  for (int j = 0; j < J; j++) r[j] = {-FN[j], -FP[j]};
  const int NS = ln.NS();
#pragma unroll 1
  for (int s = 0; s < NS; s++) {
    const int rf = 1 << s;
    Vec<T> rm[CAP], rp[CAP];
    below(ln, r, rm, rf, zero);
    above(ln, r, rp, rf, zero);
    const CBlk<T>* row = kc + (size_t)s * 2 * L + ln.lane;
#pragma unroll
    for (int j = 0; j < J; j++) {
      const CBlk<T> c1 = row[32 * j], c2 = row[L + 32 * j];
      const Vec<T> t1 = bmulvec(Blk<T>{c1.a, c1.b, c1.c, c1.d}, rm[j]);
      const Vec<T> t2 = bmulvec(Blk<T>{c2.a, c2.b, c2.c, c2.d}, rp[j]);
      r[j] = {r[j].x - t1.x - t2.x, r[j].y - t1.y - t2.y};
    }
  }
  const int JH = J > 1 ? J / 2 : 1;
  Vec<T> d[CAP];
#pragma unroll
  for (int jh = 0; jh < JH; jh++) {
    const Vec<T> rhi = upper(ln, r, jh);
    const Vec<T> kv = bmulvec(fin.k[jh], rhi);
    const Vec<T> rhs = {r[jh].x - kv.x, r[jh].y - kv.y};
    const Vec<T> xlo = bmulvec(fin.inv_lhs[jh], rhs);
    const Vec<T> av = bmulvec(fin.ahi[jh], xlo);
    const Vec<T> rhs_hi = {rhi.x - av.x, rhi.y - av.y};
    const Vec<T> xhi = bmulvec(fin.inv_bhi[jh], rhs_hi);
    if (J > 1) {
      d[jh] = xlo;
      d[jh + J / 2] = xhi;
    } else {
      // L = 32: lanes 0-15 solved their pairs; lane l >= 16 takes the
      // upper half from lane l - 16.
      const Vec<T> up = shfl(xhi, (ln.lane - 16) & 31);
      d[0] = ln.lane < 16 ? xlo : up;
    }
  }
#pragma unroll
  for (int j = 0; j < J; j++) {
    dN[j] = d[j].x;
    dP[j] = d[j].y;
  }
}

// E update (models/trpl.update_e) at the accepted iterate (N, P).
template <typename T, int JC>
__device__ __forceinline__ void update_e(const Lane<JC>& ln, const Mat<T>& mp, T a0,
                                         const T* N, const T* P, const T* bE, T* E) {
  constexpr int CAP = Lane<JC>::CAP;
  T Nm[CAP], Pm[CAP];
  below(ln, N, Nm, 1, T(0));
  below(ln, P, Pm, 1, T(0));
#pragma unroll
  for (int j = 0; j < ln.J(); j++) {
    const T denom = mp.lam * (mp.dp * (P[j] + Pm[j]) + mp.dn * (N[j] + Nm[j])) / T(2) + a0;
    const T num = mp.lam * (mp.dp * (P[j] - Pm[j]) - mp.dn * (N[j] - Nm[j])) - bE[j];
    E[j] = (num / denom) * (T(1) - onehot<T>(ln.cell(j), 0));
  }
}

// The step-size test's maxima: |dN|, |N|, |dP|, |P| over the sample.
template <typename T, int JC>
__device__ __forceinline__ void step_maxima(const Lane<JC>& ln, const T* dN, const T* N,
                                            const T* dP, const T* P, T* m4) {
  T v[4][Lane<JC>::CAP];
#pragma unroll
  for (int j = 0; j < ln.J(); j++) {
    v[0][j] = absv(dN[j]);
    v[1][j] = absv(N[j]);
    v[2][j] = absv(dP[j]);
    v[3][j] = absv(P[j]);
  }
  warp_reduce<4, true>(ln, v, m4);
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
template <typename T, int JC>
__device__ __forceinline__ bool newton_full(const Lane<JC>& ln, const Mat<T>& mp, T a0, T* N,
                                            T* P, const T* bN, const T* bP, const T* bE,
                                            T tol, T skip_tol, T guard, T step_tol,
                                            int max_iters, bool approx, CBlk<T>* kc,
                                            int& its) {
  constexpr int CAP = Lane<JC>::CAP;
  T FN[CAP], FP[CAP], errn, errp;
  Aux<T, CAP> ax;
  Fin<T, Lane<JC>::HCAP> fin;
  residual(ln, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
  bool done = errn < skip_tol && errp < skip_tol;
  its = 0;
  if (done) return true;
  for (int it = 0; it < max_iters && !done; it++) {
    const bool polish = errn < tol && errp < tol;
    refresh(ln, mp, a0, ax, approx, kc, fin);
    T dN[CAP], dP[CAP];
    apply(ln, kc, fin, FN, FP, dN, dP);
#pragma unroll
    for (int j = 0; j < ln.J(); j++) {
      N[j] = nmax(N[j] + dN[j], T(0.05) * N[j]);
      P[j] = nmax(P[j] + dP[j], T(0.05) * P[j]);
    }
    its++;
    T m4[4];
    step_maxima(ln, dN, N, dP, P, m4);
    const bool ok_step = m4[0] <= step_tol * m4[1] && m4[2] <= step_tol * m4[3] &&
                         errn < guard && errp < guard;
    residual(ln, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
    done = polish || ok_step || (errn < skip_tol && errp < skip_tol);
  }
  return done || (errn < tol && errp < tol);
}

// Bytes of one sample's chord cache in shared memory.
template <typename T> __host__ __device__ constexpr size_t cache_bytes(int L) {
  return (size_t)sweeps_of(L) * 2 * L * sizeof(CBlk<T>);
}

// Samples per block: up to 4 warps, as many as the opt-in shared memory
// of one block holds (at least 1; a launch that does not fit fails).
inline int samples_per_block(size_t sample_bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t fit = sample_bytes ? (size_t)optin / sample_bytes : 4;
  return fit >= 4 ? 4 : fit >= 1 ? (int)fit : 1;
}

// Launch layout of one kernel, for the C interface's layout queries:
// out[0] samples per block, [1] threads per block, [2] dynamic shared
// memory per block (bytes), [3] resident blocks per SM, [4] registers per
// thread, [5] local memory per thread (bytes), [6] multiprocessors.
template <typename K>
int query_layout(K kernel, int spb, size_t block_bytes, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)block_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * spb, block_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = spb;
  out[1] = 32 * spb;
  out[2] = (int)block_bytes;
  out[3] = blocks;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  out[6] = sms;
  return 0;
}

}  // namespace

// The fused-horizon kernel for Hopper (sm_90a): one fixed-dt BDF phase of
// the TRPL drift-diffusion-decay model, with chord or full Newton and the
// fused log-likelihood, in a single launch.
//
// Replaces: horizon_kernel._kernel of the JAX package
// (bayesian_inference_trpl_tpu/ops/pallas/horizon_kernel.py:447-746,
// launched by _call at :761-902), in its three modes: stride 1
// (solve_horizon_fused, the fine phase), stride S (solve_coarse_phase_fused,
// one rung of the ladder, with cubic log-space dense output at the S fine
// observation points of each coarse step) and off-grid, offgrid_k = K
// (solve_phase_offgrid_fused, :1195-1310: K observation slots per step
// scored from per-slot Lagrange weights over the same log-PL window, and a
// liveness row that forgives a Newton failure only after the last
// observation).  The three modes share the step loop; only the likelihood
// at the end of each step differs.  Each mode has two Newton bodies (the
// template parameter NEWTON): CHORD, _newton_solve_chord (:226-444; method
// fused_horizon_chord), and FULL, _newton_solve (:127-223; method
// fused_horizon), the shared check-then-solve exact Newton of
// trpl_newton.cuh, with a Jacobian and a PCR reduce on every iteration.
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
// Newton decisions (skip, loop exit, refresh) are uniform across the block.
// Those decisions are therefore per sample; the JAX kernel takes them over
// its whole sample tile (see ops/horizon_kernel.py, ``group``).  For FULL
// that changes no result (see newton_full).
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

#include "trpl_newton.cuh"

namespace {

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

// Shared-memory layout, in elements of T: the rolling histories, the
// Newton work area, the BDF table and ``slots`` likelihood accumulators per
// experiment: 1 (stride 1), S (stride S) or K (off-grid).
struct Layout {
  int nh, ph, eh;
  NewtonLayout nw;
  int bdf, acc, total;
  __host__ __device__ Layout(int L, int num_exp, int slots)
      : nh(0), ph(6 * L), eh(12 * L), nw(L, 18 * L) {
    bdf = nw.end;
    acc = bdf + 32;
    total = acc + 2 * num_exp * slots;
  }
};

// The likelihood at the end of each step: at observation point t+1
// (STRIDE1), at the S fine points of coarse step t by dense output
// (STRIDES), or at the K observation slots of step t (OFFGRID).
enum Mode { STRIDE1, STRIDES, OFFGRID };
// The Newton body of each step.
enum Newton { CHORD, FULL };

template <int MODE> __host__ __device__ __forceinline__ int slots_of(int stride, int k) {
  return MODE == OFFGRID ? k : MODE == STRIDES ? stride : 1;
}

template <typename T, int MODE, int NEWTON>
__global__ void __launch_bounds__(1024) horizon_kernel(const Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int S = slots_of<MODE>(a.stride, a.offgrid_k);   // accumulators per experiment
  const Layout ly(a.L, a.num_exp, S);
  Block<T> bk{reinterpret_cast<T*>(smem_raw), ly.nw, (int)threadIdx.x, a.L, 0};
  T* sm = bk.sm;
  const int b = blockIdx.x, i = bk.i, L = bk.L;
  const int NE = a.num_exp, TS = a.T_steps;
  const bool approx = a.approx_inv != 0;

  const Mat<T> mp = load_mat(a.mat + (size_t)b * 12);
  const T tol = T(a.tol), step_tol = T(a.step_tol), log_scale = T(a.log_scale);
  const T minv = T(a.min_val) > tiny_of<T>() ? T(a.min_val) : tiny_of<T>();
  const T skip_full = tol * T(a.skip_accept_factor);
  const T skip_tol = skip_full * T(a.skip_tighten);
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
  block_reduce4(v4, sm + ly.nw.red, bk.parity, false);
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
    // BDF history sums.  Newton's accepted iterates are only tol-accurate,
    // so two summation orders let trajectories drift apart far beyond
    // rounding (~1e-7 relative in float64 over 256 steps at tol 1e-4) and
    // flip Newton decisions; each body therefore keeps the order of the
    // function it is held to.  CHORD: newest first, as the JAX kernel.
    // FULL: every slot from slot 0, from zero, as the step loops'
    // models/solver.bdf_step (age-5 slot weight 0).
    T bN, bP, bE;
    if (NEWTON == FULL) {
      bN = bP = bE = T(0);
#pragma unroll
      for (int s = 0; s < 6; s++) {
        const int m = ((t - s) % 6 + 6) % 6;
        const T w = m < 5 ? bdf[row * 6 + m + 1] : T(0);
        bN = bN + w * nh[s * L + i];
        bP = bP + w * ph[s * L + i];
        bE = bE + w * eh[s * L + i];
      }
    } else {
      bN = bdf[row * 6 + 1] * nh[sl[0] * L + i];
      bP = bdf[row * 6 + 1] * ph[sl[0] * L + i];
      bE = bdf[row * 6 + 1] * eh[sl[0] * L + i];
#pragma unroll
      for (int m = 1; m < 5; m++) {
        const T w = bdf[row * 6 + m + 1];
        bN = bN + w * nh[sl[m] * L + i];
        bP = bP + w * ph[sl[m] * L + i];
        bE = bE + w * eh[sl[m] * L + i];
      }
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

    int step_its = 0;
    bool done;
    if (NEWTON == FULL) {
      // ---- Full Newton (horizon_kernel._newton_solve): every iteration
      // is a refresh, so the chord telemetry counts it in both.
      done = newton_full(bk, mp, a0, N, P, bN, bP, bE, tol, skip_full, guard_full,
                         step_tol, a.max_iters, approx, step_its);
      execs += step_its;
      fulls += step_its;
    } else {
      // ---- Chord Newton (horizon_kernel._newton_solve_chord).
      T FN, FP, errn, errp;
      Aux<T> ax;
      residual(bk, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
      done = errn < skip_tol && errp < skip_tol;
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
          block_reduce4(m4, sm + ly.nw.red, bk.parity, true);
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
    }
    // ---- E update (trpl.update_e); xN/xP hold the accepted iterate.
    E = update_e_cell(bk, mp, a0, N, P, bE);
    const int sn = (t + 1) % 6;
    nh[sn * L + i] = N;
    ph[sn * L + i] = P;
    eh[sn * L + i] = E;
    its += step_its;
    maxit = step_its > maxit ? step_its : maxit;

    // ---- Fused likelihood (see Mode).
    T p4[4] = {N * P, T(0), T(0), T(0)};
    block_reduce4(p4, sm + ly.nw.red, bk.parity, false);
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

template <typename T, int MODE, int NEWTON>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int mode = a.offgrid_k > 0 ? OFFGRID : a.stride > 1 ? STRIDES : STRIDE1;
  if (mode != MODE || (MODE == OFFGRID && a.stride != 1)) return (int)cudaErrorInvalidValue;
  if (a.batch == 0 || a.T_steps == 0) return 0;
  const Layout ly(a.L, a.num_exp, slots_of<MODE>(a.stride, a.offgrid_k));
  const size_t bytes = (size_t)ly.total * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      horizon_kernel<T, MODE, NEWTON>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  horizon_kernel<T, MODE, NEWTON><<<a.batch, a.L, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int NEWTON>
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
  return launch<T, MODE, NEWTON>(a, (cudaStream_t)stream);
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
// launcher per Newton body (chord, full), mode (stride 1, stride S > 1,
// off-grid) and dtype.  Each returns the launch's cudaError_t (0 on
// success); the kernel runs on the given stream and does not synchronise.
#define TRPL_HORIZON_ENTRY(newton, NEWTON, mode, MODE, dt, T)                    \
  extern "C" int trpl_horizon_##newton##_##mode##_##dt(TRPL_ENTRY_ARGS) {       \
    return entry<T, MODE, NEWTON>(TRPL_ENTRY_CALL);                              \
  }
#define TRPL_HORIZON_ENTRIES(newton, NEWTON)                                     \
  TRPL_HORIZON_ENTRY(newton, NEWTON, stride1, STRIDE1, f32, float)               \
  TRPL_HORIZON_ENTRY(newton, NEWTON, stride1, STRIDE1, f64, double)              \
  TRPL_HORIZON_ENTRY(newton, NEWTON, strides, STRIDES, f32, float)               \
  TRPL_HORIZON_ENTRY(newton, NEWTON, strides, STRIDES, f64, double)              \
  TRPL_HORIZON_ENTRY(newton, NEWTON, offgrid, OFFGRID, f32, float)               \
  TRPL_HORIZON_ENTRY(newton, NEWTON, offgrid, OFFGRID, f64, double)

TRPL_HORIZON_ENTRIES(chord, CHORD)
TRPL_HORIZON_ENTRIES(full, FULL)

extern "C" const char* trpl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

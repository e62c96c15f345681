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
// Given an output for it, FULL at stride 1 also records the PL trace: the
// JAX package's solve(record_pl=True), which runs both fused methods as the
// coupled_newton XLA scan (models/solver.py:304-317, :367-432), the solve
// of the interpolation fallback.  The same launch may also record the state
// N/P/E every state_every steps and, per recorded PL point, the largest
// Newton iteration count of its pl_stride steps (the scan's
// record_state_stride and record_iters outputs, :411-416, of the forward
// model's standalone mode, models/driver.pvsim).
//
// Design: one warp per sample, lane l holding cells l + 32 j (see
// trpl_newton.cuh), up to 4 samples per block; the whole phase runs in one
// launch, a loop over time inside the warp taking the place of the TPU
// grid's sequential time axis.  Per sample, registers hold the state, the
// rolling N/P histories (shifted by one slot per step, newest first) and
// the final pair-solve blocks; lane-private shared memory holds the chord
// cache, the E history and the likelihood accumulators.  Nothing in the
// step loop waits on another warp: neighbours and reductions move by
// shuffle, so the Newton decisions (skip, loop exit, refresh) are per
// sample.  The JAX kernel takes them over its sample tile (see
// ops/horizon_kernel.py, ``group``); for FULL that changes no result (see
// newton_full).
//
// What bounds it on this card: FP32 (FP64) issue and the latency of
// dependent shuffles and divides, not memory.  Device-memory traffic is a
// few bytes per sample-step (one observation value per experiment, or 6 K
// values per experiment off-grid, which stay in L2).  At L = 128 in
// float32 the 4-cells-per-lane instantiation keeps every array in
// registers (launch bounds of 2 blocks of 4 warps per SM, so up to 255
// registers a lane; ~225 used, no spills) and a sample takes ~27 KB of
// shared memory: 8 samples per SM, so the 1,024-sample chunk is resident
// in one wave on 132 SMs, 2 warps per scheduler.  The PCR sweep is one
// loop body for every distance (unrolled, it needs more than 255
// registers and runs at half the speed).  Other widths run the same code
// with the cells per lane read at run time (arrays in local memory).
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
  T* pl_out;   // the PL trace (batch, T_steps / pl_stride + 1), or null
  T* st_out;   // the state trace (T_steps / state_every, 3, batch, L), or null
  int* it_out; // the iteration trace (batch, T_steps / pl_stride), or null
  int batch, L, T_steps, stride, offgrid_k, num_exp;
  int has_mask, normalize, ext_pl0, pred_order, max_iters, chord_budget, approx_inv;
  int pl_stride, state_every;
  double tol, step_tol, log_scale, min_val, settle_guard, skip_accept_factor,
      skip_tighten, stall, step_tol_guard;
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

// One sample's shared memory, in bytes from its base: the chord cache,
// the rolling 6-slot E history ([slot][j][lane]) and ``slots`` likelihood
// accumulators per experiment (sse, then esum).
template <typename T> struct SampleLayout {
  size_t eh, acc, bytes;
  __host__ __device__ SampleLayout(int L, int num_exp, int slots) {
    size_t o = cache_bytes<T>(L);
    eh = o;
    o += (size_t)6 * L * sizeof(T);
    acc = o;
    o += (size_t)2 * num_exp * slots * sizeof(T);
    bytes = (o + 15) / 16 * 16;
  }
};

// FULL body's history sums: every slot in ring order from ring slot 0, as
// models/solver.bdf_step sums them (age-5 slot weight 0).  With t % 6 = R
// ring slot s holds age (R - s) mod 6, which is history register (age)
// (R - s) mod 6; eh is the ring itself.
template <int R, int JC, typename T>
__device__ __forceinline__ void full_sums(const Lane<JC>& ln, const T* bd,
                                          T (*nh)[Lane<JC>::CAP], T (*ph)[Lane<JC>::CAP],
                                          const T* eh, T* bN, T* bP, T* bE) {
  const int J = ln.J();
#pragma unroll
  for (int j = 0; j < J; j++) bN[j] = bP[j] = bE[j] = T(0);
#pragma unroll
  for (int s = 0; s < 6; s++) {
    const int m = (R - s + 6) % 6;
    const T w = m < 5 ? bd[m + 1] : T(0);
#pragma unroll
    for (int j = 0; j < J; j++) {
      bN[j] = bN[j] + w * nh[m][j];
      bP[j] = bP[j] + w * ph[m][j];
      bE[j] = bE[j] + w * eh[(s * J + j) * 32 + ln.lane];
    }
  }
}

template <typename T, int JC, int MODE, int NEWTON>
__global__ void __launch_bounds__(128, JC > 0 ? 2 : 1)
    horizon_kernel(const Args<T> a, const int spb, const size_t sample_bytes) {
  constexpr int CAP = Lane<JC>::CAP;
  constexpr int HS = NEWTON == FULL ? 6 : 5;   // N/P history registers, by age
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * spb + w;
  if (b >= a.batch) return;   // the batch's tail: the warp has no sample
  const Lane<JC> ln{(int)(threadIdx.x & 31), a.L >> 5};
  const int J = ln.J(), L = a.L, lane = ln.lane;
  const int S = slots_of<MODE>(a.stride, a.offgrid_k);   // accumulators per experiment
  const int NE = a.num_exp, TS = a.T_steps;
  const bool approx = a.approx_inv != 0;
  const SampleLayout<T> sl(L, NE, S);
  unsigned char* base = smem_raw + (size_t)w * sample_bytes;
  CBlk<T>* kc = reinterpret_cast<CBlk<T>*>(base);
  T* eh = reinterpret_cast<T*>(base + sl.eh);
  T* acc_sse = reinterpret_cast<T*>(base + sl.acc);
  T* acc_esum = acc_sse + NE * S;

  const Mat<T> mp = load_mat(a.mat + (size_t)b * 12);
  const T tol = T(a.tol), step_tol = T(a.step_tol), log_scale = T(a.log_scale);
  const T minv = T(a.min_val) > tiny_of<T>() ? T(a.min_val) : tiny_of<T>();
  const T skip_full = tol * T(a.skip_accept_factor);
  const T skip_tol = skip_full * T(a.skip_tighten);
  const T guard_full = tol * T(a.step_tol_guard);
  const T guard_chord = tol * T(a.settle_guard);
  const T stall = T(a.stall);

  T nh[HS][CAP], ph[HS][CAP];
  T N[CAP], P[CAP], E[CAP];
  T v1[1][CAP];
#pragma unroll
  for (int j = 0; j < J; j++) {
    const size_t row0 = (size_t)b * L + ln.cell(j);
    N[j] = a.n0[row0];
    P[j] = a.p0[row0];
    E[j] = a.e0[row0];
#pragma unroll
    for (int s = 0; s < HS; s++) {
      nh[s][j] = s == 0 ? N[j] : T(0);
      ph[s][j] = s == 0 ? P[j] : T(0);
    }
    for (int s = 0; s < 6; s++) eh[(s * J + j) * 32 + lane] = s == 0 ? E[j] : T(0);
    v1[0][j] = N[j] * P[j];
  }
  for (int k = lane; k < 2 * NE * S; k += 32) acc_sse[k] = T(0);
  __syncwarp();

  // PL at the phase start (normalization anchor unless given, and the
  // dense-output window's newest node; on the phase's rescaled rate).
  const T n0p0 = mp.n0 * mp.p0;
  T r1[1];
  warp_reduce<1, false>(ln, v1, r1);
  const T pl00 = mp.rate * (r1[0] - T(L) * n0p0);
  const T pl0s = a.ext_pl0 ? a.pl0[b] : pl00;
  // The PL trace (FULL at stride 1 only, the JAX package's
  // solve(record_pl=True)): the nondimensional PL at t = 0 and after every
  // pl_stride-th step, stored by lane 0.
  constexpr bool kRecord = MODE == STRIDE1 && NEWTON == FULL;
  T* const pl_row = kRecord && a.pl_out != nullptr
                        ? a.pl_out + (size_t)b * (TS / a.pl_stride + 1) : nullptr;
  if (kRecord && pl_row != nullptr && lane == 0) pl_row[0] = pl00;
  auto logpl = [&](T x) {
    if (a.normalize) return log10_of(nmax(x / pl0s, minv));
    return log10_of(nmax(x, minv)) + log_scale;
  };
  T lpw0 = T(0), lpw1 = T(0), lpw2 = T(0), lpw3 = MODE != STRIDE1 ? logpl(pl00) : T(0);

  bool conv = true, cval = false;
  int its = 0, maxit = 0, fulls = 0, execs = 0;
  int rec_it = 0;   // the iteration trace's running max over a PL stride
  Fin<T, Lane<JC>::HCAP> fin;

  for (int t = 0; t < TS; t++) {
    const int row = t < 4 ? t : 4;
    const T* bd = a.bdf + row * 6;
    const T a0 = bd[0];

    // BDF history sums.  Newton's accepted iterates are only tol-accurate,
    // so two summation orders let trajectories drift apart far beyond
    // rounding (~1e-7 relative in float64 over 256 steps at tol 1e-4) and
    // flip Newton decisions; each body therefore keeps the order of the
    // function it is held to.  CHORD: newest first, as the JAX kernel.
    // FULL: ring order (full_sums).
    T bN[CAP], bP[CAP], bE[CAP];
    if (NEWTON == FULL) {
      switch (t % 6) {
        case 0: full_sums<0>(ln, bd, nh, ph, eh, bN, bP, bE); break;
        case 1: full_sums<1>(ln, bd, nh, ph, eh, bN, bP, bE); break;
        case 2: full_sums<2>(ln, bd, nh, ph, eh, bN, bP, bE); break;
        case 3: full_sums<3>(ln, bd, nh, ph, eh, bN, bP, bE); break;
        case 4: full_sums<4>(ln, bd, nh, ph, eh, bN, bP, bE); break;
        default: full_sums<5>(ln, bd, nh, ph, eh, bN, bP, bE); break;
      }
    } else {
      const T w1 = bd[1];
      const T* e_new = eh + (size_t)(t % 6) * J * 32 + lane;
#pragma unroll
      for (int j = 0; j < J; j++) {
        bN[j] = w1 * nh[0][j];
        bP[j] = w1 * ph[0][j];
        bE[j] = w1 * e_new[32 * j];
      }
#pragma unroll
      for (int m = 1; m < 5; m++) {
        const T wm = bd[m + 1];
        const T* e_m = eh + (size_t)((t - m + 6) % 6) * J * 32 + lane;
#pragma unroll
        for (int j = 0; j < J; j++) {
          bN[j] = bN[j] + wm * nh[m][j];
          bP[j] = bP[j] + wm * ph[m][j];
          bE[j] = bE[j] + wm * e_m[32 * j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; j++) {
      N[j] = nh[0][j];
      P[j] = ph[0][j];
    }
    if (a.pred_order) {
      // Extrapolated initial iterate with a positivity fallback
      // (models/solver.bdf_step; horizon_kernel.py:568-592).
      const T ramp = t > 0 ? T(1) : T(0);
      const T ramp2 = t > 1 ? T(1) : T(0);
#pragma unroll
      for (int j = 0; j < J; j++) {
        const T Nm = nh[1][j], Pm = ph[1][j];
        const T d1n = N[j] - Nm, d1p = P[j] - Pm;
        T Nx = N[j] + ramp * d1n;
        T Px = P[j] + ramp * d1p;
        if (a.pred_order == 2) {
          Nx = Nx + ramp2 * (d1n - (Nm - nh[2][j]));
          Px = Px + ramp2 * (d1p - (Pm - ph[2][j]));
        }
        if (a.pred_order == 3) {
          Nx = Nm > T(0) ? N[j] * (N[j] / Nm) : Nx;
          Px = Pm > T(0) ? P[j] * (P[j] / Pm) : Px;
        }
        N[j] = Nx > T(0) ? Nx : N[j];
        P[j] = Px > T(0) ? Px : P[j];
      }
    }

    int step_its = 0;
    bool done;
    if (NEWTON == FULL) {
      // ---- Full Newton (horizon_kernel._newton_solve): every iteration
      // is a refresh, so the chord telemetry counts it in both.
      done = newton_full(ln, mp, a0, N, P, bN, bP, bE, tol, skip_full, guard_full, step_tol,
                         a.max_iters, approx, kc, step_its);
      execs += step_its;
      fulls += step_its;
    } else {
      // ---- Chord Newton (horizon_kernel._newton_solve_chord).
      T FN[CAP], FP[CAP], errn, errp;
      Aux<T, CAP> ax;
      residual(ln, mp, a0, N, P, bN, bP, bE, FN, FP, errn, errp, ax);
      done = errn < skip_tol && errp < skip_tol;
      if (!done) {
        bool full = !cval;
        for (int it = 0; it < a.max_iters && !done; it++) {
          execs++;
          if (full) {
            refresh(ln, mp, a0, ax, approx, kc, fin);
            cval = true;
            fulls++;
          }
          T dN[CAP], dP[CAP];
          apply(ln, kc, fin, FN, FP, dN, dP);
          const T upd = T(1);
#pragma unroll
          for (int j = 0; j < J; j++) {
            N[j] = N[j] + upd * (nmax(N[j] + dN[j], T(0.05) * N[j]) - N[j]);
            P[j] = P[j] + upd * (nmax(P[j] + dP[j], T(0.05) * P[j]) - P[j]);
          }
          step_its++;
          T m4[4];
          step_maxima(ln, dN, N, dP, P, m4);
          const T guard = full ? guard_full : guard_chord;
          const bool ok_step = m4[0] <= step_tol * m4[1] && m4[2] <= step_tol * m4[3] &&
                               errn < guard && errp < guard;
          T errn2, errp2;
          residual(ln, mp, a0, N, P, bN, bP, bE, FN, FP, errn2, errp2, ax);
          done = ok_step || (errn2 < skip_tol && errp2 < skip_tol);
          const bool bad = !done && (errn2 > stall * errn || errp2 > stall * errp);
          full = bad || it + 1 >= a.chord_budget;
          errn = errn2;
          errp = errp2;
        }
        done = done || (errn < tol && errp < tol);
      }
    }
    // ---- E update (trpl.update_e) at the accepted iterate; the histories
    // move up one slot (N/P) or one ring slot (E).
    update_e(ln, mp, a0, N, P, bE, E);
    T* e_next = eh + (size_t)((t + 1) % 6) * J * 32 + lane;
#pragma unroll
    for (int j = 0; j < J; j++) {
#pragma unroll
      for (int s = HS - 1; s > 0; s--) {
        nh[s][j] = nh[s - 1][j];
        ph[s][j] = ph[s - 1][j];
      }
      nh[0][j] = N[j];
      ph[0][j] = P[j];
      e_next[32 * j] = E[j];
      v1[0][j] = N[j] * P[j];
    }
    its += step_its;
    maxit = step_its > maxit ? step_its : maxit;

    // ---- Fused likelihood (see Mode).
    warp_reduce<1, false>(ln, v1, r1);
    const T pl_t = mp.rate * (r1[0] - T(L) * n0p0);
    const T lp = logpl(pl_t);
    if (kRecord && pl_row != nullptr && lane == 0 && (t + 1) % a.pl_stride == 0)
      pl_row[(t + 1) / a.pl_stride] = pl_t;
    if (kRecord && a.it_out != nullptr) {
      // The largest iteration count of the pl_stride steps of each
      // recorded point, stored by lane 0.
      rec_it = step_its > rec_it ? step_its : rec_it;
      if ((t + 1) % a.pl_stride == 0) {
        if (lane == 0)
          a.it_out[(size_t)b * (TS / a.pl_stride) + (t + 1) / a.pl_stride - 1] = rec_it;
        rec_it = 0;
      }
    }
    if (kRecord && a.st_out != nullptr && (t + 1) % a.state_every == 0) {
      // Frame (t + 1) / state_every - 1 of the state trace, from the lanes'
      // registers: cell 32 j + lane, so each store of the warp coalesces.
      const size_t plane = (size_t)a.batch * L;
      T* const fr = a.st_out + (size_t)((t + 1) / a.state_every - 1) * 3 * plane +
                    (size_t)b * L + lane;
#pragma unroll
      for (int j = 0; j < J; j++) {
        fr[32 * j] = N[j];
        fr[plane + 32 * j] = P[j];
        fr[2 * plane + 32 * j] = E[j];
      }
    }
    if (MODE == STRIDE1) {
      for (int e = lane; e < NE; e += 32) {
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
      // (E, T, 4K) table; values and weights are (E, T, K).  Lane k % 32
      // owns slot k's sums.
      lpw0 = lpw1;
      lpw1 = lpw2;
      lpw2 = lpw3;
      lpw3 = lp;
      for (int e = 0; e < NE; e++) {
        for (int k = lane; k < S; k += 32) {
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
      for (int k = lane; k < S; k += 32) {
        const T* W = a.wtab + ((size_t)(t < 2 ? t : 2) * S + k) * 4;
        const T lpf = lpw0 * W[0] + lpw1 * W[1] + lpw2 * W[2] + lpw3 * W[3];
        for (int e = 0; e < NE; e++) {
          const size_t o = ((size_t)e * TS + t) * S + k;
          const T err = lpf - a.obs[o];
          if (a.has_mask) {
            const T vm = a.vmask[o];
            acc_sse[e * S + k] = acc_sse[e * S + k] + vm * err * err;
            acc_esum[e * S + k] = acc_esum[e * S + k] + vm * err;
          } else {
            acc_sse[e * S + k] = acc_sse[e * S + k] + err * err;
            acc_esum[e * S + k] = acc_esum[e * S + k] + err;
          }
        }
      }
    }
    if (MODE != OFFGRID && a.has_mask) {
      // Padding-only steps (zero weight in every experiment) cannot fail
      // a sample.
      T w_any = a.msk[t];
      for (int e = 1; e < NE; e++) w_any = nmax(w_any, a.msk[(size_t)e * TS + t]);
      done = done || !(w_any > T(0));
    }
    conv = conv && done;
  }

  __syncwarp();
  for (int e = lane; e < NE; e += 32) {
    T s = acc_sse[e * S], q = acc_esum[e * S];
    for (int k = 1; k < S; k++) {
      s = s + acc_sse[e * S + k];
      q = q + acc_esum[e * S + k];
    }
    a.sse[(size_t)e * a.batch + b] = s;
    a.esum[(size_t)e * a.batch + b] = q;
  }
#pragma unroll
  for (int j = 0; j < J; j++) {
    const size_t row0 = (size_t)b * L + ln.cell(j);
    a.n_out[row0] = N[j];
    a.p_out[row0] = P[j];
    a.e_out[row0] = E[j];
  }
  if (lane == 0) {
    a.conv[b] = conv ? 1 : 0;
    a.its[b] = its;
    a.maxit[b] = maxit;
    a.fulls[b] = fulls;
    a.execs[b] = execs;
  }
}

// The kernel of a launch: the 4-cells-per-lane instantiation at L = 128,
// the run-time one at any other width.
template <typename T, int MODE, int NEWTON>
__host__ auto kernel_for(int L) {
  return L == 128 ? horizon_kernel<T, 4, MODE, NEWTON> : horizon_kernel<T, 0, MODE, NEWTON>;
}

template <typename T, int MODE, int NEWTON>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int mode = a.offgrid_k > 0 ? OFFGRID : a.stride > 1 ? STRIDES : STRIDE1;
  if (mode != MODE || (MODE == OFFGRID && a.stride != 1)) return (int)cudaErrorInvalidValue;
  if (a.pl_out != nullptr && (MODE != STRIDE1 || NEWTON != FULL || a.pl_stride < 1 ||
                              a.T_steps % a.pl_stride != 0))
    return (int)cudaErrorInvalidValue;
  // The state and iteration traces ride on the PL trace's launch: every
  // state_every (a multiple of pl_stride) steps, and every pl_stride steps.
  if ((a.st_out != nullptr || a.it_out != nullptr) && a.pl_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.st_out != nullptr && (a.state_every < 1 || a.state_every % a.pl_stride != 0))
    return (int)cudaErrorInvalidValue;
  if (a.batch == 0 || a.T_steps == 0) return 0;
  const SampleLayout<T> sl(a.L, a.num_exp, slots_of<MODE>(a.stride, a.offgrid_k));
  const int spb = samples_per_block(sl.bytes);
  const size_t bytes = sl.bytes * spb;
  auto kernel = kernel_for<T, MODE, NEWTON>(a.L);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.batch + spb - 1) / spb, 32 * spb, bytes, stream>>>(a, spb, sl.bytes);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int NEWTON>
int layout(int L, int num_exp, int stride, int offgrid_k, int* out) {
  const SampleLayout<T> sl(L, num_exp, slots_of<MODE>(stride, offgrid_k));
  const int spb = samples_per_block(sl.bytes);
  auto kernel = kernel_for<T, MODE, NEWTON>(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return query_layout(kernel, spb, sl.bytes * spb, out);
}

// Shared memory of a launch at width L with ``slots`` accumulators per
// experiment: out[0] bytes per sample, out[1] samples per block, out[2]
// bytes per block, out[3] the opt-in bytes a block may take on this card.
template <typename T>
int smem(int L, int num_exp, int slots, long long* out) {
  const SampleLayout<T> sl(L, num_exp, slots);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int spb = samples_per_block(sl.bytes);
  out[0] = (long long)sl.bytes;
  out[1] = spb;
  out[2] = (long long)sl.bytes * spb;
  out[3] = optin;
  return 0;
}

template <typename T, int MODE, int NEWTON>
int entry(const void* mat, const void* n0, const void* p0, const void* e0,
          const void* obs, const void* msk, const void* vmask, const void* pl0,
          const void* wtab, const void* bdf, void* sse, void* esum, void* conv,
          void* its, void* maxit, void* n_out, void* p_out, void* e_out,
          void* fulls, void* execs, void* pl_out, void* st_out, void* it_out, int batch,
          int L, int T_steps, int stride, int offgrid_k, int num_exp, int has_mask,
          int normalize, int ext_pl0, int pred_order, int max_iters, int chord_budget,
          int approx_inv, int pl_stride, int state_every, double tol,
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
  a.fulls = (int*)fulls; a.execs = (int*)execs; a.pl_out = (T*)pl_out;
  a.st_out = (T*)st_out; a.it_out = (int*)it_out;
  a.batch = batch; a.L = L; a.T_steps = T_steps; a.stride = stride;
  a.offgrid_k = offgrid_k; a.num_exp = num_exp;
  a.has_mask = has_mask; a.normalize = normalize; a.ext_pl0 = ext_pl0;
  a.pred_order = pred_order; a.max_iters = max_iters; a.chord_budget = chord_budget;
  a.approx_inv = approx_inv; a.pl_stride = pl_stride; a.state_every = state_every;
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
      void *fulls, void *execs, void *pl_out, void *st_out, void *it_out,       \
      int batch, int L, int T_steps, int stride, int offgrid_k, int num_exp,    \
      int has_mask, int normalize, int ext_pl0, int pred_order, int max_iters,  \
      int chord_budget, int approx_inv, int pl_stride, int state_every,         \
      double tol,                                                               \
      double step_tol, double log_scale, double min_val, double settle_guard,   \
      double skip_accept_factor, double skip_tighten, double stall,             \
      double step_tol_guard, void *stream
#define TRPL_ENTRY_CALL                                                          \
  mat, n0, p0, e0, obs, msk, vmask, pl0, wtab, bdf, sse, esum, conv, its, maxit, \
      n_out, p_out, e_out, fulls, execs, pl_out, st_out, it_out, batch, L,       \
      T_steps, stride, offgrid_k, num_exp, has_mask, normalize, ext_pl0,         \
      pred_order, max_iters, chord_budget, approx_inv, pl_stride, state_every,   \
      tol, step_tol, log_scale, min_val,                                         \
      settle_guard, skip_accept_factor, skip_tighten, stall, step_tol_guard, stream

// Plain C interface, loaded with ctypes by ops/horizon_kernel.py: one
// launcher per Newton body (chord, full), mode (stride 1, stride S > 1,
// off-grid) and dtype.  Each returns the launch's cudaError_t (0 on
// success); the kernel runs on the given stream and does not synchronise.
// Beside each, ``..._layout`` fills 7 ints with the launch layout at width
// L (see query_layout) for ``num_exp`` experiments, stride and K.
#define TRPL_HORIZON_ENTRY(newton, NEWTON, mode, MODE, dt, T)                    \
  extern "C" int trpl_horizon_##newton##_##mode##_##dt(TRPL_ENTRY_ARGS) {       \
    return entry<T, MODE, NEWTON>(TRPL_ENTRY_CALL);                              \
  }                                                                              \
  extern "C" int trpl_horizon_##newton##_##mode##_##dt##_layout(                 \
      int L, int num_exp, int stride, int offgrid_k, int* out) {                 \
    return layout<T, MODE, NEWTON>(L, num_exp, stride, offgrid_k, out);          \
  }
#define TRPL_HORIZON_PAIR(newton, NEWTON, mode, MODE)                            \
  TRPL_HORIZON_ENTRY(newton, NEWTON, mode, MODE, f32, float)                     \
  TRPL_HORIZON_ENTRY(newton, NEWTON, mode, MODE, f64, double)

// ops/kernel_lib.py compiles this file once per part, -DTRPL_PART=0..5, all
// parts at once: one per Newton body and mode (4 kernels each).
// nvcc parts: 6
#if !defined(TRPL_PART) || TRPL_PART == 0
TRPL_HORIZON_PAIR(chord, CHORD, stride1, STRIDE1)
extern "C" const char* trpl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
extern "C" int trpl_horizon_smem_f32(int L, int num_exp, int slots, long long* out) {
  return smem<float>(L, num_exp, slots, out);
}
extern "C" int trpl_horizon_smem_f64(int L, int num_exp, int slots, long long* out) {
  return smem<double>(L, num_exp, slots, out);
}
#endif
#if !defined(TRPL_PART) || TRPL_PART == 1
TRPL_HORIZON_PAIR(chord, CHORD, strides, STRIDES)
#endif
#if !defined(TRPL_PART) || TRPL_PART == 2
TRPL_HORIZON_PAIR(chord, CHORD, offgrid, OFFGRID)
#endif
#if !defined(TRPL_PART) || TRPL_PART == 3
TRPL_HORIZON_PAIR(full, FULL, stride1, STRIDE1)
#endif
#if !defined(TRPL_PART) || TRPL_PART == 4
TRPL_HORIZON_PAIR(full, FULL, strides, STRIDES)
#endif
#if !defined(TRPL_PART) || TRPL_PART == 5
TRPL_HORIZON_PAIR(full, FULL, offgrid, OFFGRID)
#endif

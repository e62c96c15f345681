// The per-step Newton kernel for Hopper (sm_90a): one implicit BDF step's
// check-then-solve exact Newton over a batch of samples, and the E update.
//
// Replaces: newton_kernel._kernel of the JAX package
// (bayesian_inference_trpl_tpu/ops/pallas/newton_kernel.py:35-56, launched
// by _call at :59-104 through pallas_newton_step, :107-140), the step of
// method coupled_newton_pallas (models/solver.bdf_step).  Its body is the
// horizon kernel's full Newton, _newton_solve (horizon_kernel.py:127-223),
// here newton_full of trpl_newton.cuh, shared with horizon_kernel.cu.
//
// Design: one warp per sample, lane l holding cells l + 32 j (see
// trpl_newton.cuh), up to 4 samples per block and a grid of
// ceil(batch / samples per block) blocks, the warps past the batch idle.
// Each warp loads its row of the predicted N/P, the history sums bN/bP/bE
// and the 12 material columns into registers, runs Newton with the chord
// cache of its PCR in lane-private shared memory, and writes N/P/E and its
// per-sample update count and convergence flag.  a0, tol and step_tol are
// read from device memory, so the caller never waits on the device to
// pass them.  L = 128 has its own instantiation with every array in
// registers; other widths read the cells per lane at run time.
//
// What bounds it on this card: per launch it moves 8 (batch, L) fields
// (5 in, 3 out) and does ~1,000 operations per cell and Newton iteration,
// a few microseconds at the power_scan chunk; a launch is one BDF step, so
// the host loop around it (history sums, predictor, likelihood: tens of
// small PyTorch operations per step) and the launch latency bound the
// path, not the kernel.  A CUDA graph over the step is for later work.

#include "trpl_newton.cuh"

namespace {

template <typename T> struct StepArgs {
  const T *mat, *n, *p, *bn, *bp, *be, *a0, *tol, *step_tol;
  T *n_out, *p_out, *e_out;
  int *its, *done;
  int batch, L, max_iters;
  double skip_accept_factor, step_tol_guard;
};

template <typename T, int JC>
__global__ void __launch_bounds__(128, JC > 0 ? 2 : 1)
    newton_step_kernel(const StepArgs<T> a, const int spb, const size_t sample_bytes) {
  constexpr int CAP = Lane<JC>::CAP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * spb + w;
  if (b >= a.batch) return;   // the batch's tail: the warp has no sample
  const Lane<JC> ln{(int)(threadIdx.x & 31), a.L >> 5};
  const int J = ln.J();
  CBlk<T>* kc = reinterpret_cast<CBlk<T>*>(smem_raw + (size_t)w * sample_bytes);
  const Mat<T> mp = load_mat(a.mat + (size_t)b * 12);
  const T a0 = a.a0[0], tol = a.tol[0], step_tol = a.step_tol[0];
  T N[CAP], P[CAP], bN[CAP], bP[CAP], bE[CAP], E[CAP];
#pragma unroll
  for (int j = 0; j < J; j++) {
    const size_t row = (size_t)b * a.L + ln.cell(j);
    N[j] = a.n[row];
    P[j] = a.p[row];
    bN[j] = a.bn[row];
    bP[j] = a.bp[row];
    bE[j] = a.be[row];
  }
  int its;
  const bool done = newton_full(ln, mp, a0, N, P, bN, bP, bE, tol,
                                tol * T(a.skip_accept_factor), tol * T(a.step_tol_guard),
                                step_tol, a.max_iters, false, kc, its);
  update_e(ln, mp, a0, N, P, bE, E);
#pragma unroll
  for (int j = 0; j < J; j++) {
    const size_t row = (size_t)b * a.L + ln.cell(j);
    a.n_out[row] = N[j];
    a.p_out[row] = P[j];
    a.e_out[row] = E[j];
  }
  if (ln.lane == 0) {
    a.its[b] = its;
    a.done[b] = done ? 1 : 0;
  }
}

template <typename T> __host__ auto step_kernel_for(int L) {
  return L == 128 ? newton_step_kernel<T, 4> : newton_step_kernel<T, 0>;
}

template <typename T> size_t step_sample_bytes(int L) { return cache_bytes<T>(L); }

template <typename T>
int step_entry(const void* mat, const void* n, const void* p, const void* bn,
               const void* bp, const void* be, const void* a0, const void* tol,
               const void* step_tol, void* n_out, void* p_out, void* e_out, void* its,
               void* done, int batch, int L, int max_iters, double skip_accept_factor,
               double step_tol_guard, void* stream) {
  StepArgs<T> a;
  a.mat = (const T*)mat; a.n = (const T*)n; a.p = (const T*)p;
  a.bn = (const T*)bn; a.bp = (const T*)bp; a.be = (const T*)be;
  a.a0 = (const T*)a0; a.tol = (const T*)tol; a.step_tol = (const T*)step_tol;
  a.n_out = (T*)n_out; a.p_out = (T*)p_out; a.e_out = (T*)e_out;
  a.its = (int*)its; a.done = (int*)done;
  a.batch = batch; a.L = L; a.max_iters = max_iters;
  a.skip_accept_factor = skip_accept_factor; a.step_tol_guard = step_tol_guard;
  if (batch == 0) return 0;
  const size_t sample = step_sample_bytes<T>(L);
  const int spb = samples_per_block(sample);
  const size_t bytes = sample * spb;
  auto kernel = step_kernel_for<T>(L);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(batch + spb - 1) / spb, 32 * spb, bytes, (cudaStream_t)stream>>>(a, spb, sample);
  return (int)cudaGetLastError();
}

template <typename T> int step_layout(int L, int* out) {
  const size_t sample = step_sample_bytes<T>(L);
  const int spb = samples_per_block(sample);
  auto kernel = step_kernel_for<T>(L);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return query_layout(kernel, spb, sample * spb, out);
}

}  // namespace

// Plain C interface, loaded with ctypes by ops/newton_kernel.py: one
// launcher per dtype.  Each returns the launch's cudaError_t (0 on
// success); the kernel runs on the given stream and does not synchronise.
// Beside each, ``..._layout`` fills 7 ints with the launch layout at width
// L (see query_layout in trpl_newton.cuh).
#define TRPL_STEP_ARGS                                                           \
  const void *mat, const void *n, const void *p, const void *bn, const void *bp, \
      const void *be, const void *a0, const void *tol, const void *step_tol,    \
      void *n_out, void *p_out, void *e_out, void *its, void *done, int batch,  \
      int L, int max_iters, double skip_accept_factor, double step_tol_guard,   \
      void *stream
#define TRPL_STEP_CALL                                                           \
  mat, n, p, bn, bp, be, a0, tol, step_tol, n_out, p_out, e_out, its, done,     \
      batch, L, max_iters, skip_accept_factor, step_tol_guard, stream


// ops/kernel_lib.py compiles this file once per dtype, -DTRPL_PART=0..1,
// both parts at once.
// nvcc parts: 2
#if !defined(TRPL_PART) || TRPL_PART == 0
extern "C" int trpl_newton_step_f32(TRPL_STEP_ARGS) {
  return step_entry<float>(TRPL_STEP_CALL);
}
extern "C" int trpl_newton_step_f32_layout(int L, int* out) { return step_layout<float>(L, out); }
#endif
#if !defined(TRPL_PART) || TRPL_PART == 1
extern "C" int trpl_newton_step_f64(TRPL_STEP_ARGS) {
  return step_entry<double>(TRPL_STEP_CALL);
}
extern "C" int trpl_newton_step_f64_layout(int L, int* out) { return step_layout<double>(L, out); }
#endif

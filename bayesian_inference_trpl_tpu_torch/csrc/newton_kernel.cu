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
// Design: one thread block per sample and one thread per spatial cell
// (blockDim.x == L), grid = batch with no padding to a tile.  Each block
// loads its row of the predicted N/P, the history sums bN/bP/bE and the 12
// material columns, runs Newton with the Jacobian, the PCR and the
// residual norms in shared memory, and writes N/P/E and its per-sample
// update count and convergence flag.  a0, tol and step_tol are read from
// device memory, so the caller never waits on the device to pass them.
//
// What bounds it on this card: per launch it moves 8 (batch, L) fields
// (5 in, 3 out) and does ~1,000 operations per cell and Newton iteration,
// a few microseconds at the power_scan chunk; a launch is one BDF step, so
// the host loop around it (history sums, predictor, likelihood: tens of
// small PyTorch operations per step) and the launch latency bound the
// path, not the kernel.  Several samples per block, warp-level PCR and a
// CUDA graph over the step are for later work.

#include "trpl_newton.cuh"

namespace {

template <typename T> struct StepArgs {
  const T *mat, *n, *p, *bn, *bp, *be, *a0, *tol, *step_tol;
  T *n_out, *p_out, *e_out;
  int *its, *done;
  int batch, L, max_iters;
  double skip_accept_factor, step_tol_guard;
};

template <typename T>
__global__ void __launch_bounds__(1024) newton_step_kernel(const StepArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  Block<T> bk{reinterpret_cast<T*>(smem_raw), NewtonLayout(a.L, 0), (int)threadIdx.x,
              a.L, 0};
  const int b = blockIdx.x;
  const size_t row = (size_t)b * a.L + bk.i;
  const Mat<T> mp = load_mat(a.mat + (size_t)b * 12);
  const T a0 = a.a0[0], tol = a.tol[0], step_tol = a.step_tol[0];
  T N = a.n[row], P = a.p[row];
  const T bE = a.be[row];
  int its;
  const bool done = newton_full(bk, mp, a0, N, P, a.bn[row], a.bp[row], bE, tol,
                                tol * T(a.skip_accept_factor), tol * T(a.step_tol_guard),
                                step_tol, a.max_iters, false, its);
  a.n_out[row] = N;
  a.p_out[row] = P;
  a.e_out[row] = update_e_cell(bk, mp, a0, N, P, bE);
  if (bk.i == 0) {
    a.its[b] = its;
    a.done[b] = done ? 1 : 0;
  }
}

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
  const size_t bytes = (size_t)NewtonLayout(L, 0).end * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      newton_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  newton_step_kernel<T><<<batch, L, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes by ops/newton_kernel.py: one
// launcher per dtype.  Each returns the launch's cudaError_t (0 on
// success); the kernel runs on the given stream and does not synchronise.
#define TRPL_STEP_ARGS                                                           \
  const void *mat, const void *n, const void *p, const void *bn, const void *bp, \
      const void *be, const void *a0, const void *tol, const void *step_tol,    \
      void *n_out, void *p_out, void *e_out, void *its, void *done, int batch,  \
      int L, int max_iters, double skip_accept_factor, double step_tol_guard,   \
      void *stream
#define TRPL_STEP_CALL                                                           \
  mat, n, p, bn, bp, be, a0, tol, step_tol, n_out, p_out, e_out, its, done,     \
      batch, L, max_iters, skip_accept_factor, step_tol_guard, stream

extern "C" int trpl_newton_step_f32(TRPL_STEP_ARGS) {
  return step_entry<float>(TRPL_STEP_CALL);
}
extern "C" int trpl_newton_step_f64(TRPL_STEP_ARGS) {
  return step_entry<double>(TRPL_STEP_CALL);
}

// Weighted 1-D and 2-D histograms for Hopper (sm_90a): the marginals of the
// posterior analysis (posterior/stats.marginalize_1d, marginalize_2d).
//
// Replaces: not a pallas_call.  The JAX package bins its marginals in its
// native host library with OpenMP, trpl_hist1d_weighted and
// trpl_hist2d_weighted (bayesian_inference_trpl_tpu/native/src/
// trpl_native.cpp:97-138 and :142-179), called from posterior/stats.py:127
// and :155.
//
// The binning rule is that library's, not numpy's edge-corrected one:
// inv = bins / (hi - lo) on the host in float64, b = (int64)((x - lo) * inv),
// samples with x < lo or x > hi dropped, b == bins -> bins - 1.  A NaN x
// is dropped explicitly: the C++ cast of NaN gives INT64_MIN on x86 (and
// the sample falls out of range there), where CUDA's conversion gives 0;
// likewise a product at or past 2^63 is dropped, as x86 drops it.
//
// Design (a simple one that is right; making it fast is later work): a
// grid-stride loop over the samples, 256 threads a block, each block
// accumulating into its own histogram in shared memory with atomicAdd on
// doubles and on 64-bit counts, then merging its non-empty bins into the
// output in device memory with atomicAdd.  Which path a size takes (see
// plan()): the shared path while the block's histogram (1-D: 16 B a bin,
// sums and counts; 2-D: 8 B a bin) fits the card's opt-in shared memory
// per block (227 KB on the H100: 96 bins = 1.5 KB, 96 x 96 = 72 KB, both
// shared; 200 x 200 = 313 KB, global), else the global path, whose threads
// add straight into the output.  The blocks are at most what the card
// holds at once, and at most one per max(4,096, bins) samples, so that
// merging the block histograms stays small beside binning the samples.
//
// Determinism: the counts are exact.  The float64 sums are added in an
// order that the atomics choose, so they can differ from run to run in the
// last bits (each within a few ulps of the exact sum of positive weights);
// a result is not bitwise the same from run to run.
//
// What bounds it on this card: bytes.  It reads each sample's 16 (1-D) or
// 24 (2-D) bytes once and does a few operations on them; at the CLI's
// n = 1e5-1e6 samples and 96 bins that is 5-7 microseconds at 3.35 TB/s,
// below a launch's own cost.  The shared atomics on a hot bin serialise,
// which a per-warp histogram would relieve.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMinSamplesPerBlock = 4096;

// The bin of x under the native library's rule, or -1 if x is dropped.
__device__ __forceinline__ long long bin_of(double x, double lo, double hi, double inv,
                                            long long bins) {
  if (!(x >= lo && x <= hi)) return -1;  // x < lo, x > hi, or NaN
  const double f = (x - lo) * inv;
  if (!(f < 9223372036854775808.0)) return -1;  // NaN (hi == lo) or past int64
  long long b = (long long)f;
  if (b == bins) b = bins - 1;  // the last bin is closed on the right
  return (b >= 0 && b < bins) ? b : -1;
}

struct Axis {
  double lo, hi, inv;
  long long bins;
};

// One kernel for both ranks: ``y == nullptr`` is 1-D (sums and counts),
// else 2-D (sums of bin a * by + b, no counts).  SHARED: the block's
// histogram lives in shared memory and is merged at the end.
template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const double* __restrict__ x, const double* __restrict__ y,
                const double* __restrict__ w, long long n, Axis ax, Axis ay,
                double* __restrict__ out_w, unsigned long long* __restrict__ out_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool two = y != nullptr;
  const long long nb = two ? ax.bins * ay.bins : ax.bins;
  double* hw = out_w;
  unsigned long long* hc = out_c;
  if (SHARED) {
    hw = reinterpret_cast<double*>(smem_raw);
    hc = two ? nullptr : reinterpret_cast<unsigned long long*>(smem_raw + nb * sizeof(double));
    for (long long k = threadIdx.x; k < nb; k += kThreads) {
      hw[k] = 0.0;
      if (!two) hc[k] = 0ull;
    }
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    long long k = bin_of(x[i], ax.lo, ax.hi, ax.inv, ax.bins);
    if (k < 0) continue;
    if (two) {
      const long long b = bin_of(y[i], ay.lo, ay.hi, ay.inv, ay.bins);
      if (b < 0) continue;
      k = k * ay.bins + b;
    }
    atomicAdd(hw + k, w[i]);
    if (!two) atomicAdd(hc + k, 1ull);
  }
  if (SHARED) {
    __syncthreads();
    // An empty bin holds +0.0 and adds nothing to the output's +0.0.
    for (long long k = threadIdx.x; k < nb; k += kThreads) {
      if (two) {
        if (hw[k] != 0.0) atomicAdd(out_w + k, hw[k]);
      } else if (hc[k] != 0ull) {
        atomicAdd(out_w + k, hw[k]);
        atomicAdd(out_c + k, hc[k]);
      }
    }
  }
}

// The launch for n samples into nb bins of ``bytes_per_bin`` shared bytes:
// out[0] the path (0 shared, 1 global), out[1] the blocks, out[2] the
// shared bytes a block, out[3] the opt-in shared bytes of the card.
int plan(long long n, long long nb, int bytes_per_bin, int* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long smem = nb * bytes_per_bin;
  const bool shared = smem <= optin;
  int per_sm = 0;
  if (shared) {
    err = cudaFuncSetAttribute(hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel<true>, kThreads,
                                                          (size_t)smem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel<false>, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const long long per_block = nb > kMinSamplesPerBlock ? nb : kMinSamplesPerBlock;
  long long blocks = (n + per_block - 1) / per_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  out[0] = shared ? 0 : 1;
  out[1] = (int)blocks;
  out[2] = shared ? (int)smem : 0;
  out[3] = optin;
  return 0;
}

int launch(const double* x, const double* y, const double* w, long long n, Axis ax, Axis ay,
           double* out_w, unsigned long long* out_c, void* stream, int* info) {
  const bool two = y != nullptr;
  const long long nb = two ? ax.bins * ay.bins : ax.bins;
  int p[4];
  int err = plan(n, nb, two ? 8 : 16, p);
  if (err != 0) return err;
  if (info != nullptr)
    for (int k = 0; k < 4; k++) info[k] = p[k];
  if (n == 0 || nb == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p[0] == 0)
    hist_kernel<true><<<p[1], kThreads, (size_t)p[2], s>>>(x, y, w, n, ax, ay, out_w, out_c);
  else
    hist_kernel<false><<<p[1], kThreads, 0, s>>>(x, y, w, n, ax, ay, out_w, out_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes by ops/histogram.py.  The outputs
// must be zeroed by the caller; each entry launches on ``stream``, does not
// synchronise and returns the launch's cudaError_t (0 on success).
// ``info`` (may be null) gets the plan: path (0 shared, 1 global), blocks,
// shared bytes a block, the card's opt-in shared bytes a block.
extern "C" int trpl_hist1d_f64(const void* x, const void* w, long long n, double lo, double hi,
                               double inv, long long bins, void* out_w, void* out_c,
                               void* stream, int* info) {
  const Axis ax{lo, hi, inv, bins};
  return launch((const double*)x, nullptr, (const double*)w, n, ax, ax, (double*)out_w,
                (unsigned long long*)out_c, stream, info);
}

extern "C" int trpl_hist2d_f64(const void* x, const void* y, const void* w, long long n,
                               double lox, double hix, double invx, long long bx, double loy,
                               double hiy, double invy, long long by, void* out_w,
                               void* stream, int* info) {
  const Axis ax{lox, hix, invx, bx}, ay{loy, hiy, invy, by};
  return launch((const double*)x, (const double*)y, (const double*)w, n, ax, ay,
                (double*)out_w, nullptr, stream, info);
}

// The plan alone, for n samples into nb bins (``dims`` 1 or 2).
extern "C" int trpl_hist_plan(int dims, long long n, long long nb, int* info) {
  return plan(n, nb, dims == 2 ? 8 : 16, info);
}

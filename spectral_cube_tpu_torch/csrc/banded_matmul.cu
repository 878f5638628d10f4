// Banded matrix product out = M @ x of a (nin, S) float32 array along its
// first axis: out (nout, S), M banded.
//
// Replaces the TPU kernel spectral_cube_tpu/ops/banded_pallas.py::
// banded_matmul_strips, which cuts M into strips of m rows, each with one
// K-column window, and multiplies each (m, K) block with the K input rows
// it touches on the MXU.  Here each output row arrives as its own band
// (kernels/banded_matmul.py::row_bands): the first column of its nonzero
// span, the span's length and its taps, so that
//
//   out[i, s] = sum_{t < len[i]} taps[i, t] * x[start[i] + t, s]
//
// in IEEE float32 FMAs in t order.  A non-finite x reaches out[i, s] only
// through row i's span; the dense M never reaches the card.
//
// What bounds it on an H100: device memory.  Each input is read once and
// each output written once (4 (nin + nout) bytes per column) against
// 2 * len flops per output.  A block owns a tile of 64 neighbouring
// columns and walks the output rows in chunks of R rows: it stages the
// input rows the chunk's spans cover (the host gives each chunk's row
// range) in shared memory, with adjacent threads on adjacent columns so
// that every row is read coalesced, and the chunk's taps beside them;
// then each thread computes the outputs of one column from shared memory
// (taps broadcast, inputs conflict-free) and writes them coalesced.  The
// rows two chunks share are read twice, from L2 for the second time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;
constexpr int kGroups = kThreads / kCols;

__global__ void __launch_bounds__(kThreads)
banded_matmul_kernel(const float* __restrict__ x, int nout, long long S,
                     const int* __restrict__ start,
                     const int* __restrict__ len,
                     const float* __restrict__ taps, int W,
                     const int* __restrict__ chunk_lo,
                     const int* __restrict__ chunk_hi, int R, int kmax,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;                          // kmax x kCols
  float* ts = xs + (size_t)kmax * kCols;     // R x W
  int* st = (int*)(ts + (size_t)R * W);      // R
  int* ln = st + R;                          // R
  const long long s0 = (long long)blockIdx.x * kCols;
  const int ncols = (int)min((long long)kCols, S - s0);
  const int c = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;
  const int nchunks = (nout + R - 1) / R;
  for (int k = 0; k < nchunks; ++k) {
    const int o0 = k * R;
    const int nr = min(R, nout - o0);
    const int lo = chunk_lo[k];
    const int hi = chunk_hi[k];
    __syncthreads();  // the previous chunk is done with shared memory
    if (c < ncols)
      for (int r = lo + g; r < hi; r += kGroups)
        xs[(r - lo) * kCols + c] = x[(long long)r * S + s0 + c];
    for (int i = threadIdx.x; i < nr * W; i += kThreads)
      ts[i] = taps[(long long)o0 * W + i];
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      st[i] = start[o0 + i] - lo;
      ln[i] = len[o0 + i];
    }
    __syncthreads();
    if (c >= ncols) continue;
    for (int i = g; i < nr; i += kGroups) {
      const float* w = ts + i * W;
      const float* xr = xs + st[i] * kCols + c;
      const int n = ln[i];
      float acc = 0.f;
      for (int t = 0; t < n; ++t) acc = fmaf(w[t], xr[t * kCols], acc);
      out[(long long)(o0 + i) * S + s0 + c] = acc;
    }
  }
}

}  // namespace

// Shared bytes of one block for chunks of R rows spanning at most kmax
// input rows, with W taps a row.
extern "C" long long sct_banded_matmul_smem(int R, int kmax, int W) {
  return (long long)kmax * kCols * sizeof(float) +
         (long long)R * W * sizeof(float) + 2LL * R * sizeof(int);
}

// x: (nin, S) float32; start, len: (nout,) int32; taps: (nout, W) float32;
// chunk_lo, chunk_hi: (ceil(nout / R),) int32, the input rows each chunk of
// R output rows reads (chunk_hi - chunk_lo <= kmax); out: (nout, S).
extern "C" int sct_banded_matmul(const void* x, int nout, long long S,
                                 const void* start, const void* len,
                                 const void* taps, int W,
                                 const void* chunk_lo, const void* chunk_hi,
                                 int R, int kmax, void* out, void* stream) {
  if (nout <= 0 || S <= 0) return (int)cudaSuccess;
  const long long bytes = sct_banded_matmul_smem(R, kmax, W);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      banded_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (S + kCols - 1) / kCols;
  banded_matmul_kernel<<<(unsigned)blocks, kThreads, (size_t)bytes,
                         (cudaStream_t)stream>>>(
      (const float*)x, nout, S, (const int*)start, (const int*)len,
      (const float*)taps, W, (const int*)chunk_lo, (const int*)chunk_hi, R,
      kmax, (float*)out);
  return (int)cudaGetLastError();
}

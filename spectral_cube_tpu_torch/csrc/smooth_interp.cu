// Fused spectral smooth + 2-tap interpolation of a (nin, ncol) float32
// array along its first axis: out (nout, ncol), one column per spaxel.
//
// Replaces the TPU kernels spectral_cube_tpu/ops/banded_pallas.py::
// smooth_interp_strips_3d (3-D (nin, BY, 128) slabs) and
// ::smooth_interp_strips (a flat (nin, S) view).  Both apply the composed
// operator M = I @ S as MXU strip matmuls to clean slabs and run the exact
// chain (normalized smooth with the 1e-6 den floor, then I with NaN
// poisoning) on slabs that hold NaN.  On this card they are one kernel
// over the flat (nin, ncol) view, and the clean/dirty decision is made
// per spectrum from the input's own finiteness:
//
//   all finite          out[o] = sum_t M[o, t] x[t]
//   none finite         out[o] = NaN
//   otherwise           sm[c]  = num / den, den = 1 - sum S[c, t] over
//                                non-finite x[t], num = sum S[c, t] x[t]
//                                over finite x[t]; NaN where den <= 1e-6
//                       out[o] = sum I[o, u] sm[u] over taps I[o, u] != 0,
//                                NaN if any such sm[u] is NaN
//
// Each operator arrives as compact per-row bands (start, W taps), built
// on the host from the dense matrices (kernels/smooth_interp.py::
// band_rows); the dense (nout, nin) matrix never reaches the card.
//
// What bounds it on an H100: device memory, one read of the input and one
// write of the output (nin + nout floats per spectrum) against ~2 * W
// flops per output.  A block stages a tile of up to 32 neighbouring
// spectra in shared memory (adjacent threads read adjacent columns of a
// channel row, so each row is read coalesced), flags which spectra hold a
// non-finite value, and then every thread computes outputs of one spectrum
// from shared memory and writes them coalesced.  A dirty spectrum
// evaluates the smooth at the two samples each output needs, so the chain
// needs no scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;
constexpr size_t kTileBudget = 113 * 1024;   // two blocks per SM
constexpr size_t kMaxShared = 232448 - 1024; // per block, sm_90, less static
constexpr float kDenEps = 1e-6f;             // banded_pallas.py:45

struct Band {
  const int* start;
  const float* taps;
  int width;
};

// normalized smooth of spectrum `col` at channel c, from shared memory
__device__ float smooth_at(const float* xs, int pitch, int col, Band s,
                           int c) {
  const int s0 = __ldg(s.start + c);
  const float* w = s.taps + (size_t)c * s.width;
  float num = 0.f, bad = 0.f;
  for (int t = 0; t < s.width; ++t) {
    const float wt = __ldg(w + t);
    const float v = xs[(s0 + t) * pitch + col];
    if (isfinite(v))
      num = fmaf(wt, v, num);
    else
      bad += wt;
  }
  const float den = 1.f - bad;
  return den > kDenEps ? num / den : NAN;
}

__global__ void __launch_bounds__(kThreads)
smooth_interp_kernel(const float* __restrict__ x, int nin, int nout,
                     long long ncol, int tile, Band m, Band s, Band in,
                     float* __restrict__ out) {
  extern __shared__ float xs[];                // nin x (tile + 1)
  __shared__ int state[kMaxTile];              // bit 0: finite, 1: not
  const int pitch = tile + 1;
  const long long p0 = (long long)blockIdx.x * tile;
  const int nsp = (int)min((long long)tile, ncol - p0);
  const int col = threadIdx.x % tile;
  const int row = threadIdx.x / tile;
  const int rows = blockDim.x / tile;
  if (threadIdx.x < tile) state[threadIdx.x] = 0;
  __syncthreads();

  int seen = 0;
  if (col < nsp) {
    for (int c = row; c < nin; c += rows) {
      const float v = x[(long long)c * ncol + p0 + col];
      xs[c * pitch + col] = v;
      seen |= isfinite(v) ? 1 : 2;
    }
  }
  if (seen) atomicOr(&state[col], seen);
  __syncthreads();
  if (col >= nsp) return;

  const int st = state[col];
  for (int o = row; o < nout; o += rows) {
    float r;
    if (!(st & 1)) {
      r = NAN;
    } else if (!(st & 2)) {
      const int base = __ldg(m.start + o);
      const float* w = m.taps + (size_t)o * m.width;
      float acc = 0.f;
      for (int t = 0; t < m.width; ++t)
        acc = fmaf(__ldg(w + t), xs[(base + t) * pitch + col], acc);
      r = acc;
    } else {
      const int base = __ldg(in.start + o);
      const float* w = in.taps + (size_t)o * in.width;
      float acc = 0.f;
      bool poisoned = false;
      for (int u = 0; u < in.width; ++u) {
        const float wu = __ldg(w + u);
        if (wu == 0.f) continue;
        const float v = smooth_at(xs, pitch, col, s, base + u);
        if (isnan(v))
          poisoned = true;
        else
          acc = fmaf(wu, v, acc);
      }
      r = poisoned ? NAN : acc;
    }
    out[(long long)o * ncol + p0 + col] = r;
  }
}

}  // namespace

// x: (nin, ncol) float32; bands: int32 starts and float32 (rows, width)
// taps of M (nout rows), S (nin rows) and I (nout rows); out: (nout, ncol).
extern "C" int sct_smooth_interp(const void* x, int nin, int nout,
                                 long long ncol, const void* m_start,
                                 const void* m_taps, int wm,
                                 const void* s_start, const void* s_taps,
                                 int ws, const void* i_start,
                                 const void* i_taps, int wi, void* out,
                                 void* stream) {
  if (nin <= 0 || nout <= 0 || ncol <= 0) return (int)cudaSuccess;
  int tile = kMaxTile;
  while (tile > 1 && (size_t)nin * (tile + 1) * sizeof(float) > kTileBudget)
    tile >>= 1;
  const size_t bytes = (size_t)nin * (tile + 1) * sizeof(float);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smooth_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Band m{(const int*)m_start, (const float*)m_taps, wm};
  const Band s{(const int*)s_start, (const float*)s_taps, ws};
  const Band in{(const int*)i_start, (const float*)i_taps, wi};
  const long long blocks = (ncol + tile - 1) / tile;
  smooth_interp_kernel<<<(unsigned)blocks, kThreads, bytes,
                         (cudaStream_t)stream>>>(
      (const float*)x, nin, nout, ncol, tile, m, s, in, (float*)out);
  return (int)cudaGetLastError();
}

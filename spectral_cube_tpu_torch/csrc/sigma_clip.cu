// Iterative per-spaxel sigma clip of a (nchan, S) float32 cube along its
// spectral axis (S = ny * nx spaxels), stdfunc = std, centre = median or
// mean, in one kernel.
//
// Replaces the TPU kernel spectral_cube_tpu/ops/clip_pallas.py::
// sigma_clip_fused, which sorts (nchan, 8, 128) tiles in VMEM with a
// vectorized bitonic network, iterates the clip band with indicator-mask
// sums, emits lo/hi/count planes and leaves the clipped cube to an XLA
// `where`.  Here one block stages a tile of consecutive spaxels in shared
// memory (coalesced: neighbouring threads read neighbouring spaxels of a
// channel row), one warp per spaxel sorts a +inf padded copy of its
// spectrum with a bitonic network in shared memory, runs the band
// iterations on the sorted values (the median is a direct read s[m], the
// band statistics warp sums), and the block writes x or NaN for every
// channel from an unsorted copy it kept in shared memory.  HBM sees the
// cube read once and written once.  A spectrum too long for one spaxel's
// rows to fit in shared memory (beyond ~25,000 channels) keeps them in a
// global workspace instead, one spaxel per block, over chunks of spaxels.
//
// Semantics (spectral_cube_tpu/ops/smoothing.py:316-392): non-finite
// samples are missing; the band [i_lo, i_hi) of sorted finite values
// starts as all of them; each iteration with cnt = i_hi - i_lo > 0 takes
// mean = sum/cnt, centre = median (s[i_lo + (cnt-1)/2] + s[i_lo + cnt/2])/2
// or the mean, std = sqrt(sum (s - mean)^2 / cnt), and narrows the band to
// the values in [centre - sigma*std, centre + sigma*std]; a sample is kept
// when finite, cnt > 0 and s[i_lo] <= x <= s[i_hi - 1].
//
// Every float32 sum runs in one fixed order that the plain PyTorch twin
// (kernels/sigma_clip.py::band_sum) repeats: lane l adds the band values
// at sorted positions l, l+32, ... in turn, then an xor butterfly.  All
// arithmetic is round-to-nearest with no contraction (__fadd_rn etc.), so
// kernel and twin agree bitwise.
//
// What bounds it on an H100: the sort.  The cube moves 8 bytes per voxel
// through HBM (~0.9 ms at 623 x 768 x 768), but a 1024-wide bitonic
// network is 55 stages of 512 compare-exchanges per spaxel, each two
// shared-memory loads and up to two stores: ~270 GB of shared-memory
// traffic at that size, several milliseconds at the SMs' combined shared
// memory rate.  Padding the sort to a power of two and one warp per
// spaxel keep the network simple; a register-resident sort is the lever
// for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTile = 16;                   // spaxels (warps) per block
constexpr size_t kTileBudget = 113 * 1024;     // two blocks per SM
constexpr size_t kMaxShared = 232448;          // per block, sm_90

__device__ __forceinline__ float warp_sum(float a) {
  for (int off = kLanes / 2; off; off >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

__device__ __forceinline__ int warp_sum_int(int a) {
  for (int off = kLanes / 2; off; off >>= 1)
    a += __shfl_xor_sync(kFull, a, off);
  return a;
}

// first position >= lo that is lane's residue mod 32
__device__ __forceinline__ int first_of_lane(int lo, int lane) {
  return lo + ((lane - lo) & (kLanes - 1));
}

// sum of s[lo..hi) in the fixed lane order
__device__ float band_sum(const float* s, int lo, int hi, int lane) {
  float acc = 0.f;
  for (int i = first_of_lane(lo, lane); i < hi; i += kLanes)
    acc = __fadd_rn(acc, s[i]);
  return warp_sum(acc);
}

// sum of (s - mean)^2 over s[lo..hi) in the same order
__device__ float band_sq_sum(const float* s, int lo, int hi, float mean,
                             int lane) {
  float acc = 0.f;
  for (int i = first_of_lane(lo, lane); i < hi; i += kLanes) {
    const float d = __fsub_rn(s[i], mean);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  return warp_sum(acc);
}

// ascending bitonic sort of s[0..n), n a power of two, by one warp
__device__ void bitonic_sort(float* s, int n, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < (n >> 1); q += kLanes) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int p = i | j;
        const float a = s[i], b = s[p];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[p] = a;
        }
      }
      __syncwarp();
    }
  }
}

// kInWork: the tile's rows live in this block's slice of the global
// workspace ``work`` instead of shared memory (a compile-time choice, so
// the shared-memory variant keeps shared-memory loads and stores)
template <bool kInWork>
__global__ void sigma_clip_kernel(const float* __restrict__ x, int nchan,
                                  int npad, long long S, long long p_base,
                                  int tile, float sigma, int maxiters,
                                  int use_mean, float* __restrict__ work,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const int pitch = npad + 1;                  // staggers the tile's banks
  float* sorted = kInWork
      ? work + (size_t)blockIdx.x * tile * (pitch + nchan)
      : smem;                                  // tile x pitch
  float* copy = sorted + (size_t)tile * pitch; // tile x nchan, unsorted
  float* lo_val = kInWork ? smem : copy + (size_t)tile * nchan;  // tile
  float* hi_val = lo_val + tile;               // tile
  int* keep_any = (int*)(hi_val + tile);       // tile: final cnt > 0

  const long long p0 = p_base + (long long)blockIdx.x * tile;
  const int nsp = (int)min((long long)tile, S - p0);

  for (int idx = threadIdx.x; idx < tile * nchan; idx += blockDim.x) {
    const int c = idx / tile;
    const int k = idx - c * tile;
    float v = NAN;
    if (k < nsp) v = x[(long long)c * S + p0 + k];
    copy[k * nchan + c] = v;
    sorted[k * pitch + c] = isfinite(v) ? v : INFINITY;
  }
  const int npadding = npad - nchan;
  for (int idx = threadIdx.x; idx < tile * npadding; idx += blockDim.x) {
    const int k = idx / npadding;
    sorted[k * pitch + nchan + (idx - k * npadding)] = INFINITY;
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int nwarps = blockDim.x / kLanes;
  for (int k = threadIdx.x / kLanes; k < nsp; k += nwarps) {
    float* s = sorted + k * pitch;
    bitonic_sort(s, npad, lane);
    int nfin = 0;
    for (int i = lane; i < nchan; i += kLanes) nfin += s[i] < INFINITY;
    nfin = warp_sum_int(nfin);
    int i_lo = 0, i_hi = nfin;
    for (int it = 0; it < maxiters; ++it) {
      const int cnt = i_hi - i_lo;
      if (cnt <= 0) break;               // the band no longer changes
      const float safe = (float)cnt;
      const float mean = __fdiv_rn(band_sum(s, i_lo, i_hi, lane), safe);
      float centre = mean;
      if (!use_mean) {
        const float a = s[i_lo + (cnt - 1) / 2];
        const float b = s[i_lo + cnt / 2];
        centre = __fdiv_rn(__fadd_rn(a, b), 2.f);
      }
      const float var = __fdiv_rn(band_sq_sum(s, i_lo, i_hi, mean, lane),
                                  safe);
      const float t = __fmul_rn(sigma, __fsqrt_rn(var));
      const float lo_v = __fsub_rn(centre, t);
      const float hi_v = __fadd_rn(centre, t);
      int n_lt = 0, n_le = 0;
      for (int i = lane; i < nfin; i += kLanes) {
        n_lt += s[i] < lo_v;
        n_le += s[i] <= hi_v;
      }
      i_lo = max(i_lo, warp_sum_int(n_lt));
      i_hi = min(i_hi, warp_sum_int(n_le));
    }
    if (lane == 0) {
      const bool some = i_hi > i_lo;
      keep_any[k] = some;
      lo_val[k] = some ? s[i_lo] : 0.f;
      hi_val[k] = some ? s[i_hi - 1] : 0.f;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < tile * nchan; idx += blockDim.x) {
    const int c = idx / tile;
    const int k = idx - c * tile;
    if (k >= nsp) continue;
    const float v = copy[k * nchan + c];
    const bool keep = isfinite(v) && keep_any[k] && v >= lo_val[k] &&
                      v <= hi_val[k];
    out[(long long)c * S + p0 + k] = keep ? v : NAN;
  }
}

static size_t row_floats(int nchan, int npad) {
  return (size_t)(npad + 1) + nchan;           // sorted row + unsorted copy
}

static int pad_pow2(int nchan) {
  int npad = 1;
  while (npad < nchan) npad <<= 1;
  return npad;
}

static size_t per_spaxel_shared(int nchan) {
  return row_floats(nchan, pad_pow2(nchan)) * sizeof(float) +
         2 * sizeof(float) + sizeof(int);
}

}  // namespace

// Floats of global workspace per spaxel that sct_sigma_clip needs for
// spectra of nchan channels: 0 when a spaxel's rows fit in shared memory.
extern "C" long long sct_sigma_clip_work(int nchan) {
  if (nchan <= 0 || per_spaxel_shared(nchan) <= kMaxShared) return 0;
  return (long long)row_floats(nchan, pad_pow2(nchan));
}

// x, out: (nchan, S) float32, contiguous; nchan >= 1.  work: chunk *
// sct_sigma_clip_work(nchan) floats, or null when that is 0; the spaxels
// then run chunk at a time.
extern "C" int sct_sigma_clip(const void* x, int nchan, long long S,
                              float sigma, int maxiters, int use_mean,
                              void* work, long long chunk, void* out,
                              void* stream) {
  if (nchan <= 0 || S <= 0) return (int)cudaSuccess;
  const int npad = pad_pow2(nchan);
  cudaStream_t st = (cudaStream_t)stream;
  if (sct_sigma_clip_work(nchan) > 0) {
    if (work == nullptr || chunk <= 0) return (int)cudaErrorInvalidValue;
    const size_t bytes = 2 * sizeof(float) + sizeof(int);
    for (long long p = 0; p < S; p += chunk) {
      const long long blocks = S - p < chunk ? S - p : chunk;
      sigma_clip_kernel<true><<<(unsigned)blocks, kLanes, bytes, st>>>(
          (const float*)x, nchan, npad, S, p, 1, sigma, maxiters, use_mean,
          (float*)work, (float*)out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  const size_t per = per_spaxel_shared(nchan);
  int tile = kMaxTile;
  while (tile > 1 && per * tile > kTileBudget) tile >>= 1;
  const size_t bytes = per * tile;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_clip_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (S + tile - 1) / tile;
  sigma_clip_kernel<false><<<(unsigned)blocks, tile * kLanes, bytes, st>>>(
      (const float*)x, nchan, npad, S, 0, tile, sigma, maxiters, use_mean,
      nullptr, (float*)out);
  return (int)cudaGetLastError();
}

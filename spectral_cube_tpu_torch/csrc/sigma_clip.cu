// Iterative per-spaxel sigma clip of a (nchan, S) float32 cube along its
// spectral axis (S = ny * nx spaxels), stdfunc = std, centre = median or
// mean, in one kernel.
//
// Replaces the TPU kernel spectral_cube_tpu/ops/clip_pallas.py::
// sigma_clip_fused (#13), which sorts (nchan, 8, 128) tiles in VMEM with a
// vectorized bitonic network, iterates the clip band with indicator-mask
// sums, emits lo/hi/count planes and leaves the clipped cube to an XLA
// `where`.
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
// kernel and twin agree bitwise.  The band's new edges are counts of
// sorted values below a threshold, found by a warp-wide 32-way search
// (the same integers a count gives).
//
// What bounds it on an H100: the sort.  The cube moves 8 bytes per voxel
// through HBM (~0.9 ms at 623 x 768 x 768); a bitonic network over 1024
// values is 55 stages of 512 compare-exchanges per spaxel.  Run in shared
// memory, each compare-exchange costs two loads and up to two stores,
// several milliseconds of shared-memory traffic at that size.  So for
// spectra of up to 1024 channels (the register path) the sort runs in
// registers:
//
// - A block stages a tile of consecutive spaxels in shared memory with
//   4-byte cp.async copies, all in flight at once (neighbouring threads
//   read neighbouring spaxels of a channel row: coalesced).
// - One warp per spaxel pulls the spectrum into registers, R = npad / 32
//   values a lane (npad the length padded to a power of two, at least 32),
//   non-finite values and padding as +inf, and sorts them with a bitonic
//   network in a blocked layout (element lane * R + r), in the form whose
//   comparators all point one way.  Stages that pair elements of one lane
//   are two register min/max a pair, with no direction to choose; stages
//   that pair lanes use __shfl_xor_sync (15 of the 55 stages at npad =
//   1024).  R is a template parameter, so the values never leave
//   registers.
// - The sorted values go once to a per-warp row in shared memory, position
//   p at p + p / 32 (no bank conflicts for the blocked writes nor for the
//   lane-strided reads of the band sums).
// - A spectrum without a finite sample skips the sort: it comes out NaN.
// - The block writes x or NaN for every channel from the staged tile.
//
// Longer spectra keep a shared-memory network: one warp per spaxel sorts
// a padded copy in shared memory, or, beyond ~25,000 channels, in a global
// workspace, one spaxel per block over chunks of spaxels.  The plan
// (kernels/sigma_clip.py::plan) picks the path from nchan and the block's
// warps and spaxels from the shared memory; sct_sigma_clip checks it.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

using sct::cp_async4;
using sct::cp_async_wait_all;

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTile = 16;                   // spaxels (warps) per block
constexpr size_t kTileBudget = 113 * 1024;     // two blocks per SM
constexpr size_t kMaxShared = 232448;          // per block, sm_90
constexpr int kMaxR = 32;                      // register path: npad <= 1024
constexpr int kMaxWarps = 8;                   // register path, per block
constexpr int kMaxSpaxels = 64;                // register path, per block

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

// a row of sorted values: plain, or with position p at p + p / 32
template <bool kSwizzled>
struct Row {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return p[kSwizzled ? i + (i >> 5) : i];
  }
};

// first position >= lo that is lane's residue mod 32
__device__ __forceinline__ int first_of_lane(int lo, int lane) {
  return lo + ((lane - lo) & (kLanes - 1));
}

// sum of s[lo..hi) in the fixed lane order
template <class S>
__device__ float band_sum(S s, int lo, int hi, int lane) {
  float acc = 0.f;
  for (int i = first_of_lane(lo, lane); i < hi; i += kLanes)
    acc = __fadd_rn(acc, s[i]);
  return warp_sum(acc);
}

// sum of (s - mean)^2 over s[lo..hi) in the same order
template <class S>
__device__ float band_sq_sum(S s, int lo, int hi, float mean, int lane) {
  float acc = 0.f;
  for (int i = first_of_lane(lo, lane); i < hi; i += kLanes) {
    const float d = __fsub_rn(s[i], mean);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  return warp_sum(acc);
}

// number of the ascending s[0..n) below v (kStrict: s < v, else s <= v),
// the same integer a count over all n gives (0 when v is NaN), by one warp
// in 32-way steps: the lanes probe every g-th of the n unknown positions
// (g = ceil(n / 32)); the last probe that passes brackets the answer
// within g - 1 positions, which the next step probes.  Two steps up to
// 1056 values.
template <bool kStrict, class S>
__device__ int count_below(S s, int n, float v, int lane) {
  int lo = 0;                            // s[0..lo) is below v
  while (n > 0) {
    const int g = (n + kLanes - 1) / kLanes;
    const bool in = lane * g < n;
    const float a = in ? s[lo + lane * g] : 0.f;
    const bool p = in && (kStrict ? a < v : a <= v);
    const int c = __popc(__ballot_sync(kFull, p));
    if (c == 0) break;
    lo += (c - 1) * g + 1;
    n = min(g - 1, n - (c - 1) * g - 1);
  }
  return lo;
}

// The band iterations on the ascending finite values s[0..nfin) of one
// spaxel, by one warp; lane 0 stores the final band's value range.
template <class S>
__device__ void clip_band(S s, int nfin, float sigma, int maxiters,
                          int use_mean, int lane, int k, float* lo_val,
                          float* hi_val, int* keep_any) {
  int i_lo = 0, i_hi = nfin;
  for (int it = 0; it < maxiters; ++it) {
    const int cnt = i_hi - i_lo;
    if (cnt <= 0) break;                 // the band no longer changes
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
    i_lo = max(i_lo, count_below<true>(s, nfin, lo_v, lane));
    i_hi = min(i_hi, count_below<false>(s, nfin, hi_v, lane));
  }
  if (lane == 0) {
    const bool some = i_hi > i_lo;
    keep_any[k] = some;
    lo_val[k] = some ? s[i_lo] : 0.f;
    hi_val[k] = some ? s[i_hi - 1] : 0.f;
  }
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n >> 1);
}

// Ascending bitonic sort of 32 * R values held R a lane by one warp,
// element lane * R + r in v[r], in the form whose comparators all point
// one way: merging runs of length k starts with i against i ^ (k - 1)
// (the second run taken backwards), then i against i ^ j for j = k / 4 ..
// 1; the lower index always takes the minimum.  A pair inside one lane
// (below R) is two register min/max with nothing to choose; a pair across
// lanes is one __shfl_xor_sync and one min or max by the lane's side.
template <int R>
__device__ __forceinline__ void warp_sort(float (&v)[R], int lane) {
  constexpr int kLogN = 5 + ilog2(R);
#pragma unroll
  for (int lk = 1; lk <= kLogN; ++lk) {
    const int k = 1 << lk;
    if (k <= R) {                        // i ^ (k - 1) in this lane
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & (k >> 1)) continue;
        const int q = r ^ (k - 1);
        const float a = v[r], b = v[q];
        v[r] = fminf(a, b);
        v[q] = fmaxf(a, b);
      }
    } else {                             // in lane ^ (k / R - 1), R-1-r
      const int m = k / R - 1;
      const bool lower = (lane & (k / (2 * R))) == 0;
      if (R == 1) {
        const float p = __shfl_xor_sync(kFull, v[0], m);
        v[0] = lower ? fminf(v[0], p) : fmaxf(v[0], p);
      } else {
#pragma unroll
        for (int r = 0; r < R / 2; ++r) {
          const float a = v[r], b = v[R - 1 - r];
          const float pa = __shfl_xor_sync(kFull, b, m);
          const float pb = __shfl_xor_sync(kFull, a, m);
          v[r] = lower ? fminf(a, pa) : fmaxf(a, pa);
          v[R - 1 - r] = lower ? fminf(b, pb) : fmaxf(b, pb);
        }
      }
    }
#pragma unroll
    for (int lj = lk - 2; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < R) {                       // i ^ j in this lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & j) continue;
          const float a = v[r], b = v[r | j];
          v[r] = fminf(a, b);
          v[r | j] = fmaxf(a, b);
        }
      } else {                           // in lane ^ (j / R)
        const int m = j / R;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = __shfl_xor_sync(kFull, v[r], m);
          v[r] = lower ? fminf(v[r], p) : fmaxf(v[r], p);
        }
      }
    }
  }
}

// shared floats of the register path's block: the staged tile (spaxels x
// pitch), one sorted row a warp (33 R), lo, hi and keep_any per spaxel
__host__ __device__ __forceinline__ int tile_pitch(int nchan) {
  return nchan | 1;                      // odd: staging writes spread banks
}

size_t reg_shared_bytes(int nchan, int R, int warps, int spaxels) {
  return ((size_t)spaxels * tile_pitch(nchan) + (size_t)warps * 33 * R +
          3 * (size_t)spaxels) * sizeof(float);
}

// two blocks an SM at least: up to 128 registers a thread, so R = 32's
// values stay in registers
template <int R>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 2)
sigma_clip_reg_kernel(const float* __restrict__ x, int nchan, long long S,
                      int spaxels, float sigma, int maxiters, int use_mean,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int pitch = tile_pitch(nchan);
  const int nwarps = blockDim.x / kLanes;
  float* tile = smem;                                  // unsorted spectra
  float* rows = tile + (size_t)spaxels * pitch;        // nwarps x 33 R
  float* lo_val = rows + nwarps * 33 * R;
  float* hi_val = lo_val + spaxels;
  int* keep_any = (int*)(hi_val + spaxels);

  const long long p0 = (long long)blockIdx.x * spaxels;
  const int nsp = (int)min((long long)spaxels, S - p0);
  // thread t stages spaxel t % spaxels of channels t / spaxels, ... (the
  // plan's spaxels divide the block's threads)
  const int ks = threadIdx.x % spaxels;
  const int cstep = blockDim.x / spaxels;
  if (ks < nsp) {
    for (int c = threadIdx.x / spaxels; c < nchan; c += cstep)
      cp_async4(tile + ks * pitch + c, x + (long long)c * S + p0 + ks);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  float* row = rows + (threadIdx.x / kLanes) * 33 * R;
  for (int k = threadIdx.x / kLanes; k < nsp; k += nwarps) {
    const float* t = tile + k * pitch;
    float v[R];
    int fin = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + kLanes * r;   // any placement: the sort orders
      const float a = c < nchan ? t[c] : INFINITY;
      const bool f = isfinite(a);
      fin += f;
      v[r] = f ? a : INFINITY;
    }
    const int nfin = warp_sum_int(fin);
    if (nfin == 0) {                     // nothing to keep: skip the sort
      if (lane == 0) {
        keep_any[k] = 0;
        lo_val[k] = hi_val[k] = 0.f;
      }
      continue;
    }
    warp_sort<R>(v, lane);
    __syncwarp();                        // the last spaxel's reads are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = lane * R + r;
      row[p + (p >> 5)] = v[r];
    }
    __syncwarp();
    clip_band(Row<true>{row}, nfin, sigma, maxiters, use_mean, lane, k,
              lo_val, hi_val, keep_any);
  }
  __syncthreads();

  if (ks >= nsp) return;
  const bool any = keep_any[ks];
  const float lo = lo_val[ks], hi = hi_val[ks];
  for (int c = threadIdx.x / spaxels; c < nchan; c += cstep) {
    const float v = tile[ks * pitch + c];
    const bool keep = isfinite(v) && any && v >= lo && v <= hi;
    out[(long long)c * S + p0 + ks] = keep ? v : NAN;
  }
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

// Long spectra.  kInWork: the tile's rows live in this block's slice of
// the global workspace ``work`` instead of shared memory (a compile-time
// choice, so the shared-memory variant keeps shared-memory loads and
// stores)
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
    clip_band(Row<false>{s}, nfin, sigma, maxiters, use_mean, lane, k,
              lo_val, hi_val, keep_any);
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

// values a lane of the register path for nchan channels; 0: a longer
// spectrum, the shared-memory or workspace path
int reg_class(int nchan) {
  const int npad = pad_pow2(nchan);
  if (npad > kLanes * kMaxR) return 0;
  return npad <= kLanes ? 1 : npad / kLanes;
}

template <int R>
cudaError_t launch_reg(const float* x, int nchan, long long S, float sigma,
                       int maxiters, int use_mean, int warps, int spaxels,
                       float* out, cudaStream_t st) {
  const size_t bytes = reg_shared_bytes(nchan, R, warps, spaxels);
  cudaError_t err = cudaFuncSetAttribute(
      sigma_clip_reg_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (S + spaxels - 1) / spaxels;
  sigma_clip_reg_kernel<R><<<(unsigned)blocks, warps * kLanes, bytes, st>>>(
      x, nchan, S, spaxels, sigma, maxiters, use_mean, out);
  return cudaGetLastError();
}

}  // namespace

// Floats of global workspace per spaxel that sct_sigma_clip needs for
// spectra of nchan channels: 0 when a spaxel's rows fit in shared memory.
extern "C" long long sct_sigma_clip_work(int nchan) {
  if (nchan <= 0 || reg_class(nchan) > 0 ||
      per_spaxel_shared(nchan) <= kMaxShared)
    return 0;
  return (long long)row_floats(nchan, pad_pow2(nchan));
}

// Shared bytes of the register path's block for the plan (R, warps,
// spaxels) at nchan channels; -1 where nchan takes the longer path or the
// plan is not one this library launches (spaxels must divide the
// block's threads).
extern "C" long long sct_sigma_clip_smem(int nchan, int R, int warps,
                                         int spaxels) {
  if (nchan <= 0 || R != reg_class(nchan) || R == 0 || warps < 1 ||
      warps > kMaxWarps || spaxels < 1 || spaxels > kMaxSpaxels ||
      (warps * kLanes) % spaxels != 0)
    return -1;
  const size_t bytes = reg_shared_bytes(nchan, R, warps, spaxels);
  return bytes <= kMaxShared ? (long long)bytes : -1;
}

// x, out: (nchan, S) float32, contiguous; nchan >= 1.  (R, warps,
// spaxels): the plan; R = 0 for spectra longer than 1024 channels, whose
// work is chunk * sct_sigma_clip_work(nchan) floats, or null when that is
// 0; the spaxels then run chunk at a time.
extern "C" int sct_sigma_clip(const void* x, int nchan, long long S,
                              float sigma, int maxiters, int use_mean, int R,
                              int warps, int spaxels, void* work,
                              long long chunk, void* out, void* stream) {
  if (nchan <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (R != reg_class(nchan)) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    if (sct_sigma_clip_smem(nchan, R, warps, spaxels) < 0)
      return (int)cudaErrorInvalidValue;
    const float* xf = (const float*)x;
    float* of = (float*)out;
    cudaError_t err;
    switch (R) {
      case 1: err = launch_reg<1>(xf, nchan, S, sigma, maxiters, use_mean,
                                  warps, spaxels, of, st); break;
      case 2: err = launch_reg<2>(xf, nchan, S, sigma, maxiters, use_mean,
                                  warps, spaxels, of, st); break;
      case 4: err = launch_reg<4>(xf, nchan, S, sigma, maxiters, use_mean,
                                  warps, spaxels, of, st); break;
      case 8: err = launch_reg<8>(xf, nchan, S, sigma, maxiters, use_mean,
                                  warps, spaxels, of, st); break;
      case 16: err = launch_reg<16>(xf, nchan, S, sigma, maxiters, use_mean,
                                    warps, spaxels, of, st); break;
      default: err = launch_reg<32>(xf, nchan, S, sigma, maxiters, use_mean,
                                    warps, spaxels, of, st); break;
    }
    return (int)err;
  }
  const int npad = pad_pow2(nchan);
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

// Fused spectral smooth + 2-tap interpolation of a (nin, ncol) float32
// array along its first axis: out (nout, ncol), one column per spaxel.
//
// Replaces the TPU kernels spectral_cube_tpu/ops/banded_pallas.py::
// smooth_interp_strips_3d (#11, 3-D (nin, BY, 128) slabs) and
// ::smooth_interp_strips (#12, a flat (nin, S) view).  Both apply the
// composed operator M = I @ S as MXU strip matmuls to clean slabs and run
// the exact chain (normalized smooth with the 1e-6 den floor, then I with
// NaN poisoning) on slabs that hold NaN.  On this card they are one kernel
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
// flops per output.  Reaching the HBM rate takes tens of KB of loads in
// flight per SM, and the loads must overlap the compute.  So a persistent
// block (512 threads, as many blocks as fit on each SM) walks tiles of up
// to 32 neighbouring spectra (a whole nin x tile slab in shared memory)
// through a ring of two slabs: while it computes one tile, every load of
// the next is in flight as cp.async copies that no thread waits on one by
// one (16 bytes a copy where the rows are 16-byte aligned: ncol a multiple
// of 4, the base 16-byte aligned, tile a multiple of 4; else 4 bytes a
// copy).  The plan (kernels/smooth_interp.py::plan) chooses the tile, the
// copy form and the ring (one slab where two do not fit) from the shapes,
// and sct_smooth_interp checks it.  Per tile a pass over the slab flags
// which spectra hold a non-finite value, then every thread computes
// outputs of one spectrum from shared memory (a warp: 32 spectra of one
// output row) and writes them coalesced, a clean spectrum's outputs four
// at a time in independent chains.  M's taps arrive in rows padded to 4
// taps and are read as warp-uniform 16-byte loads, one for 4 FMAs.
// The compute keeps the first version's arithmetic: fmaf over the taps in
// order, and a dirty spectrum evaluates the smooth at the two samples each
// output needs, so the chain needs no scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

using sct::cp_async16;
using sct::cp_async4;
using sct::cp_async_commit;
using sct::cp_async_wait;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTile = 32;
constexpr size_t kMaxShared = 232448 - 1024; // per block, sm_90, less static
constexpr float kDenEps = 1e-6f;             // banded_pallas.py:45

struct Band {
  const int* start;
  const float* taps;                           // row r at r * pitch
  int width;
  int pitch;
};

// normalized smooth of spectrum `col` at channel c, from shared memory
__device__ float smooth_at(const float* xs, int pitch, int col, Band s,
                           int c) {
  const int s0 = __ldg(s.start + c);
  const float* w = s.taps + (size_t)c * s.pitch;
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

// kN clean outputs o, o + step, ... of spectrum `col`: sum_t M[o, t] x[t]
// with M's rows padded to a multiple of 4 taps, one uniform 16-byte load
// for 4 FMAs; kN independent chains, each in tap order
template <int kN>
__device__ __forceinline__ void clean_outputs(const float* xs, int pitch,
                                              int col, Band m, int o,
                                              int step, float* r) {
  const float4* w4[kN];
  const float* xc[kN];
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int oi = o + i * step;
    w4[i] = reinterpret_cast<const float4*>(m.taps + (size_t)oi * m.pitch);
    xc[i] = xs + __ldg(m.start + oi) * pitch + col;
    acc[i] = 0.f;
  }
  int u = 0;
  for (; u + 4 <= m.width; u += 4) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float4 q = __ldg(w4[i] + (u >> 2));
      acc[i] = fmaf(q.x, xc[i][u * pitch], acc[i]);
      acc[i] = fmaf(q.y, xc[i][(u + 1) * pitch], acc[i]);
      acc[i] = fmaf(q.z, xc[i][(u + 2) * pitch], acc[i]);
      acc[i] = fmaf(q.w, xc[i][(u + 3) * pitch], acc[i]);
    }
  }
  if (u < m.width) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float4 q = __ldg(w4[i] + (u >> 2));
      acc[i] = fmaf(q.x, xc[i][u * pitch], acc[i]);
      if (u + 1 < m.width)
        acc[i] = fmaf(q.y, xc[i][(u + 1) * pitch], acc[i]);
      if (u + 2 < m.width)
        acc[i] = fmaf(q.z, xc[i][(u + 2) * pitch], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = acc[i];
}

// issue the copies of tile p0's slab (nsp of its tile spectra) into xs:
// thread t copies segment t % segs of rows t / segs, ... (tile, a power of
// two up to 32, divides the block's threads)
template <bool kVec16>
__device__ __forceinline__ void stage_slab(const float* __restrict__ x,
                                           int nin, long long ncol, int tile,
                                           long long p0, int nsp,
                                           float* xs) {
  if (kVec16) {
    const int segs = tile >> 2;                // 16-byte segments a row
    const int g = threadIdx.x % segs;
    if (4 * g < nsp) {                         // nsp is a multiple of 4
      for (int c = threadIdx.x / segs; c < nin; c += blockDim.x / segs)
        cp_async16(xs + c * tile + 4 * g,
                   x + (long long)c * ncol + p0 + 4 * g);
    }
  } else {
    const int col = threadIdx.x % tile;
    if (col < nsp) {
      for (int c = threadIdx.x / tile; c < nin; c += blockDim.x / tile)
        cp_async4(xs + c * tile + col, x + (long long)c * ncol + p0 + col);
    }
  }
}

// kVec16: the slabs arrive in 16-byte copies (rows 16-byte aligned);
// stages: 2 (a ring: the next tile's copies fly during this tile's
// compute) or 1
template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
smooth_interp_kernel(const float* __restrict__ x, int nin, int nout,
                     long long ncol, int tile, int stages, Band m, Band s,
                     Band in, float* __restrict__ out) {
  extern __shared__ __align__(16) float slabs[];  // stages x nin x tile
  __shared__ int state[kMaxTile];                 // bit 0: finite, 1: not
  const int pitch = tile;
  const size_t slab = (size_t)nin * tile;
  const long long ntiles = (ncol + tile - 1) / tile;
  const int col = threadIdx.x % tile;
  const int row = threadIdx.x / tile;
  const int rows = blockDim.x / tile;
  auto width = [&](long long t) {
    return (int)min((long long)tile, ncol - t * tile);
  };

  long long t = blockIdx.x;
  if (t < ntiles)
    stage_slab<kVec16>(x, nin, ncol, tile, t * tile, width(t), slabs);
  cp_async_commit();
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    const long long next = t + gridDim.x;
    const int cur = stages == 2 ? (it & 1) : 0;
    const float* xs = slabs + cur * slab;
    if (stages == 2) {
      if (next < ntiles)
        stage_slab<kVec16>(x, nin, ncol, tile, next * tile, width(next),
                           slabs + (cur ^ 1) * slab);
      cp_async_commit();
      cp_async_wait<1>();                      // this tile's copies landed
    } else {
      cp_async_wait<0>();
    }
    if (threadIdx.x < tile) state[threadIdx.x] = 0;
    __syncthreads();

    const long long p0 = t * tile;
    const int nsp = width(t);
    int seen = 0;
    if (col < nsp) {
      for (int c = row; c < nin; c += rows)
        seen |= isfinite(xs[c * pitch + col]) ? 1 : 2;
    }
    if (seen) atomicOr(&state[col], seen);
    __syncthreads();

    const int st = state[col];
    int o = row;
    if (st == 1 && col < nsp) {                // clean: four chains at once
      for (; o + 3 * rows < nout; o += 4 * rows) {
        float r[4];
        clean_outputs<4>(xs, pitch, col, m, o, rows, r);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[(long long)(o + i * rows) * ncol + p0 + col] = r[i];
      }
    }
    for (; col < nsp && o < nout; o += rows) {
      float r;
      if (!(st & 1)) {
        r = NAN;
      } else if (!(st & 2)) {
        clean_outputs<1>(xs, pitch, col, m, o, rows, &r);
      } else {
        const int base = __ldg(in.start + o);
        const float* w = in.taps + (size_t)o * in.pitch;
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
    if (stages == 1 && next < ntiles) {
      __syncthreads();                         // the slab's reads are done
      stage_slab<kVec16>(x, nin, ncol, tile, next * tile, width(next),
                         slabs);
      cp_async_commit();
    }
    __syncthreads();                           // the next refill may start
  }
}

}  // namespace

// Shared bytes of a block for the plan (tile, vec16, stages) at nin rows
// and ncol columns; -1 where the plan is not one this library launches
// (tile not a power of two up to 32, 16-byte copies on rows that are not
// 16-byte aligned, stages not 1 or 2, or slabs past one block's shared
// memory).
extern "C" long long sct_smooth_interp_smem(int nin, long long ncol,
                                           int tile, int vec16, int stages) {
  if (nin <= 0 || ncol <= 0 || tile < 1 || tile > kMaxTile ||
      (tile & (tile - 1)) != 0 || (stages != 1 && stages != 2))
    return -1;
  if (vec16 && (tile % 4 != 0 || ncol % 4 != 0)) return -1;
  const size_t bytes = (size_t)stages * nin * tile * sizeof(float);
  return bytes <= kMaxShared ? (long long)bytes : -1;
}

// x: (nin, ncol) float32; bands: int32 starts and float32 (rows, width)
// taps of M (nout rows, each padded to a multiple of 4 taps and 16-byte
// aligned), S (nin rows) and I (nout rows); out: (nout, ncol).  (tile,
// vec16, stages): the plan; vec16 also needs x 16-byte aligned.
extern "C" int sct_smooth_interp(const void* x, int nin, int nout,
                                 long long ncol, int tile, int vec16,
                                 int stages, const void* m_start,
                                 const void* m_taps, int wm,
                                 const void* s_start, const void* s_taps,
                                 int ws, const void* i_start,
                                 const void* i_taps, int wi, void* out,
                                 void* stream) {
  if (nin <= 0 || nout <= 0 || ncol <= 0) return (int)cudaSuccess;
  const long long bytes =
      sct_smooth_interp_smem(nin, ncol, tile, vec16, stages);
  if (bytes < 0 || (vec16 && ((uintptr_t)x & 15) != 0) ||
      ((uintptr_t)m_taps & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Band m{(const int*)m_start, (const float*)m_taps, wm, (wm + 3) & ~3};
  const Band s{(const int*)s_start, (const float*)s_taps, ws, ws};
  const Band in{(const int*)i_start, (const float*)i_taps, wi, wi};
  const void* kernel = vec16 ? (const void*)smooth_interp_kernel<true>
                             : (const void*)smooth_interp_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks: as many as fit on each SM, or one per tile
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (ncol + tile - 1) / tile;
  const long long blocks =
      ntiles < (long long)sms * per_sm ? ntiles : (long long)sms * per_sm;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    smooth_interp_kernel<true><<<(unsigned)blocks, kThreads, bytes, st>>>(
        (const float*)x, nin, nout, ncol, tile, stages, m, s, in,
        (float*)out);
  else
    smooth_interp_kernel<false><<<(unsigned)blocks, kThreads, bytes, st>>>(
        (const float*)x, nin, nout, ncol, tile, stages, m, s, in,
        (float*)out);
  return (int)cudaGetLastError();
}

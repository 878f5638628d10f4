// Masked spectral moments 0/1/2 and the global-statistics planes in one
// pass over a (nchan, ny, nx) float32 cube.
//
// Replaces the TPU kernels spectral_cube_tpu/ops/moments.py::
// moments_012_pallas (the whole spectral axis of a tile in one VMEM block)
// and ::_moments_pallas_chunked (channel chunks combined in float32 pairs).
// One kernel serves both: every spaxel walks its spectrum in chunks of
// kChunk channels, runs the two-pass numerics of _moment_stats on each
// chunk, and adds the chunk into compensated (hi, lo) pairs exactly as the
// chunked TPU kernel does (moments.py:376-418).  With nchan <= kChunk there
// is one chunk, and the result is the single-block kernel's numerics up to
// rounding.  The planes are finalized at plane level in torch
// (ops/moments.py: _finalize_pairs, _recombine_statistics).
//
// What bounds it on an H100: device memory.  Each voxel is read once (4
// bytes, plus 1 for an include mask) for about 20 flops, far below the
// card's flop-per-byte line.  Reaching the HBM rate takes some 25 KB or
// more of loads in flight per SM, which one dependent scalar load per
// thread and channel cannot give.  So a block of kThreads spaxels streams
// its spectra through a ring of `stages` chunk tiles in shared memory
// (kChunk channels x the block's spaxels, and the include mask's bytes for
// the same chunk): while the block computes chunk k, the cp.async copies of
// chunks k + 1 ... k + stages - 1 are in flight, issued by all threads and
// waited on once per chunk (16 bytes a copy where npix % 4 == 0 and the
// base is 16-byte aligned, else 4 bytes; the mask's bytes 16 or 4 at a
// time where its rows allow, else read directly in pass 1).  Each thread
// owns one spaxel, a column of the tile: pass 1 (MomentAcc::add) reads its
// column and writes NaN into its excluded slots, pass 2 (end_chunk) reads
// the column again; a column is only ever touched by its own thread, so
// the one barrier a chunk guards the ring alone.  A whole chunk's two
// passes run with a fixed trip count (unrolled, several shared loads in
// flight), and two stages of 16 KB keep six blocks on an SM (blocks of
// 256 spaxels, or more stages, measured no faster on an H100).  A tail
// block copies and stores its in-range spaxels only.  The launch plan
// (kernels/moments.py::plan) chooses the copy forms and the ring's depth;
// sct_moments_smem checks it.
//
// Mask predicate: finiteness, one fused scalar comparison against a
// threshold (op codes in moments_acc.cuh), and an optional uint8 include
// array.  The per-spaxel arithmetic lives in moments_acc.cuh, shared with
// the fused pipeline kernel (conv_reproject.cu), whose planes equal these.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "moments_acc.cuh"

using sct::cp_async16;
using sct::cp_async4;
using sct::cp_async_commit;
using sct::cp_async_wait;

namespace {

using sct::kChunk;
constexpr int kThreads = 128;
constexpr int kMaxStages = 4;
constexpr long long kMaxShared = 232448 - 1024;  // per block, sm_90

// include-mask forms (kernels/moments.py MASK_FORMS)
constexpr int kMaskNone = 0, kMaskAsync16 = 1, kMaskAsync4 = 2,
              kMaskDirect = 3;

// bytes of one ring stage: the chunk tile, and the mask's when it is
// staged
__host__ __device__ constexpr long long stage_bytes(bool staged) {
  return (long long)kChunk * kThreads * (sizeof(float) + (staged ? 1 : 0));
}

// issue the copies of chunk c0 (cc channels) of spaxels p0 ... p0 + nsp - 1
// into one stage: `tile` (kChunk x kThreads floats) and `mtile` (kChunk x
// kThreads bytes)
template <bool kVec16, int kMask>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ data, const uint8_t* __restrict__ include,
    long long npix, long long p0, int nsp, int c0, int cc, float* tile,
    uint8_t* mtile) {
  const int t = threadIdx.x;
  if (kVec16) {
    // a row is kThreads / 4 copies, 4 rows at once; nsp is a multiple of
    // 4 (npix % 4 == 0)
    constexpr int segs = kThreads / 4;
    const int g = t % segs;
    if (4 * g < nsp) {
      for (int j = t / segs; j < cc; j += kThreads / segs)
        cp_async16(tile + j * kThreads + 4 * g,
                   data + (long long)(c0 + j) * npix + p0 + 4 * g);
    }
  } else if (t < nsp) {
    for (int j = 0; j < cc; ++j)
      cp_async4(tile + j * kThreads + t,
                data + (long long)(c0 + j) * npix + p0 + t);
  }
  if (kMask == kMaskAsync16) {
    constexpr int segs = kThreads / 16;  // 16 bytes a copy
    const int g = t % segs;
    if (16 * g < nsp) {                  // nsp is a multiple of 16
      for (int j = t / segs; j < cc; j += kThreads / segs)
        cp_async16(mtile + j * kThreads + 16 * g,
                   include + (long long)(c0 + j) * npix + p0 + 16 * g);
    }
  } else if (kMask == kMaskAsync4) {
    constexpr int segs = kThreads / 4;   // 4 bytes a copy
    const int g = t % segs;
    if (4 * g < nsp) {                   // nsp is a multiple of 4
      for (int j = t / segs; j < cc; j += kThreads / segs)
        cp_async4(mtile + j * kThreads + 4 * g,
                  include + (long long)(c0 + j) * npix + p0 + 4 * g);
    }
  }
}

// the fused comparison (sct::passes) without a switch: sgn * v > lim, or
// >= where the op is not strict; negation is exact, so v < thr is -v >
// -thr; any other op code is none, v > -inf, true for every finite v
struct Cmp {
  float sgn, lim;
  bool strict;
  __device__ explicit Cmp(int op, float thr)
      : sgn(op == sct::kCmpLt || op == sct::kCmpLe ? -1.f : 1.f),
        lim(op == sct::kCmpLt || op == sct::kCmpLe
                ? -thr
                : (op == sct::kCmpGt || op == sct::kCmpGe ? thr
                                                          : -INFINITY)),
        strict(op != sct::kCmpGe && op != sct::kCmpLe) {}
  __device__ __forceinline__ bool operator()(float v) const {
    const float sv = sgn * v;
    return strict ? sv > lim : sv >= lim;
  }
};

// both passes over one chunk of a spaxel's column (slot j at col[j *
// kThreads]): pass 1 (s0, s1, count, min, max; excluded slots become NaN),
// then pass 2 about the chunk's centroid estimate (_moment_stats).  kCC:
// the chunk's channels when fixed, else 0 and cc
template <int kCC, int kMask>
__device__ __forceinline__ void chunk_passes(
    sct::MomentAcc& acc, float* col, const uint8_t* mcol,
    const uint8_t* __restrict__ include, long long npix, long long p,
    int c0, int cc, const float* __restrict__ xc, Cmp passes,
    int with_stats) {
  constexpr bool kStaged = kMask == kMaskAsync16 || kMask == kMaskAsync4;
  const int n = kCC ? kCC : cc;
  acc.begin_chunk();
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float v = col[j * kThreads];
    bool ok = isfinite(v) && passes(v);
    if (kStaged) ok = ok && mcol[j * kThreads] != 0;
    if (kMask == kMaskDirect)
      ok = ok && include[(long long)(c0 + j) * npix + p] != 0;
    // the slot keeps v where it is included, NaN where not
    acc.add(v, ok, __ldg(xc + c0 + j));
    if (!ok) col[j * kThreads] = NAN;
  }
  acc.end_chunk(col, kThreads, n, xc + c0, with_stats != 0);
}

// six blocks an SM: two 16 KB stages leave room for six
template <bool kVec16, int kMask>
__global__ void __launch_bounds__(kThreads, 6)
moments_kernel(const float* __restrict__ data, const float* __restrict__ xc,
               const uint8_t* __restrict__ include, int nchan,
               long long npix, int cmp_op, float thr, int with_stats,
               int stages, float* __restrict__ planes,
               int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr bool kStaged = kMask == kMaskAsync16 || kMask == kMaskAsync4;
  constexpr long long kTileBytes = (long long)kChunk * kThreads * 4;
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const int nsp = (int)min((long long)kThreads, npix - p0);
  const long long p = p0 + t;
  const bool live = t < nsp;
  const int nchunks = (nchan + kChunk - 1) / kChunk;
  auto tile_of = [&](int s) {
    return reinterpret_cast<float*>(ring + s * stage_bytes(kStaged));
  };
  auto mtile_of = [&](int s) {
    return ring + s * stage_bytes(kStaged) + kTileBytes;
  };
  auto issue = [&](int k) {
    if (k < nchunks) {
      const int s = k % stages;
      stage_chunk<kVec16, kMask>(data, include, npix, p0, nsp, k * kChunk,
                                 min(kChunk, nchan - k * kChunk), tile_of(s),
                                 mtile_of(s));
    }
    cp_async_commit();
  };

  for (int k = 0; k < stages - 1; ++k) issue(k);

  const Cmp passes(cmp_op, thr);
  sct::MomentAcc acc;
  acc.init();
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait(stages - 2);  // this thread's copies of chunk k landed
    __syncthreads();            // everyone's; and chunk k - 1 is done
    issue(k + stages - 1);      // into the stage chunk k - 1 used
    const int s = k % stages;
    const int c0 = k * kChunk;
    const int cc = min(kChunk, nchan - c0);
    float* col = tile_of(s) + t;
    const uint8_t* mcol = mtile_of(s) + t;
    if (live) {
      // a whole chunk's loops have a fixed trip count, so the compiler
      // unrolls them and keeps several shared loads in flight
      if (cc == kChunk)
        chunk_passes<kChunk, kMask>(acc, col, mcol, include, npix, p, c0,
                                    kChunk, xc, passes, with_stats);
      else
        chunk_passes<0, kMask>(acc, col, mcol, include, npix, p, c0, cc, xc,
                               passes, with_stats);
    }
  }
  cp_async_wait(0);
  if (live) acc.store(planes, count, npix, p, with_stats != 0);
}

template <bool kVec16, int kMask>
int launch(const void* data, const void* xc, const void* include, int nchan,
           long long npix, int cmp_op, float thr, int with_stats, int stages,
           long long smem, void* planes, void* count, cudaStream_t st) {
  auto kernel = moments_kernel<kVec16, kMask>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const float*)data, (const float*)xc, (const uint8_t*)include, nchan,
      npix, cmp_op, thr, with_stats, stages, (float*)planes, (int*)count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sct_moments_chunk() { return kChunk; }

// Shared bytes of a block for the plan (stages, vec16, mask form) at npix
// spaxels; -1 where the plan is not one this library launches (stages not
// 2..kMaxStages, 16-byte data copies with npix % 4 != 0, staged mask bytes
// whose rows are not 16- or 4-byte aligned, or past one block's shared
// memory).
extern "C" long long sct_moments_smem(long long npix, int stages, int vec16,
                                      int mask) {
  if (npix <= 0 || stages < 2 || stages > kMaxStages || mask < kMaskNone ||
      mask > kMaskDirect)
    return -1;
  if (vec16 && npix % 4 != 0) return -1;
  if ((mask == kMaskAsync16 && npix % 16 != 0) ||
      (mask == kMaskAsync4 && npix % 4 != 0))
    return -1;
  const long long bytes =
      stages * stage_bytes(mask == kMaskAsync16 || mask == kMaskAsync4);
  return bytes <= kMaxShared ? bytes : -1;
}

// planes: (6 or 10, npix) float32; count: (npix,) int32; (stages, vec16,
// mask): the plan, vec16 also needs data 16-byte aligned, mask form 1 the
// include array 16-byte aligned and form 2 4-byte aligned.  Returns the
// launch's cudaGetLastError().
extern "C" int sct_moments(const void* data, const void* xc,
                           const void* include, int nchan, long long npix,
                           int cmp_op, float thr, int with_stats, int stages,
                           int vec16, int mask, void* planes, void* count,
                           void* stream) {
  if (npix <= 0) return (int)cudaSuccess;
  const long long smem = sct_moments_smem(npix, stages, vec16, mask);
  if (smem < 0 || (vec16 && ((uintptr_t)data & 15) != 0) ||
      ((include == nullptr) != (mask == kMaskNone)) ||
      (mask == kMaskAsync16 && ((uintptr_t)include & 15) != 0) ||
      (mask == kMaskAsync4 && ((uintptr_t)include & 3) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SCT_MOMENTS_LAUNCH(V, M)                                           \
  return launch<V, M>(data, xc, include, nchan, npix, cmp_op, thr,         \
                      with_stats, stages, smem, planes, count, st)
  if (vec16) {
    switch (mask) {
      case kMaskNone: SCT_MOMENTS_LAUNCH(true, kMaskNone);
      case kMaskAsync16: SCT_MOMENTS_LAUNCH(true, kMaskAsync16);
      case kMaskAsync4: SCT_MOMENTS_LAUNCH(true, kMaskAsync4);
      default: SCT_MOMENTS_LAUNCH(true, kMaskDirect);
    }
  }
  switch (mask) {
    case kMaskNone: SCT_MOMENTS_LAUNCH(false, kMaskNone);
    case kMaskAsync16: SCT_MOMENTS_LAUNCH(false, kMaskAsync16);
    case kMaskAsync4: SCT_MOMENTS_LAUNCH(false, kMaskAsync4);
    default: SCT_MOMENTS_LAUNCH(false, kMaskDirect);
  }
#undef SCT_MOMENTS_LAUNCH
}

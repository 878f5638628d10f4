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
// card's flop-per-byte line.  The design keeps that one read: one thread per
// spaxel with x fastest, so a warp reads 128 contiguous bytes per channel;
// the chunk is kept in shared memory, each thread in its own column (no
// barrier needed), for the second pass; the pair arithmetic runs once per
// chunk, not per voxel.
//
// Mask predicate: finiteness, one fused scalar comparison against a
// threshold (op codes in moments_acc.cuh), and an optional uint8 include
// array.  The per-spaxel arithmetic lives in moments_acc.cuh, shared with
// the fused pipeline kernel (conv_reproject.cu), whose planes equal these.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moments_acc.cuh"

namespace {

using sct::kChunk;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ data, const float* __restrict__ xc,
               const uint8_t* __restrict__ include, int nchan,
               long long npix, int cmp_op, float thr, int with_stats,
               float* __restrict__ planes, int* __restrict__ count) {
  __shared__ float chunk[kChunk][kThreads];
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int t = threadIdx.x;

  sct::MomentAcc acc;
  acc.init();
  for (int c0 = 0; c0 < nchan; c0 += kChunk) {
    const int cc = min(kChunk, nchan - c0);
    // pass 1: s0, s1, count, min, max; the chunk stays in shared memory,
    // each thread in its own column (no barrier needed)
    acc.begin_chunk();
    for (int j = 0; j < cc; ++j) {
      const long long idx = (long long)(c0 + j) * npix + p;
      const float v = data[idx];
      bool ok = isfinite(v) && sct::passes(v, cmp_op, thr);
      if (include != nullptr) ok = ok && include[idx] != 0;
      acc.add(v, ok, __ldg(xc + c0 + j), &chunk[j][t]);
    }
    // pass 2 about the chunk's centroid estimate (_moment_stats)
    acc.end_chunk(&chunk[0][t], kThreads, cc, xc + c0, with_stats != 0);
  }
  acc.store(planes, count, npix, p, with_stats != 0);
}

}  // namespace

extern "C" int sct_moments_chunk() { return kChunk; }

// planes: (6 or 10, npix) float32; count: (npix,) int32.  Returns the
// launch's cudaGetLastError().
extern "C" int sct_moments(const void* data, const void* xc,
                           const void* include, int nchan, long long npix,
                           int cmp_op, float thr, int with_stats,
                           void* planes, void* count, void* stream) {
  if (npix <= 0) return (int)cudaSuccess;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  moments_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const float*)xc, (const uint8_t*)include, nchan,
      npix, cmp_op, thr, with_stats, (float*)planes, (int*)count);
  return (int)cudaGetLastError();
}

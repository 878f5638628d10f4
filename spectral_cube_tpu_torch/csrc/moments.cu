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
// threshold (op codes below), and an optional uint8 include array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 128;

// comparison op codes shared with kernels/moments.py
constexpr int kCmpNone = 0, kCmpGt = 1, kCmpGe = 2, kCmpLt = 3, kCmpLe = 4;

// Error-free transforms (ops/df32.py).  The explicit _rn intrinsics keep
// the compiler from contracting them into FMAs, which would break exactness.
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// a * b = p + e exactly; fmaf gives the same pair as Dekker's split.
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  e = fmaf(a, b, -p);
}

// (h, l) += (vh, vl), the acc2 step of moments.py:386-389
__device__ __forceinline__ void acc2(float& h, float& l, float vh, float vl) {
  float s, e;
  two_sum(h, vh, s, e);
  l = __fadd_rn(l, __fadd_rn(e, vl));
  h = s;
}

// (xh, xl) / y for a float y, df32.df_div with a zero low part
__device__ __forceinline__ void df_div1(float xh, float xl, float y,
                                        float& qh, float& ql) {
  const float q1 = __fdiv_rn(xh, y);
  float p, e;
  two_prod(q1, y, p, e);
  float ph, pl;
  two_sum(p, e, ph, pl);
  float s, t;
  two_sum(xh, -ph, s, t);
  t = __fadd_rn(t, __fadd_rn(xl, -pl));
  float rh, rl;
  two_sum(s, t, rh, rl);
  const float q2 = __fdiv_rn(__fadd_rn(rh, rl), y);
  two_sum(q1, q2, qh, ql);
}

__device__ __forceinline__ bool passes(float v, int op, float thr) {
  switch (op) {
    case kCmpGt: return v > thr;
    case kCmpGe: return v >= thr;
    case kCmpLt: return v < thr;
    case kCmpLe: return v <= thr;
    default: return true;
  }
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ data, const float* __restrict__ xc,
               const uint8_t* __restrict__ include, int nchan,
               long long npix, int cmp_op, float thr, int with_stats,
               float* __restrict__ planes, int* __restrict__ count) {
  __shared__ float chunk[kChunk][kThreads];
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int t = threadIdx.x;

  float s0h = 0.f, s0l = 0.f, s1h = 0.f, s1l = 0.f, s2h = 0.f, s2l = 0.f;
  float qh = 0.f, ql = 0.f;
  float mn = INFINITY, mx = -INFINITY;
  int cnt = 0;

  for (int c0 = 0; c0 < nchan; c0 += kChunk) {
    const int cc = min(kChunk, nchan - c0);
    // pass 1: s0, s1, count, min, max; the chunk stays in shared memory
    // with NaN marking excluded voxels (an included value is finite)
    float s0 = 0.f, s1 = 0.f;
    int n = 0;
    for (int j = 0; j < cc; ++j) {
      const long long idx = (long long)(c0 + j) * npix + p;
      const float v = data[idx];
      bool ok = isfinite(v) && passes(v, cmp_op, thr);
      if (include != nullptr) ok = ok && include[idx] != 0;
      chunk[j][t] = ok ? v : NAN;
      if (ok) {
        s0 += v;
        s1 += v * __ldg(xc + c0 + j);
        ++n;
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    // pass 2 about the chunk's centroid estimate (_moment_stats)
    const float safe = (s0 == 0.f) ? 1.f : s0;
    const float m1 = s1 / safe;
    const float mi = s0 / (float)max(n, 1);
    float r1 = 0.f, s2c = 0.f, d2 = 0.f;
    for (int j = 0; j < cc; ++j) {
      const float v = chunk[j][t];
      if (isnan(v)) continue;
      const float d = __ldg(xc + c0 + j) - m1;
      r1 += v * d;
      s2c += v * (d * d);
      const float dev = v - mi;
      d2 += dev * dev;
    }
    cnt += n;
    // exact conversion of the chunk into the global-centered sums:
    // S1 += s0*m1 + R1, S2 += s0*m1^2 + 2*m1*R1 + s2c (moments.py:391-396)
    float p1h, p1l, t2h, t2l;
    two_prod(s0, m1, p1h, p1l);
    two_prod(p1h, m1, t2h, t2l);
    acc2(s0h, s0l, s0, 0.f);
    acc2(s1h, s1l, p1h, __fadd_rn(p1l, r1));
    acc2(s2h, s2l, t2h,
         __fadd_rn(__fadd_rn(t2l, __fmul_rn(p1l, m1)),
                   __fmul_rn(__fmul_rn(2.f, m1), r1)));
    acc2(s2h, s2l, s2c, 0.f);
    if (with_stats) {
      // chunk sum of squares as d2 + s0^2/n, the division kept as a pair
      // (moments.py:407-418)
      float sqh, sql, dh, dl;
      two_prod(s0, s0, sqh, sql);
      df_div1(sqh, sql, (float)max(n, 1), dh, dl);
      acc2(qh, ql, d2, 0.f);
      acc2(qh, ql, dh, dl);
    }
  }

  planes[0 * npix + p] = s0h;
  planes[1 * npix + p] = s0l;
  planes[2 * npix + p] = s1h;
  planes[3 * npix + p] = s1l;
  planes[4 * npix + p] = s2h;
  planes[5 * npix + p] = s2l;
  if (with_stats) {
    planes[6 * npix + p] = qh;
    planes[7 * npix + p] = ql;
    planes[8 * npix + p] = mn;
    planes[9 * npix + p] = mx;
  }
  count[p] = cnt;
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

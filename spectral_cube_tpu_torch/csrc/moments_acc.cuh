// Per-spaxel masked moment and statistics accumulation, shared by the
// moments kernel (moments.cu) and the fused convolve + reproject + moments
// kernel (conv_reproject.cu), so that both produce the same planes bit for
// bit.
//
// A spaxel's spectrum is walked in chunks of kChunk channels.  Pass 1 (add)
// sums s0 = sum w and s1 = sum w * x over the chunk and keeps each included
// value (NaN for an excluded one) in a slot the caller owns; pass 2
// (end_chunk) re-reads the slots for the second moment about the chunk's own
// centroid estimate, and adds the chunk into compensated (hi, lo) float32
// pairs exactly as the chunked TPU kernel does
// (spectral_cube_tpu/ops/moments.py:376-418).  The planes are finalized at
// plane level in torch (ops/moments.py: _finalize_pairs).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sct {

constexpr int kChunk = 32;

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

struct MomentAcc {
  float s0h, s0l, s1h, s1l, s2h, s2l, qh, ql, mn, mx;
  int cnt;
  float s0, s1;  // the current chunk's pass-1 sums
  int n;

  __device__ __forceinline__ void init() {
    s0h = s0l = s1h = s1l = s2h = s2l = qh = ql = 0.f;
    mn = INFINITY;
    mx = -INFINITY;
    cnt = 0;
  }

  __device__ __forceinline__ void begin_chunk() {
    s0 = 0.f;
    s1 = 0.f;
    n = 0;
  }

  // pass 1 for one voxel of value v at centered coordinate x; the slot
  // keeps v for pass 2, or NaN when the voxel is excluded (an included
  // value is finite)
  __device__ __forceinline__ void add(float v, bool ok, float x,
                                      float* slot) {
    *slot = ok ? v : NAN;
    add(v, ok, x);
  }

  // pass 1 without a slot: the caller re-reads the chunk for pass 2
  __device__ __forceinline__ void add(float v, bool ok, float x) {
    if (ok) {
      s0 += v;
      s1 += v * x;
      ++n;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }

  // pass 2 over the chunk's cc slots (slot j at slots[j * stride], its
  // coordinate at xc[j]), then the exact conversion of the chunk into the
  // global-centered sums: S1 += s0*m1 + R1, S2 += s0*m1^2 + 2*m1*R1 + s2c
  // (moments.py:391-396)
  __device__ __forceinline__ void end_chunk(const float* slots, int stride,
                                            int cc,
                                            const float* __restrict__ xc,
                                            bool with_stats) {
    end_chunk_of([=](int j) { return slots[j * stride]; }, cc, xc,
                 with_stats);
  }

  // pass 2 with slot j given by slot(j): the included value, or NaN
  template <class Slot>
  __device__ __forceinline__ void end_chunk_of(Slot slot, int cc,
                                               const float* __restrict__ xc,
                                               bool with_stats) {
    const float safe = (s0 == 0.f) ? 1.f : s0;
    const float m1 = s1 / safe;
    const float mi = s0 / (float)max(n, 1);
    float r1 = 0.f, s2c = 0.f, d2 = 0.f;
    for (int j = 0; j < cc; ++j) {
      const float v = slot(j);
      if (isnan(v)) continue;
      const float d = __ldg(xc + j) - m1;
      r1 += v * d;
      s2c += v * (d * d);
      const float dev = v - mi;
      d2 += dev * dev;
    }
    cnt += n;
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

  // planes: (6 or 10, npix) float32; count: (npix,) int32
  __device__ __forceinline__ void store(float* __restrict__ planes,
                                        int* __restrict__ count,
                                        long long npix, long long p,
                                        bool with_stats) const {
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
};

}  // namespace sct

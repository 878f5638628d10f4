// Axis-aligned 2-tap bilinear resample of a (nchan, ny_in, nx_in) float32
// cube straight from raw, NaN-carrying data.
//
// Replaces the TPU kernels spectral_cube_tpu/ops/banded_pallas.py::
// per_channel_resample_raw_strips (rectangular 2-tap matrices on the MXU)
// and ::per_channel_shift_lerp (a pure translation as in-VMEM rolls).  On
// this card both are the same gather: output row i reads input rows y0[i]
// and y0[i] + 1 with weights 1 - wy[i] and wy[i], output column j reads
// x0[j] and x0[j] + 1 likewise; a translation is the case y0[i] = i + sy
// with a constant weight.
//
//   out = sum w * nan_to_num(Z)            (y taps first, then x taps)
//   out = NaN where sum w * isnan(Z) > 1e-6, where valid_plane is 0 and
//         where zvalid[channel] is 0       (banded_pallas.py:995-1006)
//
// A tap of weight 0 adds 0 to the NaN weight, so it never poisons
// (banded_pallas.py:1559-1561).
//
// What bounds it on an H100: device memory, one read of the input and one
// write of the output (~8 bytes per voxel for ~12 flops).  So each input
// value should leave device memory once, and enough copies must be in
// flight to reach the HBM rate.  A block owns a strip of one channel's
// output: `width` columns (128, or 64 / 32 where the plan narrows it) by a
// tile of rows, walked down in steps of kStepRows rows (two a warp).  The
// strip's input span of each input row a step needs is copied into a slot
// of a ring in shared memory with cp.async (16 bytes a copy where the
// input rows are 16-byte aligned, else 4; or, where a strip's columns lie
// too far apart for a span, a listed set of columns 4 bytes a copy), and
// the copies of the next `depth` steps are in flight while a step
// computes.  The host (kernels/resample2.py::plan) lays out the ring: it
// gives every step the rows to load and their slots, and every output row
// the slots of its two input rows, keeping a row resident for as long as
// the next steps read it.  So an input row that output rows i and i + 1
// both read (a translation, an equal y0, a flip) is loaded once, and any
// y0 (clipped, non-monotone, downsampling) stages the rows it needs.  The
// strip's x taps (staged positions and weights) sit in registers; the
// tile's tables (each row's slots and y taps, validity bits, one word per
// 32 outputs, and the ring's loads) are copied into shared memory once, so
// that no step waits on a chain of global reads; a channel whose zvalid
// is 0 writes NaN and reads nothing.
// A row is first computed without NaN weights; only a warp with a
// non-finite output (so a non-finite sample) recomputes it with them and
// nan_to_num (the identity, and weights of 0, on finite samples, so the
// bits are the same).
// A lane computes the outputs 32 apart (lane + 32 k), so the x gather
// reads consecutive shared words across a warp (4 adjacent outputs a lane
// would read at a stride of 4 words: 4-way bank conflicts); with 128
// columns a lane's 4 results pass through a per-warp buffer and leave as
// one 16-byte streaming store of 4 adjacent outputs where nx_out % 4 == 0,
// else each store of a warp writes 32 adjacent floats.  The raw entry adds
// in the plain version's order with __fmul_rn/__fadd_rn, so it equals
// kernels/resample2.py::resample2_plain bit for bit.
//
// The filled entry (sct_resample2 with wz set) replaces
// spectral_cube_tpu/ops/banded_pallas.py::per_channel_resample_strips, the
// staged path of a reprojection onto a new spectral axis
// (ops/regrid.py:351-408): the data come NaN-filled (fz) with a separate
// NaN-weight plane (wz, the spectrally lerped NaN mask, so fractional),
// and
//
//   out = sum w * fz,  NaN where sum w * wz > 1e-6, where valid_plane is 0
//         and where zvalid[channel] is 0
//
// with the same taps, the poison test only in channels whose flag is 1.
// The caller flags every channel whose wz is not all zero; an unflagged
// channel never reads wz, as the TPU kernel skips its weight pass for an
// all-zero block (banded_pallas.py:876), and the plain version skips the
// test in the same channels.  Bound by device memory: fz read once, wz
// once in each flagged channel, out written once.  It is the raw entry's
// kernel (kFilled): the same host-planned ring, with a second plane of
// slots for wz (kernels/resample2.py plans it where any channel is
// flagged), so a staged row's span of fz, and in a flagged channel the
// same span of wz, is copied once per strip by the same cp.async forms;
// an unflagged channel issues no wz copy and runs no poison test, and the
// channel flags travel in the one packed taps buffer.  Values take the
// raw entry's finite fast path (fz holds no NaN to drop).  Both entries
// add in the plain version's order with __fmul_rn/__fadd_rn (no FMA
// contraction), so the filled entry and
// kernels/resample2.py::resample2_filled_plain agree bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "cp_async.cuh"

using sct::cp_async16;
using sct::cp_async4;
using sct::cp_async_commit;
using sct::cp_async_wait;

// A launch of either entry: the packed taps (one device buffer laid out by
// kernels/resample2.py::pack_taps) and the plan.  The filled entry sets wz
// (and planes to 2 where a channel is flagged).
struct SctResample2 {
  const float* raw;       // (nchan, ny_in, nx_in): raw data, or fz
  const float* wz;        // fz's NaN weights (filled entry), else null
  float* out;             // (nchan, ny_out, nx_out)
  const int* rows;        // (ny_out, 2): slot_a | slot_b << 16, wy bits
  const int* cols;        // (strips * width, 2): pos_a | pos_b << 16, wx
  const int* strips;      // (strips, 2): first staged column, staged count
  const int* list;        // (strips, pitch): staged columns (list form)
  const int* step_off;    // (tiles * steps + 1,) offsets into loads
  const int* loads;       // (loads, 2): input row, slot
  const unsigned* valid;  // (ny_out, vwords): validity bits
  const int* zvalid;      // (nchan,)
  const int* wflags;      // (nchan,): 1 where wz takes the poison test
  int nchan, ny_in, nx_in, ny_out, nx_out;
  int width, tile_rows, tiles, steps, depth, slots, pitch, form, store16,
      vwords, max_loads;  // max_loads: the most loads a tile lists
  int planes;             // planes of ring slots: 2 holds wz beside fz
};

namespace {

constexpr float kPoison = 1e-6f;   // banded_pallas.py:45

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// a * ga + b * fa in the plain version's order: two rounded products, one
// rounded sum
__device__ __forceinline__ float lerp_rn(float ga, float a, float fa,
                                         float b) {
  return __fadd_rn(__fmul_rn(ga, a), __fmul_rn(fa, b));
}

// staging forms (kernels/resample2.py FORMS)
constexpr int kSpan16 = 0, kSpan4 = 1, kList = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kStepRows = kWarps * kRowsPerWarp;
constexpr int kMaxDepth = 3;
constexpr int kMaxSlots = 2 * kStepRows * (kMaxDepth + 1);
constexpr long long kMaxShared = 232448 - 1024;  // per block, sm_90

// kW outputs a lane (columns lane + 32 k of the strip); kStore16: they
// leave as one 16-byte store of 4 adjacent outputs (kW == 4); kFilled: the
// filled entry (fz in a.raw, wz beside it), else the raw entry
template <int kW, bool kStore16, bool kFilled>
__global__ void __launch_bounds__(kThreads, 4)
resample2_kernel(const SctResample2 a) {
  extern __shared__ __align__(16) float ring[];  // planes x slots x pitch
  constexpr int W = 32 * kW;
  const int nstrips = (a.nx_out + W - 1) / W;
  int b = blockIdx.x;
  const int tile = b % a.tiles;
  b /= a.tiles;
  const int strip = b % nstrips;
  const int c = b / nstrips;
  const int j0 = strip * W;
  const int i0 = tile * a.tile_rows;
  const int i1 = min(i0 + a.tile_rows, a.ny_out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* outc = a.out + (long long)c * a.ny_out * a.nx_out;

  if (!a.zvalid[c]) {
    for (int i = i0 + warp; i < i1; i += kWarps)
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < a.nx_out) __stcs(outc + (long long)i * a.nx_out + j, NAN);
      }
    return;
  }
  // the filled entry's channel flag: stage wz and test the NaN weight
  const bool wflag = kFilled && __ldg(a.wflags + c) != 0;

  // the strip's x taps: staged positions and weights, once per block
  int pa[kW], pb[kW];
  float fx[kW];  // gx = 1 - fx is formed where it is used (registers)
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const int2 ct = __ldg(reinterpret_cast<const int2*>(a.cols) +
                          strip * W + lane + 32 * k);
    pa[k] = ct.x & 0xffff;
    pb[k] = ct.x >> 16;
    fx[k] = __int_as_float(ct.y);
  }
  const long long plane = (long long)a.ny_in * a.nx_in;
  const float* Z = a.raw + c * plane;
  const float* WZ = kFilled ? a.wz + c * plane : nullptr;
  const int s_lo = __ldg(a.strips + 2 * strip);
  const int span = __ldg(a.strips + 2 * strip + 1);
  const int* lst = a.list + (long long)strip * a.pitch;
  // wz's slots: the second plane of the ring
  float* wring = ring + a.slots * a.pitch;

  // the tile's tables in shared memory, once per block, so that a step's
  // chain of dependent reads stays on the SM: each row's slots and wy, the
  // strip's validity words, the steps' load offsets and the loads
  int* trows = reinterpret_cast<int*>(
      ring + a.planes * a.slots * a.pitch + (kStore16 ? kWarps * 128 : 0));
  unsigned* tvalid = reinterpret_cast<unsigned*>(trows + 2 * a.tile_rows);
  int* tstep = reinterpret_cast<int*>(tvalid + kW * a.tile_rows);
  int* tloads = tstep + ((a.steps + 2) & ~1);
  {
    const int nrows = i1 - i0;
    for (int q = threadIdx.x; q < 2 * nrows; q += kThreads)
      trows[q] = __ldg(a.rows + 2 * i0 + q);
    for (int q = threadIdx.x; q < kW * nrows; q += kThreads) {
      const int w = (j0 >> 5) + q % kW;
      tvalid[q] = w < a.vwords
          ? __ldg(a.valid + (long long)(i0 + q / kW) * a.vwords + w)
          : 0u;
    }
    const int* so = a.step_off + tile * a.steps;
    const int e0 = __ldg(so);
    for (int q = threadIdx.x; q <= a.steps; q += kThreads)
      tstep[q] = __ldg(so + q) - e0;
    const int ne = __ldg(so + a.steps) - e0;
    for (int q = threadIdx.x; q < 2 * ne; q += kThreads)
      tloads[q] = __ldg(a.loads + 2 * e0 + q);
    __syncthreads();
  }

  // one staged row's span (or listed columns) from src into dst, by lane
  auto stage = [&](float* dst, const float* src) {
    if (a.form == kSpan16) {
      for (int q = 4 * lane; q < span; q += 128)
        cp_async16(dst + q, src + s_lo + q);
    } else if (a.form == kSpan4) {
      for (int q = lane; q < span; q += 32)
        cp_async4(dst + q, src + s_lo + q);
    } else {
      for (int q = lane; q < span; q += 32)
        cp_async4(dst + q, src + __ldg(lst + q));
    }
  };
  // issue the copies of step s: each warp one listed row at a time
  auto issue = [&](int s) {
    if (s < a.steps) {
      const int e1 = tstep[s + 1];
      for (int e = tstep[s] + warp; e < e1; e += kWarps) {
        const int2 ld = reinterpret_cast<const int2*>(tloads)[e];
        const long long row = (long long)ld.x * a.nx_in;
        stage(ring + ld.y * a.pitch, Z + row);
        if (kFilled && wflag) stage(wring + ld.y * a.pitch, WZ + row);
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < a.depth; ++s) issue(s);
  float* buf = ring + a.planes * a.slots * a.pitch + warp * 128;
  for (int s = 0; s < a.steps; ++s) {
    cp_async_wait(a.depth - 1);  // this thread's copies of step s landed
    __syncthreads();             // everyone's; and step s - 1 is done
    issue(s + a.depth);          // into slots no step s ... s + depth reads
    // one row at a time: unrolled, the rows spill at 64 registers
#pragma unroll 1
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = i0 + s * kStepRows + warp + kWarps * r;
      if (i >= i1) break;
      const int2 rw = reinterpret_cast<const int2*>(trows)[i - i0];
      const int sa = rw.x & 0xffff, sb = rw.x >> 16;
      const float* A = ring + sa * a.pitch;
      const float* B = ring + sb * a.pitch;
      const float fy = __int_as_float(rw.y), gy = __fsub_rn(1.f, fy);
      const unsigned* vrow = tvalid + (i - i0) * kW;
      // first without NaN weights: y taps, then x taps (the order of My @
      // Z @ Mx^T).  A non-finite sample makes its output non-finite (0 *
      // NaN, 0 * inf and inf - inf are NaN); where every output of the
      // warp is finite, every sample was, nan_to_num is the identity and
      // the NaN weights are 0, so these are the plain version's bits
      float v[kW];
      bool finite = true;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        v[k] = lerp_rn(__fsub_rn(1.f, fx[k]),
                       lerp_rn(gy, A[pa[k]], fy, B[pa[k]]), fx[k],
                       lerp_rn(gy, A[pb[k]], fy, B[pb[k]]));
        finite = finite && isfinite(v[k]);
      }
      if (kFilled) {
        // fz is NaN-filled: the values stand; a flagged channel's NaN
        // weight, summed in the same order, poisons past kPoison
        if (wflag) {
          const float* WA = wring + sa * a.pitch;
          const float* WB = wring + sb * a.pitch;
#pragma unroll
          for (int k = 0; k < kW; ++k) {
            const float wn =
                lerp_rn(__fsub_rn(1.f, fx[k]),
                        lerp_rn(gy, WA[pa[k]], fy, WB[pa[k]]), fx[k],
                        lerp_rn(gy, WA[pb[k]], fy, WB[pb[k]]));
            if (wn > kPoison) v[k] = NAN;
          }
        }
      } else if (!__all_sync(0xffffffffu, finite)) {
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          const float zaa = A[pa[k]], zab = A[pb[k]];
          const float zba = B[pa[k]], zbb = B[pb[k]];
          const float ta = lerp_rn(gy, nan_to_num(zaa), fy, nan_to_num(zba));
          const float tb = lerp_rn(gy, nan_to_num(zab), fy, nan_to_num(zbb));
          const float na = lerp_rn(gy, (float)isnan(zaa), fy,
                                   (float)isnan(zba));
          const float nb = lerp_rn(gy, (float)isnan(zab), fy,
                                   (float)isnan(zbb));
          const float gx = __fsub_rn(1.f, fx[k]);
          v[k] = lerp_rn(gx, na, fx[k], nb) > kPoison
                     ? NAN
                     : lerp_rn(gx, ta, fx[k], tb);
        }
      }
#pragma unroll
      for (int k = 0; k < kW; ++k)
        if (!((vrow[k] >> lane) & 1u)) v[k] = NAN;
      float* orow = outc + (long long)i * a.nx_out;
      if (kStore16) {
#pragma unroll
        for (int k = 0; k < kW; ++k) buf[lane + 32 * k] = v[k];
        __syncwarp();
        const float4 q = reinterpret_cast<const float4*>(buf)[lane];
        __syncwarp();
        if (j0 + 4 * lane < a.nx_out)
          __stcs(reinterpret_cast<float4*>(orow + j0) + lane, q);
      } else {
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          const int j = j0 + lane + 32 * k;
          if (j < a.nx_out) __stcs(orow + j, v[k]);
        }
      }
    }
  }
  cp_async_wait(0);
}

// shared bytes of a plan; -1 where the library does not launch it (width
// not 32/64/128, 16-byte stores off 128 columns or on rows that are not
// 16-byte aligned, depth not 1..kMaxDepth, slots past what a step's rows
// need, span copies off a pitch of whole 16-byte words, a second plane of
// slots without wz, or past one block's shared memory)
__host__ long long plan_smem(const SctResample2& a) {
  if ((a.width != 32 && a.width != 64 && a.width != 128) ||
      (a.store16 && (a.width != 128 || a.nx_out % 4 != 0)) ||
      a.depth < 1 || a.depth > kMaxDepth || a.slots < 1 ||
      a.slots > kMaxSlots || a.pitch < 4 || a.pitch % 4 != 0 ||
      a.pitch > 0xffff || a.form < kSpan16 || a.form > kList ||
      (a.form == kSpan16 && a.nx_in % 4 != 0) || a.tile_rows < 1 ||
      a.tile_rows % kStepRows != 0 || a.steps != a.tile_rows / kStepRows ||
      a.tiles != (a.ny_out + a.tile_rows - 1) / a.tile_rows ||
      a.vwords != (a.nx_out + 31) / 32 || a.max_loads < 0 ||
      a.planes < 1 || a.planes > 2 || (a.planes == 2 && !a.wz))
    return -1;
  // the ring, the store buffers, the tile's tables (kernel's layout)
  const long long bytes =
      ((long long)a.planes * a.slots * a.pitch +
       (a.store16 ? kWarps * 128 : 0) +
       (2 + a.width / 32) * (long long)a.tile_rows + ((a.steps + 2) & ~1) +
       2LL * a.max_loads) * 4;
  return bytes <= kMaxShared ? bytes : -1;
}

template <int kW, bool kStore16, bool kFilled>
int launch_plan(const SctResample2& a, long long smem, cudaStream_t st) {
  auto kernel = resample2_kernel<kW, kStore16, kFilled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nstrips = (a.nx_out + 32 * kW - 1) / (32 * kW);
  const long long blocks = (long long)a.nchan * nstrips * a.tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool kFilled>
int launch_width(const SctResample2& a, long long smem, cudaStream_t st) {
  switch (a.width) {
    case 128:
      return a.store16 ? launch_plan<4, true, kFilled>(a, smem, st)
                       : launch_plan<4, false, kFilled>(a, smem, st);
    case 64: return launch_plan<2, false, kFilled>(a, smem, st);
    default: return launch_plan<1, false, kFilled>(a, smem, st);
  }
}

}  // namespace

extern "C" int sct_resample2_step_rows() { return kStepRows; }

// Shared bytes of a plan, -1 where it is not one this library launches.
extern "C" long long sct_resample2_smem(const SctResample2* a) {
  return plan_smem(*a);
}

// Either entry, with the taps and ring laid out in *a.  The raw entry (wz
// null): out = sum w * nan_to_num(raw), NaN by the poison rule, validity
// and zvalid.  The filled entry (wz set; raw holds fz, NaN-filled, and wz
// its NaN weights, both (nchan, ny_in, nx_in) float32; wflags (nchan,)
// int32, 1 where the channel's wz takes the poison test, at least wherever
// wz is not all zero): out = sum w * fz, NaN where a flagged channel's
// sum w * wz exceeds kPoison, validity and zvalid.  Returns the launch's
// cudaGetLastError().
extern "C" int sct_resample2(const SctResample2* a, void* stream) {
  if (a->nchan <= 0 || a->ny_out <= 0 || a->nx_out <= 0)
    return (int)cudaSuccess;
  const long long smem = plan_smem(*a);
  const bool span16 = a->form == kSpan16;
  if (smem < 0 || (span16 && ((uintptr_t)a->raw & 15) != 0) ||
      (span16 && a->wz && ((uintptr_t)a->wz & 15) != 0) ||
      (a->wz && !a->wflags) || ((uintptr_t)a->out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return a->wz ? launch_width<true>(*a, smem, st)
               : launch_width<false>(*a, smem, st);
}

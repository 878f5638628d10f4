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
// 2 * len flops per output.  Read one tap and one input from shared memory
// per FMA and shared-memory issue takes longer than the bytes (at bench
// config 2's size ~0.7 ms against a 0.54 ms bound).  So a block owns a strip of columns (128: 4 adjacent floats a
// lane; 32 where the plan narrows it) and walks every output row of the
// operator in steps of kWarps groups, a group of kR consecutive output
// rows a warp.  A lane keeps its columns of the group's kR rows in
// registers and reads each staged input row of the group's span once, as
// one float4, for all kR rows; the taps of a row of the span arrive for
// the kR rows at once (broadcast float4s) with a bit mask of the rows
// whose span holds it, and a row outside the mask takes no FMA, so a NaN
// or inf reaches exactly the rows whose span holds it, even at a zero
// tap.  Each row's FMAs run in t order.  The input rows a step needs are
// copied into a ring of row slots in shared memory by cp.async (16 bytes
// a copy where S % 4 == 0 and the base is aligned, else 4), `depth` steps
// ahead; the host (kernels/banded_matmul.py::plan, with
// kernels/resample2.py's ring schedule) gives every step the rows to load
// and their slots, keeping a row resident while later steps read it, so
// each input row leaves device memory once per strip.  Each step's table
// (its loads and its groups' records: slot, mask, taps) is copied into a
// second ring 2 * depth steps ahead of its use, so no step waits on a
// global read.  Outputs leave as 16-byte streaming stores where S % 4 ==
// 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

using sct::cp_async16;
using sct::cp_async4;
using sct::cp_async_commit;
using sct::cp_async_wait;
using sct::cp_async_wait_all;

// A launch: the step tables (one device buffer laid out by
// kernels/banded_matmul.py::pack) and the plan.
struct SctBandedMatmul {
  const float* x;      // (nin, S)
  float* out;          // (nout, S)
  const int* tables;   // (steps, table_words): a step's loads and groups
  long long S;
  int nout, rows, cols, depth, slots, steps, table_words, max_loads,
      group_words, copy16, store16;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;  // output-row groups a step
constexpr int kMaxDepth = 3;
constexpr long long kMaxShared = 232448 - 1024;  // per block, sm_90

// kR output rows a warp's group, kC columns a lane (a strip of 32 kC)
template <int kR, int kC>
__global__ void __launch_bounds__(kThreads)
banded_matmul_kernel(const SctBandedMatmul a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStrip = 32 * kC;
  // words of one span row's record: slot, then for kR == 1 its tap; else
  // a mask of the group's rows whose span holds it, two pad words and kR
  // taps
  constexpr int kRec = kR == 1 ? 2 : 4 + kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = kC * lane;
  const long long s0 = (long long)blockIdx.x * kStrip;
  const long long S = a.S;
  float* xring = smem;                                       // slots rows
  int* tring = reinterpret_cast<int*>(xring + a.slots * kStrip);
  const int tslots = 2 * a.depth + 1;
  const float* xs = a.x + s0 + col;

  // the table of step k into its slot of the table ring
  auto issue_table = [&](int k) {
    if (k < a.steps) {
      int* dst = tring + (k % tslots) * a.table_words;
      const int* src = a.tables + (long long)k * a.table_words;
      for (int q = 4 * threadIdx.x; q < a.table_words; q += 4 * kThreads)
        cp_async16(dst + q, src + q);
    }
  };
  // the input rows step k loads, each into its slot: one row a warp at a
  // time (its table has landed)
  auto issue_rows = [&](int k) {
    if (k < a.steps) {
      const int* t = tring + (k % tslots) * a.table_words;
      const int n = t[0];
      const int2* ld = reinterpret_cast<const int2*>(t + 4);
      for (int e = warp; e < n; e += kWarps) {
        const int2 l = ld[e];
        float* dst = xring + l.y * kStrip + col;
        const float* src = xs + (long long)l.x * S;
        if (kC == 4 && a.copy16) {
          if (s0 + col < S) cp_async16(dst, src);
        } else {
#pragma unroll
          for (int k2 = 0; k2 < kC; ++k2)
            if (s0 + col + k2 < S) cp_async4(dst + k2, src + k2);
        }
      }
    }
  };

  for (int k = 0; k < 2 * a.depth; ++k) issue_table(k);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < a.depth; ++k) {
    issue_rows(k);
    cp_async_commit();
  }
  const int goff = 4 + ((2 * a.max_loads + 3) & ~3);  // groups in a table
  for (int s = 0; s < a.steps; ++s) {
    cp_async_wait(a.depth - 1);  // this thread's rows of step s landed
    __syncthreads();             // everyone's; and step s - 1 is done
    issue_rows(s + a.depth);     // its table landed with step s's group
    issue_table(s + 2 * a.depth);  // into the slot of step s - 1's table
    cp_async_commit();

    const int* grp =
        tring + (s % tslots) * a.table_words + goff + warp * a.group_words;
    const int nrec = grp[0];
    const int* rec = grp + 4;
    float acc[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int k = 0; k < kC; ++k) acc[r][k] = 0.f;
#pragma unroll 2
    for (int u = 0; u < nrec; ++u) {
      int slot;
      unsigned mask = 1u;
      float t[kR];
      if constexpr (kR == 1) {
        const int2 h = reinterpret_cast<const int2*>(rec)[u];
        slot = h.x;
        t[0] = __int_as_float(h.y);
      } else {
        const int4 h = *reinterpret_cast<const int4*>(rec + u * kRec);
        slot = h.x;
        mask = (unsigned)h.y;
#pragma unroll
        for (int q = 0; q < kR / 4; ++q) {
          const float4 w =
              *reinterpret_cast<const float4*>(rec + u * kRec + 4 + 4 * q);
          t[4 * q] = w.x;
          t[4 * q + 1] = w.y;
          t[4 * q + 2] = w.z;
          t[4 * q + 3] = w.w;
        }
      }
      const float* xr = xring + slot * kStrip + col;
      float xv[kC];
      if constexpr (kC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr);
        xv[0] = v.x;
        xv[1] = v.y;
        xv[2] = v.z;
        xv[3] = v.w;
      } else {
        xv[0] = xr[0];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if ((mask >> r) & 1u)
#pragma unroll
          for (int k = 0; k < kC; ++k)
            acc[r][k] = fmaf(t[r], xv[k], acc[r][k]);
    }
    const int g = s * kWarps + warp;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = g * kR + r;
      if (i >= a.nout) break;
      float* o = a.out + (long long)i * S + s0 + col;
      if (kC == 4 && a.store16) {
        if (s0 + col < S)
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      } else {
#pragma unroll
        for (int k = 0; k < kC; ++k)
          if (s0 + col + k < S) __stcs(o + k, acc[r][k]);
      }
    }
  }
  cp_async_wait_all();
}

// shared bytes of a plan; -1 where the library does not launch it (a
// shape it has no instance of, depth not 1..kMaxDepth, tables off whole
// 16-byte words or too small for their loads and groups, too few steps
// for nout, 16-byte copies or stores on rows that are not 16-byte
// aligned, or past one block's shared memory)
long long plan_smem(const SctBandedMatmul& a) {
  const bool shape = (a.rows == 8 && a.cols == 4) ||
                     (a.rows == 1 && (a.cols == 4 || a.cols == 1));
  if (!shape || a.depth < 1 || a.depth > kMaxDepth || a.slots < 1 ||
      a.steps < 1 || a.max_loads < 0 || a.group_words < 4 ||
      a.group_words % 4 != 0 || a.table_words % 4 != 0 ||
      a.table_words < 4 + ((2 * a.max_loads + 3) & ~3) +
                          kWarps * a.group_words ||
      (long long)a.steps * kWarps * a.rows < a.nout || a.nout < 0 ||
      ((a.copy16 || a.store16) && (a.cols != 4 || a.S % 4 != 0)))
    return -1;
  const long long bytes = ((long long)a.slots * 32 * a.cols +
                           (2LL * a.depth + 1) * a.table_words) * 4;
  return bytes <= kMaxShared ? bytes : -1;
}

template <int kR, int kC>
int launch_plan(const SctBandedMatmul& a, long long smem, cudaStream_t st) {
  auto kernel = banded_matmul_kernel<kR, kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.S + 32 * kC - 1) / (32 * kC);
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sct_banded_matmul_warps() { return kWarps; }

// Shared bytes of a plan, -1 where it is not one this library launches.
extern "C" long long sct_banded_matmul_smem(const SctBandedMatmul* a) {
  return plan_smem(*a);
}

// out (nout, S) = the banded product of the operator laid out in
// a->tables with x (nin, S), both float32.  Returns the launch's
// cudaGetLastError().
extern "C" int sct_banded_matmul(const SctBandedMatmul* a, void* stream) {
  if (a->nout <= 0 || a->S <= 0) return (int)cudaSuccess;
  const long long smem = plan_smem(*a);
  if (smem < 0 || (a->copy16 && ((uintptr_t)a->x & 15) != 0) ||
      (a->store16 && ((uintptr_t)a->out & 15) != 0) ||
      ((uintptr_t)a->tables & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a->rows == 8) return launch_plan<8, 4>(*a, smem, st);
  return a->cols == 4 ? launch_plan<1, 4>(*a, smem, st)
                      : launch_plan<1, 1>(*a, smem, st);
}

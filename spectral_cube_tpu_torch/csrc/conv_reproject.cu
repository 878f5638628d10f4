// Fused common-beam convolution + axis-aligned bilinear resample of a
// (nchan, ny_in, nx_in) float32 cube, its clean-only mode, and the same
// stream with the masked moment and statistics planes taken on the way.
//
// Replaces three TPU kernels of spectral_cube_tpu/ops/banded_pallas.py:
//
//   mode 0  ::conv_reproject_raw_strips (#8)
//   mode 1  ::per_channel_plain_strips  (#9, the clean branch of #8)
//   mode 2  ::pipeline_fused_raw_strips (#10, #8 plus moments)
//
// Per channel, from the channel's own content (a pre-pass sets two flags:
// it holds a non-NaN value, it holds a NaN):
//
//   clean channel:  out = sum_i Gy_i @ Z @ Gx_i^T with the host-composed
//                   G = R @ M (rank r): output row o reads input rows
//                   start[o] + k with weight taps[i][o][k];
//   NaN channel:    the exact chain.  num = K * where(isnan, 0, Z) and
//                   den = 1 - K * isnan (zero padding counts as valid),
//                   c = 0 and nanc = 1 where den <= 1e-6, else c = num / den;
//                   out = R @ c @ R^T, NaN where R @ nanc @ R^T > 1e-6
//                   (banded_pallas.py:1159-1195);
//   all-NaN channel: NaN;
//
// then NaN where valid_plane is 0.  Mode 1 applies the clean branch to
// every channel, with NaN carried as a value (its callers pass finite data).
//
// On the TPU each grid step holds whole planes in VMEM and runs the
// operators as strip matmuls.  Here a block owns a tile of outputs (modes 0
// and 1: 32 rows by 128 or 64 columns, or fewer where the window is wide)
// and, per channel, stages in shared memory the input window its taps
// read.  What bounds it on an H100 is float32 FMA issue against
// shared-memory issue: an SM issues four warp-wide FMAs per cycle but one
// warp-wide shared load.  So, as in conv_sep.cu:
//
// - The G taps come from the host as descriptors of 8 consecutive outputs
//   (kDesc ints: first input index, uniform flag, tap offset, count, and
//   each output's offset from the first index) and their taps, one blob per
//   (group, tile), staged in shared memory once per block and group and
//   read as block-uniform float4 broadcasts; the chain's taps likewise.  No
//   tap is read from global memory or L1 inside an FMA loop.
// - A "uniform" descriptor (8 outputs whose bands are one band shifted by
//   one index each, bit for bit: every interior row of a translation) is
//   applied from a sliding register window: the y pass feeds 8 * r FMAs per
//   staged load (all ranks of 8 rows of one column), the x pass 8 FMAs per
//   load (8 columns of one row, lane = output row).  Any other descriptor
//   (plane edges, rescaled or flipped targets) is applied output by output
//   from the same staged window.  Every output sums its taps in order, each
//   rank on its own, the ranks in order, as the plain version does, so the
//   two forms give the same bits.
// - Two barriers per 32 output rows of a channel (y pass, x pass); the
//   outputs leave through a shared staging buffer in coalesced rows.
// - The chain runs the same register blocking with __fmul_rn / __fadd_rn
//   in the plain version's order (kernels/conv_reproject.py::
//   conv_reproject_plain: y taps, then x taps, then the ranks), so NaN
//   decisions at den ~ 1e-6 agree exactly; its flag pass restages the
//   window as NaN flags and runs only where the window holds a NaN.
// - The window is staged with 16-byte loads from a 4-aligned column.
//
// Mode 2 partitions the outputs by input tile: output (i, j) belongs to the
// block whose 32 x 24 input tile holds (y0[i], x0[j]), and the block walks
// every channel of its tile, so each input spaxel is accumulated exactly
// once, by the same per-spaxel code and chunk order as the moments kernel
// (moments_acc.cuh; three spaxels a thread, their state in shared memory,
// pass 2 re-reading the chunk from device memory): its planes equal
// moments.cu's bit for bit, and its cube output equals mode 0's, since
// every output is the same function of the same window values.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moments_acc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileY = 32;          // output rows of a pass: one per lane
constexpr int kBlk = 8;             // outputs per thread along a pass and
                                    // per descriptor
constexpr int kMaxCols = 128;       // a block's output columns: 8 warps x 2
constexpr int kDesc = 12;           // ints per descriptor
constexpr int kMomTY = 32;          // mode 2: the 32 x 24 input tile,
constexpr int kMomTX = 24;          // three spaxels a thread
constexpr int kMomPer = kMomTY * kMomTX / kThreads;
constexpr int kMomWords = (int)(sizeof(sct::MomentAcc) / 4);
constexpr int kSmemLimit = 232448;  // bytes a block may use, sm_90
constexpr float kEps = 1e-6f;       // banded_pallas.py:45

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

// Host-side layout, mirrored by kernels/conv_reproject.py (ctypes).
struct SctAxis {
  const int* perm;      // (n_out,) outputs ordered by tile
  const int* off;       // (tiles + 1,) tile t holds perm[off[t] .. off[t+1])
  const int* win0;      // (groups, tiles) first input index of each window
  const int* blob;      // descriptors and G taps of every (group, tile)
  const int* blob_off;  // (groups * tiles + 1,) word offsets into blob
  const float* ktaps;   // (rank, klen) flipped convolution taps (modes 0, 2)
  const int* i0;        // (n_out,) resample row: weights w0 at i0, w1 at i0+1
  const float* w0;
  const float* w1;
  int n_in, n_out, tiles, span, width, klen, khalf, max_count, blob_max,
      reach;            // width: G taps per output, a multiple of 4;
                        // reach: window rows (y) / y-pass columns (x) the
                        // clean branch reads
};

struct SctConvReproject {
  const float* raw;          // (nchan, ny_in, nx_in)
  const int* group_idx;      // (nchan,) or null: all group 0
  int* flags;                // (nchan,) scratch (modes 0, 2)
  const uint8_t* valid;      // (ny_out, nx_out) or null
  const float* xc;           // (nchan,) centered coordinates (mode 2)
  const uint8_t* include;    // (nchan, ny_in, nx_in) or null (mode 2)
  float* out;                // (nchan, ny_out, nx_out)
  float* planes;             // (10, ny_in, nx_in) (mode 2)
  int* count;                // (ny_in, nx_in) (mode 2)
  SctAxis y, x;
  int nchan, rank, groups, mode, chan_per_block, cmp_op;
  float thr;
  int mom_ty, mom_tx;        // mode 2: the input tile, kMomTY x kMomTX
};

namespace {

// shared-memory layout, in 4-byte words (offsets multiples of 4)
struct Layout {
  int rows, cols, yb, xb, ky, kx, vin, os, work, cv, cb, mom, total;
  int pin, vrows, pt, qy, qc, cy, cx, pcx, ly4, lx4, po;
};

__host__ __device__ inline bool layout(const SctConvReproject& a,
                                       Layout& L) {
  const int r = a.rank, sy = a.y.span, sx = a.x.span;
  if (r < 1 || r > 8 || sy <= 0 || sx <= 0 || a.x.max_count > kMaxCols)
    return false;
  L.cy = L.cx = L.pcx = L.ly4 = L.lx4 = L.qc = 0;
  int rows_c = 0;
  if (a.mode != 1) {
    L.cy = sy - a.y.klen + 1;
    L.cx = sx - a.x.klen + 1;
    if (L.cy < 1 || L.cx < 1 || a.y.klen < 1 || a.x.klen < 1) return false;
    L.pcx = L.cx | 1;
    L.ly4 = round4(a.y.klen);
    L.lx4 = round4(a.x.klen);
    L.qc = round8(L.cx) + L.lx4 - 1;
    rows_c = round8(L.cy) + L.ly4 - 1;
  }
  L.qy = a.x.reach;
  L.pt = imax(L.qy, L.qc) | 1;
  L.pin = round4(imax(L.qy, L.qc) + 3);
  L.vrows = imax(a.y.reach, rows_c);
  L.rows = 0;
  L.cols = L.rows + round4(a.y.max_count);
  L.yb = L.cols + round4(a.x.max_count);
  L.xb = L.yb + round4(a.y.blob_max);
  L.ky = L.xb + round4(a.x.blob_max);
  L.kx = L.ky + (a.mode != 1 ? r * L.ly4 : 0);
  L.vin = L.kx + (a.mode != 1 ? r * L.lx4 : 0);
  L.po = round8(a.x.max_count) | 1;
  L.os = L.vin + L.vrows * L.pin;
  L.work = L.os + round4(kTileY * L.po);
  const int clean = r * kTileY * L.pt;
  L.cv = L.work + round4(round8(L.cy) * L.pt);
  L.cb = L.cv + round4(L.cy * L.pcx);
  const int chain = a.mode != 1 ? L.cb + round4(L.cy * L.pcx) - L.work : 0;
  L.mom = L.work + round4(imax(clean, chain));
  L.total = L.mom + (a.mode == 2 ? kMomWords * kMomTY * kMomTX : 0);
  return true;
}

__device__ __forceinline__ float mul_add_rn(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// a * ga + b * fa in the plain version's order
__device__ __forceinline__ float lerp_rn(float ga, float a, float fa,
                                         float b) {
  return __fadd_rn(__fmul_rn(ga, a), __fmul_rn(fa, b));
}

__device__ __forceinline__ void load_taps(const float* __restrict__ p,
                                          int n4, float* t) {
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    if (j < n4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      t[j] = v.x; t[j + 1] = v.y; t[j + 2] = v.z; t[j + 3] = v.w;
    }
  }
}

__global__ void chan_flags_kernel(const float* __restrict__ data,
                                  long long plane, int blocks_per_chan,
                                  int* __restrict__ flags) {
  const int c = blockIdx.x / blocks_per_chan;
  const int b = blockIdx.x - c * blocks_per_chan;
  const float* x = data + (long long)c * plane;
  bool value = false, nan = false;
  for (long long i = (long long)b * blockDim.x + threadIdx.x; i < plane;
       i += (long long)blocks_per_chan * blockDim.x) {
    if (isnan(x[i]))
      nan = true;
    else
      value = true;
  }
  value = __syncthreads_or(value);
  nan = __syncthreads_or(nan);
  if (threadIdx.x == 0 && (value || nan))
    atomicOr(flags + c, (value ? 1 : 0) | (nan ? 2 : 0));
}

enum StageAs { kValues, kRaw, kFlags };

// Stage window rows [0, L.vrows) and pitch columns of the channel plane Z,
// window origin (gy0, gx0): shared column k holds input column gxa + k, gxa
// = gx0 rounded down to a multiple of 4.  Zero outside the plane and
// outside the true window (vrows x vcols); NaN as 0 (kValues), as itself
// (kRaw) or as flags 1 / 0 (kFlags).  Returns whether a staged value of the
// true window was NaN (this thread's part).
__device__ __forceinline__ bool stage(const float* __restrict__ Z, int ny,
                                      int nx, float* __restrict__ in,
                                      int pin, int nrows, int gy0, int gx0,
                                      int vrows, int vcols, StageAs as) {
  const int gxa = gx0 - (gx0 & 3);
  const int s = gx0 - gxa;
  const int nq = pin >> 2;
  const bool vec = (nx & 3) == 0;
  bool bad = false;
  for (int e = threadIdx.x; e < nrows * nq; e += kThreads) {
    const int r = e / nq;
    const int m = e - r * nq;
    const int gy = gy0 + r;
    const int gx = gxa + 4 * m;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < ny && r < vrows) {
      const float* row = Z + (long long)gy * nx;
      if (vec && gx >= 0 && gx + 3 < nx) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + gx));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (gx + k >= 0 && gx + k < nx) v[k] = __ldg(row + gx + k);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * m + k - s;
      const bool inside = col >= 0 && col < vcols;
      const bool nan = isnan(v[k]);
      bad |= inside && nan;
      v[k] = !inside ? 0.f
             : as == kFlags ? (nan ? 1.f : 0.f)
             : (as == kValues && nan) ? 0.f : v[k];
    }
    *reinterpret_cast<float4*>(in + r * pin + 4 * m) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  return bad;
}

// Clean y pass: T[i][8 gi + k][q] = sum_o G_i taps of output row 8 (g0 +
// gi) + k times the window column q, for descriptors g0 .. g0 + ng, every
// rank at once.  Uniform descriptors: taps [o][RP], a sliding window of
// 8 + 3 rows; others: taps [m][o][RP], output by output.
template <int R>
__device__ __forceinline__ void y_pass(const float* __restrict__ in, int pin,
                                       const int* __restrict__ yb, int g0,
                                       int ng, int wy0, int W4,
                                       float* __restrict__ T, int pt,
                                       int qy) {
  constexpr int RP = round4(R);
  const float* fb = reinterpret_cast<const float*>(yb);
  for (int e = threadIdx.x; e < ng * qy; e += kThreads) {
    const int gi = e / qy;
    const int q = e - gi * qy;
    const int* d = yb + (g0 + gi) * kDesc;
    const float* tp = fb + d[2];
    const float* col = in + (d[0] - wy0) * pin + q;
    float acc[R][kBlk];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < kBlk; ++k) acc[i][k] = 0.f;
    if (d[1]) {
      float w[kBlk + 3];
#pragma unroll
      for (int k = 0; k < kBlk - 1; ++k) w[k] = col[k * pin];
      for (int o = 0; o < W4; o += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[kBlk - 1 + k] = col[(o + kBlk - 1 + k) * pin];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float tap[8];
          load_taps(tp + (o + p) * RP, RP, tap);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int k = 0; k < kBlk; ++k)
              acc[i][k] = fmaf(tap[i], w[p + k], acc[i][k]);
        }
#pragma unroll
        for (int k = 0; k < kBlk - 1; ++k) w[k] = w[k + 4];
      }
    } else {
#pragma unroll
      for (int m = 0; m < kBlk; ++m) {
        const float* c = col + d[4 + m] * pin;
        const float* t = tp + m * W4 * RP;
        for (int o = 0; o < W4; ++o) {
          const float v = c[o * pin];
          float tap[8];
          load_taps(t + o * RP, RP, tap);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][m] = fmaf(tap[i], v, acc[i][m]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < kBlk; ++k)
        T[(i * kTileY + gi * kBlk + k) * pt + q] = acc[i][k];
  }
}

// Clean x pass of descriptor cg for output row lane: acc[k] = sum_i sum_o
// Gx_i taps of output column 8 cg + k times T[i][lane][...], each rank's
// sum taken on its own and then added.  Uniform taps [i][o]; others
// [m][i][o].
template <int R>
__device__ __forceinline__ void x_pass(const float* __restrict__ T, int pt,
                                       const int* __restrict__ xb, int cg,
                                       int wx0, int W4,
                                       float (&acc)[kBlk]) {
  const int lane = threadIdx.x & 31;
  const int* d = xb + cg * kDesc;
  const float* tp = reinterpret_cast<const float*>(xb) + d[2];
  const int c0 = d[0] - wx0;
  const bool uniform = d[1] != 0;
#pragma unroll
  for (int k = 0; k < kBlk; ++k) acc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* row = T + (i * kTileY + lane) * pt + c0;
    float a[kBlk];
#pragma unroll
    for (int k = 0; k < kBlk; ++k) a[k] = 0.f;
    if (uniform) {
      const float* kx = tp + i * W4;
      float w[kBlk + 3];
#pragma unroll
      for (int k = 0; k < kBlk - 1; ++k) w[k] = row[k];
      for (int p0 = 0; p0 < W4; p0 += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[kBlk - 1 + k] = row[p0 + kBlk - 1 + k];
        const float4 v = *reinterpret_cast<const float4*>(kx + p0);
        const float tap[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < kBlk; ++k) a[k] = fmaf(tap[p], w[p + k], a[k]);
#pragma unroll
        for (int k = 0; k < kBlk - 1; ++k) w[k] = w[k + 4];
      }
    } else {
#pragma unroll
      for (int m = 0; m < kBlk; ++m) {
        const float* rm = row + d[4 + m];
        const float* kx = tp + (m * R + i) * W4;
        for (int o = 0; o < W4; o += 4) {
          const float4 v = *reinterpret_cast<const float4*>(kx + o);
          a[m] = fmaf(v.x, rm[o], a[m]);
          a[m] = fmaf(v.y, rm[o + 1], a[m]);
          a[m] = fmaf(v.z, rm[o + 2], a[m]);
          a[m] = fmaf(v.w, rm[o + 3], a[m]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBlk; ++k) acc[k] += a[k];
  }
}

// The clean branch for the block's outputs rows[0..nr) x cols[0..nc), in
// passes of 32 output rows: the y pass into T, then the x pass (lane =
// output row, a warp per 8 columns) into registers and a shared staging
// buffer, written out row by row so that the stores and the validity
// plane's loads coalesce.
template <int R>
__device__ __forceinline__ void clean_branch(const SctConvReproject& a,
                                             const Layout& L, float* sm,
                                             int wy0, int wx0, int nr, int nc,
                                             float* __restrict__ O) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* rows = reinterpret_cast<const int*>(sm) + L.rows;
  const int* cols = reinterpret_cast<const int*>(sm) + L.cols;
  const int* yb = reinterpret_cast<const int*>(sm) + L.yb;
  const int* xb = reinterpret_cast<const int*>(sm) + L.xb;
  const float* in = sm + L.vin + (wx0 & 3);
  float* T = sm + L.work;
  float* os = sm + L.os;
  const int nx_out = a.x.n_out;
  const int nc8 = (nc + kBlk - 1) / kBlk;
  for (int rb = 0; rb < nr; rb += kTileY) {
    const int ng = min(kTileY / kBlk, (nr - rb + kBlk - 1) / kBlk);
    y_pass<R>(in, L.pin, yb, rb / kBlk, ng, wy0, a.y.width, T, L.pt, L.qy);
    __syncthreads();
    for (int cg = warp; cg < nc8; cg += kThreads / 32) {
      float acc[kBlk];
      x_pass<R>(T, L.pt, xb, cg, wx0, a.x.width, acc);
#pragma unroll
      for (int k = 0; k < kBlk; ++k) os[lane * L.po + cg * kBlk + k] = acc[k];
    }
    __syncthreads();
    // the staged rows out, consecutive threads on consecutive columns
    const int n = min(kTileY, nr - rb) * nc;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int j = e / nc;
      const int k = e - j * nc;
      const long long p = (long long)rows[rb + j] * nx_out + cols[k];
      const bool ok = a.valid == nullptr || a.valid[p] != 0;
      O[p] = ok ? os[j * L.po + k] : NAN;
    }
  }
}

// The chain's normalized-convolution numerator (values staged) or
// denominator sum (flags staged) on the conv grid (cy x cx), into dst:
// per rank, the y taps over 8 conv rows of one column from a sliding
// window, then the x taps over 8 conv columns of one row (lane = conv
// row), summed over ranks in rank order, in __fmul_rn / __fadd_rn.
template <int R>
__device__ __forceinline__ void conv_passes(const Layout& L,
                                            const float* __restrict__ in,
                                            const float* __restrict__ kys,
                                            const float* __restrict__ kxs,
                                            float* __restrict__ tv,
                                            float* __restrict__ dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = round8(L.cy) / kBlk, qc = L.qc, cy = L.cy, cx = L.cx;
  const int pin = L.pin, pt = L.pt;
  // conv rows in blocks of 32 (lane = row) where a block is at least half
  // full; the rows past them one conv output per thread
  const int nb = (cy + 16) / 32, cx8 = (cx + kBlk - 1) / kBlk;
  const int rest0 = min(cy, nb * 32);
  for (int i = 0; i < R; ++i) {
    const float* ky = kys + i * L.ly4;
    for (int e = tid; e < ng * qc; e += kThreads) {
      const int g = e / qc;
      const int q = e - g * qc;
      const float* col = in + g * kBlk * pin + q;
      float acc[kBlk], w[kBlk + 3];
#pragma unroll
      for (int k = 0; k < kBlk; ++k) acc[k] = 0.f;
#pragma unroll
      for (int k = 0; k < kBlk - 1; ++k) w[k] = col[k * pin];
      for (int o = 0; o < L.ly4; o += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[kBlk - 1 + k] = col[(o + kBlk - 1 + k) * pin];
        const float4 v = *reinterpret_cast<const float4*>(ky + o);
        const float tap[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < kBlk; ++k)
            acc[k] = mul_add_rn(acc[k], tap[p], w[p + k]);
#pragma unroll
        for (int k = 0; k < kBlk - 1; ++k) w[k] = w[k + 4];
      }
#pragma unroll
      for (int k = 0; k < kBlk; ++k) tv[(g * kBlk + k) * pt + q] = acc[k];
    }
    __syncthreads();
    const float* kx = kxs + i * L.lx4;
    for (int e = warp; e < nb * cx8; e += kThreads / 32) {
      const int b = e / cx8;
      const int cg = e - b * cx8;
      const int r = b * 32 + lane;
      if (r >= cy) continue;
      const float* row = tv + r * pt + cg * kBlk;
      float acc[kBlk], w[kBlk + 3];
#pragma unroll
      for (int k = 0; k < kBlk; ++k) acc[k] = 0.f;
#pragma unroll
      for (int k = 0; k < kBlk - 1; ++k) w[k] = row[k];
      for (int o = 0; o < L.lx4; o += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[kBlk - 1 + k] = row[o + kBlk - 1 + k];
        const float4 v = *reinterpret_cast<const float4*>(kx + o);
        const float tap[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int k = 0; k < kBlk; ++k)
            acc[k] = mul_add_rn(acc[k], tap[p], w[p + k]);
#pragma unroll
        for (int k = 0; k < kBlk - 1; ++k) w[k] = w[k + 4];
      }
#pragma unroll
      for (int k = 0; k < kBlk; ++k) {
        const int c = cg * kBlk + k;
        if (c < cx) {
          float* d = dst + r * L.pcx + c;
          *d = i == 0 ? acc[k] : __fadd_rn(*d, acc[k]);
        }
      }
    }
    for (int e = tid; e < (cy - rest0) * cx; e += kThreads) {
      const int r = rest0 + e / cx;
      const int c = e - (r - rest0) * cx;
      const float* row = tv + r * pt + c;
      float acc = 0.f;
      for (int o = 0; o < L.lx4; ++o) acc = mul_add_rn(acc, kx[o], row[o]);
      float* d = dst + r * L.pcx + c;
      *d = i == 0 ? acc : __fadd_rn(*d, acc);
    }
    __syncthreads();
  }
}

// The exact chain for a channel that holds NaN (and a non-NaN value).
template <int R>
__device__ __forceinline__ void chain_branch(
    const SctConvReproject& a, const Layout& L, float* sm,
    const float* __restrict__ Z, int wy0, int wx0, int nr, int nc,
    bool has_bad, float* __restrict__ O) {
  const int tid = threadIdx.x;
  const int* rows = reinterpret_cast<const int*>(sm) + L.rows;
  const int* cols = reinterpret_cast<const int*>(sm) + L.cols;
  float* vin = sm + L.vin;
  const float* in = vin + (wx0 & 3);
  float* cv = sm + L.cv;
  float* cb = sm + L.cb;
  const int cy = L.cy, cx = L.cx, pcx = L.pcx;
  conv_passes<R>(L, in, sm + L.ky, sm + L.kx, sm + L.work, cv);
  if (has_bad) {
    stage(Z, a.y.n_in, a.x.n_in, vin, L.pin, L.vrows, wy0, wx0, a.y.span,
          a.x.span, kFlags);
    __syncthreads();
    conv_passes<R>(L, in, sm + L.ky, sm + L.kx, sm + L.work, cb);
  }
  // normalize: den = 1 - K * isnan; without a NaN in the window den is 1
  for (int e = tid; e < cy * cx; e += kThreads) {
    const int r = e / cx;
    const int i = r * pcx + e - r * cx;
    const float den = has_bad ? __fsub_rn(1.f, cb[i]) : 1.f;
    const bool nanc = den <= kEps;
    cv[i] = nanc ? 0.f : __fdiv_rn(cv[i], den);
    cb[i] = nanc ? 1.f : 0.f;
  }
  __syncthreads();
  // 2-tap resample of the conv values and of the NaN flags
  const int oy = wy0 + a.y.khalf, ox = wx0 + a.x.khalf;
  const int nx_out = a.x.n_out;
  for (int e = tid; e < nr * nc; e += kThreads) {
    const int kk = e / nc;
    const int row = rows[kk];
    const int col = cols[e - kk * nc];
    const int ia = a.y.i0[row];
    const int ya = ia - oy, yb = min(ia + 1, a.y.n_in - 1) - oy;
    const int ja = a.x.i0[col];
    const int xa = ja - ox, xb = min(ja + 1, a.x.n_in - 1) - ox;
    const float gy = a.y.w0[row], fy = a.y.w1[row];
    const float gx = a.x.w0[col], fx = a.x.w1[col];
    const float v = lerp_rn(gx, lerp_rn(gy, cv[ya * pcx + xa], fy,
                                        cv[yb * pcx + xa]),
                            fx, lerp_rn(gy, cv[ya * pcx + xb], fy,
                                        cv[yb * pcx + xb]));
    const float wn = lerp_rn(gx, lerp_rn(gy, cb[ya * pcx + xa], fy,
                                         cb[yb * pcx + xa]),
                             fx, lerp_rn(gy, cb[ya * pcx + xb], fy,
                                         cb[yb * pcx + xb]));
    const long long p = (long long)row * nx_out + col;
    const bool ok = a.valid == nullptr || a.valid[p] != 0;
    O[p] = (ok && !(wn > kEps)) ? v : NAN;
  }
}

// mode 2: whether voxel idx of value v enters the moments (the moments
// kernel's predicate)
__device__ __forceinline__ bool included(const SctConvReproject& a, float v,
                                         long long idx) {
  bool ok = isfinite(v) && sct::passes(v, a.cmp_op, a.thr);
  if (a.include != nullptr) ok = ok && a.include[idx] != 0;
  return ok;
}

__device__ __forceinline__ void fill_nan(const SctConvReproject& a,
                                         const int* rows, const int* cols,
                                         int nr, int nc, float* O) {
  for (int e = threadIdx.x; e < nr * nc; e += kThreads) {
    const int kk = e / nc;
    O[(long long)rows[kk] * a.x.n_out + cols[e - kk * nc]] = NAN;
  }
}

template <int kMode, int R>
__global__ void __launch_bounds__(kThreads, 2)
conv_reproject_kernel(const SctConvReproject a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Layout L;
  layout(a, L);
  const int tid = threadIdx.x;
  const int ty = blockIdx.x / a.x.tiles;
  const int tx = blockIdx.x - ty * a.x.tiles;
  const int rb = a.y.off[ty], nr = a.y.off[ty + 1] - rb;
  const int cb = a.x.off[tx], nc = a.x.off[tx + 1] - cb;
  int* rows = reinterpret_cast<int*>(sm) + L.rows;
  int* cols = reinterpret_cast<int*>(sm) + L.cols;
  for (int k = tid; k < nr; k += kThreads) rows[k] = a.y.perm[rb + k];
  for (int k = tid; k < nc; k += kThreads) cols[k] = a.x.perm[cb + k];
  if (kMode != 1) {
    for (int e = tid; e < R * L.ly4; e += kThreads) {
      const int i = e / L.ly4, o = e - i * L.ly4;
      sm[L.ky + e] = o < a.y.klen ? a.y.ktaps[i * a.y.klen + o] : 0.f;
    }
    for (int e = tid; e < R * L.lx4; e += kThreads) {
      const int i = e / L.lx4, o = e - i * L.lx4;
      sm[L.kx + e] = o < a.x.klen ? a.x.ktaps[i * a.x.klen + o] : 0.f;
    }
  }
  const int ny_in = a.y.n_in, nx_in = a.x.n_in;
  const long long plane = (long long)ny_in * nx_in;
  const long long out_plane = (long long)a.y.n_out * a.x.n_out;

  // mode 2: spaxel s = k * kThreads + tid of the block's input tile is
  // (ty * kMomTY + s / kMomTX, tx * kMomTX + s % kMomTX), its state in
  // shared memory
  sct::MomentAcc* st = reinterpret_cast<sct::MomentAcc*>(sm + L.mom);
  if (kMode == 2) {
#pragma unroll
    for (int k = 0; k < kMomPer; ++k) st[k * kThreads + tid].init();
  }

  const int c_begin = blockIdx.y * a.chan_per_block;
  const int c_end = min(a.nchan, c_begin + a.chan_per_block);
  int staged = -1;
  for (int c = c_begin; c < c_end; ++c) {
    const int g = a.group_idx != nullptr ? a.group_idx[c] : 0;
    if (g != staged) {
      // this group's descriptors and G taps, once per block and group
      __syncthreads();
      const int* ys = a.y.blob + a.y.blob_off[g * a.y.tiles + ty];
      const int ny = a.y.blob_off[g * a.y.tiles + ty + 1] -
                     a.y.blob_off[g * a.y.tiles + ty];
      const int* xs = a.x.blob + a.x.blob_off[g * a.x.tiles + tx];
      const int nx = a.x.blob_off[g * a.x.tiles + tx + 1] -
                     a.x.blob_off[g * a.x.tiles + tx];
      int* yb = reinterpret_cast<int*>(sm) + L.yb;
      int* xb = reinterpret_cast<int*>(sm) + L.xb;
      for (int e = tid; e < ny; e += kThreads) yb[e] = __ldg(ys + e);
      for (int e = tid; e < nx; e += kThreads) xb[e] = __ldg(xs + e);
      staged = g;
      __syncthreads();
    }
    const int fl = kMode == 1 ? 1 : a.flags[c];
    const int wy0 = a.y.win0[g * a.y.tiles + ty];
    const int wx0 = a.x.win0[g * a.x.tiles + tx];
    const float* Z = a.raw + (long long)c * plane;
    float* O = a.out + (long long)c * out_plane;
    const bool some = fl & 1, dirty = (fl & 2) != 0;
    if (kMode != 2 && !some) {
      fill_nan(a, rows, cols, nr, nc, O);
      continue;
    }
    if (kMode == 2) {
      const int j = c % sct::kChunk;
#pragma unroll
      for (int k = 0; k < kMomPer; ++k) {
        const int sp = k * kThreads + tid;
        const int my = ty * kMomTY + sp / kMomTX;
        const int mx = tx * kMomTX + sp % kMomTX;
        if (my < ny_in && mx < nx_in) {
          const long long p = (long long)my * nx_in + mx;
          sct::MomentAcc& A = st[k * kThreads + tid];
          if (j == 0) A.begin_chunk();
          const float v = Z[p];
          A.add(v, included(a, v, (long long)c * plane + p), __ldg(a.xc + c));
          if (j == sct::kChunk - 1 || c == a.nchan - 1) {
            const long long c0 = c - j;
            A.end_chunk_of(
                [&](int jj) {
                  const long long idx = (c0 + jj) * plane + p;
                  const float u = a.raw[idx];
                  return included(a, u, idx) ? u : NAN;
                },
                j + 1, a.xc + c0, true);
          }
        }
      }
    }
    if (!some) {
      fill_nan(a, rows, cols, nr, nc, O);
    } else {
      const bool bad = stage(Z, ny_in, nx_in, sm + L.vin, L.pin, L.vrows, wy0,
                             wx0, a.y.span, a.x.span,
                             kMode == 1 ? kRaw : kValues);
      const bool has_bad = __syncthreads_or(bad);
      if (kMode == 1 || !dirty)
        clean_branch<R>(a, L, sm, wy0, wx0, nr, nc, O);
      else
        chain_branch<R>(a, L, sm, Z, wy0, wx0, nr, nc, has_bad, O);
    }
    __syncthreads();
  }
  if (kMode == 2) {
#pragma unroll
    for (int k = 0; k < kMomPer; ++k) {
      const int sp = k * kThreads + tid;
      const int my = ty * kMomTY + sp / kMomTX;
      const int mx = tx * kMomTX + sp % kMomTX;
      if (my < ny_in && mx < nx_in)
        st[k * kThreads + tid].store(a.planes, a.count, plane,
                                     (long long)my * nx_in + mx, true);
    }
  }
}

template <int kMode, int R>
cudaError_t launch_rank(const SctConvReproject& a, int bytes,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_reproject_kernel<kMode, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int groups = (a.nchan + a.chan_per_block - 1) / a.chan_per_block;
  conv_reproject_kernel<kMode, R>
      <<<dim3((unsigned)(a.y.tiles * a.x.tiles), (unsigned)groups), kThreads,
         bytes, s>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch(const SctConvReproject& a, int bytes, cudaStream_t s) {
  switch (a.rank) {
    case 1: return launch_rank<kMode, 1>(a, bytes, s);
    case 2: return launch_rank<kMode, 2>(a, bytes, s);
    case 3: return launch_rank<kMode, 3>(a, bytes, s);
    case 4: return launch_rank<kMode, 4>(a, bytes, s);
    case 5: return launch_rank<kMode, 5>(a, bytes, s);
    case 6: return launch_rank<kMode, 6>(a, bytes, s);
    case 7: return launch_rank<kMode, 7>(a, bytes, s);
    case 8: return launch_rank<kMode, 8>(a, bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of shared memory one block of this launch needs, or -1 when the
// tiling is not one the kernel takes; more than sct_conv_reproject_smem_limit
// does not launch.
extern "C" long long sct_conv_reproject_smem(const SctConvReproject* a) {
  Layout L;
  if (!layout(*a, L)) return -1;
  return 4LL * L.total;
}

extern "C" int sct_conv_reproject_smem_limit() { return kSmemLimit; }

extern "C" int sct_conv_reproject_threads() { return kThreads; }

// One launch of the mode's kernel (and, for modes 0 and 2, the channel flag
// pre-pass into a->flags).  Returns the first CUDA error.
extern "C" int sct_conv_reproject(const SctConvReproject* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->nchan <= 0 || a->y.n_out <= 0 || a->x.n_out <= 0)
    return (int)cudaSuccess;
  Layout L;
  if (!layout(*a, L) || 4LL * L.total > kSmemLimit || a->chan_per_block < 1)
    return (int)cudaErrorInvalidValue;
  if (a->mode == 2 && (a->mom_ty != kMomTY || a->mom_tx != kMomTX ||
                       a->chan_per_block < a->nchan))
    return (int)cudaErrorInvalidValue;
  if (a->mode != 1) {
    const long long plane = (long long)a->y.n_in * a->x.n_in;
    cudaError_t err = cudaMemsetAsync(a->flags, 0, sizeof(int) * a->nchan, s);
    if (err != cudaSuccess) return (int)err;
    const int per_chan =
        (int)((plane + 1023) / 1024 < 64 ? (plane + 1023) / 1024 : 64);
    chan_flags_kernel<<<a->nchan * per_chan, 256, 0, s>>>(a->raw, plane,
                                                          per_chan, a->flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int bytes = 4 * L.total;
  switch (a->mode) {
    case 0: return (int)launch<0>(*a, bytes, s);
    case 1: return (int)launch<1>(*a, bytes, s);
    case 2: return (int)launch<2>(*a, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
//                   G = R @ M (rank r), given as per-row band descriptors:
//                   output row o reads input rows start[o] + k with weight
//                   taps[i][o][k];
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
// operators as strip matmuls.  Here a block owns a tile of outputs and
// stages in shared memory the input window its taps read: the rows from the
// first tap of its first output row to the last tap of its last (the G
// bands for the clean branch, y0 - half .. y0 + 1 + L - 1 - half for the
// chain), likewise for columns, so a rescaled target simply gets a wider
// window.  The chain evaluates the normalized convolution only on the grid
// of input points the block's resample taps read (rows y0 .. y0 + 1 of its
// outputs), in the order and roundings of the plain version
// (kernels/conv_reproject.py::conv_reproject_plain: y taps, then x taps, then
// the ranks, __fmul_rn/__fadd_rn so nothing contracts into an FMA), so NaN
// decisions at den ~ 1e-6 agree exactly.  The clean branch uses fmaf.
//
// Mode 2 partitions the outputs by input tile: output (i, j) belongs to the
// block whose 8 x 32 input tile holds (y0[i], x0[j]), and the block walks
// every channel of its tile, so each input spaxel is accumulated exactly
// once, by the same per-spaxel code and chunk order as the moments kernel
// (moments_acc.cuh): its planes equal moments.cu's bit for bit, and its cube
// output equals mode 0's, since every output is the same function of the
// same window values.
//
// What bounds it on an H100: float32 arithmetic and shared-memory traffic.
// A clean output costs about r * (Wy * SX / TX + Wx) FMAs (W = L + 1 taps of
// G, SX the window width of a TX-wide tile), each with a shared-memory
// operand and a tap from L1; a NaN channel about twice the chain's; device
// memory sees each input voxel ~(1 + halo / tile) times, mostly from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moments_acc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;                    // outputs per thread and pass
constexpr int kOutPerPass = kMaxOut * kThreads;
constexpr int kSmemLimit = 232448;            // bytes a block may use, sm_90
constexpr float kEps = 1e-6f;                 // banded_pallas.py:45

}  // namespace

// Host-side layout, mirrored by kernels/conv_reproject.py (ctypes).
struct SctAxis {
  const int* perm;    // (n_out,) outputs ordered by tile
  const int* off;     // (tiles + 1,) tile t holds perm[off[t] .. off[t+1])
  const int* win0;    // (groups, tiles) first input index of each window
  const int* start;   // (groups, n_out) first input index of each G band
  const float* taps;  // G band weights: (groups, rank, n_out, width) for
                      // y, tap-major (groups, rank, width, n_out) for x
  const float* ktaps; // (rank, klen) flipped convolution taps (modes 0, 2)
  const int* i0;      // (n_out,) resample row: weights w0 at i0, w1 at i0+1
  const float* w0;
  const float* w1;
  int n_in, n_out, tiles, span, width, klen, khalf, max_count;
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
  int mom_ty, mom_tx;        // mode 2: the input tile, mom_ty * mom_tx ==
                             // kThreads (one spaxel per thread)
};

namespace {

// shared-memory layout, in 4-byte words
struct Layout {
  int rows, cols, vin, bin, t, tv, tb, cv, cb, chunk, total, rpp, cy, cx;
};

__host__ __device__ inline bool layout(const SctConvReproject& a,
                                       Layout& L) {
  const int sy = a.y.span, sx = a.x.span;
  if (a.x.max_count > kOutPerPass || sy <= 0 || sx <= 0) return false;
  L.rpp = a.y.max_count < 1 ? 1 : a.y.max_count;
  const int per = kOutPerPass / (a.x.max_count < 1 ? 1 : a.x.max_count);
  if (L.rpp > per) L.rpp = per;
  L.cy = L.cx = 0;
  if (a.mode != 1) {
    L.cy = sy - a.y.klen + 1;
    L.cx = sx - a.x.klen + 1;
    if (L.cy < 1 || L.cx < 1) return false;
  }
  L.rows = 0;
  L.cols = L.rows + a.y.max_count;
  L.vin = L.cols + a.x.max_count;
  L.bin = L.vin + sy * sx;
  L.t = L.bin + sy * sx;
  L.tv = L.t + L.rpp * sx;
  L.tb = L.tv + L.cy * sx;
  L.cv = L.tb + L.cy * sx;
  L.cb = L.cv + L.cy * L.cx;
  L.chunk = L.cb + L.cy * L.cx;
  L.total = L.chunk + (a.mode == 2 ? sct::kChunk * kThreads : 0);
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

// The clean branch for the block's outputs: rows[0..nr) x cols[0..nc),
// sum over ranks of the y pass into t (a warp per output row, the lanes
// along the window's columns, the row's taps broadcast) and the x pass
// into registers (the x taps stored tap-major, so the lanes' loads of
// neighbouring columns' taps coalesce).
__device__ __forceinline__ void clean_branch(
    const SctConvReproject& a, const Layout& L, float* sm, int g, int wy0,
    int wx0, int nr, int nc, float* __restrict__ O) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* rows = (const int*)sm + L.rows;
  const int* cols = (const int*)sm + L.cols;
  const float* vin = sm + L.vin;
  float* t = sm + L.t;
  const int sx = a.x.span;
  const int wy = a.y.width, wx = a.x.width;
  const int ny_out = a.y.n_out, nx_out = a.x.n_out;
  for (int k0 = 0; k0 < nr; k0 += L.rpp) {
    const int nk = min(L.rpp, nr - k0);
    // this thread's outputs of the pass: t offset and column
    float acc[kMaxOut];
    int toff[kMaxOut], col[kMaxOut];
#pragma unroll
    for (int m = 0; m < kMaxOut; ++m) {
      acc[m] = 0.f;
      toff[m] = col[m] = -1;
      const int e = tid + m * kThreads;
      if (e < nk * nc) {
        const int kk = e / nc;
        col[m] = cols[e - kk * nc];
        toff[m] = kk * sx + a.x.start[(long long)g * nx_out + col[m]] - wx0;
      }
    }
    for (int i = 0; i < a.rank; ++i) {
      for (int kk = warp; kk < nk; kk += kThreads / 32) {
        const int row = rows[k0 + kk];
        const float* base =
            vin + (a.y.start[(long long)g * ny_out + row] - wy0) * sx;
        const float* tp =
            a.y.taps + (((long long)g * a.rank + i) * ny_out + row) * wy;
        for (int q = lane; q < sx; q += 32) {
          float v = 0.f;
          for (int o = 0; o < wy; ++o)
            v = fmaf(__ldg(tp + o), base[o * sx + q], v);
          t[kk * sx + q] = v;
        }
      }
      __syncthreads();
      const float* taps =
          a.x.taps + ((long long)g * a.rank + i) * wx * nx_out;
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        if (toff[m] >= 0) {
          const float* tr = t + toff[m];
          const float* tp = taps + col[m];
          float v = 0.f;
          for (int o = 0; o < wx; ++o)
            v = fmaf(__ldg(tp + (long long)o * nx_out), tr[o], v);
          acc[m] += v;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kMaxOut; ++m) {
      if (toff[m] >= 0) {
        const int kk = (tid + m * kThreads) / nc;
        const long long p = (long long)rows[k0 + kk] * nx_out + col[m];
        const bool ok = a.valid == nullptr || a.valid[p] != 0;
        O[p] = ok ? acc[m] : NAN;
      }
    }
  }
}

// The exact chain for a channel that holds NaN (and a non-NaN value).
__device__ __forceinline__ void chain_branch(
    const SctConvReproject& a, const Layout& L, float* sm, int wy0, int wx0,
    int nr, int nc, bool has_bad, float* __restrict__ O) {
  const int tid = threadIdx.x;
  const int* rows = (const int*)sm + L.rows;
  const int* cols = (const int*)sm + L.cols;
  const float* vin = sm + L.vin;
  const float* bin = sm + L.bin;
  float* tv = sm + L.tv;
  float* tb = sm + L.tb;
  float* cv = sm + L.cv;
  float* cb = sm + L.cb;
  const int sx = a.x.span, cy = L.cy, cx = L.cx;
  const int ly = a.y.klen, lx = a.x.klen;
  for (int i = 0; i < a.rank; ++i) {
    const float* ky = a.y.ktaps + i * ly;
    const float* kx = a.x.ktaps + i * lx;
    // y taps over the conv rows, every window column
    for (int e = tid; e < cy * sx; e += kThreads) {
      const int r = e / sx;
      const int q = e - r * sx;
      float v = 0.f, b = 0.f;
      for (int o = 0; o < ly; ++o)
        v = mul_add_rn(v, __ldg(ky + o), vin[(r + o) * sx + q]);
      tv[e] = v;
      if (has_bad) {
        for (int o = 0; o < ly; ++o)
          b = mul_add_rn(b, __ldg(ky + o), bin[(r + o) * sx + q]);
        tb[e] = b;
      }
    }
    __syncthreads();
    // x taps at the conv grid, summed over ranks in rank order
    for (int e = tid; e < cy * cx; e += kThreads) {
      const int r = e / cx;
      const int q = e - r * cx;
      float v = 0.f, b = 0.f;
      for (int o = 0; o < lx; ++o)
        v = mul_add_rn(v, __ldg(kx + o), tv[r * sx + q + o]);
      cv[e] = i == 0 ? v : __fadd_rn(cv[e], v);
      if (has_bad) {
        for (int o = 0; o < lx; ++o)
          b = mul_add_rn(b, __ldg(kx + o), tb[r * sx + q + o]);
        cb[e] = i == 0 ? b : __fadd_rn(cb[e], b);
      }
    }
    __syncthreads();
  }
  // normalize: den = 1 - K * isnan; without a NaN in the window den is 1
  for (int e = tid; e < cy * cx; e += kThreads) {
    const float den = has_bad ? __fsub_rn(1.f, cb[e]) : 1.f;
    const bool nanc = den <= kEps;
    cv[e] = nanc ? 0.f : __fdiv_rn(cv[e], den);
    cb[e] = nanc ? 1.f : 0.f;
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
    const float v = lerp_rn(gx, lerp_rn(gy, cv[ya * cx + xa], fy,
                                        cv[yb * cx + xa]),
                            fx, lerp_rn(gy, cv[ya * cx + xb], fy,
                                        cv[yb * cx + xb]));
    const float wn = lerp_rn(gx, lerp_rn(gy, cb[ya * cx + xa], fy,
                                         cb[yb * cx + xa]),
                             fx, lerp_rn(gy, cb[ya * cx + xb], fy,
                                         cb[yb * cx + xb]));
    const long long p = (long long)row * nx_out + col;
    const bool ok = a.valid == nullptr || a.valid[p] != 0;
    O[p] = (ok && !(wn > kEps)) ? v : NAN;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
conv_reproject_kernel(const SctConvReproject a) {
  extern __shared__ float sm[];
  Layout L;
  layout(a, L);
  const int tid = threadIdx.x;
  const int ty = blockIdx.x / a.x.tiles;
  const int tx = blockIdx.x - ty * a.x.tiles;
  const int rb = a.y.off[ty], nr = a.y.off[ty + 1] - rb;
  const int cb = a.x.off[tx], nc = a.x.off[tx + 1] - cb;
  int* rows = (int*)sm + L.rows;
  int* cols = (int*)sm + L.cols;
  for (int k = tid; k < nr; k += kThreads) rows[k] = a.y.perm[rb + k];
  for (int k = tid; k < nc; k += kThreads) cols[k] = a.x.perm[cb + k];
  float* vin = sm + L.vin;
  float* bin = sm + L.bin;
  const int sy = a.y.span, sx = a.x.span;
  const int ny_in = a.y.n_in, nx_in = a.x.n_in;
  const long long plane = (long long)ny_in * nx_in;
  const long long out_plane = (long long)a.y.n_out * a.x.n_out;

  // mode 2: this thread's spaxel of the block's input tile
  int my = 0, mx = 0;
  if (kMode == 2) {
    my = ty * a.mom_ty + tid / a.mom_tx;
    mx = tx * a.mom_tx + tid % a.mom_tx;
  }
  const bool mine = kMode == 2 && my < ny_in && mx < nx_in;
  sct::MomentAcc acc;
  acc.init();
  float* slots = sm + L.chunk + tid;

  const int c_begin = blockIdx.y * a.chan_per_block;
  const int c_end = min(a.nchan, c_begin + a.chan_per_block);
  __syncthreads();
  for (int c = c_begin; c < c_end; ++c) {
    const int g = a.group_idx != nullptr ? a.group_idx[c] : 0;
    const int fl = kMode == 1 ? 1 : a.flags[c];
    const int wy0 = a.y.win0[g * a.y.tiles + ty];
    const int wx0 = a.x.win0[g * a.x.tiles + tx];
    const float* Z = a.raw + (long long)c * plane;
    float* O = a.out + (long long)c * out_plane;
    const bool some = fl & 1, dirty = (fl & 2) != 0;
    if (kMode != 2 && !some) {
      for (int e = tid; e < nr * nc; e += kThreads) {
        const int kk = e / nc;
        O[(long long)rows[kk] * a.x.n_out + cols[e - kk * nc]] = NAN;
      }
      continue;
    }
    // stage the window: values with NaN as 0, and, for a channel that
    // holds NaN, the NaN flags
    bool bad = false;
    for (int e = tid; e < sy * sx; e += kThreads) {
      const int r = e / sx;
      const int q = e - r * sx;
      const int gy = wy0 + r, gx = wx0 + q;
      float v = 0.f, b = 0.f;
      if (gy >= 0 && gy < ny_in && gx >= 0 && gx < nx_in) {
        const float d = Z[(long long)gy * nx_in + gx];
        if (kMode != 1 && dirty && isnan(d)) {
          b = 1.f;
          bad = true;
        } else {
          v = d;
        }
      }
      vin[e] = v;
      if (dirty) bin[e] = b;
    }
    const bool has_bad = __syncthreads_or(bad);
    if (kMode == 2) {
      const int j = c % sct::kChunk;
      if (j == 0) acc.begin_chunk();
      if (mine) {
        const int w = (my - wy0) * sx + (mx - wx0);
        const float v = dirty && bin[w] != 0.f ? NAN : vin[w];
        bool ok = isfinite(v) && sct::passes(v, a.cmp_op, a.thr);
        if (a.include != nullptr)
          ok = ok && a.include[(long long)c * plane +
                               (long long)my * nx_in + mx] != 0;
        acc.add(v, ok, __ldg(a.xc + c), slots + j * kThreads);
        if (j == sct::kChunk - 1 || c == a.nchan - 1)
          acc.end_chunk(slots, kThreads, j + 1, a.xc + c - j, true);
      }
    }
    if (!some) {
      for (int e = tid; e < nr * nc; e += kThreads) {
        const int kk = e / nc;
        O[(long long)rows[kk] * a.x.n_out + cols[e - kk * nc]] = NAN;
      }
    } else if (kMode == 1 || !dirty) {
      clean_branch(a, L, sm, g, wy0, wx0, nr, nc, O);
    } else {
      chain_branch(a, L, sm, wy0, wx0, nr, nc, has_bad, O);
    }
    __syncthreads();
  }
  if (mine) {
    acc.store(a.planes, a.count, plane, (long long)my * nx_in + mx, true);
  }
}

template <int kMode>
cudaError_t launch(const SctConvReproject& a, int bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_reproject_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int groups = (a.nchan + a.chan_per_block - 1) / a.chan_per_block;
  conv_reproject_kernel<kMode>
      <<<dim3((unsigned)(a.y.tiles * a.x.tiles), (unsigned)groups), kThreads,
         bytes, s>>>(a);
  return cudaGetLastError();
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
  if (a->mode == 2 && (a->mom_ty * a->mom_tx != kThreads ||
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

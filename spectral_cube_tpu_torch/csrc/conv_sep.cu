// Per-channel separable normalized convolution of a (nchan, ny, nx)
// float32 cube, zero-fill boundary, NaN interpolation.
//
// Replaces the TPU kernels spectral_cube_tpu/ops/banded_pallas.py::
// per_channel_conv_strips and ::per_channel_conv_strips_blocked.  On the
// TPU they apply dense (m, K) strips of the banded matrices My/Mx on the
// MXU, channel by channel or cb channels per grid step; here the operator
// is its 1-D taps, and which channels a block takes is only a launch
// detail, so one kernel serves both.
//
//   out[c] = sum_i My[g,i] @ X[c] @ Mx[g,i]^T,   g = group_idx[c]
//
// with the taps flipped and offset as ops/smoothing._banded_conv_matrix
// builds them (tap o reads input index y + o - half).  Normalized
// convolution: num = conv(X with non-finite values set to 0), den = 1 -
// conv(isnan-or-inf flags), out = num / den where den > 1e-6, else NaN;
// a channel with no finite value is NaN (banded_pallas.py:586-594).  The
// zero fill outside the plane counts as valid weight.  A tile whose halo
// holds only finite values has den == 1 exactly, so it skips the
// denominator pass, as the TPU kernel's pl.when skips clean channels.
//
// What bounds it on an H100: float32 FMA issue.  A voxel needs about
// rank * (ly * W / TX + lx) FMAs (W = TX + lx - 1 the y pass's halo width),
// twice that in tiles whose halo holds a non-finite value; device memory
// sees each voxel about (1 + halo) times, mostly from L2.  An SM issues
// four warp-wide FMAs per cycle but one warp-wide shared-memory load, so
// the design keeps at most about one shared load per four FMAs:
//
// - A block owns a 32-row by TX-column output tile (TX a multiple of 8 up
//   to 120, chosen on the host so that W stays within 127 columns).
// - The y pass: a thread computes 8 consecutive rows of one column for
//   every rank at once, from a sliding window of 11 input rows held in
//   registers; each input load feeds 8 * RANK FMAs and each tap, read as
//   a block-uniform float4 broadcast, 8 FMAs.  Its results go to a shared
//   (RANK, 32, W) buffer.
// - The x pass: a thread (lane = output row) computes 8 consecutive
//   columns from a sliding window along its row, per rank, into registers
//   summed over ranks; 4 taps per float4 broadcast, one load per 8 FMAs.
// - The taps and the halo stream through shared memory in fixed chunks
//   (y taps in chunks of 24 or 32, x taps in chunks of 64, the halo rows
//   and columns each chunk reads), accumulating partial sums, so shared
//   memory depends on the rank only and every tap length runs.
// - The halo is staged with 16-byte loads from a 4-aligned column (the
//   plane's row length a multiple of 4), masked at the plane's edges.
// - No integer division in the FMA loops.  fp32 FMA only (no TF32).
//
// A small first kernel marks the channels that hold any finite value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileY = 32;       // output rows of a tile: one per lane
constexpr int kBlk = 8;          // outputs per thread along a pass
constexpr int kMaxW = 127;       // y-pass columns of one chunk, at most
constexpr int kPitchT = 127;     // odd: lanes on rows read distinct banks
constexpr int kPitchIn = 132;    // staged columns: kMaxW + 3 alignment, x4
constexpr int kChunkX = 64;      // x taps per chunk
constexpr int kMaxTileX = 120;
constexpr float kDenEps = 1e-6f;  // banded_pallas.py:45

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// y taps per chunk: 24 at rank 5, so that two blocks share an SM (ranks
// up to 4 fit two blocks at 32; ranks 6 to 8 take one block for their
// registers), else 32
template <int RANK>
__host__ __device__ constexpr int chunk_y() { return RANK == 5 ? 24 : 32; }

template <int RANK>
__host__ __device__ constexpr int smem_floats() {
  return chunk_y<RANK>() * round4(RANK)            // y taps, [o][rank]
         + RANK * kChunkX                          // x taps, [rank][o]
         + (kTileY + chunk_y<RANK>() - 1) * kPitchIn  // staged halo
         + RANK * kTileY * kPitchT;                // y-pass results
}

__global__ void channel_flags_kernel(const float* __restrict__ data,
                                     long long plane, int blocks_per_chan,
                                     int* __restrict__ flags) {
  const int c = blockIdx.x / blocks_per_chan;
  const int b = blockIdx.x - c * blocks_per_chan;
  const float* x = data + (long long)c * plane;
  bool fin = false;
  for (long long i = (long long)b * blockDim.x + threadIdx.x; i < plane;
       i += (long long)blocks_per_chan * blockDim.x) {
    if (isfinite(x[i])) {
      fin = true;
      break;
    }
  }
  fin = __syncthreads_or(fin);
  if (fin && threadIdx.x == 0) atomicOr(flags + c, 1);
}

struct Tile {
  const float* X;   // the channel's plane
  int ny, nx, y0, x0, hy, hx, tx;
};

// Stage rows [0, nrows) x columns [0, ncols) of the chunk's halo, whose
// (0, 0) is input (gy0, gx0), as values (non-finite -> 0) or as
// non-finite flags; zero outside the plane and outside the chunk's true
// window (rows >= vrows, columns >= vcols: read only through zero taps).
// Shared column k holds input column gxa + k, gxa = gx0 rounded down to a
// multiple of 4.  Returns whether a staged value was non-finite.
__device__ __forceinline__ bool stage(const Tile& t, float* __restrict__ in,
                                      int gy0, int gx0, int nrows, int vrows,
                                      int ncols, int vcols, bool flags) {
  const int gxa = gx0 - (gx0 & 3);
  const int s = gx0 - gxa;
  const int nq = (s + ncols + 3) >> 2;  // float4s per row
  const bool vec = (t.nx & 3) == 0;
  bool bad = false;
  for (int e = threadIdx.x; e < nrows * nq; e += kThreads) {
    const int r = e / nq;
    const int m = e - r * nq;
    const int gy = gy0 + r;
    const int gx = gxa + 4 * m;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < t.ny && r < vrows) {
      const float* row = t.X + (long long)gy * t.nx;
      if (vec && gx >= 0 && gx + 3 < t.nx) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + gx));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (gx + k >= 0 && gx + k < t.nx) v[k] = __ldg(row + gx + k);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * m + k - s;
      const bool inside = col >= 0 && col < vcols;
      const bool fin = isfinite(v[k]);
      bad |= inside && !fin;
      v[k] = !inside ? 0.f : flags ? (fin ? 0.f : 1.f) : (fin ? v[k] : 0.f);
    }
    *reinterpret_cast<float4*>(in + r * kPitchIn + 4 * m) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  return bad;
}

// y pass of one chunk of nt4 taps (a multiple of 4) over W columns:
// t[i][row][q] (+)= sum_o ky[o][i] * in[row + o][s + q] for the 32 rows,
// a thread taking rows 8g .. 8g + 7 of column q.
template <int RANK>
__device__ __forceinline__ void y_pass(const float* __restrict__ in,
                                       const float* __restrict__ kys,
                                       float* __restrict__ tb, int s, int W,
                                       int nt4, bool first) {
  constexpr int RP = round4(RANK);
  const int q = threadIdx.x & 127;
  if (q >= W) return;
  for (int g = threadIdx.x >> 7; g < kTileY / kBlk; g += kThreads / 128) {
    float acc[RANK][kBlk];
#pragma unroll
    for (int i = 0; i < RANK; ++i)
#pragma unroll
      for (int k = 0; k < kBlk; ++k) acc[i][k] = 0.f;
    const float* col = in + g * kBlk * kPitchIn + s + q;
    float w[kBlk + 3];
#pragma unroll
    for (int k = 0; k < kBlk - 1; ++k) w[k] = col[k * kPitchIn];
    for (int o = 0; o < nt4; o += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[kBlk - 1 + k] = col[(o + kBlk - 1 + k) * kPitchIn];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float tap[RP];
#pragma unroll
        for (int j = 0; j < RP; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(kys + (o + p) * RP + j);
          tap[j] = v.x; tap[j + 1] = v.y; tap[j + 2] = v.z; tap[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RANK; ++i)
#pragma unroll
          for (int k = 0; k < kBlk; ++k)
            acc[i][k] = fmaf(tap[i], w[p + k], acc[i][k]);
      }
#pragma unroll
      for (int k = 0; k < kBlk - 1; ++k) w[k] = w[k + 4];
    }
#pragma unroll
    for (int i = 0; i < RANK; ++i)
#pragma unroll
      for (int k = 0; k < kBlk; ++k) {
        float* d = tb + (i * kTileY + g * kBlk + k) * kPitchT + q;
        *d = first ? acc[i][k] : *d + acc[i][k];
      }
  }
}

// x pass of one chunk of ncx4 taps: acc[h][k] += sum_i sum_p kx[i][p] *
// t[i][lane][8 jb + k + p], jb = warp + 8 h, each rank's sum taken on its
// own and then added, in the plain version's order.
template <int RANK>
__device__ __forceinline__ void x_pass(const float* __restrict__ tb,
                                       const float* __restrict__ kxs,
                                       int ncx4, int tx,
                                       float (&acc)[2][kBlk]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jb = warp + (kThreads / 32) * h;
    if (jb * kBlk < tx) {
      for (int i = 0; i < RANK; ++i) {
        const float* row = tb + (i * kTileY + lane) * kPitchT + jb * kBlk;
        const float* kx = kxs + i * kChunkX;
        float w[kBlk + 3], a[kBlk];
#pragma unroll
        for (int k = 0; k < kBlk; ++k) a[k] = 0.f;
#pragma unroll
        for (int k = 0; k < kBlk - 1; ++k) w[k] = row[k];
        for (int p0 = 0; p0 < ncx4; p0 += 4) {
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
#pragma unroll
        for (int k = 0; k < kBlk; ++k) acc[h][k] += a[k];
      }
    }
  }
}

// The whole convolution of one tile, numerator or denominator: x-tap
// chunks outside, y-tap chunks inside, into acc.  Returns whether a
// staged value was non-finite (this thread's part).
template <int RANK>
__device__ __forceinline__ bool convolve_tile(const Tile& t, float* __restrict__ sm,
                              const float* __restrict__ yt,
                              const float* __restrict__ xt, int ly, int lx,
                              bool flags, float (&acc)[2][kBlk]) {
  constexpr int CY = chunk_y<RANK>();
  constexpr int RP = round4(RANK);
  float* kys = sm;
  float* kxs = kys + CY * RP;
  float* in = kxs + RANK * kChunkX;
  float* tb = in + (kTileY + CY - 1) * kPitchIn;
  bool bad = false;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < kBlk; ++k) acc[h][k] = 0.f;
  for (int ox = 0; ox < lx; ox += kChunkX) {
    const int ncx = min(kChunkX, lx - ox), ncx4 = round4(ncx);
    const int W = t.tx + ncx4 - 1;      // y-pass columns the x pass reads
    const int gx0 = t.x0 - t.hx + ox;
    for (int oy = 0; oy < ly; oy += CY) {
      const int nt = min(CY, ly - oy), nt4 = round4(nt);
      __syncthreads();  // the previous passes are done with in, kxs, tb
      for (int e = threadIdx.x; e < CY * RP; e += kThreads) {
        const int o = e / RP, i = e - o * RP;
        kys[e] = (o < nt && i < RANK) ? yt[i * ly + oy + o] : 0.f;
      }
      if (oy == 0) {
        for (int e = threadIdx.x; e < RANK * kChunkX; e += kThreads) {
          const int i = e / kChunkX, p = e - i * kChunkX;
          kxs[e] = p < ncx ? xt[i * lx + ox + p] : 0.f;
        }
      }
      bad |= stage(t, in, t.y0 - t.hy + oy, gx0, kTileY + nt4 - 1,
                   kTileY + nt - 1, W, t.tx + ncx - 1, flags);
      __syncthreads();
      y_pass<RANK>(in, kys, tb, gx0 & 3, W, nt4, oy == 0);
    }
    __syncthreads();
    x_pass<RANK>(tb, kxs, ncx4, t.tx, acc);
  }
  return bad;
}

template <int RANK>
__global__ void __launch_bounds__(kThreads)
conv_sep_kernel(const float* __restrict__ data,
                const float* __restrict__ ytaps,
                const float* __restrict__ xtaps,
                const int* __restrict__ group_idx,
                const int* __restrict__ flags, int nchan, int ny, int nx,
                int ly, int lx, int hy, int hx, int tx,
                float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const long long plane = (long long)ny * nx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = blockIdx.y * kTileY + lane;
  for (int c = blockIdx.z; c < nchan; c += gridDim.z) {
    Tile t{data + (long long)c * plane, ny, nx, (int)blockIdx.y * kTileY,
           (int)blockIdx.x * tx, hy, hx, tx};
    float* O = out + (long long)c * plane;
    float num[2][kBlk], nbad[2][kBlk];
    bool has_bad = false;
    const bool some = flags[c] & 1;
    if (some) {
      const int g = group_idx[c];
      const float* yt = ytaps + (long long)g * RANK * ly;
      const float* xt = xtaps + (long long)g * RANK * lx;
      has_bad = __syncthreads_or(
          convolve_tile<RANK>(t, sm, yt, xt, ly, lx, false, num));
      if (has_bad) convolve_tile<RANK>(t, sm, yt, xt, ly, lx, true, nbad);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = t.x0 + (warp + (kThreads / 32) * h) * kBlk;
      if ((warp + (kThreads / 32) * h) * kBlk >= tx || y >= ny || x >= nx)
        continue;
      float o[kBlk];
#pragma unroll
      for (int k = 0; k < kBlk; ++k) {
        o[k] = NAN;
        if (some) {
          o[k] = num[h][k];
          if (has_bad) {
            const float den = 1.f - nbad[h][k];
            o[k] = den > kDenEps ? o[k] / den : NAN;
          }
        }
      }
      float* dst = O + (long long)y * nx + x;
      if ((nx & 3) == 0 && x + kBlk <= nx) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int k = 0; k < kBlk; ++k)
          if (x + k < nx) dst[k] = o[k];
      }
    }
    __syncthreads();  // shared memory is reused by the next channel
  }
}

template <int RANK>
cudaError_t launch(const float* data, const float* yt, const float* xt,
                   const int* gi, const int* flags, int nchan, int ny, int nx,
                   int ly, int lx, int hy, int hx, float* out,
                   cudaStream_t s) {
  const int bytes = 4 * smem_floats<RANK>();
  cudaError_t err = cudaFuncSetAttribute(
      conv_sep_kernel<RANK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  // the widest tile (a multiple of 8) whose first x chunk's y-pass width
  // TX + round4(taps) - 1 stays within kMaxW
  const int c4 = round4(lx < kChunkX ? lx : kChunkX);
  int tx = (kMaxW + 1 - c4) / kBlk * kBlk;
  if (tx > kMaxTileX) tx = kMaxTileX;
  const dim3 grid((unsigned)((nx + tx - 1) / tx),
                  (unsigned)((ny + kTileY - 1) / kTileY),
                  (unsigned)(nchan < 65535 ? nchan : 65535));
  conv_sep_kernel<RANK><<<grid, kThreads, bytes, s>>>(
      data, yt, xt, gi, flags, nchan, ny, nx, ly, lx, hy, hx, tx, out);
  return cudaGetLastError();
}

}  // namespace

// data/out: (nchan, ny, nx) float32; ytaps: (G, rank, ly) and xtaps:
// (G, rank, lx) float32, already flipped; group_idx: (nchan,) int32;
// flags: (nchan,) int32 scratch.  hy/hx: the taps' centre offsets.  Any
// tap lengths; rank 1 to 8.
extern "C" int sct_conv_sep(const void* data, const void* ytaps,
                            const void* xtaps, const void* group_idx,
                            void* flags, int nchan, int ny, int nx, int rank,
                            int ly, int lx, int hy, int hx, void* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nchan <= 0 || ny <= 0 || nx <= 0) return (int)cudaSuccess;
  if (rank < 1 || rank > 8 || ly < 1 || lx < 1)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)ny * nx;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * nchan, s);
  if (err != cudaSuccess) return (int)err;
  const int per_chan = (int)((plane + 1023) / 1024 < 64 ? (plane + 1023) / 1024
                                                         : 64);
  channel_flags_kernel<<<nchan * per_chan, 256, 0, s>>>(
      (const float*)data, plane, per_chan, (int*)flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* d = (const float*)data;
  const float* yt = (const float*)ytaps;
  const float* xt = (const float*)xtaps;
  const int* gi = (const int*)group_idx;
  const int* fl = (const int*)flags;
  float* o = (float*)out;
#define SCT_CONV_SEP_RANK(R)                                              \
  case R:                                                                 \
    return (int)launch<R>(d, yt, xt, gi, fl, nchan, ny, nx, ly, lx, hy, hx, \
                          o, s);
  switch (rank) {
    SCT_CONV_SEP_RANK(1)
    SCT_CONV_SEP_RANK(2)
    SCT_CONV_SEP_RANK(3)
    SCT_CONV_SEP_RANK(4)
    SCT_CONV_SEP_RANK(5)
    SCT_CONV_SEP_RANK(6)
    SCT_CONV_SEP_RANK(7)
    SCT_CONV_SEP_RANK(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCT_CONV_SEP_RANK
}

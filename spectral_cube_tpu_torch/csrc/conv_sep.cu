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
// a channel with no finite value is NaN (banded_pallas.py:586-594).  A
// tile whose halo holds only finite values has den == 1 exactly, so it
// skips the denominator pass, as the TPU kernel's pl.when skips clean
// channels.
//
// What bounds it on an H100: arithmetic and shared-memory traffic, about
// rank * (ky * (1 + (kx - 1) / 32) + kx) FMAs per voxel (twice that in
// tiles that hold NaN), each reading one shared-memory operand; device
// memory sees each voxel about (1 + halo) times, mostly from L2.  The design
// stages one output tile plus its halo in shared memory once, runs the y
// pass into a shared (tile rows x halo width) buffer and the x pass into
// registers, summed over ranks, with fp32 FMA only (no TF32).  A small
// first kernel marks the channels that hold any finite value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;     // output tile width: one warp
constexpr int kRowsPerPass = 8;
constexpr int kMaxRowTiles = 4;  // tile height <= 32
constexpr int kThreads = kTileX * kRowsPerPass;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr float kDenEps = 1e-6f;    // banded_pallas.py:45

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

__global__ void __launch_bounds__(kThreads)
conv_sep_kernel(const float* __restrict__ data,
                const float* __restrict__ ytaps,
                const float* __restrict__ xtaps,
                const int* __restrict__ group_idx,
                const int* __restrict__ flags, int ny, int nx, int rank,
                int ly, int lx, int hy, int hx, int tile_y, int tiles_x,
                int tiles_y, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tiles = tiles_x * tiles_y;
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x - c * tiles;
  const int x0 = (tile % tiles_x) * kTileX;
  const int y0 = (tile / tiles_x) * tile_y;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int hrows = tile_y + ly - 1;
  const int width = kTileX + lx - 1;
  const int nk = tile_y / kRowsPerPass;
  const long long plane = (long long)ny * nx;
  const float* X = data + (long long)c * plane;
  float* O = out + (long long)c * plane;

  if (!(flags[c] & 1)) {
    for (int k = 0; k < nk; ++k) {
      const int y = y0 + threadIdx.y + kRowsPerPass * k;
      const int x = x0 + threadIdx.x;
      if (y < ny && x < nx) O[(long long)y * nx + x] = NAN;
    }
    return;
  }

  float* fy = smem;                  // rank * ly, flipped y taps
  float* fx = fy + rank * ly;        // rank * lx, flipped x taps
  float* vin = fx + rank * lx;       // hrows * width, filled values
  float* bin = vin + hrows * width;  // hrows * width, non-finite flags
  float* tv = bin + hrows * width;   // tile_y * width, y-pass of vin
  float* tb = tv + tile_y * width;   // tile_y * width, y-pass of bin

  const int g = group_idx[c];
  for (int i = tid; i < rank * ly; i += kThreads)
    fy[i] = ytaps[(long long)g * rank * ly + i];
  for (int i = tid; i < rank * lx; i += kThreads)
    fx[i] = xtaps[(long long)g * rank * lx + i];

  bool bad = false;
  for (int i = tid; i < hrows * width; i += kThreads) {
    const int r = i / width;
    const int q = i - r * width;
    const int gy = y0 - hy + r;
    const int gx = x0 - hx + q;
    float v = 0.f, b = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const float d = X[(long long)gy * nx + gx];
      if (isfinite(d)) {
        v = d;
      } else {
        b = 1.f;
        bad = true;
      }
    }
    vin[i] = v;
    bin[i] = b;
  }
  const bool has_bad = __syncthreads_or(bad);

  float num[kMaxRowTiles] = {0.f, 0.f, 0.f, 0.f};
  float nbad[kMaxRowTiles] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < rank; ++i) {
    const float* ky = fy + i * ly;
    const float* kx = fx + i * lx;
    for (int e = tid; e < tile_y * width; e += kThreads) {
      const int r = e / width;
      const int q = e - r * width;
      float a = 0.f;
      for (int o = 0; o < ly; ++o) a = fmaf(ky[o], vin[(r + o) * width + q], a);
      tv[e] = a;
      if (has_bad) {
        float ab = 0.f;
        for (int o = 0; o < ly; ++o)
          ab = fmaf(ky[o], bin[(r + o) * width + q], ab);
        tb[e] = ab;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxRowTiles; ++k) {
      if (k < nk) {
        const int row = (threadIdx.y + kRowsPerPass * k) * width + threadIdx.x;
        float a = 0.f;
        for (int o = 0; o < lx; ++o) a = fmaf(kx[o], tv[row + o], a);
        num[k] += a;
        if (has_bad) {
          float ab = 0.f;
          for (int o = 0; o < lx; ++o) ab = fmaf(kx[o], tb[row + o], ab);
          nbad[k] += ab;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxRowTiles; ++k) {
    if (k < nk) {
      const int y = y0 + threadIdx.y + kRowsPerPass * k;
      const int x = x0 + threadIdx.x;
      if (y < ny && x < nx) {
        float o = num[k];
        if (has_bad) {
          const float den = 1.f - nbad[k];
          o = den > kDenEps ? o / den : NAN;
        }
        O[(long long)y * nx + x] = o;
      }
    }
  }
}

long long smem_bytes(int rank, int ly, int lx, int tile_y) {
  const long long width = kTileX + lx - 1;
  return 4LL * (rank * (ly + lx) + 2LL * (tile_y + ly - 1) * width +
                2LL * tile_y * width);
}

}  // namespace

// Tile height the launcher will use for these tap lengths, or 0 when no
// tile fits the shared memory of one block.
extern "C" int sct_conv_sep_tile_y(int rank, int ly, int lx) {
  for (int t = kTileX; t >= kRowsPerPass; t /= 2)
    if (smem_bytes(rank, ly, lx, t) <= kSmemLimit) return t;
  return 0;
}

// data/out: (nchan, ny, nx) float32; ytaps: (G, rank, ly) and xtaps:
// (G, rank, lx) float32, already flipped; group_idx: (nchan,) int32;
// flags: (nchan,) int32 scratch.  hy/hx: the taps' centre offsets.
extern "C" int sct_conv_sep(const void* data, const void* ytaps,
                            const void* xtaps, const void* group_idx,
                            void* flags, int nchan, int ny, int nx, int rank,
                            int ly, int lx, int hy, int hx, void* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nchan <= 0 || ny <= 0 || nx <= 0) return (int)cudaSuccess;
  const int tile_y = sct_conv_sep_tile_y(rank, ly, lx);
  if (tile_y == 0) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)ny * nx;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * nchan, s);
  if (err != cudaSuccess) return (int)err;
  const int per_chan = (int)((plane + 1023) / 1024 < 64 ? (plane + 1023) / 1024
                                                         : 64);
  channel_flags_kernel<<<nchan * per_chan, 256, 0, s>>>(
      (const float*)data, plane, per_chan, (int*)flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long bytes = smem_bytes(rank, ly, lx, tile_y);
  err = cudaFuncSetAttribute(conv_sep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (nx + kTileX - 1) / kTileX;
  const int tiles_y = (ny + tile_y - 1) / tile_y;
  const long long blocks = (long long)tiles_x * tiles_y * nchan;
  conv_sep_kernel<<<(unsigned)blocks, dim3(kTileX, kRowsPerPass), bytes, s>>>(
      (const float*)data, (const float*)ytaps, (const float*)xtaps,
      (const int*)group_idx, (const int*)flags, ny, nx, rank, ly, lx, hy, hx,
      tile_y, tiles_x, tiles_y, (float*)out);
  return (int)cudaGetLastError();
}

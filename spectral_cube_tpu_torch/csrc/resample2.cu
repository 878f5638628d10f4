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
// write of the output (~8 bytes per voxel for ~12 flops).  One thread per
// output pixel, x fastest, so neighbouring threads read neighbouring input
// columns and the 2x2 footprints of a warp share cache lines.
//
// sct_resample2_filled replaces spectral_cube_tpu/ops/banded_pallas.py::
// per_channel_resample_strips, the staged path of a reprojection onto a new
// spectral axis (ops/regrid.py:351-408): the data come NaN-filled (fz) with
// a separate NaN-weight plane (wz, the spectrally lerped NaN mask, so
// fractional), and
//
//   out = sum w * fz,  NaN where sum w * wz > 1e-6, where valid_plane is 0
//         and where zvalid[channel] is 0
//
// with the same taps, the poison test only in channels whose flag is 1.
// The caller flags every channel whose wz is not all zero; an unflagged
// channel never reads wz, as the TPU kernel skips its weight pass for an
// all-zero block (banded_pallas.py:876), and the plain version skips the
// test in the same channels.  Bound by device
// memory: fz and wz read once, out written once.  Both entries add in the
// plain version's order with __fmul_rn/__fadd_rn (no FMA contraction), so
// the filled entry and kernels/resample2.py::resample2_filled_plain agree
// bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr float kPoison = 1e-6f;   // banded_pallas.py:45

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

__global__ void __launch_bounds__(kTileX * kTileY)
resample2_kernel(const float* __restrict__ raw, const int* __restrict__ y0,
                 const float* __restrict__ wy, const int* __restrict__ x0,
                 const float* __restrict__ wx,
                 const uint8_t* __restrict__ valid_plane,
                 const uint8_t* __restrict__ zvalid, int ny_in, int nx_in,
                 int ny_out, int nx_out, int tiles_x, int tiles_y,
                 float* __restrict__ out) {
  const int tiles = tiles_x * tiles_y;
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x - c * tiles;
  const int x = (tile % tiles_x) * kTileX + threadIdx.x;
  const int y = (tile / tiles_x) * kTileY + threadIdx.y;
  if (x >= nx_out || y >= ny_out) return;
  const long long o = ((long long)c * ny_out + y) * nx_out + x;
  if (!zvalid[c] || !valid_plane[(long long)y * nx_out + x]) {
    out[o] = NAN;
    return;
  }
  const int ya = y0[y];
  const int yb = min(ya + 1, ny_in - 1);
  const int xa = x0[x];
  const int xb = min(xa + 1, nx_in - 1);
  const float fy = wy[y], gy = 1.f - fy;
  const float fx = wx[x], gx = 1.f - fx;
  const float* Z = raw + (long long)c * ny_in * nx_in;
  const float zaa = Z[(long long)ya * nx_in + xa];
  const float zba = Z[(long long)yb * nx_in + xa];
  const float zab = Z[(long long)ya * nx_in + xb];
  const float zbb = Z[(long long)yb * nx_in + xb];
  // y taps, then x taps: the order of My @ Z @ Mx^T
  const float ta = gy * nan_to_num(zaa) + fy * nan_to_num(zba);
  const float tb = gy * nan_to_num(zab) + fy * nan_to_num(zbb);
  const float v = gx * ta + fx * tb;
  const float na = gy * (float)isnan(zaa) + fy * (float)isnan(zba);
  const float nb = gy * (float)isnan(zab) + fy * (float)isnan(zbb);
  const float wn = gx * na + fx * nb;
  out[o] = wn > kPoison ? NAN : v;
}

// a * ga + b * fa in the plain version's order: two rounded products, one
// rounded sum
__device__ __forceinline__ float lerp_rn(float ga, float a, float fa,
                                         float b) {
  return __fadd_rn(__fmul_rn(ga, a), __fmul_rn(fa, b));
}

__global__ void __launch_bounds__(kTileX * kTileY)
resample2_filled_kernel(const float* __restrict__ fz,
                        const float* __restrict__ wz,
                        const int* __restrict__ wflags,
                        const int* __restrict__ y0,
                        const float* __restrict__ wy,
                        const int* __restrict__ x0,
                        const float* __restrict__ wx,
                        const uint8_t* __restrict__ valid_plane,
                        const uint8_t* __restrict__ zvalid, int ny_in,
                        int nx_in, int ny_out, int nx_out, int tiles_x,
                        int tiles_y, float* __restrict__ out) {
  const int tiles = tiles_x * tiles_y;
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x - c * tiles;
  const int x = (tile % tiles_x) * kTileX + threadIdx.x;
  const int y = (tile / tiles_x) * kTileY + threadIdx.y;
  if (x >= nx_out || y >= ny_out) return;
  const long long o = ((long long)c * ny_out + y) * nx_out + x;
  if (!zvalid[c] || !valid_plane[(long long)y * nx_out + x]) {
    out[o] = NAN;
    return;
  }
  const int ya = y0[y];
  const int yb = min(ya + 1, ny_in - 1);
  const int xa = x0[x];
  const int xb = min(xa + 1, nx_in - 1);
  const float fy = wy[y], gy = __fsub_rn(1.f, fy);
  const float fx = wx[x], gx = __fsub_rn(1.f, fx);
  const long long base = (long long)c * ny_in * nx_in;
  const long long iaa = base + (long long)ya * nx_in + xa;
  const long long iba = base + (long long)yb * nx_in + xa;
  const long long iab = base + (long long)ya * nx_in + xb;
  const long long ibb = base + (long long)yb * nx_in + xb;
  // y taps, then x taps: the order of My @ fz @ Mx^T
  const float v = lerp_rn(gx, lerp_rn(gy, fz[iaa], fy, fz[iba]), fx,
                          lerp_rn(gy, fz[iab], fy, fz[ibb]));
  if (wflags[c]) {
    const float wn = lerp_rn(gx, lerp_rn(gy, wz[iaa], fy, wz[iba]), fx,
                             lerp_rn(gy, wz[iab], fy, wz[ibb]));
    if (wn > kPoison) {
      out[o] = NAN;
      return;
    }
  }
  out[o] = v;
}

}  // namespace

// raw: (nchan, ny_in, nx_in) float32; y0/wy: (ny_out,) int32/float32;
// x0/wx: (nx_out,) int32/float32; valid_plane: (ny_out, nx_out) uint8;
// zvalid: (nchan,) uint8; out: (nchan, ny_out, nx_out) float32.
extern "C" int sct_resample2(const void* raw, const void* y0, const void* wy,
                             const void* x0, const void* wx,
                             const void* valid_plane, const void* zvalid,
                             int nchan, int ny_in, int nx_in, int ny_out,
                             int nx_out, void* out, void* stream) {
  if (nchan <= 0 || ny_out <= 0 || nx_out <= 0) return (int)cudaSuccess;
  const int tiles_x = (nx_out + kTileX - 1) / kTileX;
  const int tiles_y = (ny_out + kTileY - 1) / kTileY;
  const long long blocks = (long long)tiles_x * tiles_y * nchan;
  resample2_kernel<<<(unsigned)blocks, dim3(kTileX, kTileY), 0,
                     (cudaStream_t)stream>>>(
      (const float*)raw, (const int*)y0, (const float*)wy, (const int*)x0,
      (const float*)wx, (const uint8_t*)valid_plane, (const uint8_t*)zvalid,
      ny_in, nx_in, ny_out, nx_out, tiles_x, tiles_y, (float*)out);
  return (int)cudaGetLastError();
}

// fz/wz: (nchan, ny_in, nx_in) float32, fz NaN-filled, wz its NaN weights;
// wflags: (nchan,) int32, 1 where the channel's wz takes the poison test
// (at least wherever wz is not all zero); the other
// arguments as sct_resample2.
extern "C" int sct_resample2_filled(const void* fz, const void* wz,
                                    const void* wflags, const void* y0,
                                    const void* wy, const void* x0,
                                    const void* wx, const void* valid_plane,
                                    const void* zvalid, int nchan, int ny_in,
                                    int nx_in, int ny_out, int nx_out,
                                    void* out, void* stream) {
  if (nchan <= 0 || ny_out <= 0 || nx_out <= 0) return (int)cudaSuccess;
  const int tiles_x = (nx_out + kTileX - 1) / kTileX;
  const int tiles_y = (ny_out + kTileY - 1) / kTileY;
  const long long blocks = (long long)tiles_x * tiles_y * nchan;
  resample2_filled_kernel<<<(unsigned)blocks, dim3(kTileX, kTileY), 0,
                            (cudaStream_t)stream>>>(
      (const float*)fz, (const float*)wz, (const int*)wflags,
      (const int*)y0, (const float*)wy, (const int*)x0, (const float*)wx,
      (const uint8_t*)valid_plane, (const uint8_t*)zvalid, ny_in, nx_in,
      ny_out, nx_out, tiles_x, tiles_y, (float*)out);
  return (int)cudaGetLastError();
}

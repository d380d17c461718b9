// HED's side-output tail: the five side-output logit maps upsampled to the
// padded picture, their mean, the sigmoid, the crop and C channels, in one
// pass.
//
// Replaces no Pallas kernel: the JAX package computes this tail with
// jax.image.resize and numpy after the network (models/hed.py:detect_edges).
// On the card the same tail took a few hundred tiny launches and host numpy
// per picture while the device stood idle; this kernel writes the finished
// (h, w, C) edge map, which the host then copies once.
//
// Side k (k = 0..4) is a (th >> k, tw >> k) float32 map, contiguous. Output
// pixel (y, x), y < h <= th, x < w <= tw, takes side 0 at (y, x) and side
// k >= 1 bilinearly on half-pixel centres: src = (y + 0.5) / 2^k - 0.5, the
// taps floor(src) and floor(src) + 1 clamped to the map, weights 1 - f and
// f. For upsampling this is jax.image.resize's "linear" with its border
// renormalisation (ops/resize.py) and F.interpolate(align_corners=False).
// The five values are summed in side order and divided by 5, then
// 1 / (1 + expf(-m)); all float32, with IEEE division and expf (no fast
// math), so the map stays within ulps of the plain version.
//
// Bound on an H100 by bytes: at 1024 x 768 x 3 it reads 3.1 MB of side 0
// and about 1 MB of the other sides and writes 9.4 MB, about 4 us at
// 3.35 TB/s. One thread an output pixel, a block a stretch of one row
// (blockIdx.y is the row, so no thread divides), x fastest: side 0 and the
// output are read and written by neighbouring threads at neighbouring
// addresses; sides 1-4 are read through the read-only cache, where the
// 2^k neighbouring threads that share a tap find it.

#include <cuda_runtime.h>

namespace {

struct Sides {
  const float* map[5];
};

// side k (k >= 1) at output pixel (y, x): rows blended first, then columns
__device__ __forceinline__ float upsampled(const float* __restrict__ m,
                                           int hk, int wk, float inv, int y,
                                           int x) {
  const float sy = (y + 0.5f) * inv - 0.5f;
  const float sx = (x + 0.5f) * inv - 0.5f;
  const float fy0 = floorf(sy), fx0 = floorf(sx);
  const float fy = sy - fy0, fx = sx - fx0;
  const int y0 = (int)fy0, x0 = (int)fx0;
  // src lies in (-1, n - 0.5): floor(src) >= -1 and floor(src) + 1 <= n
  const int r0 = max(y0, 0) * wk, r1 = min(y0 + 1, hk - 1) * wk;
  const int c0 = max(x0, 0), c1 = min(x0 + 1, wk - 1);
  const float left =
      (1.0f - fy) * __ldg(m + r0 + c0) + fy * __ldg(m + r1 + c0);
  const float right =
      (1.0f - fy) * __ldg(m + r0 + c1) + fy * __ldg(m + r1 + c1);
  return (1.0f - fx) * left + fx * right;
}

__global__ void hed_fuse_kernel(Sides s, float* __restrict__ out, int th,
                                int tw, int w, int channels) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  float sum = s.map[0][(size_t)y * tw + x];
#pragma unroll
  for (int k = 1; k < 5; ++k)
    sum += upsampled(s.map[k], th >> k, tw >> k, 1.0f / (float)(1 << k), y,
                     x);
  const float e = 1.0f / (1.0f + expf(-(sum / 5.0f)));
  float* o = out + ((size_t)y * w + x) * channels;
  for (int c = 0; c < channels; ++c) o[c] = e;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was taken).
extern "C" int dsc_hed_fuse(const float* s0, const float* s1, const float* s2,
                            const float* s3, const float* s4, float* out,
                            int th, int tw, int h, int w, int channels,
                            void* stream) {
  if (th % 16 || tw % 16 || h < 1 || w < 1 || h > th || w > tw ||
      h > 65535 || channels < 1)
    return (int)cudaErrorInvalidValue;
  const Sides s = {{s0, s1, s2, s3, s4}};
  const int threads = 128;
  const dim3 blocks((w + threads - 1) / threads, h);
  hed_fuse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      s, out, th, tw, w, channels);
  return (int)cudaGetLastError();
}

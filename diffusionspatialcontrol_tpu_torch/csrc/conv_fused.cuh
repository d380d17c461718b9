// GroupNorm-affine + SiLU + 3x3 convolution for Hopper (sm_90a): the
// operands, prologue and epilogue shared by K4 (direct convolution,
// csrc/conv_fused.cu) and K5 (implicit GEMM, csrc/conv_fused_v2.cu); what
// their bf16 tensor-core bodies share beyond this is in conv_tc.cuh.
//
//   out[b, y, x, o] = sum_{ky, kx, c} act[b, y+ky-1, x+kx-1, c]
//                                     * w[o, ky, kx, c]
//                     + cb[o] (+ xb[b, o]) (+ skip[b, y, x, o])
//   act = round_T(silu(x * scale[b, c] + shift[b, c])), and 0 outside the
//         image: the zero padding stays zero after the SiLU.
//
// scale/shift are the folded GroupNorm statistics and affine (fp32, per
// (b, c)); xb is the resnet's time-embedding projection (fp32, per (b, o)).
// x, skip and out are NHWC, w is (C_out, 3, 3, C_in) (the port's OIHW
// kernels stored channels_last), all contiguous, of one type T (fp32 or
// bf16). The sum, the biases and the skip are fp32; out is rounded to T
// once. C_in and C_out are multiples of 8, so every channel run of 8 is one
// 16-byte (bf16) or 32-byte (fp32) access.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dscconv {

struct ConvArgs {
  const void* x;       // (B, H, W, C_in) T
  const float* scale;  // (B, C_in) fp32
  const float* shift;  // (B, C_in) fp32
  const void* w;       // (C_out, 3, 3, C_in) T
  const float* cb;     // (C_out,) fp32
  const float* xb;     // (B, C_out) fp32, or null
  const void* skip;    // (B, H, W, C_out) T, or null
  void* out;           // (B, H, W, C_out) T
  int B, H, W, Cin, Cout;
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T's precision, as a float
__device__ __forceinline__ float round_as(const float*, float x) { return x; }
__device__ __forceinline__ float round_as(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// silu(x * s + t) in fp32. The multiply and the add round separately (no
// FMA contraction) and the SiLU is x / (1 + exp(-x)), as the plain
// version's separate tensor ops compute it.
__device__ __forceinline__ float gn_silu(float x, float s, float t) {
  const float a = __fadd_rn(__fmul_rn(x, s), t);
  return a / (1.0f + expf(-a));
}

// The activations of channels ci .. ci+7 at pixel (b, iy, ix), rounded to
// T; all 0 when `inside` is false (padding, or past C_in or the last pixel).
template <typename T>
__device__ __forceinline__ void act8(const ConvArgs& a, int b, int iy, int ix,
                                     int ci, bool inside, float v[8]) {
  if (!inside) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    return;
  }
  const T* x = static_cast<const T*>(a.x);
  load8(x + (((long long)b * a.H + iy) * a.W + ix) * a.Cin + ci, v);
  float s[8], t[8];
  load8(a.scale + (long long)b * a.Cin + ci, s);
  load8(a.shift + (long long)b * a.Cin + ci, t);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = round_as(x, gn_silu(v[j], s[j], t[j]));
}

// acc + cb[o] (+ xb[b, o]) (+ skip[m, o]) in fp32, in the plain version's
// order; m is the flat pixel index (b * H + y) * W + x.
template <typename T>
__device__ __forceinline__ float epilogue(const ConvArgs& a, long long m,
                                          int b, int o, float acc) {
  float r = acc + a.cb[o];
  if (a.xb) r += a.xb[(long long)b * a.Cout + o];
  if (a.skip) r += to_f(static_cast<const T*>(a.skip)[m * a.Cout + o]);
  return r;
}

inline ConvArgs make_args(const void* x, const float* scale,
                          const float* shift, const void* w, const float* cb,
                          const float* xb, const void* skip, void* out, int B,
                          int H, int W, int Cin, int Cout) {
  ConvArgs a;
  a.x = x; a.scale = scale; a.shift = shift; a.w = w; a.cb = cb; a.xb = xb;
  a.skip = skip; a.out = out;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  return a;
}

}  // namespace dscconv

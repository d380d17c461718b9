// K5: fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper, as an
// implicit GEMM.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/conv_fused.py:_kernel_v2,
// the body behind gn_silu_conv3x3_v2 (conv_impl="pallas2"). Same function as
// K4 (conv_fused.cuh); the TPU kernel's CONV_V2_VARIANT forms only work
// around Mosaic layouts and need no counterpart.
//
// The conv is a GEMM of M = B*H*W pixels by N = C_out by K = 9*C_in, with
// K ordered (ky, kx, c) as the weights are stored: (C_out, 3, 3, C_in) is
// the "N x K, K contiguous" operand as it is, so no weight repack happens
// per launch. The A operand is gathered from NHWC on the fly, one tap and
// 32 input channels at a time, through the same affine/SiLU/zero/round
// prologue as K4; the activated input never reaches device memory.
//
// Bound on an H100: operations (see conv_fused.cu: 15.1 GFLOP, ~15 us for
// UNet level 0 at 512^2 at the bf16 tensor-core peak; 155 GFLOP, ~156 us
// for the VAE's 256 -> 128 conv at 512^2). What the design does: bf16
// operands go through the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), so every product is exact and only the order of the
// fp32 sum differs from the plain version. A block of 8 warps owns a
// 128-pixel x 64-channel output tile, each warp 32 x 32 (2 x 4 mma tiles,
// 32 fp32 sums a thread). Shared rows have a pitch of BK + 8 bf16 (20
// words), so the fragment loads of the 8 row groups hit distinct banks.
// fp32 operands (the tests' and the tiny model's type) take the same tiles
// and fragment layout with fp32 FMAs on the CUDA cores, which keeps them
// exact to fp32 rounding. Not done yet: a pipeline of loads (cp.async/TMA)
// against the mma, and wgmma.

#include "conv_fused.cuh"

namespace dscconv {
namespace {

constexpr int BM = 128;  // pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels of one tap per K step
constexpr int NT = 256;  // 8 warps: 4 along M x 2 along N

template <typename T>
__host__ __device__ constexpr int pitch() {  // elements per shared row
  return sizeof(T) == 2 ? BK + 8 : BK + 4;
}

__device__ __forceinline__ void copy8(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst + 4) =
      *reinterpret_cast<const float4*>(src + 4);
}
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void zero8(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero8(__nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// acc[mt][nt] += A[warp rows] x B[warp columns] over one BK step. The
// accumulator layout is mma.sync's m16n8 C fragment: element e of tile
// (mt, nt) is row mt*16 + g + 8*(e / 2), column nt*8 + 2*t4 + e % 2.
__device__ __forceinline__ void mma_step(const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int wm,
                                         int wn, int g, int t4,
                                         float acc[2][4][4]) {
  constexpr int P = pitch<__nv_bfloat16>();
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* p = As + (wm + mt * 16 + g) * P + kk + 2 * t4;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * P);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * P + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* q = Bs + (wn + nt * 8 + g) * P + kk + 2 * t4;
      bfr[nt][0] = *reinterpret_cast<const uint32_t*>(q);
      bfr[nt][1] = *reinterpret_cast<const uint32_t*>(q + 8);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* c = acc[mt][nt];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(af[mt][0]), "r"(af[mt][1]), "r"(af[mt][2]),
              "r"(af[mt][3]), "r"(bfr[nt][0]), "r"(bfr[nt][1]));
      }
  }
}

__device__ __forceinline__ void mma_step(const float* As, const float* Bs,
                                         int wm, int wn, int g, int t4,
                                         float acc[2][4][4]) {
  constexpr int P = pitch<float>();
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[2][2], bv[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      av[mt][0] = As[(wm + mt * 16 + g) * P + k];
      av[mt][1] = As[(wm + mt * 16 + g + 8) * P + k];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bv[nt][0] = Bs[(wn + nt * 8 + 2 * t4) * P + k];
      bv[nt][1] = Bs[(wn + nt * 8 + 2 * t4 + 1) * P + k];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(av[mt][e / 2], bv[nt][e % 2], acc[mt][nt][e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) conv_igemm_kernel(const ConvArgs a) {
  constexpr int P = pitch<T>();
  __shared__ __align__(16) unsigned char smem[(BM + BN) * P * sizeof(T)];
  T* As = reinterpret_cast<T*>(smem);  // [pixel][k]
  T* Bs = As + BM * P;                 // [output channel][k]

  const int hw = a.H * a.W;
  const long long M = (long long)a.B * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int g = lane / 4;
  const int t4 = lane % 4;

  // Loads: A rows threadIdx/4 and threadIdx/4 + 64, B row threadIdx/4, each
  // the 8 channels starting at cv.
  const int cv = (threadIdx.x % 4) * 8;
  int rb[2], ry[2], rx[2];
  bool rv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + threadIdx.x / 4 + 64 * r;
    rv[r] = m < M;
    const int mm = rv[r] ? (int)(m % hw) : 0;
    rb[r] = rv[r] ? (int)(m / hw) : 0;
    ry[r] = mm / a.W;
    rx[r] = mm % a.W;
  }
  const int bo = n0 + threadIdx.x / 4;
  const T* w = static_cast<const T*>(a.w);
  const T* wrow = w + (long long)bo * 9 * a.Cin;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll 1
    for (int c0 = 0; c0 < a.Cin; c0 += BK) {
      __syncthreads();  // the previous step's readers are done
      const int ci = c0 + cv;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int iy = ry[r] + dy;
        const int ix = rx[r] + dx;
        const bool inside = rv[r] && iy >= 0 && iy < a.H && ix >= 0 &&
                            ix < a.W && ci < a.Cin;
        float v[8];
        act8<T>(a, rb[r], iy, ix, ci, inside, v);
        store8(As + (threadIdx.x / 4 + 64 * r) * P + cv, v);
      }
      T* bdst = Bs + (threadIdx.x / 4) * P + cv;
      if (bo < a.Cout && ci < a.Cin)
        copy8(bdst, wrow + tap * a.Cin + ci);
      else
        zero8(bdst);
      __syncthreads();
      mma_step(As, Bs, wm, wn, g, t4, acc);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      const int b = (int)(m / hw);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = n0 + wn + nt * 8 + 2 * t4;  // o, o + 1 < C_out together
        if (o >= a.Cout) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store1(out + m * a.Cout + o + e,
                 epilogue<T>(a, m, b, o + e, acc[mt][nt][2 * half + e]));
      }
    }
}

template <typename T>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const long long m = (long long)a.B * a.H * a.W;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (a.Cout + BN - 1) / BN);
  conv_igemm_kernel<T><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dscconv

// dtype: 0 = fp32, 1 = bf16. xb and skip may be null.
extern "C" int dsc_conv_fused_v2(const void* x, const float* scale,
                                 const float* shift, const void* w,
                                 const float* cb, const float* xb,
                                 const void* skip, void* out, int dtype,
                                 int B, int H, int W, int Cin, int Cout,
                                 void* stream) {
  using namespace dscconv;
  const ConvArgs a =
      make_args(x, scale, shift, w, cb, xb, skip, out, B, H, W, Cin, Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

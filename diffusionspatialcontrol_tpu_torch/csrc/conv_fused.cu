// K4: fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper, as a
// direct convolution.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/conv_fused.py:_kernel (K4a,
// the whole padded map per program) and :_kernel_rows (K4b, row blocks with
// a halo), the two bodies behind gn_silu_conv3x3 (conv_impl="pallas"). The
// TPU chooses between them by whether the map fits VMEM; a CUDA grid tiles
// rows at every size, so one kernel covers both. What it computes is in
// conv_fused.cuh.
//
// Bound on an H100: operations. A resnet conv does 2 * B*H*W * 9*C_in*C_out
// flops against ~(C_in + 2 C_out) * B*H*W elements of traffic: UNet level 0
// at 512^2 (B = 2, 64x64, 320 -> 320) is 15.1 GFLOP against ~17 MB, 15 us
// at the bf16 tensor-core peak and 5 us at the memory rate. This kernel
// runs fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so it stays several
// times over that bound by design; K5 (conv_fused_v2.cu) is the tensor-core
// form. What the design does: the activated input never reaches device
// memory. A block owns 8 x 16 output pixels x 64 output channels, with the
// fp32 sums in registers (4 pixels x 8 channels a thread). Per chunk of 16
// input channels it loads the input tile with its one-pixel halo once,
// applying the GroupNorm affine, the SiLU, the zero padding and the rounding
// to T on the way into shared memory, loads the 9 taps of the weights for
// its 64 channels, and accumulates the 9 taps from shared memory. The
// epilogue adds the conv bias, the channel bias and the skip in fp32 and
// rounds once.

#include "conv_fused.cuh"

namespace dscconv {
namespace {

constexpr int TH = 8;             // output rows per block
constexpr int TW = 16;            // output columns per block
constexpr int TCO = 64;           // output channels per block
constexpr int CK = 16;            // input channels per chunk
constexpr int NT = 256;           // threads per block
constexpr int IH = TH + 2;        // input tile rows, with the halo
constexpr int IW = TW + 2;        // input tile columns, with the halo
constexpr int IP = CK + 1;        // floats per input pixel in shared memory
                                  // (odd: 4 neighbouring columns hit 4 banks)
constexpr size_t SMEM = sizeof(float) * (IH * IW * IP + 9 * CK * TCO);
static_assert((IH * IW * IP) % 4 == 0, "weights must start 16-byte aligned");

template <typename T>
__global__ void __launch_bounds__(NT) conv_direct_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);  // [IH * IW][IP]
  float* w_s = in_s + IH * IW * IP;               // [9][CK][TCO]

  const int tiles_w = (a.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  // thread: channels o0 + tc*8 .. +8 of pixels (2i + pr, pc), i = 0..3
  const int tc = threadIdx.x % 8;
  const int tp = threadIdx.x / 8;
  const int pr = tp / TW;
  const int pc = tp % TW;
  const T* w = static_cast<const T*>(a.w);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += CK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < IH * IW * (CK / 8); i += NT) {
      const int pix = i / (CK / 8);
      const int cv = (i % (CK / 8)) * 8;
      const int iy = y0 - 1 + pix / IW;
      const int ix = x0 - 1 + pix % IW;
      const bool inside = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W &&
                          c0 + cv < a.Cin;
      float v[8];
      act8<T>(a, b, iy, ix, c0 + cv, inside, v);
      float* dst = in_s + pix * IP + cv;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = v[j];
    }
    for (int i = threadIdx.x; i < 9 * (CK / 8) * TCO; i += NT) {
      const int o = i % TCO;  // neighbouring threads: neighbouring channels
      const int r = i / TCO;
      const int tap = r / (CK / 8);
      const int cv = (r % (CK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (o0 + o < a.Cout && c0 + cv < a.Cin)
        load8(w + ((long long)(o0 + o) * 9 + tap) * a.Cin + c0 + cv, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) w_s[(tap * CK + cv + j) * TCO + o] = v[j];
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
      const float* in_t = in_s + ((pr + ky) * IW + pc + kx) * IP;
      const float* w_t = w_s + tap * CK * TCO + tc * 8;
#pragma unroll 4
      for (int c = 0; c < CK; ++c) {
        const float4 wa = *reinterpret_cast<const float4*>(w_t + c * TCO);
        const float4 wb = *reinterpret_cast<const float4*>(w_t + c * TCO + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = in_t[2 * i * IW * IP + c];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
  }

  const int o = o0 + tc * 8;
  if (o >= a.Cout) return;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = y0 + 2 * i + pr;
    const int x = x0 + pc;
    if (y >= a.H || x >= a.W) continue;
    const long long m = ((long long)b * a.H + y) * a.W + x;
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = epilogue<T>(a, m, b, o + j, acc[i][j]);
    store8(out + m * a.Cout + o, r);
  }
}

template <typename T>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_direct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW),
                  (a.Cout + TCO - 1) / TCO, a.B);
  conv_direct_kernel<T><<<grid, NT, SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dscconv

// dtype: 0 = fp32, 1 = bf16. xb and skip may be null.
extern "C" int dsc_conv_fused(const void* x, const float* scale,
                              const float* shift, const void* w,
                              const float* cb, const float* xb,
                              const void* skip, void* out, int dtype, int B,
                              int H, int W, int Cin, int Cout, void* stream) {
  using namespace dscconv;
  const ConvArgs a =
      make_args(x, scale, shift, w, cb, xb, skip, out, B, H, W, Cin, Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

// K5: fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper, as an
// implicit GEMM.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/conv_fused.py:_kernel_v2,
// the body behind gn_silu_conv3x3_v2 (conv_impl="pallas2"). Same function as
// K4 (conv_fused.cuh); the TPU kernel's CONV_V2_VARIANT forms only work
// around Mosaic layouts and need no counterpart.
//
// The conv is a GEMM of M pixels by N = C_out by K = 9*C_in, with K ordered
// (ky, kx, c) as the weights are stored: (C_out, 3, 3, C_in) is the
// "N x K, K contiguous" operand as it is, so no weight repack happens per
// launch.
//
// Bound on an H100: as K4 (conv_fused.cu): operations at maps of 16^2 and
// more (15.1 GFLOP, ~15 us for level 0 at 512^2 at the bf16 tensor-core
// peak; 155 GFLOP, ~156 us for the VAE's 256 -> 128 conv at 512^2), the
// weights' bytes at the UNet's 8^2 level.
//
// bf16 operands (the main path) run conv_wgmma_kernel, on wgmma:
//   * A tile is 128 GEMM rows x 128 output channels. Its rows are pixels
//     laid out so that every tap is a shift of halo rows. At W > 8 they
//     are a box of 8 x 16 pixels of one image; its halo is the 10 x 18 box
//     around it, and a tap moves a row by dy * 18 + dx. At W <= 8 (the
//     UNet's 8^2 level, where a box would leave half its rows idle) they
//     are a strip of 128 consecutive positions of the images laid out with
//     padded rows of W + 2, as _kernel_v2 pads them (conv_fused.py:422-424),
//     so a tap is the row offset dy (W + 2) + dx; the positions on the
//     padding are computed and dropped. Each lane's ldmatrix address is its
//     own row, so both forms cost the same in the loop.
//   * Per chunk of 64 input channels, the raw halo is copied by cp.async
//     (zero-filled outside the images and past C_in) two chunks ahead,
//     into one of two raw buffers. The activation (conv_tc.cuh:Activator)
//     of chunk c+1 is spread over the taps of chunk c, one halo row a
//     thread after each tap's wgmma group is issued, into the other of two
//     activated buffers: the special-function and FP32 work runs while the
//     tensor cores work, and a chunk takes one barrier.
//   * Each tap loads its four k16 A fragments from the shifted rows by
//     ldmatrix into registers and issues four
//     wgmma.mma_async.m64n128k16 (bf16 in, fp32 accumulate), A from
//     registers, B from shared memory. One group stays in flight while the
//     next tap's fragments load; a weight stage is released when its group
//     has completed.
//   * B, the 128 x 64 weight tile of one (tap, chunk) K step, arrives by
//     TMA (a 3-D tensor map (C_in, 9, C_out) whose out-of-bounds zero fill
//     covers ragged C_in and C_out; 128-byte swizzle) into a ring of 6
//     stages with full/empty mbarriers, kept in flight by one producer
//     warp. Two consumer warpgroups each own 64 rows (64 fp32 sums a
//     thread).
//   * Split-K and the epilogue as K4's (conv_tc.cuh).
// The tensor map is encoded per launch on the host (each conv has its own
// weights) through cudaGetDriverEntryPoint, so the library needs no
// -lcuda, and passed as a __grid_constant__ parameter.
//
// fp32 operands (the tests' and the tiny model's type) keep the CUDA-core
// body conv_igemm_kernel: a block of 8 warps owns 128 pixels x 64
// channels, gathers one tap x 32 channels of A through the same
// activation per K step, and accumulates with fp32 FMAs in mma.sync's
// fragment layout.

#include <cuda.h>

#include "conv_tc.cuh"

namespace dscconv {
namespace igemm32 {


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
__device__ __forceinline__ void zero8(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
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

}  // namespace igemm32

namespace k5 {

using tc::BN;
using tc::SP;

constexpr int BM = 128;             // GEMM rows of a tile
constexpr int TH = 8, TW = 16;      // the box form: output rows x columns
constexpr int BOX_PW = TW + 2;      // its halo's row width
constexpr int CK = 64;              // input channels of a chunk
constexpr int G = CK / 8;           // 16-byte words of a halo row
constexpr int NSB = 6;              // stages of the weight ring
constexpr int NCT = 256;            // consumer threads: two warpgroups
constexpr int NT = NCT + 32;        // and the producer warp
constexpr int STRIP_MAX_W = 8;      // widest map of the strip form
constexpr int MAX_HL = (TH + 2) * BOX_PW;    // halo rows, at most
static_assert(BM + 2 * (STRIP_MAX_W + 2) + 2 <= MAX_HL, "strip halo fits");
constexpr int ROWS_A = NCT / G;     // halo rows one pass of the threads takes
constexpr int K_ACT = (MAX_HL + ROWS_A - 1) / ROWS_A;
static_assert(K_ACT <= 9, "a chunk's activation spreads over its 9 taps");
constexpr int B_BYTES = BN * CK * 2;         // one weight stage
constexpr int HALO_BYTES = MAX_HL * CK * 2;  // one raw or activated halo
// shared memory, in bytes from a 1024-aligned base (TMA's 128-byte swizzle)
constexpr int OFF_RAW = NSB * B_BYTES;             // [2] raw halos
constexpr int OFF_ACT = OFF_RAW + 2 * HALO_BYTES;  // [2] activated halos
constexpr int OFF_PM = OFF_ACT + 2 * HALO_BYTES;
constexpr int OFF_PB = OFF_PM + MAX_HL * 4;
constexpr int OFF_BAR = (OFF_PB + MAX_HL * 4 + 7) / 8 * 8;
constexpr int OFF_FLAG = OFF_BAR + 2 * NSB * 8;
constexpr size_t SMEM = OFF_FLAG + 16 + 1024;
static_assert(BM * SP * 4 <= OFF_PM - OFF_RAW, "the staged tile fits");

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(tc::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(tc::smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity. A phase that never
// completes (a lost copy) ends the launch with an error after some seconds
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long i = 0; !mbar_try(bar, parity); ++i)
    if (i == (1ll << 26)) __trap();
}

// The box (c0, tap, n0) of the weights' tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int tap,
                                            int n0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0),
      "r"(tap), "r"(n0)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register live (and in place) up to this point: the A fragments
// of a wgmma group in flight must not be reused before it completes.
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a K-major 128-row B tile with 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t addr = tc::smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d += a . b over one m64n128k16 step: A (64 x 16 bf16) from registers,
// each warp's 16 rows in mma.sync's m16n8k16 A layout; B (128 x 16, K
// contiguous) by descriptor; fp32 D, element 4 j + e of a thread at row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float d[64],
                                                 const uint32_t a[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, %70, %71, %72;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(1), "n"(1), "n"(0));
}

__global__ void __launch_bounds__(NT, 1)
    conv_wgmma_kernel(const ConvArgs a, const tc::TcArgs p,
                      const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bring = base;                             // [NSB][BN][CK]
  uint4* raw = reinterpret_cast<uint4*>(base + OFF_RAW);  // [2][HL] rows
  uint4* act = reinterpret_cast<uint4*>(base + OFF_ACT);  // [2][HL] rows
  int* pm = reinterpret_cast<int*>(base + OFF_PM);  // halo pixel or -1
  int* pb = reinterpret_cast<int*>(base + OFF_PB);  // its image
  uint64_t* full = reinterpret_cast<uint64_t*>(base + OFF_BAR);
  uint64_t* empty = full + NSB;
  int* flag = reinterpret_cast<int*>(base + OFF_FLAG);
  float* stage = reinterpret_cast<float*>(base + OFF_RAW);  // after the loop

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool strip = p.tile == 1;
  const int PW = strip ? a.W + 2 : BOX_PW;  // halo row width
  const int HL = strip ? BM + 2 * PW + 2 : MAX_HL;
  const int n0 = blockIdx.y * BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int cb0, cb1;
  tc::split_range((a.Cin + CK - 1) / CK, p.splits, blockIdx.z, &cb0, &cb1);

  // Halo row j of the tile. GEMM row r of tap (ky, kx) reads halo row
  // hb(r) + ky PW + kx; its output pixel is halo row hb(r) + PW + 1.
  if (strip) {  // 128 padded positions from q0
    const int HP2 = a.H + 2;
    const int q_end = a.B * HP2 * PW;
    const int q0 = PW + blockIdx.x * BM;
    for (int j = tid; j < HL; j += NT) {
      const int q = q0 - PW - 1 + j;
      int m = -1, bb = 0;
      if (q >= 0 && q < q_end) {
        const int vy = q / PW;
        bb = vy / HP2;
        m = tc::halo_pixel(a, bb, vy % HP2 - 1, q % PW - 1);
      }
      pm[j] = m;
      pb[j] = bb;
    }
  } else {  // a TH x TW box of one image
    const int tiles_w = (a.W + TW - 1) / TW;
    const int tiles_h = (a.H + TH - 1) / TH;
    int t = blockIdx.x;
    const int x0 = (t % tiles_w) * TW;
    t /= tiles_w;
    const int y0 = (t % tiles_h) * TH, bb = t / tiles_h;
    for (int j = tid; j < HL; j += NT) {
      pm[j] = tc::halo_pixel(a, bb, y0 - 1 + j / BOX_PW, x0 - 1 + j % BOX_PW);
      pb[j] = bb;
    }
  }
  auto hb = [&](int r) { return strip ? r : (r / TW) * BOX_PW + r % TW; };
  if (tid == 0) {
    for (int s = 0; s < NSB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nch = cb1 - cb0;
  if (warp == NCT / 32) {  // the producer warp
    if (lane == 0) {
      for (int s = 0; s < nch * 9; ++s) {  // (chunk, tap) K steps
        const int st = s % NSB;
        mbar_wait(&empty[st], ((s / NSB) & 1) ^ 1);
        mbar_expect_tx(&full[st], B_BYTES);
        tma_load_3d(bring + st * B_BYTES, &wmap, &full[st],
                    (cb0 + s / 9) * CK, s % 9, n0);
      }
    }
    return;
  }

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  auto load_raw = [&](int c, int buf) {
    const int c0 = c * CK;
    uint4* dst = raw + buf * MAX_HL * G;
    for (int i = tid; i < HL * G; i += NCT) {
      const int j = i / G, g = i % G;
      const int m = pm[j];
      const bool ok = m >= 0 && c0 + 8 * g < a.Cin;
      tc::cp_async16(dst + tc::swz<G>(j, g),
                     ok ? x + (long long)m * a.Cin + c0 + 8 * g : x,
                     ok ? 16 : 0);
    }
    tc::cp_async_commit();
  };

  // ldmatrix: matrix lane / 8 of a k16 step holds GEMM rows
  // (lane / 8 % 2) * 8 + lane % 8 of the warp's 16, channel group lane / 16.
  const int wg = warp / 4, wi = warp % 4;
  const int abase = hb(wg * 64 + wi * 16 + (lane / 8 % 2) * 8 + lane % 8);
  const int akg = lane / 16;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t af[2][4][4];
  tc::Activator<G> next_act;

  // Chunk i computes from act[i % 2] while the threads activate chunk i+1
  // from raw[(i + 1) % 2] between its taps, and chunk i+2's raw halo lands
  // in raw[i % 2]. One barrier a chunk.
  load_raw(cb0, 0);
  if (nch > 1) {
    load_raw(cb0 + 1, 1);
    tc::cp_async_wait<1>();
  } else {
    tc::cp_async_wait<0>();
  }
  tc::bar_sync<NCT>();
  tc::activate<G, NCT>(raw, act, pm, pb, HL, a, cb0 * CK, tid);
  tc::cp_async_wait<0>();
  tc::bar_sync<NCT>();

  int step = 0;
#pragma unroll 1
  for (int i = 0; i < nch; ++i) {
    const int buf = i & 1;
    if (i + 2 < nch) load_raw(cb0 + i + 2, buf);
    const bool more = i + 1 < nch;
    if (more) next_act.begin(a, (cb0 + i + 1) * CK, tid);
    const uint4* act_c = act + buf * MAX_HL * G;
    const uint4* raw_n = raw + (buf ^ 1) * MAX_HL * G;
    uint4* act_n = act + (buf ^ 1) * MAX_HL * G;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t(&f)[4][4] = af[tap & 1];
      const int j = abase + (tap / 3) * PW + tap % 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::ldmatrix_x4(f[kk], act_c + tc::swz<G>(j, 2 * kk + akg));
      const int st = step % NSB;
      mbar_wait(&full[st], (step / NSB) & 1);
      wgmma_fence();
      const uint64_t d = b_desc(bring + st * B_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(acc, f[kk], d + 2 * kk);  // + 32 bytes a k16
      wgmma_commit();
      if (more && tap < K_ACT) {  // while the group runs
        const int pr = tid / G + ROWS_A * tap;
        if (pr < HL) next_act.row(raw_n, act_n, pm, pb, a, pr);
      }
      if (tap > 0) {
        wgmma_wait<1>();  // the previous tap's group is done
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) keep(af[(tap + 1) & 1][kk][e]);
        if (lane == 0) mbar_arrive(&empty[(step - 1) % NSB]);
      }
      ++step;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 64; ++k) keep(acc[k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(af[0][kk][e]);
    if (lane == 0) mbar_arrive(&empty[(step - 1) % NSB]);
    tc::cp_async_wait<0>();  // chunk i+2's raw halo
    tc::bar_sync<NCT>();     // chunk i+1 activated; act[buf] is free
  }

  // raw and act are free: stage the tile over them
  const int row = wg * 64 + wi * 16 + lane / 4;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = jn * 8 + 2 * (lane % 4);
    *reinterpret_cast<float2*>(stage + row * SP + col) =
        make_float2(acc[4 * jn], acc[4 * jn + 1]);
    *reinterpret_cast<float2*>(stage + (row + 8) * SP + col) =
        make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
  }
  tc::bar_sync<NCT>();
  tc::epilogue_tile<BM, NCT>(a, p, stage, n0, tile, blockIdx.z, flag, tid,
                             [&](int r, int& bb) {
                               const int j = hb(r) + PW + 1;
                               bb = pb[j];
                               return pm[j];
                             });
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !f) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

cudaError_t launch(const ConvArgs& a, const tc::TcArgs& p,
                   cudaStream_t stream) {
  int tiles_m;
  if (p.tile == 1 && a.W <= STRIP_MAX_W)
    tiles_m = (a.B * (a.H + 2) * (a.W + 2) - 2 * (a.W + 2) + BM - 1) / BM;
  else if (p.tile == 0)
    tiles_m = a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  else
    return cudaErrorInvalidValue;
  const int chunks = (a.Cin + CK - 1) / CK;
  if (tiles_m != p.tiles_m || p.splits < 1 || p.splits > chunks ||
      (p.splits > 1 && (!p.ws || !p.tickets)))
    return cudaErrorInvalidValue;
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)a.Cin, 9, (cuuint64_t)a.Cout};
  const cuuint64_t strides[2] = {(cuuint64_t)a.Cin * 2,
                                 (cuuint64_t)a.Cin * 18};
  const cuuint32_t box[3] = {CK, 1, BN};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(a.w), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_m, (a.Cout + BN - 1) / BN, p.splits);
  conv_wgmma_kernel<<<grid, NT, SMEM, stream>>>(a, p, map);
  return cudaGetLastError();
}

}  // namespace k5
}  // namespace dscconv

// dtype: 0 = fp32 (the CUDA-core body; ws, tickets and the plan are not
// read), 1 = bf16 (the wgmma body; plan from conv_plan: tile 1 for the
// padded strip, 0 for row tiles, tiles along the pixels, splits; ws and
// tickets when splits > 1). xb and skip may be null.
extern "C" int dsc_conv_fused_v2(const void* x, const float* scale,
                                 const float* shift, const void* w,
                                 const float* cb, const float* xb,
                                 const void* skip, void* out, float* ws,
                                 int* tickets, int dtype, int B, int H,
                                 int W, int Cin, int Cout, int tile,
                                 int tiles_m, int splits, void* stream) {
  using namespace dscconv;
  const ConvArgs a =
      make_args(x, scale, shift, w, cb, xb, skip, out, B, H, W, Cin, Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)igemm32::launch<float>(a, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  tc::TcArgs p;
  p.ws = ws; p.tickets = tickets; p.tile = tile; p.tiles_m = tiles_m;
  p.splits = splits;
  return (int)k5::launch(a, p, st);
}

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
// Bound on an H100: operations at maps of 16^2 and more, bytes (the
// weights) at the UNet's 8^2 level. A resnet conv does
// 2 * B*H*W * 9*C_in*C_out flops: UNet level 0 at 512^2 (B = 2, 64x64,
// 320 -> 320) is 15.1 GFLOP against ~17 MB, 15 us at the bf16 tensor-core
// peak and 5 us at the memory rate; at 2x8x8, 2560 -> 1280 the 59 MB of
// weights take 18 us and the 3.8 GFLOP 4 us.
//
// bf16 operands (the main path) run conv_mma_kernel, on the tensor cores:
//   * A block owns TH x TW = 8 x 16 output pixels (8 x 8 where W <= 8) x 128
//     output channels: 8 warps, each 32 pixels x 64 (or 32) channels, the
//     fp32 sums in registers as mma.sync m16n8k16 C fragments.
//   * Per chunk of 16 input channels: the chunk's weights for all 9 taps
//     (9 x 128 rows of 32 bytes) and the raw (TH+2) x (TW+2) halo go into
//     double buffers by 16-byte cp.async, zero-filled past the image, C_in
//     and C_out: chunk c+1's weights and chunk c+2's halo are in flight
//     while chunk c computes. The halo is activated once
//     (conv_tc.cuh:activate_item), chunk c+1's one or two rows a thread
//     between chunk c's taps, into the other of two activated buffers. Then
//     9 taps of mma.sync.m16n8k16 (bf16 in, fp32 accumulate) read A by
//     ldmatrix from the shifted halo rows and B by ldmatrix from the weight
//     tile. One block barrier a chunk; two blocks share an SM (98 KB of
//     shared memory each), so one's barrier hides under the other's MMAs.
//   * Split-K over the chunks where the tiles alone are fewer than the 132
//     SMs (at 512^2: the UNet's 32^2, 16^2 and 8^2 levels, the decoder's
//     64^2), reduced in split order by the tile's last block (conv_tc.cuh). The epilogue stages the tile in shared memory and adds
//     the conv bias, the channel bias and the skip in fp32, 16 bytes a
//     thread, rounding once.
// The activation is rounded to bf16 before the MMA and the products are
// exact in fp32, so the order of the fp32 sum and the SiLU's last fp32 bits
// (conv_tc.cuh:gn_silu_fast) are all that differ from the plain version.
//
// fp32 operands (the tests' and the tiny model's type) keep the CUDA-core
// body conv_direct_kernel: per chunk of 16 input channels it activates the
// halo tile into shared memory as fp32, loads the 9 taps of the weights for
// its 64 channels, and accumulates with fp32 FMAs, 4 pixels x 8 channels a
// thread.

#include "conv_tc.cuh"

namespace dscconv {
namespace direct {

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

}  // namespace direct

namespace k4 {

using tc::BN;
using tc::SP;

constexpr int TH = 8;        // output rows of a tile
constexpr int CK = 16;       // input channels of a chunk
constexpr int G = CK / 8;    // 16-byte words of a halo or weight row
constexpr int NT = 256;      // 8 warps

template <int TW>
struct Cfg {
  static constexpr int IW = TW + 2;            // halo columns
  static constexpr int HP = (TH + 2) * IW;     // halo pixels
  static constexpr int PM = TH * TW;           // output pixels of a tile
  static constexpr int WM = PM / 32;           // warps along the pixels
  static constexpr int WN = 8 / WM;            // warps along the channels
  static constexpr int NW = BN / WN;           // channels of a warp
  static constexpr int NT8 = NW / 8;           // its n8 tiles
  static constexpr int W_WORDS = 9 * BN * G;   // one chunk's weights
  static constexpr int R_WORDS = HP * G;       // one raw or activated halo
  static constexpr int ITEMS = (HP * G + NT - 1) / NT;  // halo words a thread
  static constexpr int RING = 2 * W_WORDS + 4 * R_WORDS;  // all double
  static constexpr size_t SMEM = 16 * RING + sizeof(int) * (2 * HP + 4);
  static_assert(ITEMS <= 9, "a chunk's activation spreads over its taps");
  static_assert(PM * SP * 4 <= 16 * RING, "the staged tile fits the ring");
};

template <int TW>
__global__ void __launch_bounds__(NT, 2)
    conv_mma_kernel(const ConvArgs a, const tc::TcArgs p) {
  using C = Cfg<TW>;
  extern __shared__ uint4 smem[];
  uint4* wring = smem;                    // [2][9][BN] rows of G words
  uint4* rring = wring + 2 * C::W_WORDS;  // [2][HP] rows, raw
  uint4* act = rring + 2 * C::R_WORDS;    // [2][HP] rows, activated
  int* pm = reinterpret_cast<int*>(act + 2 * C::R_WORDS);  // pixel or -1
  int* pb = pm + C::HP;                                // its image
  int* flag = pb + C::HP;
  float* stage = reinterpret_cast<float*>(smem);  // after the loop

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int tiles_h = (a.H + TH - 1) / TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int y0 = (t % tiles_h) * TH;
  const int b = t / tiles_h;
  const int n0 = blockIdx.y * BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int cb0, cb1;
  tc::split_range((a.Cin + CK - 1) / CK, p.splits, blockIdx.z, &cb0, &cb1);
  const int nloc = cb1 - cb0;

  for (int i = tid; i < C::HP; i += NT) {
    pm[i] = tc::halo_pixel(a, b, y0 - 1 + i / C::IW, x0 - 1 + i % C::IW);
    pb[i] = b;
  }
  __syncthreads();

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  auto load_raw = [&](int s, int c) {
    const int c0 = c * CK;
    uint4* rdst = rring + s * C::R_WORDS;
    for (int i = tid; i < C::HP * G; i += NT) {
      const int px = i / G, g = i % G;
      const int m = pm[px];
      const bool ok = m >= 0 && c0 + 8 * g < a.Cin;
      tc::cp_async16(rdst + tc::swz<G>(px, g),
                     ok ? x + (long long)m * a.Cin + c0 + 8 * g : x,
                     ok ? 16 : 0);
    }
  };
  auto load_weights = [&](int s, int c) {
    const int c0 = c * CK;
    uint4* wdst = wring + s * C::W_WORDS;
#pragma unroll 3
    for (int i = tid; i < 9 * BN * G; i += NT) {
      const int g = i % G;
      const int n = (i / G) % BN;
      const int tap = i / (G * BN);
      const bool ok = n0 + n < a.Cout && c0 + 8 * g < a.Cin;
      tc::cp_async16(
          wdst + tap * BN * G + tc::swz<G>(n, g),
          ok ? w + ((long long)(n0 + n) * 9 + tap) * a.Cin + c0 + 8 * g : w,
          ok ? 16 : 0);
    }
  };

  // ldmatrix rows of this lane: A (pixels) matrix lane / 8 holds rows
  // (lane / 8 % 2) * 8 + lane % 8 of words lane / 16; B (output channels)
  // matrix lane / 8 holds rows (lane / 16) * 8 + lane % 8 of word
  // lane / 8 % 2.
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int mi = lane / 8, r8 = lane % 8;
  int ap[2];  // halo row of tap (0, 0) for the lane's A row, per m tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int px = wm * 32 + mt * 16 + (mi % 2) * 8 + r8;
    ap[mt] = (px / TW) * C::IW + px % TW;
  }
  const int ah = mi / 2;
  const int brow = wn * C::NW + (mi / 2) * 8 + r8;
  const int bh = mi % 2;

  float acc[2][C::NT8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // Chunk i computes from act[i % 2] and weights[i % 2] while the threads
  // activate chunk i+1 from raw[(i + 1) % 2] between its taps, and chunk
  // i+1's weights and chunk i+2's raw halo are copied into the buffers
  // chunk i-1 left. One barrier a chunk.
  load_weights(0, cb0);
  load_raw(0, cb0);
  if (nloc > 1) load_raw(1, cb0 + 1);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  tc::activate<G, NT>(rring, act, pm, pb, C::HP, a, cb0 * CK, tid);
  __syncthreads();

#pragma unroll 1
  for (int it = 0; it < nloc; ++it) {
    const int buf = it & 1;
    if (it + 1 < nloc) load_weights(buf ^ 1, cb0 + it + 1);
    if (it + 2 < nloc) load_raw(buf, cb0 + it + 2);
    tc::cp_async_commit();
    const bool more = it + 1 < nloc;
    const int c_next = (cb0 + it + 1) * CK;
    const uint4* act_c = act + buf * C::R_WORDS;
    const uint4* raw_n = rring + (buf ^ 1) * C::R_WORDS;
    uint4* act_n = act + (buf ^ 1) * C::R_WORDS;
    const uint4* wst = wring + buf * C::W_WORDS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * C::IW + tap % 3;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldmatrix_x4(af[mt], act_c + tc::swz<G>(ap[mt] + off, ah));
      const uint4* wt = wst + tap * BN * G;
#pragma unroll
      for (int jp = 0; jp < C::NT8 / 2; ++jp) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, wt + tc::swz<G>(brow + 16 * jp, bh));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tc::mma_bf16(acc[mt][2 * jp], af[mt], bf[0], bf[1]);
          tc::mma_bf16(acc[mt][2 * jp + 1], af[mt], bf[2], bf[3]);
        }
      }
      if (more && tap < C::ITEMS) {  // behind this tap's MMAs
        const int i = tid + NT * tap;
        if (C::HP * G % NT == 0 || i < C::HP * G)
          tc::activate_item<G>(raw_n, act_n, pm, pb, a, i / G, i % G,
                               c_next + 8 * (i % G));
      }
    }
    tc::cp_async_wait<0>();  // chunk i+1's weights, chunk i+2's raw halo
    __syncthreads();         // chunk i+1 activated; chunk i's buffers free
  }

  // the ring is free: stage the tile over it
  const int g4 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j) {
      const int row = wm * 32 + mt * 16 + g4;
      const int col = wn * C::NW + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(stage + row * SP + col) =
          make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(stage + (row + 8) * SP + col) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  __syncthreads();
  tc::epilogue_tile<C::PM, NT>(
      a, p, stage, n0, tile, blockIdx.z, flag, tid, [&](int r, int& bb) {
        bb = b;
        return pm[(r / TW + 1) * C::IW + r % TW + 1];
      });
}

template <int TW>
cudaError_t launch(const ConvArgs& a, const tc::TcArgs& p,
                   cudaStream_t stream) {
  using C = Cfg<TW>;
  const int tiles_m = a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  const int chunks = (a.Cin + CK - 1) / CK;
  if (tiles_m != p.tiles_m || p.splits < 1 || p.splits > chunks ||
      (p.splits > 1 && (!p.ws || !p.tickets)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_mma_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_m, (a.Cout + BN - 1) / BN, p.splits);
  conv_mma_kernel<TW><<<grid, NT, C::SMEM, stream>>>(a, p);
  return cudaGetLastError();
}

}  // namespace k4
}  // namespace dscconv

// dtype: 0 = fp32 (the CUDA-core body; ws, tickets and the plan are not
// read), 1 = bf16 (the tensor-core body; plan from conv_plan: tile width
// 16 or 8, tiles along the pixels, splits; ws and tickets when splits > 1).
// xb and skip may be null.
extern "C" int dsc_conv_fused(const void* x, const float* scale,
                              const float* shift, const void* w,
                              const float* cb, const float* xb,
                              const void* skip, void* out, float* ws,
                              int* tickets, int dtype, int B, int H, int W,
                              int Cin, int Cout, int tile, int tiles_m,
                              int splits, void* stream) {
  using namespace dscconv;
  const ConvArgs a =
      make_args(x, scale, shift, w, cb, xb, skip, out, B, H, W, Cin, Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)direct::launch<float>(a, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  tc::TcArgs p;
  p.ws = ws; p.tickets = tickets; p.tile = tile; p.tiles_m = tiles_m;
  p.splits = splits;
  if (tile == 16) return (int)k4::launch<16>(a, p, st);
  if (tile == 8) return (int)k4::launch<8>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

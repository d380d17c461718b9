// The bf16 tensor-core bodies of K4 (csrc/conv_fused.cu, mma.sync) and K5
// (csrc/conv_fused_v2.cu, wgmma): what the two share. The function is
// conv_fused.cuh's; fp32 operands keep the CUDA-core bodies of those files.
//
// Both kernels activate their input once per block and per channel chunk:
//   * the raw bf16 halo tile (the pixels of the block's output tile and a
//     one-pixel border) is copied into shared memory by 16-byte cp.async,
//     one row per halo pixel, zero-filled for pixels outside the image and
//     channels past C_in;
//   * one pass over it (`activate`, or `Activator`/`activate_item` row by
//     row between the taps of the previous chunk) applies the folded
//     GroupNorm affine and the SiLU, forces the padding border and the
//     channels past C_in to zero and rounds to bf16, into a second buffer
//     of the same layout;
//   * each of the 9 taps then reads its A fragments from that buffer by
//     ldmatrix, every lane giving the address of its own pixel row: a tap is
//     a shift of rows, and no tap recomputes the activation.
// Rows are CK channels (CK / 8 = G words of 16 bytes) with no padding; the
// word of (row p, group g) is swizzled (`swz`) so that the 8 row addresses
// of an ldmatrix matrix, 8 consecutive rows of one group, fall in 8
// distinct bank quads.
//
// Split-K: where the grid of output tiles would leave SMs idle, the C_in
// chunks are split over gridDim.z blocks of one tile (the plan is
// ops/kernels/conv_fused.py:conv_plan). Each writes its fp32 partial tile to
// a workspace; the last block of the tile to take a ticket (an atomic
// counter per tile, after a __threadfence) sums the partials in split order,
// so that two launches give bitwise-identical outputs, runs the epilogue
// once, and sets the ticket back to 0 for the next launch.

#pragma once

#include "conv_fused.cuh"

namespace dscconv {
namespace tc {

constexpr int BN = 128;      // output channels of a tile (both kernels)
constexpr int SP = BN + 4;   // fp32 pitch of the staged output tile

struct TcArgs {
  float* ws;      // (tiles, splits, tile pixels, BN) fp32 partials, or null
  int* tickets;   // one int per tile, 0 between launches, or null
  int tile;       // K4: tile width (16 or 8); K5: 1 strip, 0 boxes
  int tiles_m;    // output tiles along the pixels
  int splits;     // blocks along C_in for one output tile
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on one m16n8k16 tile (bf16 in, fp32 accumulate). Fragment
// layout (lane = 4 g + t4): c[0..1] row g, c[2..3] row g + 8, columns
// 2 t4, 2 t4 + 1.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Barrier 1 over the first NTH threads of the block (K5's producer warp
// does not take part).
template <int NTH>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTH) : "memory");
}

// The 16-byte word of (row p, channel group g) in a tile of G groups a row.
template <int G>
__device__ __forceinline__ int swz(int p, int g) {
  constexpr int SH = G == 8 ? 0 : (G == 4 ? 1 : 2);  // log2(8 / G)
  return p * G + (g ^ ((p >> SH) & (G - 1)));
}

// silu(x * s + t) for the bf16 bodies: the affine as gn_silu rounds it,
// then a / (1 + 2^(-a log2 e)) with ex2.approx and a fast divide, two
// special-function operations where expf and an IEEE divide take about 30
// instructions. It is within a few fp32 ulp of gn_silu, far below the bf16
// rounding that follows (2^-9 relative): the rounded activation differs
// only for values that close to a rounding boundary. For a < -88 it gives
// 0 where gn_silu gives a denormal.
__device__ __forceinline__ float gn_silu_fast(float x, float s, float t) {
  const float a = __fadd_rn(__fmul_rn(x, s), t);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(a * -1.4426950408889634f));
  return __fdividef(a, 1.0f + e);
}

// bf16(silu(x * s + t)) of the 8 bf16 values in `raw`.
__device__ __forceinline__ uint4 silu8(const uint4* raw, const float s[8],
                                       const float t[8]) {
  float v[8];
  load8(reinterpret_cast<const __nv_bfloat16*>(raw), v);
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(
        gn_silu_fast(v[2 * j], s[2 * j], t[2 * j]),
        gn_silu_fast(v[2 * j + 1], s[2 * j + 1], t[2 * j + 1]));
  return o;
}

// raw -> act, one halo row at a time: act = bf16(silu(raw * s + t)), and 0
// where the row lies outside the image (pm < 0) or the group past C_in.
// Thread `tid` always takes channel group tid % G, so it keeps its 8
// channels' scale and shift in registers, reloaded when the row's image
// changes (a K5 strip may span two images).
template <int G>
struct Activator {
  float s[8], t[8];
  int cur, c, g;

  __device__ __forceinline__ void begin(const ConvArgs& a, int c0, int tid) {
    g = tid % G;
    c = c0 + 8 * g;
    cur = c < a.Cin ? -1 : -2;  // -2: every row of this group is zero
  }

  __device__ __forceinline__ void row(const uint4* raw, uint4* act,
                                      const int* pm, const int* pb,
                                      const ConvArgs& a, int p) {
    const int m = pm[p];
    const int w = swz<G>(p, g);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (m >= 0 && cur != -2) {
      const int b = pb[p];
      if (b != cur) {
        load8(a.scale + (long long)b * a.Cin + c, s);
        load8(a.shift + (long long)b * a.Cin + c, t);
        cur = b;
      }
      o = silu8(raw + w, s, t);
    }
    act[w] = o;
  }
};

// One halo row and channel group (channel c = c0 + 8 g) with no state kept
// between calls: K4 takes one or two such items a thread a chunk, and
// keeps its registers for the sums.
template <int G>
__device__ __forceinline__ void activate_item(const uint4* raw, uint4* act,
                                              const int* pm, const int* pb,
                                              const ConvArgs& a, int p, int g,
                                              int c) {
  const int m = pm[p];
  const int w = swz<G>(p, g);
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  if (m >= 0 && c < a.Cin) {
    float s[8], t[8];
    load8(a.scale + (long long)pb[p] * a.Cin + c, s);
    load8(a.shift + (long long)pb[p] * a.Cin + c, t);
    o = silu8(raw + w, s, t);
  }
  act[w] = o;
}

// The whole pass over `rows` halo rows by NTH threads.
template <int G, int NTH>
__device__ __forceinline__ void activate(const uint4* raw, uint4* act,
                                         const int* pm, const int* pb,
                                         int rows, const ConvArgs& a, int c0,
                                         int tid) {
  static_assert(NTH % G == 0, "a thread keeps one channel group");
  Activator<G> act_;
  act_.begin(a, c0, tid);
  for (int p = tid / G; p < rows; p += NTH / G)
    act_.row(raw, act, pm, pb, a, p);
}

// The output tile, staged as fp32 sums in stage[row * SP + col] (PM rows,
// BN columns from output channel n0), written out by NTH threads, 8
// channels (16 bytes of bf16) a thread: out = sum + cb (+ xb) (+ skip),
// rounded once. rowpix(row, b) gives the row's flat output pixel (or -1)
// and its image. With splits > 1 the block's partial goes to the workspace
// first, and only the tile's last block goes on.
template <int PM, int NTH, typename RowPix>
__device__ __forceinline__ void epilogue_tile(const ConvArgs& a,
                                              const TcArgs& p,
                                              const float* stage, int n0,
                                              int tile, int split, int* flag,
                                              int tid, RowPix rowpix) {
  constexpr int GN = BN / 8;
  if (p.splits > 1) {
    float* part = p.ws + ((long long)tile * p.splits + split) * PM * BN;
    for (int i = tid; i < PM * GN; i += NTH) {
      const int r = i / GN, g = i % GN;
      const float4* src = reinterpret_cast<const float4*>(stage + r * SP +
                                                          g * 8);
      float4* dst = reinterpret_cast<float4*>(part + r * BN + g * 8);
      dst[0] = src[0];
      dst[1] = src[1];
    }
    __threadfence();
    bar_sync<NTH>();
    if (tid == 0) *flag = atomicAdd(p.tickets + tile, 1) == p.splits - 1;
    bar_sync<NTH>();
    if (!*flag) return;
    __threadfence();
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const __nv_bfloat16* skip = static_cast<const __nv_bfloat16*>(a.skip);
  for (int i = tid; i < PM * GN; i += NTH) {
    const int r = i / GN, g = i % GN;
    const int o = n0 + g * 8;
    int b;
    const int m = rowpix(r, b);
    if (m < 0 || o >= a.Cout) continue;
    float v[8];
    if (p.splits > 1) {
      const float* base = p.ws + (long long)tile * p.splits * PM * BN +
                          r * BN + g * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      for (int s = 0; s < p.splits; ++s) {  // in split order
        const float4* q =
            reinterpret_cast<const float4*>(base + (long long)s * PM * BN);
        const float4 x0 = __ldcg(q), x1 = __ldcg(q + 1);
        v[0] += x0.x; v[1] += x0.y; v[2] += x0.z; v[3] += x0.w;
        v[4] += x1.x; v[5] += x1.y; v[6] += x1.z; v[7] += x1.w;
      }
    } else {
      load8(stage + r * SP + g * 8, v);
    }
    float e[8];
    load8(a.cb + o, e);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += e[j];
    if (a.xb) {
      load8(a.xb + (long long)b * a.Cout + o, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += e[j];
    }
    if (skip) {
      load8(skip + (long long)m * a.Cout + o, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += e[j];
    }
    store8(out + (long long)m * a.Cout + o, v);
  }
  if (p.splits > 1 && tid == 0) p.tickets[tile] = 0;
}

// Flat output pixel of the halo pixel (b, iy, ix), or -1 outside the image.
__device__ __forceinline__ int halo_pixel(const ConvArgs& a, int b, int iy,
                                          int ix) {
  return iy >= 0 && iy < a.H && ix >= 0 && ix < a.W
             ? (b * a.H + iy) * a.W + ix
             : -1;
}

// This split's C_in chunks [*c0, *c1) of `chunks`: split s of S takes
// [s * chunks / S, (s + 1) * chunks / S), so each chunk is taken once.
__device__ __forceinline__ void split_range(int chunks, int splits, int s,
                                            int* c0, int* c1) {
  *c0 = (int)((long long)s * chunks / splits);
  *c1 = (int)((long long)(s + 1) * chunks / splits);
}

}  // namespace tc
}  // namespace dscconv

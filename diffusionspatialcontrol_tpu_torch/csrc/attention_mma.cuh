// Softmax attention on Hopper's tensor cores for bf16 operands, shared by
// K1 (region attention, csrc/region_attention.cu) and K2 (attention without
// bias, csrc/flash_attention.cu, which also serves K3's streaming shapes).
// fp32 operands keep the CUDA-core body of csrc/attention.cuh; `run` at the
// end of this file dispatches on the operand type.
//
//   out[b, l, h, :] = softmax_s(scale * q[b,l,h,:] . k[b,s,h,:] + w[b, l, s])
//                     . v[b, s, h, :]
//
// Replaces the Pallas TPU kernels diffusionspatialcontrol_tpu/ops/pallas/
// flash_attention.py:_kernel and :_stream_kernel (K2, K3) and
// region_attention.py:_kernel (K1), for bf16 operands: fp32 logits and
// softmax, output in bf16, (B, L, H, D) read through strides with no padded
// copy and no transpose.
//
// Bounds on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s, ~3.9 T exps/s: 16
// special-function results a clock per SM). Per logit the kernel does
// 2*D multiply-adds for QK^T and 2*D for P.V, and one exp.
//   * K2 at the 512^2 level-0 self-attention (B*H = 16, L = S = 4096,
//     D = 40): 43 GFLOP (0.043 ms), 268 M exps (0.069 ms), 2.6 MB moved
//     (0.0008 ms). At D = 40 the exps bound it, not the MMAs. At
//     L = S = 16384 (K3's shape): 0.69 ms of MMA, 1.10 ms of exps.
//   * K1 at level 0 (S = 77): 0.8 GFLOP, 40 M exps (0.010 ms), and 13 MB
//     of Q, O and fp32 bias (0.0039 ms): bound by the exps and the bytes.
//
// Design: the FlashAttention-2 shape on mma.sync, fed by cp.async.
//   * A block takes RM = 16 * MT * NW query rows of one (b, L tile) and a
//     group of HG heads; each of its NW warps owns 16 * MT rows. K2 takes
//     one head a block (HG = 1); K1 takes as many heads as leave at least
//     one block per SM, so its bias tile is read once for all of them.
//   * The block walks over jobs (head of its group, tile of KT keys). The
//     K and V tiles of each job go through a ring of NS stages in shared
//     memory, filled by 16-byte cp.async (commit_group / wait_group): while
//     the warps compute on job j, jobs j+1 .. j+NS-1 are in flight. One
//     barrier a job: after it, every warp has left the stage that the next
//     copy overwrites. Q is copied with a head's first job; K1 keeps NQ = NS
//     Q buffers, so a head's Q is never overwritten before it was read.
//   * Tiles stay bf16 in shared memory, rows padded to DK + 8 elements (DK
//     is D rounded up to 16, QK^T's depth: 40 -> 48): an odd number of
//     16-byte words, so ldmatrix's 8 row addresses hit distinct banks. Rows
//     at or past L or S and the columns D .. DK are zero-filled by
//     cp.async's src-size-0 form, never left stale: a masked P of 0 times a
//     NaN in shared memory would be NaN.
//   * QK^T: each warp keeps its Q fragments in registers for the whole key
//     loop (ldmatrix once a head); K's B fragments come from ldmatrix;
//     mma.sync.m16n8k16 bf16 with fp32 accumulation. bf16 products are
//     exact in fp32, so this differs from an fp32 QK^T only in the order of
//     the sum (what the JAX `qk_bf16` option means). The scale multiplies
//     the fp32 accumulator (K1: one FFMA with the bias from shared memory;
//     K2: folded into the FFMA before the exp).
//   * Online softmax in registers, on the accumulator fragments: a row's
//     max is reduced over the 4 lanes that hold it (shfl_xor 1, 2), alpha
//     rescales the O accumulators, each thread keeps a partial row sum, and
//     1/l is applied once at the store. One exp per logit: expf (about 8
//     instructions, one of them on the special-function unit), or under
//     OPT_EXP2 2^(x log2 e) as one ex2.approx (results under 2^-126 flush
//     to zero, far below a bf16 output's resolution).
//   * P.V without shared memory: two adjacent m16n8 accumulator tiles of P,
//     converted to bf16 in registers, are an m16n8k16 A fragment; V's B
//     fragments come from the row-major (keys, D) tile by ldmatrix.trans.
//     P is not rounded to bf16 by default: it is split into hi = bf16(P)
//     and lo = bf16(P - hi) and both products are issued (error <= 2^-16
//     of P, against 2^-9 for a plain bf16 P); OPT_PV_BF16 takes hi only.
//   * Key tiles: K2 takes KT = 64; K1 takes KT = 80, so S = 77 * chunks is
//     padded to 80 * chunks, and K1's usual S = 77 is one tile. Key pairs
//     of 16 that lie wholly past S are skipped in both products.
//   * Occupancy: K2 at D <= 40 runs 4 warps of 32 rows (RM = 128; the
//     second m-tile halves the shared-memory reads of K and V per row), at
//     D >= 64 4 warps of 16 rows; NS = 3 stages (2 at D >= 128). At D = 40
//     a block holds 57 KB of shared memory and is held to 168 registers a
//     thread, so 3 blocks (12 warps) share an SM: while one warp waits on
//     its exps another's MMAs run. Row maxima and sums are trees, so a
//     row's dependent chain is log2 of its length. At D = 40 the default
//     pays for two choices against the OPT_PV_BF16 | OPT_EXP2 instance:
//     expf takes about 8 instructions an exp where ex2.approx takes one,
//     and the split doubles the P.V products; chip_smoke.py times all four
//     instances at the level-0 and K3 shapes.
// What is left for later: wgmma for D = 80/160 (its shared-memory
// descriptors want 32/64/128-byte swizzle atoms that 80-byte rows of D = 40
// do not fill), and spreading the exps over the FMA pipe at D = 40.

#pragma once

#include "attention.cuh"

namespace dsc {

constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory limit

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16x2 hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Rows [r0, r0 + ROWS) of a (rows, D) bf16 slab with row stride `stride`
// (elements) into shared memory with pitch PK, as DK / 8 chunks of 16 bytes
// a row; chunks of rows at or past `valid` and past column D are zeros.
template <int D, int DK, int PK, int ROWS, int NTH>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int valid) {
  constexpr int CH = DK / 8;
#pragma unroll
  for (int it = 0; it < (ROWS * CH + NTH - 1) / NTH; ++it) {
    const int i = it * NTH + threadIdx.x;
    if ((ROWS * CH) % NTH != 0 && i >= ROWS * CH) break;
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = r0 + r < valid && c * 8 < D;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + r) * stride + c * 8
                                : src;
    cp_async16(dst + r * PK + c * 8, g, ok ? 16 : 0);
  }
}

// Shared memory of one block: the bias tile (K1), NQ Q buffers and NS
// stages of K and V.
template <int RM, bool HAS_BIAS>
__host__ __device__ constexpr size_t bias_bytes(int S) {
  return HAS_BIAS ? ((size_t)RM * S * sizeof(float) + 127) / 128 * 128 : 0;
}

template <int RM, int KT, int PK, int NS, int NQ, bool HAS_BIAS>
__host__ __device__ constexpr size_t mma_smem_bytes(int S) {
  return bias_bytes<RM, HAS_BIAS>(S) +
         sizeof(__nv_bfloat16) * ((size_t)NQ * RM * PK +
                                  (size_t)NS * 2 * KT * PK);
}

// Sum (or max) of v[0..N) as a tree: log2(N) dependent steps, not N.
template <bool MAX, int N>
__device__ __forceinline__ float tree_reduce(float (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w)
      v[i] = MAX ? fmaxf(v[i], v[i + w]) : v[i] + v[i + w];
  return v[0];
}

// Logits c * s -> probabilities for one key tile, in place: the online
// softmax update of each row's max m and this thread's partial sum l, and
// alpha applied to the O accumulators. c > 0 (K2's scale, 1 for K1, whose
// logits are already scaled and biased), so max(c * s) = c * max(s) and
// each probability takes one FFMA before its exp.
template <bool EXP2, int MT, int NTS, int NTO>
__device__ __forceinline__ void softmax_tile(float s[MT][NTS][4],
                                             float o[MT][NTO][4],
                                             float m[MT][2], float l[MT][2],
                                             float c) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[NTS];
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
        v[nt] = fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]);
      float mx = tree_reduce<true>(v);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[mt][r], mx * c);
      const float alpha = EXP2 ? ex2((m[mt][r] - mn) * LOG2E)
                               : expf(m[mt][r] - mn);
      m[mt][r] = mn;
      const float cl = EXP2 ? c * LOG2E : c;
      const float ml = EXP2 ? mn * LOG2E : mn;
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = fmaf(s[mt][nt][e], cl, -ml);
          s[mt][nt][e] = EXP2 ? ex2(x) : expf(x);
        }
        v[nt] = s[mt][nt][2 * r] + s[mt][nt][2 * r + 1];
      }
      l[mt][r] = l[mt][r] * alpha + tree_reduce<false>(v);
#pragma unroll
      for (int nt = 0; nt < NTO; ++nt) {
        o[mt][nt][2 * r] *= alpha;
        o[mt][nt][2 * r + 1] *= alpha;
      }
    }
}

// o += P . V over one key tile; P from the accumulator fragments in s
// (hi and, with SPLIT, lo), V's fragments by ldmatrix.trans from Vs. Key
// pairs of 16 wholly past `valid` are skipped unless the tile is FULL.
template <bool FULL, bool SPLIT, int MT, int NTS, int NTO, int PK>
__device__ __forceinline__ void pv_tile(float s[MT][NTS][4],
                                        float o[MT][NTO][4],
                                        const __nv_bfloat16* Vs, int valid,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < NTS / 2; ++kk) {
    if (!FULL && kk * 16 >= valid) break;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ah[mt][0], al[mt][0]);
      split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ah[mt][1], al[mt][1]);
      split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ah[mt][2],
                 al[mt][2]);
      split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ah[mt][3],
                 al[mt][3]);
    }
    const __nv_bfloat16* vrow =
        Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PK;
#pragma unroll
    for (int np = 0; np < NTO / 2; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * np], ah[mt], vb[0], vb[1]);
        mma_bf16(o[mt][2 * np + 1], ah[mt], vb[2], vb[3]);
        if (SPLIT) {
          mma_bf16(o[mt][2 * np], al[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * np + 1], al[mt], vb[2], vb[3]);
        }
      }
    }
    if (NTO % 2) {
      uint32_t vb[2];
      ldmatrix_x2_trans(vb, vrow + (NTO - 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][NTO - 1], ah[mt], vb[0], vb[1]);
        if (SPLIT) mma_bf16(o[mt][NTO - 1], al[mt], vb[0], vb[1]);
      }
    }
  }
}

// One key tile of a job: S = Q K^T on the tensor cores, K1's scale and
// bias (bias_rows: the warp's first bias row at the tile's first key), the
// mask of keys at or past S, the online softmax and O += P V. A FULL tile
// (every key valid: all but a head's last) is straight-line code, so the
// compiler can interleave one m-tile's MMAs with the other's exps; the
// last tile skips key pairs of 16 wholly past S and masks the rest.
template <bool FULL, bool HAS_BIAS, int OPTS, int D, int MT, int KT>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qf)[MT][(D + 15) / 16][4], float (&o)[MT][D / 8][4],
    float (&m)[MT][2], float (&l)[MT][2], const __nv_bfloat16* Ks,
    const __nv_bfloat16* Vs, int valid, const float* bias_rows, int S,
    float scale, int lane) {
  constexpr int KSTEPS = (D + 15) / 16;
  constexpr int PK = KSTEPS * 16 + 8;
  constexpr int NTS = KT / 8;  // n8 tiles of a logits tile
  constexpr int NTO = D / 8;   // n8 tiles of the output
  const int g = lane / 4;
  const int t4 = lane % 4;

  float s[MT][NTS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int np = 0; np < NTS / 2; ++np) {
      if (!FULL && np * 16 >= valid) break;
      uint32_t kf[4];
      ldmatrix_x4(kf, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * PK +
                          ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * np], qf[mt][ks], kf[0], kf[1]);
        mma_bf16(s[mt][2 * np + 1], qf[mt][ks], kf[2], kf[3]);
      }
    }

  if (HAS_BIAS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          if (FULL || col < valid)
            s[mt][nt][e] = fmaf(
                s[mt][nt][e], scale,
                bias_rows[(mt * 16 + g + 8 * (e >> 1)) * S + col]);
        }
  }
  if (!FULL) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t4 + (e & 1) >= valid) s[mt][nt][e] = -INFINITY;
  }

  softmax_tile<(OPTS & OPT_EXP2) != 0, MT, NTS, NTO>(
      s, o, m, l, HAS_BIAS ? 1.f : scale);
  pv_tile<FULL, (OPTS & OPT_PV_BF16) == 0, MT, NTS, NTO, PK>(s, o, Vs,
                                                              valid, lane);
}

// Two m-tiles a warp fit 168 registers, so 3 blocks (12 warps) share an SM.
template <int D, int MT, int NW, int KT, int NS, int NQ, bool HAS_BIAS,
          int OPTS>
__global__ void __launch_bounds__(NW * 32, MT == 2 ? 3 : 1)
attention_mma_kernel(const AttnArgs a, const int hg) {
  static_assert(D % 8 == 0 && KT % 16 == 0 && NS >= 2, "tile shape");
  using bf16 = __nv_bfloat16;
  constexpr int NTH = NW * 32;
  constexpr int RM = 16 * MT * NW;   // query rows per block
  constexpr int DK = (D + 15) / 16 * 16;
  constexpr int PK = DK + 8;         // shared row pitch (elements)

  extern __shared__ __align__(128) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(
      smem + bias_bytes<RM, HAS_BIAS>(a.S));
  bf16* KVs = Qs + NQ * RM * PK;

  const int groups = a.H / hg;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y - b * groups) * hg;
  const int q0 = blockIdx.x * RM;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row0 = warp * 16 * MT;  // the warp's first row in the block
  const int T = (a.S + KT - 1) / KT;
  const int jobs = hg * T;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0];

  if (HAS_BIAS) {  // the block's bias rows: one flat span of (B, L, S)
    const int n = min(RM, a.L - q0) * a.S;
    const float* src = a.bias + ((long long)b * a.L + q0) * a.S;
    for (int i = threadIdx.x; i < n; i += NTH) cp_async4(bias_s + i, src + i);
  }

  auto issue = [&](int j) {
    if (j < jobs) {
      const int hh = j / T;
      const int t = j - hh * T;
      const int h = h0 + hh;
      bf16* Ks = KVs + (j % NS) * 2 * KT * PK;
      load_rows_async<D, DK, PK, KT, NTH>(Ks, kb + h * a.sk[2], a.sk[1],
                                          t * KT, a.S);
      load_rows_async<D, DK, PK, KT, NTH>(Ks + KT * PK, vb + h * a.sv[2],
                                          a.sv[1], t * KT, a.S);
      if (t == 0)
        load_rows_async<D, DK, PK, RM, NTH>(Qs + (hh % NQ) * RM * PK,
                                            qb + h * a.sq[2], a.sq[1], q0,
                                            a.L);
    }
    cp_async_commit();  // an empty group where j >= jobs keeps the count
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);

  uint32_t qf[MT][DK / 16][4];
  float o[MT][D / 8][4], m[MT][2], l[MT][2];

  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<NS - 2>();  // job j (and the bias) have landed
    __syncthreads();          // for every thread; and job j-1 is done
    issue(j + NS - 1);        // into the stage job j-1 used

    const int hh = j / T;
    const int t = j - hh * T;
    const bf16* Ks = KVs + (j % NS) * 2 * KT * PK;
    const bf16* Vs = Ks + KT * PK;
    const int valid = min(KT, a.S - t * KT);

    if (t == 0) {  // a new head: its Q fragments and a fresh softmax state
      const bf16* Qh = Qs + (hh % NQ) * RM * PK;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks)
          ldmatrix_x4(qf[mt][ks], Qh + (row0 + mt * 16 + (lane & 15)) * PK +
                                      ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        m[mt][0] = m[mt][1] = -INFINITY;
        l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
      }
    }

    const float* bias_rows = HAS_BIAS ? bias_s + row0 * a.S + t * KT
                                      : nullptr;
    if (valid == KT)
      attend_tile<true, HAS_BIAS, OPTS, D, MT, KT>(
          qf, o, m, l, Ks, Vs, valid, bias_rows, a.S, a.scale, lane);
    else
      attend_tile<false, HAS_BIAS, OPTS, D, MT, KT>(
          qf, o, m, l, Ks, Vs, valid, bias_rows, a.S, a.scale, lane);

    if (t == T - 1) {  // the head's last tile: O / l to device memory
      bf16* op = static_cast<bf16*>(a.o) + b * a.so[0] + (h0 + hh) * a.so[2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float lt = l[mt][r];
          lt += __shfl_xor_sync(0xffffffffu, lt, 1);
          lt += __shfl_xor_sync(0xffffffffu, lt, 2);
          const float inv = 1.f / lt;
          const int row = q0 + row0 + mt * 16 + g + 8 * r;
          if (row < a.L) {
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt)
              *reinterpret_cast<__nv_bfloat162*>(
                  op + (long long)row * a.so[1] + nt * 8 + 2 * t4) =
                  __floats2bfloat162_rn(o[mt][nt][2 * r] * inv,
                                        o[mt][nt][2 * r + 1] * inv);
          }
        }
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// K2: 4 warps of 32 rows (D <= 40) or 16 rows, 64-key tiles, one head a
// block. K1: 2 warps of 16 rows (32 rows a block), 80-key tiles, and the
// largest group of heads that still gives every SM a block.
template <int D, bool HAS_BIAS, int OPTS>
cudaError_t launch_mma(const AttnArgs& a, cudaStream_t stream) {
  constexpr int MT = (!HAS_BIAS && D <= 40) ? 2 : 1;
  constexpr int NW = HAS_BIAS ? 2 : 4;
  constexpr int KT = HAS_BIAS ? 80 : 64;
  constexpr int NS = D >= 128 ? 2 : 3;
  constexpr int NQ = HAS_BIAS ? NS : 1;
  constexpr int RM = 16 * MT * NW;
  constexpr int PK = (D + 15) / 16 * 16 + 8;
  const size_t smem = mma_smem_bytes<RM, KT, PK, NS, NQ, HAS_BIAS>(a.S);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = attention_mma_kernel<D, MT, NW, KT, NS, NQ, HAS_BIAS, OPTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.L + RM - 1) / RM;
  int hg = 1;
  if (HAS_BIAS) {
    for (hg = a.H; hg > 1; --hg)
      if (a.H % hg == 0 && tiles * a.B * (a.H / hg) >= sm_count()) break;
  }
  const dim3 grid(tiles, a.B * (a.H / hg));
  kern<<<grid, NW * 32, smem, stream>>>(a, hg);
  return cudaGetLastError();
}

// The options are template parameters, so each tile's code has no branch
// on them: K2's four combinations are four instances; K1 takes none.
template <int D, bool HAS_BIAS>
cudaError_t launch_mma_opts(const AttnArgs& a, cudaStream_t stream) {
  if constexpr (HAS_BIAS) {
    if (a.opts != 0) return cudaErrorInvalidValue;
    return launch_mma<D, true, 0>(a, stream);
  } else {
    switch (a.opts) {
      case 0: return launch_mma<D, false, 0>(a, stream);
      case OPT_PV_BF16: return launch_mma<D, false, OPT_PV_BF16>(a, stream);
      case OPT_EXP2: return launch_mma<D, false, OPT_EXP2>(a, stream);
      case OPT_PV_BF16 | OPT_EXP2:
        return launch_mma<D, false, OPT_PV_BF16 | OPT_EXP2>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <bool HAS_BIAS>
cudaError_t dispatch_d(const AttnArgs& a, int dtype, int d,
                       cudaStream_t st) {
#define DSC_HEAD_DIM(N)                                                   \
  case N:                                                                 \
    return dtype == 0 ? launch_fp32<N, HAS_BIAS>(a, st)                   \
                      : launch_mma_opts<N, HAS_BIAS>(a, st);
  switch (d) {
    DSC_HEAD_DIM(16)
    DSC_HEAD_DIM(32)
    DSC_HEAD_DIM(40)
    DSC_HEAD_DIM(64)
    DSC_HEAD_DIM(80)
    DSC_HEAD_DIM(128)
    DSC_HEAD_DIM(160)
    default: return cudaErrorInvalidValue;
  }
#undef DSC_HEAD_DIM
}

// dtype: 0 = fp32 (attention.cuh's CUDA-core body), 1 = bf16 (the
// tensor-core body above). strides: 12 element strides, [b, row, h] of q,
// k, v and o in that order.
template <bool HAS_BIAS>
int run(const void* q, const void* k, const void* v, const float* bias,
        void* o, int dtype, int B, int H, int L, int S, int D,
        const long long* strides, float scale, int opts, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.o = o;
  a.B = B; a.H = H; a.L = L; a.S = S;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.scale = scale;
  a.opts = opts;
  return (int)dispatch_d<HAS_BIAS>(a, dtype, D,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace dsc

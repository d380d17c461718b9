// Softmax attention for Hopper (sm_90a), shared by K1 (region attention,
// csrc/region_attention.cu) and K2 (attention without bias,
// csrc/flash_attention.cu): the common arguments and the body for fp32
// operands. bf16 operands, the main path's type, take the tensor-core body
// of csrc/attention_mma.cuh, whose `run` dispatches on the type.
//
//   out[b, l, h, :] = softmax_s(scale * q[b,l,h,:] . k[b,s,h,:] + w[b, l, s])
//                     . v[b, s, h, :]
//
// w is K1's region bias (B, L, S) fp32, broadcast over heads (bias row
// b = bh / H); K2 has none. Operands are read in the (B, L, H, D) layout
// the projections produce, through strides: there is no transpose and no
// padded copy. QK^T, the softmax and P.V are fp32; the output has the
// input's type.
//
// Why this body stays for fp32: it serves the tiny card-against-CPU checks
// and the fp32 tests, held to rtol 2e-4 / atol 2e-5, which the tensor
// cores' TF32 (10-bit mantissa) cannot meet. It streams K/V in tiles of BN
// keys with an online softmax (running max, denominator and fp32
// accumulator kept in registers); the result differs from a single pass
// only in the order of summation.
//
// Design (fp32 FMA on the CUDA cores, no tensor cores, no pipelining):
//   * one block of 256 threads takes BM = 64 query rows of one (b, h);
//   * thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 .. ty*4+3 in
//     every phase, so the running softmax state of its rows never leaves
//     its registers;
//   * per tile of BN = 64 keys: K and V go to shared memory, each thread
//     computes a 4x4 block of logits (columns tx + 16 j) with 16-byte
//     shared loads, reduces the row max / sum over the 16 threads of a row
//     with warp shuffles, writes P transposed to shared memory, and adds
//     P.V into its 4 x ceil(D/16) accumulators;
//   * shared rows have a pitch of D + 4 floats: an odd number of 16-byte
//     words, so the 16-byte loads of 8 consecutive rows hit distinct banks.
// Head dims 16, 32, 40, 64, 80, 128 and 160 are template instances; the
// ragged L and S edges are masked in the kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dsc {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Option bits (K2's attn_impl suffixes; K1 passes 0).
constexpr int OPT_PV_BF16 = 1;  // round P to bf16 before P.V
constexpr int OPT_EXP2 = 2;     // exp(x) as exp2(x * log2 e)

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, L, S) fp32 contiguous, or null
  void* o;
  int B, H, L, S;
  // element strides of the (B, *, H, D) operands: [b, row, h] each
  long long sq[3], sk[3], sv[3], so[3];
  float scale;
  int opts;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [r0, r0 + ROWS) of a (rows, D) slab with row stride `stride` (in
// elements) into shared memory with pitch P; rows at or past `valid` are 0.
template <int D, int P, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int r0,
                                          int valid) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += NT) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < valid) x = load4(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * P + c) = x;
  }
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BM * (D + 4) + 2 * (size_t)BN * (D + 4) +
                          (size_t)BN * (BM + 4));
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(NT)
attention_kernel(const AttnArgs a) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int P = D + 4;    // Q/K/V row pitch (odd count of float4)
  constexpr int PP = BM + 4;  // P^T row pitch
  constexpr int DC = (D + 15) / 16;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * P;
  float* Vs = Ks + BN * P;
  float* Pt = Vs + BN * P;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool pv_bf16 = (a.opts & OPT_PV_BF16) != 0;
  const bool use_exp2 = (a.opts & OPT_EXP2) != 0;

  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* bias_b =
      HAS_BIAS ? a.bias + (long long)b * a.L * a.S : nullptr;

  load_tile<D, P, BM>(Qs, qp, a.sq[1], q0, a.L);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < a.S; n0 += BN) {
    __syncthreads();  // the previous tile's readers of Ks / Vs / Pt are done
    load_tile<D, P, BN>(Ks, kp, a.sk[1], n0, a.S);
    load_tile<D, P, BN>(Vs, vp, a.sv[1], n0, a.S);
    __syncthreads();

    // logits s[i][j] for rows ty*4+i, columns n0 + tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty * 4 + i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(Ks + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // scale, bias, key mask; then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (HAS_BIAS && row < a.L && col < a.S)
          x += bias_b[(long long)row * a.S + col];
        s[i][j] = col < a.S ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mx));
      const float alpha = use_exp2 ? exp2f((m[i] - m_new) * LOG2E)
                                   : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = use_exp2 ? exp2f((s[i][j] - m_new) * LOG2E)
                                 : expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = p;
      }
      l[i] = l[i] * alpha + row_reduce_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = pv_bf16
            ? __bfloat162float(__float2bfloat16(s[i][j])) : s[i][j];
        Pt[(tx + 16 * j) * PP + ty * 4 + i] = p;
      }
    __syncthreads();

    const int nk = min(BN, a.S - n0);
#pragma unroll 4
    for (int n = 0; n < nk; ++n) {
      const float4 p = load4(Pt + n * PP + ty * 4);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < D ? Vs[n * P + col] : 0.f;
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

  float* op = static_cast<float*>(a.o) + b * a.so[0] + h * a.so[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.L) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) op[(long long)row * a.so[1] + col] = acc[i][c] / l[i];
    }
  }
}

template <int D, bool HAS_BIAS>
cudaError_t launch_fp32(const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + BM - 1) / BM, a.B * a.H);
  attention_kernel<D, HAS_BIAS><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace dsc

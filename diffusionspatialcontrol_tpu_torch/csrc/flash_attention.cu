// K2: attention without bias for Hopper; it also serves K3's shapes.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/flash_attention.py:_kernel
// (the single-pass Pallas TPU kernel) and, where the JAX package streams
// K/V because they outgrow VMEM (S > 12160 at D <= 128: the level-0
// self-attention at 1024^2, L = S = 16384), its :_stream_kernel. Computes
// softmax(scale * Q K^T) V for every self-attention, and for every
// cross-attention when no region map is given.
//
// Bounds on an H100 for bf16 operands (csrc/attention_mma.cuh): at the
// 512^2 level-0 self-attention (B*H = 16, L = S = 4096, D = 40) 43 GFLOP of
// MMA (0.043 ms at 989 TFLOP/s), 268 M exps (0.069 ms at ~3.9 T/s) and
// 2.6 MB of Q/K/V/O (0.0008 ms): the exps bound it. At L = S = 16384:
// 0.69 ms of MMA, 1.10 ms of exps. K/V (320 KB each at level 0, 1.3 MB at
// L = 16384) exceed a block's 227 KB of shared memory, so the kernel
// streams them through a cp.async ring of key tiles with an online
// softmax, QK^T and P.V on mma.sync (bf16 in, fp32 accumulate), P kept in
// registers and split into bf16 hi + lo so that it is not rounded. fp32
// operands take the CUDA-core body of csrc/attention.cuh.
//
// Options (attn_impl suffixes of the JAX UNet): OPT_PV_BF16 rounds P to
// bf16 before P.V (the hi part only); OPT_EXP2 takes exp as
// exp2(x * log2 e). "qk_bf16" needs no code here: that option only keeps the
// TPU kernel from casting Q and K to fp32 before its fp32-accumulated QK^T,
// and this kernel always forms QK^T in fp32 from the operands' own values
// (bf16 products are exact in fp32).

#include "attention_mma.cuh"

extern "C" int dsc_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int L, int S, int D,
                                   const long long* strides, float scale,
                                   int opts, void* stream) {
  return dsc::run<false>(q, k, v, nullptr, o, dtype, B, H, L, S, D, strides,
                         scale, opts, stream);
}

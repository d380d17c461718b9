// K2: attention without bias for Hopper.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/flash_attention.py:_kernel
// (the single-pass Pallas TPU kernel). Computes softmax(scale * Q K^T) V for
// every self-attention, and for every cross-attention when no region map is
// given.
//
// Bound on an H100 at 512^2: operations. Self-attention at level 0 is
// 4 * 2 * 8 * 4096^2 * 40 ~ 43 GFLOP a launch against ~2.6 MB of Q/K/V/O.
// The TPU kernel keeps the whole K/V in VMEM; here K/V (320 KB each at level
// 0) exceed a block's 227 KB of shared memory, so the kernel streams them in
// tiles with an online softmax (attention.cuh).
//
// Options (attn_impl suffixes of the JAX UNet): OPT_PV_BF16 rounds P to
// bf16 before P.V; OPT_EXP2 takes exp as exp2(x * log2 e). "qk_bf16" needs
// no code here: that option only keeps the TPU kernel from casting Q and K
// to fp32 before its fp32-accumulated QK^T, and this kernel always forms
// QK^T in fp32 from the operands' own values.

#include "attention.cuh"

extern "C" int dsc_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int L, int S, int D,
                                   const long long* strides, float scale,
                                   int opts, void* stream) {
  return dsc::run<false>(q, k, v, nullptr, o, dtype, B, H, L, S, D, strides,
                         scale, opts, stream);
}

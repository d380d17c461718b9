// K1: region-biased cross-attention for Hopper.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/region_attention.py:_kernel
// (the Pallas TPU kernel). Computes softmax(scale * Q K^T + w) V with the
// fp32 region bias w (B, L, S) broadcast over heads. The global logits std
// inside w is a plain reduction computed before the launch
// (ops/attention.py:logits_std_gram_nlhd), as in the JAX package.
//
// Bound on an H100 at 512^2: memory. S is 77 (<= 308), so a launch does
// ~0.8 GFLOP at level 0 but has to read Q and the fp32 bias and write O,
// ~13 MB. The bias row of batch b is read once per head; at 512^2 a level's
// bias (<= 2.5 MB) stays in the 50 MB L2 across the heads. See attention.cuh
// for the kernel's design.

#include "attention.cuh"

extern "C" int dsc_region_attention(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    void* o, int dtype, int B, int H, int L,
                                    int S, int D, const long long* strides,
                                    float scale, void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return dsc::run<true>(q, k, v, bias, o, dtype, B, H, L, S, D, strides,
                        scale, 0, stream);
}

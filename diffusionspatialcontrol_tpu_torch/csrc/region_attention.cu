// K1: region-biased cross-attention for Hopper.
//
// Replaces diffusionspatialcontrol_tpu/ops/pallas/region_attention.py:_kernel
// (the Pallas TPU kernel). Computes softmax(scale * Q K^T + w) V with the
// fp32 region bias w (B, L, S) broadcast over heads. The global logits std
// inside w is a plain reduction computed before the launch
// (ops/attention.py:logits_std_gram_nlhd), as in the JAX package.
//
// Bound on an H100 at 512^2: bytes and exps. S is 77 (<= 308 with chunked
// prompts), so a launch at level 0 does ~0.8 GFLOP and 40 M exps
// (0.010 ms) but has to read Q and the fp32 bias and write O, ~13 MB
// (0.0039 ms). So the design reads each byte once: for bf16 operands
// (csrc/attention_mma.cuh) a block takes 32 query rows of one batch and a
// group of heads (all 8 at level 0: 256 blocks), copies its 32 x S bias
// rows, one contiguous span of the (B, L, S) tensor, into shared memory
// once, and reuses them for every head of the group. K and V go through the
// same cp.async ring and tensor-core products as K2's, in key tiles of 80,
// so S = 77 is one tile padded to 80 keys. The bias tile bounds S: a block
// has 227 KB of shared memory, so S <= 808 at D = 160 and more at smaller
// D (the launch returns an error beyond). fp32 operands take the CUDA-core
// body of csrc/attention.cuh, which reads the bias through L2 once a head.

#include "attention_mma.cuh"

extern "C" int dsc_region_attention(const void* q, const void* k,
                                    const void* v, const float* bias,
                                    void* o, int dtype, int B, int H, int L,
                                    int S, int D, const long long* strides,
                                    float scale, void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return dsc::run<true>(q, k, v, bias, o, dtype, B, H, L, S, D, strides,
                        scale, 0, stream);
}

"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| Kernel | Module | CUDA source | Replaces (Pallas) |
| --- | --- | --- | --- |
| K1 | ``region_attention`` | ``csrc/region_attention.cu`` | ``ops/pallas/region_attention.py:_kernel`` |
| K2 | ``flash_attention`` | ``csrc/flash_attention.cu`` | ``ops/pallas/flash_attention.py:_kernel`` and, at S > 12160, ``:_stream_kernel`` (K3) |
| K4 | ``conv_fused`` (``gn_silu_conv3x3``) | ``csrc/conv_fused.cu`` (bf16: with ``conv_tc.cuh``) | ``ops/pallas/conv_fused.py:_kernel`` (K4a) and ``:_kernel_rows`` (K4b) |
| K5 | ``conv_fused`` (``gn_silu_conv3x3_v2``) | ``csrc/conv_fused_v2.cu`` (bf16: with ``conv_tc.cuh``) | ``ops/pallas/conv_fused.py:_kernel_v2`` |
| HED tail | ``hed_fuse`` (``hed_tail``) | ``csrc/hed_fuse.cu`` | none: ``jax.image.resize`` and numpy in ``models/hed.py:detect_edges`` |

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built by ``_build`` at first use) or raises.
"""

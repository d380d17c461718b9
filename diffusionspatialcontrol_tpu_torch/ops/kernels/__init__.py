"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

| Kernel | Module | CUDA source | Replaces (Pallas) |
| --- | --- | --- | --- |
| K1 | ``region_attention`` | ``csrc/region_attention.cu`` | ``ops/pallas/region_attention.py:_kernel`` |
| K2 | ``flash_attention`` | ``csrc/flash_attention.cu`` | ``ops/pallas/flash_attention.py:_kernel`` |

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (built by ``_build`` at first use) or raises.
"""

"""Public kernel wrappers: thin aliases over the port's front doors.

The counterpart of the JAX package's ``repro.kernels.ops``, its stable
back-compat API for external callers and notebooks, under the same names:
``flash_attention``, ``matmul_fused``, ``norm_onepass``, ``linear_scan``
and ``kernel_path``, bound to ``repro_torch.backend.dispatch``.  As
everywhere in the port, the tensors' device picks the path: the Hopper
kernel on CUDA, its plain version on the CPU.

``use_flash`` has no counterpart: the port's model has no q-chunked
attention path to choose against, and always takes the flash door.
"""
from __future__ import annotations

from repro_torch.backend.dispatch import (dispatch_flash_attention,
                                          dispatch_layernorm,
                                          dispatch_linear_scan,
                                          dispatch_matmul, kernel_path)

flash_attention = dispatch_flash_attention
matmul_fused = dispatch_matmul
norm_onepass = dispatch_layernorm
linear_scan = dispatch_linear_scan

__all__ = ["flash_attention", "matmul_fused", "norm_onepass", "linear_scan",
           "kernel_path"]

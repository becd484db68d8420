"""Kernel front doors of the port (``dispatch``), re-exported as the JAX
package's ``repro.backend`` re-exports its own."""
from repro_torch.backend import dispatch
from repro_torch.backend.dispatch import (dispatch_flash_attention,
                                          dispatch_layernorm,
                                          dispatch_linear_scan,
                                          dispatch_matmul, kernel_path)

__all__ = ["dispatch", "kernel_path", "dispatch_matmul",
           "dispatch_flash_attention", "dispatch_linear_scan",
           "dispatch_layernorm"]

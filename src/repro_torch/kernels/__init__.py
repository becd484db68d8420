"""The port's kernels: plain PyTorch versions (``ref``) and hand-written
CUDA kernels for Hopper behind device-routed wrappers.  Importing this
package builds nothing; the CUDA library builds on the first launch."""

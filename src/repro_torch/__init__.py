"""PyTorch + CUDA port of the ``repro`` serving path for NVIDIA Hopper.

A second package beside the JAX one: it imports torch and numpy only, and
keeps its own copy of every module it needs.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; on the CPU
every kernel front door takes its plain PyTorch version.
"""

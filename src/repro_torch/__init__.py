"""PyTorch / CUDA port of the Predictive Indexing system.

The JAX package ``repro`` is the reference; this package runs the
paper's loop on one plain table on an NVIDIA H100, with the scan
kernels written by hand in CUDA C++ (``kernels/csrc``).  The public
surface is ``repro_torch.api``.
"""

"""PyTorch / CUDA port of the Predictive Indexing system.

The JAX package ``repro`` is the reference; this package runs the
paper's loop -- plain, coverage-bitmap and sharded tables, the
predictive tuner and the closed-loop workload runner -- on an NVIDIA
H100, with the scan kernels written by hand in CUDA C++
(``kernels/csrc``).  The public surface is ``repro_torch.api``.
"""

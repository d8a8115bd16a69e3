"""Hand-written CUDA scan kernels (K1, K2), their plain PyTorch
versions and the table adapters (``ops``)."""

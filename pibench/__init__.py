"""The benchmark of ``repro_torch`` on one NVIDIA H100 (see README.md)."""

"""Data substrate of the port: the deterministic sharded token pipeline."""
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline"]

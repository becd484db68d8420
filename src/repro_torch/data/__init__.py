"""Data of the port: the synthetic LM pipeline."""
from repro_torch.data.pipeline import SyntheticLM

__all__ = ["SyntheticLM"]

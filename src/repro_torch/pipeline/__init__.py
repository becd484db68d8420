"""Plan execution of the port: ``run_stage``, one stage's group slice (the
single-device stage walk the serving engine steps)."""
from repro_torch.pipeline.executor import run_stage

__all__ = ["run_stage"]

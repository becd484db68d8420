"""Training of the port: AdamW, the train step, and the moments' ZeRO-1
specs (``zero1_specs``)."""
from repro_torch.training.optimizer import AdamW, AdamWState, zero1_specs
from repro_torch.training.trainer import make_train_step

__all__ = ["AdamW", "AdamWState", "make_train_step", "zero1_specs"]

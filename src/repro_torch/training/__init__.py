"""Training of the port: AdamW and the train step."""
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.trainer import make_train_step

__all__ = ["AdamW", "AdamWState", "make_train_step"]

"""Training of the port: AdamW, the train step and its sharded form over
a device mesh, and the moments' ZeRO-1 specs (``zero1_specs``)."""
from repro_torch.training.optimizer import AdamW, AdamWState, zero1_specs
from repro_torch.training.trainer import (init_sharded, make_train_step,
                                          sharded_train_step)

__all__ = ["AdamW", "AdamWState", "init_sharded", "make_train_step",
           "sharded_train_step", "zero1_specs"]

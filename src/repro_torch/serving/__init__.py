"""Serving engine of the port."""
from repro_torch.serving.engine import (Request, ServingEngine,
                                        make_prefill_slot_step,
                                        make_prefill_suffix_paged_step,
                                        make_serve_step)

__all__ = ["Request", "ServingEngine", "make_serve_step",
           "make_prefill_slot_step", "make_prefill_suffix_paged_step"]

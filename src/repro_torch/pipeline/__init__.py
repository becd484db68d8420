"""Plan execution of the port: the SSR pipeline executor over a device
mesh (``plan_forward``, its runner and the uniform-plan shims; one
process over the slots, or one process a mesh rank) and
``run_stage``, one stage's group slice (the stage walk the serving engine
steps)."""
from repro_torch.pipeline.executor import (gather_logits,
                                           make_pipeline_runner,
                                           make_plan_runner, pipeline_forward,
                                           pipeline_spec, plan_forward,
                                           plan_stage_params, run_stage,
                                           stage_params_reshape)

__all__ = ["gather_logits", "make_pipeline_runner", "make_plan_runner",
           "pipeline_forward", "pipeline_spec", "plan_forward",
           "plan_stage_params", "run_stage", "stage_params_reshape"]

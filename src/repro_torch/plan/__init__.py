"""ExecutionPlan subsystem of the port: the plan IR and its lowering
(copies of the JAX package's ``plan/ir.py`` and ``plan/lower.py``, pure
Python), the single-device validation subset (``plan.validate``) and
plan-driven serving (``plan.serving``: chunked prefill through the plan's
stages, spatial decode replicas).

Only the IR and the lowering are imported here: ``validate`` and
``serving`` run the model (torch) and are imported by name."""
from repro_torch.plan.ir import (ExecutionPlan, ServingPlan, StagePlan,
                                 fit_dp_tp, uniform_plan)
from repro_torch.plan.lower import (group_acc_map, lower, lower_serving,
                                    realized_assignment,
                                    rereplicate_serving)

__all__ = [
    "ExecutionPlan", "ServingPlan", "StagePlan", "uniform_plan",
    "fit_dp_tp", "lower", "lower_serving", "group_acc_map",
    "realized_assignment", "rereplicate_serving",
]

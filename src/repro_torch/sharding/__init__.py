"""Sharding of the port: the rules (param and input trees -> partition
specs, equal to the JAX package's) and their DTensor placements
(``rules``); executing them on a ``DeviceMesh`` (``execute``: DTensor
trees, this rank's batch rows, a plan mesh rank's tree); the
collectives over named mesh axes that every sharded layer reaches the
process groups through (``collectives``)."""
from repro_torch.sharding.collectives import Parallel, reset_stats, stats
from repro_torch.sharding.execute import (axes_view, gather_tree,
                                          plan_rank_tree, shard_batch,
                                          shard_tree, stacked, unstacked,
                                          zeros_tree)
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        batch_axes_for, input_shardings_tree,
                                        input_specs_tree, param_shardings,
                                        param_specs, placements,
                                        stacked_shapes)

__all__ = ["NamedSharding", "Parallel", "PartitionSpec", "axes_view",
           "batch_axes_for", "gather_tree", "input_shardings_tree",
           "input_specs_tree", "param_shardings", "param_specs",
           "placements", "plan_rank_tree", "reset_stats", "shard_batch",
           "shard_tree", "stacked", "stacked_shapes", "stats", "unstacked",
           "zeros_tree"]

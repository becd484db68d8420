"""Sharding rules of the port: param and input trees -> partition specs
(``rules``), equal to the JAX package's, and their DTensor placements."""
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        batch_axes_for, input_shardings_tree,
                                        input_specs_tree, param_shardings,
                                        param_specs, placements,
                                        stacked_shapes)

__all__ = ["NamedSharding", "PartitionSpec", "batch_axes_for",
           "input_shardings_tree", "input_specs_tree", "param_shardings",
           "param_specs", "placements", "stacked_shapes"]

"""SSR core: the paper's contribution — layer-graph IR, analytical TPU cost
model, Layer→Acc evolutionary search (Alg. 1), inter-acc-aware
customization (Alg. 2), pipeline scheduling, Pareto exploration.

The port's copy of the JAX package's ``repro.core`` (pure Python, no
torch), plus the H100 ``Chip`` in ``hw``."""
from repro_torch.core.assignment import (Assignment, ScheduleResult,
                                         contiguous_assignment,
                                         sequential_assignment, simulate,
                                         spatial_assignment)
from repro_torch.core.costmodel import (AccConfig, Features, node_time,
                                        stage_time)
from repro_torch.core.ea import (DSEResult, evolutionary_search,
                                 exhaustive_search, ssr_dse)
from repro_torch.core.graph import (Graph, MatmulShape, Node, build_graph,
                                    model_flops)
from repro_torch.core.hw import CHIPS, H100, TPU_V5E, VCK190, mxu_efficiency
from repro_torch.core.pareto import (DesignPoint, best_under_latency,
                                     pareto_front, strategy_points)

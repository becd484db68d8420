"""Entry points of the port (the ``serve`` and ``train`` command lines)
and its device meshes (``mesh``)."""
from repro_torch.launch.mesh import (Mesh, backend_for, device_mesh,
                                     init_distributed, local_devices,
                                     make_host_mesh, make_pipeline_mesh,
                                     make_plan_mesh, make_production_mesh)

__all__ = ["Mesh", "backend_for", "device_mesh", "init_distributed",
           "local_devices", "make_host_mesh", "make_pipeline_mesh",
           "make_plan_mesh", "make_production_mesh"]

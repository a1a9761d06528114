# optpricer_tpu_torch.parallel — single-controller device-mesh data
# parallelism (the counterpart of optpricer_tpu.parallel).
from .mesh import (get_mesh, get_mesh_multislice, mesh_axes,  # noqa: F401
                   mc_sumstats_sharded)

"""Multi-device paths on ``torch.distributed``: the device mesh, the
multi-start population, the panel-sharded (N-axis) fit and the
distributed matrix-free CG.  Port of :mod:`gpyrn_tpu.parallel`; where the
JAX package runs SPMD from one process, every rank here is a process and
the functions are called collectively (:mod:`.mesh`)."""
from gpyrn_tpu_torch.parallel.mesh import (DP_AXIS, LAT_AXIS, make_mesh,
                                           shard_along, use_mesh)
from gpyrn_tpu_torch.parallel.multistart import (make_multistart_step,
                                                 multistart_optimize)
from gpyrn_tpu_torch.parallel.panel_fit import PanelEngine, make_panel_engine
from gpyrn_tpu_torch.parallel.iterative_sharded import cg_solve_sharded

__all__ = [
    "DP_AXIS", "LAT_AXIS", "make_mesh", "shard_along", "use_mesh",
    "make_multistart_step", "multistart_optimize",
    "PanelEngine", "make_panel_engine", "cg_solve_sharded",
]

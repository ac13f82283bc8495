"""The multi-device layer: the ``(rot, batch)`` mesh of
``torch.distributed`` ranks (``mesh``), its collectives, the
rotation-sharded sweeps, batched docking (``batch_eval.dock_batch``) and
the data-parallel train step."""
from deeplocalproteindocking_torch.parallel.batch_eval import (  # noqa: F401
    dock_batch)
from deeplocalproteindocking_torch.parallel.mesh import (  # noqa: F401
    init_distributed, make_mesh)
from deeplocalproteindocking_torch.parallel.sharded_sweep import (  # noqa: F401
    sharded_dock_sweep, sharded_dock_sweep_resplat)

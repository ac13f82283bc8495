from deeplocalproteindocking_torch.sweep.docker import (  # noqa: F401
    DockResult, dock_sweep,
)
from deeplocalproteindocking_torch.sweep.cluster import (  # noqa: F401
    pose_pairwise_rmsd, nms_cluster,
)

from deeplocalproteindocking_torch.grids.voxelize import (  # noqa: F401
    default_origin, separable_splat, splat,
)
from deeplocalproteindocking_torch.grids.rotate import (  # noqa: F401
    rotate_volume, rotate_volumes,
)
from deeplocalproteindocking_torch.grids.xplor import write_xplor  # noqa: F401
from deeplocalproteindocking_torch.grids.ccp4 import (  # noqa: F401
    read_ccp4, write_ccp4,
)

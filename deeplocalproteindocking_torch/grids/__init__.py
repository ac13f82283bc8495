from deeplocalproteindocking_torch.grids.voxelize import (  # noqa: F401
    separable_splat,
)

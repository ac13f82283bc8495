from deeplocalproteindocking_torch.models.representation import (  # noqa: F401
    HybridRepresentation, Representation, shape_channels,
)
from deeplocalproteindocking_torch.models.scoring import (  # noqa: F401
    ScoringModel,
)

from deeplocalproteindocking_torch.train.decoys import (  # noqa: F401
    DecoySet, generate_decoys,
)
from deeplocalproteindocking_torch.train.losses import ranking_hinge_loss  # noqa: F401
from deeplocalproteindocking_torch.train.trainer import (  # noqa: F401
    TrainState, Trainer, TrainBatch,
)

"""Batched multi-complex docking (``batch_eval.dock_batch``)."""
from deeplocalproteindocking_torch.parallel.batch_eval import (  # noqa: F401
    dock_batch)

from deeplocalproteindocking_torch.utils.rmsd import (  # noqa: F401
    rmsd, kabsch_rmsd, kabsch_rotation,
)
from deeplocalproteindocking_torch.utils.quality import (  # noqa: F401
    ligand_rmsd, interface_rmsd, fnat, capri_class, CAPRI_CLASSES,
)

from deeplocalproteindocking_torch.structure.atom_types import (  # noqa: F401
    ATOM_TYPE_NAMES, NUM_ATOM_TYPES, assign_atom_types,
)
from deeplocalproteindocking_torch.structure.pdb import (  # noqa: F401
    Structure, parse_pdb, parse_pdb_text, write_pdb,
)

from deeplocalproteindocking_torch.structure.atom_types import (  # noqa: F401
    ATOM_TYPE_NAMES, NUM_ATOM_TYPES, assign_atom_types,
)
from deeplocalproteindocking_torch.structure.pdb import (  # noqa: F401
    Structure, parse_pdb, parse_pdb_text, write_pdb,
)
from deeplocalproteindocking_torch.structure.transforms import (  # noqa: F401
    rotate, translate, apply_pose, center_of_mass, bounding_box,
    quat_to_matrix, random_rotations, axis_angle_to_matrix,
)
from deeplocalproteindocking_torch.structure.so3 import (  # noqa: F401
    super_fibonacci_rotations, local_rotations, geodesic_angle,
)

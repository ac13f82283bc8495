from deeplocalproteindocking_torch.data.benchmark import (  # noqa: F401
    Complex, structure_to_device, synthetic_complex,
)

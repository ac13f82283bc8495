"""XPLOR/CNS density map export for visual debugging.

Port of ``deeplocalproteindocking_tpu/grids/xplor.py``: a host-side
numpy text writer, readable by PyMOL, Chimera(X) and VMD.  Accepts a
numpy array or a tensor on any device.
"""
from __future__ import annotations

import numpy as np


def _host(volume) -> np.ndarray:
    if hasattr(volume, "detach"):          # a torch tensor
        volume = volume.detach().to("cpu").numpy()
    return np.asarray(volume, dtype=np.float64)


def write_xplor(path: str, volume, resolution: float = 1.25,
                title: str = "deeplocalproteindocking_torch") -> None:
    """Write a single-channel ``[L, L, L]`` volume as an XPLOR ASCII map."""
    vol = _host(volume)
    if vol.ndim != 3 or len(set(vol.shape)) != 1:
        raise ValueError(f"expected cubic [L,L,L] volume, got {vol.shape}")
    L = vol.shape[0]
    a = L * resolution
    with open(path, "w") as f:
        f.write("\n       2 !NTITLE\n")
        f.write(f" REMARKS {title}\n")
        f.write(f" REMARKS resolution {resolution:.3f} A/voxel\n")
        f.write("".join(f"{v:8d}" for v in
                        (L, 0, L - 1, L, 0, L - 1, L, 0, L - 1)) + "\n")
        f.write("".join(f"{v:12.5E}" for v in
                        (a, a, a, 90.0, 90.0, 90.0)) + "\n")
        f.write("ZYX\n")
        for k in range(L):          # sections along Z
            f.write(f"{k:8d}\n")
            sec = vol[:, :, k].T.reshape(-1)  # X fastest within a section
            for i in range(0, sec.size, 6):
                f.write("".join(f"{v:12.5E}" for v in sec[i:i + 6]) + "\n")
        f.write(f"{-9999:8d}\n")
        f.write(f"{vol.mean():12.4E} {vol.std():12.4E}\n")

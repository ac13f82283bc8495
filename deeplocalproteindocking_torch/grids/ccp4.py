"""CCP4/MRC binary density map export and import.

Port of ``deeplocalproteindocking_tpu/grids/ccp4.py``: a 1024-byte header
and float32 section data, little-endian, MODE 2, the format ChimeraX,
PyMOL, Coot and EM tools read.  Host-side, never on the compute path;
accepts a numpy array or a tensor on any device.
"""
from __future__ import annotations

import struct

import numpy as np

from deeplocalproteindocking_torch.grids.xplor import _host


def write_ccp4(path: str, volume, resolution: float = 1.25,
               origin: tuple = (0.0, 0.0, 0.0)) -> None:
    """Write a ``[L, L, L]`` volume as a CCP4/MRC (mode 2) map.

    ``volume[x, y, z]`` with columns X (fastest), rows Y, sections Z
    (MAPC/MAPR/MAPS = 1/2/3), a cubic cell of ``L * resolution`` Angstrom;
    ``origin`` is the Cartesian origin in Angstrom (the ORIGIN words).
    """
    vol = _host(volume).astype(np.float32)
    if vol.ndim != 3 or len(set(vol.shape)) != 1:
        raise ValueError(f"expected cubic [L,L,L] volume, got {vol.shape}")
    L = vol.shape[0]
    a = L * resolution
    data = np.ascontiguousarray(vol.transpose(2, 1, 0))   # [z, y, x]
    hdr = struct.pack(
        "<10i6f3i3f3i",
        L, L, L,                  # NC, NR, NS
        2,                        # MODE 2 = float32
        0, 0, 0,                  # NCSTART, NRSTART, NSSTART
        L, L, L,                  # MX, MY, MZ (sampling)
        a, a, a, 90.0, 90.0, 90.0,  # cell
        1, 2, 3,                  # MAPC, MAPR, MAPS (X, Y, Z)
        float(vol.min()), float(vol.max()), float(vol.mean()),
        1, 0, 0,                  # ISPG (P1), NSYMBT, LSKFLG
    )
    # Words 26..49 extra (zeros), 50..52 ORIGIN, 53 MAP, 54 MACHST,
    # 55 RMS, 56 NLABL, 57.. labels.
    header = (hdr + b"\x00" * (4 * 24)
              + struct.pack("<3f", *map(float, origin))
              + b"MAP "
              + struct.pack("<4B", 0x44, 0x44, 0x00, 0x00)  # little-endian
              + struct.pack("<f", float(vol.std()))
              + struct.pack("<i", 1)
              + b"deeplocalproteindocking_torch".ljust(80)[:80]
              + b"\x00" * (80 * 9))
    if len(header) != 1024:
        raise AssertionError(f"CCP4 header is {len(header)} bytes")
    with open(path, "wb") as f:
        f.write(header)
        f.write(data.tobytes())


def read_ccp4(path: str):
    """``(volume [L, L, L] float32, resolution)`` of a mode-2 map in the
    cubic single-axis convention of :func:`write_ccp4`."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nc, nr, ns, mode = struct.unpack("<4i", header[:16])
        if mode != 2:
            raise ValueError(f"unsupported CCP4 mode {mode}")
        mx = struct.unpack("<i", header[28:32])[0]
        xlen = struct.unpack("<f", header[40:44])[0]
        data = np.frombuffer(f.read(4 * nc * nr * ns),
                             dtype="<f4").reshape(ns, nr, nc)
    return np.ascontiguousarray(data.transpose(2, 1, 0)), xlen / mx

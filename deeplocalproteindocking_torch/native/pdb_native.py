"""ctypes binding of the C++ PDB parser (``native/pdb_parser.cpp``).

``parse_pdb`` reads a file's first model with the same rules as
``structure.pdb.parse_pdb_text`` (fixed columns, truncated records
skipped, occupancy-ranked altlocs through ``select_altlocs``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from deeplocalproteindocking_torch import native


@functools.cache
def library() -> ctypes.CDLL:
    """The shared library with ``pdb_count_atoms`` and ``pdb_parse_v2``
    bound; raises when it cannot be built or loaded."""
    lib = native.library()
    lib.pdb_count_atoms.restype = ctypes.c_int
    lib.pdb_count_atoms.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pdb_parse_v2.restype = ctypes.c_int
    lib.pdb_parse_v2.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    return lib


def parse_pdb(path: str, include_hetatm: bool = False):
    """The first model of ``path`` as a ``Structure``, parsed in C++."""
    from deeplocalproteindocking_torch.structure.atom_types import (
        assign_atom_types)
    from deeplocalproteindocking_torch.structure.pdb import (
        Structure, select_altlocs)

    lib = library()
    het = 1 if include_hetatm else 0
    n = lib.pdb_count_atoms(path.encode(), het)
    if n < 0:
        raise IOError(f"cannot read {path}")
    coords = np.zeros((n, 3), dtype=np.float32)
    atom_raw = ctypes.create_string_buffer(max(4 * n, 4))
    res_raw = ctypes.create_string_buffer(max(3 * n, 3))
    chain_raw = ctypes.create_string_buffer(max(n, 1))
    icode_raw = ctypes.create_string_buffer(max(n, 1))
    altloc_raw = ctypes.create_string_buffer(max(n, 1))
    res_ids = np.zeros(n, dtype=np.int32)
    occ = np.zeros(n, dtype=np.float32)
    got = lib.pdb_parse_v2(
        path.encode(), het, n,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        atom_raw, res_raw, chain_raw,
        res_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), icode_raw,
        altloc_raw, occ.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got != n:
        raise IOError(f"parse mismatch in {path}: {got} != {n}")

    def chars(raw, w):
        return np.char.strip(np.frombuffer(raw.raw[:w * n],
                                           dtype=f"S{w}").astype(f"<U{w}"))

    atom_names, res_names = chars(atom_raw, 4), chars(res_raw, 3)
    chain_ids = np.frombuffer(chain_raw.raw[:n], dtype="S1").astype("<U1")
    icodes, altlocs = chars(icode_raw, 1), chars(altloc_raw, 1)
    keep = select_altlocs(atom_names, chain_ids, res_ids, icodes, altlocs,
                          occ)
    atom_names, res_names = atom_names[keep], res_names[keep]
    return Structure(
        coords=coords[keep], atom_names=atom_names, res_names=res_names,
        res_ids=res_ids[keep], chain_ids=chain_ids[keep],
        types=assign_atom_types(res_names, atom_names), icodes=icodes[keep])
